"""The port's telemetry against the JAX package's on the CPU: the event
streams of both drivers agree (the same event types in the same order,
with the same simulation fields; timing fields, device names and each
package's own merkleization counters excluded), and the port's own
runtime legs work on the CPU.

- the dense driver at n = 128 on the minimal config, with a lossy and
  delaying fault plan, the dense monitors, the phase profiler, the flight
  recorder and autocheckpoint, 2 epochs;
- the spec driver at 64 validators: a faulted two-view run with a crash
  window, an equivocator and the default monitors, checkpointed at slot 4
  and resumed with ``telemetry=`` in each package; and a DAS run with
  200 samplers and a light client (``das_attach``, ``das_serve``,
  ``light_client_lag``), under the debug flag's invariant checker;
- ``torchrt`` (builds, launches, dispatches, transfers by phase,
  donations), the build ledger, ``DeviceMemorySampler`` and
  ``FlightRecorder`` on the CPU, and ``Telemetry.to_file(append=True)``.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu import config as jc  # noqa: E402
from pos_evolution_tpu import sim as jsim  # noqa: E402
from pos_evolution_tpu import telemetry as jtel  # noqa: E402
from pos_evolution_tpu.backend import set_backend as jax_set_backend  # noqa: E402
from pos_evolution_tpu.das import BlobEngine as JBlobEngine  # noqa: E402
from pos_evolution_tpu.sim.dense_driver import DenseSimulation as JaxDense  # noqa: E402
from pos_evolution_tpu.sim.dense_monitors import default_dense_monitors as jax_monitors  # noqa: E402
from pos_evolution_tpu.sim.faults import DenseFaultPlan as JaxPlan  # noqa: E402
from pos_evolution_tpu_torch import config as tc  # noqa: E402
from pos_evolution_tpu_torch import sim as tsim  # noqa: E402
from pos_evolution_tpu_torch import telemetry as ttel  # noqa: E402
from pos_evolution_tpu_torch.backend import use_backend  # noqa: E402
from pos_evolution_tpu_torch.das import BlobEngine as TBlobEngine  # noqa: E402
from pos_evolution_tpu_torch.ops import kernels  # noqa: E402
from pos_evolution_tpu_torch.profiling import ledger  # noqa: E402
from pos_evolution_tpu_torch.profiling.phases import PhaseTimer  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_driver import DenseSimulation  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_monitors import default_dense_monitors  # noqa: E402
from pos_evolution_tpu_torch.sim.faults import DenseFaultPlan  # noqa: E402
from pos_evolution_tpu_torch.telemetry import device as tdevice  # noqa: E402
from pos_evolution_tpu_torch.telemetry import torchrt  # noqa: E402

PKGS = ("port", "jax")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: tiny tensor ops under parallel test workers
    otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(ev: dict) -> dict:
    """An event's simulation fields: timing fields, device names, each
    package's own merkleization counters and the compressed checkpoint
    bytes (the port deflates its dense payload at another level) are not
    the simulation's."""
    out = {}
    for k, v in ev.items():
        if k in ("seq", "unix", "accounted_pct", "bytes") or k.endswith(("_ms", "_s")):
            continue
        if ev["type"] == "merkleization" and k not in ("v", "type", "slot"):
            continue
        out[k] = v
    if "phases" in out:
        out["phases"] = sorted(out["phases"])    # the phase names, not their ms
    if "rows" in out:
        out["rows"] = [r.get("platform") for r in out["rows"]]   # device names aside
    return out


def _same_stream(a: list, b: list) -> None:
    assert [e["type"] for e in a] == [e["type"] for e in b]
    for x, y in zip(a, b):
        assert _normal(x) == _normal(y), x["type"]


# --- the dense driver --------------------------------------------------------------

def _dense_run(pkg, tmp):
    cfg = tc.minimal_config() if pkg == "port" else jc.minimal_config()
    Tel, Fr, Sim = ((ttel.Telemetry, ttel.FlightRecorder, DenseSimulation) if pkg == "port"
                    else (jtel.Telemetry, jtel.FlightRecorder, JaxDense))
    Plan, mons = ((DenseFaultPlan, default_dense_monitors) if pkg == "port"
                  else (JaxPlan, jax_monitors))
    tel = Tel()
    glob = ttel if pkg == "port" else jtel
    glob.set_global(tel)      # the dense supervision's events go to the global sink
    kw = {"device": "cpu"} if pkg == "port" else {}
    try:
        sim = Sim(128, cfg, seed=5, shuffle_rounds=4, check_walk_every=4, phase_profile=2,
                  telemetry=tel, flight_recorder=Fr(tel, sample_every=4),
                  autocheckpoint=(4, str(tmp)), monitors=mons(),
                  fault_plan=Plan(seed=3, drop_p=0.1, delay_p=0.1), **kw)
        sim.run_epochs(2)
        stats = sim.finish_autocheckpoint()
    finally:
        glob.set_global(None)
    return {"sim": sim, "events": tel.bus.events, "stats": stats, "tel": tel}


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return {pkg: _dense_run(pkg, tmp_path_factory.mktemp(pkg)) for pkg in PKGS}


def test_dense_event_stream_equals_jax(dense):
    _same_stream(dense["port"]["events"], dense["jax"]["events"])
    types = {e["type"] for e in dense["port"]["events"]}
    assert {"run_start", "monitor_attach", "slot", "dense_fault", "dense_phase",
            "shard_skew", "device_memory", "checkpoint_saved", "checkpoint_final"} <= types


def test_dense_flight_recorder_and_phases(dense):
    port, jax = dense["port"], dense["jax"]
    s = port["sim"].summary()
    mem = s["device"]["memory"]
    assert mem["source"] == "host_rss" and mem["samples"] == jax["sim"].flight.memory.samples
    assert s["device"]["shard_skew"]["probes"] == jax["sim"].flight.skew_probes
    ph = s["dense_phases"]
    assert "checkpoint_capture" in ph["phases"]
    assert ph["async_phases"]["checkpoint_serialize"]["count"] == port["stats"]["saves"]
    hist = port["tel"].registry.histogram("dense_phase_ms")
    assert hist.value(phase="vote_pass")["count"] == ph["sampled_slots"]
    counts = port["tel"].registry.counts()
    assert any(k.startswith("jax_transfer_bytes_total") for k in counts)
    assert any(k.startswith("jax_donation_bytes_total;armed=0") for k in counts)
    assert port["stats"]["saves"] == jax["stats"]["saves"] == 5   # steps 4-16 and the final


# --- the spec driver ---------------------------------------------------------------

@pytest.fixture(autouse=True)
def _minimal_cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jax_set_backend("numpy")
    with jc.use_config(jc.minimal_config()), tc.use_config(tc.minimal_config()), \
            use_backend("torch", device="cpu"):
        yield
    torch.set_num_threads(n)
    jax_set_backend("numpy")


def _pkg(name):
    return tsim if name == "port" else jsim


def _tel(name, **kw):
    return (ttel if name == "port" else jtel).Telemetry(**kw)


def _faulted(name):
    pkg = _pkg(name)
    plan = pkg.FaultPlan(seed=1, drop_p=0.1, crashes=(pkg.CrashWindow(1, 3, 6),))
    return {"schedule": pkg.faulty_schedule(64, plan, n_groups=2),
            "adversaries": [pkg.Equivocator({0, 1})], "monitors": pkg.default_monitors()}


def _faulted_run(name):
    """Run to slot 4, checkpoint, resume with ``telemetry=`` and run on to
    slot 9: the streams before and after the resume, and the metrics."""
    pkg = _pkg(name)
    tel = _tel(name)
    sim = pkg.Simulation(64, accelerated_forkchoice=True, telemetry=tel, **_faulted(name))
    sim.run_until_slot(4)
    back_tel = _tel(name)
    back = pkg.Simulation.resume(sim.checkpoint(), telemetry=back_tel, **_faulted(name))
    back.run_until_slot(9)
    return tel.bus.events, back_tel.bus.events, back.metrics


@pytest.fixture(scope="module")
def faulted():
    torch.set_num_threads(1)
    jax_set_backend("numpy")
    with jc.use_config(jc.minimal_config()), tc.use_config(tc.minimal_config()), \
            use_backend("torch", device="cpu"):
        return {name: _faulted_run(name) for name in PKGS}


def test_spec_faulted_streams_equal_jax(faulted):
    (pa, pb, pm), (ja, jb, jm) = faulted["port"], faulted["jax"]
    assert pm == jm
    _same_stream(pa, ja)
    _same_stream(pb, jb)
    types = {e["type"] for e in pa + pb}
    assert {"propose", "attest", "gossip", "deliver", "handler", "slot", "crash",
            "rejoin", "monitor_attach", "merkleization"} <= types


def test_spec_resume_with_telemetry_starts_at_the_checkpoint(faulted):
    start = faulted["port"][1][0]
    assert start["type"] == "run_start" and start["resumed_at_slot"] == 5
    assert start == {**faulted["jax"][1][0], "seq": start["seq"]}


def _rider_run(name):
    pkg = _pkg(name)
    tel = _tel(name, debug=True)
    engine = (TBlobEngine(tc.cfg(), device="cpu") if name == "port" else JBlobEngine())
    sim = pkg.Simulation(16, das=engine, telemetry=tel)
    sim.attach_das_clients(200, seed=3)
    sim.attach_light_client()
    sim.run_until_slot(8)
    sim.flush_light_clients()
    return sim, tel


@pytest.fixture(scope="module")
def riders():
    torch.set_num_threads(1)
    jax_set_backend("numpy")
    with jc.use_config(jc.minimal_config()), tc.use_config(tc.minimal_config()), \
            use_backend("torch", device="cpu"):
        return {name: _rider_run(name) for name in PKGS}


def test_spec_rider_stream_equals_jax(riders):
    (psim, ptel), (jsim_, jtel_) = riders["port"], riders["jax"]
    _same_stream(ptel.bus.events, jtel_.bus.events)
    types = [e["type"] for e in ptel.bus.events]
    assert {"das_attach", "das_serve", "light_client_lag"} <= set(types)
    assert "invariant_violation" not in types
    assert all(g.invariants is not None for g in psim.groups)
    assert [e for e in ptel.bus.events if e["type"] == "light_client_lag"][-1]["offchain"]


def test_spec_rider_registry_counters_equal_jax(riders):
    """The copied DAS server's and ``BlobStore``'s counters, and the
    handler counters, equal the JAX package's."""
    (_, ptel), (_, jtel_) = riders["port"], riders["jax"]
    pc, jc_ = ptel.registry.counts(), jtel_.registry.counts()
    keys = [k for k in jc_ if k.startswith(("das_", "handler_calls_total", "blob_",
                                            "carried_attestation"))]
    assert keys and {k: pc.get(k) for k in keys} == {k: jc_[k] for k in keys}


# --- the runtime legs on the CPU -----------------------------------------------------

@pytest.fixture
def registry():
    reg = ttel.MetricsRegistry()
    torchrt.install(reg)
    yield reg
    torchrt.install(None)
    torchrt.attach_ledger(None)


def test_torchrt_counts_builds_launches_transfers(registry, monkeypatch):
    from pos_evolution_tpu_torch.profiling.ledger import CompileLedger
    led = CompileLedger(registry=registry)
    torchrt.attach_ledger(led)
    pt = PhaseTimer(sample_every=1, registry=registry)
    pt.begin_slot(1)
    with pt.phase("vote_pass"):
        for fn in kernels.build_listeners:      # what build_all calls after a build
            fn("merkle_level.cu", 2.5)
        torchrt.record_transfer(64, direction="d2h", site="x")
    with ledger.function_scope("digest"):
        for fn in kernels.build_listeners:
            fn("agg_sig.cu", 1.0)
    pt.end_slot(1)
    torchrt.record_dispatch(3, site="resident_head")
    torchrt.record_donation(100, site="epoch_step")
    monkeypatch.setitem(kernels._entries, "agg_sig", lambda *a: 0)
    before = kernels.launches["agg_sig"]
    torchrt.collect_launches()
    for _ in range(5):
        kernels.launch("agg_sig")
    assert torchrt.collect_launches() == {"agg_sig": 5}
    kernels.launches["agg_sig"] = before
    c = registry.counts()
    assert c["kernel_builds_total;source=merkle_level.cu"] == 1
    assert c["kernel_build_seconds;source=merkle_level.cu;stat=count"] == 1
    assert c["kernel_launches_total;kernel=agg_sig"] == 5
    assert c["jax_dispatches_total;site=resident_head"] == 3
    assert c["jax_transfer_bytes_total;direction=d2h;site=x"] == 64
    assert c["jax_transfer_bytes_by_phase_total;direction=d2h;phase=vote_pass"] == 64
    assert c["jax_donation_bytes_total;armed=0;site=epoch_step"] == 100
    rows = {(r["source"], r["function"], r["phase"]): r["count"] for r in led.rows()}
    assert rows == {("merkle_level.cu", "inline:vote_pass", "vote_pass"): 1,
                    ("agg_sig.cu", "digest", "?"): 1}
    assert led.attribution()["named_pct"] == 100.0
    assert pt.summary()["accounted_pct"] is not None


def test_memory_sampler_and_flight_recorder_on_cpu(tmp_path, registry):
    tel = ttel.Telemetry(registry=registry)
    fr = ttel.FlightRecorder(tel, sample_every=2).install()
    assert fr.installed and torchrt.current() is registry
    fr.on_slot(2)
    fr.on_slot(3)                      # not a probed slot
    fr.sample_memory(site="checkpoint", slot=3)
    rows = fr.probe_skew("vote_pass", torch.zeros(4), slot=2)
    assert rows[0]["device"] == "cpu" and fr.probe_skew("x", [1, 2]) == []
    s = fr.summary()
    assert s["memory"]["samples"] == 2 and s["memory"]["source"] == "host_rss"
    assert s["memory"]["peak_bytes"]["host"] > 0
    assert [e["site"] for e in tel.bus.of_type("device_memory")] == ["slot", "checkpoint"]
    assert len(tel.bus.of_type("shard_skew")) == 1
    doc = fr.write_artifact(str(tmp_path / "run_device_ledger.json"))
    assert json.loads((tmp_path / "run_device_ledger.json").read_text()) == \
        json.loads(json.dumps(doc))
    fr.detach()
    assert torchrt.current_ledger() is None
    assert tdevice.shard_completion_times(object()) == []


def test_telemetry_to_file_appends(tmp_path):
    path = tmp_path / "events.jsonl"
    a = ttel.Telemetry.to_file(path)
    a.bus.emit("one")
    a.close()
    b = ttel.Telemetry.to_file(path, append=True).install_global()
    try:
        ttel.emit_global("two", x=1)
    finally:
        ttel.set_global(None)
    b.close()
    assert ttel.emit_global("three") is None
    evs = ttel.read_jsonl(str(path))
    assert [(e["seq"], e["type"]) for e in evs] == [(0, "one"), (1, "two")]
