"""The spec driver's DAS and light-client riders in the port against the
JAX package's on the CPU, tolerance 0: the port on its CPU torch backend
with one intra-op thread, the JAX package on its numpy backend, both on
the minimal config, each run made once per module and held against its
twin — per-slot records, every view's verified blob keys, the DAS
server's counters and the served summaries (their wall-clock fields
aside), each light client's ``summary()`` (its timings aside) and
``records``:

- ``Simulation(32, das=True)`` with 2,000 sampling clients and one light
  client for 4 epochs, then ``flush_light_clients``;
- the same population under a lossy plan for 2 epochs, with sidecars
  pulled by req/resp at import, and its checkpoint after epoch 1 resumed
  across the packages both ways (a resume with another engine seed
  refused);
- a light client following a faulted 72-slot chain to the full node's
  finalized root;
- the kzg scheme's aggregate serving, one proposal and one served block
  at the smallest kzg geometry (a pairing check on the plain field
  arithmetic takes tens of seconds on a CPU)."""

import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu import config as jc  # noqa: E402
from pos_evolution_tpu import sim as jsim  # noqa: E402
from pos_evolution_tpu.backend import set_backend as jax_set_backend  # noqa: E402
from pos_evolution_tpu.das import BlobEngine as JBlobEngine  # noqa: E402
from pos_evolution_tpu_torch import config as tc  # noqa: E402
from pos_evolution_tpu_torch import convert  # noqa: E402
from pos_evolution_tpu_torch import sim as tsim  # noqa: E402
from pos_evolution_tpu_torch.backend import use_backend  # noqa: E402
from pos_evolution_tpu_torch.das import BlobEngine as TBlobEngine  # noqa: E402

PKGS = ("port", "jax")
TIMING = ("p50_ms", "p95_ms", "verify_ms")
_RUNS: dict = {}


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


def _spe() -> int:
    return jc.minimal_config().slots_per_epoch


def _pkg(name):
    return tsim if name == "port" else jsim


def _engine(name, **kw):
    return (TBlobEngine(tc.cfg(), device="cpu", **kw) if name == "port"
            else JBlobEngine(**kw))


def _once(key, make):
    if key not in _RUNS:
        _RUNS[key] = make()
    return _RUNS[key]


def _record_serves(sim) -> list:
    """Wrap the sim's DAS server so that every served summary is kept,
    its wall-clock fields dropped."""
    served = []
    inner = sim.das_server.serve_samples

    def serve(*args):
        summary = inner(*args)
        served.append({k: v for k, v in summary.items() if k not in TIMING})
        return summary

    sim.das_server.serve_samples = serve
    return served


def _state(sim, served=None) -> dict:
    """What the twins must share: per-slot records, each view's blob keys
    and sidecar commitments, the DAS server's counters and summaries, and
    each light client's summary and records."""
    out = {"metrics": sim.metrics, "slot": sim.slot,
           "blob_keys": [sorted((r, i, sorted(c)) for (r, i), c in g.blob_store.sidecars.items())
                         if g.blob_store is not None else None for g in sim.groups]}
    server = sim.das_server
    if server is not None:
        out["server"] = (server.served_blocks, server.samples_served, server.scheme_builds,
                         server.proof_cache.hits, server.proof_cache.misses,
                         server.update_cache.hits, server.update_cache.misses,
                         sim.das_population.blocks_sampled, sim.das_population.samples_drawn)
    if served is not None:
        out["served"] = served
    out["light_clients"] = []
    for node in sim.light_clients:
        summary = node.summary()
        summary.pop("timing")
        out["light_clients"].append((summary, node.records, node.finalized_root()))
    return out


# --- the honest rider run -------------------------------------------------------------

def _honest(name) -> dict:
    sim = _pkg(name).Simulation(32, das=True)
    sim.attach_das_clients(2000, seed=7)
    node = sim.attach_light_client()
    served = _record_serves(sim)
    sim.run_epochs(4)
    sim.flush_light_clients()
    final = bytes(sim.store(0).finalized_checkpoint.root)
    return {**_state(sim, served), "lc_on_final": node.finalized_root() == final,
            "finalized": sim.finalized_epoch()}


@pytest.mark.parametrize("part", ["metrics", "blob_keys", "server", "served", "light_clients"])
def test_honest_rider_run_equals_jax(part):
    port, jax = (_once(("honest", p), lambda p=p: _honest(p)) for p in PKGS)
    assert port[part] == jax[part]


def test_honest_rider_run_serves_and_follows():
    port = _once(("honest", "port"), lambda: _honest("port"))
    assert port["finalized"] >= 2 and port["lc_on_final"]
    assert all(s["failed"] == 0 and s["clients_all_ok"] == 2000 for s in port["served"])
    summary, records, _root = port["light_clients"][0]
    assert summary["rejected"] == 0 and summary["applied"] > 0 and records


# --- the lossy run, its backfills and its checkpoint ------------------------------------

def _lossy_schedule(pkg):
    c = jc.minimal_config()
    plan = pkg.lossy_plan(seed=13, drop_p=0.15, gst=c.slots_per_epoch * c.seconds_per_slot)
    return pkg.faulty_schedule(32, plan)


def _lossy(name) -> dict:
    """The lossy run to the end of epoch 2, checkpointed after epoch 1;
    the sidecars each view pulled from the archive at import."""
    pkg = _pkg(name)
    sim = pkg.Simulation(32, schedule=_lossy_schedule(pkg), das=True)
    sim.attach_das_clients(2000, seed=7)
    served = _record_serves(sim)
    pulled = []
    resolve = sim._resolve_blobs

    def counting(group, signed_block):
        before = sum(len(c) for c in group.blob_store.sidecars.values())
        resolve(group, signed_block)
        pulled.append(sum(len(c) for c in group.blob_store.sidecars.values()) - before)

    sim._resolve_blobs = counting
    sim.run_until_slot(_spe())
    data = sim.checkpoint()
    sim.run_until_slot(2 * _spe())
    return {"state": _state(sim, served), "checkpoint": data, "pulled": sum(pulled)}


@pytest.mark.parametrize("part", ["metrics", "blob_keys", "server", "served"])
def test_lossy_rider_run_equals_jax(part):
    port, jax = (_once(("lossy", p), lambda p=p: _lossy(p)) for p in PKGS)
    assert port["state"][part] == jax["state"][part]


def test_lossy_rider_run_backfills_sidecars():
    port, jax = (_once(("lossy", p), lambda p=p: _lossy(p)) for p in PKGS)
    assert port["pulled"] == jax["pulled"] > 0
    assert all(s["failed"] == 0 and s["clients_all_ok"] == 2000 for s in port["state"]["served"])
    assert port["checkpoint"] == jax["checkpoint"]


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_das_checkpoint_resumes_across_packages(src, dst):
    """Each package's checkpoint after epoch 1, resumed by the other with
    its engine and a fresh population, continued 1 epoch: the records and
    blob keys of the uninterrupted run; the two resumed runs' servers
    agree with each other."""
    runs = {p: _once(("lossy", p), lambda p=p: _lossy(p)) for p in PKGS}
    pkg = _pkg(dst)

    def resumed(name):
        data = runs[src if name == dst else dst]["checkpoint"]
        schedule = _lossy_schedule(_pkg(name))
        if name == "port":       # the JAX run's engine carried across by its describe()
            engine = convert.blob_engine_to_port(JBlobEngine().describe(), tc.cfg(), "cpu")
            sim = convert.simulation_to_port(data, schedule=schedule, device="cpu", das=engine)
        else:
            sim = jsim.Simulation.resume(data, schedule=schedule, das=JBlobEngine())
        sim.attach_das_clients(2000, seed=7)
        served = _record_serves(sim)
        sim.run_until_slot(2 * _spe())
        return _state(sim, served)

    got = _once(("resumed", src, dst), lambda: resumed(dst))
    other = _once(("resumed", dst, src), lambda: resumed(src))
    want = runs[dst]["state"]
    assert got["metrics"] == want["metrics"] and got["blob_keys"] == want["blob_keys"]
    assert got["server"] == other["server"] and got["served"] == other["served"]
    with pytest.raises(ValueError, match="does not match"):
        pkg.Simulation.resume(runs[src]["checkpoint"], schedule=_lossy_schedule(pkg),
                              das=_engine(dst, seed=1))


# --- a light client on a faulted chain ------------------------------------------------

def _follow(name) -> dict:
    pkg = _pkg(name)
    c = jc.minimal_config()
    plan = pkg.lossy_plan(seed=7, drop_p=0.10, gst=7 * c.slots_per_epoch * c.seconds_per_slot)
    sim = pkg.Simulation(64, schedule=pkg.faulty_schedule(64, plan))
    node = sim.attach_light_client()
    sim.run_until_slot(9 * c.slots_per_epoch)
    sim.flush_light_clients()
    full = sim.store(0)
    root = bytes(full.finalized_checkpoint.root)
    return {**_state(sim), "finalized": sim.finalized_epoch(),
            "on_final": node.finalized_root() == root,
            "final_slot": node.finalized_slot == int(full.blocks[root].slot)}


def test_light_client_follows_faulted_chain_equal_to_jax():
    port, jax = (_once(("follow", p), lambda p=p: _follow(p)) for p in PKGS)
    assert port == jax
    assert port["finalized"] >= 5 and port["on_final"] and port["final_slot"]
    summary, records, _root = port["light_clients"][0]
    assert summary["applied"] > 0 and summary["rejected"] == 0
    assert len(records) >= 72 and records[-1]["finality_lag"] == 0


# --- the kzg scheme's aggregate serving ----------------------------------------------

def test_kzg_rider_serving_equals_jax():
    """``Simulation(16, das=BlobEngine(n_blobs=1, scheme="kzg"))`` with 64
    clients through slot 1, blobs of 4 cells of one 16-byte chunk: one
    proposal and one aggregate proof served and verified."""
    geometry = dict(das_cells_per_blob=2, das_cell_bytes=16)
    out = []
    with jc.use_config(jc.minimal_config().replace(**geometry)), \
            tc.use_config(tc.minimal_config().replace(**geometry)):
        for name in PKGS:
            sim = _pkg(name).Simulation(16, das=_engine(name, n_blobs=1, scheme="kzg"))
            sim.attach_das_clients(64)
            served = _record_serves(sim)
            sim.run_until_slot(1)
            out.append(_state(sim, served))
    assert out[0] == out[1]
    (summary,) = out[0]["served"]
    assert summary["aggregated"] and summary["failed"] == 0 and summary["clients_all_ok"] == 64


def test_blob_engine_to_port():
    """A JAX engine's ``describe()`` gives the port's engine of the same
    scheme, blob count and seed, whose sidecars are the JAX engine's."""
    jeng = JBlobEngine(n_blobs=1, seed=9)
    engine = convert.blob_engine_to_port(jeng.describe(), tc.cfg(), "cpu")
    assert engine.describe() == jeng.describe()
    grids, coms, graffiti = engine.build_for(3, bytes(32))
    assert (coms, graffiti) == tuple(jeng.build_for(3, bytes(32))[1:])
    with pytest.raises(ValueError, match="not a blob engine"):
        convert.blob_engine_to_port({"kind": "das_population"}, tc.cfg(), "cpu")
