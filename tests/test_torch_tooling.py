"""The port's offline tools against the JAX package's scripts, on the same
inputs: ``run_report`` (dict and markdown), ``perf_gate``, ``perf_diff``,
``trace_merge`` (a byte-for-byte copy) and ``obs_top --once`` each give the
JAX script's output exactly. The inputs are ``tests/golden_telemetry.jsonl``
and what the port writes on the CPU in a few seconds: a dense
``resilient_run`` at 256 validators killed once and resumed (its events,
emission and heartbeat), and a small multi-process serving run (its events,
span files, worker heartbeats and fleet snapshots). The sections only the
port fills (kernel builds, the build ledger, Kineto top ops folded by
kernel, ``kernel_launches_total``, checkpoint digest launches) equal the
port's own counters. None of the tools imports torch or touches a device.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

pytest.importorskip("torch")

from pos_evolution_tpu_torch import obs_top, perf_diff, perf_gate, run_report  # noqa: E402
from pos_evolution_tpu_torch import trace_merge  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden_telemetry.jsonl")


def _script(name):
    """The JAX package's script ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    return {name: _script(name)
            for name in ("run_report", "perf_gate", "perf_diff", "trace_merge", "obs_top")}


def _run(main_fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main_fn(argv)
    return rc, out.getvalue(), err.getvalue()


# a small multi-process serving run on the CPU: 1 front x 2 worker processes,
# every request traced, the heartbeats and snapshots kept in run/
_SERVE = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, {repo!r})

    def main(root):
        from pos_evolution_tpu_torch.serve.harness import run_mp_scenario
        from pos_evolution_tpu_torch.telemetry import Telemetry
        tel = Telemetry.to_file(os.path.join(root, "events.jsonl"))
        tel.bus.emit("serve_mp_attach", fronts=1, workers=2, arrivals=200, rate=400.0,
                     chaos=None)
        steady = run_mp_scenario(
            n_fronts=1, workers_per_front=2, arrivals=200, rate=400.0, seed=3, kills=0,
            wedges=0, fd_exhaust_n=0, run_dir=os.path.join(root, "run"), events_bus=tel.bus,
            trace_rate=1.0, trace_dir=os.path.join(root, "trace"), ready_grace_s=1.0,
            device="cpu")
        tel.bus.emit("serve_mp_summary", steady=steady, chaos=None)
        tel.close()
        print(json.dumps(steady["verdict"]))

    if __name__ == "__main__":
        main(sys.argv[1])
""")


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's files on the CPU: the resilient run and the serving run,
    in processes of their own, started together."""
    root = tmp_path_factory.mktemp("tooling")
    res, srv = root / "resilient", root / "serve"
    res.mkdir()
    srv.mkdir()
    (root / "serve_run.py").write_text(_SERVE.format(repo=REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "pos_evolution_tpu_torch.resilient_run", "--dense",
             "--validators", "256", "--config", "minimal", "--epochs", "2", "--every", "4",
             "--crash-at-slot", "10", "--ckpt-dir", str(res / "store"),
             "--events", str(res / "events.jsonl"), "--json", str(res / "emission.json"),
             "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO),
        subprocess.Popen([sys.executable, str(root / "serve_run.py"), str(srv)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)]
    for proc in procs:
        out = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, out[-3000:]
    return {"resilient": res, "serve": srv}


def test_trace_merge_is_a_byte_copy_of_the_script():
    with open(os.path.join(REPO, "scripts", "trace_merge.py"), "rb") as f:
        script = f.read()
    with open(os.path.join(REPO, "pos_evolution_tpu_torch", "trace_merge.py"), "rb") as f:
        assert f.read() == script


# --- run_report ------------------------------------------------------------------

def _logs(port_runs) -> dict:
    return {"golden": GOLDEN,
            "resilient": str(port_runs["resilient"] / "events.jsonl"),
            "serve_mp": str(port_runs["serve"] / "events.jsonl")}


@pytest.mark.parametrize("log", ["golden", "resilient", "serve_mp"])
def test_run_report_equals_the_script(jax_scripts, port_runs, tmp_path, log):
    path = _logs(port_runs)[log]
    outs = {}
    for name, main in (("jax", jax_scripts["run_report"].main), ("port", run_report.main)):
        js, md = tmp_path / f"{name}.json", tmp_path / f"{name}.md"
        rc, _, err = _run(main, [path, "--json", str(js), "--markdown", str(md)])
        assert rc == 0, err
        outs[name] = (json.loads(js.read_text()), md.read_text(), err)
    assert outs["port"] == outs["jax"]
    report = outs["port"][0]
    if log == "resilient":
        res = report["resilience"]
        assert [i["reason"] for i in res["interruptions"]] == ["crash"]
        emission = json.loads((port_runs["resilient"] / "emission.json").read_text())
        assert res["goodput"]["goodput_pct"] == emission["goodput_pct"]
        assert res["replayed_slots"] == emission["replayed_slots"] > 0
    if log == "serve_mp":
        assert report["serving_mp"]["steady"]["verified_proofs"] > 0


def test_run_report_builds_the_same_dict(jax_scripts, port_runs):
    for log in _logs(port_runs).values():
        events, _ = run_report.load_events(log)
        jevents, _ = jax_scripts["run_report"].load_events(log)
        assert events == jevents
        assert run_report.build_report(events) == jax_scripts["run_report"].build_report(events)


# --- perf_gate and perf_diff --------------------------------------------------------

@pytest.fixture(scope="module")
def emissions(port_runs, tmp_path_factory):
    """The resilient run's emission, one with every count doubled, one
    with a kernel launch counter added, and a run report's JSON."""
    root = tmp_path_factory.mktemp("emissions")
    base = json.loads((port_runs["resilient"] / "emission.json").read_text())
    worse = json.loads(json.dumps(base))
    worse["counts"] = {k: 2 * v + 8 for k, v in base["counts"].items()}
    worse["run_wall_s"] = base["run_wall_s"] * 3
    kern = json.loads(json.dumps(base))
    kern["counts"]["kernel_launches_total;kernel=merkle_level"] = 18
    report = run_report.build_report(run_report.load_events(
        str(port_runs["resilient"] / "events.jsonl"))[0])
    paths = {}
    for name, doc in (("base", base), ("worse", worse), ("kern", kern), ("report", report)):
        paths[name] = str(root / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(doc, f)
    return paths


GATE_CASES = [
    ("pass", "base", "base", []),
    ("regression", "worse", "base", []),
    ("timings reported", "worse", "base", ["--rel-tol", "1.5"]),
    ("count only", "worse", "base", ["--count-only"]),
    ("strict timing", "base", "worse", ["--strict-timing"]),
    ("a new counter", "kern", "base", ["--count-only"]),
    ("incomparable shapes", "report", "base", ["--count-only"]),
]


@pytest.mark.parametrize("case, cand, base, flags", GATE_CASES, ids=[c[0] for c in GATE_CASES])
def test_perf_gate_equals_the_script(jax_scripts, emissions, case, cand, base, flags):
    argv = ["--candidate", emissions[cand], "--baseline", emissions[base], *flags]
    assert _run(perf_gate.main, argv) == _run(jax_scripts["perf_gate"].main, argv)


def test_perf_gate_history_equals_the_script(jax_scripts, emissions, tmp_path):
    from pos_evolution_tpu_torch.profiling import history
    hist = str(tmp_path / "history.jsonl")
    for name in ("base", "base", "kern", "base"):
        with open(emissions[name]) as f:
            history.append_entry(hist, json.load(f), kind="bench_resilience")
    for argv in (["--history", hist, "--list-kinds"],
                 ["--history", hist, "--candidate", emissions["worse"], "--count-only"],
                 ["--history", hist, "--candidate", emissions["base"], "--max-abs-ratio", "8"],
                 ["--history", hist, "--candidate", emissions["base"], "--kind", "bench"]):
        assert _run(perf_gate.main, argv) == _run(jax_scripts["perf_gate"].main, argv)


def test_perf_gate_fails_a_doubled_kernel_launch_count(emissions, tmp_path):
    """The port's count metric: ``kernel_launches_total{kernel}`` doubled
    fails the gate, as the smoke's phase 42 (d) checks on the card."""
    with open(emissions["kern"]) as f:
        doc = json.load(f)
    doc["counts"]["kernel_launches_total;kernel=merkle_level"] *= 2
    doubled = tmp_path / "doubled.json"
    doubled.write_text(json.dumps(doc))
    same = _run(perf_gate.main, ["--candidate", emissions["kern"], "--baseline",
                                 emissions["kern"], "--count-only"])
    worse = _run(perf_gate.main, ["--candidate", str(doubled), "--baseline",
                                  emissions["kern"], "--count-only"])
    assert same[0] == 0 and worse[0] == 1
    assert "[FAIL] kernel_launches_total;kernel=merkle_level: baseline=18 candidate=36" in worse[1]
    assert "x2.0" in worse[1]   # perf_diff's attribution names it
    rc, _, err = _run(perf_gate.main, ["--candidate", emissions["kern"]])
    assert rc == 2 and "no baseline found (None)" in err   # the JAX BENCH files are not the port's


@pytest.mark.parametrize("pair", [("base", "worse"), ("worse", "kern"), ("base", "report"),
                                  ("resilient_events", "serve_events")])
def test_perf_diff_equals_the_script(jax_scripts, emissions, port_runs, pair):
    paths = {**emissions,
             "resilient_events": str(port_runs["resilient"] / "events.jsonl"),
             "serve_events": str(port_runs["serve"] / "events.jsonl")}
    a, b = (paths[p] for p in pair)
    jd = jax_scripts["perf_diff"]
    assert perf_diff.diff(perf_diff.load_side(a), perf_diff.load_side(b)) == \
        jd.diff(jd.load_side(a), jd.load_side(b))
    assert _run(perf_diff.main, [a, b]) == _run(jd.main, [a, b])


def test_perf_diff_names_kernel_builds(jax_scripts):
    """The port's build-ledger rows (a source each) diff as kernel builds;
    a JAX-shaped ledger diffs as the JAX script diffs it."""
    def doc(rows):
        return {"device": {"compile_ledger": {"rows": rows}}}
    row = {"stage": "build", "source": "merkle_level.cu", "function": "inline:vote_pass",
           "phase": "vote_pass", "count": 1, "seconds": 4.1}
    d = perf_diff.diff(doc([]), doc([row, {**row, "source": "agg_sig.cu", "count": 2}]))
    assert d["compile_ledger"] == [
        {"stage": "build", "source": "agg_sig.cu", "function": "inline:vote_pass",
         "phase": "vote_pass", "baseline": 0, "candidate": 2, "delta": 2},
        {"stage": "build", "source": "merkle_level.cu", "function": "inline:vote_pass",
         "phase": "vote_pass", "baseline": 0, "candidate": 1, "delta": 1}]
    assert "kernel-build deltas" in perf_diff.render(d)
    assert "agg_sig.cu" in perf_diff.render(d)
    jrow = {"stage": "backend_compile", "function": "epoch", "phase": "vote_pass", "count": 3}
    jd = jax_scripts["perf_diff"]
    assert perf_diff.diff(doc([]), doc([jrow])) == jd.diff(doc([]), doc([jrow]))
    assert perf_diff.render(perf_diff.diff(doc([]), doc([jrow]))) == \
        jd.render(jd.diff(doc([]), doc([jrow])))


# --- trace_merge and obs_top ----------------------------------------------------------

def test_trace_merge_equals_the_script(jax_scripts, port_runs, tmp_path):
    trace = str(port_runs["serve"] / "trace")
    files = [f for f in os.listdir(trace) if f.startswith("spans.")]
    outs = []
    for main in (trace_merge.main, jax_scripts["trace_merge"].main):
        out = str(tmp_path / "merged.json")
        got = _run(main, [trace, "--out", out, "--expect-pids", str(len(files))])
        with open(out) as f:
            outs.append((got, f.read()))
    assert outs[0] == outs[1]
    assert outs[0][0][0] == 0 and len(files) >= 2
    lanes = [e for e in json.loads(outs[0][1])["traceEvents"] if e.get("name") == "process_name"]
    assert len(lanes) == len(files)
    assert _run(trace_merge.main, [trace, "--out", str(tmp_path / "m.json"),
                                   "--expect-pids", str(len(files) + 1)])[0] == 1


def test_obs_top_once_equals_the_script(jax_scripts, port_runs, monkeypatch):
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)   # one clock for both views
    runs = [["--dir", str(port_runs["serve"] / "run"), "--once"],
            ["--dir", str(port_runs["resilient"] / "store"), "--once",
             "--events", str(port_runs["resilient"] / "events.jsonl")]]
    for argv in runs:
        got = _run(obs_top.main, argv)
        assert got == _run(jax_scripts["obs_top"].main, argv)
        assert got[0] == 0
    out = _run(obs_top.main, runs[0])[1]
    for w in (0, 1):
        assert f"hb worker{w}.hb" in out and f"\n  worker {w} " in out


# --- the sections only the port fills --------------------------------------------------

def test_device_section_holds_the_ports_kernel_counters(tmp_path):
    """A flight recorder's artifact beside the log: the Device section's
    build ledger and ``kernels`` equal the recorder's ledger and its
    registry's ``kernel_builds_total`` / ``kernel_launches_total``."""
    from pos_evolution_tpu_torch.ops import kernels
    from pos_evolution_tpu_torch.telemetry import FlightRecorder, Telemetry, torchrt
    tel = Telemetry.to_file(str(tmp_path / "events.jsonl"))
    fr = FlightRecorder(tel).install()
    try:
        torchrt._on_build("merkle_level.cu", 4.25)      # what ops/kernels.build_all calls
        torchrt.collect_launches()
        with kernels._LAUNCH_LOCK:                   # seven K2 launches, as launch counts them
            kernels.launches["merkle_level"] += 7
        tel.bus.emit("slot", slot=1)
        doc = fr.write_artifact(str(tmp_path / "run_device_ledger.json"))
    finally:
        fr.detach()
        torchrt.install(None)
        with kernels._LAUNCH_LOCK:
            kernels.launches["merkle_level"] -= 7
    tel.close()
    counts = tel.registry.counts()
    assert counts["kernel_builds_total;source=merkle_level.cu"] == 1
    assert counts["kernel_launches_total;kernel=merkle_level"] == 7
    js, md = tmp_path / "r.json", tmp_path / "r.md"
    rc, _, err = _run(run_report.main, [str(tmp_path / "events.jsonl"), "--json", str(js),
                                        "--markdown", str(md)])
    assert rc == 0 and "auto-discovered device ledger" in err
    dev = json.loads(js.read_text())["device"]
    assert dev["kernels"] == {"builds": {"merkle_level.cu": 1}, "launches": {"merkle_level": 7}}
    assert dev["compile_ledger"] == doc["flight_recorder"]["compile_ledger"]
    assert dev["compile_ledger"]["rows"] == [
        {"stage": "build", "source": "merkle_level.cu", "function": "?", "phase": "?",
         "count": 1, "seconds": 4.25}]
    text = md.read_text()
    assert "- build ledger: **0/1** kernel builds" in text
    assert "| kernel_launches_total | kernel=merkle_level | 7 |" in text
    top = _run(obs_top.main, ["--dir", str(tmp_path), "--once"])[1]
    assert "kernel builds: 1 (0.0% named)" in top and "kernel launches: merkle_level=7" in top
    assert "top build row: merkle_level.cu ? phase=? x1 (4.25s)" in top


def test_checkpoint_digest_launches_and_worker_interruptions(tmp_path):
    log = tmp_path / "events.jsonl"
    evs = [{"type": "checkpoint_saved", "step": 32, "blocked_ms": 40.0},
           {"type": "checkpoint_final", "slot": 64, "bytes": 6826502},
           {"type": "goodput", "attempts": 2, "goodput_pct": 88.89,
            "ckpt_digest_launches": {"merkle_level": 36}},
           {"type": "worker_interruption", "worker": 1, "reason": "crash", "pid": 77,
            "exit_code": -9, "wall_s": 3.5},
           {"type": "serve_mp_summary", "steady": {"fronts": 1, "workers": 2}, "chaos": None}]
    log.write_text("".join(json.dumps({"v": 1, "seq": i, **e}) + "\n"
                           for i, e in enumerate(evs)))
    report = run_report.build_report(run_report.load_events(str(log))[0])
    assert report["resilience"]["checkpoint_digest_launches"] == {"merkle_level": 36}
    assert report["serving_mp"]["interruption_events"] == [
        {"worker": 1, "reason": "crash", "pid": 77, "exit_code": -9, "wall_s": 3.5}]
    text = run_report.to_markdown(report)
    assert "checkpoint digest launches (final attempt): {'merkle_level': 36}" in text
    assert "worker_interruption events: 1" in text


def test_top_ops_are_found_through_the_profile_event_and_folded_by_kernel(tmp_path):
    """A Kineto top-ops table where ``Simulation(profile=)`` wrote it, found
    only through the log's ``profile_artifacts`` event; its device rows
    folded by kernel function across the ranges that launched them."""
    prof, logs = tmp_path / "profile", tmp_path / "logs"
    prof.mkdir()
    logs.mkdir()
    k2 = "merkle_level_kernel(int const*, int, int const*, int, int*, int)"
    table = {"/device:GPU:0": [
        {"op": f"sim_run/slot/propose/{k2}", "total_ms": 1.5, "count": 147},
        {"op": f"sim_run/slot/on_block/{k2}", "total_ms": 3.0, "count": 294},
        {"op": "sim_run/slot/aggregate_verify/(anonymous namespace)::agg_sig_kernel(int*)",
         "total_ms": 0.25, "count": 2},
        {"op": "sim_run/slot/aten::add/void at::native::vectorized_elementwise_kernel"
               "<4, at::native::AddFunctor<long>, std::array<char*, 3ul> >(int, "
               "at::native::AddFunctor<long>)", "total_ms": 0.125, "count": 9}],
        "/host:CPU": [{"op": "sim_run", "total_ms": 50.0, "count": 1}]}
    (prof / "top_ops.json").write_text(json.dumps({"source": "profiled_region", "planes": table}))
    (logs / "events.jsonl").write_text(json.dumps(
        {"v": 1, "seq": 0, "type": "profile_artifacts", "dir": str(prof),
         "files": ["top_ops.json"]}) + "\n")
    js = tmp_path / "r.json"
    rc, out, err = _run(run_report.main, [str(logs / "events.jsonl"), "--json", str(js)])
    assert rc == 0 and f"auto-discovered top-ops table: {prof / 'top_ops.json'}" in err
    report = json.loads(js.read_text())
    assert report["top_device_ops"] == table
    assert report["top_device_kernels"] == {"/device:GPU:0": {
        "merkle_level_kernel": {"count": 441, "total_ms": 4.5, "paths": 2},
        "agg_sig_kernel": {"count": 2, "total_ms": 0.25, "paths": 1},
        "vectorized_elementwise_kernel": {"count": 9, "total_ms": 0.125, "paths": 1}}}
    assert "| merkle_level_kernel | 4.5 | 441 | 2 |" in out


def test_cost_table_lands_under_cost_analysis(tmp_path):
    cost = {"backend": "cuda", "n_validators": 1024,
            "kernels": {"epoch_sweep": {"flops": 1, "bytes_accessed": 2, "temp_bytes": 3,
                                        "peak_bytes": 4}}}
    (tmp_path / "cost.json").write_text(json.dumps(cost))
    rc, out, _ = _run(run_report.main, [GOLDEN, "--cost", str(tmp_path / "cost.json"),
                                        "--json", str(tmp_path / "r.json")])
    assert rc == 0 and json.loads((tmp_path / "r.json").read_text())["cost_analysis"] == cost
    assert "| epoch_sweep | 1 | 2 | 3 | 4 |" in out


def test_xplane_flag_reads_kineto_traces(tmp_path):
    """``--xplane`` over a directory of torch.profiler traces (no xplane
    file): the table ``profiling/kineto`` reads from them."""
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "merkle_level_kernel", "pid": 0, "tid": 7,
         "ts": 10.0, "dur": 2.0, "args": {"device": 0, "stream": 7, "correlation": 1}}],
        "baseTimeNanoseconds": 0}
    (tmp_path / "host.pt.trace.json").write_text(json.dumps(trace))
    rc, _, _ = _run(run_report.main, [GOLDEN, "--xplane", str(tmp_path),
                                      "--json", str(tmp_path / "r.json")])
    report = json.loads((tmp_path / "r.json").read_text())
    assert rc == 0
    assert report["top_device_kernels"]["/device:GPU:0"]["merkle_level_kernel"]["count"] == 1


def test_the_tools_import_no_torch():
    code = ("import sys\n"
            "from pos_evolution_tpu_torch import obs_top, perf_diff, perf_gate, run_report, "
            "trace_merge\n"
            "import pos_evolution_tpu_torch.analysis.__main__\n"
            "from pos_evolution_tpu_torch.profiling import history, kineto, xplane\n"
            "import pos_evolution_tpu_torch.resilience\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
