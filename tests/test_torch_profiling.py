"""The port's profiling tooling against the JAX package's on the CPU.

- the trace reader (``profiling/kineto.py``) on a Kineto trace built here:
  nested ranges, an operator that launches, a launch made outside any
  operator (as ``ctypes`` launches are), a launch found only by its
  ``ac2g`` flow, a kernel with no launch record, a range projection on the
  stream that is left out; its planes survive the JAX package's xplane
  encode and parse unchanged;
- attribution and exports on the same planes and events equal the JAX
  package's, the partition too; a region's own name claims nothing a
  tighter name claims;
- ``checksum_tree`` equals the JAX one; ``fused_measure`` times a body and
  records its dispatches;
- the cost table has the JAX emission's hot paths and keys, and its
  argument and output bytes (with the documented exceptions);
- dense offloads load across the packages; a profiled ``Simulation``
  writes its artifacts and equals an unprofiled run; ``compile_cache=``
  and ``resilient_run --history``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu.backend.jax_init import ensure_x64  # noqa: E402
from pos_evolution_tpu.ops.epoch import DenseRegistry as JaxRegistry  # noqa: E402
from pos_evolution_tpu.profiling import attribution as jattr  # noqa: E402
from pos_evolution_tpu.profiling import cost as jcost  # noqa: E402
from pos_evolution_tpu.profiling import export as jexport  # noqa: E402
from pos_evolution_tpu.profiling import xplane as jxplane  # noqa: E402
from pos_evolution_tpu.profiling.history import read_history as jax_read_history  # noqa: E402
from pos_evolution_tpu.utils import snapshot as jsnap  # noqa: E402
from pos_evolution_tpu.utils.benchtime import checksum_tree as jax_checksum  # noqa: E402
from pos_evolution_tpu_torch import config as tc  # noqa: E402
from pos_evolution_tpu_torch.ops import kernels  # noqa: E402
from pos_evolution_tpu_torch.ops.epoch import DenseRegistry  # noqa: E402
from pos_evolution_tpu_torch.profiling import (  # noqa: E402
    ProfiledRegion,
    attribute_to_spans,
    group_by_jit,
    innermost_jit,
    kineto,
)
from pos_evolution_tpu_torch.profiling import export as texport  # noqa: E402
from pos_evolution_tpu_torch.profiling.cost import analyze_hot_paths  # noqa: E402
from pos_evolution_tpu_torch.sim.driver import Simulation  # noqa: E402
from pos_evolution_tpu_torch.telemetry import MetricsRegistry, Telemetry, torchrt  # noqa: E402
from pos_evolution_tpu_torch.utils import snapshot as tsnap  # noqa: E402
from pos_evolution_tpu_torch.utils.benchtime import checksum_tree, fused_measure  # noqa: E402
from pos_evolution_tpu_torch.utils.metrics import trace_region  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: tiny tensor ops under parallel test workers
    otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- a Kineto trace, built by hand ---------------------------------------------------

PID = 4242
AGG = "(anonymous namespace)::agg_sig_kernel(unsigned int const*, int)"
ADD = "void at::native::add_kernel<int>(int)"
COPY = "Memcpy DtoH (Device -> Pinned)"


def _host(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": PID, "tid": PID, "ts": ts,
            "dur": dur, "args": args}


def _dev(cat, name, ts, dur, corr, stream=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream, "ts": ts,
            "dur": dur, "args": {"device": 0, "stream": stream, "correlation": corr}}


def _trace() -> dict:
    """A region ``sim_run`` over a ``slot``; K1 launched through ctypes under
    ``aggregate_verify`` (no operator: its kernel runs after the range
    closed), torch's add and a copy under ``on_block``'s ``aten::add``, a
    kernel under ``on_block/merkle`` known only by its flow, a TorchScript
    fusion group's kernel (its operator named as the kernel, launched
    through the driver API) under ``on_block``, one launched
    directly under the region, one outside it, one with no launch record,
    and a range named with a ``/``."""
    events = [
        {"ph": "M", "name": "thread_name", "pid": PID, "tid": PID,
         "args": {"name": "thread 4242 (python)"}},
        _host("user_annotation", "sim_run", 1000.0, 1000.0),
        _host("user_annotation", "slot", 1010.0, 900.0),
        _host("user_annotation", "aggregate_verify", 1020.0, 100.0),
        _host("cuda_runtime", "cudaLaunchKernel", 1030.0, 2.0, correlation=1),
        _host("user_annotation", "on_block", 1150.0, 300.0),
        _host("cpu_op", "aten::add", 1160.0, 20.0),
        _host("cpu_op", "aten::empty", 1161.0, 2.0),
        _host("cuda_runtime", "cudaLaunchKernel", 1170.0, 3.0, correlation=2),
        _host("cuda_runtime", "cudaMemcpyAsync", 1175.0, 1.5, correlation=3),
        _host("user_annotation", "merkle", 1200.0, 50.0),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 4, "pid": PID, "tid": PID,
         "ts": 1210.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 4, "pid": 0, "tid": 7,
         "ts": 1420.0, "bp": "e"},
        _host("cpu_op", "fused_add_0", 1300.0, 10.0),
        _host("cuda_driver", "cuLaunchKernel", 1302.0, 2.0, correlation=8),
        _host("user_annotation", "io/read", 1500.0, 10.0),
        _host("cuda_runtime", "cudaLaunchKernel", 1502.0, 1.0, correlation=7),
        _host("cuda_runtime", "cudaLaunchKernel", 1950.0, 2.0, correlation=5),
        _host("cpu_op", "aten::mul", 3000.0, 5.0),
        _host("cuda_runtime", "cudaLaunchKernel", 3001.0, 2.0, correlation=6),
        _dev("kernel", AGG, 1200.0, 12.0, 1),
        _dev("kernel", ADD, 1400.0, 2.25, 2),
        _dev("gpu_memcpy", COPY, 1410.0, 1.0, 3),
        _dev("kernel", "merkle_level_kernel", 1420.0, 10.0, 4),
        _dev("kernel", "fused_add_0", 1430.0, 0.25, 8),
        _dev("kernel", "read_kernel", 1600.0, 0.5, 7, stream=13),
        _dev("kernel", "tail_kernel", 1960.0, 1.0, 5),
        _dev("kernel", "mul_kernel", 3010.0, 1.0, 6),
        _dev("kernel", "orphan_kernel", 1700.0, 4.0, 99),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "on_block", "pid": 0, "tid": 7,
         "ts": 1400.0, "dur": 30.0, "args": {}},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": "Spans",
         "tid": "PyTorch Profiler", "ts": 990.0, "dur": 3000.0, "args": {}},
    ]
    return {"schemaVersion": 1, "traceEvents": events, "traceName": "t"}


PATHS = {
    AGG: "sim_run/slot/aggregate_verify/" + AGG,
    ADD: "sim_run/slot/on_block/aten::add/" + ADD,
    COPY: "sim_run/slot/on_block/aten::add/" + COPY,
    "merkle_level_kernel": "sim_run/slot/on_block/merkle/merkle_level_kernel",
    "fused_add_0": "sim_run/slot/on_block/fused_add_0",
    "read_kernel": "sim_run/slot/io|read/read_kernel",
    "tail_kernel": "sim_run/tail_kernel",
    "mul_kernel": "aten::mul/mul_kernel",
    "orphan_kernel": "orphan_kernel",
}
DURS_MS = {AGG: 0.012, ADD: 0.00225, COPY: 0.001, "merkle_level_kernel": 0.01,
           "fused_add_0": 0.00025,
           "read_kernel": 0.0005, "tail_kernel": 0.001, "mul_kernel": 0.001,
           "orphan_kernel": 0.004}


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "w.1.pt.trace.json"
    path.write_text(json.dumps(_trace()))
    return kineto.parse_path(path.parent)


def _device_ops(planes) -> dict:
    return {op.rsplit("/", 1)[-1]: (op, dur)
            for _, _, op, _, dur in jxplane.iter_ops(jxplane.select_planes(planes))}


def test_reader_names_each_device_event_by_its_launch_path(planes):
    assert [p["name"] for p in planes] == ["/device:GPU:0", "/host:CPU"]
    gpu, host = planes
    assert [line["name"] for line in gpu["lines"]] == ["stream 7", "stream 13"]
    ops = _device_ops(planes)
    # the range projection on the stream is left out: it would count the work twice
    assert {k: op for k, (op, _) in ops.items()} == PATHS
    for name, (_, dur_ps) in ops.items():
        assert dur_ps == round(DURS_MS[name] * 1e9)
    # offsets against the line's first event, in picoseconds
    line = gpu["lines"][0]
    assert line["timestamp_ns"] == 1_200_000
    assert [e["offset_ps"] for e in line["events"]][:2] == [0, 200_000_000]
    assert host["lines"][0]["name"] == "thread 4242 (python)"
    host_ops = {op for _, _, op, _, _ in jxplane.iter_ops([host])}
    assert {"sim_run", "aten::add", "cudaLaunchKernel", "io/read"} <= host_ops


def test_reader_planes_are_the_jax_schema(planes):
    """The JAX package's wire encoder and parser carry the port's planes
    unchanged, and its summaries read them."""
    assert jxplane.parse_xspace(jxplane.encode_xspace(planes)) == planes
    top = jxplane.top_table(jxplane.summarize_planes(planes), 3)
    assert list(top)[0] == "/device:GPU:0"
    assert top["/device:GPU:0"][0] == {"op": PATHS[AGG], "total_ms": 0.012, "count": 1}


def test_innermost_range_and_grouping(planes):
    assert innermost_jit(PATHS[AGG]) == "aggregate_verify"
    assert innermost_jit(PATHS[ADD]) == "on_block"          # past the launching operator
    assert innermost_jit(PATHS["mul_kernel"]) is None
    assert innermost_jit("orphan_kernel") is None
    by = group_by_jit(planes)
    assert {k: v["count"] for k, v in by.items()} == {
        "aggregate_verify": 1, "on_block": 3, "merkle": 1, "io|read": 1, "sim_run": 1,
        "unranged": 2}
    total = sum(DURS_MS.values())
    assert sum(v["total_ms"] for v in by.values()) == pytest.approx(total, abs=1e-4)


@pytest.mark.parametrize("names", [["on_block"], ["merkle", "on_block", "aten::add"],
                                   ["slot", "kernel"], []])
def test_attribution_equals_the_jax_packages(planes, names):
    """The same planes, through the JAX package's wire format, attribute
    as the port attributes them: the same rows, summing to the trace."""
    jax_planes = jxplane.parse_xspace(jxplane.encode_xspace(planes))
    port = attribute_to_spans(planes, names)
    assert port == jattr.attribute_to_spans(jax_planes, names)
    total = sum(DURS_MS.values())
    assert sum(v["total_ms"] for v in port.values()) == pytest.approx(total, abs=1e-4)
    assert sum(v["count"] for v in port.values()) == len(DURS_MS)


def test_region_claims_only_what_no_tighter_name_claims(planes):
    att = attribute_to_spans(planes, ["on_block"], region="sim_run")
    assert {k: v["count"] for k, v in att.items()} == {
        "aggregate_verify": 1,     # its innermost range, not the region
        "on_block": 4,             # the bus's handler claims its subtree
        "io|read": 1,
        "sim_run": 1,              # launched directly under the region
        "unattributed": 2}         # outside the region / no launch record
    assert att["aggregate_verify"]["total_ms"] == DURS_MS[AGG]
    total = sum(DURS_MS.values())
    assert sum(v["total_ms"] for v in att.values()) == pytest.approx(total, abs=1e-4)


EVENTS = [
    {"v": 1, "seq": 0, "type": "propose", "span": "blk-1", "slot": 1, "proposer": 3},
    {"v": 1, "seq": 1, "type": "gossip", "span": "blk-1/g0", "parent": "blk-1", "t": 12.0,
     "src": 0, "dst": 1},
    {"v": 1, "seq": 2, "type": "deliver", "span": "blk-1/d1", "parent": "blk-1/g0",
     "t": 12.5, "duration_ms": 3.25, "group": 1, "handler": "on_block", "status": "accept"},
    {"v": 1, "seq": 3, "type": "attest", "span": "att-1-0", "slot": 1, "group": 0},
    {"v": 1, "seq": 4, "type": "fault", "t": 13.0, "kind": "drop", "dst": 1},
    {"v": 1, "seq": 5, "type": "slot", "slot": 1},
]


def test_exports_equal_the_jax_packages_byte_for_byte(planes, tmp_path):
    assert texport.chrome_trace(EVENTS, device_planes=planes, max_device_events=5) == \
        jexport.chrome_trace(EVENTS, device_planes=planes, max_device_events=5)
    assert texport.collapsed_stacks(EVENTS) == jexport.collapsed_stacks(EVENTS)
    assert texport.device_collapsed_stacks(planes, exclude_ops={"sim_run"}) == \
        jexport.device_collapsed_stacks(planes, exclude_ops={"sim_run"})
    top = jxplane.top_table(jxplane.summarize_planes(planes))
    kw = {"events": EVENTS, "planes": planes, "top_ops": top, "max_device_events": 50_000,
          "exclude_ops": {"sim_run"}}
    port = texport.write_artifacts(tmp_path / "port", **kw)
    ref = jexport.write_artifacts(tmp_path / "jax", **kw)
    assert sorted(port) == sorted(ref) == ["chrome_trace.json", "flame.txt",
                                           "flame_device.txt", "top_ops.json"]
    for name in port:
        assert Path(port[name]).read_bytes() == Path(ref[name]).read_bytes(), name


def test_export_cli_reads_a_torch_trace(planes, tmp_path):
    trace = tmp_path / "trace"
    trace.mkdir()
    (trace / "w.1.pt.trace.json").write_text(json.dumps(_trace()))
    events = tmp_path / "events.jsonl"
    events.write_text("".join(json.dumps(e) + "\n" for e in EVENTS))
    out, flame = tmp_path / "chrome.json", tmp_path / "flame_device.txt"
    assert texport.main([str(events), "--trace", str(trace), "--chrome", str(out),
                         "--device-flame", str(flame)]) == 0
    lane = [e for e in json.loads(out.read_text())["traceEvents"]
            if e.get("pid") == texport.DEVICE_PID and e["ph"] == "X"]
    # every plane is drawn (the host's threads too, as in the JAX package)
    assert set(PATHS.values()) <= {e["args"]["op_name"] for e in lane}
    assert len(lane) == sum(len(line["events"]) for p in planes for line in p["lines"])
    assert flame.read_text().splitlines() == texport.device_collapsed_stacks(planes)


# --- honest timing ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8])
def test_checksum_tree_equals_the_jax_one(dtype):
    ensure_x64()
    rng = np.random.default_rng(7)
    info = np.iinfo(dtype)
    leaves = [rng.integers(info.min, info.max, size, dtype=dtype, endpoint=True)
              for size in ((97,), (13, 5), (0,))]
    ref = int(jax_checksum([jnp.asarray(a) for a in leaves]))
    got = checksum_tree({"a": torch.from_numpy(leaves[0]),
                         "b": (torch.from_numpy(leaves[1]), torch.from_numpy(leaves[2]))})
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == ref


def test_fused_measure_times_a_body_and_records_its_dispatches():
    x = torch.arange(4096, dtype=torch.int32)
    salts = []

    def body(salt, acc):
        salts.append(salt)
        return acc + checksum_tree(x + salt)

    reg = MetricsRegistry()
    was = torchrt.current()
    torchrt.install(reg)
    try:
        per = fused_measure(body, k_hi=3, reps=2, entropy=5)
    finally:
        torchrt.install(was)
    assert isinstance(per, float) and per > 0
    # a warm call, 2 timed calls of 1 and 2 of 3: each call's salts consecutive
    assert salts == [5, 16, 17, 26, 27, 28, 27, 28, 29]
    assert reg.counter("jax_dispatches_total").value(site="fused_measure") == 9
    assert reg.counter("jax_transfer_bytes_total").value(
        direction="d2h", site="fused_measure") == 5 * 4


# --- the cost table ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cost_tables():
    ensure_x64()
    return (analyze_hot_paths(n=256, capacity=16, device="cpu"),
            jcost.analyze_hot_paths(n=256, capacity=16))


def test_cost_table_has_the_jax_emissions_names_and_keys(cost_tables):
    port, ref = cost_tables
    assert port["backend"] == "cpu"
    assert {k: port[k] for k in ("n_validators", "forkchoice_capacity")} == \
        {"n_validators": 256, "forkchoice_capacity": 16}
    assert list(port["kernels"]) == list(ref["kernels"])
    for name, row in port["kernels"].items():
        assert "error" not in row, (name, row)
        assert set(ref["kernels"][name]) <= set(row), name
        assert row["peak_bytes"] is None and row["temp_bytes"] is None  # no card here
        assert row["generated_code_bytes"] == 0 and row["transcendentals"] == 0


def test_cost_table_bytes_equal_the_jax_packages(cost_tables):
    """Argument and output bytes equal the JAX package's, but for the two
    exceptions the module names: XLA leaves the unread ``slot`` and
    ``msg_epoch`` columns out of the rescan's arguments, and its tuple
    outputs carry an 8-byte pointer a leaf."""
    port, ref = cost_tables
    n, capacity = 256, 16
    unread = {"forkchoice.head_and_weights": capacity * 4 + n * 8}
    tuple_leaves = {"forkchoice.head_and_weights": 2, "forkchoice.head_from_buckets": 2,
                    "epoch.process_epoch_dense": 16}
    for name, row in port["kernels"].items():
        want = ref["kernels"][name]
        assert row["argument_bytes"] - unread.get(name, 0) == want["argument_bytes"], name
        assert row["output_bytes"] + 8 * tuple_leaves.get(name, 0) == \
            want["output_bytes"], name


def test_cost_table_level_sweep_by_hand(cost_tables):
    """One merkle level of 256 sibling pairs: a 64-byte message is two
    SHA-256 compressions (the message block with its 48-word schedule, the
    padding block's schedule a constant); a compression is 64 rounds of
    14 integer operations and the 8-word feed-forward, a schedule word 10;
    64 bytes read and 32 written a pair."""
    row = cost_tables[0]["kernels"]["merkle_device.level_sweep"]
    assert row["flops"] == 256 * (2 * (64 * 14 + 8) + 48 * 10) == 585_728
    assert row["bytes_accessed"] == 256 * (64 + 32)
    assert row["argument_bytes"] == 256 * 64 and row["output_bytes"] == 256 * 32


# --- dense offloads ------------------------------------------------------------------------

def _registry_columns(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"effective_balance": rng.integers(16, 33, n).astype(np.int64) * 10**9,
            "balance": rng.integers(31 * 10**9, 33 * 10**9, n).astype(np.int64),
            "activation_epoch": rng.integers(0, 4, n).astype(np.int64),
            "exit_epoch": np.full(n, 2**62, np.int64),
            "withdrawable_epoch": np.full(n, 2**62, np.int64),
            "slashed": rng.random(n) < 0.1,
            "prev_flags": rng.integers(0, 8, n).astype(np.uint8),
            "cur_flags": rng.integers(0, 8, n).astype(np.uint8),
            "inactivity_scores": rng.integers(0, 50, n).astype(np.int64)}


def test_dense_offloads_load_across_the_packages(tmp_path):
    cols = _registry_columns(300, 3)
    jsnap.save_dense(str(tmp_path / "jax.npz"),
                     JaxRegistry(**{k: jnp.asarray(v) for k, v in cols.items()}))
    port = tsnap.load_dense(str(tmp_path / "jax.npz"), device="cpu")
    assert isinstance(port, DenseRegistry)
    for f in DenseRegistry._fields:
        assert getattr(port, f).device.type == "cpu"
        assert np.array_equal(getattr(port, f).numpy(), cols[f]), f
        assert getattr(port, f).numpy().dtype == cols[f].dtype, f
    tsnap.save_dense(str(tmp_path / "port.npz"), port)
    back = jsnap.load_dense(str(tmp_path / "port.npz"))
    for f in DenseRegistry._fields:
        assert np.array_equal(np.asarray(getattr(back, f)), cols[f]), f
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsnap.load_dense(str(tmp_path / "port.npz"))


# --- the driver's knobs, the region and the entry point -----------------------------------

def test_profiled_region_on_the_cpu_emits_the_jax_packages_keys():
    tel = Telemetry()
    with ProfiledRegion("region", telemetry=tel) as prof:
        with trace_region("inner"):
            torch.ones(64).cumsum(0)
        tel.bus.emit("deliver", handler="inner", span="s-1")
    assert prof.error is None
    assert [p["name"] for p in prof.planes] == ["/host:CPU"]
    (ev,) = tel.bus.of_type("profile")
    assert set(ev) - {"v", "seq", "type"} == {"name", "by_jit", "by_shard_map", "attribution"}
    assert ev["name"] == "region" and ev["by_shard_map"] == {}
    # on the host-plane fallback the handler's range claims its own slice
    assert ev["attribution"]["inner"]["count"] >= 1
    assert "region" not in ev["attribution"]


def test_a_second_profiler_session_degrades_to_an_error():
    with ProfiledRegion("outer") as outer:
        with ProfiledRegion("inner") as inner:
            torch.ones(4).sum()
    assert outer.error is None and outer.planes
    assert inner.error is not None and inner.planes == [] and inner.attribution == {}


def test_profiled_simulation_writes_artifacts_and_equals_an_unprofiled_run(tmp_path):
    with tc.use_config(tc.minimal_config()):
        tel = Telemetry()
        sim = Simulation(64, telemetry=tel, profile=tmp_path / "prof", device="cpu")
        sim.run_until_slot(3)
        assert sim.slot == 4   # the profiled segment ran the sim
        written = sorted(os.listdir(tmp_path / "prof"))
        assert written == ["chrome_trace.json", "flame.txt", "flame_device.txt",
                           "top_ops.json"]
        chrome = json.loads((tmp_path / "prof" / "chrome_trace.json").read_text())
        assert any(e.get("pid") == texport.DEVICE_PID for e in chrome["traceEvents"])
        (prof,) = tel.bus.of_type("profile")
        assert prof["name"] == "sim_run" and "error" not in prof
        # the handlers' ranges claim their slices
        assert {"on_block", "get_head"} <= set(prof["attribution"])
        assert tel.bus.of_type("profile_artifacts")[0]["files"] == written
        # the second run segment is NOT profiled (one capture)
        sim.run_until_slot(5)
        assert len(tel.bus.of_type("profile")) == 1
        plain = Simulation(64, device="cpu")
        plain.run_until_slot(5)
        assert sim.metrics == plain.metrics


def test_compile_cache_points_the_build_directory_and_changes_no_record(tmp_path):
    before = kernels.BUILD_DIR
    try:
        with tc.use_config(tc.minimal_config()):
            sim = Simulation(16, compile_cache=tmp_path / "cache", device="cpu")
            assert sim.compile_cache == str(tmp_path / "cache")
            assert kernels.BUILD_DIR == tmp_path / "cache"
            assert kernels._library_path("merkle_level").parent == tmp_path / "cache"
            sim.run_until_slot(3)
            plain = Simulation(16, device="cpu")
            plain.run_until_slot(3)
            assert sim.metrics == plain.metrics
    finally:
        kernels.set_build_dir(before)


def test_resilient_run_history_is_read_by_the_jax_package(tmp_path):
    history = tmp_path / "bench_history.jsonl"
    cmd = [sys.executable, "-m", "pos_evolution_tpu_torch.resilient_run", "--device", "cpu",
           "--dense", "--validators", "64", "--epochs", "1", "--every", "4",
           "--ckpt-dir", str(tmp_path / "store"), "--json", str(tmp_path / "out.json"),
           "--history", str(history), "--hang-timeout", "120", "--backoff", "0.05"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    emission = json.loads((tmp_path / "out.json").read_text())
    (entry,) = jax_read_history(history)
    assert entry["kind"] == "bench_resilience" and entry["emission"] == emission
    assert emission["final_slot"] == 8 and emission["attempts"] == 1
