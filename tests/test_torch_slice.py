"""The port's whole slice -- one epoch through ``run_epoch`` -- against the
same composition of JAX package functions (bit for bit), the port's
independence from JAX, and its device rules."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu import config as jcfg  # noqa: E402
from pos_evolution_tpu.ops import aggregation as jagg  # noqa: E402
from pos_evolution_tpu.ops import epoch as jep  # noqa: E402
from pos_evolution_tpu.ops import forkchoice as jfc  # noqa: E402
from pos_evolution_tpu.ops.shuffle import shuffle_permutation_jax  # noqa: E402
from pos_evolution_tpu_torch import convert  # noqa: E402
from pos_evolution_tpu_torch.device import (  # noqa: E402
    checksum_tree,
    words_to_numpy,
    words_to_torch,
)
from pos_evolution_tpu_torch.epoch import (  # noqa: E402
    build_epoch_inputs,
    epoch_committees,
    head_passes,
    load_inputs,
    run_epoch,
)
from pos_evolution_tpu_torch.ops import kernels  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(slots=4, committees_per_slot=4, capacity=16, shuffle_rounds=10)


def _jax_epoch(inp):
    """The JAX package's functions composed as ``run_epoch`` composes the port's."""
    n = inp.pubkeys.shape[0]
    a, c = inp.agg_bits.shape
    perm = shuffle_permutation_jax(inp.shuffle_seed, n, inp.shuffle_rounds)
    committees = perm[: a * c].reshape(a, c)
    pk = jagg.precompute_pk_states(inp.pubkeys)
    bits, msgs = jnp.asarray(inp.agg_bits), jnp.asarray(inp.msg_words)
    sigs = jagg.aggregate_signatures_batch(pk, committees, bits, msgs)
    ok = jagg.aggregate_verify_batch(pk, committees, bits, msgs, sigs)
    store = jfc.DenseStore(*(jnp.asarray(x) for x in inp.store))
    heads, weights = [], []
    for s in range(inp.slots):
        t = inp.salt * inp.slots + s
        st = store._replace(msg_epoch=store.msg_epoch.at[0].set(t),
                            boost_idx=jnp.int32(t % inp.capacity))
        h, w = jfc.head_and_weights(st, inp.capacity)
        heads.append(int(h))
        weights.append(np.asarray(w))
    cur, fin, jbits, pj, cj, sl = inp.sweep_args
    res = jep.process_epoch_dense(jep.DenseRegistry(*(jnp.asarray(x) for x in inp.registry)),
                                  cur, fin, jnp.asarray(jbits), pj, cj, sl,
                                  jcfg.mainnet_config())
    return (np.asarray(committees), np.asarray(sigs), np.asarray(ok), heads,
            np.stack(weights), res)


def test_run_epoch_matches_jax():
    inp = build_epoch_inputs(4096, seed=5, **SMALL)
    assert inp.agg_bits.shape == (16, 256)
    before = dict(kernels.launches)
    out = run_epoch(inp, "cpu")
    assert kernels.launches == before   # the CPU takes the plain version
    committees, sigs, ok, heads, weights, res = _jax_epoch(inp)

    np.testing.assert_array_equal(out.committees.numpy(), committees)
    np.testing.assert_array_equal(words_to_numpy(out.aggregates), sigs)
    np.testing.assert_array_equal(out.ok.numpy(), ok)
    assert out.ok.all()
    assert out.heads.tolist() == heads
    np.testing.assert_array_equal(out.weights.numpy(), weights)
    got = convert.to_numpy(out.result)
    for f in jep.DenseRegistry._fields:
        np.testing.assert_array_equal(getattr(got.registry, f),
                                      np.asarray(getattr(res.registry, f)), err_msg=f)
    for f in jep.EpochResult._fields[1:]:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(res, f)), err_msg=f)
    assert int(got.finalize_epoch) == 9     # ~95% participation finalizes


def test_plain_flag_gives_the_same_epoch():
    inp = build_epoch_inputs(1024, seed=6, **SMALL)
    a, b = run_epoch(inp, "cpu"), run_epoch(inp, "cpu", plain=True)
    assert checksum_tree(a) == checksum_tree(b)
    assert torch.equal(a.aggregates, b.aggregates)


def test_stages_compose_to_run_epoch():
    """The stage functions, called one by one, give ``run_epoch``'s outputs."""
    inp = build_epoch_inputs(1024, seed=7, **SMALL)
    out = run_epoch(inp, "cpu")
    t = load_inputs(inp, "cpu")
    assert torch.equal(epoch_committees(inp, "cpu"), out.committees)
    heads, weights = head_passes(t.store, inp)
    assert torch.equal(heads, out.heads) and torch.equal(weights, out.weights)
    assert heads.dtype == torch.int32 and weights.shape == (inp.slots, inp.capacity)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from pos_evolution_tpu_torch.ops.aggregation import precompute_pk_states
    inp = build_epoch_inputs(1024, seed=8, **SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_epoch(inp)
    with pytest.raises(RuntimeError, match="CUDA"):
        precompute_pk_states(inp.pubkeys)
    for carry, arg in ((convert.registry_to_torch, inp.registry),
                       (convert.store_to_torch, inp.store),
                       (convert.pk_states_to_torch, np.zeros((4, 8), np.uint32)),
                       (words_to_torch, inp.msg_words),
                       (convert.limbs_to_torch, np.zeros((2, 32), np.int32))):
        with pytest.raises(RuntimeError, match="CUDA"):
            carry(arg)
    from pos_evolution_tpu_torch import bls_verify
    from pos_evolution_tpu_torch.ops.g2prep import hash_to_g2_batch
    bls = bls_verify.build_inputs(2, 4, distinct_keys=2, seed=1)
    for call in (lambda: bls_verify.run(bls), lambda: bls_verify.oracle_tensors(bls),
                 lambda: hash_to_g2_batch([b"m"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = ("jax", "jaxlib", "pos_evolution_tpu")

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import: " + name)
            return None

    sys.meta_path.insert(0, Blocker())
    sys.path.insert(0, {repo!r})
""")


def _run_blocked(body: str):
    code = _BLOCKER.format(repo=REPO) + textwrap.dedent(body)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO)


def test_blocker_blocks_only_whole_names():
    proc = _run_blocked("""
        for name in ("jax", "pos_evolution_tpu", "pos_evolution_tpu.config"):
            try:
                __import__(name)
            except ImportError:
                pass
            else:
                raise SystemExit("not blocked: " + name)
        import pos_evolution_tpu_torch
        print("ok")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_runs_with_jax_blocked():
    """Every module of the port imports, and a tiny epoch, its state
    roots, a faulted dense simulation with its checkpoint and state
    digest, the BLS slice's key decompression and a tower multiply, the
    KZG slice's NTT round trip and a commit (against the host Pippenger),
    and the spec tier's chain over one epoch boundary and its replay run
    on the CPU, with jax and pos_evolution_tpu impossible to import."""
    proc = _run_blocked("""
        import pkgutil, importlib
        import pos_evolution_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from pos_evolution_tpu_torch.epoch import build_epoch_inputs, run_epoch
        inp = build_epoch_inputs(512, seed=1, slots=2, committees_per_slot=2,
                                 capacity=8, shuffle_rounds=4)
        out = run_epoch(inp, "cpu")
        assert bool(out.ok.all())
        from pos_evolution_tpu_torch.state_roots import run_state_roots
        roots = run_state_roots(inp, "cpu")
        assert roots.pre != roots.post and len(roots.post["balances"]) == 32
        from pos_evolution_tpu_torch.config import mainnet_config
        from pos_evolution_tpu_torch.resilience import state_digest
        from pos_evolution_tpu_torch.sim.dense_driver import DenseSimulation
        from pos_evolution_tpu_torch.sim.dense_monitors import default_dense_monitors
        from pos_evolution_tpu_torch.sim.faults import DenseFaultPlan
        cfg = mainnet_config().replace(slots_per_epoch=4, max_committees_per_slot=2)
        sim = DenseSimulation(64, cfg, device="cpu", shuffle_rounds=4, check_walk_every=2,
                              fault_plan=DenseFaultPlan(seed=1, drop_p=0.1),
                              monitors=default_dense_monitors())
        sim.run_epochs(2)
        resumed = DenseSimulation.resume(sim.checkpoint(), device="cpu")
        assert state_digest(resumed) == state_digest(sim)
        assert sim.summary()["resident_head_equals_spec_walk"]
        import numpy as np, torch
        from pos_evolution_tpu_torch import bls_verify
        from pos_evolution_tpu_torch.crypto import bls12_381 as oracle
        from pos_evolution_tpu_torch.ops import fp, g2prep, tower
        bls = bls_verify.build_inputs(2, 4, distinct_keys=2, seed=1)
        xs, signs = bls_verify._pk_limbs(bls.pk_comp)
        pk, ok = g2prep.g1_decompress_batch(torch.from_numpy(xs), torch.from_numpy(signs))
        assert bool(ok.all()) and fp.from_limbs(pk[0, 1]) == oracle.g1_decompress(bls.pk_comp[0])[1]
        x = pk[:, :, None, :].expand(2, 2, 6, 32).reshape(2, 12, 32)
        assert tower.alg_mul(x, x).shape == (2, 12, 32)
        from pos_evolution_tpu_torch.das.commitment import get_scheme
        from pos_evolution_tpu_torch.kzg import curve, fr, ntt
        vals = fr.to_mont(fr.ints_to_digits([3, 1, 4, 1, 5, 9, 2, 6]))
        assert fr.digits_to_ints(fr.from_mont(ntt.intt(ntt.ntt(vals)))) == [3, 1, 4, 1, 5, 9, 2, 6]
        kcfg = cfg.replace(das_cells_per_blob=2, das_cell_bytes=16)
        scheme = get_scheme("kzg", "cpu", cfg=kcfg)
        grid = np.arange(64, dtype=np.uint8).reshape(4, 16)
        point, _comp, coeffs, wire = scheme.commit_full(grid)
        assert point == curve.g1_lincomb(scheme.setup().powers_g1(), coeffs)
        assert scheme.commit(grid) == wire
        from pos_evolution_tpu_torch import config as spec_config, spec_chain
        mc = spec_config.minimal_config()
        run = spec_chain.run_chain(64, mc.slots_per_epoch + 1, device="cpu", cfg=mc)
        assert run.summary["state_roots"] > 0 and run.pre_epoch is not None
        assert spec_chain.replay(run, device="cpu", cfg=mc)["final_root"] == \
            run.summary["final_root"]
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ran", out.heads.tolist())
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ran")


def test_riders_run_with_jax_blocked():
    """The spec driver's riders with jax and pos_evolution_tpu impossible to
    import: the copied DAS server, light-client package and single-flight
    import, and a DAS run on the CPU serves its sampling clients and its
    light client for two epochs and resumes from its checkpoint."""
    proc = _run_blocked("""
        import pos_evolution_tpu_torch.das.server
        import pos_evolution_tpu_torch.lightclient
        import pos_evolution_tpu_torch.utils.singleflight
        from pos_evolution_tpu_torch.backend import use_backend
        from pos_evolution_tpu_torch.config import minimal_config, use_config
        from pos_evolution_tpu_torch.sim.driver import Simulation
        with use_config(minimal_config()), use_backend("torch", device="cpu"):
            sim = Simulation(16, das=True)
            sim.attach_das_clients(200, seed=3)
            node = sim.attach_light_client()
            sim.run_epochs(2)
            assert sim.das_serves and all(s["failed"] == 0 for s in sim.das_serves)
            assert sim.das_server.served_blocks > 0 and node.updates_applied > 0
            resumed = Simulation.resume(sim.checkpoint(), das=True)
            assert resumed.metrics == sim.metrics
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ran", sim.das_server.served_blocks)
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ran")


def test_chip_smoke_imports_without_jax_and_refuses_cpu():
    """chip_smoke.py imports nothing of JAX and, with no CUDA, exits
    non-zero before printing any result."""
    proc = _run_blocked("""
        import runpy
        sys.argv = ["chip_smoke.py"]
        runpy.run_path("chip_smoke.py", run_name="__main__")
    """)
    if "torch.cuda.is_available() is False" not in proc.stderr:
        pytest.skip("a CUDA device is present")
    assert proc.returncode == 2, proc.stderr
    assert "ok" not in proc.stdout
    assert "blocked import" not in proc.stderr


def test_spec_driver_runs_with_jax_blocked():
    """The spec driver's modules (``sim.driver``, ``ops.resident``,
    ``utils.snapshot``, ``utils.metrics``, ``variants``) import, and a
    small accelerated ``Simulation`` with a faulted schedule, an
    equivocator and the default monitors runs, checkpoints and resumes,
    and a Goldfish run proceeds, on the CPU with jax and
    pos_evolution_tpu impossible to import."""
    proc = _run_blocked("""
        import importlib
        for name in ("sim.driver", "ops.resident", "utils.snapshot", "utils.metrics",
                     "variants", "sim.monitors", "sim.adversary", "sim.attacks"):
            importlib.import_module("pos_evolution_tpu_torch." + name)
        from pos_evolution_tpu_torch import config as tc
        from pos_evolution_tpu_torch import sim
        from pos_evolution_tpu_torch.variants import GoldfishVariant
        with tc.use_config(tc.minimal_config()):
            plan = sim.FaultPlan(seed=1, drop_p=0.1, crashes=(sim.CrashWindow(1, 3, 6),))
            s = sim.Simulation(32, schedule=sim.faulty_schedule(32, plan, n_groups=2),
                               accelerated_forkchoice=True, device="cpu",
                               adversaries=[sim.Equivocator({0, 1})],
                               monitors=sim.default_monitors())
            s.run_until_slot(7)
            back = sim.Simulation.resume(s.checkpoint(),
                                         schedule=sim.faulty_schedule(32, plan, n_groups=2),
                                         device="cpu", adversaries=[sim.Equivocator({0, 1})],
                                         monitors=sim.default_monitors())
            s.run_until_slot(9)
            back.run_until_slot(9)
            assert back.metrics == s.metrics
            assert not any(g.resident.degraded for g in s.groups)
            g = sim.Simulation(16, variant=GoldfishVariant(), device="cpu")
            g.run_until_slot(4)
            assert g.metrics[-1]["n_blocks"] > 1
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ran", s.metrics[-1]["head_root"])
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ran")


def test_profiling_runs_with_jax_blocked(tmp_path):
    """The profiling tooling (``profiling/``, ``utils/benchtime``, the
    metrics regions and the dense offloads) imports and runs on the CPU
    with jax and pos_evolution_tpu impossible to import: a profiled dense
    region, its artifacts, a profiled spec ``Simulation``, the cost table
    and a timed body."""
    proc = _run_blocked(f"""
        import importlib, os, torch
        for name in ("kineto", "xplane", "history", "attribution", "export", "cost"):
            importlib.import_module("pos_evolution_tpu_torch.profiling." + name)
        from pos_evolution_tpu_torch.config import mainnet_config, minimal_config, use_config
        from pos_evolution_tpu_torch.profiling import ProfiledRegion
        from pos_evolution_tpu_torch.profiling.cost import analyze_hot_paths
        from pos_evolution_tpu_torch.profiling.export import write_artifacts
        from pos_evolution_tpu_torch.sim.dense_driver import DenseSimulation
        from pos_evolution_tpu_torch.sim.driver import Simulation
        from pos_evolution_tpu_torch.telemetry import Telemetry
        from pos_evolution_tpu_torch.utils.benchtime import checksum_tree, fused_measure
        from pos_evolution_tpu_torch.utils.snapshot import load_dense, save_dense
        cfg = mainnet_config().replace(slots_per_epoch=4, max_committees_per_slot=2)
        sim = DenseSimulation(64, cfg, device="cpu", shuffle_rounds=4)
        sim.run_slot()
        tel = Telemetry()
        with ProfiledRegion("dense", telemetry=tel) as prof:
            sim.run_slot()
        assert prof.error is None and prof.planes, prof.error
        wrote = write_artifacts({str(tmp_path)!r}, events=tel.bus.events, planes=prof.planes,
                                top_ops=prof.top_ops)
        assert sorted(wrote) == ["chrome_trace.json", "flame.txt", "flame_device.txt",
                                 "top_ops.json"], wrote
        save_dense({str(tmp_path / "reg.npz")!r}, sim.views[0].registry)
        back = load_dense({str(tmp_path / "reg.npz")!r}, device="cpu")
        assert torch.equal(back.balance, sim.views[0].registry.balance)
        with use_config(minimal_config()):
            s = Simulation(16, device="cpu", profile={str(tmp_path / "prof")!r},
                           telemetry=Telemetry())
            s.run_until_slot(2)
        assert sorted(os.listdir({str(tmp_path / "prof")!r})) == sorted(wrote)
        table = analyze_hot_paths(n=64, capacity=8, device="cpu")
        assert not [k for k, v in table["kernels"].items() if "error" in v], table
        x = torch.arange(64)
        assert fused_measure(lambda salt, acc: acc + checksum_tree(x + salt), reps=1) > 0
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ran", len(prof.planes))
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ran")


def test_serving_tier_runs_with_jax_blocked():
    """The serving tier with jax and pos_evolution_tpu impossible to import:
    ``pos_evolution_tpu_torch.serve`` imports, a served spec-driver run
    publishes its views, an in-process front answers ``das_cells`` from
    one, and a worker's spawn entry (``serve/workers._worker_main``),
    run as this process's main thread, boots, follows the board, serves
    a ``das_cells`` request and drains on SIGTERM, on the CPU."""
    proc = _run_blocked("""
        import os, signal, socket, tempfile, threading, time
        import pos_evolution_tpu_torch.serve as serve
        from pos_evolution_tpu_torch.backend import use_backend
        from pos_evolution_tpu_torch.config import minimal_config, use_config
        from pos_evolution_tpu_torch.serve.shm import ShmViewBoard
        from pos_evolution_tpu_torch.serve.workers import _worker_main, worker_spec
        from pos_evolution_tpu_torch.sim.driver import Simulation
        from pos_evolution_tpu_torch.utils.watchdog import read_heartbeat
        with use_config(minimal_config()), use_backend("torch", device="cpu"):
            sim = Simulation(16, das=True, serve=True)
            sim.run_until_slot(3)
            view = sim.serving_state.current()
            assert len(sim.serving_state.views) == 4 and view.sidecars
            root = next(iter(view.sidecars)).hex()
            params = {"block_root": root, "samples": [[0, 1], [1, 5]]}
            state = serve.ServingState()
            state.publish(view)
            front = serve.ServeFront(state, scheme=sim.das.scheme, workers=1)
            cli = serve.ServeClient(front.start(), connections=1, hedge_ms=None)
            local = cli.request("das_cells", params, deadline_s=10.0)
            cli.close()
            front.stop()
            assert local.ok, local.error
            tmp = tempfile.mkdtemp()
            lock = os.path.join(tmp, "board.lock")
            board = ShmViewBoard.create(lock)
            gen = board.publish(view)
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
            spec = worker_spec(0, port, board.name, lock, tmp, threads=1, device="cpu")
            got = {}

            def client():
                deadline = time.time() + 120
                while time.time() < deadline:
                    hb = read_heartbeat(spec["heartbeat_path"])
                    if hb and hb["payload"].get("slot") == gen:
                        break
                    time.sleep(0.05)
                c = serve.ServeClient(("127.0.0.1", port), connections=1, hedge_ms=None)
                got["res"] = c.request("das_cells", params, deadline_s=10.0)
                c.close()
                os.kill(os.getpid(), signal.SIGTERM)

            threading.Thread(target=client, daemon=True).start()
            try:
                _worker_main(spec)
            except SystemExit as e:
                assert e.code == 0, e.code
            board.close()
        assert got["res"].ok and got["res"].result == local.result, got["res"].error
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ran", len(got["res"].result["cells"]))
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ran 2")


def test_offline_tooling_runs_with_jax_blocked(tmp_path):
    """Each entry point of the offline tooling, run as ``python -m`` runs
    it, with jax and pos_evolution_tpu impossible to import: the analysis
    gate and its doctor, the run report, the perf gate and diff, the
    trace merge and the live view; none of them imports torch either."""
    spans = tmp_path / "trace"
    spans.mkdir()
    for pid in (11, 12):
        (spans / f"spans.{pid}.jsonl").write_text(json.dumps(
            {"trace": "00000000000000aa", "name": "service", "t0": 1.0 + pid, "dur_ms": 2.0,
             "pid": pid, "proc": f"p{pid}", "tid": 0}) + "\n")
    emission = tmp_path / "emission.json"
    emission.write_text(json.dumps({"counts": {"kernel_launches_total;kernel=merkle_level": 18}}))
    proc = _run_blocked(f"""
        import runpy
        golden = {os.path.join(REPO, "tests", "golden_telemetry.jsonl")!r}
        tmp = {str(tmp_path)!r}

        def run(module, *argv):
            sys.argv = [module, *argv]
            try:
                runpy.run_module(module, run_name="__main__")
            except SystemExit as e:
                return e.code
            return 0

        pkg = "pos_evolution_tpu_torch."
        assert run(pkg + "analysis", "--doctor") == 1
        assert run(pkg + "analysis", "--strict", "pos_evolution_tpu_torch/analysis",
                   "--baseline", "none") == 0
        assert run(pkg + "run_report", golden, "--json", tmp + "/r.json",
                   "--markdown", tmp + "/r.md") == 0
        assert run(pkg + "perf_gate", "--candidate", {str(emission)!r},
                   "--baseline", {str(emission)!r}, "--count-only") == 0
        assert run(pkg + "perf_diff", {str(emission)!r}, {str(emission)!r}) == 0
        assert run(pkg + "trace_merge", {str(spans)!r}, "--expect-pids", "2") == 0
        assert run(pkg + "obs_top", "--dir", tmp, "--events", golden, "--once") == 0
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED + ("torch",)]
        assert not bad, bad
        print("ran")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.rstrip().endswith("ran"), proc.stdout
