"""The serving tier in the port against the JAX package's on the CPU,
tolerance 0: the port on its CPU torch backend with one intra-op thread,
the JAX package on its numpy backend, both on the minimal config.

- ``Simulation(32, das=True, serve=True)`` for one epoch: every published
  ``ServeView`` (one a slot) equal in every field, each sidecar's cells,
  commitment and SSZ root, and ``encode_view``'s bytes;
- one view handed to a JAX ``ServeFront`` and to the port's, then a seeded
  list of requests (head, finality, lc_update, ``das_cells``, malformed
  parameters, samples outside the grid, unknown roots and methods): every
  reply and status equal;
- ``arrival_times`` for each pattern and seed; a mini open-loop run over
  the port's front with every served proof verified;
- a kzg view at the smallest kzg geometry (4 cells of one chunk): one
  ``das_aggregate`` reply equal, proof bytes included (the pairing check
  that verifies it runs on the card, in ``chip_smoke.py`` phase 41: on
  the plain field arithmetic it takes ~30 s of CPU);
- the port's own contract: ``_scheme_aggregates`` reads the class flag
  and builds no scheme, ``worker_spec`` defaults to CUDA, a front or
  scheme asked for CUDA without it raises, and a served run's checkpoint
  leaves the serving state out and resumes equal."""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from pos_evolution_tpu import config as jc  # noqa: E402
from pos_evolution_tpu import serve as jserve  # noqa: E402
from pos_evolution_tpu import sim as jsim  # noqa: E402
from pos_evolution_tpu import ssz as jssz  # noqa: E402
from pos_evolution_tpu.backend import set_backend as jax_set_backend  # noqa: E402
from pos_evolution_tpu.das import BlobEngine as JBlobEngine  # noqa: E402
from pos_evolution_tpu.serve.shm import encode_view as j_encode_view  # noqa: E402
from pos_evolution_tpu.telemetry.registry import MetricsRegistry as JRegistry  # noqa: E402
from pos_evolution_tpu_torch import config as tc  # noqa: E402
from pos_evolution_tpu_torch import serve as tserve  # noqa: E402
from pos_evolution_tpu_torch import sim as tsim  # noqa: E402
from pos_evolution_tpu_torch import ssz as tssz  # noqa: E402
from pos_evolution_tpu_torch.backend import use_backend  # noqa: E402
from pos_evolution_tpu_torch.das import BlobEngine as TBlobEngine  # noqa: E402
from pos_evolution_tpu_torch.serve.shm import encode_view as t_encode_view  # noqa: E402
from pos_evolution_tpu_torch.telemetry.registry import MetricsRegistry as TRegistry  # noqa: E402

PKGS = ("port", "jax")
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


def _served_sim(name):
    """``Simulation(32, das=True, serve=True)`` for one epoch, once a module."""
    if name not in _RUNS:
        pkg = tsim if name == "port" else jsim
        sim = pkg.Simulation(32, das=True, serve=True)
        sim.run_epochs(1)
        _RUNS[name] = sim
    return _RUNS[name]


def _view_record(view, name) -> dict:
    htr = tssz.hash_tree_root if name == "port" else jssz.hash_tree_root
    return {
        "slot": view.slot, "head_root": view.head_root, "head_slot": view.head_slot,
        "justified": (view.justified_epoch, view.justified_root),
        "finalized": (view.finalized_epoch, view.finalized_root),
        "update_ssz": view.update_ssz, "update_root": view.update_root,
        "sidecars": [(root, [(np.asarray(car.cells, dtype=np.uint8).tobytes(),
                              bytes(car.commitment), bytes(htr(car))) for car in cars])
                     for root, cars in view.sidecars.items()],
        "n_cells": view.n_cells, "scheme": view.scheme,
    }


def test_published_views_equal_jax():
    port, jax = _served_sim("port"), _served_sim("jax")
    views = port.serving_state.views
    assert len(views) == port.slot == len(jax.serving_state.views) == 9
    for a, b in zip(views, jax.serving_state.views):
        assert _view_record(a, "port") == _view_record(b, "jax")
        assert t_encode_view(a) == j_encode_view(b)
    last = views[-1]
    assert last.sidecars and last.update_root is not None
    assert last.n_cells == 2 * tc.cfg().das_cells_per_blob
    # the publication's work is metered, apart from the riders' phases
    assert port.meter.calls["serve_publish"] == port.slot


def _requests(view, seed: int = 16) -> list:
    """A seeded list of (method, params): the interactive methods, valid
    and invalid ``das_cells`` requests, an aggregate request to a branch
    scheme, an unknown method."""
    rng = np.random.default_rng(seed)
    roots = list(view.sidecars)
    out = [("head", {}), ("finality", {}), ("lc_update", {})]
    for root in roots:
        n_blobs = len(view.sidecars[root])
        for k in (1, 4, 9):
            samples = [[int(rng.integers(n_blobs)), int(rng.integers(view.n_cells))]
                       for _ in range(k)]
            out.append(("das_cells", {"block_root": root.hex(), "samples": samples}))
    root = roots[-1].hex()
    out += [
        ("das_cells", {"block_root": root, "samples": [[0, 1], [0, 1]]}),   # duplicates
        ("das_cells", {"block_root": "zz" * 32, "samples": [[0, 0]]}),      # bad hex
        ("das_cells", {"samples": [[0, 0]]}),                               # no root
        ("das_cells", {"block_root": root, "samples": [["a", 0]]}),         # not an int
        ("das_cells", {"block_root": "ab" * 32, "samples": [[0, 0]]}),      # not served
        ("das_cells", {"block_root": root, "samples": [[0, view.n_cells]]}),
        ("das_cells", {"block_root": root, "samples": [[9, 0]]}),
        ("das_cells", {"block_root": root, "samples": [[0, -1]]}),
        ("das_cells", {"block_root": root, "samples": [[0, 0]] * 513}),    # over the cap
        ("das_aggregate", {"block_root": root, "samples": [[0, 0]]}),
        ("nope", {}),
    ]
    return out


def _replies(serve, registry, view, scheme, requests) -> list:
    state = serve.ServingState()
    state.publish(view)
    front = serve.ServeFront(state, scheme=scheme, registry=registry(), workers=2)
    addr = front.start()
    try:
        cli = serve.ServeClient(addr, connections=1, hedge_ms=None)
        out = []
        for method, params in requests:
            res = cli.request(method, params, deadline_s=10.0)
            out.append((method, res.status, res.result, res.error, res.reason))
        cli.close()
        return out, front.summary()
    finally:
        front.stop()


def test_front_replies_equal_jax():
    port, jax = _served_sim("port"), _served_sim("jax")
    requests = _requests(port.serving_state.views[-1])
    got, got_summary = _replies(tserve, TRegistry, port.serving_state.views[-1],
                                port.das.scheme, requests)
    want, want_summary = _replies(jserve, JRegistry, jax.serving_state.views[-1],
                                  jax.das.scheme, requests)
    assert got == want
    statuses = [r[1] for r in got]
    assert statuses.count("ok") == 3 + 3 * len(port.serving_state.views[-1].sidecars) + 1
    assert set(statuses) == {"ok", "error"}
    for key in ("by_status", "by_method", "scheme_builds", "proof_cache"):
        assert got_summary[key] == want_summary[key], key
    # one backing build per (block, blob) served
    assert got_summary["scheme_builds"] == sum(len(c) for c in
                                               port.serving_state.views[-1].sidecars.values())


def test_arrival_times_equal_jax():
    for pattern in ("uniform", "diurnal", "bursty", "hotspot"):
        for seed in (0, 5, 11):
            for windows in ((), ((0.1, 0.3, 10.0),)):
                a = tserve.arrival_times(pattern, 700, 1500.0, seed=seed,
                                         burst_windows=windows)
                b = jserve.arrival_times(pattern, 700, 1500.0, seed=seed,
                                         burst_windows=windows)
                assert a.dtype == b.dtype and np.array_equal(a, b), (pattern, seed, windows)


def test_mini_open_loop_run_all_verified():
    """The port's front under the open loop (as the JAX package's
    ``test_mini_open_loop_run_all_verified``): every served proof and
    update verifies."""
    sim = _served_sim("port")
    state = tserve.ServingState()
    state.publish(sim.serving_state.views[-1])
    front = tserve.ServeFront(state, scheme=sim.das.scheme, registry=TRegistry(), workers=2)
    addr = front.start()
    try:
        def targets():
            v = state.current()
            return {"roots": [r.hex() for r in v.sidecars], "n_cells": v.n_cells,
                    "n_blobs": {r.hex(): len(s) for r, s in v.sidecars.items()}}

        def verify_update(result):
            from pos_evolution_tpu_torch.lightclient.containers import LightClientUpdate
            obj = tssz.deserialize(bytes.fromhex(result["update"]), LightClientUpdate)
            return bytes(tssz.hash_tree_root(obj)).hex() == result["update_root"]

        lg = tserve.LoadGenerator(addr, 400, 2000.0, pattern="hotspot", seed=11,
                                  client_threads=16, targets_fn=targets,
                                  verify_update=verify_update, device="cpu")
        summary = lg.run()
    finally:
        front.stop()
    assert summary["arrivals"] == 400
    assert summary["verify_failures"] == 0
    assert summary["verified_proofs"] > 0
    tiers = summary["tiers"]
    assert tiers["bulk"]["by_status"].get("ok", 0) > 0
    assert tiers["interactive"]["by_status"].get("ok", 0) > 0


# --- the kzg scheme's aggregate RPC -----------------------------------------------------

def test_das_aggregate_reply_equals_jax():
    """A kzg view of one blob of 4 cells of one 16-byte chunk: one
    ``das_aggregate`` reply of 3 samples (one repeated) equal to the JAX
    front's, its proof bytes included, on the CPU."""
    geometry = dict(das_cells_per_blob=2, das_cell_bytes=16)
    root = b"\x07" * 32
    out = []
    with jc.use_config(jc.minimal_config().replace(**geometry)), \
            tc.use_config(tc.minimal_config().replace(**geometry)):
        for name in PKGS:
            if name == "port":
                eng = TBlobEngine(tc.cfg(), n_blobs=1, scheme="kzg", seed=4, device="cpu")
                serve, registry = tserve, TRegistry
            else:
                eng = JBlobEngine(n_blobs=1, scheme="kzg", seed=4)
                serve, registry = jserve, JRegistry
            grids, coms, _ = eng.build_for(2, root)
            view = serve.ServeView(
                slot=2, head_root=root, head_slot=2,
                justified_epoch=0, justified_root=b"\x00" * 32,
                finalized_epoch=0, finalized_root=b"\x00" * 32,
                update_ssz=None, update_root=None,
                sidecars={root: [_Sidecar(g, c) for g, c in zip(grids, coms)]},
                n_cells=4, scheme="kzg")
            out.append(_replies(serve, registry, view, eng.scheme, [
                ("das_aggregate", {"block_root": root.hex(),
                                   "samples": [[0, 3], [0, 0], [0, 3]]}),
                ("das_aggregate", {"block_root": root.hex(), "samples": [[1, 0]]}),
                ("das_cells", {"block_root": root.hex(), "samples": [[0, 0]]}),
            ])[0])
    assert out[0] == out[1]
    ok, refused, per_cell = out[0]
    assert ok[1] == "ok" and ok[2]["scheme"] == "kzg" and ok[2]["proof"]
    assert refused[1] == "error" and per_cell[1] == "error"


class _Sidecar:
    def __init__(self, cells, commitment):
        self.cells, self.commitment = cells, commitment


# --- the port's own contract ------------------------------------------------------------

def test_scheme_aggregates_reads_the_class_flag(monkeypatch):
    from pos_evolution_tpu_torch.das import commitment
    from pos_evolution_tpu_torch.serve.loadgen import LoadGenerator

    def built(*args, **kw):
        raise AssertionError("a scheme was built")

    monkeypatch.setattr(commitment, "get_scheme", built)
    lg = LoadGenerator.__new__(LoadGenerator)
    lg._agg_memo = {}
    assert lg._scheme_aggregates("kzg") is True
    assert lg._scheme_aggregates("merkle") is False
    assert lg._scheme_aggregates("nope") is False
    assert lg._scheme_aggregates(None) is False


def test_worker_spec_defaults_to_cuda(tmp_path):
    from pos_evolution_tpu_torch.serve.workers import worker_spec
    spec = worker_spec(0, 1, "board", "lock", str(tmp_path))
    assert spec["device"] == "cuda"
    assert worker_spec(0, 1, "board", "lock", str(tmp_path), device="cpu")["device"] == "cpu"
    assert spec["config"] == dataclasses.asdict(tc.cfg())


def test_cuda_front_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pos_evolution_tpu_torch.das.commitment import get_scheme
    with pytest.raises(RuntimeError, match="CUDA"):
        get_scheme("merkle", "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TBlobEngine(tc.cfg(), device="cuda")


def test_served_checkpoint_leaves_the_serving_state_out():
    """A served run's checkpoint is the unserved run's byte for byte, and
    resumes (with no serving state) equal to the uninterrupted run."""
    served = tsim.Simulation(32, das=True, serve=True)
    plain = tsim.Simulation(32, das=True)
    served.run_until_slot(4)
    plain.run_until_slot(4)
    data = served.checkpoint()
    assert data == plain.checkpoint()
    resumed = tsim.Simulation.resume(data, das=True)
    assert resumed.serving_state is None
    state = tserve.ServingState(keep_history=True)
    resumed.serving_state = state            # a resumed run re-attaches
    resumed.run_epochs(1)
    served.run_epochs(1)
    assert resumed.metrics == served.metrics
    assert [t_encode_view(v) for v in state.views] == \
        [t_encode_view(v) for v in served.serving_state.views[-len(state.views):]]
