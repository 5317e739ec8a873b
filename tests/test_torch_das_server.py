"""The port's DAS serving layer against the JAX package's on the CPU, at
tolerance 0, on inputs made by numpy from a seed: the SSZ ``BlobSidecar``
and ``CellRows`` (serialization and roots at the minimal and the PeerDAS
geometry, both ways), the engine's ``sidecars_for`` and ``regenerate``,
the merkle scheme's ``branch``, ``prove_cells`` and ``verify_cells``
and the schemes' registry, the
copied ``LRUCache``, ``DasServer.serve_samples`` (merkle) and
``best_update``, ``build_blob_proofs`` stampeded by 8 threads, and the
backend dispatch entries ``verify_das_samples``, ``reconstruct_check``
and ``verify_sync_update_batch``. The port runs on its CPU backend with
one intra-op thread, the JAX package on its numpy backend."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pos_evolution_tpu.das  # noqa: E402,F401  (before ops.das_verify: its import order)
from pos_evolution_tpu import config as jc  # noqa: E402
from pos_evolution_tpu import sim as jsim  # noqa: E402
from pos_evolution_tpu import ssz as jssz  # noqa: E402
from pos_evolution_tpu.backend import set_backend as jax_set_backend  # noqa: E402
from pos_evolution_tpu.das import commitment as jcom  # noqa: E402
from pos_evolution_tpu.das import containers as jcon  # noqa: E402
from pos_evolution_tpu.das import engine as jeng  # noqa: E402
from pos_evolution_tpu.das import sampler as jsam  # noqa: E402
from pos_evolution_tpu.das import server as jsrv  # noqa: E402
from pos_evolution_tpu.ops import das_verify as jdv  # noqa: E402
from pos_evolution_tpu.ops import sync_verify as jsv  # noqa: E402
from pos_evolution_tpu.specs import containers as jspec  # noqa: E402
from pos_evolution_tpu_torch import config as tc  # noqa: E402
from pos_evolution_tpu_torch import sim as tsim  # noqa: E402
from pos_evolution_tpu_torch import ssz as tssz  # noqa: E402
from pos_evolution_tpu_torch.backend import use_backend  # noqa: E402
from pos_evolution_tpu_torch.das import commitment as tcom  # noqa: E402
from pos_evolution_tpu_torch.das import containers as tcon  # noqa: E402
from pos_evolution_tpu_torch.das import engine as teng  # noqa: E402
from pos_evolution_tpu_torch.das import sampler as tsam  # noqa: E402
from pos_evolution_tpu_torch.das import server as tsrv  # noqa: E402
from pos_evolution_tpu_torch.ops import das_verify as tdv  # noqa: E402
from pos_evolution_tpu_torch.ops import sync_verify as tsv  # noqa: E402
from pos_evolution_tpu_torch.sim.driver import PEERDAS  # noqa: E402
from pos_evolution_tpu_torch.specs import containers as tspec  # noqa: E402

#: the geometries, as replacements of each package's config
GEOMETRIES = {"minimal": ("minimal_config", {}),
              "peerdas": ("mainnet_config", PEERDAS)}
#: the summary fields that are wall-clock times
TIMING = ("p50_ms", "p95_ms", "verify_ms")


def _cfgs(geometry="minimal", **kw):
    base, repl = GEOMETRIES[geometry]
    repl = {**repl, **kw}
    return getattr(tc, base)().replace(**repl), getattr(jc, base)().replace(**repl)


class _Both:
    """Both packages' configs set, the port on its CPU backend."""

    def __init__(self, geometry="minimal", **kw):
        self.tcfg, self.jcfg = _cfgs(geometry, **kw)

    def __enter__(self):
        self._stack = [jc.use_config(self.jcfg), tc.use_config(self.tcfg),
                       use_backend("torch", device="cpu")]
        for cm in self._stack:
            cm.__enter__()
        return self

    def __exit__(self, *exc):
        for cm in reversed(self._stack):
            cm.__exit__(*exc)


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain SHA-256 is thousands of small tensor ops: one intra-op
    thread keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jax_set_backend("numpy")
    yield
    torch.set_num_threads(n)


def _grid(cfg, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (2 * cfg.das_cells_per_blob, cfg.das_cell_bytes)).astype(np.uint8)


def _engines(both, seed=3, n_blobs=None):
    return (teng.BlobEngine(both.tcfg, n_blobs=n_blobs, seed=seed, device="cpu"),
            jeng.BlobEngine(n_blobs=n_blobs, seed=seed))


def _signed_block(spec, slot, proposer, parent):
    return spec.SignedBeaconBlock(message=spec.BeaconBlock(
        slot=slot, proposer_index=proposer, parent_root=parent))


# --- the SSZ containers --------------------------------------------------------------

@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_sidecar_ssz_equals_jax(geometry):
    with _Both(geometry) as both:
        rng = np.random.default_rng(1)
        cells = _grid(both.tcfg, 2)
        fields = dict(slot=5, proposer_index=3, block_root=rng.bytes(32), blob_index=1,
                      n_blobs=2, cells=cells, commitment=rng.bytes(32))
        t, j = tcon.BlobSidecar(**fields), jcon.BlobSidecar(**fields)
        data = tcon.BlobSidecar.serialize(t)
        assert data == jcon.BlobSidecar.serialize(j)
        assert tssz.hash_tree_root(t) == jssz.hash_tree_root(j)
        assert tcon.CellRows().htr(cells) == jcon.CellRows().htr(cells)
        assert tcon.CellRows().serialize(cells) == jcon.CellRows().serialize(cells)
        # each package reads the other's bytes
        back, jback = tcon.BlobSidecar.deserialize(data), jcon.BlobSidecar.deserialize(data)
        np.testing.assert_array_equal(back.cells, cells)
        np.testing.assert_array_equal(jback.cells, cells)
        assert tcon.BlobSidecar.serialize(back) == data
        empty = tcon.CellRows().default()
        assert empty.shape == (0, both.tcfg.das_cell_bytes)
        assert tcon.CellRows().htr(empty) == jcon.CellRows().htr(jcon.CellRows().default())


def test_sidecars_for_and_regenerate_equal_jax():
    with _Both() as both:
        teng_, jeng_ = _engines(both, seed=5)
        parent = bytes(range(32))
        tsb, jsb = (_signed_block(spec, 7, 2, parent) for spec in (tspec, jspec))
        root = tssz.hash_tree_root(tsb.message)
        assert root == jssz.hash_tree_root(jsb.message)
        tg, tcoms, tgraff = teng_.build_for(7, parent)
        jg, jcoms, jgraff = jeng_.build_for(7, parent)
        assert (tcoms, tgraff) == (jcoms, jgraff)
        built = teng_.sidecars_for(tsb, root, tg, tcoms)
        regen, jregen = teng_.regenerate(tsb, root), jeng_.regenerate(jsb, root)
        assert len(built) == len(regen) == len(jregen) == both.tcfg.das_max_blobs_per_block
        for a, b, c in zip(built, regen, jregen):
            assert isinstance(a.cells, np.ndarray)
            data = tcon.BlobSidecar.serialize(a)
            assert data == tcon.BlobSidecar.serialize(b) == jcon.BlobSidecar.serialize(c)
        assert teng_.describe() == jeng_.describe()


# --- the schemes ---------------------------------------------------------------------

def test_merkle_scheme_proofs_equal_jax():
    with _Both() as both:
        ts, js = tcom.get_scheme("merkle", "cpu", cfg=both.tcfg), jcom.get_scheme("merkle")
        assert isinstance(ts, tcom.CellCommitmentScheme) and not ts.aggregates
        grid = _grid(both.tcfg, 4)
        com = ts.commit(grid)
        assert com == js.commit(grid)
        for i in (0, 5, 15):
            np.testing.assert_array_equal(ts.branch(grid, i), js.branch(grid, i))
        idx = [1, 3, 4, 12]
        proof = ts.prove_cells(grid, idx)
        assert proof == js.prove_cells(grid, idx)
        assert ts.verify_cells(com, grid[idx], idx, proof)
        assert js.verify_cells(com, grid[idx], idx, proof)
        bad = grid[idx].copy()
        bad[2, 0] ^= 1
        assert not ts.verify_cells(com, bad, idx, proof)
        assert not js.verify_cells(com, bad, idx, proof)
        with pytest.raises(ValueError, match="unknown cell-commitment scheme"):
            tcom.get_scheme("nope", "cpu")


def test_scheme_registry():
    """Both schemes are ``CellCommitmentScheme``s registered by name (the
    kzg scheme's ``prove_cells`` and ``verify_cells`` are held against the
    JAX package's in ``test_torch_kzg_scheme.py``); the base class names
    the contract only."""
    ts = tcom.get_scheme("kzg", "cpu", cfg=_cfgs(das_cells_per_blob=2, das_cell_bytes=16)[0])
    assert isinstance(ts, tcom.CellCommitmentScheme) and ts.aggregates
    assert list(tcom._SCHEMES) == ["merkle", "kzg"]
    base = tcom.CellCommitmentScheme()
    for call in (lambda: base.commit(None), lambda: base.branch(None, 0),
                 lambda: base.prove_cells(None, []), lambda: base.verify_cells(b"", None, [], [])):
        with pytest.raises(NotImplementedError):
            call()


# --- the server ----------------------------------------------------------------------

def test_lru_cache_equals_jax():
    caches = (tsrv.LRUCache(3), jsrv.LRUCache(3))
    ops = [("put", "a", 1), ("put", "b", 2), ("get", "a"), ("put", "c", 3), ("put", "d", 4),
           ("get", "b"), ("get", "c"), ("peek", "a"), ("get", "a"), ("clear",), ("get", "d"),
           ("put", "e", 5), ("get", "e")]
    seen = []
    for cache, miss in zip(caches, (tsrv._MISS, jsrv._MISS)):
        out = []
        for op in ops:
            r = getattr(cache, op[0])(*op[1:])
            out.append("miss" if r is miss else r)
        out.append((cache.hits, cache.misses, cache.lookups, len(cache), cache.hit_rate))
        seen.append(out)
    assert seen[0] == seen[1]
    assert seen[0][-1] == (4, 2, 6, 1, 4 / 6)
    assert tsrv.LRUCache(1).hit_rate == 0.0


class _Sidecar:
    def __init__(self, cells, commitment):
        self.cells, self.commitment = cells, commitment


def _served(summary) -> dict:
    return {k: v for k, v in summary.items() if k not in TIMING}


def test_serve_samples_equals_jax():
    """The same sidecars and population through both servers: a fresh
    block, the same block again (from the proof cache), and a corrupted
    block on a fresh server."""
    with _Both() as both:
        teng_, jeng_ = _engines(both, seed=4)
        grids, coms, _ = teng_.build_for(2, b"\x07" * 32)
        out = []
        for srv, eng, pop in ((tsrv, teng_, tsam.SamplingClientPopulation(
                                  both.tcfg, 1000, 4, seed=1, device="cpu")),
                              (jsrv, jeng_, jsam.SamplingClientPopulation(1000, 4, seed=1))):
            sidecars = [_Sidecar(g.copy(), c) for g, c in zip(grids, coms)]
            server = srv.DasServer(eng.scheme)
            s1 = server.serve_samples(b"\x07" * 32, sidecars, pop)
            s2 = server.serve_samples(b"\x07" * 32, sidecars, pop)
            sidecars[0].cells[:, 0] ^= 0xFF
            s3 = srv.DasServer(eng.scheme).serve_samples(b"\x08" * 32, sidecars, pop)
            out.append(([_served(s) for s in (s1, s2, s3)],
                        (server.served_blocks, server.samples_served, server.scheme_builds,
                         server.proof_cache.hits, server.proof_cache.misses)))
        assert out[0] == out[1]
        (s1, s2, s3), counters = out[0]
        assert s1["failed"] == 0 and s1["clients_all_ok"] == 1000
        assert s2["cache_misses"] == 0 and s3["failed"] > 0
        assert counters[:3] == (2, 8000, 2)


def _chain(pkg, n=32, slots=9):
    sim = pkg.Simulation(n)
    sim.run_until_slot(slots)
    return sim


def test_best_update_equals_jax():
    with _Both() as both:
        spe = both.jcfg.slots_per_epoch
        updates = []
        for pkg, srv, eng in ((tsim, tsrv, teng.BlobEngine(both.tcfg, device="cpu")),
                              (jsim, jsrv, jeng.BlobEngine())):
            sim = _chain(pkg, slots=spe + 1)
            server = srv.DasServer(eng.scheme)
            store = sim.store()
            head = sim._get_head(sim.groups[0])
            first = server.best_update(store, head, archive=sim.block_archive)
            again = server.best_update(store, head, archive=sim.block_archive)
            assert again is first
            updates.append((type(first).serialize(first), server.update_cache.hits,
                            server.update_cache.misses))
        assert updates[0] == updates[1]
        assert updates[0][1:] == (1, 1)


class _CountingScheme:
    """Wraps a scheme, counting its backing branch builds."""

    def __init__(self, inner):
        self._inner = inner
        self.branch_calls = 0
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def branches(self, cells, indices):
        with self._lock:
            self.branch_calls += 1
        return self._inner.branches(cells, indices)


def test_build_blob_proofs_stampede_builds_once_per_blob():
    """8 threads serve one fresh block at once: one backing build per
    blob. Each thread sets its own config and backend (both are per
    thread; the port's default backend is CUDA)."""
    with _Both() as both:
        eng = teng.BlobEngine(both.tcfg, seed=4, device="cpu")
        grids, coms, _ = eng.build_for(2, b"\x07" * 32)
    sidecars = [_Sidecar(g, c) for g, c in zip(grids, coms)]
    scheme = _CountingScheme(eng.scheme)
    server = tsrv.DasServer(scheme)
    pops = [tsam.SamplingClientPopulation(both.tcfg, 400, 4, seed=s, device="cpu")
            for s in range(8)]
    gate = threading.Event()
    summaries, errors = [], []

    def serve(pop):
        gate.wait(5.0)
        try:
            with tc.use_config(both.tcfg), use_backend("torch", device="cpu"):
                summaries.append(server.serve_samples(b"\x09" * 32, sidecars, pop))
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(p,)) for p in pops]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(timeout=120.0)
    assert not errors, errors
    assert len(summaries) == 8 and all(s["failed"] == 0 for s in summaries)
    assert server.scheme_builds == scheme.branch_calls == len(sidecars)
    with tc.use_config(both.tcfg), use_backend("torch", device="cpu"):
        again = server.serve_samples(b"\x09" * 32, sidecars, pops[0])
    assert again["cache_misses"] == 0 and server.scheme_builds == len(sidecars)


# --- the dispatch entries ------------------------------------------------------------

def test_dispatch_entries_equal_jax():
    from pos_evolution_tpu.crypto.bls import FakeBLS
    with _Both() as both:
        rng = np.random.default_rng(9)
        grid = teng.BlobEngine(both.tcfg, seed=1, device="cpu").build_for(1, bytes(32))[0][0]
        scheme = tcom.get_scheme("merkle", "cpu", cfg=both.tcfg)
        pick = rng.integers(0, grid.shape[0], 12)
        _leaves, branches = scheme.branches(grid, pick)
        fields = dict(cells=grid[pick].copy(), branches=branches, indices=pick.astype(np.int64),
                      commitments=np.tile(np.frombuffer(scheme.commit(grid), np.uint8), (12, 1)))
        fields["cells"][3, 0] ^= 1
        got = tdv.verify_das_samples(tdv.DasSampleBatch(**{k: v.copy() for k, v in fields.items()}))
        want = jdv.verify_das_samples(jdv.DasSampleBatch(**fields))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        assert got["ok"].sum() == 11 and not got["ok"][3]
        present = np.zeros(grid.shape[0], bool)
        present[rng.choice(grid.shape[0], grid.shape[0] // 2 + 1, replace=False)] = True
        for cells_ in (grid, np.where(np.arange(grid.shape[0])[:, None] == 2, grid ^ 1, grid)):
            ok, data = tdv.reconstruct_check(cells_, present)
            jok, jdata = jdv.reconstruct_check(cells_, present)
            assert ok == bool(jok)
            np.testing.assert_array_equal(data, jdata)
        b, s = 4, 16
        pubkeys = rng.integers(0, 256, (b, s, 48)).astype(np.uint8)
        bits = rng.random((b, s)) < 0.7
        messages = rng.integers(0, 256, (b, 32)).astype(np.uint8)
        signatures = np.zeros((b, 96), np.uint8)
        for i in range(b):
            pks = [pubkeys[i, j].tobytes() for j in np.nonzero(bits[i])[0]]
            if pks and i != 2:                         # update 2 forged
                signatures[i] = np.frombuffer(FakeBLS.Aggregate(
                    [FakeBLS._sig_for(pk, messages[i].tobytes()) for pk in pks]), np.uint8)

        def group(depth):
            leaf = rng.integers(0, 256, (b, 32)).astype(np.uint8)
            branch = rng.integers(0, 256, (b, depth, 32)).astype(np.uint8)
            index = rng.integers(0, 1 << depth, b).astype(np.int64)
            root = jsv.merkle_roots_host(leaf, branch, index)
            root[1, 0] ^= 1
            return leaf, branch, index, root, rng.random(b) < 0.8

        fin, sc = group(6), group(5)
        fields = dict(pubkeys=pubkeys, bits=bits, weights=rng.integers(0, 2**40, (b, s)),
                      messages=messages, signatures=signatures,
                      fin_leaf=fin[0], fin_branch=fin[1], fin_index=fin[2], fin_root=fin[3],
                      fin_present=fin[4], sc_leaf=sc[0], sc_branch=sc[1], sc_index=sc[2],
                      sc_root=sc[3], sc_present=sc[4])
        got = tsv.verify_sync_update_batch(tsv.SyncUpdateBatch(**fields))
        want = jsv.verify_sync_update_batch(jsv.SyncUpdateBatch(**fields))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        assert not got["sig_ok"][2]
