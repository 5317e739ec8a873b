"""The port's DAS slice against the JAX package on the CPU, byte for byte:
the copied host layers (SHA-256 batches, GF(2^8) tables and erasure code,
containers, the commitment scheme, the engine, the store and the sampler),
kernel K6's plain version against hashlib, the sample verification and the
reconstruction check (kernel K7's plain version) against the JAX device
twins, on inputs made by numpy from a seed."""

import hashlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.config import mainnet_config as jax_mainnet  # noqa: E402
from pos_evolution_tpu.config import use_config  # noqa: E402
from pos_evolution_tpu.das import commitment as jcom  # noqa: E402
from pos_evolution_tpu.das import containers as jcon  # noqa: E402
from pos_evolution_tpu.das import engine as jeng  # noqa: E402
from pos_evolution_tpu.das import erasure as jera  # noqa: E402
from pos_evolution_tpu.das import sampler as jsam  # noqa: E402
from pos_evolution_tpu.ops import das_verify as jdv  # noqa: E402
from pos_evolution_tpu.ssz import hash as jhash  # noqa: E402
from pos_evolution_tpu_torch.config import mainnet_config  # noqa: E402
from pos_evolution_tpu_torch.das import commitment as tcom  # noqa: E402
from pos_evolution_tpu_torch.das import containers as tcon  # noqa: E402
from pos_evolution_tpu_torch.das import engine as teng  # noqa: E402
from pos_evolution_tpu_torch.das import erasure as tera  # noqa: E402
from pos_evolution_tpu_torch.das import sampler as tsam  # noqa: E402
from pos_evolution_tpu_torch.ops import das_verify as tdv  # noqa: E402
from pos_evolution_tpu_torch.ops import sha256 as tsha  # noqa: E402
from pos_evolution_tpu_torch.ssz import hash as thash  # noqa: E402

GEOM = dict(das_cells_per_blob=8, das_cell_bytes=64, das_max_blobs_per_block=3)
LENGTHS = (0, 16, 49, 52, 55, 56, 63, 64, 2048)


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain SHA-256 is thousands of small tensor ops: one intra-op
    thread keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = {**GEOM, **kw}
    return mainnet_config().replace(**kw), jax_mainnet().replace(**kw)


def _hashlib_rows(msgs):
    return np.stack([np.frombuffer(hashlib.sha256(m.tobytes()).digest(), np.uint8)
                     for m in msgs]) if len(msgs) else np.empty((0, 32), np.uint8)


# --- the copied host layers --------------------------------------------------------

@pytest.mark.parametrize("length", LENGTHS)
def test_host_sha256_and_padding_equal_jax(length):
    rng = np.random.default_rng(length)
    for n in (1, 5, 1024):
        msgs = rng.integers(0, 256, (n, length)).astype(np.uint8)
        np.testing.assert_array_equal(thash._pad_messages(msgs), jhash._pad_messages(msgs))
        want = _hashlib_rows(msgs)
        np.testing.assert_array_equal(thash.sha256_batch(msgs), want)
        np.testing.assert_array_equal(jhash.sha256_batch(msgs), want)
    left, right = (rng.integers(0, 256, (7, 32)).astype(np.uint8) for _ in range(2))
    np.testing.assert_array_equal(thash.sha256_pairs(left, right), jhash.sha256_pairs(left, right))
    assert thash.sha256_batch(np.zeros((0, 5), np.uint8)).shape == (0, 32)


@pytest.mark.parametrize("length", LENGTHS)
def test_k6_plain_equals_hashlib(length):
    """K6's plain version, through ``sha256_rows`` (host padding and
    padding on the tensor's device) and ``sha256_blocks``, at lengths that
    fill, straddle and span blocks."""
    rng = np.random.default_rng(100 + length)
    msgs = rng.integers(0, 256, (6, length)).astype(np.uint8)
    want = _hashlib_rows(msgs)
    np.testing.assert_array_equal(tsha.sha256_rows(msgs, "cpu").numpy(), want)
    np.testing.assert_array_equal(tsha.sha256_rows(torch.from_numpy(msgs)).numpy(), want)
    np.testing.assert_array_equal(tsha.pad_words(torch.from_numpy(msgs)).numpy().view(np.uint32),
                                  thash._pad_messages(msgs))
    words = torch.from_numpy(thash._pad_messages(msgs).view(np.int32))
    got = tsha.sha256_blocks(words)
    assert got.dtype == torch.int32 and got.shape == (6, 8)
    assert torch.equal(got, tsha.sha256_blocks(words, plain=True))
    assert tsha.sha256_rows(msgs[:0], "cpu").shape == (0, 32)


def test_gf_tables_and_erasure_equal_jax():
    np.testing.assert_array_equal(tera.GF_EXP, jera.GF_EXP)
    np.testing.assert_array_equal(tera.GF_LOG, jera.GF_LOG)
    assert tera.GF_EXP.dtype == jera.GF_EXP.dtype and tera.GF_LOG.dtype == jera.GF_LOG.dtype
    for a in range(256):
        for b in range(0, 256, 7):
            assert tera.gf_mul(a, b) == jera.gf_mul(a, b)
        if a:
            assert tera.gf_inv(a) == jera.gf_inv(a)
    with pytest.raises(ZeroDivisionError):
        tera.gf_inv(0)
    for k in (1, 2, 8, 16):
        np.testing.assert_array_equal(tera.extension_matrix(k), jera.extension_matrix(k))
    sel = (3, 5, 8, 9, 10, 12, 14, 15)
    np.testing.assert_array_equal(tera.lagrange_matrix(sel, tuple(range(8))),
                                  jera.lagrange_matrix(sel, tuple(range(8))))
    with pytest.raises(ValueError):
        tera.extension_matrix(129)


def test_extend_and_reconstruct_blob_equal_jax_at_peerdas_geometry():
    """k = 64 data cells of 2,048 bytes: the host copies against the JAX
    package's, and K7's plain version against both."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (64, 2048)).astype(np.uint8)
    grid = tera.extend_blob(data)
    np.testing.assert_array_equal(grid, jera.extend_blob(data))
    parity = tdv.gf_matmul(torch.from_numpy(tera.extension_matrix(64)[None].copy()),
                           torch.from_numpy(data[None]))
    np.testing.assert_array_equal(parity[0].numpy(), grid[64:])
    present = np.zeros(128, bool)
    present[64:] = True
    for got, want in zip(tera.reconstruct_blob(grid, present),
                         jera.reconstruct_blob(grid, present)):
        np.testing.assert_array_equal(got, want)
    ok, back = tdv.reconstruct_check_device(grid, present, "cpu")
    assert ok and (back == data).all()


@pytest.mark.parametrize("k", [8, 64])
def test_validate_das_config_equals_jax(k):
    bad = ({"das_cells_per_blob": 6}, {"das_cells_per_blob": 256}, {"das_cell_bytes": 96},
           {"das_max_blobs_per_block": 256}, {"das_samples_per_client": 0})
    tcfg, jcfg = _cfgs(das_cells_per_blob=k)
    tcon.validate_das_config(tcfg)
    jcon.validate_das_config(jcfg)
    for kw in bad:
        with pytest.raises(ValueError):
            jcon.validate_das_config(jcfg.replace(**kw))
        with pytest.raises(ValueError):
            tcon.validate_das_config(tcfg.replace(**kw))


def test_graffiti_and_digest_equal_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 9):
        coms = [rng.integers(0, 256, 32).astype(np.uint8).tobytes() for _ in range(n)]
        g = tcon.das_graffiti(coms)
        assert g == jcon.das_graffiti(coms)
        assert tcon.parse_das_graffiti(g) == jcon.parse_das_graffiti(g)
        assert tcon.commitments_digest(coms) == jcon.commitments_digest(coms)
    assert tcon.parse_das_graffiti(b"x" * 32) is None


def test_kzg_scheme_raises_naming_item_5b():
    """The KZG scheme (ROADMAP Queue 1 item 5b) is ported: ``get_scheme("kzg",
    "cpu")`` commits a grid to the JAX package's wire commitment (its memo
    then serves the recommit); an unknown name still raises, naming both
    schemes."""
    tcfg, jcfg = _cfgs()
    scheme = tcom.get_scheme("kzg", "cpu", cfg=tcfg)
    grid = np.random.default_rng(5).integers(0, 256, (16, 64), dtype=np.uint8)
    with use_config(jcfg):
        want = jcom.get_scheme("kzg").commit_full(grid)
    assert scheme.name == "kzg" and scheme.commit(grid) == want[3]
    point, comp, coeffs, wire = scheme.commit_full(grid)
    assert (point, comp, coeffs, wire) == (want[0], want[1], tuple(want[2]), want[3])
    assert len(scheme._memo) == 1
    with pytest.raises(ValueError, match=r"unknown.*'merkle', 'kzg'"):
        tcom.get_scheme("nope", "cpu")


# --- the engine, the store and the sampler ---------------------------------------

@pytest.fixture(scope="module")
def built():
    """One proposal's grids from both packages under one config."""
    tcfg, jcfg = _cfgs()
    root = bytes(range(32))
    tengine = teng.BlobEngine(tcfg, seed=5, device="cpu")
    with use_config(jcfg):
        jengine = jeng.BlobEngine(seed=5)
        jout = jengine.build_for(17, root)
    return tcfg, jcfg, tengine, jengine, tengine.build_for(17, root), jout


def test_build_for_equals_jax(built):
    _, _, tengine, jengine, (tgrids, tcoms, tgraf), (jgrids, jcoms, jgraf) = built
    assert len(tgrids) == len(jgrids) == 3
    for a, b in zip(tgrids, jgrids):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert tcoms == jcoms and tgraf == jgraf
    with use_config(built[1]):
        assert tengine.describe() == jengine.describe()
    np.testing.assert_array_equal(tengine.blob_data(17, bytes(range(32)), 2), jgrids[2][:8])


def test_commitments_and_branches_equal_jax(built):
    tcfg, jcfg, tengine, _, (tgrids, tcoms, _), _ = built
    tscheme, jscheme = tengine.scheme, jcom.get_scheme("merkle")
    idx = [0, 3, 15, 8]
    with use_config(jcfg):
        for grid, com in zip(tgrids, tcoms):
            assert tscheme.commit(grid) == jscheme.commit(grid) == com
            np.testing.assert_array_equal(tscheme.cell_leaves(grid).numpy(),
                                          jscheme.cell_leaves(grid))
            for got, want in zip(tscheme.branches(grid, idx), jscheme.branches(grid, idx)):
                np.testing.assert_array_equal(got, want)
    roots = tscheme.commit_batch(torch.from_numpy(np.stack(tgrids)))
    assert [tsha.words_to_rows(r[None]).numpy().tobytes() for r in roots] == tcoms


def _poisoned(grids, coms):
    """(cells, commitment, blob_index, n_blobs) of every sidecar the store
    tests feed: a flipped data cell, then the honest one; a flipped parity
    cell, then the honest one; a wrong commitment, a wrong shape, a blob
    index past n_blobs, the honest third; then redeliveries of a stored
    (block, blob, commitment), the second with the flipped cells."""
    flip_data = grids[0].copy()
    flip_data[2, 5] ^= 0x40
    flip_parity = grids[1].copy()
    flip_parity[12, 0] ^= 1
    return [(flip_data, coms[0], 0, 3), (grids[0], coms[0], 0, 3),
            (flip_parity, coms[1], 1, 3), (grids[1], coms[1], 1, 3),
            (grids[2], coms[1], 2, 3), (grids[2][:15], coms[2], 2, 3),
            (grids[2], coms[2], 3, 3), (grids[2], coms[2], 2, 3),
            (grids[0], coms[0], 0, 3), (flip_data, coms[0], 0, 3)]


def test_store_on_sidecar_equals_jax(built):
    tcfg, jcfg, tengine, jengine, (tgrids, tcoms, tgraf), _ = built
    root = b"\x07" * 32
    cases = _poisoned(tgrids, tcoms)
    tstore, tbatch = teng.BlobStore(tengine), teng.BlobStore(tengine)
    with use_config(jcfg):
        jstore = jeng.BlobStore(jengine)
        want = [jstore.on_sidecar(jcon.BlobSidecar(
            slot=3, proposer_index=1, block_root=root, blob_index=bi, n_blobs=nb,
            cells=cells, commitment=com)) for cells, com, bi, nb in cases]
    scs = [tcon.BlobSidecar(slot=3, proposer_index=1, block_root=root, blob_index=bi,
                            n_blobs=nb, cells=cells, commitment=com)
           for cells, com, bi, nb in cases]
    got = [tstore.on_sidecar(sc) for sc in scs]
    assert got == want == [False, True, False, True, False, False, False, True, True, True]
    assert tbatch.on_sidecars(scs) == want       # one batch, the same order semantics
    assert {k: sorted(v) for k, v in tstore.sidecars.items()} == \
        {k: sorted(v) for k, v in jstore.sidecars.items()}
    block = types.SimpleNamespace(body=types.SimpleNamespace(graffiti=tgraf))
    assert tstore.is_available(root, block) and tbatch.is_available(root, block)
    other = types.SimpleNamespace(body=types.SimpleNamespace(graffiti=tcon.das_graffiti(
        [tcoms[1], tcoms[0], tcoms[2]])))
    assert not teng.BlobStore(tengine).is_available(root, other)
    assert [sc.blob_index for sc in tstore.sidecars_for_block(root)] == [0, 1, 2]


def test_select_cells_equals_jax():
    tcfg, jcfg = _cfgs()
    root = bytes(range(1, 33))
    tpop = tsam.SamplingClientPopulation(tcfg, 50, samples_per_client=12, seed=9, device="cpu")
    with use_config(jcfg):
        jpop = jsam.SamplingClientPopulation(50, samples_per_client=12, seed=9)
        want = jpop.select_cells(root, 3, 16)
    for got, exp in zip(tpop.select_cells(root, 3, 16), want):
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)
    assert (tpop.blocks_sampled, tpop.samples_drawn) == (jpop.blocks_sampled, jpop.samples_drawn)
    assert tpop.describe() == jpop.describe()
    dflt = tsam.SamplingClientPopulation(tcfg, 4, device="cpu")
    assert dflt.samples == tcfg.das_samples_per_client


# --- sample verification and the reconstruction check against JAX --------------

def _sample_batch(tengine, grids, coms, rng, n):
    blob = rng.integers(0, len(grids), n)
    cell = rng.integers(0, grids[0].shape[0], n)
    branches = np.zeros((n, 4, 32), np.uint8)
    for i in range(n):
        _, br = tengine.scheme.branches(grids[blob[i]], [int(cell[i])])
        branches[i] = br[0]
    cells = np.stack([grids[b][c] for b, c in zip(blob, cell)])
    commits = np.stack([np.frombuffer(coms[b], np.uint8) for b in blob])
    return tdv.DasSampleBatch(cells=cells, branches=branches, indices=cell.astype(np.int64),
                              commitments=commits)


def test_sample_verification_equals_jax(built):
    _, jcfg, tengine, _, (grids, coms, _), _ = built
    rng = np.random.default_rng(21)
    batch = _sample_batch(tengine, grids, coms, rng, 24)
    batch.cells[3, 7] ^= 1                 # a corrupted cell
    batch.branches[5, 2, 0] ^= 0x80        # a corrupted branch
    batch.commitments[9, 31] ^= 2          # a wrong commitment
    host = tdv.verify_samples_host(batch)
    got = tdv.verify_samples_device(batch, "cpu")
    with use_config(jcfg):
        jhost = jdv.verify_samples_host(batch)
        jdev = jdv.verify_samples_device(batch)
    for want in (host, jhost, jdev):
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])
    assert (~got["ok"]).nonzero()[0].tolist() == [3, 5, 9]


@pytest.mark.parametrize("case", ["parity_half", "random_subset", "corrupted", "too_few"])
def test_reconstruct_check_equals_jax(case):
    rng = np.random.default_rng(["parity_half", "random_subset", "corrupted",
                                 "too_few"].index(case))
    k = 8
    grid = tera.extend_blob(rng.integers(0, 256, (k, 64)).astype(np.uint8))
    present = np.zeros(2 * k, bool)
    present[k:] = True
    if case == "random_subset":
        present = rng.permutation(np.arange(2 * k) < 11)
        grid[~present] = rng.integers(0, 256, (int((~present).sum()), 64))
    if case == "corrupted":
        present[:] = True
        grid[4, 9] ^= 0x21
    if case == "too_few":
        present = np.arange(2 * k) < k - 1
        with pytest.raises(ValueError, match="reconstruction needs"):
            tdv.reconstruct_check_device(grid, present, "cpu")
        with pytest.raises(ValueError, match="reconstruction needs"):
            jdv.reconstruct_check_device(grid, present)
        return
    ok, data = tdv.reconstruct_check_device(grid, present, "cpu")
    jok, jdata = jdv.reconstruct_check_device(grid, present)
    hok, hdata = tdv.reconstruct_check_host(grid, present)
    assert ok == jok == hok == (case != "corrupted")
    assert type(ok) is type(jok) is bool
    assert data.dtype == jdata.dtype == np.uint8
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(data, hdata)


def test_k7_plain_broadcasts_and_zero_rows():
    """K7's plain version against the host product per group, with zero
    rows and columns and each operand's group axis broadcast."""
    rng = np.random.default_rng(31)
    a = rng.integers(0, 256, (4, 6, 8)).astype(np.uint8)
    b = rng.integers(0, 256, (4, 8, 12)).astype(np.uint8)
    a[1, 2] = 0
    b[2, :, 5] = 0
    got = tdv.gf_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for g in range(4):
        np.testing.assert_array_equal(got[g], tera.gf_matmul(a[g], b[g]))
    one = tdv.gf_matmul(torch.from_numpy(a[:1]), torch.from_numpy(b)).numpy()
    for g in range(4):
        np.testing.assert_array_equal(one[g], tera.gf_matmul(a[0], b[g]))
    assert tdv.gf_matmul(torch.from_numpy(a[:1]), torch.from_numpy(b[:0])).shape == (0, 6, 12)
    with pytest.raises(ValueError, match="cannot multiply"):
        tdv.gf_matmul(torch.from_numpy(a[:2]), torch.from_numpy(b[:3]))


def test_entry_points_default_to_the_card():
    """Without CUDA every entry point of the slice raises unless asked for
    the CPU; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from pos_evolution_tpu_torch.ops import sync_verify as tsv
    tcfg, _ = _cfgs()
    grid = np.zeros((16, 64), np.uint8)
    batch = tdv.DasSampleBatch(cells=grid[:2], branches=np.zeros((2, 4, 32), np.uint8),
                               indices=np.zeros(2, np.int64),
                               commitments=np.zeros((2, 32), np.uint8))
    calls = (lambda: tsha.sha256_rows(np.zeros((2, 5), np.uint8)),
             lambda: tdv.verify_samples_device(batch),
             lambda: tdv.reconstruct_check_device(grid, np.ones(16, bool)),
             lambda: tcom.get_scheme("merkle"),
             lambda: teng.BlobEngine(tcfg),
             lambda: tsam.SamplingClientPopulation(tcfg, 4),
             lambda: tsv.merkle_roots_device(grid[:2, :32], np.zeros((2, 1, 32), np.uint8),
                                             np.zeros(2)))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
