"""The port's ``KzgCellScheme`` against the JAX package's on the CPU (its
numpy backend: host Pippenger and oracle pairings), at tolerance 0:
commits of random grids (point, compression, coefficients, wire, the
memo), aggregate proofs byte for byte, and the verdicts of the
single-blob proofs (honest, corrupted cell, wrong commitment, malformed
proof); the aggregate proofs' verdicts are in
``tests/test_torch_kzg_verdicts.py`` (split off to run on a test worker
of its own). Inputs come from numpy with a seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.config import mainnet_config as jax_mainnet  # noqa: E402
from pos_evolution_tpu.config import minimal_config as jax_minimal  # noqa: E402
from pos_evolution_tpu.config import use_config  # noqa: E402
from pos_evolution_tpu.kzg.scheme import KzgCellScheme as JaxScheme  # noqa: E402
from pos_evolution_tpu_torch.config import mainnet_config, minimal_config  # noqa: E402
from pos_evolution_tpu_torch.das.commitment import get_scheme  # noqa: E402
from pos_evolution_tpu_torch.device import words_to_rows  # noqa: E402
from pos_evolution_tpu_torch.kzg.scheme import KzgCellScheme  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """A plain field op is hundreds of small tensor ops: one intra-op thread
    keeps parallel test workers from oversubscribing the cores. Module
    scope, so that it also wraps the module's fixtures, which run first."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(cfg, seed, count):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (2 * cfg.das_cells_per_blob, cfg.das_cell_bytes),
                         dtype=np.uint8) for _ in range(count)]


def test_commits_equal_jax_at_the_default_geometry():
    """Three grids committed in one batch (N = 128, mainnet's geometry),
    one of them twice: point, compression, coefficients and wire equal the
    JAX package's ``commit_full``; the memo serves the recommit and the
    duplicate; ``commit_batch`` returns the wires as (G, 8) words."""
    cfg = mainnet_config()
    scheme = get_scheme("kzg", "cpu", cfg=cfg)
    assert scheme.geometry() == (32, 4, 128)
    grids = _grids(cfg, 19, 3)
    batch = torch.from_numpy(np.stack(grids + grids[:1]))
    with use_config(jax_mainnet()):
        jax = JaxScheme()
        want = [jax.commit_full(g) for g in grids]
    batches = []
    compute = scheme._commit_device
    scheme._commit_device = lambda g: batches.append(g.shape[0]) or compute(g)
    words = scheme.commit_batch(batch)
    assert words.shape == (4, 8) and words.dtype == torch.int32
    rows = words_to_rows(words).numpy()
    assert [r.tobytes() for r in rows] == [w[3] for w in want + want[:1]]
    assert batches == [3] and len(scheme._memo) == 3
    for grid, (point, comp, coeffs, wire) in zip(grids, want):
        assert scheme.commit_full(grid) == (point, comp, tuple(coeffs), wire)
        assert scheme.commit(grid) == wire == scheme.wire_bind(comp)
    assert batches == [3]                             # every one a memo hit
    bad = grids[0].copy()
    bad[3, 5] ^= 1
    assert scheme.commit(bad) != want[0][3] and batches == [3, 1]


@pytest.fixture(scope="module")
def committee():
    """tests/test_kzg.py's committee at the minimal geometry (N = 64): two
    grids, four samples, the port's proof and the JAX package's."""
    cfg = minimal_config()
    scheme = KzgCellScheme("cpu", cfg=cfg)
    n_cells = scheme.geometry()[0]
    grids = _grids(cfg, 29, 2)
    samples = [(0, 0), (0, 5), (1, 2), (1, n_cells - 1)]
    with use_config(jax_minimal()):
        jax = JaxScheme()
        jproof = jax.prove_aggregate(grids, samples)
        jcell_proof = jax.prove_cells(grids[0], [0, 3, 7])
    return {"scheme": scheme, "jax": jax, "grids": grids, "samples": samples,
            "wires": [scheme.commit(g) for g in grids],
            "cells": [grids[b][c] for b, c in samples],
            "proof": scheme.prove_aggregate(grids, samples), "jproof": jproof,
            "cell_proof": scheme.prove_cells(grids[0], [0, 3, 7]), "jcell_proof": jcell_proof}


def test_proofs_equal_jax(committee):
    assert committee["proof"] == committee["jproof"]
    assert committee["cell_proof"] == committee["jcell_proof"]
    s, proof = committee["scheme"], committee["proof"]
    assert s.proof_n_bytes(proof) == 48 * (len(committee["grids"]) + 2)
    assert s.decode_proof(s.encode_proof(proof)) == proof
    with pytest.raises(ValueError):
        s.decode_proof(s.encode_proof(proof)[1:])


def test_cell_proof_verdicts_equal_jax(committee):
    """The single-blob proofs of ``prove_cells`` through ``verify_cells``:
    the honest and the corrupted cell, the wrong commitment and the
    malformed proofs (these fail before the pairing), each verdict as the
    JAX package's."""
    s, jax = committee["scheme"], committee["jax"]
    grid, wire, idx = committee["grids"][0], committee["wires"][0], [0, 3, 7]
    proof = committee["cell_proof"]
    bad = grid[idx].copy()
    bad[1, 0] ^= 0x01
    got = [s.verify_cells(wire, cells, idx, proof) for cells in (grid[idx], bad)]
    malformed = ([], [b"not-the-tag"] + proof[1:], proof[:-1] + [b"\xff" * 48])
    got += [s.verify_cells(b"\x00" * 32, grid[idx], idx, proof)]
    got += [s.verify_cells(wire, grid[[1]], [1], p) for p in malformed]
    with use_config(jax_minimal()):
        want = [jax.verify_cells(wire, cells, idx, proof) for cells in (grid[idx], bad)]
        want += [jax.verify_cells(b"\x00" * 32, grid[idx], idx, proof)]
        want += [jax.verify_cells(wire, grid[[1]], [1], p) for p in malformed]
    assert got == want == [True] + [False] * 5
