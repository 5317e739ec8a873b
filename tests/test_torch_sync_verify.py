"""The port's light-client sync-update verification against the JAX
package on the CPU: ``verify_batch_device(device="cpu")`` (the plain
versions of K1, K2 and K6) and ``verify_batch_host`` against JAX's
``verify_batch_device`` and ``verify_batch_host``, every key and dtype, on
the spec-built batch of ``tests/test_lightclient.py`` (one signature and
one branch corrupted) and on seeded synthetic batches."""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.crypto.bls import FakeBLS  # noqa: E402
from pos_evolution_tpu.ops import aggregation as jagg  # noqa: E402
from pos_evolution_tpu.ops import sync_verify as jsv  # noqa: E402
from pos_evolution_tpu_torch.ops import aggregation as tagg  # noqa: E402
from pos_evolution_tpu_torch.ops import sync_verify as tsv  # noqa: E402

FIN_DEPTH, SC_DEPTH = 6, 5      # lightclient/containers.py: the two branch depths


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain SHA-256 is thousands of small tensor ops: one intra-op
    thread keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_results_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _synthetic(seed, b=12, s=32):
    """Seeded updates: honest and forged signatures, empty bitlists,
    weights, valid and corrupted branches, absent branch groups."""
    rng = np.random.default_rng(seed)
    pubkeys = rng.integers(0, 256, (b, s, 48)).astype(np.uint8)
    bits = rng.random((b, s)) < 0.7
    bits[1] = False                                   # an empty bitlist
    messages = rng.integers(0, 256, (b, 32)).astype(np.uint8)
    signatures = np.zeros((b, 96), np.uint8)
    for i in range(b):
        pks = [pubkeys[i, j].tobytes() for j in np.nonzero(bits[i])[0]]
        if pks and i % 4 != 3:                        # every 4th forged
            sig = FakeBLS.Aggregate([FakeBLS._sig_for(pk, messages[i].tobytes()) for pk in pks])
            signatures[i] = np.frombuffer(sig, np.uint8)
        else:
            signatures[i] = rng.integers(0, 256, 96)

    def group(depth):
        leaf = rng.integers(0, 256, (b, 32)).astype(np.uint8)
        branch = rng.integers(0, 256, (b, depth, 32)).astype(np.uint8)
        index = rng.integers(0, 1 << depth, b).astype(np.int64)
        root = jsv.merkle_roots_host(leaf, branch, index)
        root[::5, 0] ^= 1                             # every 5th root wrong
        present = rng.random(b) < 0.8
        return leaf, branch, index, root, present

    fin, sc = group(FIN_DEPTH), group(SC_DEPTH)
    return dict(pubkeys=pubkeys, bits=bits,
                weights=rng.integers(0, 2**40, (b, s)).astype(np.int64),
                messages=messages, signatures=signatures,
                fin_leaf=fin[0], fin_branch=fin[1], fin_index=fin[2], fin_root=fin[3],
                fin_present=fin[4], sc_leaf=sc[0], sc_branch=sc[1], sc_index=sc[2],
                sc_root=sc[3], sc_present=sc[4])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_batches_equal_jax(seed):
    fields = _synthetic(seed)       # one shape: one JAX compile for the three
    tbatch, jbatch = tsv.SyncUpdateBatch(**fields), jsv.SyncUpdateBatch(**fields)
    want = jsv.verify_batch_host(jbatch)
    _assert_results_equal(tsv.verify_batch_host(tbatch), want)
    _assert_results_equal(tsv.verify_batch_device(tbatch, "cpu"), want)
    _assert_results_equal(tsv.verify_batch_device(tbatch, "cpu"), jsv.verify_batch_device(jbatch))
    assert not want["sig_ok"][1] and want["participation"][1] == 0
    assert want["sig_ok"].any() and not want["sig_ok"].all()
    assert want["fin_ok"].any() and not want["fin_ok"].all()


def test_spec_built_batch_equals_jax():
    """The light-client updates of a 64-validator spec simulation, one
    signature and one finality branch corrupted (the JAX package's own
    parity test, ``tests/test_lightclient.py``)."""
    from pos_evolution_tpu.lightclient import build_update, updates_to_batch
    from pos_evolution_tpu.sim import Simulation
    sim = Simulation(64)
    updates = []
    for _ in range(16):
        sim.run_slot()
        g = sim.groups[0]
        u = build_update(g.store, sim._get_head(g), archive=sim.block_archive)
        if u is not None:
            updates.append(u)
    assert len(updates) >= 8
    genesis = sim.genesis_state
    jbatch = updates_to_batch(updates, [genesis.current_sync_committee] * len(updates),
                              bytes(genesis.fork.current_version),
                              bytes(genesis.genesis_validators_root))
    jbatch.signatures[1, 0] ^= 0xFF
    # 16 slots finalize nothing, so the corrupted branch is a present
    # next-sync-committee one
    assert jbatch.sc_present[2] and not jbatch.fin_present.any()
    jbatch.sc_branch[2, 0, 0] ^= 1
    tbatch = tsv.SyncUpdateBatch(**vars(jbatch))
    want = jsv.verify_batch_device(jbatch)
    _assert_results_equal(tsv.verify_batch_device(tbatch, "cpu"), want)
    _assert_results_equal(tsv.verify_batch_host(tbatch), want)
    assert not want["sig_ok"][1] and want["sig_ok"][0]
    assert not want["sc_ok"][2] and want["sc_ok"][3]


def test_empty_and_edge_batches():
    """No update; updates with no lanes; depth-0 branches."""
    for b, s in ((0, 32), (2, 0)):
        f = _synthetic(9, b=3, s=max(s, 1))
        f = {k: (v[:b, :s] if k in ("pubkeys", "bits", "weights") else v[:b])
             for k, v in f.items()}
        _assert_results_equal(tsv.verify_batch_device(tsv.SyncUpdateBatch(**f), "cpu"),
                              jsv.verify_batch_host(jsv.SyncUpdateBatch(**f)))
    leaf = np.random.default_rng(4).integers(0, 256, (3, 32)).astype(np.uint8)
    np.testing.assert_array_equal(
        tsv.merkle_roots_device(leaf, np.zeros((3, 0, 32), np.uint8), np.zeros(3), "cpu"), leaf)


def test_fakebls_and_tallies_equal_jax():
    rng = np.random.default_rng(5)
    pks = [rng.integers(0, 256, 48).astype(np.uint8).tobytes() for _ in range(5)]
    msg = hashlib.sha256(b"m").digest()
    sig = FakeBLS.Aggregate([FakeBLS._sig_for(pk, msg) for pk in pks])
    for args in ((pks, msg, sig), (pks[:4], msg, sig), ([], msg, sig)):
        assert tsv.fakebls_fast_aggregate_verify(*args) == FakeBLS.FastAggregateVerify(*args)
    bits = rng.random((6, 40)) < 0.5
    weights = rng.integers(0, 2**40, (6, 40)).astype(np.int64)
    count, weight = tagg.aggregate_bits_and_weights(torch.from_numpy(bits),
                                                    torch.from_numpy(weights))
    jcount, jweight = jagg.aggregate_bits_and_weights(bits, weights)
    assert count.dtype == torch.int32 and weight.dtype == torch.int64
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    np.testing.assert_array_equal(weight.numpy(), np.asarray(jweight))
