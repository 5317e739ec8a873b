"""The port's FakeBLS aggregation (K1's plain version, its wrapper, sign and
verify) against the JAX package's XLA twin and against FakeBLS itself.

``tests/test_pallas.py`` pins the XLA twin to the Pallas kernel K1. All of
it is integer math: the comparisons are bit for bit (tolerance 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu.crypto.bls import FakeBLS  # noqa: E402
from pos_evolution_tpu.ops import aggregation as jagg  # noqa: E402
from pos_evolution_tpu_torch import convert  # noqa: E402
from pos_evolution_tpu_torch.device import words_to_numpy, words_to_torch  # noqa: E402
from pos_evolution_tpu_torch.ops import aggregation as tagg  # noqa: E402
from pos_evolution_tpu_torch.ops import kernels  # noqa: E402

N, A, C = 256, 8, 16


def _case(seed):
    """pubkeys, committees, bits (row 3 empty, row 5 full), messages."""
    rng = np.random.default_rng(seed)
    pubkeys = rng.integers(0, 256, (N, 48), dtype=np.uint8)
    committees = rng.permutation(N)[: A * C].reshape(A, C).astype(np.int32)
    bits = rng.random((A, C)) < 0.8
    bits[3] = False
    bits[5] = True
    msgs = rng.integers(0, 256, (A, 32), dtype=np.uint8)
    return pubkeys, committees, bits, msgs


def _jax_side(pubkeys, committees, bits, msg_words):
    pk = jagg.precompute_pk_states(pubkeys)
    sigs = jagg.aggregate_signatures_batch(pk, jnp.asarray(committees),
                                           jnp.asarray(bits), jnp.asarray(msg_words))
    return np.asarray(pk), np.asarray(sigs)


def _torch_side(pubkeys, committees, bits, msg_words):
    pk = tagg.precompute_pk_states(pubkeys, "cpu")
    return (pk, torch.from_numpy(committees), torch.from_numpy(bits),
            words_to_torch(msg_words, "cpu"))


@pytest.mark.parametrize("seed", [0, 1])
def test_sign_and_verify_match_jax(seed):
    pubkeys, committees, bits, msgs = _case(seed)
    msg_words = tagg.messages_to_words(msgs)
    np.testing.assert_array_equal(msg_words, jagg.messages_to_words(msgs))
    pk_j, sigs_j = _jax_side(pubkeys, committees, bits, msg_words)
    pk_t, comm_t, bits_t, msg_t = _torch_side(pubkeys, committees, bits, msg_words)
    np.testing.assert_array_equal(words_to_numpy(pk_t), pk_j)

    sigs_t = tagg.aggregate_signatures_batch(pk_t, comm_t, bits_t, msg_t)
    np.testing.assert_array_equal(words_to_numpy(sigs_t), sigs_j)

    tampered = sigs_j.copy()
    tampered[1, 7] ^= 1
    for provided in (sigs_j, tampered):
        want = np.asarray(jagg.aggregate_verify_batch(
            jnp.asarray(pk_j), jnp.asarray(committees), jnp.asarray(bits),
            jnp.asarray(msg_words), jnp.asarray(provided)))
        got = tagg.aggregate_verify_batch(pk_t, comm_t, bits_t, msg_t,
                                          words_to_torch(provided, "cpu")).numpy()
        np.testing.assert_array_equal(got, want)
    expect = bits.any(axis=1)
    np.testing.assert_array_equal(want, expect & (np.arange(A) != 1))


def test_matches_fakebls():
    """Aggregates equal FakeBLS.Aggregate over the set-bit signers; honest
    ones verify, a tampered one and an empty bitlist do not."""
    rng = np.random.default_rng(7)
    a, c, n = 4, 6, 24
    pubkeys_b = [FakeBLS.SkToPk(i + 1) for i in range(n)]
    pubkeys = np.frombuffer(b"".join(pubkeys_b), np.uint8).reshape(n, 48)
    committees = rng.permutation(n).reshape(a, c).astype(np.int32)
    bits = rng.random((a, c)) < 0.7
    bits[0] = True
    bits[2] = False
    msgs = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(a)]

    expected = []
    for i in range(a):
        signers = [pubkeys_b[v] for v, b in zip(committees[i], bits[i]) if b]
        sigs = [FakeBLS.Sign(int(v) + 1, msgs[i])
                for v, b in zip(committees[i], bits[i]) if b]
        expected.append(FakeBLS.Aggregate(sigs) if sigs else bytes(96))
        if signers:
            assert FakeBLS.FastAggregateVerify(signers, msgs[i], expected[-1])

    msg_words = tagg.messages_to_words(np.frombuffer(b"".join(msgs), np.uint8).reshape(a, 32))
    pk, comm, bits_t, msg_t = _torch_side(pubkeys, committees, bits, msg_words)
    agg = tagg.aggregate_signatures_batch(pk, comm, bits_t, msg_t)
    np.testing.assert_array_equal(words_to_numpy(agg), tagg.pack_signature_words(expected))

    ok = tagg.aggregate_verify_batch(pk, comm, bits_t, msg_t, agg).numpy()
    np.testing.assert_array_equal(ok, [True, True, False, True])
    bad = agg.clone()
    bad[3, 23] ^= 0x100
    assert not tagg.aggregate_verify_batch(pk, comm, bits_t, msg_t, bad)[3]


def test_wrapper_takes_plain_on_cpu_and_counts_no_launch():
    pubkeys, committees, bits, msgs = _case(2)
    pk, comm, bits_t, msg_t = _torch_side(pubkeys, committees, bits,
                                          tagg.messages_to_words(msgs))
    before = dict(kernels.launches)
    got = tagg.committee_aggregates(pk, comm, bits_t, msg_t)
    assert got.dtype == torch.int32 and got.shape == (A, 24)
    assert torch.equal(got, tagg._committee_aggregates(pk, comm, bits_t, msg_t))
    assert tagg.aggregate_verify_batch(pk, comm, bits_t, msg_t, got, plain=True).tolist() \
        == bits.any(axis=1).tolist()
    assert kernels.launches == before


def test_wrapper_raises_off_cpu_without_kernel():
    """A tensor that is not on the CPU never falls back to the plain version."""
    meta = dict(device="meta")
    args = (torch.empty((N, 8), dtype=torch.int32, **meta),
            torch.empty((A, C), dtype=torch.int32, **meta),
            torch.empty((A, C), dtype=torch.bool, **meta),
            torch.empty((A, 8), dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="no kernel"):
        tagg.committee_aggregates(*args)


def test_pk_states_convert_from_jax():
    pubkeys, *_ = _case(3)
    pk_j = jagg.precompute_pk_states(pubkeys)
    pk_t = convert.pk_states_to_torch(pk_j, "cpu")
    assert pk_t.dtype == torch.int32
    assert torch.equal(pk_t, tagg.precompute_pk_states(pubkeys, "cpu"))


def test_xor_reduce_odd_lengths():
    rng = np.random.default_rng(5)
    for length in (1, 2, 3, 5, 7, 16):
        x = rng.integers(0, 2**32, (3, length, 4), dtype=np.uint64).astype(np.int64)
        want = np.bitwise_xor.reduce(x, axis=1)
        got = tagg._xor_reduce(torch.from_numpy(x), dim=1).numpy()
        np.testing.assert_array_equal(got, want)
