"""The real-BLS verify slice (``pos_evolution_tpu_torch/bls_verify.py``):
``build_inputs`` makes the host draws of the JAX package's
``scripts/bench_config3_real.py`` exactly, the host helpers agree with
the oracle, and (slow tier: the whole slice takes about two minutes on
the CPU through the plain versions) the slice's verdicts and negative
control agree with ``PyBLS``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.crypto import bls12_381 as jo  # noqa: E402
from pos_evolution_tpu.crypto.bls12_381 import PyBLS  # noqa: E402
from pos_evolution_tpu_torch import bls_verify as bv  # noqa: E402
from pos_evolution_tpu_torch.crypto import bls12_381 as o  # noqa: E402
from pos_evolution_tpu_torch.ops import fp  # noqa: E402
from pos_evolution_tpu_torch.ops.pairing import g2_affine_encode  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain field ops are thousands of tiny tensor ops: one intra-op
    thread keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script_draws(B, N, K, seed):
    """``bench_config3_real.py:79-121``'s draws, as the script writes them,
    with the JAX package's oracle."""
    C = N // B
    rng = np.random.default_rng(seed)
    sks = [int(rng.integers(2, 2**62)) for _ in range(K)]
    pk_comp = [jo.g1_compress(jo.ec_mul(jo.G1_GEN, sk)) for sk in sks]
    sk_of = np.asarray([sks[i % K] for i in range(N)], dtype=object)
    committees = rng.permutation(N).reshape(B, C).astype(np.int32)
    bits = rng.random((B, C)) < 0.99
    bits[:, 0] = True
    messages = [rng.bytes(32) for _ in range(B)]
    agg_sk = np.zeros(B, dtype=object)
    for b in range(B):
        agg_sk[b] = int(sum(int(s) for s in sk_of[committees[b][bits[b]]]) % jo.R)
    return sks, pk_comp, committees, bits, messages, agg_sk


@pytest.mark.parametrize("b,n,k,seed", [(4, 512, 8, bv.SEED), (8, 64, 3, 7)])
def test_build_inputs_matches_script_draws(b, n, k, seed):
    got = bv.build_inputs(b, n, distinct_keys=k, seed=seed)
    sks, pk_comp, committees, bits, messages, agg_sk = _script_draws(b, n, k, seed)
    assert got.sks == sks and got.pk_comp == pk_comp
    np.testing.assert_array_equal(got.committees, committees)
    assert got.committees.dtype == np.int32
    np.testing.assert_array_equal(got.bits, bits)
    assert got.messages == messages
    assert got.agg_sk == [int(v) for v in agg_sk]
    assert got.bits[:, 0].all() and got.bits.mean() > 0.9


def test_build_inputs_rejects_ragged():
    with pytest.raises(ValueError, match="divide"):
        bv.build_inputs(3, 10, distinct_keys=2)


def test_host_helpers_match_oracle():
    inputs = bv.build_inputs(2, 4, distinct_keys=3, seed=1)
    xs, signs = bv._pk_limbs(inputs.pk_comp)
    for i, d in enumerate(inputs.pk_comp):
        x, y = o.g1_decompress(d)
        assert fp.from_limbs(xs[i]) == x and bool(signs[i]) == o._y_is_large(y)
    bits = bv._scalar_bits([5, o.R - 1])
    assert bits.shape == (2, 255) and bits[0, -3:].tolist() == [True, False, True]
    assert int("".join("1" if v else "0" for v in bits[1]), 2) == o.R - 1
    pts = [o.ec_mul(o.G2_GEN, k) for k in (2, 9)]
    sig = torch.from_numpy(np.stack([g2_affine_encode(p) for p in pts]))
    np.testing.assert_array_equal(bv._compress(sig),
                                  np.stack([np.frombuffer(o.g2_compress(p), np.uint8) for p in pts]))


def test_oracle_tensors_shapes():
    inputs = bv.build_inputs(2, 6, distinct_keys=2, seed=2)
    t = bv.oracle_tensors(inputs, "cpu")
    assert t.pk_table.shape == (6, 2, fp.L) and t.committees.shape == (2, 3)
    assert t.msg_g2.shape == t.sig_g2.shape == (2, 2, 2, fp.L) and not t.sig_inf.any()
    np.testing.assert_array_equal(t.msg_g2[1].numpy(),
                                  g2_affine_encode(o.hash_to_g2(inputs.messages[1])))


@pytest.mark.slow
def test_whole_slice_agrees_with_pybls():
    """B = 2 aggregates of C = 2 on the CPU: every stage of ``run``, all
    verdicts true and equal to PyBLS, the swapped pair rejected as PyBLS
    rejects it, the hashed messages equal to the oracle's."""
    inputs = bv.build_inputs(2, 4, distinct_keys=2, seed=5)
    out = bv.run(inputs, "cpu")
    s = out.summary
    assert s["verified"] == 2 and s["negative_control_rejected"] == [0, 1]
    assert s["hash_oracle_rows"] == {"setup": 0, "verify": 0}
    assert not any(v for stage in s["launches"].values() for v in stage.values())
    sig_bytes = [bytes(r) for r in bv._compress(out.tensors.sig_g2)]
    for i in range(2):
        members = [inputs.pk_comp[int(v) % 2] for v, b in
                   zip(inputs.committees[i], inputs.bits[i]) if b]
        assert PyBLS.FastAggregateVerify(members, inputs.messages[i], sig_bytes[i])
        assert not PyBLS.FastAggregateVerify(members, inputs.messages[i], sig_bytes[1 - i])
        np.testing.assert_array_equal(out.tensors.msg_g2[i].numpy(),
                                      g2_affine_encode(o.hash_to_g2(inputs.messages[i])))
    assert out.verdicts.tolist() == [True, True] and out.negative.tolist() == [False, False]
