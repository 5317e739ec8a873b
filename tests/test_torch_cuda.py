"""The port's CUDA kernels on the card: each against its plain PyTorch
version, bit for bit. Marked ``cuda``; each test skips without a CUDA
device. On a GPU machine: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu_torch.device import words_to_torch  # noqa: E402
from pos_evolution_tpu_torch.epoch import build_epoch_inputs, run_epoch  # noqa: E402
from pos_evolution_tpu_torch.ops import fp, g2prep, kernels, pairing, tower  # noqa: E402, F401
from pos_evolution_tpu_torch.ops.aggregation import (  # noqa: E402
    _committee_aggregates,
    committee_aggregates,
)
from pos_evolution_tpu_torch.ops.merkle_device import _merkle_level, merkle_level  # noqa: E402
from pos_evolution_tpu_torch.resilience import state_digest  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_driver import DenseSimulation  # noqa: E402
from pos_evolution_tpu_torch.state_roots import run_state_roots  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _k1_inputs(a, c, n, seed):
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    committees = rng.integers(0, n, (a, c)).astype(np.int32)
    bits = rng.random((a, c)) < 0.9
    bits[0, : c // 2] = False
    if a > 2:
        bits[2] = False
    msgs = rng.integers(0, 2**32, (a, 8), dtype=np.uint64).astype(np.uint32)
    return (words_to_torch(pk, "cpu"), torch.from_numpy(committees), torch.from_numpy(bits),
            words_to_torch(msgs, "cpu"))


@pytest.mark.parametrize("a,c,n", [(1, 1, 8), (7, 33, 300), (3, 200, 1000), (64, 512, 40000)])
def test_k1_matches_plain(cuda, a, c, n):
    cpu_args = _k1_inputs(a, c, n, seed=a * c)
    args = [t.to(cuda) for t in cpu_args]
    before = kernels.launches["agg_sig"]
    got = committee_aggregates(*args)
    torch.cuda.synchronize()
    assert kernels.launches["agg_sig"] == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32 and got.shape == (a, 24)
    assert torch.equal(got, _committee_aggregates(*args))
    assert torch.equal(got.cpu(), _committee_aggregates(*cpu_args))


def test_k1_rejects_what_it_does_not_take(cuda):
    pk, comm, bits, msgs = (t.to(cuda) for t in _k1_inputs(4, 64, 500, seed=1))
    with pytest.raises(ValueError, match="pk_states"):
        committee_aggregates(pk.long(), comm, bits, msgs)
    with pytest.raises(ValueError, match="outside"):
        committee_aggregates(pk, comm.masked_fill(comm == comm[0, 0], 500), bits, msgs)
    with pytest.raises(ValueError, match="contiguous"):
        committee_aggregates(pk, comm.t().contiguous().t(), bits, msgs)


@pytest.mark.parametrize("a,c", [(0, 16), (4, 0)])
def test_k1_empty_launches_nothing(cuda, a, c):
    """No committee or no signer: zero aggregates, and no launch counted."""
    pk, comm, bits, msgs = (t.to(cuda) for t in _k1_inputs(max(a, 1), max(c, 1), 64, seed=2))
    comm, bits, msgs = comm[:a, :c].contiguous(), bits[:a, :c].contiguous(), msgs[:a]
    before = kernels.launches["agg_sig"]
    got = committee_aggregates(pk, comm, bits, msgs)
    assert kernels.launches["agg_sig"] == before
    assert got.shape == (a, 24) and not bool(got.any())


def test_small_epoch_card_equals_cpu(cuda):
    inp = build_epoch_inputs(4096, seed=3, slots=4, committees_per_slot=4, capacity=16,
                             shuffle_rounds=10)
    a, b = run_epoch(inp, "cpu"), run_epoch(inp, cuda)
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y.cpu())
    for x, y in zip(a.result.registry, b.result.registry):
        assert torch.equal(x, y.cpu())
    for x, y in zip(a.result[1:], b.result[1:]):
        assert torch.equal(x, y.cpu())


def _k2_inputs(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (2 * n, 8), dtype=np.uint64).astype(np.uint32)
    return words_to_torch(words, "cpu")


@pytest.mark.parametrize("n", [1, 3, 255, 256, 257, 511, 513, 100_000])
def test_k2_matches_plain(cuda, n):
    layer = _k2_inputs(n, seed=n)
    left, right = layer[:n].to(cuda), layer[n:].to(cuda)
    before = kernels.launches["merkle_level"]
    got = merkle_level(left, right)
    torch.cuda.synchronize()
    assert kernels.launches["merkle_level"] == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32 and got.shape == (n, 8)
    assert torch.equal(got, _merkle_level(left, right))
    assert torch.equal(got.cpu(), _merkle_level(layer[:n], layer[n:]))


def test_k2_strided_level(cuda):
    """The even and odd rows of one level, as views (row stride 16 words)."""
    layer = _k2_inputs(513, seed=7).to(cuda)
    got = merkle_level(layer[0::2], layer[1::2])
    assert torch.equal(got, _merkle_level(layer[0::2], layer[1::2]))


def test_k2_empty_launches_nothing(cuda):
    layer = _k2_inputs(4, seed=8).to(cuda)
    before = kernels.launches["merkle_level"]
    got = merkle_level(layer[:0], layer[:0])
    assert kernels.launches["merkle_level"] == before
    assert got.shape == (0, 8)


def test_k2_rejects_what_it_does_not_take(cuda):
    layer = _k2_inputs(8, seed=9).to(cuda)
    with pytest.raises(ValueError, match="left"):
        merkle_level(layer[:8].long(), layer[8:])
    with pytest.raises(ValueError, match="right"):
        merkle_level(layer[:8], layer[8:12])
    flat = layer.reshape(-1)
    with pytest.raises(ValueError, match="aligned"):
        merkle_level(flat[1:65].view(8, 8), layer[8:])        # rows off 16-byte alignment
    with pytest.raises(ValueError, match="aligned"):
        merkle_level(layer[:8].t(), layer[8:])                # words not contiguous


def test_small_state_roots_card_equals_cpu(cuda):
    inp = build_epoch_inputs(4096, seed=3, slots=4, committees_per_slot=4, capacity=16,
                             shuffle_rounds=10)
    a, b = run_state_roots(inp, "cpu"), run_state_roots(inp, cuda)
    assert (a.pre, a.post, a.dirty) == (b.pre, b.post, b.dirty)


def test_small_dense_run_card_equals_cpu(cuda):
    """One epoch of the dense driver at n = 256 on the card (K1 every slot,
    K2 in the digest) equals the same run on the CPU."""
    from pos_evolution_tpu_torch.config import mainnet_config
    cfg = mainnet_config().replace(slots_per_epoch=8, max_committees_per_slot=4)
    runs = []
    for dev in ("cpu", cuda):
        kernels.reset_launches()
        sim = DenseSimulation(256, cfg, device=dev, seed=11, shuffle_rounds=6,
                              check_walk_every=4)
        sim.run_epochs(1)
        runs.append((sim.metrics, sim.summary(), state_digest(sim), dict(kernels.launches)))
    (m_cpu, s_cpu, d_cpu, l_cpu), (m_dev, s_dev, d_dev, l_dev) = runs
    assert (m_dev, s_dev, d_dev) == (m_cpu, s_cpu, d_cpu)
    assert not any(l_cpu.values())
    assert l_dev["agg_sig"] == 2 * 8 and l_dev["merkle_level"] > 0


# --- K3-K5: the field kernels ---------------------------------------------------

_EDGES = [0, 1, fp.P_INT - 1, fp.P_INT, 2 * fp.P_INT - 1]


def _field(shape, seed, top=2 * fp.P_INT, edges=True):
    """int32 digits [*shape, 32] of seeded values in [0, top), the edge
    values 0, 1, p-1, p, 2p-1 in the first rows."""
    rng = np.random.default_rng(seed)
    flat = [int.from_bytes(rng.bytes(49), "big") % top for _ in range(int(np.prod(shape)))]
    if edges:
        flat[:len(_EDGES)] = _EDGES[:len(flat)]
    return torch.from_numpy(np.stack([fp.to_limbs(v) for v in flat]).reshape(*shape, fp.L))


@pytest.mark.parametrize("sa,sb", [((5, 7), (5, 7)), ((300,), (300,)), ((4, 1, 3), (1, 6, 3)),
                                   ((9, 2), (2,)), ((1,), (1,))])
@pytest.mark.parametrize("top", [2 * fp.P_INT, 2**384])
def test_k3_matches_plain(cuda, sa, sb, top):
    """K3 on broadcast shapes, lazy residues and any canonical digits."""
    a, b = _field(sa, 1, top).to(cuda), _field(sb, 2, top).to(cuda)
    before = kernels.launches["fp_modmul"]
    got = fp.modmul(a, b)
    torch.cuda.synchronize()
    assert kernels.launches["fp_modmul"] == before + 1
    assert got.dtype == torch.int32 and got.shape == torch.broadcast_shapes(a.shape, b.shape)
    assert torch.equal(got, fp._modmul(a, b))
    assert torch.equal(got.cpu(), fp._modmul(a.cpu(), b.cpu()))


@pytest.mark.parametrize("op", ["modadd", "modsub", "modneg", "canon"])
@pytest.mark.parametrize("top", [2 * fp.P_INT, 2**384])
def test_k4_matches_plain(cuda, op, top):
    a, b = _field((67, 3), 3, top).to(cuda), _field((3,), 4, top).to(cuda)
    args = (a, b) if op in ("modadd", "modsub") else (a,)
    before = kernels.launches["fp_addsub"]
    got = getattr(fp, op)(*args)
    torch.cuda.synchronize()
    assert kernels.launches["fp_addsub"] == before + 1
    assert torch.equal(got, getattr(fp, "_" + op)(*args))
    assert torch.equal(got.cpu(), getattr(fp, "_" + op)(*(t.cpu() for t in args)))


@pytest.mark.parametrize("d,slots", [(2, None), (6, None), (12, None),
                                     (12, (0, 1, 2, 3, 8, 9))])
@pytest.mark.parametrize("n", [1, 33, 257, 4096])
def test_k5_matches_plain(cuda, d, slots, n):
    dy = d if slots is None else len(slots)
    x, y = _field((n, d), 5 * d + n).to(cuda), _field((n, dy), 6 * d + n).to(cuda)
    before = kernels.launches["alg_mul"]
    got = tower.alg_mul(x, y, slots)
    torch.cuda.synchronize()
    assert kernels.launches["alg_mul"] == before + 1
    assert torch.equal(got, tower._alg_mul(x, y, slots))
    assert torch.equal(got.cpu(), tower._alg_mul(x.cpu(), y.cpu(), slots))


def test_k5_broadcast_operand(cuda):
    """A constant right operand broadcast over the batch (the Frobenius
    gammas, the eighth roots), and strided component views, read in place."""
    x, g = _field((40, 6, 2), 7).to(cuda), _field((6, 2), 8).to(cuda)
    got = tower.alg_mul(x, g.expand(x.shape))
    assert torch.equal(got, tower._alg_mul(x, g.expand(x.shape)))
    z = _field((40, 12), 9).to(cuda)
    got = tower.alg_mul(z[:, 2:4], z[:, 8:10])
    assert torch.equal(got, tower._alg_mul(z[:, 2:4], z[:, 8:10]))
    p = _field((33, 3, 2), 10).to(cuda)
    assert torch.equal(tower.alg_mul(p[:, 2], p[:, 1]), tower._alg_mul(p[:, 2], p[:, 1]))


def test_field_kernels_empty_and_plain_mode(cuda):
    a = _field((4,), 9).to(cuda)
    before = dict(kernels.launches)
    assert fp.modmul(a[:0], a[:0]).shape == (0, fp.L)
    with fp.plain_mode():
        assert torch.equal(fp.modmul(a, a), fp._modmul(a, a))
        assert torch.equal(fp.modsub(a, a.flip(0)), fp._modsub(a, a.flip(0)))
        x = a[:2].reshape(1, 2, fp.L)
        assert torch.equal(tower.alg_mul(x, x), tower._alg_mul(x, x))
    assert kernels.launches == before


def test_small_verify_card_equals_cpu_and_plain(cuda):
    """fast_aggregate_verify_batch at B = 2 on the card (K3-K5) equals the
    plain=True run on the card and the CPU run, stage by stage."""
    from pos_evolution_tpu_torch.bls_verify import build_inputs, oracle_tensors
    from pos_evolution_tpu_torch.ops.pairing import fast_aggregate_verify_batch
    inputs = build_inputs(2, 4, distinct_keys=2, seed=5)
    runs = {}
    for name, dev, plain in (("kernel", cuda, False), ("plain", cuda, True), ("cpu", "cpu", False)):
        stages = {}
        ok = fast_aggregate_verify_batch(*oracle_tensors(inputs, dev), plain=plain,
                                         stages=stages)
        runs[name] = (ok.cpu(), {k: v.cpu() for k, v in stages.items()})
    for name in ("plain", "cpu"):
        assert torch.equal(runs[name][0], runs["kernel"][0])
        for k, v in runs["kernel"][1].items():
            assert torch.equal(runs[name][1][k], v), (name, k)
    assert runs["kernel"][0].tolist() == [True, True]


# --- K4 tapes -----------------------------------------------------------------

TAPE_NAMES = sorted(fp.TAPES)


def _tape_inputs(tape, n, seed, broadcast=False):
    """Seeded inputs of ``tape`` over n lanes; with ``broadcast`` the last
    input is one constant expanded over the lanes (element stride 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(tape.in_shapes):
        last = broadcast and i == len(tape.in_shapes) - 1
        shape = ((1,) if last else (n,)) + s
        d = rng.integers(0, 1 << fp.BITS, shape + (fp.L,), dtype=np.int32)
        d[..., -1] = rng.integers(0, int(fp.TWO_P[-1]), shape, dtype=np.int32)   # below 2p
        flat = d.reshape(-1, fp.L)
        for r, v in enumerate(_EDGES[:len(flat)]):
            flat[(r * 7 + i) % len(flat)] = fp.to_limbs(v)
        t = torch.from_numpy(d)
        out.append(t.expand((n,) + s + (fp.L,)) if last else t)
    return out


@pytest.mark.parametrize("name", TAPE_NAMES)
@pytest.mark.parametrize("n,broadcast", [(1, False), (33, False), (4096, False), (33, True)])
def test_tape_matches_plain(cuda, name, n, broadcast):
    """Every registered tape on the card, one launch, equal to its plain
    version; every output written as the components of one tensor."""
    tape = fp.TAPES[name]
    args = [t.to(cuda) for t in _tape_inputs(tape, n, len(name) + n, broadcast)]
    before = kernels.launches["fp_addsub"]
    got = fp.run_tape(tape, *args)
    torch.cuda.synchronize()
    assert kernels.launches["fp_addsub"] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    with fp.plain_mode():
        want = fp.run_tape(tape, *args)
    want = want if isinstance(want, tuple) else (want,)
    for g, w, shape in zip(got, want, tape.out_shapes, strict=True):
        assert g.shape == (n,) + shape + (fp.L,) and g.is_contiguous()
        assert torch.equal(g, w)


def test_tape_strided_inputs(cuda):
    """Component views read in place: a tape over x[..., 2:4, :] of an Fq12
    and over a two-dim batch."""
    x = _field((50, 12), 3).to(cuda)
    got = tower.fq2_mul_xi(x[:, 2:4])
    assert torch.equal(got, fp._run_tape(fp.TAPES["fq2_mul_xi"], x[:, 2:4]))
    y = _field((7, 5, 2), 4).to(cuda)
    assert torch.equal(tower.fq2_muli(y, 9), fp._run_tape(tower._muli_tape(9), y))


def test_fused_callers_launch_counts(cuda):
    """A cyclotomic squaring is at most 12 field-kernel launches (two tapes
    and one K5); fq2_muli is one launch for any k >= 2 and none for 0, 1."""
    x = _field((64, 12), 5).to(cuda)
    before = dict(kernels.launches)
    got = tower.fq12_cyclotomic_sq(x)
    torch.cuda.synchronize()
    used = {k: kernels.launches[k] - before[k] for k in before}
    assert sum(used.values()) <= 12 and used == {**used, "fp_addsub": 2, "alg_mul": 1}
    with fp.plain_mode():
        assert torch.equal(got, tower.fq12_cyclotomic_sq(x))
    y = x[:, :2]
    for k in range(10):
        before = kernels.launches["fp_addsub"]
        out = tower.fq2_muli(y, k)
        assert kernels.launches["fp_addsub"] == before + (k >= 2)
        with fp.plain_mode():
            assert torch.equal(out, tower.fq2_muli(y, k))


def test_field_launch_failure_raises(cuda):
    """A launch CUDA refuses raises, and is not counted."""
    before = dict(kernels.launches)
    io = (ctypes.c_longlong * 2)(0, 0)
    with pytest.raises(RuntimeError, match="fp_addsub launch failed"):
        kernels.launch_on(cuda, "fp_addsub", io, 1, bytes(2), 0, 1, 0, 1)     # no steps
    tower.alg_mul(*(_field((2, 2), 6).to(cuda),) * 2)                       # plans uploaded
    before = dict(kernels.launches)
    with pytest.raises(RuntimeError, match="alg_mul launch failed"):
        kernels.launch_on(cuda, "alg_mul", 0, 0, 0, 0, 0, 1, 7)               # no plan 7
    assert kernels.launches == before
