"""The port's CUDA kernels on the card: each against its plain PyTorch
version, bit for bit. Marked ``cuda``; each test skips without a CUDA
device. On a GPU machine: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import ctypes
import hashlib

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


# --- K3: products read in place, lanes per element, and the ladder -----------------

_K3_EDGES = [0, 1, fp.P_INT - 1, fp.P_INT, fp.P_INT + 1, 2 * fp.P_INT - 2, 2 * fp.P_INT - 1,
             2**384 - 1]


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("n", [1, 7, 33, 2048])
def test_k3_groups_match_plain(cuda, group, n):
    """Both work splits (1 or 4 lanes an element) equal the plain
    version, on every pair of the edge values (products up to (2^384 - 1)^2)
    and on seeded residues."""
    e = torch.from_numpy(np.stack([fp.to_limbs(v) for v in _K3_EDGES])).to(cuda)
    a = torch.cat([e.repeat_interleave(len(_K3_EDGES), 0), _field((n,), 11 + n).to(cuda)])
    b = torch.cat([e.repeat(len(_K3_EDGES), 1), _field((n,), 12 + n, 2**384).to(cuda)])
    out, args, _keep = fp._modmul_launch(a, b, group)
    before = kernels.launches["fp_modmul"]
    kernels.launch_on(cuda, "fp_modmul", *args)
    torch.cuda.synchronize()
    assert kernels.launches["fp_modmul"] == before + 1 and args[-1] == group
    assert torch.equal(out, fp._modmul(a, b))


def test_k3_views_read_in_place(cuda):
    """The G1 tree's unbind views, _fq2_scale_fq's broadcast scalar and an
    Fq2 component view: read without copies, equal to the plain version."""
    jac = _field((64, 8, 3), 13).to(cuda)
    X1, Y1, Z1 = jac[:, :4].unbind(-2)
    X2, Y2, Z2 = jac[:, 4:].unbind(-2)
    c2, s = _field((300, 2), 14).to(cuda), _field((300,), 15).to(cuda)
    for x, y in ((Z1, Z1), (X1, Z2), (Y1, Y2), (c2, s[..., None, :]), (c2[:, 0], c2[:, 1]),
                 (c2, s[:1, None, :])):
        out, args, keep = fp._modmul_launch(x, y)
        assert keep[0].data_ptr() == x.data_ptr() and keep[1].data_ptr() == y.data_ptr()
        got = fp.modmul(x, y)
        assert torch.equal(got, fp._modmul(x, y))
        assert torch.equal(got.cpu(), fp._modmul(x.cpu(), y.cpu()))


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("which", ["modinv", "sqrt"])
def test_k3_ladder_matches_plain(cuda, group, which):
    """The whole ladder in one launch equals the plain version at 2048
    elements (the edge values among them) and at 33 as a component view."""
    bits = fp._P_MINUS_2_BITS if which == "modinv" else g2prep._SQRT_FQ_BITS
    x = _field((2048,), 16).to(cuda)
    x[:len(_K3_EDGES) - 1] = torch.from_numpy(
        np.stack([fp.to_limbs(v) for v in _K3_EDGES[:-1]])).to(cuda)
    view = _field((33, 2), 17).to(cuda)[:, 1]
    for t in (x, view):
        out, args, _keep = fp._pow_launch(t, bits, group)
        before = kernels.launches["fp_pow"]
        kernels.launch_on(cuda, "fp_pow", *args)
        torch.cuda.synchronize()
        assert kernels.launches["fp_pow"] == before + 1
        assert torch.equal(out, fp._pow_static(t, bits))


def test_k3_ladder_short_schedules(cuda):
    x = _field((100,), 18).to(cuda)
    for bits in ([1], [0, 1], [1, 0, 1, 1, 0], [0, 0, 1, 0]):
        bits = np.array(bits, dtype=bool)
        assert torch.equal(fp.pow_static(x, bits), fp._pow_static(x, bits))


def test_k3_launch_counts_of_the_inversions(cuda):
    """fq2_inv and g1_to_affine: one ladder and four products each."""
    for fn, arg in ((tower.fq2_inv, _field((2048, 2), 19)), (pairing.g1_to_affine,
                                                            _field((2048, 3), 20))):
        arg = arg.to(cuda)
        before = dict(kernels.launches)
        got = fn(arg)
        torch.cuda.synchronize()
        assert kernels.launches["fp_pow"] == before["fp_pow"] + 1
        assert kernels.launches["fp_modmul"] == before["fp_modmul"] + 4
        with fp.plain_mode():
            want = fn(arg)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)


def test_k3_launch_failure_raises(cuda):
    """A launch K3 refuses raises, and is not counted; a CUDA tensor in
    plain_mode takes the plain ladder and launches nothing."""
    x = _field((4,), 21).to(cuda)
    out, args, _keep = fp._modmul_launch(x, x)
    before = dict(kernels.launches)
    with pytest.raises(RuntimeError, match="fp_modmul launch failed"):
        kernels.launch_on(cuda, "fp_modmul", *args[:-1], 3)                  # no 3-lane split
    words, _ = fp._pack_bits(fp._P_MINUS_2_BITS)
    with pytest.raises(RuntimeError, match="fp_pow launch failed"):
        kernels.launch_on(cuda, "fp_pow", x.data_ptr(), 0, fp.L, out.data_ptr(), 4, 4, words,
                          0, 1)                                              # no bits
    assert kernels.launches == before
    with fp.plain_mode():
        assert torch.equal(fp.modinv(x), fp._pow_static(x, fp._P_MINUS_2_BITS))
    assert kernels.launches == before


# --- K6 (multi-block SHA-256) and K7 (GF(2^8) product): the DAS and sync slice ------

def _k6_messages(n, length, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, length)).astype(np.uint8)


@pytest.mark.parametrize("n,length", [(1, 52), (3, 2048), (1152, 2048), (36864, 52),
                                      (36864, 2048), (5, 55), (5, 56)])
def test_k6_matches_plain_and_hashlib(cuda, n, length):
    """1 and 33 blocks a message (52 and 2,048 bytes), at the DAS path's
    batch sizes; 55 and 56 bytes straddle the padding's block."""
    from pos_evolution_tpu_torch.ops.sha256 import pad_words, sha256_blocks, sha256_rows
    from pos_evolution_tpu_torch.ssz.hash import _pad_messages
    msgs = _k6_messages(n, length, n + length)
    words = torch.from_numpy(_pad_messages(msgs).view(np.int32)).to(cuda)
    before = kernels.launches["sha256_blocks"]
    got = sha256_blocks(words)
    torch.cuda.synchronize()
    assert kernels.launches["sha256_blocks"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (n, 8)
    assert torch.equal(got, sha256_blocks(words, plain=True))
    assert torch.equal(pad_words(torch.from_numpy(msgs).to(cuda)), words)
    rows = sha256_rows(msgs, cuda).cpu().numpy()
    for i in {0, n // 2, n - 1}:
        assert rows[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest()


def test_pk_states_through_k6(cuda):
    """The signers' midstate table is one K6 launch, equal to the CPU's."""
    from pos_evolution_tpu_torch.ops.aggregation import precompute_pk_states
    pubkeys = np.random.default_rng(4).integers(0, 256, (1000, 48)).astype(np.uint8)
    before = kernels.launches["sha256_blocks"]
    got = precompute_pk_states(pubkeys, cuda)
    torch.cuda.synchronize()
    assert kernels.launches["sha256_blocks"] == before + 1
    assert torch.equal(got.cpu(), precompute_pk_states(pubkeys, "cpu"))


def test_k6_empty_and_refused(cuda):
    """N = 0 launches nothing; a strided row or a wrong width raises; a
    launch CUDA refuses raises and is not counted."""
    from pos_evolution_tpu_torch.ops.sha256 import sha256_blocks
    words = torch.zeros((4, 32), dtype=torch.int32, device=cuda)
    before = dict(kernels.launches)
    assert sha256_blocks(words[:0]).shape == (0, 8)
    with pytest.raises(ValueError, match="int32"):
        sha256_blocks(words[:, :24])
    with pytest.raises(ValueError, match="16-byte"):
        sha256_blocks(words.reshape(2, 64)[:, 1:17])
    out = torch.empty((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="sha256_blocks launch failed"):
        kernels.launch_on(cuda, "sha256_blocks", words.data_ptr(), 32, 2, out.data_ptr(), 0)
    assert kernels.launches == before


@pytest.mark.parametrize("g,r,k,w", [(1, 8, 8, 64), (9, 16, 8, 64), (1, 64, 64, 2048),
                                     (9, 64, 64, 2048), (9, 128, 64, 2048), (3, 40, 64, 66)])
def test_k7_matches_plain(cuda, g, r, k, w):
    """The extension (r = k) and the regrid (r = 2k) shapes of the DAS path,
    with zero rows and columns; a width that is not a multiple of 4."""
    from pos_evolution_tpu_torch.ops.das_verify import _gf_matmul, gf_matmul
    rng = np.random.default_rng(g * r + k + w)
    a = torch.from_numpy(rng.integers(0, 256, (g, r, k)).astype(np.uint8))
    b = torch.from_numpy(rng.integers(0, 256, (g, k, w)).astype(np.uint8))
    a[0, r // 2] = 0
    b[-1, :, w // 3] = 0
    b[0, k // 2] = 0
    want = _gf_matmul(a, b)
    before = kernels.launches["gf256_matmul"]
    got = gf_matmul(a.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    assert kernels.launches["gf256_matmul"] == before + 1
    assert got.dtype == torch.uint8 and torch.equal(got.cpu(), want)
    shared = gf_matmul(a[:1].to(cuda), b.to(cuda))          # one matrix for every group
    assert torch.equal(shared.cpu(), _gf_matmul(a[:1], b))
    assert torch.equal(gf_matmul(a.to(cuda), b.to(cuda), plain=True).cpu(), want)


def test_k7_offset_operand(cuda):
    """B as a contiguous view at an odd byte offset: the wrapper copies it
    to an aligned buffer (the kernel loads B in 4-byte words) and launches
    once, with the plain version's bytes."""
    from pos_evolution_tpu_torch.ops.das_verify import _gf_matmul, gf_matmul
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(0, 256, (2, 16, 8)).astype(np.uint8))
    flat = torch.from_numpy(rng.integers(0, 256, 1 + 2 * 8 * 64).astype(np.uint8))
    b = flat.to(cuda)[1:].view(2, 8, 64)
    assert b.is_contiguous() and b.data_ptr() % 4
    before = kernels.launches["gf256_matmul"]
    got = gf_matmul(a.to(cuda), b)
    torch.cuda.synchronize()
    assert kernels.launches["gf256_matmul"] == before + 1
    assert torch.equal(got.cpu(), _gf_matmul(a, flat[1:].view(2, 8, 64)))


def test_k7_empty_and_refused(cuda):
    from pos_evolution_tpu_torch.ops.das_verify import gf_matmul
    a = torch.ones((2, 4, 8), dtype=torch.uint8, device=cuda)
    b = torch.ones((2, 8, 16), dtype=torch.uint8, device=cuda)
    before = dict(kernels.launches)
    assert not gf_matmul(a[:, :0], b).any() and gf_matmul(a[:, :0], b).shape == (2, 0, 16)
    assert gf_matmul(a[:, :, :0], b[:, :0]).shape == (2, 4, 16)
    with pytest.raises(ValueError, match="k <= 256"):
        gf_matmul(torch.ones((1, 2, 300), dtype=torch.uint8, device=cuda),
                  torch.ones((1, 300, 4), dtype=torch.uint8, device=cuda))
    out = torch.empty((2, 4, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="gf256_matmul launch failed"):
        kernels.launch_on(cuda, "gf256_matmul", a.data_ptr(), 32,
                          b.data_ptr(), 128, out.data_ptr(), 2, 0, 8, 16)   # no rows: grid 0
    assert kernels.launches == before


# --- K6's two designs and K7 on the tensor cores: edge shapes ----------------------

@pytest.mark.parametrize("blocks", [1, 2, 33, 65])
def test_k6_across_the_crossover(cuda, blocks):
    """The wrapper at n = crossover - 1 (the warp-specialized chains from
    ``k6_chains_min_blocks`` blocks, else one thread a message), crossover
    and crossover + 1 (one thread a message): one launch each, equal to the
    plain version, spot rows to hashlib."""
    from pos_evolution_tpu_torch.ops.sha256 import k6_chains_below, sha256_blocks
    from pos_evolution_tpu_torch.ssz.hash import _pad_messages
    cross = k6_chains_below()
    length = 64 * blocks - 9
    msgs = _k6_messages(cross + 1, length, blocks)
    words = torch.from_numpy(_pad_messages(msgs).view(np.int32)).to(cuda)
    assert words.shape[1] == 16 * blocks
    for n in (cross - 1, cross, cross + 1):
        before = kernels.launches["sha256_blocks"]
        got = sha256_blocks(words[:n])
        torch.cuda.synchronize()
        assert kernels.launches["sha256_blocks"] == before + 1
        assert torch.equal(got, sha256_blocks(words[:n], plain=True))
        rows = got.cpu().numpy().astype(">u4").view(np.uint8).reshape(n, 32)
        for i in (0, n // 2, n - 1):
            assert rows[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest()


@pytest.mark.parametrize("n,blocks", [(1, 1), (31, 2), (33, 33), (1152, 33), (4000, 3),
                                      (40000, 2)])
def test_k6_designs_agree_on_strided_rows(cuda, n, blocks):
    """Each design (the chains; one thread a message in blocks of 32 and
    of 128), named through the measuring entry point, on rows read in place
    from a wider array (a row stride of 16 * blocks + 4 words), equal to the
    plain version; the wrapper on the same view too."""
    from pos_evolution_tpu_torch.ops.sha256 import sha256_blocks
    rng = np.random.default_rng(n + blocks)
    wide = torch.from_numpy(rng.integers(-2**31, 2**31, (n, 16 * blocks + 4),
                                         dtype=np.int64).astype(np.int32)).to(cuda)
    words = wide[:, 4:]
    assert words.stride(0) == 16 * blocks + 4 and words.data_ptr() % 16 == 0
    want = sha256_blocks(words.contiguous(), plain=True)
    for threads in (0, 32, 128):
        out = torch.full((n, 8), -1, dtype=torch.int32, device=cuda)
        kernels.launch_on(cuda, "sha256_blocks_design", words.data_ptr(), words.stride(0),
                          blocks, out.data_ptr(), n, threads)
        torch.cuda.synchronize()
        assert torch.equal(out, want), f"design threads={threads}"
    assert torch.equal(sha256_blocks(words), want)


def test_k6_design_hook_refuses_a_bad_block_size(cuda):
    """The measuring entry point takes 0 or a multiple of 32 up to 128
    threads; any other block size is refused, raises and is not counted."""
    words = torch.zeros((64, 16), dtype=torch.int32, device=cuda)
    out = torch.empty((64, 8), dtype=torch.int32, device=cuda)
    for threads in (48, 256, -32):
        before = dict(kernels.launches)
        with pytest.raises(RuntimeError, match="sha256_blocks_design launch failed"):
            kernels.launch_on(cuda, "sha256_blocks_design", words.data_ptr(), 16, 1,
                              out.data_ptr(), 64, threads)
        assert kernels.launches == before


def _k7_case(rng, kind, g, r, k, w):
    if kind == "zeros":
        return np.zeros((g, r, k), np.uint8), np.zeros((g, k, w), np.uint8)
    if kind == "ones":
        return np.full((g, r, k), 0xFF, np.uint8), np.full((g, k, w), 0xFF, np.uint8)
    b = rng.integers(0, 256, (g, k, w)).astype(np.uint8)
    if kind == "identity":
        return np.broadcast_to(np.eye(r, k, dtype=np.uint8), (1, r, k)).copy(), b
    a = rng.integers(0, 256, (1 if kind == "broadcast" else g, r, k)).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("k", [1, 3, 31, 64, 255, 256])
def test_k7_edge_shapes(cuda, k):
    """Every r in {1, 7, 16, 129} and W in {4, 66, 2,048} at this k, with
    random, broadcast, all-zero, all-0xFF and identity operands: one launch
    each, equal to the plain version."""
    from pos_evolution_tpu_torch.ops.das_verify import _gf_matmul, gf_matmul
    rng = np.random.default_rng(k)
    for r in (1, 7, 16, 129):
        for w in (4, 66, 2048):
            for kind in ("random", "broadcast", "zeros", "ones", "identity"):
                a, b = (torch.from_numpy(x).to(cuda) for x in _k7_case(rng, kind, 2, r, k, w))
                before = kernels.launches["gf256_matmul"]
                got = gf_matmul(a, b)
                torch.cuda.synchronize()
                assert kernels.launches["gf256_matmul"] == before + 1
                want = _gf_matmul(a, b)
                assert torch.equal(got, want), f"k={k} r={r} w={w} {kind}"
                if kind == "identity":
                    assert torch.equal(got[:, :min(r, k)], b[:, :min(r, k)])
                if kind == "zeros":
                    assert not got.any()


def test_das_and_sync_paths_on_card_equal_cpu(cuda):
    """The engine's grids and commitments, the store's verdicts, a sample
    batch and a sync batch: the card equals the CPU and the host oracles."""
    from pos_evolution_tpu_torch.config import mainnet_config
    from pos_evolution_tpu_torch.das.containers import BlobSidecar
    from pos_evolution_tpu_torch.das.engine import BlobEngine, BlobStore
    from pos_evolution_tpu_torch.ops import das_verify, sync_verify
    cfg = mainnet_config().replace(das_cells_per_blob=64, das_cell_bytes=2048,
                                   das_max_blobs_per_block=3)
    root = bytes(range(32))
    outs = {}
    for dev in ("cpu", cuda):
        engine = BlobEngine(cfg, seed=2, device=dev)
        grids, coms = engine.build_batch(5, root)
        bad = grids.clone()
        bad[1, 70, 9] ^= 4
        scs = [BlobSidecar(slot=5, proposer_index=0, block_root=root, blob_index=i,
                           n_blobs=3, cells=bad[i], commitment=c)
               for i, c in enumerate(coms)]
        outs[str(dev)] = (grids.cpu(), coms, BlobStore(engine).on_sidecars(scs))
    cpu, card = outs["cpu"], outs[str(cuda)]
    assert torch.equal(cpu[0], card[0]) and cpu[1:] == card[1:]
    assert card[2] == [True, False, True]
    engine = BlobEngine(cfg, seed=2, device=cuda)
    grid = card[0][0].numpy()
    idx = np.arange(0, 128, 5)
    _, branches = engine.scheme.branches(grid, idx)
    batch = das_verify.DasSampleBatch(
        cells=grid[idx].copy(), branches=branches, indices=idx.astype(np.int64),
        commitments=np.frombuffer(card[1][0] * len(idx), np.uint8).reshape(-1, 32).copy())
    batch.cells[3, 0] ^= 1
    got = das_verify.verify_samples_device(batch, cuda)
    want = das_verify.verify_samples_host(batch)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert (~got["ok"]).nonzero()[0].tolist() == [3]
    rng = np.random.default_rng(8)
    b, s = 6, 512
    pubkeys = rng.integers(0, 256, (b, s, 48)).astype(np.uint8)
    sbatch = sync_verify.SyncUpdateBatch(
        pubkeys=pubkeys, bits=rng.random((b, s)) < 0.8,
        weights=rng.integers(0, 2**35, (b, s)).astype(np.int64),
        messages=rng.integers(0, 256, (b, 32)).astype(np.uint8),
        signatures=rng.integers(0, 256, (b, 96)).astype(np.uint8),
        fin_leaf=rng.integers(0, 256, (b, 32)).astype(np.uint8),
        fin_branch=rng.integers(0, 256, (b, 6, 32)).astype(np.uint8),
        fin_index=rng.integers(0, 64, b), fin_root=rng.integers(0, 256, (b, 32)).astype(np.uint8),
        fin_present=np.ones(b, bool), sc_leaf=rng.integers(0, 256, (b, 32)).astype(np.uint8),
        sc_branch=rng.integers(0, 256, (b, 5, 32)).astype(np.uint8),
        sc_index=rng.integers(0, 32, b), sc_root=rng.integers(0, 256, (b, 32)).astype(np.uint8),
        sc_present=np.ones(b, bool))
    sbatch.fin_root[:3] = sync_verify.merkle_roots_host(sbatch.fin_leaf, sbatch.fin_branch,
                                                        sbatch.fin_index)[:3]
    for i in range(2):                                   # two honest aggregates
        acc = 0
        for j in np.nonzero(sbatch.bits[i])[0]:
            h1 = hashlib.sha256(b"fakebls-sig-pad!" + pubkeys[i, j].tobytes()
                                + sbatch.messages[i].tobytes()).digest()
            h2 = hashlib.sha256(h1).digest()
            acc ^= int.from_bytes(h1 + h2 + hashlib.sha256(h2).digest(), "big")
        sbatch.signatures[i] = np.frombuffer(acc.to_bytes(96, "big"), np.uint8)
    got = sync_verify.verify_batch_device(sbatch, cuda)
    want = sync_verify.verify_batch_host(sbatch)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert want["fin_ok"].tolist() == [True] * 3 + [False] * 3
    assert want["sig_ok"].tolist() == [True] * 2 + [False] * 4


# --- K10 (the Fr NTT and Fr's elementwise ops) and K11 (the G1 MSM): the KZG slice ----

def _fr_digits(shape, seed, lazy=True):
    """Montgomery digits [*shape, 22] of random residues in [0, 2r) (or
    [0, r)), and the edge values 0, 1, r - 1, r, r + 1, 2r - 1 in front."""
    from pos_evolution_tpu_torch.kzg import fr
    rng = np.random.default_rng(seed)
    count = int(np.prod(shape))
    top = 2 * fr.MODULUS if lazy else fr.MODULUS
    edges = [0, 1, fr.MODULUS - 1, fr.MODULUS, fr.MODULUS + 1, 2 * fr.MODULUS - 1]
    vals = [v for v in edges if v < top][:count]
    vals += [int.from_bytes(rng.bytes(40), "little") % top for _ in range(count - len(vals))]
    return torch.from_numpy(np.stack([fr.to_limbs(v) for v in vals]).astype(np.int32)
                            .reshape(tuple(shape) + (fr.L,)))


@pytest.mark.parametrize("g,n", [(9, 16384), (3, 1), (3, 2), (2, 128), (2, 1024), (2, 2048),
                                 (1, 4096), (1, 2**19)])
def test_k10_ntt_matches_plain(cuda, g, n):
    """K10's transform at the commit path's shape (9 blobs of the PeerDAS
    domain), at the smallest sizes, at the first pass's tile and its
    multiples and with three passes, both ways, equal to the plain version
    on the same card (and, at n = 128, to the numpy oracle); a launch a pass
    (the gather and the n^-1 scale fused), one elementwise launch at n = 1."""
    from pos_evolution_tpu_torch.kzg import ntt
    x = _fr_digits((g, n), 31 + n).to(cuda)
    for inverse in (False, True):
        before = kernels.launches["fr_ntt"] + kernels.launches["fr_ew"]
        got = ntt.ntt(x, inverse)
        torch.cuda.synchronize()
        launched = kernels.launches["fr_ntt"] + kernels.launches["fr_ew"] - before
        assert launched == (len(ntt.passes(n)) if n > 1 else int(inverse))
        with fp.plain_mode():
            want = ntt.ntt(x, inverse)
        assert torch.equal(got, want), f"inverse={inverse}"
        if n == 128:
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          ntt.ntt_host(x.cpu().numpy(), inverse))


def test_k10_elementwise_matches_plain(cuda):
    """Every elementwise op of K10 on lazy residues and the edge values, with
    a broadcast operand read at stride 0, equal to the plain versions."""
    from pos_evolution_tpu_torch.kzg import fr
    a, b = _fr_digits((4, 100), 3).to(cuda), _fr_digits((4, 100), 4).to(cuda)
    c = _fr_digits((1, 100), 5).to(cuda)
    cases = {"mul": (fr.mul, a, b), "add": (fr.add, a, b), "sub": (fr.sub, a, b),
             "bcast": (fr.mul, a, c), "neg": (fr.neg, a), "canon": (fr.canon, a),
             "from_mont": (fr.from_mont, a), "to_mont": (fr.to_mont, fr.from_mont(a)),
             "inv": (fr.inv, a[:, :16])}
    for name, (fn, *args) in cases.items():
        got = fn(*args)
        with fp.plain_mode():
            want = fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name


def _msm_case(n, g, seed, edges):
    """(points [n, 2, 32], inf [n], scalars [g, n, 22], the oracle points and
    ints): random multiples of G; with ``edges``, a zero scalar, r - 1, an
    infinity lane, a lane repeated 32 apart (the fold's P = Q) and s, r - s
    on one point (P = -Q)."""
    from pos_evolution_tpu_torch.crypto import bls12_381 as oracle
    from pos_evolution_tpu_torch.kzg import fr
    rng = np.random.default_rng(seed)
    base = [oracle.ec_mul(oracle.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(8)]
    pts = [base[j % 8] for j in range(n)]
    scs = [[int.from_bytes(rng.bytes(32), "little") % fr.MODULUS for _ in range(n)]
           for _ in range(g)]
    if edges and n >= 64:
        pts[33] = pts[1]
        pts[32] = pts[0]
        pts[5] = None
        for s in scs:
            s[0] = s[32]
            s[1], s[33] = 12345, fr.MODULUS - 12345
            s[2], s[3] = 0, fr.MODULUS - 1
    enc, inf = pairing.g1_encode_points(pts)
    return enc, inf, torch.stack([fr.ints_to_digits(s) for s in scs]), pts, scs


@pytest.mark.parametrize("g,n", [(2, 1), (3, 4), (2, 64), (2, 200), (9, 16384)])
def test_k11_matches_plain(cuda, g, n):
    """K11's ladders and every fold round equal the plain version digit for
    digit (lanes, partials, the affine sum), at the edge lanes and at the
    commit path's 9 x 16,384; one ladder launch and a fold launch a further
    round of 64."""
    enc, inf, scs, _pts, _ints = _msm_case(n, g, 40 + n, edges=True)
    enc, inf, scs = enc.to(cuda), inf.to(cuda), scs.to(cuda)
    lanes = pairing.g1_msm_lanes(enc, inf, scs)
    with fp.plain_mode():
        want_lanes = pairing.g1_msm_lanes(enc, inf, scs)
    torch.cuda.synchronize()
    assert torch.equal(lanes, want_lanes)
    with fp.plain_mode():
        want_sum = pairing.g1_fold(want_lanes)
    assert torch.equal(pairing.g1_fold(lanes), want_sum)
    before = kernels.launches["g1_msm"] + kernels.launches["g1_fold"]
    aff, is_inf = pairing.g1_msm(enc, inf, scs)
    rounds = 1
    while -(-n // 64 ** rounds) > 1:
        rounds += 1
    assert kernels.launches["g1_msm"] + kernels.launches["g1_fold"] - before == rounds
    with fp.plain_mode():
        paff, pinf = pairing.g1_to_affine(want_sum)
        paff = fp.canon(paff)
    torch.cuda.synchronize()
    assert torch.equal(aff, paff) and torch.equal(is_inf, pinf)


def test_k11_matches_the_oracle(cuda):
    """K11's MSM at 1,024 lanes (and its edge lanes at 64) equal to the host
    Pippenger of kzg/curve.py."""
    from pos_evolution_tpu_torch.kzg import curve
    for n, edges in ((1024, False), (64, True)):
        enc, inf, scs, pts, ints = _msm_case(n, 2, 7 + n, edges)
        aff, is_inf = pairing.g1_msm(enc.to(cuda), inf.to(cuda), scs.to(cuda))
        assert pairing.g1_decode_points(aff, is_inf) == [curve.g1_lincomb(pts, s) for s in ints]


def test_k11_setup_matches_plain_and_host(cuda):
    """The setup on the card at the PeerDAS domain (16,384 powers) equals
    its plain version, and its first 256 powers the host oracle's."""
    from pos_evolution_tpu_torch.kzg import setup as kzg_setup
    kzg_setup._DEVICE.clear()
    got = kzg_setup.device_setup(16384, 0, cuda)
    kzg_setup._DEVICE.clear()
    want = kzg_setup.device_setup(16384, 0, cuda, plain=True)
    kzg_setup._DEVICE.clear()
    assert torch.equal(got.points, want.points) and torch.equal(got.inf, want.inf)
    host = kzg_setup.trusted_setup(256, 0)
    assert pairing.g1_decode_points(got.points[:256], got.inf[:256]) == list(host.powers_g1)
    assert got.g2_tau == host.g2_tau


def _bucket_tables(cuda, n, c, seed, edges):
    """(window tables of the _msm_case points on the card, the case)."""
    enc, inf, scs, pts, ints = _msm_case(n, 2, seed, edges)
    return pairing.g1_window_tables(enc.to(cuda), inf.to(cuda), c), scs.to(cuda), pts, ints


@pytest.mark.parametrize("g,n,c", [(2, 1, 4), (3, 4, 4), (2, 64, 5), (2, 200, 13), (2, 200, 16)])
def test_k11_bucket_matches_plain(cuda, g, n, c):
    """K11's bucket route (recode, scan, scatter, fill, totals, reduce) equals
    its plain version stage by stage, digit for digit, at the edge lanes
    (zero scalar, r - 1, an infinity point, a power twice in one bucket, s and
    r - s on one point) and the host Pippenger; six launches an MSM."""
    from pos_evolution_tpu_torch.kzg import curve
    tables, scs, pts, ints = _bucket_tables(cuda, n, c, 60 + n, edges=True)
    scs = scs[:g] if scs.shape[0] >= g else scs.repeat(g, 1, 1)[:g]
    ints = (ints * g)[:g]
    got, want = {}, {}
    before = dict(kernels.launches)
    aff, inf = pairing.g1_msm_fixed(tables, scs, stages=got)
    torch.cuda.synchronize()
    assert all(kernels.launches[k] - before[k] == (1 if k.startswith("g1_bucket_") else 0)
               for k in kernels.launches if k.startswith("g1_") and k != "g1_bucket_tables")
    paff, pinf = pairing.g1_msm_fixed(tables, scs, plain=True, stages=want)
    for name in ("digits", "offsets", "start", "entries", "totals", "total"):
        assert torch.equal(got[name], want[name]), name
    assert torch.equal(aff, paff) and torch.equal(inf, pinf)
    assert pairing.g1_decode_points(aff, inf) == [curve.g1_lincomb(pts, s) for s in ints]


@pytest.mark.parametrize("c", [4, 8, 13, 16])
def test_k11_bucket_takes_lazy_scalars(cuda, c):
    """Scalars in [r, 2^256) (lazy residues; c W > 256 where c divides 256
    too): the recode and every stage equal the plain version, the sum the
    host's over the residues mod r."""
    from pos_evolution_tpu_torch.kzg import curve, fr
    tables, scs, pts, ints = _bucket_tables(cuda, 64, c, 90 + c, edges=True)
    lazy = [[v + fr.MODULUS for v in ints[0]], [(1 << 256) - 1 - v for v in ints[1]]]
    raw = torch.from_numpy(np.stack([[fr.to_limbs(v) for v in s] for s in lazy])
                           .astype(np.int32)).to(cuda)
    got, want = {}, {}
    aff, inf = pairing.g1_msm_fixed(tables, raw, stages=got)
    paff, pinf = pairing.g1_msm_fixed(tables, raw, plain=True, stages=want)
    torch.cuda.synchronize()
    for name in ("digits", "offsets", "start", "entries", "totals", "total"):
        assert torch.equal(got[name], want[name]), name
    assert torch.equal(aff, paff) and torch.equal(inf, pinf)
    assert pairing.g1_decode_points(aff, inf) == [
        curve.g1_lincomb(pts, [v % fr.MODULUS for v in s]) for s in lazy]


def test_k11_bucket_adds_that_double(cuda):
    """The kernel's totals and tree meet P = Q (128 equal entries in one
    bucket, split by the fill's chunks; two sibling buckets of one point)
    and equal the plain version and the host Pippenger."""
    from pos_evolution_tpu_torch.crypto import bls12_381 as oracle
    from pos_evolution_tpu_torch.kzg import curve, fr
    p = oracle.ec_mul(oracle.G1_GEN, 12345)
    pts = [p] * 128
    blobs = [[1] * 128, [1, 2] + [0] * 126]
    enc, inf = pairing.g1_encode_points(pts)
    tables = pairing.g1_window_tables(enc.to(cuda), inf.to(cuda), 4)
    scs = torch.stack([fr.ints_to_digits(s) for s in blobs]).to(cuda)
    got, want = {}, {}
    aff, is_inf = pairing.g1_msm_fixed(tables, scs, stages=got)
    pairing.g1_msm_fixed(tables, scs, plain=True, stages=want)
    torch.cuda.synchronize()
    for name in ("entries", "totals", "total"):
        assert torch.equal(got[name], want[name]), name
    assert pairing.g1_decode_points(aff, is_inf) == [curve.g1_lincomb(pts, s) for s in blobs]


def test_k11_bucket_at_the_commit_shape(cuda):
    """The bucket route at 9 x 16,384 over the setup's tables (c = 13): every
    stage equal to the plain version, blob 0 to the host Pippenger."""
    from pos_evolution_tpu_torch.kzg import curve, fr
    from pos_evolution_tpu_torch.kzg import setup as kzg_setup
    setup = kzg_setup.device_setup(16384, 0, cuda)
    tables = setup.window_tables()
    assert tables.c == pairing.MSM_WINDOW == 13
    rng = np.random.default_rng(77)
    ints = [[int.from_bytes(rng.bytes(32), "little") % fr.MODULUS for _ in range(16384)]
            for _ in range(9)]
    scs = torch.stack([fr.ints_to_digits(s) for s in ints]).to(cuda)
    got, want = {}, {}
    aff, inf = pairing.g1_msm_fixed(tables, scs, stages=got)
    paff, pinf = pairing.g1_msm_fixed(tables, scs, plain=True, stages=want)
    torch.cuda.synchronize()
    for name in ("digits", "offsets", "start", "entries", "totals", "total"):
        assert torch.equal(got[name], want[name]), name
    assert torch.equal(aff, paff) and torch.equal(inf, pinf)
    assert pairing.g1_decode_points(aff[:1], inf[:1]) == [
        curve.g1_lincomb(setup.powers_g1(), ints[0])]


def test_k11_window_tables_match_plain_and_oracle(cuda):
    """The tables' doubling launch and affine pass equal the plain version at
    300 powers, and spot entries the oracle's 2^(c w) P."""
    from pos_evolution_tpu_torch.crypto import bls12_381 as oracle
    enc, inf, _scs, pts, _ints = _msm_case(300, 1, 5, edges=True)
    got = pairing.g1_window_tables(enc.to(cuda), inf.to(cuda), 13)
    with fp.plain_mode():
        want = pairing.g1_window_tables(enc.to(cuda), inf.to(cuda), 13)
    torch.cuda.synchronize()
    assert torch.equal(got.points, want.points) and torch.equal(got.inf, want.inf)
    for w, j in ((0, 0), (1, 7), (10, 5), (19, 299), (19, 33)):
        p = pts[j]
        want_p = None if p is None else oracle.ec_mul(p, 1 << (13 * w))
        assert pairing.g1_decode_points(got.points[w, j], got.inf[w, j]) == [want_p]


def test_k10_k11_refused_launches_raise(cuda):
    """Launches K10 and K11 refuse raise and are not counted."""
    x = torch.zeros((2, 8, 22), dtype=torch.int32, device=cuda)
    y = torch.empty_like(x)
    out = torch.empty((1, 1, 3, 32), dtype=torch.int32, device=cuda)
    before = dict(kernels.launches)
    with pytest.raises(RuntimeError, match="fr_ntt launch failed"):
        kernels.launch_on(cuda, "fr_ntt", x.data_ptr(), y.data_ptr(), x.data_ptr(),
                          x.data_ptr(), 2, 8, 0, 4, 1)                   # stages 0-3 of 3
    with pytest.raises(RuntimeError, match="fr_ew launch failed"):
        kernels.launch_on(cuda, "fr_ew", 9, x.data_ptr(), 22, x.data_ptr(), 22,
                          y.data_ptr(), 16)                              # no op 9
    with pytest.raises(RuntimeError, match="g1_msm launch failed"):
        kernels.launch_on(cuda, "g1_msm", out.data_ptr(), 64, 0, out.data_ptr(), 1, 0,
                          x.data_ptr(), 22, 0, out.data_ptr(), 1, 0, 1)  # no lanes
    with pytest.raises(RuntimeError, match="g1_fold launch failed"):
        kernels.launch_on(cuda, "g1_fold", out.data_ptr(), out.data_ptr(), 0, 1)
    with pytest.raises(RuntimeError, match="fr_ntt launch failed"):
        kernels.launch_on(cuda, "fr_ntt", x.data_ptr(), y.data_ptr(), x.data_ptr(),
                          x.data_ptr(), 2, 8, 0, 3, 8)                   # no flag 8
    for name, args in (("g1_bucket_tables", (out.data_ptr(), out.data_ptr(), 1, 1, 17)),
                       ("g1_bucket_recode", (x.data_ptr(), y.data_ptr(), y.data_ptr(), 1, 0, 13)),
                       ("g1_bucket_scan", (y.data_ptr(), y.data_ptr(), 1, 20, 3)),
                       ("g1_bucket_scatter", (x.data_ptr(), y.data_ptr(), y.data_ptr(), 1, 8, 4,
                                              13)),
                       ("g1_bucket_fill", (out.data_ptr(), out.data_ptr(), x.data_ptr(),
                                           y.data_ptr(), out.data_ptr(), out.data_ptr(), 1, 8,
                                           6)),
                       ("g1_bucket_totals", (out.data_ptr(), out.data_ptr(), y.data_ptr(),
                                             out.data_ptr(), out.data_ptr(), 1, 8, 4095)),
                       ("g1_bucket_reduce", (out.data_ptr(), out.data_ptr(), out.data_ptr(), 0,
                                             4096))):
        with pytest.raises(RuntimeError, match=f"{name} launch failed"):
            kernels.launch_on(cuda, name, *args)
    assert kernels.launches == before


def test_k11_bucket_refuses_cpu_tables_and_bad_scalars(cuda):
    """The bucket route takes the tables' device and the tables' size: a CUDA
    batch against CPU tables, or more lanes than powers, raises."""
    enc, inf, scs, _pts, _ints = _msm_case(8, 2, 3, edges=False)
    tables = pairing.g1_window_tables(enc, inf, 4)
    with pytest.raises(ValueError, match="tables on cpu"):
        pairing.g1_msm_fixed(tables, scs.to(cuda))
    with pytest.raises(ValueError, match="scalars must be"):
        pairing.g1_msm_fixed(tables, torch.cat([scs, scs], dim=1))


@pytest.mark.parametrize("m,n", [(22, 22), (32, 32), (33, 33), (32, 33)])
def test_plain_digit_plumbing_card_equals_cpu(cuda, m, n):
    """The plain versions' digit convolution (an outer product added into
    its columns by ``index_add_``) and carry normalization (the shifted
    lookahead rounds) give the same digits on the card as on the CPU, with
    broadcast batch dims and the all-FFF ripple."""
    rng = np.random.default_rng(m * n)
    a = torch.from_numpy(rng.integers(0, 4096, (3, 1, m)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 4096, (1, 4, n)).astype(np.int32))
    b[0, 0] = fp.MASK
    want = fp.conv_digits(a, b)
    got = fp.conv_digits(a.to(cuda), b.to(cuda))
    assert torch.equal(got.cpu(), want)
    ripple = torch.full((1, m + n - 1), fp.MASK, dtype=torch.int32)
    ripple[0, 0] += 1
    x = torch.cat([want.reshape(-1, m + n - 1), ripple])
    for out_len in (m + n - 1, m + n):
        assert torch.equal(fp.carry_norm(x.to(cuda), out_len).cpu(), fp.carry_norm(x, out_len))


def test_spec_chain_one_epoch_equals_cpu(cuda):
    """The spec tier (``spec_chain``) over one epoch boundary at n = 4096,
    mainnet config, on the card and on the CPU: equal state roots after
    every block, every card state root through K2, the replay equal."""
    from pos_evolution_tpu_torch import spec_chain
    before = kernels.launches["merkle_level"]
    card = spec_chain.run_chain(4096, 33, device=cuda)
    k2 = kernels.launches["merkle_level"] - before
    host = spec_chain.run_chain(4096, 33, device="cpu")
    assert card.roots == host.roots
    assert card.summary["final_root"] == host.summary["final_root"]
    assert card.summary["state_roots"] > 0 and k2 >= card.summary["state_roots"]
    assert card.summary["epoch_sweeps"] == host.summary["epoch_sweeps"] == 2
    assert spec_chain.replay(card, device=cuda)["final_root"] == card.summary["final_root"]


def test_spec_driver_one_epoch_equals_cpu(cuda):
    """The spec driver (``sim/driver.Simulation``) at 1,024 validators,
    mainnet config, with the resident fork choice, for one epoch on the
    card and on the CPU: equal per-slot records, no resident store
    degraded, every card head query on the card's resident store, and K2
    under the card's state roots."""
    from pos_evolution_tpu_torch.config import mainnet_config, use_config
    from pos_evolution_tpu_torch.sim.driver import Simulation
    runs = {}
    with use_config(mainnet_config()):
        for dev in (cuda, "cpu"):
            before = kernels.launches["merkle_level"]
            sim = Simulation(1024, accelerated_forkchoice=True, device=dev)
            for g in sim.groups:
                g.resident.selfcheck_every = 1
            sim.run_epochs(1)
            runs[str(dev)] = (sim, kernels.launches["merkle_level"] - before)
    (card, k2), (host, k2_host) = runs[str(cuda)], runs["cpu"]
    assert card.metrics == host.metrics and len(card.metrics) == 33
    for sim in (card, host):
        res = sim.groups[0].resident
        assert not res.degraded and res.incidents == []
    res = card.groups[0].resident
    assert res.buckets.device.type == "cuda" and res.stats["device_heads"] > 0
    assert k2 > 0 and k2_host == 0


def test_spec_driver_riders_one_epoch_equals_cpu(cuda):
    """The spec driver's riders at 1,024 validators, mainnet config, for
    one epoch on the card and on the CPU: ``das=True`` with 1,000 sampling
    clients and one light client, then ``flush_light_clients``. Equal
    per-slot records, blob keys, served summaries (their times aside),
    server counters and light-client summaries and records; every served
    block verifies; K1, K2, K6 and K7 launch on the card and not on the
    CPU."""
    from pos_evolution_tpu_torch.config import mainnet_config, use_config
    from pos_evolution_tpu_torch.sim.driver import Simulation
    names = ("agg_sig", "merkle_level", "sha256_blocks", "gf256_matmul")
    runs = {}
    with use_config(mainnet_config()):
        for dev in (cuda, "cpu"):
            before = {k: kernels.launches[k] for k in names}
            sim = Simulation(1024, accelerated_forkchoice=True, device=dev, das=True)
            sim.attach_das_clients(1000, seed=5)
            node = sim.attach_light_client()
            served = []
            inner = sim.das_server.serve_samples

            def serve(*args, inner=inner, served=served):
                out = inner(*args)
                served.append({k: v for k, v in out.items()
                               if k not in ("p50_ms", "p95_ms", "verify_ms")})
                return out

            sim.das_server.serve_samples = serve
            sim.run_epochs(1)
            sim.flush_light_clients()
            summary = node.summary()
            summary.pop("timing")
            srv = sim.das_server
            runs[str(dev)] = (
                sim.metrics, [sorted(g.blob_store.sidecars) for g in sim.groups], served,
                (srv.served_blocks, srv.samples_served, srv.scheme_builds,
                 srv.proof_cache.hits, srv.update_cache.misses),
                summary, node.records,
                {k: kernels.launches[k] - before[k] for k in names})
    card, host = runs[str(cuda)], runs["cpu"]
    assert card[:6] == host[:6]
    assert card[2] and all(s["failed"] == 0 and s["clients_all_ok"] == 1000 for s in card[2])
    assert card[4]["applied"] > 0 and card[4]["rejected"] == 0
    assert all(card[6][k] > 0 for k in names), card[6]
    assert not any(host[6].values()), host[6]


def test_b9_card_equals_cpu(cuda):
    """The incremental vote buckets (Queue 2 B9) on the card against the
    CPU at a 65,536-row table and a 4,096-vote batch with duplicates."""
    from pos_evolution_tpu_torch.ops import forkchoice as ofc
    rng = np.random.default_rng(5)
    n, nb, k = 65_536, 256, 4096
    mb = rng.integers(-1, nb, n).astype(np.int32)
    me = np.where(mb >= 0, rng.integers(0, 6, n), 0).astype(np.int64)
    w = rng.integers(1, 64, n).astype(np.int64) * 10**9
    val = rng.integers(0, 1500, k).astype(np.int32)
    block = rng.integers(-1, nb, k).astype(np.int32)
    epoch = rng.integers(0, 8, k).astype(np.int64)
    active = rng.random(k) < 0.9
    args = [torch.from_numpy(a) for a in (mb, me)]
    host_b = ofc.rebuild_buckets(args[0], torch.from_numpy(w), nb)
    extra = [torch.from_numpy(a) for a in (val, block, epoch, w[val], active)]
    host = ofc.apply_latest_messages(*args, host_b, *extra)
    card = ofc.apply_latest_messages(*(a.to(cuda) for a in args), host_b.to(cuda),
                                     *(a.to(cuda) for a in extra))
    assert all(torch.equal(c.cpu(), h) for c, h in zip(card, host))
    hw = ofc.rebuild_epoch_buckets(args[0], args[1], torch.from_numpy(w), nb, 4, 2)
    cw = ofc.rebuild_epoch_buckets(args[0].to(cuda), args[1].to(cuda),
                                   torch.from_numpy(w).to(cuda), nb, 4, 2)
    assert torch.equal(cw.cpu(), hw)


def test_checkpoint_digest_through_k2(cuda, tmp_path):
    """A checkpoint's merkle digest on the card: one K2 launch a tree level,
    each counted on the writer thread that made it, the manifest's hex equal
    to K2's plain version on the card and to the CPU's; validation re-checks
    it through K2; the supervision of a run on the card picks it."""
    import json
    import math

    from pos_evolution_tpu_torch.backend.torch_backend import TorchBackend
    from pos_evolution_tpu_torch.ops.merkle_device import digest_bytes
    from pos_evolution_tpu_torch.resilience import CheckpointManager, RunSupervision
    payload = np.random.default_rng(7).integers(0, 256, 3_000_001, dtype=np.uint8).tobytes()
    levels = math.ceil(math.log2(-(-len(payload) // 32)))
    backend = TorchBackend(cuda)
    m = CheckpointManager(tmp_path / "store", digest="merkle", backend=backend, async_mode=True)
    before = kernels.launches["merkle_level"]
    m.save(1, lambda: payload)
    m.drain()
    assert kernels.launches["merkle_level"] - before == levels
    assert m.step_log[0]["digest_launches"] == {"merkle_level": levels}
    with open(tmp_path / "store" / "step_00000001" / "manifest.json") as f:
        hexd = json.load(f)["files"]["payload.bin"]["merkle"]
    assert hexd == digest_bytes(payload, cuda, plain=True).hex() == digest_bytes(payload, "cpu").hex()
    assert m.latest_valid() == (1, {"payload.bin": payload})
    assert m.verify_log[-1]["digest_launches"] == {"merkle_level": levels}
    m.close()
    sup = RunSupervision({"every_n_slots": 2, "dir": str(tmp_path / "s")}, kind="dense",
                         backend=backend)
    assert sup.manager.digest == "merkle"


def test_supervised_dense_run_resumes_on_the_card(cuda, tmp_path):
    """A dense run on the card with autocheckpoint: its newest step resumed on
    the card, and the CPU's run, end on its digest."""
    from pos_evolution_tpu_torch.config import mainnet_config
    cfg = mainnet_config().replace(slots_per_epoch=8, max_committees_per_slot=4)
    sim = DenseSimulation(4096, cfg, device=cuda, autocheckpoint=(4, str(tmp_path)))
    sim.run_epochs(1)
    stats = sim.finish_autocheckpoint()
    assert stats["saves"] == 3 and sim.supervision.manager.digest == "merkle"
    back = DenseSimulation.resume_latest(tmp_path, device=cuda)
    assert back.slot == 8 and state_digest(back) == state_digest(sim)
    cpu = DenseSimulation(4096, cfg, device="cpu")
    cpu.run_epochs(1)
    assert state_digest(cpu) == state_digest(sim)
