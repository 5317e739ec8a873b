"""K4's tapes (``pos_evolution_tpu_torch/ops/fp.py``) on the CPU, digit for
digit (lazy residues included, tolerance 0): every registered tape's plain
version against the JAX package's ``fp.modadd``, ``modsub``, ``modneg`` and
``canon`` composed in the tape's order, the fused tower callers and a Miller
doubling step against their JAX twins, and malformed tapes rejected (the
Jacobian ops are in ``test_torch_fused.py``). Inputs are numpy from a seed with the
edge values 0, 1, p-1, p and 2p-1."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu.ops import fp as jfp  # noqa: E402
from pos_evolution_tpu.ops import pairing as jp  # noqa: E402
from pos_evolution_tpu.ops import tower as jt  # noqa: E402
from pos_evolution_tpu_torch.ops import fp, g2prep, kernels, pairing, tower  # noqa: E402, F401  (g2prep builds its tapes)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain field ops are thousands of tiny tensor ops: one intra-op
    thread keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


Q = fp.P_INT
EDGES = [0, 1, Q - 1, Q, 2 * Q - 1]
LANES = 6
TAPE_NAMES = sorted(fp.TAPES)      # the path's tapes, built when their modules import


def _field(shape, seed: int) -> np.ndarray:
    """int32 digits [*shape, 32] of seeded values in [0, 2p); lane l < 5
    takes the edge values, rotated over its components."""
    rng = np.random.default_rng(seed)
    vals = np.array([int.from_bytes(rng.bytes(49), "big") % (2 * Q)
                     for _ in range(int(np.prod(shape)))], dtype=object).reshape(shape)
    flat = vals.reshape(shape[0], -1)
    for lane in range(min(shape[0], len(EDGES))):
        for c in range(flat.shape[1]):
            flat[lane, c] = EDGES[(lane + c + seed) % len(EDGES)]
    return np.stack([fp.to_limbs(int(v)) for v in flat.reshape(-1)]).reshape(*shape, fp.L)


_JAX_OPS = {fp.ADD: jfp.modadd_jit, fp.SUB: jfp.modsub_jit, fp.NEG: jax.jit(jfp.modneg),
            fp.CANON: jax.jit(jfp.canon)}


def _jax_tape(tape, inputs):
    """The tape's steps through the JAX package's field ops."""
    rows = []
    for i, c in tape.rows:
        x = jnp.asarray(inputs[i])
        rows.append(x.reshape(x.shape[:x.ndim - 1 - len(tape.in_shapes[i])] + (-1, fp.L))[..., c, :])
    slots, outs = {}, {}
    for op, dst, a, b in tape.steps:
        if op == fp.LOAD:
            slots[dst] = rows[a]
        elif op == fp.STORE:
            outs[dst] = slots[a]
        elif op in (fp.ADD, fp.SUB):
            slots[dst] = _JAX_OPS[op](slots[a], slots[b])
        else:
            slots[dst] = _JAX_OPS[op](slots[a])
    return [np.asarray(outs[r]) for r in range(len(outs))]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", TAPE_NAMES)
def test_tape_plain_equals_jax_ops(name):
    """A registered tape's plain version == the JAX package's field ops in
    the tape's order, and each output row is what its step list stored."""
    tape = fp.TAPES[name]
    seed = zlib.crc32(name.encode()) % 1000
    inputs = [_field((LANES,) + s, seed + i) for i, s in enumerate(tape.in_shapes)]
    before = dict(kernels.launches)
    got = fp.run_tape(tape, *map(_t, inputs))
    assert kernels.launches == before                # the CPU takes the plain version
    got = got if isinstance(got, tuple) else (got,)
    want = _jax_tape(tape, inputs)
    k = 0
    for g, shape in zip(got, tape.out_shapes):
        assert g.shape == (LANES,) + shape + (fp.L,)
        flat = g.reshape(LANES, -1, fp.L)
        for c in range(flat.shape[1]):
            _eq(flat[:, c], want[k])
            k += 1
    assert k == len(want)


def test_tape_broadcast_inputs():
    """A constant input broadcast over the batch (stride 0 on the card) and
    a batch of two dims."""
    a = _field((4, 3), 1)
    b = _field((1,), 2)[0]
    _eq(fp.run_tape(fp.TAPES["modsub"], _t(a), _t(b)),
        jfp.modsub_jit(jnp.asarray(a), jnp.asarray(b)))
    x = _field((3, 2), 3)
    got = fp.run_tape(fp.TAPES["fq2_mul_xi"], _t(x[None]).expand(5, 3, 2, fp.L))
    _eq(got, np.broadcast_to(jax.jit(jt.fq2_mul_xi)(jnp.asarray(x)), (5, 3, 2, fp.L)))


def test_make_tape_schedules_and_registers():
    t = fp.make_tape("test_chain", ((2,),), ((), (2,)),
                     lambda x: (x[0] + x[1], [x[1] - x[0], -(x[0] + x[0])]))
    assert fp.TAPES["test_chain"] is t
    assert t.rows == ((0, 0), (0, 1)) and sum(t.out_rows) == 3
    x = _field((LANES, 2), 4)
    s, rest = fp.run_tape(t, _t(x))
    _eq(s, jfp.modadd_jit(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1])))
    _eq(rest[:, 0], jfp.modsub_jit(jnp.asarray(x[:, 1]), jnp.asarray(x[:, 0])))
    _eq(rest[:, 1], jax.jit(jfp.modneg)(jfp.modadd_jit(jnp.asarray(x[:, 0]),
                                                        jnp.asarray(x[:, 0]))))
    with pytest.raises(ValueError, match="other steps"):
        fp.make_tape("test_chain", ((2,),), ((),), lambda x: x[0] - x[1])
    del fp.TAPES["test_chain"]


def test_malformed_tapes_rejected():
    L, S = fp.LOAD, fp.STORE
    with pytest.raises(ValueError, match="steps"):
        fp.Tape("bad", ((),), ((),), ((0, 0),), ((L, 0, 0, 0),) * 128 + ((S, 0, 0, 0),))
    with pytest.raises(ValueError, match="slots"):
        fp.Tape("bad", ((),), ((),), ((0, 0),), ((L, 8, 0, 0), (S, 0, 8, 0)))
    with pytest.raises(ValueError, match="input rows"):
        fp.Tape("bad", ((33,),), ((),), tuple((0, c) for c in range(33)),
                ((L, 0, 0, 0), (S, 0, 0, 0)))
    with pytest.raises(ValueError, match="output rows"):
        fp.Tape("bad", ((),), ((25,),), ((0, 0),),
                ((L, 0, 0, 0),) + tuple((S, r, 0, 0) for r in range(25)))
    with pytest.raises(ValueError, match="never stored"):
        fp.Tape("bad", ((),), ((2,),), ((0, 0),), ((L, 0, 0, 0), (S, 0, 0, 0)))
    with pytest.raises(ValueError, match="sources written"):
        fp.Tape("bad", ((),), ((),), ((0, 0),), ((fp.ADD, 1, 0, 0), (S, 0, 1, 0)))
    with pytest.raises(ValueError, match="live slots"):          # 9 values live at once
        fp.make_tape("bad_live", ((9,),), ((),), lambda x: _chain([a + a for a in x]))
    with pytest.raises(ValueError, match="steps"):
        fp.make_tape("bad_long", ((),), ((),), lambda x: _chain([x] * 130))
    assert "bad_live" not in fp.TAPES and "bad_long" not in fp.TAPES
    with pytest.raises(ValueError, match="takes 2 inputs"):
        fp.run_tape(fp.TAPES["modadd"], _t(_field((2,), 5)))


def _chain(vals):
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v
    return acc


# --- the fused callers against their JAX twins ---------------------------------------

@pytest.mark.parametrize("k", range(10))
def test_fq2_muli_equals_jax(k):
    x = _field((LANES, 2), 10 + k)
    _eq(tower.fq2_muli(_t(x), k), jax.jit(lambda a: jt.fq2_muli(a, k))(jnp.asarray(x)))


@pytest.mark.parametrize("fn", ["fq2_mul_xi", "fq2_conj", "fq12_conj", "fq6_mul_v",
                                "fq12_cyclotomic_sq"])
def test_tower_callers_equal_jax(fn):
    d = {"fq2_mul_xi": 2, "fq2_conj": 2, "fq12_conj": 12, "fq6_mul_v": 6,
         "fq12_cyclotomic_sq": 12}[fn]
    x = _field((LANES, d), 20 + d)
    _eq(getattr(tower, fn)(_t(x)), jax.jit(getattr(jt, fn))(jnp.asarray(x)))


def _jax_miller_double(X, Y, Z, xp, yp):
    """The doubling half of the JAX Miller loop's body
    (pos_evolution_tpu/ops/pairing.py::miller_loop), as written there."""
    fq2_sq, fq2_mul, fq2_muli, f = jt.fq2_sq, jt.fq2_mul, jt.fq2_muli, jfp
    A = fq2_sq(X)
    B = fq2_sq(Y)
    C = fq2_sq(B)
    ZZ = fq2_sq(Z)
    D = fq2_muli(f.modsub(f.modsub(fq2_sq(f.modadd(X, B)), A), C), 2)
    E = fq2_muli(A, 3)
    X3 = f.modsub(fq2_sq(E), fq2_muli(D, 2))
    Y3 = f.modsub(fq2_mul(E, f.modsub(D, X3)), fq2_muli(C, 8))
    YZ = fq2_mul(Y, Z)
    Z3 = fq2_muli(YZ, 2)
    c0 = f.modsub(fq2_muli(B, 2), fq2_muli(fq2_mul(X, A), 3))
    cx = fq2_muli(fq2_mul(A, ZZ), 3)
    cy = f.modneg(fq2_muli(fq2_mul(YZ, ZZ), 2))
    line = jp._line_embed(c0, jp._fq2_scale_fq(cx, xp), jp._fq2_scale_fq(cy, yp))
    return jnp.stack([X3, Y3, Z3], axis=-3), line


def test_miller_double_step_equals_jax():
    S = _field((LANES, 3, 2), 40)
    p_aff = _field((LANES, 2), 41)
    pq = _t(p_aff)[:, :, None, :].expand(LANES, 2, 2, fp.L).contiguous()
    got_s, got_line = pairing._double(_t(S), tower.alg_mul, pairing._MILLER_DOUBLE, pq)
    want_s, want_line = jax.jit(_jax_miller_double)(
        *(jnp.asarray(S[:, i]) for i in range(3)), jnp.asarray(p_aff[:, 0]),
        jnp.asarray(p_aff[:, 1]))
    _eq(got_s, want_s)
    _eq(got_line, want_line)
