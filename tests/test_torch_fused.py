"""The fused Jacobian doubling and unified addition on G1
(``pos_evolution_tpu_torch/ops/pairing.py``) and on the twist
(``ops/g2prep.py``), whose add/sub chains run as K4 tapes, against the JAX
package's ``pairing.g1_double_jac``, ``g1_add_jac``, ``g2prep.g2_double_jac``
and ``g2_add_jac``, digit for digit, on the CPU (the plain versions). Every
case of the unified add is covered: generic, either operand at infinity,
P = Q and P = -Q."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu.ops import g2prep as jg  # noqa: E402
from pos_evolution_tpu.ops import pairing as jp  # noqa: E402
from pos_evolution_tpu_torch.ops import fp, g2prep, pairing  # noqa: E402



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


def _field(shape, seed: int) -> np.ndarray:
    """int32 digits [*shape, 32] of seeded values in [0, 2p); lane l < 5
    takes the edge values, rotated over its components."""
    rng = np.random.default_rng(seed)
    vals = np.array([int.from_bytes(rng.bytes(49), "big") % (2 * Q)
                     for _ in range(int(np.prod(shape)))], dtype=object).reshape(shape[0], -1)
    for lane in range(min(shape[0], len(EDGES))):
        for c in range(vals.shape[1]):
            vals[lane, c] = EDGES[(lane + c + seed) % len(EDGES)]
    return np.stack([fp.to_limbs(int(v)) for v in vals.reshape(-1)]).reshape(*shape, fp.L)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _points(comp, seed):
    """Jacobian points [LANES, 3, *comp, 32] of seeded coordinates; lane 1
    at infinity (Z = 0)."""
    p = _field((LANES, 3) + comp, seed)
    p[1, 2] = 0
    return p


def _add_operands(comp):
    """(P, Q) covering the unified add's cases: generic lanes, P at
    infinity (lane 1), Q at infinity (lane 2), Q = P (lane 3, the doubling)
    and Q = -P (lane 4, infinity)."""
    P, Q_ = _points(comp, 31), _points(comp, 32)
    Q_[1] = _points(comp, 33)[0]
    Q_[2, 2] = 0
    Q_[3] = P[3]
    neg = fp.canon(fp.modneg(_t(P[4, 1]))).numpy()
    Q_[4] = P[4]
    Q_[4, 1] = neg
    return P, Q_


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_jacobian_double_equals_jax(group):
    comp, mod, jmod = ((), pairing, jp) if group == "g1" else ((2,), g2prep, jg)
    P = _points(comp, 30)
    _eq(getattr(mod, f"{group}_double_jac")(_t(P)),
        jax.jit(getattr(jmod, f"{group}_double_jac"))(jnp.asarray(P)))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_jacobian_add_equals_jax(group):
    comp, mod, jmod = ((), pairing, jp) if group == "g1" else ((2,), g2prep, jg)
    P, Q_ = _add_operands(comp)
    got = getattr(mod, f"{group}_add_jac")(_t(P), _t(Q_))
    _eq(got, jax.jit(getattr(jmod, f"{group}_add_jac"))(jnp.asarray(P), jnp.asarray(Q_)))
    assert not got[4].any()                               # P + (-P) = infinity
    _eq(got[1], Q_[1])
