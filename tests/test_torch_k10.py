"""K10's passes on the CPU: the plain version of ``kzg/ntt.ntt`` against the
JAX package's numpy oracle and its jitted ``_device_kernel`` at the first
pass's tile boundaries, and the pass plan against ``csrc/fr_ntt.cu``'s
constants (split off ``tests/test_torch_k1011.py`` to run on a test worker
of its own)."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.kzg import fr as jfr  # noqa: E402
from pos_evolution_tpu.kzg import ntt as jntt  # noqa: E402
from pos_evolution_tpu_torch.kzg import fr, ntt  # noqa: E402

R = fr.MODULUS
CSRC = Path(__file__).resolve().parents[1] / "pos_evolution_tpu_torch" / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """A plain field op is hundreds of small tensor ops: one intra-op thread
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ntt_passes_cover_every_stage():
    """The first pass runs at most csrc/fr_ntt.cu's kTileLog stages, each
    later one up to kLaterLog, together every stage once, at n = 2 to 2^30."""
    cu = (CSRC / "fr_ntt.cu").read_text()
    assert ntt.K10_FIRST_LOG == int(re.search(r"kTileLog = (\d+)", cu).group(1))
    assert int(re.search(r"kLaterLog = (\d+)", cu).group(1)) == ntt.K10_LATER_LOG
    for logn in range(1, 31):
        plan = ntt.passes(1 << logn)
        assert plan[0][0] == 0 and plan[-1][1] == logn
        assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
        assert plan[0][1] == min(logn, ntt.K10_FIRST_LOG)
        assert all(0 < e - s <= ntt.K10_LATER_LOG for s, e in plan[1:])
    assert len(ntt.passes(16384)) == 2


@pytest.mark.parametrize("tiles", [0.5, 1, 2, 4])
def test_ntt_plain_at_the_tile_boundaries(tiles):
    """``_ntt_plain`` (K10's plain version) at half, one, two and four of the
    first pass's tiles (T = 2^K10_FIRST_LOG positions), both ways, equals the
    JAX package's numpy oracle and its jitted ``_device_kernel``."""
    n = int(tiles * (1 << ntt.K10_FIRST_LOG))
    rng = np.random.default_rng(n)
    x = jfr.encode([int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)])
    x = x.reshape(1, n, fr.L)
    for inverse in (False, True):
        got = ntt.ntt(torch.from_numpy(x.astype(np.int32)), inverse).numpy()
        np.testing.assert_array_equal(got, jntt.ntt_host(x, inverse))
        np.testing.assert_array_equal(got, jntt.ntt_device(x, inverse))
