"""The verdicts of ``tests/test_kzg.py``'s aggregate cases (honest, forged
cell, swapped samples, tampered W and W', reversed points, wrong wire) by
the port's ``KzgCellScheme`` and the JAX package's on the CPU, each case
through its own verify (one MSM and one 2-lane pairing check, ~25 s a case
on the plain field arithmetic): split off ``tests/test_torch_kzg_scheme.py``,
whose committee it shares, to run on a test worker of its own."""

import pytest

pytest.importorskip("torch")

from pos_evolution_tpu.config import minimal_config as jax_minimal  # noqa: E402
from pos_evolution_tpu.config import use_config  # noqa: E402
from test_torch_kzg_scheme import _one_thread, committee  # noqa: E402,F401


def _cases(c):
    """tests/test_kzg.py's aggregate cases: (name, wires, samples, cells,
    proof)."""
    wires, samples, cells, proof = c["wires"], c["samples"], c["cells"], c["proof"]
    out = [("honest", wires, samples, cells, proof)]
    for j in range(len(cells)):
        forged = [x.copy() for x in cells]
        forged[j][0] ^= 0xA5
        out.append((f"forged cell {j}", wires, samples, forged, proof))
    out.append(("swapped samples", wires, [samples[1], samples[0]] + samples[2:], cells, proof))
    for key in ("w", "wp"):
        bad = dict(proof)
        bad[key] = bytes(proof["points"][0])
        out.append((f"tampered {key}", wires, samples, cells, bad))
    bad = dict(proof)
    bad["points"] = list(proof["points"][::-1])
    out.append(("reversed points", wires, samples, cells, bad))
    out.append(("wrong wire", [wires[1], wires[0]], samples, cells, proof))
    return out


def test_aggregate_verdicts_equal_jax(committee):
    """Every case's verdict equals the JAX package's (its oracle pairing):
    the honest proof passes, each forgery fails."""
    cases = _cases(committee)
    got = [committee["scheme"].verify_aggregate(*c[1:]) for c in cases]
    with use_config(jax_minimal()):
        want = [committee["jax"].verify_aggregate(*c[1:]) for c in cases]
    assert got == want
    assert got == [True] + [False] * (len(cases) - 1)
