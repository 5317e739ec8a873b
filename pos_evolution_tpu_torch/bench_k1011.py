"""K10 and K11 before and after on one card: the Fr INTT and the G1 MSMs of
the KZG path at its shapes, timed through the port's public entry points in
two checkouts of the repo, in turns.

    python -m pos_evolution_tpu_torch.bench_k1011 OLD NEW

Four turns, OLD, NEW, NEW, OLD (``bench_k3.run_turns``); each runs a fresh
process from one checkout (its own build of the kernels and its own setup
of 16,384 powers) and times each case from the same seeded inputs:

- ``device_ms``: the calls captured in a CUDA graph and the replay timed
  between two CUDA events, per call (the host's launch rate taken out);
- ``wrapper_ms``: CUDA events over the same calls made from Python;
- ``digest``: SHA-256 of the result (canonical affine points and their
  infinity flags; the INTT's digits), equal across the checkouts.

The cases: the commit's MSM over the setup's powers at 9 x 16,384, the
prover's at 1 x 16,383, the verifier's fold over 10 points, and K10's INTT
at (9, 16,384) and (9, 1,024). A checkout with K11's bucket route
(``pairing.g1_msm_fixed``) runs the setup's MSMs through the setup's window
tables (built once, untimed; their build time is reported) and the fold
through the ladder; an older one runs all three on the ladder.

    python -m pos_evolution_tpu_torch.bench_k1011 --c 11 12 13 14 15

times the commit's MSM in this checkout with window tables of each c
(device ms by CUDA graph, each c's result checked equal): the measurement
``pairing.MSM_WINDOW`` is set from. Needs a CUDA card; prints one JSON
line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

N = 16_384                      # the PeerDAS domain: 128 cells x 128 chunks
BLOBS = 9
CASES = ("commit MSM 9 x 16384", "prover MSM 1 x 16383", "verifier fold 1 x 10",
         "INTT (9, 16384)", "INTT (9, 1024)")
REPS = {"commit MSM 9 x 16384": 3, "prover MSM 1 x 16383": 3, "verifier fold 1 x 10": 5,
        "INTT (9, 16384)": 20, "INTT (9, 1024)": 20}


def _inputs(torch, dev):
    """The setup, the commit's canonical coefficient digits [9, N, 22], a
    fold's 10 points and scalars, and Montgomery digits for the INTTs."""
    import numpy as np

    from pos_evolution_tpu_torch.crypto import bls12_381 as oracle
    from pos_evolution_tpu_torch.kzg import fr
    from pos_evolution_tpu_torch.kzg import setup as kzg_setup
    from pos_evolution_tpu_torch.ops import pairing

    rng = np.random.default_rng(1011)
    setup = kzg_setup.device_setup(N, 0, dev)
    ints = [int.from_bytes(rng.bytes(32), "little") % fr.MODULUS for _ in range(BLOBS * N)]
    coeffs = fr.ints_to_digits(ints, dev).reshape(BLOBS, N, fr.L)
    pts = [oracle.ec_mul(oracle.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(10)]
    enc, inf = pairing.g1_encode_points(pts, dev)
    fold = (enc[None], inf[None], fr.ints_to_digits(ints[:10], dev)[None])
    mont = fr.to_mont(coeffs)
    return setup, coeffs, fold, mont


def _build(kernels) -> None:
    """Build the kernels the cases run (K3, K4, K10, K11), one nvcc a source."""
    kernels.build_all([k for k in kernels.KERNELS
                       if k.startswith(("fp_modmul", "fp_pow", "fp_addsub", "fr_", "g1_"))])


def _digest(torch, out) -> str:
    parts = out if isinstance(out, tuple) else (out,)
    h = hashlib.sha256()
    for t in parts:
        h.update(t.to(torch.int32).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker() -> dict:
    """The cases timed with the checkout that ``pos_evolution_tpu_torch``
    imports from (the working directory)."""
    import torch

    from pos_evolution_tpu_torch.bench_k3 import _events_ms, _graph_ms
    from pos_evolution_tpu_torch.kzg import ntt
    from pos_evolution_tpu_torch.ops import kernels, pairing

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build(kernels)
    setup, coeffs, fold, mont = _inputs(torch, dev)
    res = {}
    if hasattr(pairing, "g1_msm_fixed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables = setup.window_tables()
        torch.cuda.synchronize()
        res["tables"] = {"c": tables.c, "build_ms": 1e3 * (time.perf_counter() - t0),
                         "bytes": tables.points.numel() * 4 + tables.inf.numel()}

        def over_powers(scalars):
            return pairing.g1_msm_fixed(tables, scalars)
    else:
        def over_powers(scalars):
            k = scalars.shape[1]
            return pairing.g1_msm(setup.points[:k], setup.inf[:k], scalars)
    calls = {"commit MSM 9 x 16384": lambda: over_powers(coeffs),
             "prover MSM 1 x 16383": lambda: over_powers(coeffs[:1, 1:]),
             "verifier fold 1 x 10": lambda: pairing.g1_msm(*fold),
             "INTT (9, 16384)": lambda: ntt.intt(mont),
             "INTT (9, 1024)": lambda: ntt.intt(mont[:, :1024])}
    out = {}
    for name in CASES:
        call = calls[name]
        got = call()
        torch.cuda.synchronize()
        out[name] = {"device_ms": _graph_ms(torch, call, REPS[name]),
                     "wrapper_ms": _events_ms(torch, call, REPS[name]),
                     "digest": _digest(torch, got)}
    res["cases"] = out
    res["card"] = _card()
    return res


def c_sweep(cs) -> dict:
    """Device ms of the commit's MSM with window tables of each c (this
    checkout); raises if two c's results differ."""
    import torch

    from pos_evolution_tpu_torch.bench_k3 import _graph_ms
    from pos_evolution_tpu_torch.ops import kernels, pairing

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build(kernels)
    setup, coeffs, _fold, _mont = _inputs(torch, dev)
    sweep, first = {}, None
    for c in cs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables = pairing.g1_window_tables(setup.points, setup.inf, c)
        torch.cuda.synchronize()
        build_ms = 1e3 * (time.perf_counter() - t0)
        got = pairing.g1_msm_fixed(tables, coeffs)
        digest = _digest(torch, got)
        if first is not None and digest != first:
            raise AssertionError(f"the commit MSM at c = {c} differs")
        first = digest
        sweep[str(c)] = {"device_ms": _graph_ms(torch, lambda t=tables: pairing.g1_msm_fixed(
                             t, coeffs), 5),
                         "tables_build_ms": build_ms,
                         "tables_bytes": tables.points.numel() * 4 + tables.inf.numel()}
        del tables
        torch.cuda.empty_cache()
    return {"msm_window": pairing.MSM_WINDOW, "device_ms_by_c": sweep, "digest": first,
            "card": _card()}


def _card() -> str:
    import subprocess
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="OLD NEW", help="two checkouts of the repo")
    ap.add_argument("--c", nargs="+", type=int, metavar="C",
                    help="time the commit MSM with window tables of each c in this checkout")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        print(json.dumps(worker()))
        return 0
    if a.c:
        print(json.dumps(c_sweep(a.c)))
        return 0
    if len(a.trees) != 2:
        ap.error("give two checkouts, OLD and NEW")
    from pos_evolution_tpu_torch.bench_k3 import run_turns   # the worker runs in OLD too
    return run_turns(__file__, a.trees, CASES)


if __name__ == "__main__":
    sys.exit(main())
