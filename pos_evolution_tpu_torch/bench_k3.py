"""K3 before and after on one card: the base-field products and the
inversion of the BLS verify path, timed through the port's public wrappers
(``fp.modmul``, ``fp.modinv``) in two checkouts of the repo, in turns.

    python -m pos_evolution_tpu_torch.bench_k3 OLD NEW

Four turns, OLD, NEW, NEW, OLD; each runs a fresh process from one checkout
(its own build of K3) and times each case at the path's shapes, from the same seeded digits:

- ``device_ms``: 20 calls (5 for ``modinv``) captured in a CUDA graph and the
  replay timed between two CUDA events, per call: the card's time for the
  call's launches and any operand copies, the host's launch rate taken out;
- ``wrapper_ms``: CUDA events over the same calls made from Python;
- ``launches``: K3 launches of one call (a ladder counts one);
- ``digest``: SHA-256 of the output digits, equal across the checkouts.

Prints one JSON line per turn and, last, one that gathers the turns by
case. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

B, LANES = 2048, 4096
TURNS = (0, 1, 1, 0)
CASES = ("2048", "2048x64 tree level", "2048x32 tree level", "2048x16 tree level",
         "4096x2x2 line", "4096x2 scale", "modinv 2048")


def _events_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def worker() -> dict:
    """The cases timed with the checkout that ``pos_evolution_tpu_torch``
    imports from (the working directory)."""
    import numpy as np
    import torch

    from pos_evolution_tpu_torch.ops import fp, kernels

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(6)

    def digits(*shape):
        d = rng.integers(0, 1 << fp.BITS, (*shape, fp.L), dtype=np.int32)
        d[..., -1] = rng.integers(0, int(fp.TWO_P[-1]), shape, dtype=np.int32)
        return torch.from_numpy(d).to(dev)

    def tree_level(k):                 # the G1 sum tree's Jacobian add: unbind views
        jac = digits(B, 2 * k, 3)
        return jac[:, :k].unbind(-2)[0], jac[:, k:].unbind(-2)[2]

    c2 = digits(LANES, 2)
    calls = {
        "2048": (fp.modmul, digits(B), digits(B)),
        "2048x64 tree level": (fp.modmul, *tree_level(64)),
        "2048x32 tree level": (fp.modmul, *tree_level(32)),
        "2048x16 tree level": (fp.modmul, *tree_level(16)),
        "4096x2x2 line": (fp.modmul, digits(LANES, 2, 2), digits(LANES, 2, 2)),
        "4096x2 scale": (fp.modmul, c2, c2[:, 0, None, :]),
        "modinv 2048": (fp.modinv, digits(B)),
    }
    k3 = [k for k in kernels.launches if k in ("fp_modmul", "fp_pow")]
    out = {}
    for name in CASES:
        fn, *args = calls[name]
        call = lambda fn=fn, args=args: fn(*args)       # noqa: E731
        before = sum(kernels.launches[k] for k in k3)
        got = call()
        torch.cuda.synchronize()
        launches = sum(kernels.launches[k] for k in k3) - before
        reps = 5 if name.startswith("modinv") else 20
        out[name] = {"launches": launches,
                     "device_ms": _graph_ms(torch, call, reps),
                     "wrapper_ms": _events_ms(torch, call, reps),
                     "digest": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    return {"card": card, "cases": out}


def run_turns(script: str, trees, cases) -> int:
    """Run ``script --worker`` from each checkout in TURNS order (a fresh
    process, its own build), print each turn's JSON line and, last, the
    turns gathered by case; 0 when every case's output is equal across
    the checkouts."""
    turns = []
    for i in TURNS:
        me = os.path.abspath(script)         # run from the checkout: it comes first on the path
        res = subprocess.run(
            [sys.executable, "-c", f"import runpy, sys; sys.argv = [{me!r}, '--worker']; "
             f"runpy.run_path({me!r}, run_name='__main__')"],
            cwd=os.path.abspath(trees[i]), capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            raise SystemExit(f"the turn in {trees[i]} failed (exit code {res.returncode})")
        turn = {"tree": trees[i], **json.loads(res.stdout.strip().splitlines()[-1])}
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    digests = {c: {t["cases"][c]["digest"] for t in turns} for c in cases}
    print(json.dumps({
        "cases": {c: [{"tree": t["tree"], **{k: v for k, v in t["cases"][c].items()
                                             if k != "digest"}} for t in turns] for c in cases},
        "outputs_equal": all(len(d) == 1 for d in digests.values())}))
    return 0 if all(len(d) == 1 for d in digests.values()) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="OLD NEW", help="two checkouts of the repo")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        print(json.dumps(worker()))
        return 0
    if len(a.trees) != 2:
        ap.error("give two checkouts, OLD and NEW")
    return run_turns(__file__, a.trees, CASES)


if __name__ == "__main__":
    sys.exit(main())
