"""K6 and K7 before and after on one card: the multi-block SHA-256 and the
GF(2^8) product at the sync and DAS path's shapes, timed through the
port's public wrappers (``sha256.sha256_blocks``, ``das_verify.gf_matmul``)
in two checkouts of the repo, in turns.

    python -m pos_evolution_tpu_torch.bench_k67 OLD NEW

Four turns, OLD, NEW, NEW, OLD (``bench_k3.run_turns``); each runs a fresh
process from one checkout (its own build of K6 and K7) and times each case
from the same seeded inputs:

- ``device_ms``: 20 calls captured in a CUDA graph and the replay timed
  between two CUDA events, per call (the host's launch rate taken out);
- ``wrapper_ms``: CUDA events over the same calls made from Python;
- ``digest``: SHA-256 of the output, equal across the checkouts.

K2 (``merkle_device.merkle_level``) at 4,194,304 and 1,048,576 pairs is
timed as a control: it shares ``csrc/sha256.cuh`` with K6.

A checkout whose K6 has named designs (``sha256_blocks_design``) also
times each design (the chains, one thread a message in blocks of 32 and
of 128) at 1,152-36,864 messages of 33 blocks and of 1 block
(``crossover``: device ms by design), where its constants
(``sha256.k6_chains_below``, ``k6_chains_min_blocks``) are read. Prints one
JSON line per turn and, last, one that gathers the turns by case.

    python -m pos_evolution_tpu_torch.bench_k67 --designs

times the designs alone in this checkout over a wider grid (1-33 blocks,
256 to 1,048,576 messages), each shape's designs checked equal, and
prints one JSON line: the measurement K6's constants are set from. Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

# K6: (messages, blocks) of the path (bench_k67 hashes random words: the
# padding does not change the work); K7: (groups of A, groups, r, k, W)
K6_CASES = {"cell leaves": (1152, 33), "blob streams": (36_864, 1),
            "client digests": (100_000, 1), "backfill": (36_864, 33),
            "sync lanes": (1_048_576, 1)}
K7_CASES = {"extension": (1, 9, 64, 64, 2048), "regrid": (9, 9, 128, 64, 2048)}
# controls: K2 (csrc/merkle_level.cu) shares sha256.cuh with K6, and its
# source is the same in both checkouts; pairs of one merkle level
K2_CASES = {"K2 4194304 pairs": 4_194_304, "K2 1048576 pairs": 1_048_576}
CASES = (*K6_CASES, *K7_CASES, *K2_CASES)
SWEEP = (1152, 4608, 8192, 8447, 8448, 9216, 18_432, 36_864)
# --designs: (blocks, message counts)
DESIGN_GRID = tuple((b, (256, 1152, 4608, 8192, 8447, 8448, 9216, 18_432, 36_864))
                    for b in (33, 8, 4, 3, 2)) \
    + ((1, (256, 1152, 4608, 8192, 8447, 8448, 9216, 18_432, 36_864, 100_000, 1_048_576)),)
# K6's designs by the measuring entry point's `threads` (0: the chains)
DESIGNS = {"chains": 0, "one_thread_32": 32, "one_thread_128": 128}


def design_sweep(grid) -> dict:
    """Device ms of each of K6's DESIGNS at each (messages, blocks) of
    ``grid``, random words; raises if two designs' digests differ."""
    import numpy as np
    import torch

    from pos_evolution_tpu_torch.bench_k3 import _graph_ms
    from pos_evolution_tpu_torch.ops import kernels

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(68)
    sweep = {}
    for blocks, ns in grid:
        words = torch.from_numpy(rng.integers(-2**31, 2**31, (max(ns), 16 * blocks),
                                              dtype=np.int64).astype(np.int32)).to(dev)
        o = torch.empty((max(ns), 8), dtype=torch.int32, device=dev)
        for n in ns:
            row, first = {}, None
            for design, threads in DESIGNS.items():
                def raw(n=n, threads=threads, words=words, o=o, blocks=blocks):
                    kernels.launch_on(dev, "sha256_blocks_design", words.data_ptr(),
                                      16 * blocks, blocks, o.data_ptr(), n, threads)
                row[design] = _graph_ms(torch, raw, 20)
                raw()
                got = o[:n].clone()
                if first is not None and not torch.equal(got, first):
                    raise AssertionError(f"K6's {design} differs at {n} x {blocks}")
                first = got
            sweep[f"{n}x{blocks}"] = row
        del words, o
    return sweep


def worker() -> dict:
    """The cases timed with the checkout that ``pos_evolution_tpu_torch``
    imports from (the working directory)."""
    import numpy as np
    import torch

    from pos_evolution_tpu_torch.bench_k3 import _events_ms, _graph_ms
    from pos_evolution_tpu_torch.ops import das_verify, kernels, merkle_device, sha256

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(67)
    calls = {}
    for name, (n, blocks) in K6_CASES.items():
        words = torch.from_numpy(rng.integers(-2**31, 2**31, (n, 16 * blocks),
                                              dtype=np.int64).astype(np.int32)).to(dev)
        calls[name] = (sha256.sha256_blocks, words)
    for name, (ga, g, r, k, w) in K7_CASES.items():
        calls[name] = (das_verify.gf_matmul,
                       torch.from_numpy(rng.integers(0, 256, (ga, r, k), dtype=np.uint8)).to(dev),
                       torch.from_numpy(rng.integers(0, 256, (g, k, w), dtype=np.uint8)).to(dev))
    for name, pairs in K2_CASES.items():
        nodes = torch.from_numpy(rng.integers(-2**31, 2**31, (2 * pairs, 8),
                                              dtype=np.int64).astype(np.int32)).to(dev)
        calls[name] = (merkle_device.merkle_level, nodes[0::2], nodes[1::2])
    out = {}
    for name in CASES:
        fn, *args = calls[name]
        call = lambda fn=fn, args=args: fn(*args)       # noqa: E731
        got = call()
        torch.cuda.synchronize()
        out[name] = {"device_ms": _graph_ms(torch, call, 20),
                     "wrapper_ms": _events_ms(torch, call, 20),
                     "digest": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}
    res = {"cases": out}
    if "sha256_blocks_design" in kernels.KERNELS:
        res["crossover"] = {"chains_below": sha256.k6_chains_below(),
                            "chains_min_blocks": sha256.k6_chains_min_blocks(),
                            "device_ms": design_sweep(((33, SWEEP), (1, SWEEP)))}
    res["card"] = _card()
    return res


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="OLD NEW", help="two checkouts of the repo")
    ap.add_argument("--designs", action="store_true",
                    help="time K6's designs over DESIGN_GRID in this checkout")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        print(json.dumps(worker()))
        return 0
    if a.designs:
        from pos_evolution_tpu_torch.ops import sha256
        print(json.dumps({"chains_below": sha256.k6_chains_below(),
                          "chains_min_blocks": sha256.k6_chains_min_blocks(),
                          "device_ms": design_sweep(DESIGN_GRID), "card": _card()}))
        return 0
    if len(a.trees) != 2:
        ap.error("give two checkouts, OLD and NEW")
    from pos_evolution_tpu_torch.bench_k3 import run_turns   # the worker runs in OLD too
    return run_turns(__file__, a.trees, CASES)


if __name__ == "__main__":
    sys.exit(main())
