"""CLI: ``python -m pos_evolution_tpu_torch.analysis`` (port of
``pos_evolution_tpu/analysis/__main__.py``: the same flags and exit codes;
its default paths are the port's and its default baseline is the port's
own, ``pos_evolution_tpu_torch/analysis/baseline.json``).

Exit codes (gate semantics, pinned in tests/test_torch_analysis.py):

- ``0`` — no new findings (and, under ``--strict``, no stale baseline
  entries); or report-only mode.
- ``1`` — new findings (``--strict`` / default gate), or ``--doctor``
  produced exactly the expected findings (the doctored file *fails* the
  lint — CI asserts rc == 1).
- ``2`` — the pass itself is unhealthy: stale baseline entries under
  ``--strict``, a doctor mismatch, or bad usage.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass, field

from .core import Baseline, Finding
from .doctor import run_doctor
from .engine import DEFAULT_PATHS, AnalysisConfig, analyze_paths
from .report import dumps as report_dumps
from .report import render_text

#: the port's checked-in baseline (never the root's analysis_baseline.json,
#: which the JAX package's gate reads)
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


@dataclass
class Summary:
    files_scanned: int = 0
    new: list = field(default_factory=list)
    absorbed: int = 0
    suppressed: int = 0
    stale_baseline: list = field(default_factory=list)


def gate(paths, root=".", baseline: Baseline | None = None,
         config: AnalysisConfig | None = None) -> Summary:
    """Analyze ``paths`` and partition findings against the baseline."""
    results = analyze_paths(paths, root=root, config=config)
    findings: list[Finding] = []
    suppressed = 0
    for r in results:
        findings.extend(r.findings)
        suppressed += r.suppressed
    if baseline is not None:
        new, absorbed, stale = baseline.match(findings)
    else:
        new, absorbed, stale = findings, [], []
    return Summary(files_scanned=len(results), new=new,
                   absorbed=len(absorbed), suppressed=suppressed,
                   stale_baseline=stale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pos_evolution_tpu_torch.analysis",
        description="Consensus-grade static analysis of the PyTorch/CUDA "
                    "port: PEV lint (torch rules) + lockset race detector")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to analyze (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="checked-in baseline of justified pre-existing "
                         "findings (default: the port's "
                         "pos_evolution_tpu_torch/analysis/baseline.json; "
                         "'none' disables)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail (rc 2) on stale baseline entries")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="write the JSON report to FILE ('-' = stdout)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated PEV codes to run (default: all)")
    ap.add_argument("--assume-scope", choices=("strict", "decision"),
                    default=None,
                    help="treat EVERY analyzed file as a stateless-"
                         "contract module of the given class (used for "
                         "the tests/ flaky-prevention pass, where the "
                         "per-module scope tables don't apply)")
    ap.add_argument("--doctor", action="store_true",
                    help="self-test on the synthesized bug file; rc 1 = "
                         "healthy (the doctored file fails the lint)")
    ap.add_argument("--write-baseline", metavar="FILE", default=None,
                    help="write current new findings as baseline entries "
                         "to FILE (justifications start as TODO and must "
                         "be hand-edited)")
    ap.add_argument("--root", default=".", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.doctor:
        return run_doctor()

    config = AnalysisConfig(
        rules=(frozenset(c.strip() for c in args.rules.split(",") if c.strip())
               if args.rules else None))
    if args.assume_scope == "strict":
        config.stateless_strict = ("*",)
    elif args.assume_scope == "decision":
        config.stateless_decision = ("*",)
    baseline = None
    if args.baseline and args.baseline != "none":
        try:
            baseline = Baseline.load(args.baseline)
        except FileNotFoundError:
            print(f"note: baseline {args.baseline!r} not found — every "
                  f"finding counts as new", file=sys.stderr)
    paths = args.paths or DEFAULT_PATHS
    try:
        summary = gate(paths, root=args.root, baseline=baseline,
                       config=config)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        entries = list(baseline.entries) if baseline else []
        for f in summary.new:
            entries.append(Baseline.entry_for(
                f, "TODO: one-line justification (deliberate pattern? "
                   "fix instead?)"))
        merged = Baseline(entries=entries)
        with open(args.write_baseline, "w", encoding="utf-8") as fh:
            fh.write(merged.dump())
        print(f"wrote {len(entries)} baseline entries to "
              f"{args.write_baseline}", file=sys.stderr)

    if args.json:
        blob = report_dumps(summary)
        if args.json == "-":
            sys.stdout.write(blob)
        else:
            with open(args.json, "w", encoding="utf-8") as fh:
                fh.write(blob)
    if args.json != "-":
        print(render_text(summary))

    if summary.new:
        return 1
    if args.strict and summary.stale_baseline:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
