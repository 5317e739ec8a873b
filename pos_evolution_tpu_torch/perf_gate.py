"""Perf-regression gate (the port's counterpart of ``scripts/perf_gate.py``):
compare a fresh emission against a baseline on COUNT-based metrics;
timing metrics are report-only by default.

Why counts: on CPU CI, wall-clock is noise, but the counters the
telemetry registry tracks — kernel builds and launches, handler calls,
dispatches — are deterministic properties of the code path taken. The
port's are ``kernel_builds_total{source}`` (one ``nvcc`` a kernel
source) and ``kernel_launches_total{kernel}`` (``telemetry/torchrt``),
where the JAX package counts ``jax_backend_compiles_total``; the
counters ``torchrt`` keeps under the JAX names
(``jax_dispatches_total``, ``jax_transfer_bytes_total``, ...) read as
they do there. A change that doubles a path's K2 launches or starts
rejecting half the on_block calls regressed the hot path even where
nothing can time it.

Accepted emissions (count sources, in order of preference):

- an emission with a ``telemetry.counts`` mapping (flattened
  ``MetricsRegistry.counts()``: ``serve_demo --json``);
- a ``python -m pos_evolution_tpu_torch.run_report`` ``--json`` report
  (handler call counts);
- any JSON whose top level has a ``counts`` mapping (``resilient_run
  --json``: its attempts, replays and saves, and the resumed attempt's
  ``kernel_launches_total`` and ``kernel_builds_total``).

Gate rule, per count key present in BOTH emissions:

    candidate <= baseline * rel_tol + abs_slack        (default 1.25 / 4)

Count keys present on only one side are listed and skipped (a new
counter is not a regression; a vanished one is suspicious but may be a
renamed metric — the listing makes it visible either way). If NO count
key is comparable: when the baseline carries no counts at all
(pre-telemetry emission) the gate passes vacuously, loudly; when BOTH
sides carry counts in disjoint namespaces (e.g. a bench emission vs a
run report) the shapes are incomparable and the gate refuses with
exit 2 rather than manufacture a vacuous pass.

Timing keys (``value`` seconds, ``*_ms`` leaves) are compared as ratios
and printed; they fail the gate only under ``--strict-timing`` (meant
for same-hardware A/B runs, never CPU CI).

**History mode** (``--history bench_history.jsonl``): instead of one
baseline file, gate against the robust band of the last ``--window``
entries of a ``profiling/history.py`` time-series — a count metric fails
only when it exceeds ``median + max(mad_k · 1.4826 · MAD, abs_slack)``
of its own recent history, so one noisy run neither poisons the band
nor slips a slow drift through. Empty history passes vacuously
(loudly) — EXCEPT when ``--kind`` was requested explicitly and the
filter matched nothing: an emission family the caller named that has
never emitted is a typo or a CI wiring error, and a vacuous pass there
would disable the gate forever without anyone noticing — that refuses
with exit 2. (``--list-kinds`` prints what the history actually
holds.) A history whose counts share no keys with the candidate is
incomparable and refuses with exit 2, same as baseline mode.

**Outlier quarantine** (``--max-abs-ratio R``, default off): MAD bands
are robust, which cuts both ways — a grossly contaminated history entry
(a bench that ran concurrently with a test suite) is silently *absorbed* instead of surfaced, and with a
small window it can drag the median enough to wave a regression
through. With the flag on, any entry whose value differs from the
median of the OTHER entries by more than a factor of R (either
direction) is flagged LOUDLY as ``[QUARANTINE]`` in the report and
excluded from the band. Series with fewer than 3 entries are never
quarantined (too few points to tell an outlier from a level shift),
zero-vs-nonzero comparisons are exempt (sparse counters legitimately
toggle 0 <-> small; no meaningful ratio exists), and a series where
EVERY entry implicates the others is kept raw but reported loudly as
mutually inconsistent.

Usage:
    python -m pos_evolution_tpu_torch.perf_gate --candidate fresh.json
        --baseline base.json [--rel-tol 1.25] [--abs-slack 4]
        [--count-only] [--strict-timing]
        [--history bench_history.jsonl] [--window 20] [--mad-k 4.0]
        [--kind bench_resilience] [--max-abs-ratio 8.0]
    python -m pos_evolution_tpu_torch.perf_gate --history h.jsonl --list-kinds

``--baseline`` has no default: the repo's ``BENCH_r*.json`` and
``BASELINE.json`` are the JAX package's TPU emissions, never the port's.
Exit 0 = pass, 1 = regression, 2 = usage error or incomparable emission
shapes. No torch: the gate reads files, wherever Python runs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys


def extract_counts(obj: dict) -> dict[str, float]:
    """Flat {metric-key: numeric} count emission from any accepted shape."""
    out: dict[str, float] = {}
    tel = obj.get("telemetry")
    if isinstance(tel, dict):
        counts = tel.get("counts", tel)
        for k, v in counts.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = v
    if isinstance(obj.get("counts"), dict):
        for k, v in obj["counts"].items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = v
    # registry counts() keys carry the status label
    # (handler_calls_total;handler=X;status=Y); fold in the per-handler
    # aggregate so they intersect the report-derived keys below
    agg: dict[str, float] = {}
    for k, v in out.items():
        if k.startswith("handler_calls_total;handler=") and ";status=" in k:
            base = k.split(";status=", 1)[0]
            agg[base] = agg.get(base, 0) + v
    out.update(agg)
    handlers = obj.get("handlers")
    if isinstance(handlers, dict):  # run_report.py --json shape
        for name, row in handlers.items():
            if isinstance(row, dict) and isinstance(row.get("count"), int):
                out[f"handler_calls_total;handler={name}"] = row["count"]
    return out


def extract_timings(obj: dict, prefix: str = "") -> dict[str, float]:
    """Numeric timing leaves: the bench headline ``value`` (seconds) and
    any ``*_ms`` / ``*_s`` key, recursively."""
    out: dict[str, float] = {}
    for k, v in obj.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(extract_timings(v, path))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            if k == "value" or re.search(r"(^|_)ms(_|$)|_s$|_seconds$", k):
                out[path] = float(v)
    return out


def gate(baseline: dict, candidate: dict, rel_tol: float, abs_slack: float,
         count_only: bool = True, strict_timing: bool = False,
         out=None) -> int:
    """Compare two emissions; returns the process exit code."""
    out = out if out is not None else sys.stdout  # late-bound: capsys swaps
    b_counts, c_counts = extract_counts(baseline), extract_counts(candidate)
    shared = sorted(set(b_counts) & set(c_counts))
    failures = []
    print(f"count metrics: {len(shared)} comparable "
          f"({len(c_counts) - len(shared)} candidate-only, "
          f"{len(b_counts) - len(shared)} baseline-only)", file=out)
    for key in shared:
        b, c = b_counts[key], c_counts[key]
        limit = b * rel_tol + abs_slack
        verdict = "FAIL" if c > limit else "ok"
        if c > limit:
            failures.append(key)
        print(f"  [{verdict}] {key}: baseline={b} candidate={c} "
              f"limit={limit:.1f}", file=out)
    for key in sorted(set(c_counts) - set(b_counts)):
        print(f"  [skip] {key}: no baseline (candidate={c_counts[key]})",
              file=out)
    for key in sorted(set(b_counts) - set(c_counts)):
        print(f"  [skip] {key}: vanished from candidate "
              f"(baseline={b_counts[key]})", file=out)
    if not shared:
        if b_counts and c_counts:
            # both emissions carry counts but in disjoint namespaces —
            # comparing a bench emission against a run report, or two
            # incompatible formats. Passing here would let a real
            # regression ship behind a "vacuous pass".
            print("  both emissions have counts but share NO keys — "
                  "incomparable emission shapes; refusing to gate",
                  file=out)
            return 2
        print("  no comparable count metrics — gate passes VACUOUSLY "
              "(baseline predates telemetry counts?)", file=out)

    if not count_only:
        b_times, c_times = (extract_timings(baseline),
                            extract_timings(candidate))
        t_shared = sorted(set(b_times) & set(c_times))
        print(f"timing metrics ({'GATED' if strict_timing else 'report-only'}"
              f"): {len(t_shared)} comparable", file=out)
        for key in t_shared:
            b, c = b_times[key], c_times[key]
            ratio = c / b if b else float("inf")
            flag = strict_timing and ratio > rel_tol
            if flag:
                failures.append(f"timing:{key}")
            print(f"  [{'FAIL' if flag else '--'}] {key}: "
                  f"baseline={b:.6g} candidate={c:.6g} ratio={ratio:.3f}",
                  file=out)

    if failures:
        print(f"PERF GATE: FAIL ({len(failures)} regression"
              f"{'s' if len(failures) != 1 else ''}): "
              + ", ".join(failures), file=out)
        _print_attribution(baseline, candidate, out)
        return 1
    print("PERF GATE: pass", file=out)
    return 0


def _print_attribution(baseline: dict, candidate: dict, out) -> None:
    """On gate failure, rank WHAT regressed via the port's perf_diff —
    the attribution table. Diagnostic only: any failure here must never
    change the gate's exit code."""
    try:
        from pos_evolution_tpu_torch import perf_diff
        print("--- attribution (scripts/perf_diff.py) ---", file=out)
        print(perf_diff.render(perf_diff.diff(baseline, candidate)),
              file=out)
    except Exception as e:  # pev: ignore[PEV005] — diagnostic only
        print(f"(perf_diff attribution unavailable: {e!r:.120})", file=out)


def quarantine_series(series: dict[str, list[float]], ratio: float,
                      out, label: str = "") -> dict[str, list[float]]:
    """Leave-one-out outlier quarantine for history series: drop (and
    loudly flag) any value whose ratio to the median of the remaining
    entries exceeds ``ratio`` in either direction. Returns the filtered
    series; series shorter than 3 entries pass through untouched."""
    from pos_evolution_tpu_torch.profiling.history import median

    tiny = 1e-12
    cleaned: dict[str, list[float]] = {}
    for key, xs in series.items():
        if len(xs) < 3:
            cleaned[key] = xs
            continue
        keep, dropped = [], []
        for i, v in enumerate(xs):
            m = median(xs[:i] + xs[i + 1:])
            lo, hi_v = sorted((abs(v), abs(m)))
            # zero-vs-anything has no meaningful ratio: sparse counters
            # legitimately toggle 0 <-> small, and crying wolf on them
            # would train operators to ignore the quarantine signal —
            # leave those entries to the MAD band
            r = 1.0 if lo <= tiny else hi_v / lo
            (dropped if r > ratio else keep).append(v)
        if dropped and keep:
            print(f"  [QUARANTINE] {label}{key}: {len(dropped)} contaminated "
                  f"history entr{'y' if len(dropped) == 1 else 'ies'} "
                  f"(value{'s' if len(dropped) != 1 else ''} "
                  f"{[round(d, 6) for d in dropped]} vs clean median "
                  f"{median(keep):.6g}) exceed --max-abs-ratio {ratio:g} — "
                  f"excluded from the band", file=out)
            cleaned[key] = keep
        elif dropped:
            # every entry implicates every other: there is no clean core
            # to band against, so keep the raw series but say so LOUDLY
            # (silently passing it through is exactly what the flag is
            # meant to prevent)
            print(f"  [QUARANTINE] {label}{key}: series is mutually "
                  f"inconsistent — all {len(xs)} entries exceed "
                  f"--max-abs-ratio {ratio:g} against the others; keeping "
                  f"the raw series, inspect this history by hand", file=out)
            cleaned[key] = xs
        else:
            cleaned[key] = xs
    return cleaned


def gate_history(history_path: str, candidate: dict, window: int,
                 mad_k: float, abs_slack: float, rel_tol: float = 1.25,
                 kind: str | None = None, count_only: bool = True,
                 strict_timing: bool = False,
                 max_abs_ratio: float | None = None, out=None) -> int:
    """Gate one emission against the robust band of its own history
    (``profiling/history.py``); returns the process exit code.

    Timing metrics get a RELATIVE slack floor (``rel_tol`` - 1, matching
    baseline mode's ratio semantics) instead of the count-calibrated
    ``abs_slack`` — 4 absolute units would swallow any regression of a
    sub-4ms metric.

    ``kind`` selects which emission family the band is computed over.
    ``bench.py`` and ``bench_all.py`` share one history file and share
    count KEYS at very different magnitudes; a band over the mixture is
    bimodal garbage, so a mixed-kind history without an explicit
    ``--kind`` refuses with exit 2 rather than gate against it."""
    from pos_evolution_tpu_torch.profiling import history as hist

    out = out if out is not None else sys.stdout  # late-bound: capsys swaps
    try:
        # window applies AFTER the kind filter: the band must cover the
        # last N entries of the candidate's own family
        entries = hist.read_history(history_path)
    except (OSError, ValueError) as e:
        print(f"perf_gate: history unreadable: {e}", file=out)
        return 2
    if kind is not None:
        entries = [e for e in entries if e.get("kind") == kind]
        if not entries:
            # the caller NAMED this family: a filter that matches
            # nothing is a typo or a CI wiring error, and a vacuous
            # pass here would silently disable the gate forever
            print(f"history {history_path}: zero entries of kind "
                  f"{kind!r} — an explicitly requested emission family "
                  f"with no history is a typo or a wiring error, not a "
                  f"clean slate. Run --list-kinds to see what the "
                  f"history holds; refusing to gate vacuously.",
                  file=out)
            return 2
    else:
        # an entry with no "kind" sorts as None — key it explicitly or
        # sorted() raises TypeError instead of the deliberate exit 2
        kinds = sorted({e.get("kind") for e in entries},
                       key=lambda k: (k is None, k or ""))
        if len(kinds) > 1:
            print(f"history holds MIXED emission kinds {kinds} sharing "
                  f"count keys at different magnitudes — a band over the "
                  f"mixture would gate nothing honestly. Pass --kind.",
                  file=out)
            return 2
    entries = entries[-window:]
    c_counts = extract_counts(candidate)
    # benches append their emission BEFORE anyone gates it: when the
    # newest entry IS the candidate (identical count emission), gating
    # against it would let the candidate vouch for itself — and a
    # regressed run re-gated N times would self-legitimize as its own
    # entries fill the window. Exclude it from the band.
    if entries and extract_counts(
            entries[-1].get("emission") or {}) == c_counts:
        entries = entries[:-1]
        print("note: newest history entry matches the candidate emission "
              "— excluded from the band (no self-gating)", file=out)
    series = hist.series_from_history(entries, extract_counts)
    if max_abs_ratio:
        series = quarantine_series(series, max_abs_ratio, out)
    if not entries:
        print(f"history {history_path}: EMPTY — gate passes VACUOUSLY "
              f"(first entry seeds the band)", file=out)
        print("PERF GATE: pass", file=out)
        return 0
    print(f"history: {len(entries)} entr"
          f"{'y' if len(entries) == 1 else 'ies'} (window {window}), "
          f"band = median ± max({mad_k}·1.4826·MAD, {abs_slack})", file=out)

    rows = hist.band_verdicts(c_counts, series, k=mad_k,
                              abs_slack=abs_slack)
    failures = []
    compared = 0
    for row in rows:
        if row["verdict"] == "skip":
            print(f"  [skip] {row['key']}: no history "
                  f"(candidate={row['value']})", file=out)
            continue
        compared += 1
        if row["verdict"] == "FAIL":
            failures.append(row["key"])
        print(f"  [{row['verdict']}] {row['key']}: "
              f"candidate={row['value']} median={row['median']:.6g} "
              f"mad={row['mad']:.6g} hi={row['hi']:.6g} (n={row['n']})",
              file=out)
    for key in sorted(set(series) - set(c_counts)):
        # baseline mode reports vanished metrics; a renamed counter must
        # stay visible here too, not silently fall out of the band
        print(f"  [skip] {key}: vanished from candidate "
              f"(history n={len(series[key])})", file=out)
    if not compared:
        if c_counts and series:
            print("  candidate and history both carry counts but share NO "
                  "keys — incomparable emission shapes; refusing to gate",
                  file=out)
            return 2
        print("  no comparable count metrics — gate passes VACUOUSLY "
              "(history predates telemetry counts?)", file=out)

    if not count_only:
        c_times = extract_timings(candidate)
        t_series = hist.series_from_history(entries, extract_timings)
        if max_abs_ratio:
            t_series = quarantine_series(t_series, max_abs_ratio, out,
                                         label="timing:")
        t_rows = hist.band_verdicts(c_times, t_series, k=mad_k,
                                    abs_slack=0.0,
                                    rel_slack=max(rel_tol - 1.0, 0.0))
        print(f"timing metrics ({'GATED' if strict_timing else 'report-only'}"
              f"): {sum(r['verdict'] != 'skip' for r in t_rows)} comparable",
              file=out)
        for row in t_rows:
            if row["verdict"] == "skip":
                continue
            flag = strict_timing and row["verdict"] == "FAIL"
            if flag:
                failures.append(f"timing:{row['key']}")
            print(f"  [{'FAIL' if flag else '--'}] {row['key']}: "
                  f"candidate={row['value']:.6g} median={row['median']:.6g} "
                  f"hi={row['hi']:.6g} (n={row['n']})", file=out)

    if failures:
        print(f"PERF GATE: FAIL ({len(failures)} regression"
              f"{'s' if len(failures) != 1 else ''} vs history band): "
              + ", ".join(failures), file=out)
        # attribution baseline: the newest history emission that is not
        # the candidate itself (same no-self-gating rule as the band)
        base = next((e.get("emission") for e in reversed(entries)
                     if e.get("emission") != candidate), None)
        if base is not None:
            _print_attribution(base, candidate, out)
        return 1
    print("PERF GATE: pass", file=out)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--candidate",
                    help="fresh bench/report JSON emission (required "
                         "for gating; optional with --list-kinds)")
    ap.add_argument("--baseline",
                    help="baseline emission (required with --candidate "
                         "unless --history is given)")
    ap.add_argument("--rel-tol", type=float, default=1.25)
    ap.add_argument("--abs-slack", type=float, default=4.0)
    ap.add_argument("--count-only", action="store_true",
                    help="skip the timing report entirely (CPU CI mode)")
    ap.add_argument("--strict-timing", action="store_true",
                    help="timing regressions also fail the gate "
                         "(same-hardware A/B only)")
    ap.add_argument("--history",
                    help="gate against a bench_history.jsonl robust band "
                         "instead of a single baseline file")
    ap.add_argument("--window", type=int, default=20,
                    help="history entries the band is computed over")
    ap.add_argument("--mad-k", type=float, default=4.0,
                    help="band halfwidth in scaled-MAD units")
    ap.add_argument("--kind",
                    help="history emission kind to gate against (e.g. "
                         "bench / bench_all); required when the history "
                         "file holds mixed kinds")
    ap.add_argument("--max-abs-ratio", type=float, default=None,
                    help="history-mode outlier quarantine: flag LOUDLY and "
                         "exclude history entries whose value differs from "
                         "the median of the other entries by more than this "
                         "factor (default: off — contaminated entries are "
                         "only absorbed by the MAD band, silently)")
    ap.add_argument("--list-kinds", action="store_true",
                    help="print the emission kinds (and entry counts) a "
                         "--history file holds, then exit — the lookup "
                         "for a --kind refusal")
    args = ap.parse_args(argv)

    if args.list_kinds:
        if not args.history:
            print("perf_gate: --list-kinds requires --history",
                  file=sys.stderr)
            return 2
        from pos_evolution_tpu_torch.profiling import history as hist
        try:
            entries = hist.read_history(args.history)
        except (OSError, ValueError) as e:
            print(f"perf_gate: history unreadable: {e}", file=sys.stderr)
            return 2
        by_kind: dict[str, int] = {}
        for e in entries:
            k = e.get("kind") or "(none)"
            by_kind[k] = by_kind.get(k, 0) + 1
        print(f"history: {args.history} ({len(entries)} "
              f"entr{'y' if len(entries) == 1 else 'ies'})")
        for k in sorted(by_kind):
            print(f"  {k}: {by_kind[k]}")
        return 0
    if not args.candidate:
        ap.error("--candidate is required (except with --list-kinds)")

    if args.history:
        try:
            with open(args.candidate) as fh:
                candidate = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            print(f"perf_gate: {e}", file=sys.stderr)
            return 2
        print(f"history:   {args.history}")
        print(f"candidate: {args.candidate}")
        return gate_history(args.history, candidate, window=args.window,
                            mad_k=args.mad_k, abs_slack=args.abs_slack,
                            rel_tol=args.rel_tol, kind=args.kind,
                            count_only=args.count_only,
                            strict_timing=args.strict_timing,
                            max_abs_ratio=args.max_abs_ratio)

    baseline_path = args.baseline
    if baseline_path is None or not os.path.exists(baseline_path):
        print(f"perf_gate: no baseline found ({baseline_path!r})",
              file=sys.stderr)
        return 2
    try:
        with open(baseline_path) as fh:
            baseline = json.load(fh)
        with open(args.candidate) as fh:
            candidate = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        print(f"perf_gate: {e}", file=sys.stderr)
        return 2
    print(f"baseline:  {baseline_path}")
    print(f"candidate: {args.candidate}")
    return gate(baseline, candidate, args.rel_tol, args.abs_slack,
                count_only=args.count_only,
                strict_timing=args.strict_timing)


if __name__ == "__main__":
    sys.exit(main())
