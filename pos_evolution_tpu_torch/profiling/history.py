"""Bench history: a schema-versioned JSONL time-series of bench
emissions, and the robust statistics ``scripts/perf_gate.py --history``
gates against.

Why a time-series and not a baseline file: one baseline is one sample.
CPU wall-clock jitters, counters drift legitimately as features land,
and a single-sample gate either cries wolf or sleeps through a slow
regression. With the last N entries on disk, a metric is flagged only
when it falls outside a **robust band** of its own recent history:

    median(xs) ± max(k · 1.4826 · MAD(xs), abs_slack)

MAD (median absolute deviation, scaled by 1.4826 to estimate sigma under
normality) ignores the outliers that a mean/stddev band would be dragged
by — one anomalous CI run does not poison the band. The ``abs_slack``
floor keeps a degenerate band (MAD = 0: identical history values, or a
single entry) from flagging every ±1 count.

Envelope (history schema v1), one JSON object per line:

    {"v": 1, "unix": <float>, "kind": "bench" | "bench_all" | ...,
     "emission": {<the full bench/report JSON>}, ["top_ops": {...}]}

``append_entry`` is commit-on-arrival (line-buffered append, same
posture as the event bus): a crashed bench still leaves every prior
entry parseable. ``read_history`` tolerates a torn final line and
refuses unknown schema versions, mirroring ``telemetry.read_jsonl``.
"""

from __future__ import annotations

import json
import os
import time

HISTORY_SCHEMA_VERSION = 1

# MAD -> sigma under normality
_MAD_SIGMA = 1.4826


def append_entry(path, emission: dict, kind: str,
                 top_ops: dict | None = None, unix: float | None = None
                 ) -> dict:
    """Append one emission to the history file (created on first use);
    returns the envelope written."""
    entry: dict = {"v": HISTORY_SCHEMA_VERSION,
                   "unix": round(time.time() if unix is None else unix, 3),
                   "kind": kind, "emission": emission}
    if top_ops:
        entry["top_ops"] = top_ops
    with open(os.fspath(path), "a", buffering=1) as fh:
        fh.write(json.dumps(entry, sort_keys=True) + "\n")
    return entry


def read_history(path, window: int | None = None) -> list[dict]:
    """Load history entries (oldest first), keeping only the last
    ``window`` when given; a missing file is an empty history. The
    torn-tail / mid-log-corruption / unknown-schema contract is the
    shared ``telemetry.events.read_versioned_jsonl`` — one reader, no
    drift between the event log's semantics and this one's."""
    from pos_evolution_tpu_torch.telemetry.events import read_versioned_jsonl
    path = os.fspath(path)
    if not os.path.exists(path):
        return []
    entries = read_versioned_jsonl(path, HISTORY_SCHEMA_VERSION,
                                   label="bench-history")
    return entries[-window:] if window is not None else entries


def median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        raise ValueError("median of empty series")
    mid = n // 2
    return float(s[mid]) if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def mad(xs: list[float]) -> float:
    m = median(xs)
    return median([abs(x - m) for x in xs])


def robust_band(xs: list[float], k: float = 4.0,
                abs_slack: float = 4.0, rel_slack: float = 0.0) -> dict:
    """The gate band for one metric's history: ``{"median", "mad",
    "halfwidth", "lo", "hi", "n"}`` with halfwidth =
    max(k·1.4826·MAD, abs_slack, rel_slack·|median|).

    ``abs_slack`` is in the metric's own units — right for counts
    (always the same unit), wrong for timings (a 4-unit floor swallows a
    6x regression of a 0.5 ms metric); timing callers pass
    ``abs_slack=0`` and a ``rel_slack`` fraction instead."""
    m = median(xs)
    d = mad(xs)
    half = max(k * _MAD_SIGMA * d, abs_slack, rel_slack * abs(m))
    return {"median": m, "mad": d, "halfwidth": half,
            "lo": m - half, "hi": m + half, "n": len(xs)}


def band_verdicts(candidate: dict[str, float],
                  history_series: dict[str, list[float]],
                  k: float = 4.0, abs_slack: float = 4.0,
                  rel_slack: float = 0.0,
                  two_sided: bool = False) -> list[dict]:
    """Per-metric verdict rows for every candidate key with history.

    One-sided by default: only ``candidate > hi`` fails (a count/time
    *increase* is the regression; a drop is visible in the row but does
    not gate — vanishing work is usually a renamed metric or a feature
    removal, and the baseline-mode gate never failed those either).
    Keys with no history are skipped rows (``verdict: "skip"``) — a new
    counter is not a regression."""
    rows = []
    for key in sorted(candidate):
        xs = history_series.get(key) or []
        if not xs:
            rows.append({"key": key, "value": candidate[key],
                         "verdict": "skip", "n": 0})
            continue
        band = robust_band(xs, k=k, abs_slack=abs_slack,
                           rel_slack=rel_slack)
        bad_hi = candidate[key] > band["hi"]
        bad_lo = two_sided and candidate[key] < band["lo"]
        rows.append({"key": key, "value": candidate[key],
                     "verdict": "FAIL" if (bad_hi or bad_lo) else "ok",
                     **band})
    return rows


def series_from_history(entries: list[dict], extract) -> dict[str, list[float]]:
    """Apply ``extract(emission_dict) -> {key: value}`` over every
    history entry and pivot into per-key series (oldest first). Entries
    whose emission lacks a key simply contribute nothing to that key's
    series."""
    series: dict[str, list[float]] = {}
    for entry in entries:
        emission = entry.get("emission")
        if not isinstance(emission, dict):
            continue
        for key, value in extract(emission).items():
            series.setdefault(key, []).append(float(value))
    return series
