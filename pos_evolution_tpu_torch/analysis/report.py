"""Text and JSON reporters. The JSON schema is versioned and pinned by
tests/test_analysis.py — downstream tooling (CI greps, dashboards) may
rely on every key listed in ``SCHEMA_KEYS``."""

from __future__ import annotations

import json

REPORT_VERSION = 1

SCHEMA_KEYS = ("version", "files_scanned", "findings", "absorbed",
               "suppressed", "stale_baseline", "by_code", "rules")
FINDING_KEYS = ("code", "path", "line", "col", "message", "context", "key")


def render_text(summary) -> str:
    """Human-facing report: one `file:line  CODE  message` per finding,
    grouped stats at the end."""
    lines = []
    for f in summary.new:
        lines.append(f"{f.location()}: {f.code} [{f.context or '<module>'}] "
                     f"{f.message}")
    if summary.stale_baseline:
        lines.append("")
        lines.append("stale baseline entries (no longer match anything — "
                     "prune them):")
        for e in summary.stale_baseline:
            lines.append(f"  {e['code']} {e['path']} [{e['context']}] "
                         f"{e['key'][:60]}")
    lines.append("")
    by_code: dict[str, int] = {}
    for f in summary.new:
        by_code[f.code] = by_code.get(f.code, 0) + 1
    tally = " ".join(f"{c}={n}" for c, n in sorted(by_code.items())) or "none"
    lines.append(
        f"{summary.files_scanned} files: {len(summary.new)} new finding(s) "
        f"[{tally}], {summary.absorbed} baselined, "
        f"{summary.suppressed} suppressed"
        + (f", {len(summary.stale_baseline)} stale baseline entr"
           f"{'y' if len(summary.stale_baseline) == 1 else 'ies'}"
           if summary.stale_baseline else ""))
    return "\n".join(lines)


def render_json(summary) -> dict:
    from .core import all_rules
    return {
        "version": REPORT_VERSION,
        "files_scanned": summary.files_scanned,
        "findings": [
            {"code": f.code, "path": f.path, "line": f.line, "col": f.col,
             "message": f.message, "context": f.context, "key": f.key}
            for f in summary.new],
        "absorbed": summary.absorbed,
        "suppressed": summary.suppressed,
        "stale_baseline": list(summary.stale_baseline),
        "by_code": _by_code(summary.new),
        "rules": {c: {"name": r.name, "rationale": r.rationale}
                  for r in all_rules().values()
                  for c in r.all_codes},
    }


def _by_code(findings) -> dict:
    out: dict[str, int] = {}
    for f in findings:
        out[f.code] = out.get(f.code, 0) + 1
    return dict(sorted(out.items()))


def dumps(summary) -> str:
    return json.dumps(render_json(summary), indent=1, sort_keys=True) + "\n"
