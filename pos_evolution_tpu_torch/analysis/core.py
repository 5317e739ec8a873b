"""Framework core: findings, the rule registry, suppressions, baseline.

Design decisions that matter:

- **Stable codes.** Every rule owns one ``PEV###`` code forever; codes are
  never renumbered or reused (the baseline and per-line suppressions key
  on them, and both outlive any refactor of the rule's internals).
- **Line-independent baseline identity.** A baseline entry matches on
  ``(code, path, enclosing-context, normalized source line)`` — NOT on
  the line number — so unrelated edits above a recorded finding don't
  invalidate the baseline. Each entry carries a mandatory one-line
  ``justification``: the baseline is documentation of deliberate
  patterns, not a dumping ground (``--strict`` also fails on *stale*
  entries so the file can only shrink as true positives get fixed).
- **Honest suppression.** ``# pev: ignore[PEV001]`` on the offending line
  (or a standalone comment on the line above) suppresses exactly the
  named codes; a bare ``# pev: ignore`` suppresses everything on that
  line. Suppressions are counted and reported so they stay visible.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a specific location.

    ``context`` is the enclosing qualname (``Class.method``, ``func``, or
    ``""`` at module level); ``key`` is the stripped source line — the
    pair gives the baseline a line-number-independent identity.
    """

    path: str
    line: int
    code: str
    message: str
    context: str = ""
    key: str = ""
    col: int = 0

    @property
    def identity(self) -> tuple:
        return (self.code, self.path, self.context, self.key)

    def location(self) -> str:
        return f"{self.path}:{self.line}"


class Rule:
    """Base class: subclass, set ``code``/``name``/``rationale``, implement
    ``run(ctx)`` yielding ``Finding``s. ``ctx`` is an
    ``engine.ModuleContext`` (parsed tree + source + config + helpers)."""

    code: str = "PEV000"
    codes: tuple = ()  # multi-code rules (lockset) list every code here
    name: str = ""
    rationale: str = ""

    @property
    def all_codes(self) -> tuple:
        return self.codes or (self.code,)

    def run(self, ctx):  # pragma: no cover - interface
        raise NotImplementedError

    def finding(self, ctx, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            path=ctx.relpath, line=line, code=self.code, message=message,
            context=ctx.qualname_at(node), key=ctx.line_key(line),
            col=getattr(node, "col_offset", 0))


_RULES: dict[str, Rule] = {}


def register_rule(cls):
    """Class decorator: instantiate and index by code. Codes are unique —
    a collision is a programming error, not a configuration one."""
    inst = cls()
    assert inst.code not in _RULES, f"duplicate rule code {inst.code}"
    assert re.fullmatch(r"PEV\d{3}", inst.code), inst.code
    _RULES[inst.code] = inst
    return cls


def all_rules() -> dict[str, Rule]:
    # import for side effect: rule modules self-register on first use
    from . import (lockset, rules_determinism, rules_hygiene,  # noqa: F401
                   rules_mp, rules_torch)
    return dict(sorted(_RULES.items()))


# --- suppressions -------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*pev:\s*ignore(\[[^\]\n]*\]?)?")
_CODE_RE = re.compile(r"PEV\d{3}")


def parse_suppressions(source: str) -> dict[int, frozenset | None]:
    """{1-based line: frozenset of codes, or None meaning all codes}.

    A standalone ``# pev: ignore...`` comment line covers the next
    non-comment line too (decorated defs and long calls put the
    interesting token on a line with no room for a trailing comment).

    Fail-closed on malformed code lists: ``ignore[pev001]`` or an
    unclosed ``ignore[PEV001`` suppresses NOTHING (the alternative —
    falling back to suppress-everything — would silently disable the
    whole gate for that line on a typo).
    """
    out: dict[int, frozenset | None] = {}
    lines = source.splitlines()
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        if m.group(1) is not None:
            raw = m.group(1)
            if not raw.endswith("]"):
                continue  # unclosed bracket: malformed, suppress nothing
            tokens = [t.strip() for t in raw[1:-1].split(",")]
            if not tokens or any(not _CODE_RE.fullmatch(t) for t in tokens):
                continue  # bad code spelling: malformed, suppress nothing
            codes = frozenset(tokens)
        else:
            codes = None

        def merge(lineno: int) -> None:
            prev = out.get(lineno, frozenset())
            if codes is None or prev is None:
                out[lineno] = None
            else:
                out[lineno] = prev | codes

        merge(i)
        if text.lstrip().startswith("#"):  # standalone comment: cover below
            j = i + 1
            # skip further comments AND blank lines down to the next code
            # line — a suppression separated from its target by a blank
            # line must still land on the target
            while j <= len(lines) and (
                    lines[j - 1].lstrip().startswith("#")
                    or not lines[j - 1].strip()):
                j += 1
            if j <= len(lines):
                merge(j)
    return out


def is_suppressed(finding: Finding,
                  suppressions: dict[int, frozenset | None]) -> bool:
    codes = suppressions.get(finding.line, frozenset())
    return codes is None or finding.code in codes


# --- baseline -----------------------------------------------------------------

BASELINE_VERSION = 1


@dataclass
class Baseline:
    """Checked-in ledger of pre-existing / deliberate findings.

    ``match(findings)`` partitions into (new, absorbed) and records which
    entries went unused (stale). Every entry must carry a justification —
    ``load`` refuses a baseline that tries to silence findings without
    saying why.
    """

    entries: list[dict] = field(default_factory=list)
    path: str = ""

    @classmethod
    def load(cls, path) -> "Baseline":
        with open(path, encoding="utf-8") as fh:
            blob = json.load(fh)
        assert blob.get("version") == BASELINE_VERSION, \
            f"unknown baseline version {blob.get('version')!r}"
        entries = blob.get("entries", [])
        for e in entries:
            missing = {"code", "path", "context", "key",
                       "justification"} - set(e)
            assert not missing, f"baseline entry missing {sorted(missing)}: {e}"
            assert str(e["justification"]).strip(), \
                f"baseline entry needs a non-empty justification: {e}"
            e.setdefault("count", 1)
        return cls(entries=entries, path=str(path))

    @staticmethod
    def entry_for(finding: Finding, justification: str) -> dict:
        return {"code": finding.code, "path": finding.path,
                "context": finding.context, "key": finding.key,
                "count": 1, "justification": justification}

    def match(self, findings: list[Finding]) -> tuple[list[Finding],
                                                      list[Finding],
                                                      list[dict]]:
        """-> (new_findings, absorbed_findings, stale_entries)."""
        budget: dict[tuple, int] = {}
        for e in self.entries:
            ident = (e["code"], e["path"], e["context"], e["key"])
            budget[ident] = budget.get(ident, 0) + int(e["count"])
        used: dict[tuple, int] = {k: 0 for k in budget}
        new, absorbed = [], []
        for f in sorted(findings):
            ident = f.identity
            if used.get(ident, 0) < budget.get(ident, -1):
                used[ident] += 1
                absorbed.append(f)
            else:
                new.append(f)
        stale = [e for e in self.entries
                 if used.get((e["code"], e["path"], e["context"], e["key"]),
                             0) == 0]
        # multi-count entries partially used still have headroom; an entry
        # is stale only when NOTHING matched its identity (above), so a
        # count that merely shrank keeps the entry alive until hand-pruned.
        return new, absorbed, stale

    def dump(self) -> str:
        return json.dumps(
            {"version": BASELINE_VERSION,
             "entries": sorted(self.entries, key=lambda e: (
                 e["code"], e["path"], e["context"], e["key"]))},
            indent=1, sort_keys=True) + "\n"
