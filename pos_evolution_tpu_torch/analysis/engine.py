"""Analysis driver: file walking, parsed-module context, rule dispatch
(port of ``pos_evolution_tpu/analysis/engine.py``: the same driver, its
scope tables naming the port's modules, and ``ModuleContext.walk`` listing
the tree's nodes once instead of walking the tree again for every call).

One ``ModuleContext`` per file carries everything every rule needs —
the parse tree with parent links, enclosing-scope qualnames, dotted-name
resolution through module aliases, and the per-module scope knobs from
``AnalysisConfig`` — so each rule stays a small, testable visitor.
"""

from __future__ import annotations

import ast
import fnmatch
import os
from dataclasses import dataclass, field

from .core import Finding, all_rules, is_suppressed, parse_suppressions

# Scope tables: which modules are held to which contract. Patterns are
# fnmatch globs over repo-relative posix paths. They name the port's own
# modules, mirroring the JAX package's tables module for module (its
# ``jax_backend.py`` is the port's ``backend/torch_backend.py``); they are
# configuration, not policy baked into the rules.

# PEV002: the seeded stateless decision paths. "strict" modules may not
# touch wall clocks at all (every decision is a pure function of the
# identity); "decision" modules host telemetry timing legitimately, so
# only RNG-cursor / hash-seed nondeterminism is flagged there.
STATELESS_STRICT = (
    "pos_evolution_tpu_torch/sim/faults.py",
    "pos_evolution_tpu_torch/sim/dense_adversary.py",
    "pos_evolution_tpu_torch/sim/adversary.py",
    "pos_evolution_tpu_torch/sim/schedule.py",
    "pos_evolution_tpu_torch/sim/dense_monitors.py",
)
STATELESS_DECISION = (
    "pos_evolution_tpu_torch/sim/driver.py",
    "pos_evolution_tpu_torch/sim/dense_driver.py",
    "pos_evolution_tpu_torch/sim/monitors.py",
    "pos_evolution_tpu_torch/specs/*.py",
    "pos_evolution_tpu_torch/ops/*.py",
    "pos_evolution_tpu_torch/variants/*.py",
    "pos_evolution_tpu_torch/ssz/*.py",
    # the trace-sampling decision (sample/trace_id) is a pure function of
    # (seed, request ordinal); span recording reads the clock
    "pos_evolution_tpu_torch/telemetry/tracing.py",
)

# PEV003: modules whose loops are per-slot / per-message hot paths where
# an accidental device->host sync stalls the launch queue. The multi-GPU
# mode's ``parallel/*.py`` joins them once it exists.
HOT_MODULES = (
    "pos_evolution_tpu_torch/ops/*.py",
    "pos_evolution_tpu_torch/sim/dense_driver.py",
    "pos_evolution_tpu_torch/backend/torch_backend.py",
)

# Lockset scope: the multithreaded tiers (threads are created here or the
# classes are called from them).
THREADED_MODULES = (
    "pos_evolution_tpu_torch/serve/*.py",
    "pos_evolution_tpu_torch/telemetry/*.py",
    "pos_evolution_tpu_torch/resilience/*.py",
    "pos_evolution_tpu_torch/das/server.py",
    "pos_evolution_tpu_torch/utils/watchdog.py",
    "pos_evolution_tpu_torch/utils/singleflight.py",
)

DEFAULT_PATHS = ("pos_evolution_tpu_torch", "chip_smoke.py")

SKIP_DIRS = {"__pycache__", ".git", "bench_trace", "node_modules"}


@dataclass
class AnalysisConfig:
    rules: frozenset | None = None      # None = all registered
    stateless_strict: tuple = STATELESS_STRICT
    stateless_decision: tuple = STATELESS_DECISION
    hot_modules: tuple = HOT_MODULES
    threaded_modules: tuple = THREADED_MODULES
    # tests are analyzed with a narrowed rule set (see __main__)
    extra: dict = field(default_factory=dict)

    def rule_enabled(self, code: str) -> bool:
        return self.rules is None or code in self.rules


def _matches(relpath: str, patterns: tuple) -> bool:
    return any(fnmatch.fnmatch(relpath, p) for p in patterns)


class ModuleContext:
    """Parsed module + the navigation helpers rules share."""

    def __init__(self, source: str, relpath: str,
                 config: AnalysisConfig | None = None):
        self.source = source
        self.relpath = relpath.replace(os.sep, "/")
        self.config = config or AnalysisConfig()
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        self.suppressions = parse_suppressions(source)
        self._nodes: list | None = None
        self._parents: dict[int, ast.AST] = {}
        self._qualnames: dict[int, str] = {}
        self._index(self.tree, None, ())
        self.aliases = self._import_aliases()

    def _import_aliases(self) -> dict[str, str]:
        """Local binding -> canonical dotted origin, from import
        statements: ``import time as _t`` maps ``_t`` -> ``time``,
        ``from torch import compile as C`` maps ``C`` -> ``torch.compile``. Rules
        match on *resolved* names so aliasing can't evade them."""
        out: dict[str, str] = {}
        for node in self.walk((ast.Import, ast.ImportFrom)):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        out[a.asname] = a.name
                    else:
                        out[a.name.split(".")[0]] = a.name.split(".")[0]
            elif node.module and not node.level:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        return out

    def _index(self, node: ast.AST, parent, scope: tuple) -> None:
        if parent is not None:
            self._parents[id(node)] = parent
        self._qualnames[id(node)] = ".".join(scope)
        child_scope = scope
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            child_scope = scope + (node.name,)
        for child in ast.iter_child_nodes(node):
            # the def/class NODE itself belongs to the outer scope; its
            # children (including decorators, which run outside) get the
            # inner qualname — close enough for reporting purposes
            self._index(child, node, child_scope)

    # -- navigation ------------------------------------------------------------

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self._parents.get(id(node))

    def ancestors(self, node: ast.AST):
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def qualname_at(self, node: ast.AST) -> str:
        return self._qualnames.get(id(node), "")

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    _LOOP_TYPES = (ast.For, ast.While, ast.ListComp, ast.SetComp,
                   ast.DictComp, ast.GeneratorExp)

    def enclosing_loop(self, node: ast.AST, stop_at_function: bool = True):
        """Nearest enclosing per-iteration context: for/while loops AND
        comprehensions (a `.item()` in a listcomp syncs per element just
        the same)."""
        for anc in self.ancestors(node):
            if isinstance(anc, self._LOOP_TYPES):
                return anc
            if stop_at_function and isinstance(
                    anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return None
        return None

    def line_key(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    # -- name resolution -------------------------------------------------------

    @staticmethod
    def dotted(node: ast.AST) -> str:
        """'torch.compile' for Attribute/Name chains, '' when not a plain chain."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return ""

    def resolved(self, node: ast.AST) -> str:
        """``dotted`` with the head segment mapped through this module's
        import aliases: ``_t.time`` -> ``time.time``, ``C`` ->
        ``torch.compile``, ``np.random.rand`` -> ``numpy.random.rand``."""
        name = self.dotted(node)
        if not name:
            return name
        head, _, rest = name.partition(".")
        origin = self.aliases.get(head)
        if origin is None:
            return name
        return f"{origin}.{rest}" if rest else origin

    def walk(self, types=None):
        # the tree's nodes in ast.walk order, listed once: every rule walks
        # the whole module, several times each
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        for node in self._nodes:
            if types is None or isinstance(node, types):
                yield node

    # -- scope queries ---------------------------------------------------------

    def in_stateless_strict(self) -> bool:
        return _matches(self.relpath, self.config.stateless_strict)

    def in_stateless_decision(self) -> bool:
        return _matches(self.relpath, self.config.stateless_decision)

    def in_hot_module(self) -> bool:
        return _matches(self.relpath, self.config.hot_modules)

    def in_threaded_module(self) -> bool:
        return _matches(self.relpath, self.config.threaded_modules)


@dataclass
class ModuleResult:
    relpath: str
    findings: list[Finding]
    suppressed: int = 0
    parse_error: str | None = None


def analyze_source(source: str, relpath: str,
                   config: AnalysisConfig | None = None) -> ModuleResult:
    config = config or AnalysisConfig()
    try:
        ctx = ModuleContext(source, relpath, config)
    except SyntaxError as e:  # a file the pass cannot read is a finding
        return ModuleResult(relpath, [Finding(
            path=relpath, line=e.lineno or 1, code="PEV000",
            message=f"syntax error: {e.msg}")], parse_error=str(e))
    raw: list[Finding] = []
    for _code, rule in all_rules().items():
        if any(config.rule_enabled(c) for c in rule.all_codes):
            raw.extend(f for f in rule.run(ctx)
                       if config.rule_enabled(f.code))
    kept, suppressed = [], 0
    for f in sorted(raw):
        if is_suppressed(f, ctx.suppressions):
            suppressed += 1
        else:
            kept.append(f)
    return ModuleResult(ctx.relpath, kept, suppressed=suppressed)


def iter_py_files(paths, root: str = "."):
    for p in paths:
        full = os.path.join(root, p) if not os.path.isabs(p) else p
        if not os.path.exists(full):
            # a typo'ed path must never become a silent '0 files, rc 0'
            # pass — the gate would be a permanent no-op
            raise FileNotFoundError(f"analysis path does not exist: {p!r}")
        if os.path.isfile(full):
            yield full
        elif os.path.isdir(full):
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in SKIP_DIRS)
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        yield os.path.join(dirpath, name)


def analyze_paths(paths=DEFAULT_PATHS, root: str = ".",
                  config: AnalysisConfig | None = None) -> list[ModuleResult]:
    config = config or AnalysisConfig()
    results = []
    for path in iter_py_files(paths, root):
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        results.append(analyze_source(source, relpath, config))
    return results
