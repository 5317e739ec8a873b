"""Hygiene rules: PEV005 (silent except in daemon loops), PEV006
(mutable defaults / lowercase module mutables).

- **PEV005** is PR 12's silent-dead-worker class: a worker thread's loop
  catches an exception and continues with *no* emission — the worker is
  effectively dead-or-degraded and nothing ever says so. The serving
  tier hardened every such loop to either emit telemetry or close/propagate
  loudly; this rule keeps it that way. Only handlers whose body performs
  **no call, no raise, no return, no break** are flagged — a handler that
  reports, closes a connection, or re-raises is doing its job.
- **PEV006** covers the two Python-footgun shapes of shared mutable
  state: a mutable default argument (one object shared across all calls),
  and a *lowercase* module-level mutable mutated from function bodies.
  The codebase's deliberate module singletons (``_KERNEL_CACHE``,
  ``_RULES``) are SCREAMING_SNAKE by convention — that spelling is the
  opt-in marker; a lowercase module global mutated from functions reads
  as local state and gets flagged.
"""

from __future__ import annotations

import ast
import re

from .core import Rule, register_rule

_WORKER_NAME_RE = re.compile(
    r"(_loop|_worker|_drain|_forever|_heartbeat)$")
_THREAD_FACTORIES = frozenset({
    "threading.Thread", "Thread", "threading.Timer", "Timer",
})


def worker_functions(ctx) -> set[str]:
    """Names of functions that run on their own thread: ``Thread(target=
    X)`` / ``Timer(_, X)`` targets plus the ``*_loop``-style naming
    convention. Methods are tracked by bare name (``self._drain`` ->
    ``_drain``)."""
    names: set[str] = set()
    for node in ctx.walk(ast.Call):
        callee = ctx.dotted(node.func)
        target = None
        if callee in _THREAD_FACTORIES:
            kw = next((k for k in node.keywords if k.arg == "target"), None)
            if kw is not None:
                target = kw.value
            elif callee.endswith("Timer") and len(node.args) >= 2:
                target = node.args[1]
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr == "submit" and node.args:
            target = node.args[0]
        if target is not None:
            dotted = ctx.dotted(target)
            if dotted:
                names.add(dotted.rsplit(".", 1)[-1])
    for fn in ctx.walk((ast.FunctionDef, ast.AsyncFunctionDef)):
        if _WORKER_NAME_RE.search(fn.name):
            names.add(fn.name)
    return names


def _handler_is_silent(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Return, ast.Break, ast.Call)):
            return False
        # `except ... as e: self._worker_error = e` captures the exception
        # for later surfacing (the CheckpointManager idiom) — not silent
        if handler.name and isinstance(node, ast.Name) \
                and node.id == handler.name \
                and isinstance(node.ctx, ast.Load):
            return False
    return True


@register_rule
class SilentWorkerExceptRule(Rule):
    """PEV005: except-and-continue in a daemon/worker loop that swallows
    the exception without emitting anything."""

    code = "PEV005"
    name = "silent-worker-except"
    rationale = ("a worker loop that eats exceptions silently is the "
                 "silent-dead-worker class PR 12 hardened against: the "
                 "tier degrades and no event, counter, or log says why")

    def run(self, ctx):
        workers = worker_functions(ctx)
        for fn in ctx.walk((ast.FunctionDef, ast.AsyncFunctionDef)):
            if fn.name not in workers:
                continue
            # a Try nested under several loops must report once, not once
            # per enclosing loop — collect distinct handlers first
            seen: set[int] = set()
            for loop in ast.walk(fn):
                if not isinstance(loop, (ast.While, ast.For)):
                    continue
                for node in ast.walk(loop):
                    if not isinstance(node, ast.Try):
                        continue
                    for handler in node.handlers:
                        if id(handler) in seen:
                            continue
                        seen.add(id(handler))
                        if _handler_is_silent(handler):
                            yield self.finding(
                                ctx, handler,
                                f"worker loop '{fn.name}' swallows an "
                                f"exception with no emission — emit a "
                                f"telemetry event/counter or let it "
                                f"propagate to the supervisor")


_MUTABLE_CALLS = frozenset({
    "dict", "list", "set", "deque", "collections.deque",
    "defaultdict", "collections.defaultdict", "OrderedDict",
    "collections.OrderedDict", "bytearray",
})
_SINGLETON_NAME_RE = re.compile(r"^_?[A-Z][A-Z0-9_]*$")
_MUTATING_METHODS = frozenset({
    "append", "extend", "add", "update", "insert", "remove", "discard",
    "pop", "popleft", "popitem", "appendleft", "clear", "setdefault",
    "sort", "reverse",
})


def _is_mutable_ctor(ctx, node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call)
            and ctx.dotted(node.func) in _MUTABLE_CALLS)


@register_rule
class MutableSharedStateRule(Rule):
    """PEV006: mutable default arguments; lowercase module-level mutables
    mutated from function bodies."""

    code = "PEV006"
    name = "mutable-shared-state"
    rationale = ("a mutable default is one object shared by every call; "
                 "an undeclared module-level mutable is cross-call state "
                 "invisible to checkpoint/resume and to readers "
                 "(deliberate singletons are SCREAMING_SNAKE)")

    def run(self, ctx):
        yield from self._mutable_defaults(ctx)
        yield from self._module_mutables(ctx)

    def _mutable_defaults(self, ctx):
        for fn in ctx.walk((ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            args = fn.args
            for default in list(args.defaults) + [
                    d for d in args.kw_defaults if d is not None]:
                if _is_mutable_ctor(ctx, default):
                    name = getattr(fn, "name", "<lambda>")
                    yield self.finding(
                        ctx, default,
                        f"mutable default argument in '{name}' — one "
                        f"object is shared across every call; default to "
                        f"None and construct inside")

    def _module_mutables(self, ctx):
        mutables: dict[str, ast.AST] = {}
        for stmt in ctx.tree.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
                value = stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets = [stmt.target]
                value = stmt.value
            else:
                continue
            for t in targets:
                if isinstance(t, ast.Name) and _is_mutable_ctor(ctx, value) \
                        and not _SINGLETON_NAME_RE.match(t.id):
                    mutables[t.id] = stmt
        if not mutables:
            return
        mutated: dict[str, int] = {}
        for fn in ctx.walk((ast.FunctionDef, ast.AsyncFunctionDef)):
            shadowed = self._locally_bound(fn)
            for node in ast.walk(fn):
                name, line = self._mutation_of(ctx, node)
                if name in shadowed:
                    continue  # the function's own local, not the global
                if name in mutables and name not in mutated:
                    mutated[name] = line
        for name, line in sorted(mutated.items()):
            stmt = mutables[name]
            yield self.finding(
                ctx, stmt,
                f"lowercase module-level mutable '{name}' is mutated from "
                f"a function (line {line}) — rename to SCREAMING_SNAKE to "
                f"declare the singleton, or move the state into a class")

    @staticmethod
    def _locally_bound(fn) -> set:
        """Names the function binds locally (params, plain-name
        assignments, for-targets, withitems) and does NOT declare
        ``global``: mutations of those are local, whatever the module
        defines under the same name."""
        bound: set[str] = set()
        args = fn.args
        for a in (args.args + args.kwonlyargs + args.posonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            bound.add(a.arg)
        globals_: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                globals_.update(node.names)
            elif isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Store):
                bound.add(node.id)
        return bound - globals_

    @staticmethod
    def _mutation_of(ctx, node: ast.AST) -> tuple[str | None, int]:
        """(mutated module-global name, line) or (None, 0)."""
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATING_METHODS \
                and isinstance(node.func.value, ast.Name):
            return node.func.value.id, node.lineno
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = node.targets if isinstance(node, ast.Assign) else (
                [node.target] if isinstance(node, ast.AugAssign)
                else node.targets)
            for t in targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name):
                    return t.value.id, node.lineno
        return None, 0
