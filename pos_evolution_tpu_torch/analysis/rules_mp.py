"""PEV007: fork-unsafety across the process boundary.

The multi-process serving plane (PR 16) made process workers a
first-class part of the runtime, and the bug class that comes with them
is *fork inheriting a threaded parent's synchronization state*:

- **fork-start in a thread-running module.** ``fork`` duplicates the
  parent's memory image but only the calling thread survives in the
  child. Any lock held by another thread at fork time is copied *locked
  forever* — the child deadlocks the first time it touches it. A module
  that starts threads AND uses fork-start multiprocessing (explicitly
  via ``get_context("fork")`` / ``set_start_method("fork")``, or
  implicitly via bare ``multiprocessing.Process`` — the POSIX default)
  is exactly that trap. The fix is an explicit spawn context, which is
  what ``serve.workers`` uses.
- **pre-fork state referenced by a child entry point.** A
  ``threading.Lock`` / ``Condition`` (or a mutable registry) created in
  the parent and then touched from a ``Process(target=...)`` entry
  function is state that silently crossed the process boundary: under
  spawn it is a *different object* in the child (the "shared" registry
  shares nothing), under fork it may arrive already held. Either way
  the code reads as shared and is not. A deliberate, documented handoff
  opts out with ``# pev: ignore[PEV007]`` on the reference (or a
  justified baseline entry).
"""

from __future__ import annotations

import ast

from .core import Rule, register_rule

_THREAD_CTORS = frozenset({
    "threading.Thread", "threading.Timer",
    "concurrent.futures.ThreadPoolExecutor",
})
_FORK_PICKERS = frozenset({
    "multiprocessing.get_context", "multiprocessing.set_start_method",
})
# bare uses inherit the platform default start method (fork on POSIX)
_DEFAULT_START_CTORS = frozenset({
    "multiprocessing.Process", "multiprocessing.Pool",
})
_LOCK_CTORS = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Event", "threading.Semaphore",
    "threading.BoundedSemaphore", "threading.Barrier",
})


def _child_entry_names(ctx) -> set[str]:
    """Bare names of functions handed to a ``*Process(target=...)``
    call — the code that will run on the child side of the boundary."""
    names: set[str] = set()
    for node in ctx.walk(ast.Call):
        dotted = ctx.dotted(node.func)
        if not (dotted == "Process" or dotted.endswith(".Process")):
            continue
        kw = next((k for k in node.keywords if k.arg == "target"), None)
        if kw is not None:
            target = ctx.dotted(kw.value)
            if target:
                names.add(target.rsplit(".", 1)[-1])
    return names


@register_rule
class ForkUnsafetyRule(Rule):
    """PEV007: fork-start multiprocessing in thread-running modules;
    parent-created locks/registries referenced from child entries."""

    code = "PEV007"
    name = "fork-unsafety"
    rationale = ("fork in a threaded parent copies locks in whatever "
                 "state some other thread held them — the child "
                 "deadlocks on first acquire; and parent-created "
                 "locks/registries referenced from a Process target are "
                 "state that silently crossed the process boundary")

    def run(self, ctx):
        starts_threads = any(
            ctx.resolved(node.func) in _THREAD_CTORS
            for node in ctx.walk(ast.Call))
        yield from self._fork_starts(ctx, starts_threads)
        yield from self._boundary_crossings(ctx)

    # -- shape 1: fork-start where threads run ---------------------------------

    def _fork_starts(self, ctx, starts_threads: bool):
        if not starts_threads:
            return
        for node in ctx.walk(ast.Call):
            resolved = ctx.resolved(node.func)
            if resolved in _FORK_PICKERS and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and node.args[0].value == "fork":
                yield self.finding(
                    ctx, node,
                    "fork-start multiprocessing in a module that starts "
                    "threads — fork copies other threads' held locks "
                    "into the child locked forever; use "
                    "get_context(\"spawn\")")
            elif resolved in _DEFAULT_START_CTORS:
                yield self.finding(
                    ctx, node,
                    f"bare {resolved.rsplit('.', 1)[-1]}() in a module "
                    f"that starts threads inherits the platform default "
                    f"start method (fork on POSIX) — take an explicit "
                    f"spawn context instead")

    # -- shape 2: parent state referenced from a child entry -------------------

    def _boundary_crossings(self, ctx):
        entries = _child_entry_names(ctx)
        if not entries:
            return
        module_locks = self._module_lock_names(ctx)
        for fn in ctx.walk((ast.FunctionDef, ast.AsyncFunctionDef)):
            if fn.name not in entries:
                continue
            attr_locks = self._class_lock_attrs(ctx, fn)
            reported: set[str] = set()
            for node in ast.walk(fn):
                name = None
                if isinstance(node, ast.Name) \
                        and isinstance(node.ctx, ast.Load) \
                        and node.id in module_locks:
                    name = node.id
                elif isinstance(node, ast.Attribute) \
                        and isinstance(node.ctx, ast.Load) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id == "self" \
                        and node.attr in attr_locks:
                    name = f"self.{node.attr}"
                if name is None or name in reported:
                    continue
                reported.add(name)
                yield self.finding(
                    ctx, node,
                    f"child entry '{fn.name}' references parent-created "
                    f"lock '{name}' across the process boundary — under "
                    f"spawn it is a different object, under fork it may "
                    f"arrive held; create it in the child or document "
                    f"the handoff")

    @staticmethod
    def _module_lock_names(ctx) -> set[str]:
        names: set[str] = set()
        for stmt in ctx.tree.body:
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            if isinstance(value, ast.Call) \
                    and ctx.resolved(value.func) in _LOCK_CTORS:
                names.update(t.id for t in targets
                             if isinstance(t, ast.Name))
        return names

    @staticmethod
    def _class_lock_attrs(ctx, fn) -> set[str]:
        """Lock-valued ``self.X`` attributes assigned anywhere in the
        class that owns ``fn`` (``__init__`` runs in the parent; the
        child entry method sees the copies)."""
        cls = next((a for a in ctx.ancestors(fn)
                    if isinstance(a, ast.ClassDef)), None)
        if cls is None:
            return set()
        attrs: set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call) \
                    and ctx.resolved(node.value.func) in _LOCK_CTORS:
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        attrs.add(t.attr)
        return attrs
