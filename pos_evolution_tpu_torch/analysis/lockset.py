"""Lockset thread-safety analyzer: PEV101 (unlocked read-modify-write)
and PEV102 (inconsistent locking discipline).

The PR 12 review found the same race twice in one afternoon:
``MetricsRegistry._get`` created two metric objects for one name under
concurrent first touch, and the admission queue's shed counters lost
increments — both the shape ``self.x = f(self.x, ...)`` executed from N
threads with no lock. This analyzer mechanizes exactly that class for
the codebase's locking idiom, which is deliberately narrow:

- every thread-shared class owns one ``threading.Lock``/``Condition``
  stored on ``self`` (name contains ``lock`` or ``cond``);
- critical sections are lexical ``with self._lock:`` blocks (no bare
  ``acquire``/``release`` pairs);
- a class that owns a lock is *declaring itself thread-shared*: every
  public method may run on any thread (the registry's callers are in
  other modules — worker threads the intra-package call graph cannot
  see), so consistency is demanded class-wide, not only on paths from
  discovered ``Thread(target=...)`` entry points;
- a class with **no** lock is analyzed only if one of its methods is a
  discovered thread entry point (``threading.Thread(target=self._x)``,
  ``Timer``, ``executor.submit``) — then every reachable
  read-modify-write is by definition unlocked.

Soundness boundary (DESIGN.md §21): callers that hold the lock while
calling a private helper are credited via a fixed-point "always called
locked" pass over in-class call sites; methods named ``*_locked`` are
trusted by convention. What the analyzer does NOT try to prove: aliasing
through locals, multi-lock protocols, or happens-before through queues —
none of which the codebase uses on purpose.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from .core import Rule, register_rule
from .rules_hygiene import _MUTATING_METHODS

_LOCKISH_ATTR_RE = re.compile(r"(lock|cond|mutex)", re.IGNORECASE)
_LOCK_CTORS = ("Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore")
_THREAD_FACTORIES = frozenset({
    "threading.Thread", "Thread", "threading.Timer", "Timer",
})
# read-only / publish-only attrs by convention: not state
_IGNORED_ATTRS_RE = re.compile(r"^(__|_abc_)")


def _self_attr(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


@dataclass
class _Access:
    method: str
    line: int
    node: ast.AST
    kind: str       # "read" | "store" | "rmw"
    locked: bool


@dataclass
class _ClassInfo:
    node: ast.ClassDef
    methods: dict = field(default_factory=dict)   # name -> FunctionDef
    lock_attrs: set = field(default_factory=set)
    thread_targets: set = field(default_factory=set)
    accesses: dict = field(default_factory=dict)  # attr -> [_Access]
    init_only: set = field(default_factory=set)


def _collect_classes(ctx) -> list[_ClassInfo]:
    """Classes with same-module single-inheritance flattening: a subclass
    sees its base's methods and lock attrs (``Gauge(_Metric)`` inherits
    ``_Metric._lock``), overrides winning by name."""
    by_name: dict[str, ast.ClassDef] = {}
    for node in ctx.walk(ast.ClassDef):
        by_name[node.name] = node

    def own_methods(cls: ast.ClassDef) -> dict:
        return {n.name: n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    infos = []
    for cls in by_name.values():
        info = _ClassInfo(node=cls)
        chain, cur = [], cls
        while cur is not None and cur not in chain:
            chain.append(cur)
            base = next((ctx.dotted(b) for b in cur.bases
                         if ctx.dotted(b) in by_name), None)
            cur = by_name.get(base) if base else None
        for klass in reversed(chain):  # base first, overrides win
            info.methods.update(own_methods(klass))
        infos.append(info)
    return infos


def _lock_attrs_of(info: _ClassInfo, ctx) -> set:
    attrs = set()
    for fn in info.methods.values():
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    name = _self_attr(t)
                    if name and isinstance(node.value, ast.Call):
                        callee = ctx.dotted(node.value.func)
                        if callee.rsplit(".", 1)[-1] in _LOCK_CTORS:
                            attrs.add(name)
            elif isinstance(node, ast.With):
                for item in node.items:
                    name = _self_attr(item.context_expr)
                    if name and _LOCKISH_ATTR_RE.search(name):
                        attrs.add(name)  # used as a lock = is a lock
    return attrs


def _thread_targets_of(ctx) -> set:
    """Bare method/function names handed to Thread/Timer/submit anywhere
    in the module (the spawn may live in another class)."""
    targets = set()
    for node in ctx.walk(ast.Call):
        callee = ctx.dotted(node.func)
        cand = None
        if callee in _THREAD_FACTORIES:
            kw = next((k for k in node.keywords if k.arg == "target"), None)
            if kw is not None:
                cand = kw.value
            elif callee.endswith("Timer") and len(node.args) >= 2:
                cand = node.args[1]
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr == "submit" and node.args:
            cand = node.args[0]
        if cand is not None:
            dotted = ctx.dotted(cand)
            if dotted:
                targets.add(dotted.rsplit(".", 1)[-1])
    return targets


def _local_lock_aliases(method: ast.AST, lock_attrs: set) -> set:
    """Local names bound from the class's own lock (`lock = self._lock`)
    — the one-hop alias a drain loop uses. Only a VERIFIED alias counts:
    crediting any lockish-looking name would let `with other_lock:`
    (the wrong lock — the classic race) pass silently."""
    aliases = set()
    for node in ast.walk(method):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and _self_attr(node.value) in lock_attrs:
            aliases.add(node.targets[0].id)
    return aliases


def _is_locked_at(ctx, node: ast.AST, lock_attrs: set,
                  method: ast.AST) -> bool:
    """Lexically dominated by ``with self.<lock>`` (or a verified local
    alias of it) within ``method``."""
    aliases = _local_lock_aliases(method, lock_attrs)
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                name = _self_attr(item.context_expr)
                if name in lock_attrs:
                    return True
                if isinstance(item.context_expr, ast.Name) \
                        and item.context_expr.id in aliases:
                    return True
        if anc is method:
            break
    return False


def _rhs_reads_attr(node: ast.AST, attr: str) -> bool:
    for sub in ast.walk(node):
        if _self_attr(sub) == attr and isinstance(
                getattr(sub, "ctx", None), ast.Load):
            return True
    return False


def _classify_accesses(ctx, info: _ClassInfo) -> None:
    for mname, fn in info.methods.items():
        for node in ast.walk(fn):
            # a chained assignment (`self.a = self.b = ...`) records EVERY
            # target — collect (attr, kind) pairs, not a single slot
            hits: list[tuple[str, str]] = []
            attr, kind = None, None
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    a = _self_attr(t)
                    if a:
                        hits.append((a, "rmw" if _rhs_reads_attr(
                            node.value, a) else "store"))
                    elif isinstance(t, ast.Subscript):
                        a = _self_attr(t.value)
                        if a:
                            hits.append((a, "rmw"))  # container write
            elif isinstance(node, ast.AugAssign):
                a = _self_attr(node.target)
                if a is None and isinstance(node.target, ast.Subscript):
                    a = _self_attr(node.target.value)
                if a:
                    attr, kind = a, "rmw"
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATING_METHODS:
                a = _self_attr(node.func.value)
                if a:
                    attr, kind = a, "rmw"
            elif isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load):
                a = _self_attr(node)
                if a:
                    attr, kind = a, "read"
            if attr is not None:
                hits.append((attr, kind))
            for attr, kind in hits:
                if attr in info.lock_attrs or _IGNORED_ATTRS_RE.match(attr):
                    continue
                info.accesses.setdefault(attr, []).append(_Access(
                    method=mname, line=node.lineno, node=node, kind=kind,
                    locked=_is_locked_at(ctx, node, info.lock_attrs, fn)))


def _always_locked_methods(ctx, info: _ClassInfo) -> set:
    """Fixed point over in-class call sites: a leading-underscore method
    every one of whose ``self._m(...)`` call sites is lock-dominated (or
    inside an already always-locked method) is credited as locked.
    ``*_locked`` names are trusted by convention."""
    locked = {m for m in info.methods if m.endswith("_locked")}
    call_sites: dict[str, list] = {}
    for mname, fn in info.methods.items():
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                callee = _self_attr(node.func)
                if callee in info.methods:
                    call_sites.setdefault(callee, []).append((mname, fn, node))
    for _ in range(4):  # tiny graphs; fixpoint in <= depth iterations
        grew = False
        for mname in info.methods:
            if mname in locked or not mname.startswith("_") \
                    or mname.startswith("__"):
                continue
            sites = call_sites.get(mname)
            if not sites:
                continue
            if all(caller in locked
                   or _is_locked_at(ctx, node, info.lock_attrs, fn)
                   for caller, fn, node in sites):
                locked.add(mname)
                grew = True
        if not grew:
            break
    return locked


def _reachable_from_targets(info: _ClassInfo) -> set:
    """Closure of the class's thread entry points over self-calls."""
    edges: dict[str, set] = {m: set() for m in info.methods}
    for mname, fn in info.methods.items():
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                callee = _self_attr(node.func)
                if callee in info.methods:
                    edges[mname].add(callee)
    seen, frontier = set(), [t for t in info.thread_targets
                            if t in info.methods]
    while frontier:
        m = frontier.pop()
        if m in seen:
            continue
        seen.add(m)
        frontier.extend(edges.get(m, ()))
    return seen


@register_rule
class LocksetRule(Rule):
    """PEV101/PEV102: lockset analysis over the multithreaded tiers."""

    code = "PEV101"
    codes = ("PEV101", "PEV102")
    name = "lockset"
    rationale = ("unlocked read-modify-writes from thread-reachable code "
                 "lose updates (the PR 12 MetricsRegistry._get and "
                 "shed-counter races); inconsistent discipline means the "
                 "lock protects nothing")

    def run(self, ctx):
        if not ctx.in_threaded_module():
            return
        module_targets = _thread_targets_of(ctx)
        for info in _collect_classes(ctx):
            info.lock_attrs = _lock_attrs_of(info, ctx)
            info.thread_targets = {t for t in module_targets
                                   if t in info.methods}
            if not info.lock_attrs and not info.thread_targets:
                continue
            _classify_accesses(ctx, info)
            locked_methods = _always_locked_methods(ctx, info)
            if info.lock_attrs:
                shared_methods = set(info.methods)  # lock declares sharing
            else:
                shared_methods = _reachable_from_targets(info)
            yield from self._judge(ctx, info, shared_methods,
                                   locked_methods)

    def _judge(self, ctx, info, shared_methods, locked_methods):
        for attr, accesses in sorted(info.accesses.items()):
            writes = [a for a in accesses if a.kind in ("store", "rmw")
                      and a.method not in ("__init__", "__new__")]
            if not writes:
                continue
            protected = [a for a in accesses
                         if a.locked or a.method in locked_methods]
            exposed = [a for a in writes
                       if a.method in shared_methods
                       and not a.locked and a.method not in locked_methods]
            cls = info.node.name
            for a in exposed:
                if a.kind == "rmw":
                    yield self._as("PEV101").finding(
                        ctx, a.node,
                        f"unlocked read-modify-write of 'self.{attr}' in "
                        f"{cls}.{a.method} — concurrent callers lose "
                        f"updates; wrap in `with "
                        f"self.{self._lock_name(info)}:`")
                elif protected:
                    yield self._as("PEV102").finding(
                        ctx, a.node,
                        f"'self.{attr}' is written without the lock in "
                        f"{cls}.{a.method} but accessed under it elsewhere "
                        f"— inconsistent discipline; lock it or document "
                        f"the atomic-publish intent with a suppression")

    @staticmethod
    def _lock_name(info: _ClassInfo) -> str:
        return sorted(info.lock_attrs)[0] if info.lock_attrs else "_lock"

    def _as(self, code: str):
        """A lightweight view of this rule reporting under ``code``
        (PEV101 and PEV102 share one analysis)."""
        view = object.__new__(LocksetRule)
        view.__dict__ = dict(self.__dict__)
        view.code = code
        return view
