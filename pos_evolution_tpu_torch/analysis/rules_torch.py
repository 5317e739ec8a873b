"""PyTorch/CUDA discipline rules: PEV001, PEV003, PEV004 (the port's
counterpart of ``pos_evolution_tpu/analysis/rules_jax.py``, under the
same codes, so baselines and reports read the same in both packages).

Each mechanizes the port's form of a bug class this repo has paid for:

- **PEV001** — a compiled object built fresh per call. The JAX package's
  form was a per-call ``@jax.jit`` closure in ``reconstruct_check_device``
  (its demo 24.8 s -> 7.6 s once hoisted). The port compiles nothing at run time but its kernels:
  ``ops/kernels.library`` builds each CUDA source once a process (one
  ``nvcc``, ~4 s a source on the H100) and loads it once through
  ``ctypes.CDLL``, memoized in a module mapping; a build, a load, a
  ``torch.compile``, a ``torch.jit`` script or a captured CUDA graph made
  per call pays that again on every call.
- **PEV003** — a host sync inside a per-slot hot loop. ``PERF.md`` blames
  this class for two of the port's slow spots: the state-root update's 78
  host syncs (18.0-37.5 ms against a 4.1-7.1 ms build) and the dense head
  descent, whose launch rate the host sets. A ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize()``,
  an event's or a stream's ``synchronize()``, or ``int()``/``float()``/
  ``bool()``/``np.asarray()`` of a torch expression waits for the card
  every iteration.
- **PEV004** — a CUDA-only feature on a path that also runs on the CPU.
  The JAX package's form was ``donate_argnums`` warning on XLA:CPU. The
  port's tests run it on CPU-only torch, where a ``torch.cuda.*`` call
  (streams, events, graphs, ``memory_stats``) raises and ``pin_memory()``
  or ``non_blocking=True`` raise or mislead; ``telemetry/device.py`` reads
  ``torch.cuda.memory_stats`` only on an initialized CUDA runtime and
  falls back to host RSS, the guard this rule asks for.

The exemptions are the JAX rules': module level, the memoized ``*_for``
builder, ``lru_cache``/``cache``, the SCREAMING_SNAKE (``global``)
singleton, and a helper only called from those; the port adds the module
mapping its kernel loader memoizes into.
"""

from __future__ import annotations

import ast

from .core import Rule, register_rule

# callables whose *call* builds a compiled object (or a captured graph)
_COMPILE_NAMES = frozenset({
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.jit.trace_module", "torch.cuda.CUDAGraph",
    "torch.cuda.make_graphed_callables", "torch.cuda.graphs.CUDAGraph",
    "torch.utils.cpp_extension.load", "torch.utils.cpp_extension.load_inline",
    "cpp_extension.load", "cpp_extension.load_inline",
    "ctypes.CDLL", "ctypes.cdll.LoadLibrary", "CDLL",
})
_COMPILE_BARE_NAMES = frozenset(n.rsplit(".", 1)[-1] for n in _COMPILE_NAMES)
_MEMO_SUFFIXES = ("_for",)
_CACHE_DECORATORS = frozenset({
    "lru_cache", "cache", "functools.lru_cache", "functools.cache",
    "cached_property", "functools.cached_property",
})


def _names_of(ctx, node) -> set:
    """Raw and alias-resolved spellings: matching both defeats
    ``from torch import compile as C`` style aliasing."""
    return {ctx.dotted(node), ctx.resolved(node)} - {""}


def _is_compile_constructor(ctx, node: ast.AST) -> bool:
    """True for ``torch.compile(...)``, ``ctypes.CDLL(...)``, bare
    ``@torch.compile`` / ``@torch.jit.script`` decorator references, and
    ``partial(torch.compile, ...)`` forms."""
    if isinstance(node, ast.Call):
        names = _names_of(ctx, node.func)
        if names & _COMPILE_NAMES:
            return True
        if names & {"partial", "functools.partial"} and node.args:
            return bool(_names_of(ctx, node.args[0]) & _COMPILE_NAMES)
        return False
    return bool(_names_of(ctx, node) & _COMPILE_NAMES)


def _in_decorators(fn, node) -> bool:
    return any(node is d or any(node is sub for sub in ast.walk(d))
               for d in fn.decorator_list)


def _func_chain(ctx, node):
    """Enclosing (non-lambda) function defs, innermost first. A node
    inside a def's decorator list executes in the ENCLOSING scope, so that
    def is excluded from its own decorators' chain."""
    chain = []
    for a in ctx.ancestors(node):
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not chain and _in_decorators(a, node):
                continue
            chain.append(a)
    return chain


def _has_cache_decorator(fn) -> bool:
    from .engine import ModuleContext
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if ModuleContext.dotted(target) in _CACHE_DECORATORS:
            return True
    return False


def _declares_singleton_global(fn) -> bool:
    """``global _LIB`` + write: the function IS the memo for a module
    singleton."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Global) and any(
                n.startswith("_") for n in node.names):
            return True
    return False


def _module_names(ctx) -> set:
    names: set[str] = set()
    for stmt in ctx.tree.body:
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target] if isinstance(stmt, ast.AnnAssign)
                   else [])
        names.update(t.id for t in targets if isinstance(t, ast.Name))
    return names


def _stores_into_module_mapping(ctx, fn) -> bool:
    """The ``ops/kernels.library`` idiom: the function stores what it
    built under a key of a module-level mapping (``_LIBS[source] = lib``),
    so each key is built once a process."""
    module = _module_names(ctx)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                    and t.value.id in module:
                return True
    return False


def _memo_exempt_chain(ctx, chain) -> bool:
    for fn in chain:
        if fn.name.endswith(_MEMO_SUFFIXES):
            return True
        if _has_cache_decorator(fn) or _declares_singleton_global(fn) \
                or _stores_into_module_mapping(ctx, fn):
            return True
    return False


def _references_only_memoized(ctx, fn_name: str, own_def) -> bool:
    """The helper-builder idiom: the function that builds is only ever
    *called* from inside a memoized context (or handed to ``_cached``).
    Zero references = not exempt (the caller is outside our view)."""
    own_nodes = {id(n) for n in ast.walk(own_def)}
    refs = [n for n in ctx.walk(ast.Name)
            if n.id == fn_name and isinstance(n.ctx, ast.Load)
            and id(n) not in own_nodes]
    if not refs:
        return False
    for ref in refs:
        chain = _func_chain(ctx, ref)
        if _memo_exempt_chain(ctx, chain):
            continue
        in_cached_call = any(
            isinstance(a, ast.Call) and ctx.dotted(a.func).endswith("_cached")
            for a in ctx.ancestors(ref))
        if not in_cached_call:
            return False
    return True


@register_rule
class FreshCompiledObjectRule(Rule):
    """PEV001: ``torch.compile`` / ``torch.jit`` / a CUDA graph / a
    kernel library build or load constructed inside a function or loop
    body without memoization."""

    code = "PEV001"
    name = "fresh-compiled-object"
    rationale = ("a compiled object built per call is built again on every "
                 "call: an nvcc build is ~4 s a source on the H100, a "
                 "torch.compile or a graph capture recompiles or recaptures "
                 "(a per-call jax.jit closure cost the JAX package's demo 3.3x)")

    def run(self, ctx):
        seen = set()
        for node in ctx.walk((ast.Call, ast.Attribute, ast.Name)):
            if not _is_compile_constructor(ctx, node):
                continue
            # a bare Name/Attribute only matters as a decorator reference
            if not isinstance(node, ast.Call):
                parent = ctx.parent(node)
                if not (isinstance(parent, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                        and node in parent.decorator_list):
                    continue
            # the inner name of partial(torch.compile, ...): the Call case
            # already reports the partial itself
            parent = ctx.parent(node)
            if (isinstance(parent, ast.Call) and node in parent.args
                    and _is_compile_constructor(ctx, parent)):
                continue
            chain = _func_chain(ctx, node)
            # a shim DEFINING one of the constructor names is a
            # pass-through: its callers are the audit sites
            if chain and any(fn.name in _COMPILE_BARE_NAMES for fn in chain):
                continue
            if not chain:
                if ctx.enclosing_loop(node, stop_at_function=False) is None:
                    continue  # module level, outside any loop: the idiom
                outer = None
            else:
                outer = chain[-1]
            if chain and _memo_exempt_chain(ctx, chain):
                continue
            if outer is not None and _references_only_memoized(
                    ctx, outer.name, outer):
                continue
            # one finding per decorated def, not one per stacked decorator
            decorated = next(
                (a for a in ctx.ancestors(node)
                 if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
                 and _in_decorators(a, node)), None)
            key = ("deco", id(decorated)) if decorated is not None \
                else ("line", node.lineno)
            if key in seen:
                continue
            seen.add(key)
            where = chain[0].name if chain else "module loop"
            yield self.finding(
                ctx, node,
                f"compiled object (torch.compile / torch.jit / CUDA graph / "
                f"kernel library) constructed in '{where}' — hoist to module "
                f"level or memoize it (built again on every call otherwise)")


_TORCH_HINTS = frozenset({"torch"})
# methods that copy a tensor to the host or wait for the card
_SYNC_METHODS = {"item": ".item() sync", "tolist": ".tolist() sync",
                 "cpu": ".cpu() copy to the host", "numpy": ".numpy() sync"}


def _mentions_torch(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Name) and n.id in _TORCH_HINTS
               for n in ast.walk(node))


def _names_cpu(node: ast.AST) -> bool:
    """``"cpu"``, or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (isinstance(node, ast.Call) and bool(node.args)
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


@register_rule
class HostSyncInHotLoopRule(Rule):
    """PEV003: host-device synchronization inside a per-slot hot loop."""

    code = "PEV003"
    name = "host-sync-in-hot-loop"
    rationale = ("`.item()`/`.tolist()`/`.cpu()`/`synchronize()` inside a "
                 "hot loop waits for the card every iteration: the launch "
                 "queue drains and the host sets the pace (the state-root "
                 "update's 78 host syncs, PERF.md)")

    def run(self, ctx):
        if not ctx.in_hot_module():
            return
        for node in ctx.walk(ast.Call):
            if ctx.enclosing_loop(node) is None:
                continue
            name = ctx.dotted(node.func)
            names = _names_of(ctx, node.func)
            attr = node.func.attr if isinstance(node.func, ast.Attribute) \
                else None
            hit = None
            if attr in _SYNC_METHODS and not node.args \
                    and (attr != "cpu" or not node.keywords):
                # one sync a chain: ``t.cpu().numpy()`` reports its
                # ``.cpu()``, not the ``.numpy()`` of the host copy too
                inner = node.func.value
                if not (isinstance(inner, ast.Call)
                        and isinstance(inner.func, ast.Attribute)
                        and inner.func.attr in _SYNC_METHODS):
                    hit = _SYNC_METHODS[attr]
            elif attr == "synchronize":
                hit = f"{name or 'synchronize'}() sync"
            elif attr == "to" and (
                    any(_names_cpu(a) for a in node.args)
                    or any(k.arg == "device" and _names_cpu(k.value)
                           for k in node.keywords)):
                hit = '.to("cpu") copy to the host'
            elif name in ("float", "int", "bool") and node.args \
                    and _mentions_torch(node.args[0]):
                hit = f"{name}() on a torch expression"
            elif names & {"np.asarray", "numpy.asarray", "np.array",
                          "numpy.array"} and node.args \
                    and _mentions_torch(node.args[0]):
                hit = "np.asarray of a torch expression"
            if hit:
                yield self.finding(
                    ctx, node,
                    f"{hit} inside a hot loop — pull the value once "
                    f"outside the loop or keep the reduction on the card")


# torch.cuda entries that are safe on CPU-only torch (they are the guard)
_CUDA_SAFE = frozenset({
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.is_initialized",
})
_GUARD_PARAMS = frozenset({"cuda", "on_cuda", "use_cuda"})


def _device_only_use(ctx, node: ast.Call) -> str | None:
    resolved = ctx.resolved(node.func)
    if resolved.startswith("torch.cuda.") and resolved not in _CUDA_SAFE:
        return f"{resolved}()"
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr == "pin_memory":
        return "pin_memory()"
    for k in node.keywords:
        if k.arg == "non_blocking" and isinstance(k.value, ast.Constant) \
                and k.value.value is True:
            return "non_blocking=True"
    if any(k.arg == "pin_memory" and isinstance(k.value, ast.Constant)
           and k.value.value is True for k in node.keywords):
        return "pin_memory=True"
    return None


def _is_device_check(ctx, node: ast.AST) -> bool:
    """A device-type check: ``x.type == "cuda"``, ``x.is_cuda``,
    ``torch.cuda.is_available()``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in ("is_cuda",
                                                           "is_available"):
            return True
        if isinstance(sub, ast.Compare):
            parts = [sub.left, *sub.comparators]
            if any(isinstance(p, ast.Attribute) and p.attr == "type"
                   for p in parts) and any(
                    isinstance(p, ast.Constant) and p.value in ("cuda", "cpu")
                    for p in parts):
                return True
    return False


@register_rule
class UnguardedDeviceOnlyRule(Rule):
    """PEV004: a CUDA-only call (``torch.cuda.*``, ``pin_memory``,
    ``non_blocking=True``) without the guard for the CPU path."""

    code = "PEV004"
    name = "unguarded-device-only"
    rationale = ("the port's CPU tests run it on CPU-only torch, where a "
                 "torch.cuda call raises and pin_memory/non_blocking raise "
                 "or mislead; the codebase guards them on the device type "
                 "(telemetry/device.py's memory_stats)")

    def run(self, ctx):
        # a real is_available USE in code, not a docstring mention: the
        # module selects its CUDA and CPU forms at run time
        module_guarded = any(
            (isinstance(n, ast.Attribute) and n.attr == "is_available")
            or (isinstance(n, ast.Name) and n.id == "is_available")
            for n in ctx.walk((ast.Attribute, ast.Name)))
        if module_guarded:
            return
        for node in ctx.walk(ast.Call):
            what = _device_only_use(ctx, node)
            if what is None:
                continue
            # an enclosing if / conditional expression that tests the
            # device, inline
            if any(isinstance(a, (ast.If, ast.IfExp, ast.While))
                   and _is_device_check(ctx, a.test)
                   for a in ctx.ancestors(node)):
                continue
            chain = _func_chain(ctx, node)
            if any(a.arg in _GUARD_PARAMS
                   for fn in chain
                   for a in (fn.args.args + fn.args.kwonlyargs)):
                continue  # the caller decides, like the JAX rule's donate=
            # a function that checks its device's type guards its body (an
            # early return on the CPU, or a branch the call sits behind)
            if any(_is_device_check(ctx, fn) for fn in chain):
                continue
            yield self.finding(
                ctx, node,
                f"{what} without a CPU-path guard — check the device's "
                f"type, torch.cuda.is_available(), or take a `cuda` flag "
                f"the device-aware caller sets")
