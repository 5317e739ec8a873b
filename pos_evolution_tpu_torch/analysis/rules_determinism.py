"""PEV002: nondeterminism reachable from the seeded stateless paths.

PR 13's contract: every fault / adversary / monitor decision in the dense
tier is a **pure function of its identity** — ``stateless_unit(seed,
*key)`` over blake2b, no RNG cursor, no wall clock — which is what makes
runs byte-stable across backends, mesh shapes, and checkpoint/resume.
One ``time.time()`` or global-``random`` draw inside those paths breaks
replayable chaos bundles, the bit-identical-resume pins, and the
cross-mesh twin matrix all at once, usually in a way no single test
catches (the run is still *plausible*, just no longer reproducible).

Scope is configured per module class (``engine.AnalysisConfig``):

- **strict** modules (``sim/faults.py``, ``sim/dense_adversary.py``, …)
  host only decision logic: any wall-clock, RNG-cursor, hash-seed, or
  set-iteration-order dependence is flagged;
- **decision** modules (the drivers, specs, ops) legitimately measure
  wall time for telemetry, so clocks pass but RNG cursors / ``os.urandom``
  / unseeded generators are still flagged.
"""

from __future__ import annotations

import ast

from .core import Rule, register_rule

_CLOCK_CALLS = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow", "datetime.date.today", "date.today",
})

_ENTROPY_CALLS = frozenset({
    "os.urandom", "uuid.uuid1", "uuid.uuid4",
})
_ENTROPY_PREFIXES = ("secrets.",)

# the global-cursor RNG surfaces; seeded Generators are fine.
# jax.random is deliberately ABSENT: it is functional (every draw takes
# an explicit key, there is no global cursor to ride), so keyed
# jax.random.* in ops/ and the drivers is the idiomatic deterministic
# pattern, not a violation.
_RNG_PREFIXES = ("random.", "np.random.", "numpy.random.")
_RNG_SEEDED_OK = frozenset({
    "np.random.default_rng", "numpy.random.default_rng",
    "np.random.Generator", "numpy.random.Generator",
    "np.random.SeedSequence", "numpy.random.SeedSequence",
    "np.random.RandomState", "numpy.random.RandomState",
})


def _rng_violation(name: str, node: ast.Call) -> str | None:
    if name in _ENTROPY_CALLS or name.startswith(_ENTROPY_PREFIXES):
        return f"{name}() draws OS entropy"
    if name in _RNG_SEEDED_OK:
        if not node.args and not node.keywords:
            return (f"{name}() without a seed falls back to OS entropy — "
                    f"thread the run seed through")
        return None
    if name.startswith(_RNG_PREFIXES):
        # random.Random(seed) is a seeded instance; bare module-level
        # draws (random.random, np.random.rand, ...) ride the global
        # cursor whose state depends on call order across the process
        if name in ("random.Random",) and (node.args or node.keywords):
            return None
        return f"{name}() rides a global RNG cursor (call-order dependent)"
    return None


@register_rule
class NondeterminismRule(Rule):
    """PEV002: wall-clock / RNG-cursor / iteration-order nondeterminism
    in modules bound by the seeded stateless contract."""

    code = "PEV002"
    name = "stateless-path-nondeterminism"
    rationale = ("seeded stateless paths must be byte-stable across "
                 "backends, mesh shapes, and resume (PR 13 "
                 "stateless_unit_array contract); a clock or RNG cursor "
                 "breaks replayable chaos bundles silently")

    def run(self, ctx):
        strict = ctx.in_stateless_strict()
        decision = ctx.in_stateless_decision()
        if not (strict or decision):
            return
        for node in ctx.walk(ast.Call):
            name = ctx.dotted(node.func)
            if not name:
                continue
            # match on the raw AND the alias-resolved spelling so
            # `import time as _t; _t.time()` cannot evade the contract
            resolved = ctx.resolved(node.func)
            rng = _rng_violation(name, node)
            if rng is None and resolved != name:
                rng = _rng_violation(resolved, node)
            if rng is not None:
                yield self.finding(
                    ctx, node,
                    f"{rng} — use sim.faults.stateless_unit/"
                    f"stateless_unit_array keyed on the decision identity")
            elif strict and (name in _CLOCK_CALLS
                             or resolved in _CLOCK_CALLS):
                yield self.finding(
                    ctx, node,
                    f"{name}() reads the wall clock in a stateless "
                    f"decision module — decisions must be pure functions "
                    f"of (seed, identity)")
            elif strict and name == "hash" and node.args:
                yield self.finding(
                    ctx, node,
                    "builtin hash() is salted per process "
                    "(PYTHONHASHSEED) — use hashlib.blake2b via "
                    "stateless_word for stable digests")
        if strict:
            yield from self._set_iteration(ctx)

    def _set_iteration(self, ctx):
        """Iterating a set feeds its (hash-salted for str keys) order into
        whatever consumes the loop — message ordering, digest input."""
        def is_set_expr(node):
            return isinstance(node, (ast.Set, ast.SetComp)) or (
                isinstance(node, ast.Call)
                and ctx.dotted(node.func) in ("set", "frozenset"))

        for node in ctx.walk((ast.For, ast.comprehension)):
            if is_set_expr(node.iter):
                yield self.finding(
                    ctx, node.iter,
                    "iteration over a set in a stateless decision module — "
                    "order is hash-salted for str elements; sort or use a "
                    "list/dict")
