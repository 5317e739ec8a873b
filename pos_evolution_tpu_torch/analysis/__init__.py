"""Consensus-grade static analysis of the PyTorch/CUDA port (port of
``pos_evolution_tpu/analysis``): the JAX package's reviewed-out bug
classes as a mechanical, CI-gated pass over ``pos_evolution_tpu_torch/``
and ``chip_smoke.py``.

The shared rules are copies of the JAX package's (``core``, ``lockset``,
``rules_determinism``, ``rules_hygiene``, ``rules_mp``, ``report``; only
``core``'s rule list names ``rules_torch`` for ``rules_jax``), and they
give identical findings under one ``AnalysisConfig``. ``engine``'s scope
tables name the port's modules. ``rules_torch`` holds the torch forms of
the three compilation-discipline rules under the JAX codes, so baselines
and reports read the same in both packages:

- a compiled object built per call (``torch.compile``, ``torch.jit``, a
  captured CUDA graph, a kernel library's build or ``ctypes.CDLL`` load);
- a host sync in a hot loop (``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.to("cpu")``, ``synchronize()``, ``int()``/``float()``/
  ``bool()`` of a torch expression);
- a CUDA-only call on a path that also runs on the CPU.

Everything is pure stdlib ``ast``: the pass imports nothing from the
analyzed tree, neither torch nor jax, so it runs wherever Python runs.

Entry points::

    python -m pos_evolution_tpu_torch.analysis --strict   # gate the port
    python -m pos_evolution_tpu_torch.analysis --doctor   # self-test negative

Rule index (full rationale per rule in its docstring):

==========  ==================================================================
PEV001      compiled object (torch.compile / jit / CUDA graph / kernel
            library) built per call
PEV002      nondeterminism reachable from seeded stateless paths
PEV003      host-device sync inside per-slot hot loops
PEV004      CUDA-only call without the guard for the CPU path
PEV005      except-and-continue that swallows errors in daemon loops
PEV006      mutable default args / lowercase module mutables
PEV007      fork-unsafety: fork-start amid threads; pre-fork locks in child entries
PEV101      unlocked read-modify-write on a shared instance attribute
PEV102      inconsistent locking discipline on a shared instance attribute
==========  ==================================================================
"""

from .core import (  # noqa: F401
    Baseline,
    Finding,
    Rule,
    all_rules,
    parse_suppressions,
    register_rule,
)
from .engine import AnalysisConfig, analyze_paths, analyze_source  # noqa: F401
from .report import render_json, render_text  # noqa: F401

__all__ = [
    "AnalysisConfig",
    "Baseline",
    "Finding",
    "Rule",
    "all_rules",
    "analyze_paths",
    "analyze_source",
    "parse_suppressions",
    "register_rule",
    "render_json",
    "render_text",
]
