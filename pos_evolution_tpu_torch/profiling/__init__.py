"""Profiling subsystem (port of ``pos_evolution_tpu/profiling``): where did
the device time and bytes go — and is it drifting?

Four legs, one pipeline (capture → attribute → export → gate):

- **device-time attribution** (``kineto.py`` + ``xplane.py`` +
  ``attribution.py``): torch.profiler's Kineto traces read into the JAX
  package's plane schema, each kernel named by the path of the host
  ranges and operator that launched it, plus ``ProfiledRegion``, a
  context manager that wraps any sim/bench section in a
  ``torch.profiler`` session and attributes device time back to the
  telemetry spans / host ranges that launched it;
- **work & memory tables** (``cost.py``): per-hot-path work (counted
  from shapes), argument/output bytes and peak device memory;
- **trace export** (``export.py``): telemetry JSONL span trees and
  attributed device ops rendered as Chrome ``trace_event`` JSON
  (Perfetto-loadable) and collapsed-stack flamegraphs;
- **bench history** (``history.py``, a copy of the JAX package's): every
  bench emission appended to a schema-versioned ``bench_history.jsonl``,
  and the robust median ± k·MAD band a gate reads.

``ledger.py`` (kernel builds charged to spans) and ``phases.py`` (the
dense driver's phase budget) complete it. The package's names resolve on
first use, so that ``history``, ``xplane``, ``kineto`` and ``ledger``
import without torch. Timing caveats are in
``utils/benchtime.py``: a CUDA launch is asynchronous, so wall-clock
around a launch measures the enqueue; device *timelines* (this package)
complement — never replace — the work-difference *numbers* (benchtime).
"""

import importlib

# name -> the submodule defining it, imported on first use (PEP 562): the
# offline tools read with the torch-free submodules wherever Python runs
_EXPORTS = {
    "ProfiledRegion": "attribution", "attribute_to_spans": "attribution",
    "group_by_jit": "attribution", "innermost_jit": "attribution",
    "HISTORY_SCHEMA_VERSION": "history", "append_entry": "history",
    "band_verdicts": "history", "read_history": "history", "robust_band": "history",
    "CompileLedger": "ledger", "function_scope": "ledger",
    "DENSE_PHASES": "phases", "NULL_TIMER": "phases", "PhaseTimer": "phases",
    "encode_xspace": "xplane", "parse_xspace": "xplane", "summarize_path": "xplane",
    "summarize_xplane": "xplane", "top_table": "xplane",
}

__all__ = [
    "ProfiledRegion", "attribute_to_spans", "group_by_jit", "innermost_jit",
    "PhaseTimer", "NULL_TIMER", "DENSE_PHASES",
    "CompileLedger", "function_scope",
    "HISTORY_SCHEMA_VERSION", "append_entry", "band_verdicts",
    "read_history", "robust_band",
    "encode_xspace", "parse_xspace", "summarize_path", "summarize_xplane",
    "top_table", "kineto",
]


def __getattr__(name: str):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    elif name == "kineto":
        value = importlib.import_module(f"{__name__}.kineto")
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value
