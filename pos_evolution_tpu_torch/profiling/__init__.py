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
dense driver's phase budget) complete it. Timing caveats are in
``utils/benchtime.py``: a CUDA launch is asynchronous, so wall-clock
around a launch measures the enqueue; device *timelines* (this package)
complement — never replace — the work-difference *numbers* (benchtime).
"""

from pos_evolution_tpu_torch.profiling import kineto
from pos_evolution_tpu_torch.profiling.attribution import (
    ProfiledRegion,
    attribute_to_spans,
    group_by_jit,
    innermost_jit,
)
from pos_evolution_tpu_torch.profiling.history import (
    HISTORY_SCHEMA_VERSION,
    append_entry,
    band_verdicts,
    read_history,
    robust_band,
)
from pos_evolution_tpu_torch.profiling.ledger import (
    CompileLedger,
    function_scope,
)
from pos_evolution_tpu_torch.profiling.phases import (
    DENSE_PHASES,
    NULL_TIMER,
    PhaseTimer,
)
from pos_evolution_tpu_torch.profiling.xplane import (
    encode_xspace,
    parse_xspace,
    summarize_path,
    summarize_xplane,
    top_table,
)

__all__ = [
    "ProfiledRegion", "attribute_to_spans", "group_by_jit", "innermost_jit",
    "PhaseTimer", "NULL_TIMER", "DENSE_PHASES",
    "CompileLedger", "function_scope",
    "HISTORY_SCHEMA_VERSION", "append_entry", "band_verdicts",
    "read_history", "robust_band",
    "encode_xspace", "parse_xspace", "summarize_path", "summarize_xplane",
    "top_table", "kineto",
]
