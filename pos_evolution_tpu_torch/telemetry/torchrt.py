"""PyTorch runtime telemetry folded into a ``MetricsRegistry`` (the port's
counterpart of ``pos_evolution_tpu/telemetry/jaxrt.py``).

The JAX module listens to ``jax.monitoring`` for XLA compiles. The port
compiles nothing at run time but its kernels, and launches nothing but
through ``ops/kernels.launch``, so its runtime sources are its own:

- **kernel builds**: ``ops/kernels.build_all`` calls every entry of
  ``kernels.build_listeners`` with a source's ``nvcc`` seconds;
  ``install`` adds one forwarding listener (once per process) that
  counts ``kernel_builds_total{source}``, observes the
  ``kernel_build_seconds`` histogram, and hands the build to an attached
  ``profiling/ledger.CompileLedger``, which charges it to the span
  active on the building thread;
- **kernel launches**: ``collect_launches`` folds the growth of
  ``kernels.launches`` since the last call into
  ``kernel_launches_total{kernel}``;
- **dispatches, transfers, donations**: ``record_dispatch``,
  ``record_transfer`` and ``record_donation`` from the call sites the
  port controls, under the JAX module's counter names
  (``jax_dispatches_total``, ``jax_transfer_bytes_total`` and, while a
  phase is open, ``jax_transfer_bytes_by_phase_total``,
  ``jax_donation_bytes_total``): they count the same things, so a
  snapshot of either package reads the same. Torch has no buffer
  donation, so every donation row is ``armed=0``.

``install(None)`` detaches. Nothing here raises into a run or imports
torch: telemetry must never be the reason a run dies.
"""

from __future__ import annotations

import threading

_STATE: dict = {"registry": None, "listening": False, "ledger": None,
                "launch_mark": None}
_LOCK = threading.Lock()


def current():
    """The registry runtime events currently feed (None = detached)."""
    return _STATE["registry"]


def attach_ledger(ledger) -> None:
    """Point kernel builds at a ``CompileLedger`` (None detaches)."""
    _STATE["ledger"] = ledger


def current_ledger():
    return _STATE["ledger"]


def _on_build(source: str, seconds: float) -> None:
    led = _STATE["ledger"]
    if led is not None:
        try:
            led.on_build(source, seconds)
        except Exception:
            pass  # the ledger must never kill a run
    reg = _STATE["registry"]
    if reg is None:
        return
    reg.counter("kernel_builds_total", "kernel sources built (one nvcc each)").inc(
        source=source)
    reg.histogram("kernel_build_seconds", "wall seconds of each kernel build").observe(
        seconds, source=source)


def install(registry) -> bool:
    """Point runtime telemetry at ``registry`` (None detaches). Returns
    True when the build listener is live."""
    _STATE["registry"] = registry
    if registry is None or _STATE["listening"]:
        return _STATE["listening"]
    try:
        from pos_evolution_tpu_torch.ops import kernels
        kernels.build_listeners.append(_on_build)
        with _LOCK:
            _STATE["launch_mark"] = dict(kernels.launches)
        _STATE["listening"] = True
    except Exception:
        pass  # no torch: the record_* helpers still count
    return _STATE["listening"]


def collect_launches() -> dict:
    """Fold the kernel launches made since the last call (or since
    ``install``) into ``kernel_launches_total{kernel}``; returns them."""
    reg = _STATE["registry"]
    if reg is None or not _STATE["listening"]:
        return {}
    from pos_evolution_tpu_torch.ops import kernels
    with _LOCK:
        now = dict(kernels.launches)
        mark = _STATE["launch_mark"] or {}
        _STATE["launch_mark"] = now
    grown = {k: v - mark.get(k, 0) for k, v in now.items() if v > mark.get(k, 0)}
    if grown:
        c = reg.counter("kernel_launches_total", "kernel launches by the port's wrappers")
        for k, v in grown.items():
            c.inc(v, kernel=k)
    return grown


# -- explicit hooks for the call sites the port controls ------------------------

def record_dispatch(n: int = 1, *, site: str = "unknown") -> None:
    reg = _STATE["registry"]
    if reg is not None:
        reg.counter("jax_dispatches_total",
                    "device computations dispatched from "
                    "instrumented call sites").inc(n, site=site)


def record_transfer(nbytes: int, *, direction: str = "d2h",
                    site: str = "unknown") -> None:
    reg = _STATE["registry"]
    if reg is not None:
        reg.counter("jax_transfer_bytes_total",
                    "host<->device bytes moved by instrumented call "
                    "sites").inc(int(nbytes), direction=direction, site=site)
        # charged to the active phase too, in its own counter (the
        # site-keyed one keeps its label set)
        from pos_evolution_tpu_torch.profiling import ledger as _ledger
        phase = _ledger.current_phase()
        if phase is not None:
            reg.counter("jax_transfer_bytes_by_phase_total",
                        "host<->device bytes charged to the dense phase "
                        "active at transfer time").inc(
                int(nbytes), direction=direction, phase=phase)


def record_donation(nbytes: int, *, site: str = "unknown") -> None:
    """Bytes that a JAX run would offer for buffer donation at this
    site. Torch has none, so they are always recorded as ``armed=0``,
    the undonated path."""
    reg = _STATE["registry"]
    if reg is not None:
        reg.counter("jax_donation_bytes_total",
                    "bytes offered for XLA buffer donation (armed) vs "
                    "moved undonated (armed=0) at instrumented call "
                    "sites").inc(int(nbytes), site=site, armed="0")
