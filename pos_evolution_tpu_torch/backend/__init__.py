"""The port's ExecutionBackend registry (port of
``pos_evolution_tpu/backend/__init__.py``).

The spec layer (``specs/``) keeps its reference signatures and reaches
the device through ``get_backend()``: the shuffle, the epoch sweep, the
block sweep, the chain apply. The port has one backend, its torch backend
(``backend/torch_backend.py``), on an explicit device. The default is
CUDA: ``get_backend()`` raises where there is none, unless the caller set
``set_backend("torch", device="cpu")``; nothing falls back to the CPU
unasked. The backend is per thread, as in the JAX package.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

__all__ = ["get_backend", "set_backend", "use_backend"]

_local = threading.local()


def _make(backend, device):
    if not isinstance(backend, str):
        return backend
    if backend != "torch":
        raise ValueError(f"unknown ExecutionBackend {backend!r}: the port has 'torch'")
    from pos_evolution_tpu_torch.backend.torch_backend import TorchBackend
    return TorchBackend(device)


def get_backend():
    """This thread's backend; the first call makes the default, the torch
    backend on CUDA (raising without CUDA)."""
    b = getattr(_local, "backend", None)
    if b is None:
        b = _local.backend = _make("torch", "cuda")
    return b


def set_backend(backend="torch", *, device="cuda"):
    """Make ``backend`` (a name, or a backend object) this thread's; a name
    is built on ``device``. Returns the backend."""
    _local.backend = _make(backend, device)
    return _local.backend


@contextmanager
def use_backend(backend="torch", *, device="cuda"):
    """``set_backend`` for the block's duration, then the previous one."""
    prev = getattr(_local, "backend", None)
    b = set_backend(backend, device=device)
    try:
        yield b
    finally:
        _local.backend = prev
