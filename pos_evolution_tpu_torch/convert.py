"""Carry state between the JAX package and the port.

The JAX package's ``DenseRegistry``, ``DenseStore`` and ``pk_states`` go
in as any objects whose fields ``np.asarray`` accepts (jax arrays, numpy
arrays), and come out as the port's NamedTuples of tensors on ``device``:
CUDA unless the caller asks for another, raising without it (see
``device.resolve_device``). ``to_numpy`` takes them back to numpy. uint32
word arrays become int32 bit-pattern tensors (see ``device.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from pos_evolution_tpu_torch.device import resolve_device, words_to_torch
from pos_evolution_tpu_torch.ops.epoch import DenseRegistry
from pos_evolution_tpu_torch.ops.forkchoice import DenseStore


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return words_to_torch(a, device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _fields_to_torch(cls, obj, device):
    dev = resolve_device(device)
    return cls(*(_tensor(getattr(obj, f), dev) for f in cls._fields))


def registry_to_torch(reg, device="cuda") -> DenseRegistry:
    return _fields_to_torch(DenseRegistry, reg, device)


def store_to_torch(store, device="cuda") -> DenseStore:
    return _fields_to_torch(DenseStore, store, device)


def pk_states_to_torch(pk_states, device="cuda") -> torch.Tensor:
    """(N, 8) uint32 midstates -> (N, 8) int32 words on ``device``."""
    return words_to_torch(np.asarray(pk_states), device)


def to_numpy(x):
    """Port tensors (or NamedTuples of them, nested) -> numpy, same structure.
    int32 word tensors stay int32 here; use ``device.words_to_numpy`` for
    uint32 words."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x

