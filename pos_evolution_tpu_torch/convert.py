"""Carry state between the JAX package and the port.

The JAX package's ``DenseRegistry``, ``DenseStore``, ``pk_states`` and
``ValidatorRegistry`` go in as any objects whose fields ``np.asarray``
accepts (jax arrays, numpy arrays), and come out as the port's
NamedTuples of tensors on ``device``:
CUDA unless the caller asks for another, raising without it (see
``device.resolve_device``). ``to_numpy`` takes them back to numpy. uint32
word arrays become int32 bit-pattern tensors (see ``device.py``), uint64
columns int64 bit patterns, and 32-byte chunk rows (N, 8) words. BLS12-381
field elements and points travel as int32 [..., 32] base-2^12 digits in
both packages (``limbs_to_torch`` / ``limbs_to_numpy``).

Spec containers (a ``BeaconState``, a ``SignedBeaconBlock``, any SSZ
container of the spec layer) cross as SSZ bytes: ``spec_to_port``
serializes the JAX package's object by its own class and deserializes
the bytes with the port's class of the same name, so the two roots agree
wherever the SSZ code of the two packages does. A whole spec-driver
``Simulation`` crosses as its checkpoint bytes (``simulation_to_port``),
a DAS run's blob engine as its ``describe()`` (``blob_engine_to_port``),
and a resident fork-choice store as its arrays (``resident_to_port``).
"""

from __future__ import annotations

import numpy as np
import torch

from pos_evolution_tpu_torch.device import resolve_device, rows_to_words, words_to_torch
from pos_evolution_tpu_torch.ops.epoch import DenseRegistry
from pos_evolution_tpu_torch.ops.forkchoice import DenseStore
from pos_evolution_tpu_torch.ssz.incremental import ValidatorRegistry


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


def validator_registry_to_torch(reg, device="cuda") -> ValidatorRegistry:
    """The JAX package's ``ValidatorRegistry`` (any object with its numpy
    columns) -> the port's columns on ``device``; uint64 columns become
    int64 bit patterns (FAR_FUTURE_EPOCH is -1)."""
    dev = resolve_device(device)
    cols = []
    for f in ValidatorRegistry._fields:
        a = np.asarray(getattr(reg, f))
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        cols.append(torch.from_numpy(np.array(a, copy=True)).to(dev))
    return ValidatorRegistry(*cols)


def validator_registry_to_numpy(reg: ValidatorRegistry) -> dict:
    """The port's registry columns -> numpy columns in the JAX
    ``ValidatorRegistry``'s dtypes, by field name (int64 -> uint64)."""
    out = {}
    for f, t in zip(reg._fields, reg):
        a = t.detach().cpu().numpy()
        out[f] = a.view(np.uint64) if a.dtype == np.int64 else a
    return out


def chunks_to_torch(rows, device="cuda") -> torch.Tensor:
    """(N, 32) uint8 chunk rows -> (N, 8) int32 words on ``device``,
    converted there."""
    rows = np.array(rows, dtype=np.uint8, copy=True).reshape(-1, 32)
    return rows_to_words(torch.from_numpy(rows).to(resolve_device(device)))


def limbs_to_torch(a, device="cuda") -> torch.Tensor:
    """int32 [..., 32] base-field digit arrays (the JAX package's
    ``pairing.g1_affine_encode``/``g2_affine_encode`` outputs, its pk
    tables, its tower elements) -> an int32 tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype != np.int32 or a.ndim == 0 or a.shape[-1] != 32:
        raise ValueError(f"limbs must be int32 [..., 32], got {a.dtype} {a.shape}")
    return torch.from_numpy(np.array(a, copy=True)).to(resolve_device(device))


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The port's digit tensors -> int32 numpy, the JAX package's layout."""
    return t.detach().cpu().numpy()


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



def spec_to_port(obj):
    """A spec container of the JAX package (duck-typed: its class's
    ``serialize`` and its name) as the port's container of the same name
    (``specs/containers.py``, ``specs/helpers.py``), through SSZ bytes."""
    from pos_evolution_tpu_torch.specs import containers, helpers
    name = type(obj).__name__
    cls = getattr(containers, name, None) or getattr(helpers, name, None)
    if cls is None:
        raise TypeError(f"no spec container named {name!r} in the port")
    return cls.deserialize(type(obj).serialize(obj))


def simulation_to_port(checkpoint: bytes, schedule=None, device=None, **resume_kwargs):
    """A JAX package ``Simulation.checkpoint()`` (framed SSZ and JSON that
    names no class path) resumed as the port's ``sim/driver.Simulation``
    on ``device`` (the thread backend's when None). ``schedule`` is the
    run's own, built from the port's ``sim/schedule`` and ``sim/faults``;
    ``resume_kwargs`` go to ``Simulation.resume`` (adversaries, monitors,
    variant, and ``das``: a checkpoint of a DAS run takes the port's
    engine, e.g. ``blob_engine_to_port(jax_engine.describe(), cfg,
    device)``, under the run's config)."""
    from pos_evolution_tpu_torch.sim.driver import Simulation
    return Simulation.resume(bytes(checkpoint), schedule=schedule, device=device,
                             **resume_kwargs)


def blob_engine_to_port(describe: dict, cfg, device=None):
    """The port's ``das/engine.BlobEngine`` for a JAX engine's
    ``describe()`` (its scheme, blob count and seed) under config ``cfg``
    on ``device`` (CUDA when None): it regenerates the same sidecars, and
    its ``describe()`` is the one a checkpoint of the run records."""
    from pos_evolution_tpu_torch.das.engine import BlobEngine
    if describe.get("kind") != "blob_engine":
        raise ValueError(f"not a blob engine's describe(): {describe}")
    engine = BlobEngine(cfg, n_blobs=int(describe["n_blobs"]), scheme=describe["scheme"],
                        seed=int(describe["seed"]), device="cuda" if device is None else device)
    if engine.describe() != describe:
        raise ValueError(f"engine {engine.describe()} does not carry {describe}")
    return engine


def resident_to_port(arrays: dict, store, device=None):
    """A JAX ``ResidentForkChoice``'s resident image, as a dict of numpy
    arrays by its attribute names (``ops/resident.RESIDENT_ARRAYS``, plus
    ``roots``), placed as the port's ``ResidentForkChoice`` over ``store``
    (the port's spec store of the same chain) on ``device`` (the thread
    backend's when None). The store's fingerprint and memo start from the
    carried image, so the next head query reads it as it is."""
    from pos_evolution_tpu_torch.backend import get_backend, use_backend
    from pos_evolution_tpu_torch.ops.resident import RESIDENT_ARRAYS, ResidentForkChoice
    on = use_backend(get_backend()) if device is None else use_backend("torch", device=device)
    with on:
        res = ResidentForkChoice(store, capacity=len(arrays["parent"]))
    dev = res.device
    for name in RESIDENT_ARRAYS:
        setattr(res, name, torch.from_numpy(np.array(arrays[name], copy=True)).to(dev))
    res.roots = [bytes(r) for r in arrays["roots"]]
    res.index_of = {r: i for i, r in enumerate(res.roots)}
    res.capacity = int(res.parent.shape[0])
    res._rev += 1
    return res
