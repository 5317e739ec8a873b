"""SSZ type system: basic types, vectors/lists/bitfields, containers.

A from-scratch implementation of the SSZ serialization + merkleization
standard that the reference's containers are written in (pos-evolution.md:9).
Values are plain Python/NumPy data — ints, bytes, numpy arrays for
registry-scale uint lists, Python lists for composite lists — while *sedes*
(schema) objects drive serialization and hashing. Registry-scale fields hash
through the vectorized chunk path in ``ssz/merkle.py``.
"""

from __future__ import annotations

import copy as _copy
from functools import lru_cache

import numpy as np

from pos_evolution_tpu_torch.ssz.hash import sha256
from pos_evolution_tpu_torch.ssz.merkle import merkleize_chunks, mix_in_length

__all__ = [
    "Sedes", "uint8", "uint16", "uint32", "uint64", "boolean",
    "ByteVector", "ByteList", "Bytes4", "Bytes20", "Bytes32", "Bytes48", "Bytes96",
    "Vector", "List", "Bitvector", "Bitlist", "Container",
    "hash_tree_root", "cached_root", "serialize", "deserialize",
]

OFFSET_SIZE = 4


def _pack_bytes_to_chunks(data: bytes) -> np.ndarray:
    """Right-pad bytes with zeros to a multiple of 32 and view as (N,32)."""
    n = len(data)
    padded_len = max(((n + 31) // 32) * 32, 32)
    buf = np.zeros(padded_len, dtype=np.uint8)
    if n:
        buf[:n] = np.frombuffer(data, dtype=np.uint8)
    return buf.reshape(-1, 32)


class Sedes:
    """Base schema object. Subclasses implement the SSZ type rules."""

    def is_fixed(self) -> bool:
        raise NotImplementedError

    def fixed_size(self) -> int:
        raise NotImplementedError

    def serialize(self, value) -> bytes:
        raise NotImplementedError

    def deserialize(self, data: bytes):
        raise NotImplementedError

    def htr(self, value) -> bytes:
        raise NotImplementedError

    def default(self):
        raise NotImplementedError


# --- basic types -------------------------------------------------------------

class _UInt(Sedes):
    def __init__(self, byte_len: int):
        self.byte_len = byte_len

    def is_fixed(self):
        return True

    def fixed_size(self):
        return self.byte_len

    def serialize(self, value) -> bytes:
        return int(value).to_bytes(self.byte_len, "little")

    def deserialize(self, data: bytes) -> int:
        return int.from_bytes(data, "little")

    def htr(self, value) -> bytes:
        return int(value).to_bytes(self.byte_len, "little").ljust(32, b"\x00")

    def default(self) -> int:
        return 0

    @property
    def np_dtype(self):
        return {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[self.byte_len]

    def __repr__(self):
        return f"uint{self.byte_len * 8}"


class _Boolean(Sedes):
    def is_fixed(self):
        return True

    def fixed_size(self):
        return 1

    def serialize(self, value) -> bytes:
        return b"\x01" if value else b"\x00"

    def deserialize(self, data: bytes) -> bool:
        return data != b"\x00"

    def htr(self, value) -> bytes:
        return (b"\x01" if value else b"\x00").ljust(32, b"\x00")

    def default(self) -> bool:
        return False

    def __repr__(self):
        return "boolean"


uint8 = _UInt(1)
uint16 = _UInt(2)
uint32 = _UInt(4)
uint64 = _UInt(8)
boolean = _Boolean()


class _ByteVector(Sedes):
    def __init__(self, length: int):
        self.length = length

    def is_fixed(self):
        return True

    def fixed_size(self):
        return self.length

    def serialize(self, value) -> bytes:
        b = bytes(value)
        if len(b) != self.length:
            raise ValueError(f"ByteVector[{self.length}] got {len(b)} bytes")
        return b

    def deserialize(self, data: bytes) -> bytes:
        return bytes(data)

    def htr(self, value) -> bytes:
        return merkleize_chunks(_pack_bytes_to_chunks(bytes(value)))

    def default(self) -> bytes:
        return b"\x00" * self.length

    def __repr__(self):
        return f"ByteVector[{self.length}]"


class _ByteList(Sedes):
    def __init__(self, limit: int):
        self.limit = limit

    def is_fixed(self):
        return False

    def serialize(self, value) -> bytes:
        return bytes(value)

    def deserialize(self, data: bytes) -> bytes:
        return bytes(data)

    def htr(self, value) -> bytes:
        b = bytes(value)
        chunk_limit = (self.limit + 31) // 32
        chunks = _pack_bytes_to_chunks(b) if b else np.empty((0, 32), dtype=np.uint8)
        return mix_in_length(merkleize_chunks(chunks, max(chunk_limit, 1)), len(b))

    def default(self) -> bytes:
        return b""

    def __repr__(self):
        return f"ByteList[{self.limit}]"


@lru_cache(maxsize=None)
def ByteVector(length: int) -> _ByteVector:
    return _ByteVector(length)


@lru_cache(maxsize=None)
def ByteList(limit: int) -> _ByteList:
    return _ByteList(limit)


Bytes4 = ByteVector(4)
Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)


# --- homogeneous collections -------------------------------------------------

def _pack_basic_array(elem: _UInt, value) -> np.ndarray:
    """Pack a sequence of basic uints into (N, 32) chunks, vectorized."""
    arr = np.asarray(value, dtype=elem.np_dtype)
    if arr.ndim != 1:
        raise ValueError("expected 1-D array of basic elements")
    raw = arr.astype(f"<u{elem.byte_len}").view(np.uint8)
    return _pack_bytes_to_chunks(raw.tobytes()) if raw.size else np.empty((0, 32), dtype=np.uint8)


def _composite_roots(elem: Sedes, values) -> np.ndarray:
    roots = [elem.htr(v) for v in values]
    if not roots:
        return np.empty((0, 32), dtype=np.uint8)
    return np.frombuffer(b"".join(roots), dtype=np.uint8).reshape(-1, 32)


class _Vector(Sedes):
    def __init__(self, elem: Sedes, length: int):
        self.elem = elem
        self.length = length

    def is_fixed(self):
        return self.elem.is_fixed()

    def fixed_size(self):
        return self.elem.fixed_size() * self.length

    def serialize(self, value) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"Vector[{self.length}] got {len(value)} elements")
        if isinstance(self.elem, _UInt):
            return np.asarray(value, dtype=self.elem.np_dtype).astype(
                f"<u{self.elem.byte_len}").tobytes()
        return _serialize_sequence(self.elem, list(value))

    def deserialize(self, data: bytes):
        if isinstance(self.elem, _UInt):
            return np.frombuffer(data, dtype=f"<u{self.elem.byte_len}").astype(
                self.elem.np_dtype).copy()
        return _deserialize_sequence(self.elem, data)

    def htr(self, value) -> bytes:
        if isinstance(self.elem, _UInt):
            chunks = _pack_basic_array(self.elem, value)
            return merkleize_chunks(chunks, chunks.shape[0])
        return merkleize_chunks(_composite_roots(self.elem, value))

    def default(self):
        if isinstance(self.elem, _UInt):
            return np.zeros(self.length, dtype=self.elem.np_dtype)
        return [self.elem.default() for _ in range(self.length)]

    def __repr__(self):
        return f"Vector[{self.elem!r}, {self.length}]"


class _List(Sedes):
    def __init__(self, elem: Sedes, limit: int):
        self.elem = elem
        self.limit = limit

    def is_fixed(self):
        return False

    def serialize(self, value) -> bytes:
        if isinstance(self.elem, _UInt):
            return np.asarray(value, dtype=self.elem.np_dtype).astype(
                f"<u{self.elem.byte_len}").tobytes()
        return _serialize_sequence(self.elem, list(value))

    def deserialize(self, data: bytes):
        if isinstance(self.elem, _UInt):
            return np.frombuffer(data, dtype=f"<u{self.elem.byte_len}").astype(
                self.elem.np_dtype).copy()
        return _deserialize_sequence(self.elem, data)

    def htr(self, value) -> bytes:
        n = len(value)
        if isinstance(self.elem, _UInt):
            chunks = _pack_basic_array(self.elem, value)
            per_chunk = 32 // self.elem.byte_len
            limit_chunks = (self.limit + per_chunk - 1) // per_chunk
            root = merkleize_chunks(chunks, max(limit_chunks, 1))
        else:
            root = merkleize_chunks(_composite_roots(self.elem, value), self.limit)
        return mix_in_length(root, n)

    def default(self):
        if isinstance(self.elem, _UInt):
            return np.zeros(0, dtype=self.elem.np_dtype)
        return []

    def __repr__(self):
        return f"List[{self.elem!r}, {self.limit}]"


class _Bitvector(Sedes):
    def __init__(self, length: int):
        self.length = length

    def is_fixed(self):
        return True

    def fixed_size(self):
        return (self.length + 7) // 8

    def _bits(self, value) -> np.ndarray:
        bits = np.asarray(value, dtype=bool)
        if bits.shape[0] != self.length:
            raise ValueError(f"Bitvector[{self.length}] got {bits.shape[0]} bits")
        return bits

    def serialize(self, value) -> bytes:
        return np.packbits(self._bits(value), bitorder="little").tobytes()

    def deserialize(self, data: bytes) -> np.ndarray:
        raw = np.frombuffer(data, dtype=np.uint8)
        return np.unpackbits(raw, bitorder="little")[: self.length].astype(bool)

    def htr(self, value) -> bytes:
        packed = np.packbits(self._bits(value), bitorder="little").tobytes()
        return merkleize_chunks(_pack_bytes_to_chunks(packed))

    def default(self) -> np.ndarray:
        return np.zeros(self.length, dtype=bool)

    def __repr__(self):
        return f"Bitvector[{self.length}]"


class _Bitlist(Sedes):
    def __init__(self, limit: int):
        self.limit = limit

    def is_fixed(self):
        return False

    def serialize(self, value) -> bytes:
        bits = np.asarray(value, dtype=bool)
        # trailing delimiter bit marks the length
        with_delim = np.concatenate([bits, np.ones(1, dtype=bool)])
        return np.packbits(with_delim, bitorder="little").tobytes()

    def deserialize(self, data: bytes) -> np.ndarray:
        raw = np.unpackbits(np.frombuffer(data, dtype=np.uint8), bitorder="little")
        # strip everything from the highest set (delimiter) bit
        idx = np.nonzero(raw)[0]
        if idx.size == 0:
            raise ValueError("malformed bitlist: no delimiter bit")
        return raw[: idx[-1]].astype(bool)

    def htr(self, value) -> bytes:
        bits = np.asarray(value, dtype=bool)
        packed = np.packbits(bits, bitorder="little").tobytes() if bits.size else b""
        chunk_limit = ((self.limit + 7) // 8 + 31) // 32
        chunks = _pack_bytes_to_chunks(packed) if packed else np.empty((0, 32), dtype=np.uint8)
        return mix_in_length(merkleize_chunks(chunks, max(chunk_limit, 1)), int(bits.size))

    def default(self) -> np.ndarray:
        return np.zeros(0, dtype=bool)

    def __repr__(self):
        return f"Bitlist[{self.limit}]"


@lru_cache(maxsize=None)
def Vector(elem: Sedes, length: int) -> _Vector:
    return _Vector(elem, length)


@lru_cache(maxsize=None)
def List(elem: Sedes, limit: int) -> _List:
    return _List(elem, limit)


@lru_cache(maxsize=None)
def Bitvector(length: int) -> _Bitvector:
    return _Bitvector(length)


@lru_cache(maxsize=None)
def Bitlist(limit: int) -> _Bitlist:
    return _Bitlist(limit)


# --- variable-size sequence framing ------------------------------------------

def _serialize_sequence(elem: Sedes, values: list) -> bytes:
    if elem.is_fixed():
        return b"".join(elem.serialize(v) for v in values)
    parts = [elem.serialize(v) for v in values]
    offset = OFFSET_SIZE * len(parts)
    head = b""
    for p in parts:
        head += offset.to_bytes(OFFSET_SIZE, "little")
        offset += len(p)
    return head + b"".join(parts)


def _deserialize_sequence(elem: Sedes, data: bytes) -> list:
    if not data:
        return []
    if elem.is_fixed():
        size = elem.fixed_size()
        if len(data) % size:
            raise ValueError("sequence length not a multiple of element size")
        return [elem.deserialize(data[i:i + size]) for i in range(0, len(data), size)]
    first = int.from_bytes(data[:OFFSET_SIZE], "little")
    count = first // OFFSET_SIZE
    offsets = [int.from_bytes(data[i * OFFSET_SIZE:(i + 1) * OFFSET_SIZE], "little")
               for i in range(count)] + [len(data)]
    return [elem.deserialize(data[offsets[i]:offsets[i + 1]]) for i in range(count)]


# --- containers --------------------------------------------------------------

class ContainerMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        fields: dict[str, Sedes] = {}
        for base in reversed(bases):
            fields.update(getattr(base, "_fields", {}))
        module_globals = vars(__import__("sys").modules.get(ns.get("__module__", ""), None)) \
            if ns.get("__module__") in __import__("sys").modules else {}
        for fname, sedes in ns.get("__annotations__", {}).items():
            if isinstance(sedes, str):
                # `from __future__ import annotations` stringifies annotations;
                # resolve sedes expressions in the defining module's namespace.
                try:
                    sedes = eval(sedes, module_globals, dict(ns))  # noqa: S307
                except Exception:
                    continue
            if isinstance(sedes, (Sedes, ContainerMeta)):
                fields[fname] = sedes
        cls._fields = fields
        return cls


class Container(metaclass=ContainerMeta):
    """Base class for SSZ containers; the class doubles as its own sedes."""

    _fields: dict[str, Sedes] = {}

    def __init__(self, **kwargs):
        for fname, sedes in self._fields.items():
            if fname in kwargs:
                setattr(self, fname, kwargs.pop(fname))
            else:
                setattr(self, fname, _sedes_of(sedes).default())
        if kwargs:
            raise TypeError(f"unknown fields for {type(self).__name__}: {list(kwargs)}")

    # -- sedes protocol (classmethods so the class is usable as a schema) --
    @classmethod
    def is_fixed(cls) -> bool:
        return all(_sedes_of(s).is_fixed() for s in cls._fields.values())

    @classmethod
    def fixed_size(cls) -> int:
        return sum(_sedes_of(s).fixed_size() for s in cls._fields.values())

    @classmethod
    def serialize(cls, value: "Container") -> bytes:
        fixed_parts: list[bytes | None] = []
        var_parts: list[bytes] = []
        for fname, s in cls._fields.items():
            sedes = _sedes_of(s)
            v = getattr(value, fname)
            if sedes.is_fixed():
                fixed_parts.append(sedes.serialize(v))
            else:
                fixed_parts.append(None)
                var_parts.append(sedes.serialize(v))
        fixed_len = sum(OFFSET_SIZE if p is None else len(p) for p in fixed_parts)
        out, var_out, offset = [], [], fixed_len
        vi = 0
        for p in fixed_parts:
            if p is None:
                out.append(offset.to_bytes(OFFSET_SIZE, "little"))
                var_out.append(var_parts[vi])
                offset += len(var_parts[vi])
                vi += 1
            else:
                out.append(p)
        return b"".join(out) + b"".join(var_out)

    @classmethod
    def deserialize(cls, data: bytes) -> "Container":
        values: dict[str, object] = {}
        pos = 0
        var_fields: list[tuple[str, Sedes, int]] = []
        for fname, s in cls._fields.items():
            sedes = _sedes_of(s)
            if sedes.is_fixed():
                size = sedes.fixed_size()
                values[fname] = sedes.deserialize(data[pos:pos + size])
                pos += size
            else:
                off = int.from_bytes(data[pos:pos + OFFSET_SIZE], "little")
                var_fields.append((fname, sedes, off))
                pos += OFFSET_SIZE
        bounds = [off for (_, _, off) in var_fields] + [len(data)]
        for i, (fname, sedes, off) in enumerate(var_fields):
            values[fname] = sedes.deserialize(data[off:bounds[i + 1]])
        return cls(**values)

    @classmethod
    def _field_chunks(cls, value: "Container") -> np.ndarray:
        """Zero-copy (n_fields, 32) view over the per-field chunk roots."""
        roots = b"".join(_sedes_of(s).htr(getattr(value, f)) for f, s in cls._fields.items())
        return np.frombuffer(roots, dtype=np.uint8).reshape(-1, 32)

    @classmethod
    def field_roots(cls, value: "Container") -> np.ndarray:
        """(n_fields, 32) per-field chunk roots — the leaves of ``htr``.

        Exposed so merkle *proofs into a container's field tree* (light-client
        finality / sync-committee branches) can be built from the same chunks
        the root hashes over. Returns a writable copy; ``htr`` itself stays
        on the zero-copy view (it is the hottest path in the codebase).
        """
        return cls._field_chunks(value).copy()

    @classmethod
    def htr(cls, value: "Container") -> bytes:
        return merkleize_chunks(cls._field_chunks(value))

    @classmethod
    def default(cls) -> "Container":
        return cls()

    # -- instance conveniences --
    def hash_tree_root(self) -> bytes:
        return type(self).htr(self)

    def copy(self) -> "Container":
        out = _copy.deepcopy(self)
        # a memoized root (cached_root) or an incremental-merkleization
        # cache must not ride into a copy that may be mutated
        out.__dict__.pop("_htr_memo", None)
        out.__dict__.pop("_htr_cache", None)
        return out

    def __eq__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        for f in self._fields:
            a, b = getattr(self, f), getattr(other, f)
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                if not np.array_equal(np.asarray(a), np.asarray(b)):
                    return False
            elif a != b:
                return False
        return True

    def __hash__(self):
        return hash(self.hash_tree_root())

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)!r}" for f in list(self._fields)[:4])
        more = "..." if len(self._fields) > 4 else ""
        return f"{type(self).__name__}({inner}{more})"


class _ContainerSedes(Sedes):
    """Adapter making a Container class usable where a Sedes instance is."""

    def __init__(self, cls):
        self.cls = cls

    def is_fixed(self):
        return self.cls.is_fixed()

    def fixed_size(self):
        return self.cls.fixed_size()

    def serialize(self, v):
        return self.cls.serialize(v)

    def deserialize(self, data):
        return self.cls.deserialize(data)

    def htr(self, v):
        return self.cls.htr(v)

    def default(self):
        return self.cls()


@lru_cache(maxsize=None)
def _container_sedes(cls) -> _ContainerSedes:
    return _ContainerSedes(cls)


def _sedes_of(s) -> Sedes:
    if isinstance(s, Sedes):
        return s
    if isinstance(s, ContainerMeta):
        return _container_sedes(s)
    raise TypeError(f"not an SSZ schema: {s!r}")


# --- top-level API ------------------------------------------------------------

def hash_tree_root(value, sedes=None) -> bytes:
    """SSZ hash_tree_root (pos-evolution.md:142, 423, 1016-1024).

    Objects that define ``__ssz_root__`` (e.g. the dense validator registry)
    hash themselves; containers know their own schema; anything else needs an
    explicit ``sedes``. A root memoized with ``cached_root`` (immutable
    gossip objects: blocks, attestations) is honored first.
    """
    if sedes is None:
        d = getattr(value, "__dict__", None)
        if d is not None:
            memo = d.get("_htr_memo")
            if memo is not None:
                return memo
    custom = getattr(value, "__ssz_root__", None)
    if custom is not None and sedes is None:
        return custom()
    if sedes is None:
        if isinstance(value, Container):
            return type(value).htr(value)
        raise TypeError("hash_tree_root of a bare value requires a sedes")
    return _sedes_of(sedes).htr(value)


def cached_root(value) -> bytes:
    """``hash_tree_root`` memoized on the object (``_htr_memo``).

    Only for objects that are immutable once rooted — the driver's gossip
    payloads (signed blocks, attestations), whose roots were being
    recomputed at origination, gossip delivery, pool insert, and backfill.
    ``Container.copy()`` strips the memo, so copy-then-mutate flows
    (adversarial equivocation builders) cannot observe a stale root.
    """
    d = value.__dict__
    memo = d.get("_htr_memo")
    if memo is None:
        memo = hash_tree_root(value)
        d["_htr_memo"] = memo
    return memo


def serialize(value, sedes=None) -> bytes:
    if sedes is None:
        if isinstance(value, Container):
            return type(value).serialize(value)
        raise TypeError("serialize of a bare value requires a sedes")
    return _sedes_of(sedes).serialize(value)


def deserialize(data: bytes, sedes) -> object:
    return _sedes_of(sedes).deserialize(data)
