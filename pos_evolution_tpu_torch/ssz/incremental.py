"""Incremental SSZ merkleization on the device: persistent hash trees that
re-hash only the paths above changed chunks (port of
``pos_evolution_tpu/ssz/incremental.py``).

- ``ChunkTree``: one padded SSZ merkle tree over (N, 8) word chunks.
  Changed chunks are found by comparing against the last-seen leaves on
  the device (a compare, not a hash); the dirty paths re-hash level by
  level.
- ``RegistryTree``: the validator registry. Column compares find the
  changed rows, only those rows re-run the 8-leaf validator
  merkleization (through K2), and their roots feed a ``ChunkTree``
  capped at the registry limit.
- ``_TreeField`` / ``_RegistryField``: a state field backed by one of
  those, with the length mix-in of an SSZ list.

Tree updates are generators that yield one level's (left, right) pair
block at a time, so a ``LevelSweeper`` can hash level k of every dirty
field in one kernel launch (``ops/merkle_device.py``). The result is
bit-identical to merkleizing from scratch (``ssz.merkle.merkleize_chunks``
plus ``mix_in_length``), including the virtual zero padding to the type's
limit and list growth and shrink.

Host syncs: a dirty-set lookup (``nonzero``) per update, one ``unique`` of
the parent indices per level of a dirty-path rehash (its size depends on
the data), and the 32-byte top node read back once per tree, which the
host caps with zero-subtree hashes up to the limit's depth.

The spec layer's ``BeaconState`` holds host numpy columns.
``state_root`` (its ``__ssz_root__``) keeps a ``ContainerTreeCache`` per
copy lineage (``BeaconState.copy`` shares it): each big field is a
``_MirroredTree`` (the registry a ``_HostRegistryTree``), a device
``ChunkTree`` beside a host mirror of the rows it last hashed. Changed
rows are found on the host against the mirror, as the JAX package's trees
find them, and only those rows go to the device; small fields keep a
serialize-compare memo (``_SmallField``) and hash on the host. One root
is one ``LevelSweeper`` pass over every dirty field (a K2 launch a level
on a CUDA device), then the field roots' own tree.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pos_evolution_tpu_torch.device import rows_to_words
from pos_evolution_tpu_torch.ops.merkle_device import LevelSweeper, drive, pair_hash, route_device
from pos_evolution_tpu_torch.ssz.hash import sha256
from pos_evolution_tpu_torch.ssz.merkle import (
    ZERO_HASHES,
    _depth_for,
    _row_bytes,
    mix_in_length,
    zero_words,
)

__all__ = ["ChunkTree", "RegistryTree", "ValidatorRegistry", "ContainerTreeCache",
           "state_root", "set_enabled", "stats", "reset_stats"]


_STATS = {
    "htr_calls": 0,              # spec container roots (ContainerTreeCache.root)
    "htr_cache_hit": 0,          # roots served without any re-hashing
    "htr_cache_miss": 0,         # roots that needed (partial) re-hashing
    "dirty_chunks": 0,           # leaf chunks re-hashed across all trees
    "rebuilds": 0,               # full tree (re)builds
    "validator_root_passes": 0,  # _validator_roots_rows calls (4 K2 sweeps each)
}


def stats() -> dict:
    return dict(_STATS)


def reset_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


# --- persistent chunk tree ----------------------------------------------------------

class ChunkTree:
    """Persistent merkle tree over (N, 8) int32 word chunks on one device.

    ``limit`` is the chunk limit of the SSZ type (virtual zero padding up
    to ``2**ceil(log2(limit))`` leaves); ``limit=None`` is the vector rule
    (the next power of two of the count). ``root(chunks)`` compares the
    chunks with the last-seen leaves and re-hashes only the dirty paths;
    a shrink rebuilds. ``levels`` holds the occupied tree, leaves first;
    ``dirty`` the number of leaves the last call re-hashed.
    """

    __slots__ = ("limit", "count", "levels", "dirty", "_root", "_pending")

    def __init__(self, limit: int | None = None):
        self.limit = limit
        self.count = -1
        self.levels: list[torch.Tensor] | None = None
        self.dirty = 0
        self._root = b""
        # An update is in flight: leaves may be written before the inner
        # nodes hash, so a sweep that is registered and never run must not
        # leave the tree claiming a clean diff against a stale root.
        self._pending = False

    def root(self, chunks: torch.Tensor, sweeper: LevelSweeper | None = None):
        """Incremental root. Without ``sweeper``: the 32-byte root, dirty
        paths hashed now. With one: this tree's level sweeps join the
        sweeper, and the return is a finisher to call after
        ``sweeper.run()``."""
        n = self._check(chunks)
        if self._stale(n):
            return self.rebuild(chunks, sweeper)
        m = self.count
        dirty = torch.nonzero((self.levels[0][:m] != chunks[:m]).any(dim=1)).flatten()
        if n > m:
            dirty = torch.cat([dirty, torch.arange(m, n, device=dirty.device)])
        return self._update(chunks[dirty], dirty, n, sweeper)

    def update_rows(self, chunks: torch.Tensor, dirty: torch.Tensor,
                    sweeper: LevelSweeper | None = None):
        """Like ``root``, with the dirty leaves given by the caller
        (``RegistryTree`` already knows its changed rows). ``dirty`` (int64
        on the chunks' device) must cover every changed row."""
        n = self._check(chunks)
        if self._stale(n):
            return self.rebuild(chunks, sweeper)
        if n > self.count:
            dirty = torch.cat([dirty, torch.arange(self.count, n, device=dirty.device)])
        dirty = torch.unique(dirty)
        return self._update(chunks[dirty], dirty, n, sweeper)

    def update_leaves(self, n: int, dirty: torch.Tensor, rows: torch.Tensor,
                      sweeper: LevelSweeper | None = None):
        """The tree of ``n`` leaves whose rows ``dirty`` (sorted, unique,
        covering any growth past the last count) now hold ``rows``, every
        other leaf unchanged: the caller found the changes where the
        leaves live (``_MirroredTree``'s host mirror). Needs a current
        tree (``stale(n)`` False)."""
        if self.limit is not None and n > self.limit:
            raise ValueError(f"{n} chunks exceed limit {self.limit}")
        if self._stale(n):
            raise ValueError("update_leaves needs a built tree of at most n leaves")
        return self._update(rows, dirty, n, sweeper)

    def rebuild(self, chunks: torch.Tensor, sweeper: LevelSweeper | None = None):
        """Build the tree over ``chunks`` from scratch."""
        self._check(chunks)
        return self._launch(self._rebuild_steps(chunks), sweeper)

    # -- internals ------------------------------------------------------------------

    def _stale(self, n: int) -> bool:
        """First use, a shrink, or an update that never ran: rebuild."""
        return self.levels is None or n < self.count or self._pending

    def _check(self, chunks: torch.Tensor) -> int:
        n = chunks.shape[0]
        if self.limit is not None and n > self.limit:
            raise ValueError(f"{n} chunks exceed limit {self.limit}")
        return n

    def _update(self, rows, dirty, n, sweeper):
        self.dirty = int(dirty.numel())
        if self.dirty == 0 and n == self.count:
            _STATS["htr_cache_hit"] += 1
            return self._done(sweeper)
        _STATS["htr_cache_miss"] += 1
        _STATS["dirty_chunks"] += self.dirty
        return self._launch(self._update_steps(rows, dirty, n), sweeper)

    def _done(self, sweeper):
        root = self._root
        return root if sweeper is None else (lambda: root)

    def _launch(self, gen, sweeper):
        """Run one update generator now, or on the caller's sweeper."""
        if sweeper is None:
            drive(gen)
            return self._root
        sweeper.add(gen)
        return lambda: self._root

    def _effective_depth(self, n: int) -> int:
        return _depth_for(self.limit if self.limit is not None else max(n, 1))

    def _rebuild_steps(self, chunks: torch.Tensor):
        """Full build as a level-sweep generator: yields each level's
        (left, right) pair block, receives the digests."""
        n = chunks.shape[0]
        _STATS["rebuilds"] += 1
        _STATS["htr_cache_miss"] += 1
        _STATS["dirty_chunks"] += n
        self._pending = True
        self.count = n
        self.dirty = n
        if n == 0:
            self.levels = [chunks.clone()]
            self._root = ZERO_HASHES[self._effective_depth(0)]
            self._pending = False
            return
        zero = zero_words(chunks.device)
        levels = [chunks.clone()]
        layer = levels[0]
        level = 0
        while layer.shape[0] > 1:
            if layer.shape[0] % 2:
                layer = torch.cat([layer, zero[level:level + 1]])
            layer = yield (layer[0::2], layer[1::2])
            levels.append(layer)
            level += 1
        self.levels = levels
        self._root = self._cap(levels[-1], level)
        self._pending = False

    def _update_steps(self, rows: torch.Tensor, dirty: torch.Tensor, n: int):
        """Dirty-path rehash as a level-sweep generator: leaves ``dirty``
        (sorted and unique) take ``rows``, the tree grows to ``n`` leaves.
        Leaf writes happen when the generator is primed."""
        self._pending = True
        levels = self.levels
        if n != self.count:
            grown = torch.zeros((n, 8), dtype=torch.int32, device=rows.device)
            keep = min(self.count, n)
            grown[:keep] = levels[0][:keep]
            levels[0] = grown
        levels[0][dirty] = rows
        self.count = n
        zero = zero_words(rows.device)
        size = n
        k = 0
        while size > 1:
            parents = torch.unique(dirty >> 1)
            next_size = (size + 1) // 2
            if len(levels) <= k + 1:
                levels.append(torch.zeros((next_size, 8), dtype=torch.int32,
                                          device=rows.device))
            elif levels[k + 1].shape[0] != next_size:
                grown = torch.zeros((next_size, 8), dtype=torch.int32, device=rows.device)
                keep = min(levels[k + 1].shape[0], next_size)
                grown[:keep] = levels[k + 1][:keep]
                levels[k + 1] = grown
            child = levels[k]
            right_idx = 2 * parents + 1
            right = torch.where((right_idx < size)[:, None],
                                child[right_idx.clamp(max=size - 1)], zero[k])
            digests = yield (child[2 * parents], right)
            levels[k + 1][parents] = digests
            dirty = parents
            size = next_size
            k += 1
        del levels[k + 1:]
        self._root = self._cap(levels[k], k)
        self._pending = False

    def _cap(self, top: torch.Tensor, k: int) -> bytes:
        """The top of the occupied subtree, combined on the host with
        virtual zero subtrees up to the type limit's depth."""
        root = _row_bytes(top[:1])[0]
        for level in range(k, self._effective_depth(self.count)):
            root = sha256(root + ZERO_HASHES[level])
        return root


# --- validator registry -------------------------------------------------------------

class ValidatorRegistry(NamedTuple):
    """The ``List[Validator, VALIDATOR_REGISTRY_LIMIT]`` columns on a device.
    uint64 fields are int64 bit patterns: FAR_FUTURE_EPOCH = 2^64 - 1 is -1
    (``ops/epoch.i64_to_epoch_bits`` maps the dense registry's sentinel)."""

    pubkeys: torch.Tensor                       # uint8 (N, 48)
    withdrawal_credentials: torch.Tensor        # uint8 (N, 32)
    effective_balance: torch.Tensor             # int64 (N,)
    slashed: torch.Tensor                       # bool (N,)
    activation_eligibility_epoch: torch.Tensor  # int64 (N,)
    activation_epoch: torch.Tensor              # int64 (N,)
    exit_epoch: torch.Tensor                    # int64 (N,)
    withdrawable_epoch: torch.Tensor            # int64 (N,)


_EPOCH_COLS = ("activation_eligibility_epoch", "activation_epoch", "exit_epoch",
               "withdrawable_epoch")


def _le_bytes(col: torch.Tensor, byte_len: int) -> torch.Tensor:
    """(N,) column -> (N, byte_len) little-endian bytes (uint8 for 1 byte,
    int64 bit patterns for 8), read in the native byte order."""
    dtype = {1: torch.uint8, 8: torch.int64}[byte_len]
    return col.to(dtype).contiguous().view(torch.uint8).reshape(-1, byte_len)


def _validator_roots_rows(reg: ValidatorRegistry, idx: torch.Tensor | None = None,
                          *, plain: bool = False, combine=None) -> torch.Tensor:
    """hash_tree_root of each Validator of rows ``idx`` (all rows when
    None), as (k, 8) words: 8 field leaves per row, the 48-byte pubkey
    hashed as two chunks first, then a depth-3 merkle across all rows at
    once. Four ``pair_hash`` sweeps, whatever k is."""
    cols = reg if idx is None else ValidatorRegistry(*(c[idx] for c in reg))
    k = cols.effective_balance.shape[0]
    _STATS["validator_root_passes"] += 1
    pk = cols.pubkeys
    pk_hi = torch.zeros((k, 32), dtype=torch.uint8, device=pk.device)
    pk_hi[:, :16] = pk[:, 32:]
    leaves = torch.zeros((k, 8, 32), dtype=torch.uint8, device=pk.device)
    leaves[:, 1] = cols.withdrawal_credentials
    leaves[:, 2, :8] = _le_bytes(cols.effective_balance, 8)
    leaves[:, 3, 0] = cols.slashed.to(torch.uint8)
    for j, f in enumerate(_EPOCH_COLS):
        leaves[:, 4 + j, :8] = _le_bytes(getattr(cols, f), 8)
    words = rows_to_words(leaves).reshape(k, 8, 8)
    del leaves
    if combine is None:
        def combine(left, right):
            return pair_hash(left, right, plain=plain)
    words[:, 0] = combine(rows_to_words(pk[:, :32]), rows_to_words(pk_hi))
    layer = words.reshape(k * 8, 8)
    for _ in range(3):
        layer = combine(layer[0::2], layer[1::2])
    return layer


class RegistryTree:
    """Incremental validator-registry root.

    Keeps a copy of every registry column and the per-validator roots;
    ``root(reg)`` finds changed rows by column compare on the device,
    re-merkleizes only those validators and pushes their roots into a
    limit-capped ``ChunkTree``. ``dirty_rows``: rows re-merkleized by the
    last call.
    """

    __slots__ = ("_cols", "_roots", "_tree", "_limit", "dirty_rows")

    def __init__(self):
        self._cols: ValidatorRegistry | None = None
        self._roots: torch.Tensor | None = None
        self._tree: ChunkTree | None = None
        self._limit = -1
        self.dirty_rows = 0

    @property
    def tree(self) -> ChunkTree | None:
        """The chunk tree over the validator roots."""
        return self._tree

    def root(self, reg: ValidatorRegistry, limit: int, sweeper: LevelSweeper | None = None):
        """Incremental registry root, with ``ChunkTree.root``'s deferred
        contract: the dirty rows' validator roots are computed now (four
        sweeps), the chunk tree's update joins the sweeper."""
        plain = sweeper is not None and sweeper.plain
        n = reg.effective_balance.shape[0]
        if self._tree is None or limit != self._limit:
            self._limit = limit
            self._tree = ChunkTree(limit)
            self._cols = None
        if self._cols is None or n < self._roots.shape[0]:
            self._roots = (_validator_roots_rows(reg, plain=plain) if n
                           else torch.empty((0, 8), dtype=torch.int32,
                                            device=reg.effective_balance.device))
            self._cols = ValidatorRegistry(*(c.clone() for c in reg))
            self.dirty_rows = n
            dirty = torch.arange(n, device=self._roots.device)
        else:
            old_n = self._roots.shape[0]
            m = min(old_n, n)
            mask = torch.zeros(m, dtype=torch.bool, device=self._roots.device)
            for new_col, old_col in zip(reg, self._cols):
                d = new_col[:m] != old_col[:m]
                mask |= d.any(dim=1) if d.dim() == 2 else d
            dirty = torch.nonzero(mask).flatten()
            if n > old_n:
                dirty = torch.cat([dirty, torch.arange(old_n, n, device=dirty.device)])
            self.dirty_rows = int(dirty.numel())
            if self.dirty_rows:
                new_roots = _validator_roots_rows(reg, dirty, plain=plain)
                if n > old_n:
                    grown = torch.zeros((n, 8), dtype=torch.int32, device=self._roots.device)
                    grown[:old_n] = self._roots
                    self._roots = grown
                self._roots[dirty] = new_roots
                self._snapshot(reg, dirty, n)
        fin = self._tree.update_rows(self._roots, dirty, sweeper)
        if sweeper is None:
            return mix_in_length(fin, n)
        return lambda: mix_in_length(fin(), n)

    def _snapshot(self, reg: ValidatorRegistry, dirty: torch.Tensor, n: int) -> None:
        """Refresh the column copies for the rows just re-hashed."""
        if n != self._cols.effective_balance.shape[0]:
            self._cols = ValidatorRegistry(*(c.clone() for c in reg))
            return
        for new_col, old_col in zip(reg, self._cols):
            old_col[dirty] = new_col[dirty]


# --- state fields -------------------------------------------------------------------

def _pack_uint_chunks(col, byte_len: int):
    """Basic-uint list -> zero-padded 32-byte chunks: a tensor column
    (uint64 values as int64 bit patterns) gives (ceil(N * byte_len / 32), 8)
    words on its device; a numpy column gives (ceil(N * byte_len / 32), 32)
    uint8 rows on the host, the JAX package's contract."""
    if not isinstance(col, torch.Tensor):
        raw = np.ascontiguousarray(col).astype(f"<u{byte_len}").view(np.uint8).reshape(-1)
        if raw.size == 0:
            return np.empty((0, 32), dtype=np.uint8)
        padded = np.zeros(-(-raw.size // 32) * 32, dtype=np.uint8)
        padded[:raw.size] = raw
        return padded.reshape(-1, 32)
    raw = _le_bytes(col, byte_len).reshape(-1)
    n_bytes = raw.numel()
    padded = torch.zeros(-(-n_bytes // 32) * 32, dtype=torch.uint8, device=col.device)
    padded[:n_bytes] = raw
    return rows_to_words(padded)


class _TreeField:
    """A field backed by a ``ChunkTree`` (and the length mix-in of a list)."""

    __slots__ = ("chunker", "mix", "length_of", "tree")

    def __init__(self, chunker, mix: bool, length_of, limit: int | None, tree=None):
        self.chunker = chunker
        self.mix = mix
        self.length_of = length_of
        self.tree = ChunkTree(limit) if tree is None else tree

    def root(self, value) -> bytes:
        return self.root_deferred(value, None)()

    def root_deferred(self, value, sweeper):
        fin = self.tree.root(self.chunker(value), sweeper)
        if sweeper is None:
            root = fin
            fin = lambda: root  # noqa: E731 -- one finisher shape either way
        if not self.mix:
            return fin
        length = self.length_of(value)
        return lambda: mix_in_length(fin(), length)


class _RegistryField:
    """The validator registry as a state field, capped at ``limit``."""

    __slots__ = ("reg_tree", "limit")

    def __init__(self, limit: int):
        self.reg_tree = RegistryTree()
        self.limit = limit

    def root(self, value) -> bytes:
        return self.reg_tree.root(value, self.limit)

    def root_deferred(self, value, sweeper):
        fin = self.reg_tree.root(value, self.limit, sweeper)
        if sweeper is None:
            root = fin
            return lambda: root
        return fin


# --- the spec state's root: host columns, device trees ---------------------------------

_ENABLED = True


def set_enabled(flag: bool) -> bool:
    """When False, ``state_root`` merkleizes the whole state from scratch
    (``Container.htr``). Returns the previous value."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(flag)
    return prev


def _upload(a: np.ndarray, dev) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(dev)


class _MirroredTree:
    """A ``ChunkTree`` on ``device`` over host (N, 32) uint8 chunk rows. A
    host mirror of the rows last hashed finds the changed rows (a compare,
    not a hash); only they go to the device. ``root`` joins the caller's
    sweeper and returns a finisher, as ``ChunkTree.root`` does."""

    __slots__ = ("tree", "mirror", "device")

    def __init__(self, limit: int | None, device):
        self.tree = ChunkTree(limit)
        self.mirror: np.ndarray | None = None
        self.device = device

    def _words(self, rows: np.ndarray) -> torch.Tensor:
        return rows_to_words(_upload(rows, self.device))

    def root(self, chunks, sweeper: LevelSweeper):
        chunks = np.ascontiguousarray(chunks, dtype=np.uint8).reshape(-1, 32)
        n = chunks.shape[0]
        tree = self.tree
        if self.mirror is None or tree._stale(n):
            if tree.limit is not None and n > tree.limit:
                raise ValueError(f"{n} chunks exceed limit {tree.limit}")
            self.mirror = chunks.copy()
            return tree.rebuild(self._words(chunks), sweeper)
        m = tree.count
        if n == m and np.array_equal(self.mirror, chunks):
            dirty = np.empty(0, dtype=np.int64)
        else:
            dirty = np.nonzero((self.mirror[:m] != chunks[:m]).any(axis=1))[0]
            if n > m:
                dirty = np.concatenate([dirty, np.arange(m, n)])
                grown = np.zeros((n, 32), dtype=np.uint8)
                grown[:m] = self.mirror
                self.mirror = grown
            self.mirror[dirty] = chunks[dirty]
        return tree.update_leaves(n, _upload(dirty.astype(np.int64), self.device),
                                  self._words(chunks[dirty]), sweeper)


_SCALAR_COLS = ("effective_balance", "slashed") + _EPOCH_COLS
_ROW_COLS = ("pubkeys", "withdrawal_credentials")


class _HostRegistryTree:
    """The registry root of a spec ``ValidatorRegistry`` (host columns):
    host copies of the columns find the changed rows, only those rows go
    to the device, where their validator roots (``_validator_roots_rows``,
    four sweeps) feed a limit-capped ``ChunkTree``."""

    __slots__ = ("cols", "tree", "limit", "device", "dirty_rows")

    def __init__(self, device):
        self.cols: dict | None = None
        self.tree: ChunkTree | None = None
        self.limit = -1
        self.device = device
        self.dirty_rows = 0

    def _roots(self, reg, idx, combine) -> torch.Tensor:
        """Validator roots of rows ``idx`` (all when None) on the device."""
        pick = (lambda a: a) if idx is None else (lambda a: a[idx])
        cols = ValidatorRegistry(
            pubkeys=_upload(pick(reg.pubkeys), self.device),
            withdrawal_credentials=_upload(pick(reg.withdrawal_credentials), self.device),
            effective_balance=_upload(pick(reg.effective_balance).view(np.int64), self.device),
            slashed=_upload(pick(reg.slashed), self.device),
            **{f: _upload(pick(getattr(reg, f)).view(np.int64), self.device)
               for f in _EPOCH_COLS})
        if cols.effective_balance.shape[0] == 0:
            return torch.empty((0, 8), dtype=torch.int32, device=self.device)
        return _validator_roots_rows(cols, combine=combine)

    def root(self, reg, limit: int, sweeper: LevelSweeper):
        """The registry root's finisher; the validator roots of the
        changed rows are hashed now, with the sweeper's combiner."""
        n = len(reg)
        if self.tree is None or limit != self.limit:
            self.limit = limit
            self.tree = ChunkTree(limit)
            self.cols = None
        if self.cols is None or self.tree._stale(n):
            self.cols = {f: getattr(reg, f).copy() for f in _SCALAR_COLS + _ROW_COLS}
            self.dirty_rows = n
            fin = self.tree.rebuild(self._roots(reg, None, sweeper.combine), sweeper)
        else:
            old_n = self.tree.count
            m = min(old_n, n)
            dirty_mask = None
            for f in _SCALAR_COLS + _ROW_COLS:
                new_col, old_col = getattr(reg, f), self.cols[f]
                if new_col.shape[0] == old_col.shape[0] and np.array_equal(new_col, old_col):
                    continue
                d = new_col[:m] != old_col[:m]
                if d.ndim == 2:
                    d = d.any(axis=1)
                dirty_mask = d if dirty_mask is None else (dirty_mask | d)
            dirty = (np.nonzero(dirty_mask)[0] if dirty_mask is not None
                     else np.empty(0, dtype=np.int64))
            if n > old_n:
                dirty = np.concatenate([dirty, np.arange(old_n, n)])
            dirty = dirty.astype(np.int64)
            self.dirty_rows = int(dirty.size)
            if n != old_n:
                self.cols = {f: getattr(reg, f).copy() for f in _SCALAR_COLS + _ROW_COLS}
            else:
                for f in _SCALAR_COLS + _ROW_COLS:
                    self.cols[f][dirty] = getattr(reg, f)[dirty]
            fin = self.tree.update_leaves(n, _upload(dirty, self.device),
                                          self._roots(reg, dirty, sweeper.combine), sweeper)
        return lambda: mix_in_length(fin(), n)


class _SpecRegistryField:
    """The spec registry as a state field, capped at the active config's
    ``validator_registry_limit``."""

    __slots__ = ("reg_tree",)

    def __init__(self, device):
        self.reg_tree = _HostRegistryTree(device)

    def root_deferred(self, value, sweeper):
        from pos_evolution_tpu_torch.config import cfg
        return self.reg_tree.root(value, cfg().validator_registry_limit, sweeper)


class _SmallField:
    """Serialize-compare memo for cheap fields: equal serializations have
    equal roots (SSZ serialization is injective a sedes). Hashed on the
    host by the sedes."""

    __slots__ = ("sedes", "_blob", "_root")

    def __init__(self, sedes):
        self.sedes = sedes
        self._blob = None
        self._root = b""

    def root(self, value) -> bytes:
        blob = self.sedes.serialize(value)
        if blob == self._blob:
            _STATS["htr_cache_hit"] += 1
            return self._root
        _STATS["htr_cache_miss"] += 1
        self._blob = blob
        self._root = self.sedes.htr(value)
        return self._root

    def root_deferred(self, value, sweeper):
        root = self.root(value)
        return lambda: root


class ContainerTreeCache:
    """Incremental ``hash_tree_root`` of one spec container lineage, its
    trees on ``device`` (the active backend's by default). The registry,
    root-row vectors and lists and packed uint lists and vectors get
    mirrored device trees; every other field a ``_SmallField``. On a CUDA
    device the trees hash through K2 (``plain=True``: its plain version,
    the card's reference); on a CPU device through the host's SHA-256
    (``ops/merkle_device.host_pair_hash``), the route host rows take on a
    CPU backend."""

    def __init__(self, cls, device=None, *, plain: bool = False):
        from pos_evolution_tpu_torch.specs import containers as _c
        from pos_evolution_tpu_torch.ssz.core import _sedes_of
        self.cls = cls
        self.device = route_device() if device is None else torch.device(device)
        self.plain = bool(plain)
        self.host = self.device.type == "cpu"
        dev = self.device
        self.fields = {}
        for fname, s in cls._fields.items():
            sedes = _sedes_of(s)
            if isinstance(sedes, _c._RegistrySedes):
                self.fields[fname] = _SpecRegistryField(dev)
            elif isinstance(sedes, _c.Bytes32Rows):
                limit = sedes.limit if sedes.is_list else None
                self.fields[fname] = _TreeField(
                    chunker=lambda v: v, mix=sedes.is_list,
                    length_of=lambda v: np.asarray(v).reshape(-1, 32).shape[0],
                    limit=limit, tree=_MirroredTree(limit, dev))
            elif isinstance(sedes, _c._U64ListSedes):
                per_chunk = 32 // sedes.byte_len
                limit = (sedes.limit + per_chunk - 1) // per_chunk
                self.fields[fname] = _TreeField(
                    chunker=(lambda bl: lambda v: _pack_uint_chunks(v, bl))(sedes.byte_len),
                    mix=True, length_of=lambda v: np.asarray(v).shape[0],
                    limit=limit, tree=_MirroredTree(limit, dev))
            elif isinstance(sedes, _c._U64VectorSedes):
                self.fields[fname] = _TreeField(
                    chunker=lambda v: _pack_uint_chunks(v, 8), mix=False, length_of=None,
                    limit=None, tree=_MirroredTree(None, dev))
            else:
                self.fields[fname] = _SmallField(sedes)
        self.top = _MirroredTree(None, dev)

    def root(self, value) -> bytes:
        """One root: every dirty field's level sweeps in one lockstep pass
        (a K2 launch a level across all of them), then the field roots'
        tree."""
        _STATS["htr_calls"] += 1
        sweeper = LevelSweeper(plain=self.plain, host=self.host)
        finishers = [self.fields[f].root_deferred(getattr(value, f), sweeper)
                     for f in self.cls._fields]
        sweeper.run()
        roots = b"".join(fin() for fin in finishers)
        top = LevelSweeper(plain=self.plain, host=self.host)
        fin = self.top.root(np.frombuffer(roots, dtype=np.uint8).reshape(-1, 32), top)
        top.run()
        return fin()


def state_root(state) -> bytes:
    """``hash_tree_root`` of a spec ``BeaconState`` through its lineage's
    ``ContainerTreeCache`` on the active backend's device (a new cache
    when the state has none, or one of another class or device). With
    ``set_enabled(False)``: the whole state from scratch."""
    if not _ENABLED:
        return type(state).htr(state)
    dev = route_device()
    cache = state.__dict__.get("_htr_cache")
    if cache is None or cache.cls is not type(state) or cache.device != dev:
        cache = ContainerTreeCache(type(state), dev)
        state._htr_cache = cache
    return cache.root(state)
