"""DAS serving layer: request coalescing, LRU proof caches, latency metrics.

The full-node side of serving 10^5+ sampling clients. The pipeline per
served block:

1. the population draws its seeded (blob, cell) coordinates — arrays,
   never per-client objects (das/sampler.py);
2. requests are **coalesced**: 10^5 clients x 8 samples collapse onto at
   most ``n_blobs x 2k`` unique cells, so proof building and
   verification cost scales with the grid, not the crowd;
3. unique cells are answered from an **LRU proof-path cache** (hot cells
   of recent blocks stay resident; misses batch-build branches off one
   shared leaf tree per blob, through a per-(block, blob) single-flight
   so a new block's cache miss populates ONCE under concurrency — the
   cache and the stampede suppression are shared with the socket-facing
   serve tier, ``serve/server.py``);
4. the coalesced batch runs the ``ExecutionBackend`` sample-verification
   kernel (``ops/das_verify.py``) once, and verdicts fan back out to
   clients by the coalescing inverse index.

The same LRU machinery caches **best light-client updates** by head root
(``best_update``), so the per-slot ``build_update`` proof construction
in the driver's light-client serving runs once per distinct head instead
of once per slot.

Per-request p50/p95 serving latency and cache hit/miss counts land on
the ``MetricsRegistry``; the driver emits one ``das_serve`` event per
served block, which ``scripts/run_report.py`` folds into its
"DAS serving" section.
"""

from __future__ import annotations

import hashlib
import threading
import time as _time
from collections import OrderedDict

import numpy as np

from pos_evolution_tpu_torch.config import cfg
from pos_evolution_tpu_torch.das.commitment import CellCommitmentScheme
from pos_evolution_tpu_torch.ops.das_verify import DasSampleBatch, verify_das_samples
from pos_evolution_tpu_torch.utils.singleflight import SingleFlight

__all__ = ["LRUCache", "DasServer"]

_MISS = object()


class LRUCache:
    """Minimal ordered-dict LRU with hit/miss counters (no extra deps).

    Concurrency-safe: the serving tier (``serve/server.py``) hits one
    shared cache from many worker threads, so every operation — lookup,
    insert+evict, clear — is atomic under one lock. ``move_to_end`` on a
    bare OrderedDict from two threads can corrupt the linked list; the
    lock is not optional hardening.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            v = self._d.get(key, _MISS)
            if v is _MISS:
                self.misses += 1
                return _MISS
            self._d.move_to_end(key)
            self.hits += 1
            return v

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def peek(self, key):
        """Lookup WITHOUT touching counters or recency — for the
        single-flight leader's double-check (its probes are bookkeeping,
        not client traffic, and must not inflate the hit rate)."""
        with self._lock:
            return self._d.get(key, _MISS)

    def clear(self) -> None:
        """Drop every entry (counters survive — the chaos mode's
        block-boundary cache wipe must stay visible in the hit rate)."""
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        # guarded: a freshly attached server reports 0.0, never ZeroDivision
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class DasServer:
    """Serves coalesced DAS samples (and cached best-updates) for one node."""

    def __init__(self, scheme: CellCommitmentScheme, registry=None,
                 proof_cache: int | LRUCache = 4096, update_cache: int = 64,
                 flight=None):
        self.scheme = scheme
        self.registry = registry
        # an existing LRUCache instance is shared as-is: the serve tier
        # (serve/server.py) and the in-process vectorized path warm the
        # SAME proof cache, so a block served to sockets answers the
        # sampling population from cache and vice versa
        self.proof_cache = (proof_cache if isinstance(proof_cache, LRUCache)
                            else LRUCache(proof_cache))
        self.update_cache = LRUCache(update_cache)
        # stampede suppression: a new-block miss populates the proof
        # cache ONCE per (block, blob) however many threads miss
        # concurrently; scheme_builds counts actual backing builds (the
        # regression contract of tests/test_serve.py). A worker PROCESS
        # passes a ``utils/singleflight.ProcessFlight`` here so the
        # same guarantee holds across the whole pool: one backing build
        # per (block, blob) however many processes stampede.
        self._flight = flight if flight is not None else SingleFlight()
        self.scheme_builds = 0
        self._stats_lock = threading.Lock()
        self.served_blocks = 0
        self.samples_served = 0

    # -- light-client best-update caching --------------------------------------

    def best_update(self, store, head_root: bytes, archive=None):
        """``lightclient.server.build_update`` memoized by head root —
        proofs for one head are built once however many slots (or
        clients) ask for it."""
        key = bytes(head_root)
        cached = self.update_cache.get(key)
        if cached is not _MISS:
            self._count("das_update_cache_hits_total",
                        "best-update LRU hits")
            return cached
        from pos_evolution_tpu_torch.lightclient.server import build_update
        update = build_update(store, head_root, archive=archive)
        self.update_cache.put(key, update)
        self._count("das_update_cache_misses_total",
                    "best-update LRU misses (built fresh)")
        return update

    # -- sample serving --------------------------------------------------------

    def _count(self, name: str, help_: str, n: int = 1) -> None:
        if self.registry is not None:
            self.registry.counter(name, help_).inc(n)

    def build_blob_proofs(self, block_root: bytes, blob: int,
                          sidecar) -> dict[int, tuple]:
        """All of one blob's (cell, branch) pairs, built at most once per
        concurrent set of requesters (single-flight) and left in the
        proof-path cache.

        This is the new-block stampede path: before the single-flight,
        every concurrent requester that missed the cache re-ran the
        backing-scheme branch build for the same blob. The leader builds
        the WHOLE grid's branches off one shared leaf tree (the same
        amortized cost as building the missed subset, since the tree
        dominates) and populates the cache; waiters block on the leader
        and read its result. ``scheme_builds`` counts actual backing
        builds — the regression contract: concurrent misses on a fresh
        block bump it once per blob, not once per requester.
        """
        def _build() -> dict[int, tuple]:
            grid = np.ascontiguousarray(sidecar.cells, dtype=np.uint8)
            n = grid.shape[0]
            # double-check under the flight: a caller whose miss was
            # observed BEFORE an earlier flight finished lands here
            # after it — the cache already holds every cell, so there
            # is nothing left to build (this is what makes "one build
            # per (block, blob)" exact, not just likely)
            cached = {cell: self.proof_cache.peek((block_root, blob, cell))
                      for cell in range(n)}
            if all(v is not _MISS for v in cached.values()):
                return cached
            _leaves, built = self.scheme.branches(grid, list(range(n)))
            with self._stats_lock:
                self.scheme_builds += 1
            out = {}
            for cell in range(n):
                pair = (grid[cell].copy(), built[cell].copy())
                self.proof_cache.put((block_root, blob, cell), pair)
                out[cell] = pair
            return out

        def _absorb(built: dict) -> None:
            # another PROCESS led this build (cross-process flight):
            # populate our per-process LRU from its spooled result —
            # a cache fill, not a backing build, so scheme_builds
            # stays untouched (the global one-build-per-blob pin)
            for cell, pair in built.items():
                self.proof_cache.put((block_root, blob, cell), pair)

        key = ("blob_proofs", block_root, blob)
        if getattr(self._flight, "wants_absorb", False):
            return self._flight.do(key, _build, absorb=_absorb)
        return self._flight.do(key, _build)

    # -- aggregated proofs (kzg/ schemes with scheme.aggregates) ---------------

    @staticmethod
    def _coords_digest(coords) -> bytes:
        return hashlib.sha256(
            b"".join(b"%d:%d;" % (int(b), int(c)) for b, c in coords)
        ).digest()

    def build_aggregate_proof(self, block_root: bytes, sidecars: list,
                              coords) -> dict:
        """ONE opening proof for everything the population sampled from
        one block (``scheme.prove_aggregate``), built once per (block,
        sampled set) under the same single-flight/cache machinery as the
        branch path — the serve tier and the in-process sampling round
        share the cached aggregate, and concurrent misses on a fresh
        block bump ``scheme_builds`` once, not once per requester."""
        coords = tuple((int(b), int(c)) for b, c in coords)
        cache_key = ("das_agg", bytes(block_root), self._coords_digest(coords))
        hit = self.proof_cache.get(cache_key)
        if hit is not _MISS:
            return hit

        def _build() -> dict:
            cached = self.proof_cache.peek(cache_key)
            if cached is not _MISS:
                return cached
            grids = [np.ascontiguousarray(sc.cells, dtype=np.uint8)
                     for sc in sidecars]
            proof = self.scheme.prove_aggregate(grids, coords)
            with self._stats_lock:
                self.scheme_builds += 1
            self.proof_cache.put(cache_key, proof)
            return proof

        def _absorb(proof: dict) -> None:
            self.proof_cache.put(cache_key, proof)

        if getattr(self._flight, "wants_absorb", False):
            return self._flight.do(cache_key, _build, absorb=_absorb)
        return self._flight.do(cache_key, _build)

    def _serve_samples_aggregate(self, block_root: bytes, sidecars: list,
                                 blob_ids, cell_ids, uniq, inverse) -> dict:
        """Aggregate-scheme serving: instead of per-cell branches, the
        whole coalesced sampled set is answered by ONE opening proof and
        ONE pairing verification — proof bytes per sample collapse from
        depth*32 to |proof|/samples (the ISSUE 17 acceptance cut)."""
        c = cfg()
        n_cells = 2 * c.das_cells_per_blob
        u = uniq.shape[0]
        n_samples = int(blob_ids.size)
        coords = tuple((int(k) // n_cells, int(k) % n_cells) for k in uniq)

        h0 = self.proof_cache.hits
        t0 = _time.perf_counter()
        proof = self.build_aggregate_proof(bytes(block_root), sidecars,
                                           coords)
        build_s = _time.perf_counter() - t0
        cache_hit = self.proof_cache.hits > h0

        cells = [np.ascontiguousarray(sidecars[b].cells, dtype=np.uint8)[ci]
                 for b, ci in coords]
        wire_commitments = [bytes(sc.commitment) for sc in sidecars]
        t0 = _time.perf_counter()
        ok = bool(self.scheme.verify_aggregate(wire_commitments, coords,
                                               cells, proof))
        verify_s = _time.perf_counter() - t0
        per_req = (build_s + verify_s) / u
        latency = np.full(u, per_req, dtype=np.float64)

        proof_bytes = int(self.scheme.proof_n_bytes(proof))
        failed = 0 if ok else u
        clients = int(blob_ids.shape[0])
        with self._stats_lock:
            self.served_blocks += 1
            self.samples_served += n_samples
        self._count("das_samples_total",
                    "client cell samples served (pre-coalescing)", n_samples)
        self._count("das_unique_requests_total",
                    "coalesced unique (blob, cell) fetches", u)
        self._count("das_aggregate_proofs_total",
                    "aggregated opening proofs served")
        self._count("das_aggregate_proof_bytes_total",
                    "bytes of aggregated opening proofs served", proof_bytes)
        if failed:
            self._count("das_sample_verify_failures_total",
                        "samples whose proof failed verification", failed)
        if self.registry is not None:
            hist = self.registry.histogram(
                "das_request_seconds",
                "per coalesced request serving latency")
            for v in latency:
                hist.observe(float(v))

        return {
            "clients": clients,
            "samples": n_samples,
            "unique_requests": int(u),
            "coalescing": round(n_samples / u, 2),
            "blobs": len(sidecars),
            "cache_hits": int(bool(cache_hit)),
            "cache_misses": int(not cache_hit),
            "cache_hit_rate": round(self.proof_cache.hit_rate, 4),
            "verified": n_samples if ok else 0,
            "failed": failed,
            "clients_all_ok": clients if ok else 0,
            "p50_ms": round(per_req * 1e3, 4),
            "p95_ms": round(per_req * 1e3, 4),
            "verify_ms": round(verify_s * 1e3, 4),
            "scheme": self.scheme.name,
            "aggregated": True,
            "proof_bytes": proof_bytes,
            "proof_bytes_per_sample": round(proof_bytes / n_samples, 4),
        }

    def serve_samples(self, block_root: bytes, sidecars: list,
                      population) -> dict:
        """One block's sampling round for the whole population. Returns
        the summary dict the driver emits as a ``das_serve`` event."""
        c = cfg()
        n_cells = 2 * c.das_cells_per_blob
        n_blobs = len(sidecars)
        assert n_blobs > 0, "serve_samples needs at least one sidecar"
        blob_ids, cell_ids = population.select_cells(
            bytes(block_root), n_blobs, n_cells)
        flat = (blob_ids * n_cells + cell_ids).reshape(-1)
        uniq, inverse = np.unique(flat, return_inverse=True)
        u = uniq.shape[0]

        if getattr(self.scheme, "aggregates", False):
            # kzg-style schemes: no branch walk — one opening proof for
            # the whole coalesced set, one pairing verification
            return self._serve_samples_aggregate(
                bytes(block_root), sidecars, blob_ids, cell_ids,
                uniq, inverse)

        depth = self.scheme.depth_for(n_cells)
        cells = np.zeros((u, c.das_cell_bytes), dtype=np.uint8)
        branches = np.zeros((u, depth, 32), dtype=np.uint8)
        indices = np.zeros(u, dtype=np.int64)
        commitments = np.zeros((u, 32), dtype=np.uint8)
        latency = np.zeros(u, dtype=np.float64)

        # phase 1: cache lookups (individually timed — they ARE the fast path)
        miss_by_blob: dict[int, list[int]] = {}
        for j, key_flat in enumerate(uniq):
            blob, cell = int(key_flat) // n_cells, int(key_flat) % n_cells
            indices[j] = cell
            commitments[j] = np.frombuffer(
                bytes(sidecars[blob].commitment), dtype=np.uint8)
            t0 = _time.perf_counter()
            hit = self.proof_cache.get((bytes(block_root), blob, cell))
            latency[j] = _time.perf_counter() - t0
            if hit is _MISS:
                miss_by_blob.setdefault(blob, []).append(j)
            else:
                cells[j], branches[j] = hit

        # phase 2: batch-build missing branches through the per-(block,
        # blob) single-flight — one shared leaf tree per blob, built ONCE
        # even when many threads miss the same new block concurrently
        for blob, slots in miss_by_blob.items():
            t0 = _time.perf_counter()
            built = self.build_blob_proofs(bytes(block_root), blob,
                                           sidecars[blob])
            for j in slots:
                cells[j], branches[j] = built[int(indices[j])]
            per = (_time.perf_counter() - t0) / len(slots)
            for j in slots:
                latency[j] += per

        # phase 3: ONE backend verification call for the coalesced batch
        t0 = _time.perf_counter()
        result = verify_das_samples(DasSampleBatch(
            cells=cells, branches=branches, indices=indices,
            commitments=commitments))
        verify_s = _time.perf_counter() - t0
        latency += verify_s / u

        ok_flat = result["ok"][inverse].reshape(blob_ids.shape)
        clients_ok = int(ok_flat.all(axis=1).sum())
        n_samples = int(flat.shape[0])
        failed = int((~result["ok"]).sum())

        with self._stats_lock:
            self.served_blocks += 1
            self.samples_served += n_samples
        cache_hits = u - sum(len(s) for s in miss_by_blob.values())
        self._count("das_samples_total",
                    "client cell samples served (pre-coalescing)", n_samples)
        self._count("das_unique_requests_total",
                    "coalesced unique (blob, cell) fetches", u)
        self._count("das_proof_cache_hits_total",
                    "proof-path LRU hits", cache_hits)
        self._count("das_proof_cache_misses_total",
                    "proof-path LRU misses", u - cache_hits)
        if failed:
            self._count("das_sample_verify_failures_total",
                        "samples whose branch failed verification", failed)
        if self.registry is not None:
            hist = self.registry.histogram(
                "das_request_seconds",
                "per coalesced request serving latency")
            for v in latency:
                hist.observe(float(v))

        return {
            "clients": int(blob_ids.shape[0]),
            "samples": n_samples,
            "unique_requests": int(u),
            "coalescing": round(n_samples / u, 2),
            "blobs": n_blobs,
            "cache_hits": int(cache_hits),
            "cache_misses": int(u - cache_hits),
            "cache_hit_rate": round(self.proof_cache.hit_rate, 4),
            "verified": int(result["ok"].sum()),
            "failed": failed,
            "clients_all_ok": clients_ok,
            "p50_ms": round(float(np.percentile(latency, 50)) * 1e3, 4),
            "p95_ms": round(float(np.percentile(latency, 95)) * 1e3, 4),
            "verify_ms": round(verify_s * 1e3, 4),
            # proof-bytes accounting, comparable with the aggregate
            # path: every sample ships its own depth*32-byte branch
            "scheme": self.scheme.name,
            "aggregated": False,
            "proof_bytes": int(n_samples * depth * 32),
            "proof_bytes_per_sample": float(depth * 32),
        }
