"""Seeded open-loop load generator: arrivals as a schedule, not a loop.

**Open-loop** is the property that makes the latency numbers honest: the
arrival schedule is computed up front from a seeded process and every
request's latency is measured from its *scheduled* arrival time — a
server that stalls does not slow the arrival rate down (clients in the
real world do not politely stop arriving), and queueing delay during the
stall lands in the percentiles instead of being coordinated-omitted
away.

Arrival patterns (all seeded, all reproducible):

- ``uniform`` — homogeneous Poisson at ``rate``;
- ``diurnal`` — sinusoid-modulated Poisson (the day/night swing,
  compressed to the run's duration);
- ``bursty`` — on/off bursts: seeded exponential on/off phases, 10x
  rate inside a burst;
- ``hotspot`` — uniform arrivals, but the *request mix* turns
  adversarial: most bulk traffic piles onto the newest block's cells,
  maximizing cache-miss collisions (the stampede the single-flight
  machinery exists for).

Chaos burst windows (``serve/chaos.py``) multiply the rate on top of
any pattern. Every bulk response is **verified against its
commitment** via the host sample-verification kernel — overload may
shed or slow traffic, but a single wrong proof fails the run.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from pos_evolution_tpu_torch.serve.client import ServeClient
from pos_evolution_tpu_torch.telemetry import tracing

__all__ = ["arrival_times", "discover_targets", "LoadGenerator"]

_PATTERNS = ("uniform", "diurnal", "bursty", "hotspot")


def arrival_times(pattern: str, n: int, rate: float, seed: int = 0,
                  burst_windows: tuple = ()) -> np.ndarray:
    """``n`` sorted arrival offsets (seconds) for a seeded arrival
    process with mean rate ``rate``; generated by thinning a homogeneous
    Poisson stream at the peak rate."""
    assert pattern in _PATTERNS, f"unknown arrival pattern {pattern!r}"
    assert rate > 0 and n > 0
    rng = np.random.RandomState(seed)
    if pattern == "bursty":
        # seeded on/off phases: ~20% of wall time in 10x bursts
        phases, t, on = [], 0.0, False
        horizon = 4.0 * n / rate
        while t < horizon:
            dur = float(rng.exponential(0.4 if on else 1.6)
                        * (n / rate) / 8.0)
            phases.append((t, t + dur, 10.0 if on else 0.5))
            t += dur
            on = not on
        def mult(ts):
            out = np.full_like(ts, 0.5)
            for lo, hi, m in phases:
                out[(ts >= lo) & (ts < hi)] = m
            return out
        peak = 10.0
    elif pattern == "diurnal":
        period = 2.0 * n / rate  # one "day" spans ~the whole run
        def mult(ts):
            return 0.55 + 0.45 * np.sin(2.0 * np.pi * ts / period)
        peak = 1.0
    else:  # uniform / hotspot share uniform arrivals
        def mult(ts):
            return np.ones_like(ts)
        peak = 1.0
    # burst windows MULTIPLY the pattern's own rate, so the thinning
    # peak must be the PRODUCT of the two maxima — taking the max would
    # let acceptance probability exceed 1 where a window overlaps an
    # on-phase and silently cap the realized burst below the schedule
    if burst_windows:
        peak *= max(float(m) for _lo, _hi, m in burst_windows)
    base_mult = mult

    def with_bursts(ts):
        out = base_mult(ts)
        for lo, hi, m in burst_windows:
            out[(ts >= lo) & (ts < hi)] *= float(m)
        return out

    # thinning: oversample the peak-rate stream, accept at rate(t)/peak
    times, t = [], 0.0
    while len(times) < n:
        gaps = rng.exponential(1.0 / (rate * peak), size=4 * n)
        cand = t + np.cumsum(gaps)
        accept = rng.random_sample(cand.shape[0]) < (
            with_bursts(cand) / peak)
        times.extend(cand[accept].tolist())
        t = float(cand[-1])
    return np.asarray(times[:n], dtype=np.float64)


def discover_targets(client: ServeClient, refresh_s: float = 0.2,
                     deadline_s: float = 0.25, stats: dict | None = None):
    """REMOTE target discovery:
    a ``targets_fn`` that learns its bulk targets from the front's own
    ``head`` + ``finality`` RPCs instead of in-process introspection —
    the generator can drive a front it did not build.

    ``head`` advertises the serving window's block roots, the grid
    geometry (``n_cells``) and per-root blob counts; ``finality`` pins
    the finalized/justified checkpoints the interactive mix asserts
    against. Responses are cached for ``refresh_s`` (a per-arrival poll
    would be self-inflicted interactive load); a failed poll keeps the
    last good targets — a brownout must degrade the bulk mix, not crash
    the generator. ``stats`` (optional dict) accumulates
    ``discoveries`` / ``failures`` counters for the run summary."""
    lock = threading.Lock()
    state = {"at": -float("inf"),
             "targets": {"roots": [], "n_cells": 0, "n_blobs": {}}}
    if stats is None:
        stats = {}
    stats.setdefault("discoveries", 0)
    stats.setdefault("failures", 0)

    def fn() -> dict:
        with lock:
            now = time.monotonic()
            if now - state["at"] < refresh_s:
                return state["targets"]
            state["at"] = now   # even on failure: don't hammer a sick front
        head = client.request("head", {}, deadline_s=deadline_s)
        if not head.ok:
            with lock:
                stats["failures"] += 1
            return state["targets"]
        h = head.result
        roots = list(h.get("das_roots") or [])
        targets = {
            "roots": roots,
            "n_cells": int(h.get("n_cells") or 0),
            "n_blobs": {r: int(c) for r, c in
                        (h.get("das_blobs") or {}).items()},
            "head_slot": h.get("head_slot"),
            "scheme": h.get("scheme") or "merkle",
        }
        fin = client.request("finality", {}, deadline_s=deadline_s)
        if fin.ok:
            targets["finalized_epoch"] = fin.result.get("finalized_epoch")
            targets["justified_epoch"] = fin.result.get("justified_epoch")
        with lock:
            stats["discoveries"] += 1
            state["targets"] = targets
        return targets

    return fn


class LoadGenerator:
    """Drive a ``ServeFront`` with a seeded open-loop request schedule.

    ``targets_fn()`` must return the current serving targets:
    ``{"roots": [hex...], "n_cells": int, "n_blobs": {hex: int}}`` —
    in-process runs read them off the ``ServingState``; pass
    ``discover=True`` (and no ``targets_fn``) to learn them remotely
    from the front's own ``head``/``finality`` RPCs instead
    (``discover_targets``).
    """

    def __init__(self, addr, n_arrivals: int, rate: float,
                 pattern: str = "uniform", seed: int = 0,
                 bulk_fraction: float = 0.7, samples_per_request: int = 4,
                 interactive_deadline_s: float = 0.25,
                 bulk_deadline_s: float = 1.0,
                 client_threads: int = 128, connections: int = 8,
                 hedge_ms: float | None = 50.0,
                 burst_windows: tuple = (), targets_fn=None,
                 verify_update=None, discover: bool = False,
                 discover_refresh_s: float = 0.2,
                 trace_rate: float = 0.0,
                 trace_seed: int | None = None, device="cuda"):
        self.addr = addr
        # where das_aggregate proofs are verified (the scheme's pairing)
        self.device = device
        self.n = int(n_arrivals)
        self.rate = float(rate)
        self.pattern = pattern
        self.seed = int(seed)
        self.bulk_fraction = float(bulk_fraction)
        self.samples_per_request = int(samples_per_request)
        self.interactive_deadline_s = float(interactive_deadline_s)
        self.bulk_deadline_s = float(bulk_deadline_s)
        self.client_threads = int(client_threads)
        self.burst_windows = tuple(burst_windows)
        self.targets_fn = targets_fn
        self.verify_update = verify_update
        self.client = ServeClient(addr, connections=connections,
                                  hedge_ms=hedge_ms)
        self.discovery_stats: dict | None = None
        if discover:
            assert targets_fn is None, \
                "discover=True replaces targets_fn with remote discovery"
            self.discovery_stats = {}
            self.targets_fn = discover_targets(
                self.client, refresh_s=discover_refresh_s,
                stats=self.discovery_stats)
        # end-to-end tracing: the sample decision is a
        # SEEDED pure function of the arrival index — no clock, no RNG
        # cursor (PEV002 decision scope) — so a replayed schedule traces
        # exactly the same requests, and client/server spans agree on
        # the id without coordination
        self.trace_rate = float(trace_rate)
        self.trace_seed = int(seed if trace_seed is None else trace_seed)
        self.traced = 0
        self.offsets = arrival_times(pattern, self.n, self.rate, seed,
                                     burst_windows=self.burst_windows)
        # per-arrival seeded draws, fixed before the run starts: the
        # schedule is a pure function of (pattern, n, rate, seed)
        rng = np.random.RandomState(seed ^ 0x5EED)
        self._is_bulk = rng.random_sample(self.n) < self.bulk_fraction
        self._pick = rng.random_sample((self.n, 2))
        self._cells = rng.randint(0, 1 << 30,
                                  size=(self.n, self.samples_per_request, 2))
        self._lock = threading.Lock()
        self._next = 0
        self.records: list[tuple] = []  # (tier, status, latency_s, hedges)
        # ok results parked for POST-RUN batch verification: verifying
        # inline would spend the load window's CPU on sha256 walks (the
        # generator and the server share one process) and pollute the
        # latency measurement; deferring changes when we check, never
        # whether — every served proof is still verified
        self._bulk_results: list[dict] = []
        self._agg_results: list[dict] = []
        self._update_results: list[dict] = []
        self._agg_memo: dict = {}  # scheme name -> aggregates flag
        self.verified = 0
        self.verify_failures = 0
        self.late_dispatch = 0
        self.errors: list[str] = []

    # -- request construction --------------------------------------------------

    def _build(self, i: int, targets: dict):
        hot = self.pattern == "hotspot"
        if self._is_bulk[i] and targets["roots"]:
            roots = targets["roots"]
            if hot and self._pick[i, 0] < 0.85:
                root = roots[0]  # newest block: adversarial pile-on
            else:
                root = roots[int(self._pick[i, 0] * len(roots))
                             % len(roots)]
            n_cells = int(targets["n_cells"])
            n_blobs = max(int(targets["n_blobs"].get(root, 1)), 1)
            draws = self._cells[i]
            if hot and self._pick[i, 1] < 0.85:
                # hotspot cells: collide on a handful of coordinates
                cells = (draws[:, 1] % max(n_cells // 8, 1)).tolist()
            else:
                cells = (draws[:, 1] % n_cells).tolist()
            samples = [[int(b % n_blobs), int(c)]
                       for b, c in zip(draws[:, 0], cells)]
            method = ("das_aggregate"
                      if self._scheme_aggregates(targets.get("scheme"))
                      else "das_cells")
            return (method, {"block_root": root, "samples": samples},
                    self.bulk_deadline_s, 1)
        r = self._pick[i, 1]
        method = ("head" if r < 0.4 else
                  "finality" if r < 0.7 else "lc_update")
        return (method, {}, self.interactive_deadline_s, 0)

    def _scheme_aggregates(self, name) -> bool:
        """Does the front's scheme serve ONE aggregated proof per
        sampled set (kzg/) instead of per-cell branches? Read off the
        registered class: no scheme is built and no device touched.
        Memoized — a registry lookup per arrival would be self-inflicted
        load."""
        if not name:
            return False
        flag = self._agg_memo.get(name)
        if flag is None:
            from pos_evolution_tpu_torch.das.commitment import scheme_class
            try:
                flag = bool(getattr(scheme_class(name), "aggregates", False))
            except ValueError:
                flag = False
            self._agg_memo[name] = flag  # idempotent  # pev: ignore[PEV101]
        return flag

    def _verify_agg_many(self, results: list[dict]) -> tuple[int, int]:
        """(verified, failed) over das_aggregate responses: decode each
        proof and run the scheme's pairing verification on the
        generator's device under the active config (the kzg geometry) —
        an aggregate front may shed traffic, but a wrong proof fails the
        run."""
        from pos_evolution_tpu_torch.config import cfg
        from pos_evolution_tpu_torch.das.commitment import get_scheme
        good = bad = 0
        for r in results:
            try:
                scheme = get_scheme(r["scheme"], self.device, cfg=cfg())
                samples = [(int(b), int(c)) for b, c in r["samples"]]
                cells = [np.frombuffer(bytes.fromhex(c), dtype=np.uint8)
                         for c in r["cells"]]
                proof = scheme.decode_proof(
                    [bytes.fromhex(p) for p in r["proof"]])
                wires = [bytes.fromhex(x) for x in r["commitments"]]
                ok = scheme.verify_aggregate(wires, samples, cells, proof)
            except (KeyError, ValueError, TypeError):
                ok = False
            if ok:
                good += 1
            else:
                bad += 1
        return good, bad

    def _verify_bulk(self, result: dict) -> bool:
        """Verify one das_cells response against its commitments."""
        return self._verify_bulk_many([result]) == (1, 0)

    def _verify_bulk_many(self, results: list[dict]) -> tuple[int, int]:
        """(requests fully verified, requests with ANY bad sample) over
        one concatenated host-kernel batch."""
        # imported lazily: ops.das_verify pulls the das package in, and
        # importing it at module scope from inside serve/ would close an
        # import cycle (serve -> ops.das_verify -> das -> serve)
        from pos_evolution_tpu_torch.ops.das_verify import (
            DasSampleBatch,
            verify_samples_host,
        )
        if not results:
            return 0, 0
        sizes = [len(r["cells"]) for r in results]
        total = sum(sizes)
        depth = max(max(int(r["n_cells"] - 1).bit_length(), 0)
                    for r in results)
        cell_bytes = len(results[0]["cells"][0]) // 2
        cells = np.zeros((total, cell_bytes), dtype=np.uint8)
        branches = np.zeros((total, depth, 32), dtype=np.uint8)
        indices = np.zeros(total, dtype=np.int64)
        commitments = np.zeros((total, 32), dtype=np.uint8)
        j = 0
        for r in results:
            for c, branch, idx, com in zip(r["cells"], r["branches"],
                                           r["indices"],
                                           r["commitments"]):
                cells[j] = np.frombuffer(bytes.fromhex(c), dtype=np.uint8)
                for d, sib in enumerate(branch):
                    branches[j, d] = np.frombuffer(bytes.fromhex(sib),
                                                   dtype=np.uint8)
                indices[j] = idx
                commitments[j] = np.frombuffer(bytes.fromhex(com),
                                               dtype=np.uint8)
                j += 1
        ok = verify_samples_host(DasSampleBatch(
            cells=cells, branches=branches, indices=indices,
            commitments=commitments))["ok"]
        good = bad = 0
        j = 0
        for size in sizes:
            if bool(ok[j:j + size].all()):
                good += 1
            else:
                bad += 1
            j += size
        return good, bad

    def _verify_deferred(self) -> None:
        good, bad = self._verify_bulk_many(self._bulk_results)
        agg_good, agg_bad = self._verify_agg_many(self._agg_results)
        good += agg_good
        bad += agg_bad
        update_good = update_bad = 0
        for result in self._update_results:
            if self.verify_update(result):
                update_good += 1
            else:
                update_bad += 1
        # single-threaded post-join epilogue (run() joins every runner
        # before verifying); locked anyway so the class keeps ONE counter
        # discipline — the lockset pass holds every method of a
        # lock-owning class to it
        with self._lock:
            self.verified += good + update_good
            self.verify_failures += bad + update_bad

    # -- the open loop ---------------------------------------------------------

    def _runner(self, t_start: float, targets_fn) -> None:
        while True:
            with self._lock:
                i = self._next
                if i >= self.n:
                    return
                self._next += 1
            sched = t_start + float(self.offsets[i])
            delay = sched - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            elif delay < -0.005:
                with self._lock:
                    self.late_dispatch += 1
            targets = targets_fn()
            method, params, deadline, tier = self._build(i, targets)
            trace = None
            if self.trace_rate > 0 and tracing.sample(
                    self.trace_seed, i, self.trace_rate):
                trace = tracing.trace_id(self.trace_seed, i)
                with self._lock:
                    self.traced += 1
            res = self.client.request(method, params, deadline_s=deadline,
                                      tier=tier, trace=trace)
            # latency from the SCHEDULED arrival: dispatch lag and
            # queueing during a stall both count (open-loop honesty)
            latency = time.monotonic() - sched
            with self._lock:
                self.records.append((tier, res.status, latency,
                                     res.hedges))
                if res.ok and method == "das_cells":
                    self._bulk_results.append(res.result)
                elif res.ok and method == "das_aggregate":
                    self._agg_results.append(res.result)
                elif res.ok and method == "lc_update" \
                        and self.verify_update is not None:
                    self._update_results.append(res.result)
                if res.status == "error" and res.error \
                        and len(self.errors) < 20:
                    self.errors.append(res.error)

    def run(self) -> dict:
        """Fire the whole schedule; returns ``summary()``."""
        targets_fn = self.targets_fn or (lambda: {"roots": [],
                                                  "n_cells": 0,
                                                  "n_blobs": {}})
        t_start = time.monotonic() + 0.05
        threads = [threading.Thread(target=self._runner,
                                    args=(t_start, targets_fn),
                                    name=f"loadgen-{k}", daemon=True)
                   for k in range(self.client_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.wall_s = time.monotonic() - t_start
        self._verify_deferred()
        return self.summary()

    # -- reporting -------------------------------------------------------------

    @staticmethod
    def _pct(xs: list[float], q: float) -> float:
        from pos_evolution_tpu_torch.utils.metrics import percentile_ms
        return percentile_ms(xs, q)

    def summary(self) -> dict:
        tiers = {}
        for tier, label in ((0, "interactive"), (1, "bulk")):
            rows = [r for r in self.records if r[0] == tier]
            by_status: dict[str, int] = {}
            for _, status, _, _ in rows:
                by_status[status] = by_status.get(status, 0) + 1
            ok_lat = [lat for _, st, lat, _ in rows if st == "ok"]
            n = len(rows)
            tiers[label] = {
                "arrivals": n,
                "by_status": by_status,
                "goodput_pct": round(100.0 * by_status.get("ok", 0)
                                     / n, 3) if n else None,
                "shed_pct": round(100.0 * (by_status.get("shed", 0)
                                           + by_status.get("unavailable",
                                                           0))
                                  / n, 3) if n else None,
                "p50_ms": self._pct(ok_lat, 50),
                "p99_ms": self._pct(ok_lat, 99),
                "p999_ms": self._pct(ok_lat, 99.9),
            }
        out = {
            "pattern": self.pattern,
            "arrivals": len(self.records),
            "scheduled": self.n,
            "rate": self.rate,
            "wall_s": round(getattr(self, "wall_s", 0.0), 3),
            "tiers": tiers,
            "hedges": self.client.hedges_sent,
            "retries": self.client.retries_sent,
            "verified_proofs": self.verified,
            "verify_failures": self.verify_failures,
            "late_dispatch": self.late_dispatch,
            "traced": self.traced,
            "trace_rate": self.trace_rate,
            "errors": self.errors[:5],
        }
        if self.discovery_stats is not None:
            out["remote_discovery"] = dict(self.discovery_stats)
        return out
