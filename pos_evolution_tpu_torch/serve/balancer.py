"""Multi-front load balancing + the pipelined swarm load generator.

Two pieces that exist only at pool scale:

- ``Balancer`` — a seeded, health-biased front picker. The decision
  input is the shared segment's health board (``serve/shm.py``): every
  worker publishes (beat age, brownout flag, queue depth) into its slot,
  and the balancer weights each front by its workers' aggregate health —
  a front whose workers are all browned out gets a fraction of the
  traffic, a front with no live workers (mid-respawn) gets a trickle
  (probes must keep flowing or recovery is invisible). The *draw* stream
  is seeded per arrival, so runs replay; the weights react to live
  health, which is the point.

- ``SwarmLoadGenerator`` — the open-loop engine rebuilt for 10x the
  arrival rate. The thread-per-request ``LoadGenerator`` spends more CPU
  on Event round-trips than the server spends serving; at 20k+/s on a
  shared core that overhead IS the bottleneck. The swarm splits the loop
  into one **dispatcher** (walks the schedule, batches due frames into
  per-connection buffers, one ``sendall`` per batch) and one **reader
  thread per connection** (demultiplexes responses by id, records
  latency from the *scheduled* arrival — open-loop honesty unchanged).
  A connection killed mid-flight (worker SIGKILL) fails over: its
  pending requests are resent on a fresh connection to the same front —
  SO_REUSEPORT routes them to a surviving sibling — and counted as
  retries, never silently lost. Requests the server sheds with
  ``retry_after_ms`` are retried once within their deadline budget by a
  single timer thread (sheds are rare at interactive tier by
  construction; the timer thread is idle in the common case).

Every bulk response still verifies against its commitment post-run, and
anything unanswered at the drain deadline is recorded as ``lost`` —
the accounting invariant: records == schedule, always.
"""

from __future__ import annotations

import heapq
import json
import socket
import struct
import threading
import time
from bisect import bisect_right

import numpy as np

from pos_evolution_tpu_torch.serve.loadgen import LoadGenerator
from pos_evolution_tpu_torch.telemetry import fleet, tracing
from pos_evolution_tpu_torch.telemetry.tracing import record_span

__all__ = ["Balancer", "SwarmLoadGenerator"]

_LEN = struct.Struct(">I")


class Balancer:
    """Seeded weighted choice over fronts, biased by shared-segment
    health. ``slot_map[j]`` lists the health-board slots (worker front
    ids) serving front ``j``; with no board every front weighs 1.0.

    With a ``metrics_dir``, the fleet metrics pipeline adds a second,
    slower bias input: per-worker error fractions read from the beat
    snapshots (``telemetry/fleet.py``). The health board says a worker
    is *alive*; the metrics say whether it has been *answering well* —
    a worker timing out most of its requests still beats on time, and
    only its counters betray it."""

    STALE_S = 3.0

    def __init__(self, n_fronts: int, board=None,
                 slot_map: list[list[int]] | None = None,
                 refresh_s: float = 0.2,
                 metrics_dir: str | None = None,
                 metrics_refresh_s: float = 1.0):
        assert n_fronts > 0
        self.n_fronts = int(n_fronts)
        self.board = board
        self.slot_map = slot_map or [[j] for j in range(self.n_fronts)]
        assert len(self.slot_map) == self.n_fronts
        self.refresh_s = float(refresh_s)
        self.metrics_dir = metrics_dir
        self.metrics_refresh_s = float(metrics_refresh_s)
        self._lock = threading.Lock()
        self._at = -float("inf")
        self._bias_at = -float("inf")
        self._bias: dict[int, float] = {}
        # cumulative weights as a plain list: ``pick`` runs once per
        # arrival at 20k+/s, where a numpy scalar searchsorted costs
        # more than the whole frame encode — bisect is ~10x cheaper
        self._cum = [(j + 1) / self.n_fronts
                     for j in range(self.n_fronts)]
        self.refreshes = 0
        self.metrics_refreshes = 0

    def _metrics_bias(self) -> dict[int, float]:
        """Per-worker weight multiplier in [0.25, 1.0] from the fleet
        snapshot directory, cached for ``metrics_refresh_s`` (a scan
        rereads every snapshot file — far too heavy per refresh, let
        alone per pick). Workers with too few observed requests get no
        bias: early noise must not starve a cold worker."""
        if self.metrics_dir is None:
            return {}
        now = time.monotonic()
        if now - self._bias_at < self.metrics_refresh_s:
            return self._bias
        self._bias_at = now
        self.metrics_refreshes += 1
        agg = fleet.FleetAggregator.from_dir(self.metrics_dir)
        bias: dict[int, float] = {}
        for w, by_status in agg.worker_status_totals(
                "serve_requests_total").items():
            total = sum(by_status.values())
            if total < 32:
                continue
            bad = total - by_status.get("ok", 0) - by_status.get(
                "shed", 0)  # shed is honest load control, not illness
            try:
                bias[int(w)] = max(0.25, 1.0 - 2.0 * bad / total)
            except ValueError:
                continue
        self._bias = bias
        return bias

    def _weights(self) -> np.ndarray:
        rows = {r["front"]: r for r in self.board.read_health()}
        bias = self._metrics_bias()
        w = np.zeros(self.n_fronts)
        for j, slots in enumerate(self.slot_map):
            live = [rows[s] for s in slots
                    if s in rows and rows[s]["age_s"] < self.STALE_S]
            if not live:
                # mid-respawn front: a trickle keeps probing it — zero
                # traffic would make recovery invisible to the balancer
                w[j] = 0.05
                continue
            browned = sum(1 for r in live if r["brownout"])
            depth = sum(r["depth"] for r in live) / len(live)
            w[j] = len(live) * (0.3 if browned == len(live) else 1.0) \
                / (1.0 + depth / 64.0)
            if bias:
                mult = [bias[s] for s in slots if s in bias]
                if mult:
                    w[j] *= sum(mult) / len(mult)
        if w.sum() <= 0:
            w[:] = 1.0
        return w

    def pick(self, draw: float) -> int:
        """Front index for one seeded ``draw`` in [0, 1). Weights are
        recomputed at most every ``refresh_s`` (health reads are cheap
        but not free at 20k/s)."""
        if self.board is not None:
            now = time.monotonic()
            with self._lock:
                if now - self._at >= self.refresh_s:
                    self._at = now
                    w = self._weights()
                    total = float(w.sum())
                    acc, cum = 0.0, []
                    for v in w:
                        acc += float(v) / total
                        cum.append(acc)
                    self._cum = cum
                    self.refreshes += 1
                cum = self._cum
        else:
            cum = self._cum
        return min(bisect_right(cum, draw), self.n_fronts - 1)


class _SwarmConn:
    """One pipelined connection: socket + pending map + reader thread.

    ``pending[id] = (i, tier, sched, deadline_abs, body, method,
    resends)`` — everything needed to record the outcome or to resend
    the frame verbatim after a connection death."""

    def __init__(self, owner: "SwarmLoadGenerator", front: int,
                 addr: tuple[str, int]):
        self.owner = owner
        self.front = front
        self.addr = addr
        self.sock = socket.create_connection(addr, timeout=5.0)
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.plock = threading.Lock()
        self.pending: dict[int, tuple] = {}
        self.alive = True
        # writes happen on a per-connection WRITER thread: a front
        # whose worker falls behind fills its TCP buffer, and a
        # blocking sendall from the dispatcher would head-of-line
        # block every OTHER front's dispatch behind the slow one
        self._outbox: list[list] = []
        self._out_cond = threading.Condition()
        self.reader = threading.Thread(target=self._read_loop,
                                       name=f"swarm-read-f{front}",
                                       daemon=True)
        self.writer = threading.Thread(target=self._write_loop,
                                       name=f"swarm-write-f{front}",
                                       daemon=True)
        self.reader.start()
        self.writer.start()

    def send_batch(self, frames: list[tuple[int, bytes, tuple]]) -> bool:
        """Register a batch of (id, encoded frame, meta) and queue it
        for the writer thread; False when the connection is dead (the
        caller re-routes through failover)."""
        if not self.alive:
            return False
        with self.plock:
            for rid, _buf, meta in frames:
                self.pending[rid] = meta
        with self._out_cond:
            if not self.alive:
                # raced a death: roll back so the dying reader's sweep
                # and our False return cannot both claim the frames
                with self.plock:
                    for rid, _buf, _meta in frames:
                        self.pending.pop(rid, None)
                return False
            self._outbox.append(frames)
            self._out_cond.notify()
        return True

    def _write_loop(self) -> None:
        while True:
            with self._out_cond:
                while not self._outbox and self.alive:
                    self._out_cond.wait(0.25)
                if not self._outbox:
                    return  # dead and drained
                batches, self._outbox = self._outbox, []
            frames = [f for batch in batches for f in batch]
            try:
                self.sock.sendall(b"".join(buf for _, buf, _ in frames))
            except OSError:
                # the frames are registered in pending; the reader's
                # death sweep fails them over — just die loudly
                self._die()
                return

    def _die(self) -> None:
        # atomic publish: a single bool store that readers poll
        # lock-free on the send fast path
        # pev: ignore[PEV102]
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass
        with self._out_cond:
            self._out_cond.notify_all()

    def _read_loop(self) -> None:
        buf = bytearray()
        sock = self.sock
        while self.alive:
            try:
                chunk = sock.recv(1 << 16)
            except OSError:
                break  # dead socket: the sweep below fails pending over
            if not chunk:
                break
            buf.extend(chunk)
            while len(buf) >= _LEN.size:
                (length,) = _LEN.unpack(buf[:_LEN.size])
                if len(buf) < _LEN.size + length:
                    break
                body = bytes(buf[_LEN.size:_LEN.size + length])
                del buf[:_LEN.size + length]
                # fast path: the overwhelming majority of frames are
                # interactive "ok" replies whose only load-bearing
                # fields are id + status — at 20k+/s on a shared core,
                # json.loads on every one of them IS the client-side
                # capacity limit. Both server encodings open with
                # {"id":N, (compact cache hits and default json.dumps),
                # so the id ends at the first comma.
                rid = -1
                if body.startswith(b'{"id":'):
                    comma = body.find(b",", 6, 24)
                    digits = body[6:comma] if comma > 6 else b""
                    if digits.isdigit():
                        rid = int(digits)
                if rid >= 0 and (b'"status":"ok"' in body
                                 or b'"status": "ok"' in body):
                    with self.plock:
                        meta = self.pending.pop(rid, None)
                    if meta is None:
                        continue
                    # bulk results (and lc_update under verification)
                    # still need the payload — fall through to a full
                    # parse for those
                    if meta[1] == 0 and (meta[5] != "lc_update"
                                         or self.owner.verify_update
                                         is None):
                        self.owner._finish_ok(meta)
                        continue
                    try:
                        self.owner._on_response(json.loads(body), meta)
                    except json.JSONDecodeError:
                        self._die()
                        break
                    continue
                try:
                    resp = json.loads(body)
                except json.JSONDecodeError:
                    self._die()
                    break
                with self.plock:
                    meta = self.pending.pop(resp.get("id"), None)
                if meta is not None:
                    self.owner._on_response(resp, meta)
        # connection lost (worker SIGKILL, server stop): fail the
        # in-flight requests OVER to a fresh connection — the kernel
        # RST is the only notice a killed worker ever gives
        self._die()
        with self.plock:
            orphans = list(self.pending.items())
            self.pending.clear()
        if orphans:
            self.owner._failover(self.front, orphans)


class SwarmLoadGenerator(LoadGenerator):
    """Open-loop load at pool scale: one dispatcher, pipelined
    connections, balancer-routed fronts. Same seeded schedule, same
    deferred verification, same summary shape as ``LoadGenerator`` —
    only the dispatch engine differs."""

    def __init__(self, addrs: list[tuple[str, int]], n_arrivals: int,
                 rate: float, balancer: Balancer | None = None,
                 conns_per_front: int = 2, max_resends: int = 3,
                 **kw):
        kw.setdefault("bulk_fraction", 0.05)
        kw.setdefault("client_threads", 0)  # unused by the swarm engine
        super().__init__(tuple(addrs[0]), n_arrivals, rate, **kw)
        self.addrs = [tuple(a) for a in addrs]
        self.balancer = balancer or Balancer(len(self.addrs))
        assert self.balancer.n_fronts == len(self.addrs)
        self.conns_per_front = int(conns_per_front)
        self.max_resends = int(max_resends)
        rng = np.random.RandomState(self.seed ^ 0xBA1A)
        self._front_draw = rng.random_sample(self.n)
        self._conns: list[list[_SwarmConn | None]] = [
            [None] * self.conns_per_front for _ in self.addrs]
        self._conns_lock = threading.Lock()
        self._rr = 0
        # connect-refusal cooldown per front: a front whose whole
        # REUSEPORT group is dead refuses instantly — remember that
        # briefly instead of re-attempting the connect per arrival
        self._front_down = [0.0] * len(self.addrs)
        # once-only resolution per arrival: a connection-death sweep
        # and a send rollback can race into failing the SAME frames
        # over twice, and a duplicated resend would then resolve (and
        # count) one scheduled arrival twice
        self._resolved = bytearray(self.n)
        self._done = threading.Condition()
        # shed retries wait out their retry_after on ONE timer thread
        self._retry_heap: list[tuple] = []
        self._retry_cond = threading.Condition()
        self._stopping = False
        self.resends = 0
        self.shed_retries = 0
        self.lost = 0
        self.lost_by_reason: dict[str, int] = {}
        self.by_front = [0] * len(self.addrs)
        # arrival index -> trace id for sampled arrivals: written only
        # by the dispatcher, read by reader threads at resolution time
        self._traced: dict[int, str] = {}

    # -- connections -----------------------------------------------------------

    def _conn(self, front: int, k: int | None = None) -> _SwarmConn:
        """A live connection to ``front`` (round-robin across the
        front's slots), reconnecting through its SO_REUSEPORT group —
        after a worker kill the kernel hands the fresh socket to a
        surviving sibling."""
        with self._conns_lock:
            self._rr += 1
            idx = (self._rr if k is None else k) % self.conns_per_front
            c = self._conns[front][idx]
        if c is not None and c.alive:
            return c
        try:
            fresh = _SwarmConn(self, front, self.addrs[front])
        except OSError:
            with self._conns_lock:
                self._front_down[front] = time.monotonic() + 0.25
            raise
        with self._conns_lock:
            c = self._conns[front][idx]
            if c is not None and c.alive:
                winner = c
            else:
                self._conns[front][idx] = winner = fresh
        if winner is not fresh:
            fresh._die()
        return winner

    def _fresh_conn(self, front: int) -> _SwarmConn:
        """A NEWLY-connected conn to ``front``, installed in the grid.

        Failover must not trust pooled conns: when a worker is killed,
        ALL its connections die together but each ``alive`` flag lags
        until that conn's reader sees the RST — resending through the
        pool can hop orphans between doomed siblings until the resend
        quota burns out. A fresh TCP connect, by contrast, can only be
        accepted by a listener that is actually alive."""
        fresh = _SwarmConn(self, front, self.addrs[front])
        with self._conns_lock:
            self._rr += 1
            self._conns[front][self._rr % self.conns_per_front] = fresh
        return fresh

    def _send(self, conn: _SwarmConn,
              frames: list[tuple[int, bytes, tuple]]) -> None:
        """``send_batch`` that fails over instead of dropping: a batch
        rejected by a dead pipe re-enters through the same resend path
        a mid-flight connection death uses."""
        if not conn.send_batch(frames):
            self._failover(conn.front,
                           [(rid, meta) for rid, _buf, meta in frames])

    # -- outcome recording -----------------------------------------------------

    def _finish(self, i: int, tier: int, status: str, latency: float,
                result=None) -> None:
        with self._lock:
            if self._resolved[i]:
                return
            self._resolved[i] = 1
            self.records.append((tier, status, latency, 0))
            if status == "ok" and result is not None:
                if tier == 1:
                    self._bulk_results.append(result)
                elif "update" in result \
                        and self.verify_update is not None:
                    self._update_results.append(result)
            done = len(self.records) >= self.n
        trace = self._traced.get(i)
        if trace is not None:
            record_span(trace, "client", time.time() - latency,
                        latency * 1e3, status=status, tier=tier)
        if done:
            with self._done:
                self._done.notify_all()

    def _finish_ok(self, meta: tuple) -> None:
        """Record an interactive success straight from the byte-scan
        fast path — no parsed response object exists."""
        i, tier, sched, *_ = meta
        self._finish(i, tier, "ok", time.monotonic() - sched, None)

    def _on_response(self, resp: dict, meta: tuple) -> None:
        i, tier, sched, deadline_abs, body, method, resends = meta
        now = time.monotonic()
        status = resp.get("status", "error")
        if status in ("shed", "unavailable"):
            retry_s = float(resp.get("retry_after_ms", 1.0)) / 1e3
            due = now + retry_s
            if due < deadline_abs and resends < self.max_resends:
                with self._lock:
                    self.shed_retries += 1
                with self._retry_cond:
                    heapq.heappush(self._retry_heap,
                                   (due, i, tier, sched, deadline_abs,
                                    body, method, resends + 1))
                    self._retry_cond.notify()
                return
        self._finish(i, tier, status, now - sched,
                     resp.get("result") if status == "ok" else None)

    def _failover(self, front: int, orphans: list[tuple[int, tuple]]
                  ) -> None:
        """Resend a dead connection's in-flight requests; requests past
        their deadline (or out of resend budget) are recorded lost."""
        now = time.monotonic()
        resend: list[tuple[int, bytes, tuple]] = []
        for rid, meta in orphans:
            i, tier, sched, deadline_abs, body, method, resends = meta
            if now >= deadline_abs or resends >= self.max_resends \
                    or self._stopping:
                reason = ("stopping" if self._stopping
                          else "deadline" if now >= deadline_abs
                          else "resend_quota")
                with self._lock:
                    self.lost += 1
                    self.lost_by_reason[reason] = \
                        self.lost_by_reason.get(reason, 0) + 1
                self._finish(i, tier, "lost", now - sched)
                continue
            resend.append((rid, _LEN.pack(len(body)) + body,
                           (i, tier, sched, deadline_abs, body, method,
                            resends + 1)))
        if not resend:
            return
        with self._lock:
            self.resends += len(resend)
        n_fronts = len(self.addrs)
        for attempt in range(2 + n_fronts):
            if time.monotonic() < self._front_down[front]:
                front = (front + 1) % n_fronts
                continue
            try:
                conn = self._fresh_conn(front)
            except OSError:
                # whole front down (respawn backoff window): remember
                # it and rotate to the next front
                with self._conns_lock:
                    self._front_down[front] = time.monotonic() + 0.25
                front = (front + 1) % n_fronts
                continue
            if conn.send_batch(resend):
                return
        now = time.monotonic()
        for _rid, _body, meta in resend:
            i, tier, sched, *_ = meta
            with self._lock:
                self.lost += 1
                self.lost_by_reason["all_fronts_down"] = \
                    self.lost_by_reason.get("all_fronts_down", 0) + 1
            self._finish(i, tier, "lost", now - sched)

    def _retry_loop(self) -> None:
        while True:
            with self._retry_cond:
                while not self._retry_heap and not self._stopping:
                    self._retry_cond.wait(0.25)
                if self._stopping:
                    # the run is over: a shed we chose not to retry
                    # resolves as what the server last said it was
                    leftovers = list(self._retry_heap)
                    self._retry_heap.clear()
                    for item in leftovers:
                        _due, li, ltier, lsched = item[:4]
                        self._finish(li, ltier, "shed",
                                     time.monotonic() - lsched)
                    return
                due = self._retry_heap[0][0]
                now = time.monotonic()
                if due > now:
                    self._retry_cond.wait(min(due - now, 0.25))
                    continue
                item = heapq.heappop(self._retry_heap)
            due, i, tier, sched, deadline_abs, body, method, resends = item
            meta = (i, tier, sched, deadline_abs, body, method, resends)
            front = self.balancer.pick(float(self._front_draw[i]))
            try:
                conn = self._conn(front)
            except OSError:
                self._failover(front, [(i + 1, meta)])
                continue
            frame = (i + 1, _LEN.pack(len(body)) + body, meta)
            self._send(conn, [frame])

    # -- the dispatcher --------------------------------------------------------

    def _encode(self, i: int, targets: dict,
                trace: str | None = None) -> tuple[bytes, int, str,
                                                   float]:
        method, params, deadline, tier = self._build(i, targets)
        obj = {"id": i + 1, "method": method, "params": params,
               "deadline_ms": round(deadline * 1e3, 3), "tier": tier}
        if trace is not None:
            # trace member FIRST: traced frames must miss the servers'
            # byte-scan fast path (see serve/protocol.py)
            obj = {"trace": {"id": trace, "s": 1}, **obj}
        body = json.dumps(obj, separators=(",", ":")).encode()
        return body, tier, method, deadline

    def run(self) -> dict:
        targets_fn = self.targets_fn or (lambda: {"roots": [],
                                                  "n_cells": 0,
                                                  "n_blobs": {}})
        retry_thread = threading.Thread(target=self._retry_loop,
                                        name="swarm-retry", daemon=True)
        retry_thread.start()
        # the dispatch loop runs once per arrival at the full target
        # rate on a core it SHARES with the serving processes — numpy
        # scalar indexing and fresh json.dumps per interactive request
        # would eat the whole per-arrival budget. Schedule arrays drop
        # to plain lists; the three interactive frames (identical but
        # for the id) become prebuilt byte templates.
        offsets = self.offsets.tolist()
        is_bulk = self._is_bulk.tolist()
        front_draw = self._front_draw.tolist()
        pick1 = self._pick[:, 1].tolist()
        idl_ms = round(self.interactive_deadline_s * 1e3, 3)
        tmpl = {m: (f'{{"id":%d,"method":"{m}","params":{{}},'
                    f'"deadline_ms":{idl_ms},"tier":0}}').encode()
                for m in ("head", "finality", "lc_update")}
        pick_front = self.balancer.pick
        by_front = self.by_front
        pack = _LEN.pack
        monotonic = time.monotonic
        trace_rate = self.trace_rate
        trace_seed = self.trace_seed
        t_sample, t_id = tracing.sample, tracing.trace_id
        t_start = monotonic() + 0.05
        max_deadline = max(self.interactive_deadline_s,
                           self.bulk_deadline_s)
        idl_abs = self.interactive_deadline_s + 0.25
        batches: dict[_SwarmConn, list] = {}
        # per-front conn cache: `_conn` costs a lock + round-robin per
        # call, so the dispatcher holds one conn per front and rotates
        # only when a batch flushes on size — round-robin at batch
        # granularity, not per arrival
        conn_cache: list[_SwarmConn | None] = [None] * len(self.addrs)
        late = 0
        i = 0
        while i < self.n:
            now = monotonic()
            sched = t_start + offsets[i]
            if sched > now:
                # flush everything due before sleeping toward the next
                # arrival — batching bounds per-request syscall cost,
                # the sleep keeps the schedule honest
                for conn, frames in batches.items():
                    self._send(conn, frames)
                batches.clear()
                time.sleep(min(sched - now, 0.05))
                continue
            if now - sched > 0.005:
                late += 1
            trace = None
            if trace_rate > 0.0 and t_sample(trace_seed, i, trace_rate):
                trace = t_id(trace_seed, i)
                # single-writer: only this dispatch loop inserts; reader
                # threads .get() a key only after its send, and dict
                # item assignment is atomic  # pev: ignore[PEV101]
                self._traced[i] = trace
            if is_bulk[i]:
                targets = targets_fn()
                body, tier, method, deadline = self._encode(i, targets,
                                                            trace)
                deadline_abs = sched + deadline + 0.25
            else:
                r = pick1[i]
                method = ("head" if r < 0.4 else
                          "finality" if r < 0.7 else "lc_update")
                body = tmpl[method] % (i + 1)
                if trace is not None:
                    # splice the trace member in FRONT of the prebuilt
                    # template bytes — traced frames must fall off the
                    # servers' byte-scan fast path (serve/protocol.py)
                    body = (b'{"trace":{"id":"' + trace.encode()
                            + b'","s":1},' + body[1:])
                tier, deadline_abs = 0, sched + idl_abs
            front = pick_front(front_draw[i])
            if trace is not None:
                record_span(trace, "balancer_pick", time.time(), 0.0,
                            front=front, method=method)
            if monotonic() < self._front_down[front]:
                # known-dark front: rotate to the next one rather than
                # paying a guaranteed connection refusal
                for step in range(1, len(self.addrs)):
                    alt = (front + step) % len(self.addrs)
                    if monotonic() >= self._front_down[alt]:
                        front = alt
                        break
            by_front[front] += 1
            meta = (i, tier, sched, deadline_abs, body, method, 0)
            conn = conn_cache[front]
            if conn is None or not conn.alive:
                try:
                    conn = conn_cache[front] = self._conn(front)
                except OSError:
                    # a refused connect is a ROUTING event, not an
                    # outcome: the arrival fails over like any orphaned
                    # in-flight request and only becomes lost when
                    # every front is dark
                    conn_cache[front] = None
                    self._failover(front, [(i + 1, meta)])
                    i += 1
                    continue
            batch = batches.get(conn)
            if batch is None:
                batch = batches[conn] = []
            batch.append((i + 1, pack(len(body)) + body, meta))
            if len(batch) >= 64:
                self._send(conn, batches.pop(conn))
                conn_cache[conn.front] = None
            i += 1
        for conn, frames in batches.items():
            self._send(conn, frames)
        with self._lock:
            self.late_dispatch += late
        # drain: every scheduled arrival must resolve — answered,
        # retried to resolution, or recorded lost. No fourth outcome.
        drain_deadline = time.monotonic() + max_deadline + 3.0
        with self._done:
            while len(self.records) < self.n:
                remaining = drain_deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._done.wait(min(remaining, 0.25))
        with self._retry_cond:
            self._stopping = True
            self._retry_cond.notify_all()
        retry_thread.join(timeout=3.0)
        # anything STILL unresolved is lost, honestly
        with self._conns_lock:
            conns = [c for row in self._conns for c in row
                     if c is not None]
        for conn in conns:
            with conn.plock:
                orphans = list(conn.pending.items())
                conn.pending.clear()
            now = time.monotonic()
            for _rid, meta in orphans:
                li, ltier, lsched, *_ = meta
                with self._lock:
                    self.lost += 1
                self._finish(li, ltier, "lost", now - lsched)
        # the sweep reaches only the grid's connections: one a failover
        # displaced from its slot, and a retry the stopped retry thread
        # never sent, still hold arrivals. Lost all the same, so that
        # records == schedule
        now = time.monotonic()
        for li in range(self.n):
            with self._lock:
                if self._resolved[li]:
                    continue
                self.lost += 1
                self.lost_by_reason["unswept"] = \
                    self.lost_by_reason.get("unswept", 0) + 1
            self._finish(li, int(is_bulk[li]), "lost",
                         now - (t_start + offsets[li]))
        self.wall_s = time.monotonic() - t_start
        for conn in conns:
            conn._die()
        self._verify_deferred()
        return self.summary()

    def summary(self) -> dict:
        out = super().summary()
        out["engine"] = "swarm"
        out["fronts"] = len(self.addrs)
        out["by_front"] = list(self.by_front)
        out["resends"] = self.resends
        out["shed_retries"] = self.shed_retries
        out["lost"] = self.lost
        out["lost_by_reason"] = dict(self.lost_by_reason)
        out["traced"] = len(self._traced)
        out["balancer_refreshes"] = self.balancer.refreshes
        out["balancer_metrics_refreshes"] = \
            self.balancer.metrics_refreshes
        return out
