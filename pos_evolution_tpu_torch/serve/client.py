"""Serving-tier client library: deadlines, hedged retries, honest backoff.

The client half of the tail-latency contract:

- every request carries a **deadline budget**; retries and hedges spend
  the same budget (a client that retries past its own deadline is a
  retry storm, not a client);
- a request that has not answered within the **hedge delay** is sent
  again on a DIFFERENT connection (a second chance to land on a worker
  that is not stalled) — first response wins, the loser is discarded by
  id; hedging is capped at one duplicate per attempt, the
  tail-at-scale-safe amount;
- a ``shed`` / ``unavailable`` answer carries ``retry_after_ms`` — the
  client sleeps exactly that (clamped to its remaining budget) before
  retrying: the server said when capacity is expected, guessing harder
  is worse for everyone;
- responses are demultiplexed by ``id`` on a per-connection reader
  thread, so any number of caller threads share a small connection pool
  with pipelining.

``ClientResult`` reports what actually happened (status, attempts,
hedges) — the load generator's goodput/shed accounting is built on it.
"""

from __future__ import annotations

import itertools
import socket
import threading
import time

from pos_evolution_tpu_torch.serve.protocol import ProtocolError, recv_frame, send_frame
from pos_evolution_tpu_torch.telemetry.tracing import record_span

__all__ = ["ServeClient", "ClientResult"]

_ids = itertools.count(1)
_ids_lock = threading.Lock()


def _next_id() -> int:
    with _ids_lock:
        return next(_ids)


class ClientResult:
    __slots__ = ("status", "result", "attempts", "hedges", "retries",
                 "latency_s", "reason", "error")

    def __init__(self, status: str, result=None, attempts: int = 1,
                 hedges: int = 0, retries: int = 0,
                 latency_s: float = 0.0, reason: str | None = None,
                 error: str | None = None):
        self.status = status
        self.result = result
        self.attempts = attempts
        self.hedges = hedges
        self.retries = retries
        self.latency_s = latency_s
        self.reason = reason
        self.error = error

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class _Channel:
    """One pooled connection: socket + reader thread demuxing by id."""

    def __init__(self, addr: tuple[str, int], connect_timeout: float):
        self.sock = socket.create_connection(addr, timeout=connect_timeout)
        self.sock.settimeout(None)
        # without TCP_NODELAY, small frames sit in Nagle's buffer
        # waiting on the peer's delayed ACK — a 40ms floor per
        # request/response ping-pong that looks like server latency
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.wlock = threading.Lock()
        self.pending: dict[int, tuple[threading.Event, list]] = {}
        self.plock = threading.Lock()
        self.alive = True
        self.reader = threading.Thread(target=self._read_loop,
                                       name="serve-client-reader",
                                       daemon=True)
        self.reader.start()

    def _read_loop(self) -> None:
        while self.alive:
            try:
                resp = recv_frame(self.sock)
            # not a swallow: the None sentinel drops through to the
            # connection-lost path below, which fails every waiter loudly
            except (ProtocolError, OSError):  # pev: ignore[PEV005]
                resp = None
            if resp is None:
                self.alive = False
                with self.plock:
                    waiters = list(self.pending.values())
                    self.pending.clear()
                for event, slot in waiters:
                    slot.append({"status": "error",
                                 "error": "connection lost"})
                    event.set()
                return
            with self.plock:
                waiter = self.pending.pop(resp.get("id"), None)
            if waiter is not None:
                event, slot = waiter
                slot.append(resp)
                event.set()
            # an unknown id is a hedge loser arriving after its twin won
            # — dropped by design

    def post(self, frame: dict,
             event: threading.Event | None = None
             ) -> tuple[threading.Event, list] | None:
        """Register a waiter and send; None when the channel is dead.
        A caller-provided ``event`` lets a primary and its hedge share
        one wakeup — whichever response lands first sets it."""
        if not self.alive:
            return None
        event, slot = event or threading.Event(), []
        with self.plock:
            self.pending[frame["id"]] = (event, slot)
        try:
            with self.wlock:
                send_frame(self.sock, frame)
        except OSError:
            self.alive = False
            with self.plock:
                self.pending.pop(frame["id"], None)
            return None
        return event, slot

    def forget(self, rid: int) -> None:
        with self.plock:
            self.pending.pop(rid, None)

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass


class ServeClient:
    """Thread-safe pooled client with hedging + retry-after semantics."""

    def __init__(self, addr: tuple[str, int], connections: int = 2,
                 hedge_ms: float | None = 50.0, max_retries: int = 3,
                 connect_timeout: float = 5.0):
        self.addr = (addr[0], int(addr[1]))
        self.n_connections = max(int(connections), 1)
        self.hedge_ms = hedge_ms
        self.max_retries = int(max_retries)
        self.connect_timeout = float(connect_timeout)
        self._channels: list[_Channel | None] = [None] * self.n_connections
        self._chan_lock = threading.Lock()
        self._rr = itertools.count()
        self.hedges_sent = 0
        self.retries_sent = 0
        self._stats_lock = threading.Lock()

    def _channel(self, index: int) -> _Channel:
        index %= self.n_connections
        with self._chan_lock:
            ch = self._channels[index]
        if ch is not None and ch.alive:
            return ch
        # connect OUTSIDE the pool lock: a blocking reconnect (up to
        # connect_timeout) held under it would stall every caller —
        # including the hedges whose whole job is routing around stalls
        fresh = _Channel(self.addr, self.connect_timeout)
        with self._chan_lock:
            ch = self._channels[index]
            if ch is not None and ch.alive:
                winner = ch  # another thread reconnected first
            else:
                self._channels[index] = winner = fresh
        if winner is not fresh:
            fresh.close()
        return winner

    def close(self) -> None:
        with self._chan_lock:
            for ch in self._channels:
                if ch is not None:
                    ch.close()
            self._channels = [None] * self.n_connections

    # -- the request state machine ---------------------------------------------

    def request(self, method: str, params: dict | None = None,
                deadline_s: float = 1.0, tier: int = 1,
                hedge_ms: float | None = None,
                trace: str | None = None) -> ClientResult:
        """One logical request under one deadline budget: send, hedge
        once per attempt after ``hedge_ms``, honor retry-after on shed,
        give up (honestly) when the budget is gone. ``trace`` (a sampled
        trace id from ``telemetry/tracing.py``) rides every frame of
        this logical request — primary, hedge, retry — and records one
        client-side span over the whole state machine."""
        t_wall = time.time()
        res = self._request(method, params, deadline_s, tier, hedge_ms,
                            trace)
        if trace is not None:
            record_span(trace, "client", t_wall, res.latency_s * 1e3,
                        method=method, status=res.status,
                        attempts=res.attempts, hedges=res.hedges,
                        retries=res.retries)
        return res

    def _request(self, method: str, params: dict | None,
                 deadline_s: float, tier: int,
                 hedge_ms: float | None,
                 trace: str | None) -> ClientResult:
        t_start = time.monotonic()
        expires = t_start + float(deadline_s)
        hedge_ms = self.hedge_ms if hedge_ms is None else hedge_ms
        attempts = hedges = retries = 0
        last: dict | None = None
        while True:
            remaining = expires - time.monotonic()
            if remaining <= 0 or attempts > self.max_retries:
                status = "timeout" if last is None else last.get(
                    "status", "timeout")
                return ClientResult(
                    "timeout" if status == "ok" else status,
                    attempts=attempts, hedges=hedges, retries=retries,
                    latency_s=time.monotonic() - t_start,
                    reason=(last or {}).get("reason"),
                    error=(last or {}).get("error"))
            attempts += 1
            resp, hedged = self._attempt(method, params, remaining, tier,
                                         hedge_ms, trace=trace)
            hedges += hedged
            if resp is None or resp.get("error") == "connection lost":
                continue  # channel died — next attempt reconnects
            status = resp.get("status")
            if status == "ok":
                with self._stats_lock:
                    self.hedges_sent += hedges
                    self.retries_sent += retries
                return ClientResult("ok", result=resp.get("result"),
                                    attempts=attempts, hedges=hedges,
                                    retries=retries,
                                    latency_s=time.monotonic() - t_start)
            last = resp
            if status in ("shed", "unavailable"):
                retry_after = float(resp.get("retry_after_ms", 1.0)) / 1e3
                remaining = expires - time.monotonic()
                if retry_after >= remaining:
                    # the server's own estimate says capacity returns
                    # after our deadline — retrying would be dishonest
                    with self._stats_lock:
                        self.retries_sent += retries
                    return ClientResult(status, attempts=attempts,
                                        hedges=hedges, retries=retries,
                                        latency_s=(time.monotonic()
                                                   - t_start),
                                        reason=resp.get("reason"))
                retries += 1
                time.sleep(retry_after)
            elif status == "error":
                with self._stats_lock:
                    self.retries_sent += retries
                return ClientResult("error", attempts=attempts,
                                    hedges=hedges, retries=retries,
                                    latency_s=time.monotonic() - t_start,
                                    error=resp.get("error"))
            # status == "timeout": the server refused expired work; fall
            # through and retry within whatever budget remains
            else:
                retries += 1

    def _attempt(self, method, params, budget_s, tier,
                 hedge_ms, trace=None) -> tuple[dict | None, int]:
        """One wire attempt: primary send + at most one hedge. The
        primary and the hedge share ONE event, so whichever response
        lands first wakes the caller — no polling."""
        t0 = time.monotonic()
        deadline = t0 + budget_s
        event = threading.Event()
        primary = self._post(method, params, budget_s, tier, event=event,
                             trace=trace)
        if primary is None:
            return None, 0
        ch0, rid0, slot0, idx0 = primary
        hedge = None
        hedge_wait = (min(hedge_ms / 1e3, budget_s)
                      if hedge_ms is not None else budget_s)
        if not event.wait(hedge_wait):
            remaining = deadline - time.monotonic()
            if hedge_ms is not None and remaining > 0 \
                    and self.n_connections > 1:
                # the hedge must land on a DIFFERENT connection than
                # the primary — same-channel duplicates inherit the
                # exact stall they exist to route around
                hedge = self._post(method, params, remaining, tier,
                                   event=event, index=idx0 + 1,
                                   trace=trace)
                if hedge is not None and trace is not None:
                    # instant marker: when (and why) the duplicate left
                    record_span(trace, "hedge_sent", time.time(), 0.0,
                                method=method,
                                after_ms=round(
                                    (time.monotonic() - t0) * 1e3, 3))
            event.wait(max(deadline - time.monotonic(), 0.0))
        # prefer a real answer over a transport error: a died primary
        # channel writes {"status": "error", "error": "connection lost"}
        # into its slot, which must not mask the hedge's success
        candidates = [s[0] for s in (slot0, hedge[2] if hedge else None)
                      if s]
        winner = next((c for c in candidates
                       if c.get("error") != "connection lost"),
                      candidates[0] if candidates else None)
        ch0.forget(rid0)
        if hedge is not None:
            hedge[0].forget(hedge[1])
        return winner, (1 if hedge is not None else 0)

    def _post(self, method, params, budget_s, tier,
              event: threading.Event | None = None,
              index: int | None = None, trace: str | None = None):
        """Send one frame; returns (channel, id, slot, channel_index).
        ``index`` pins the starting pool slot (hedges pass the
        primary's index + 1 so the duplicate takes another socket);
        None draws from the round-robin."""
        rid = _next_id()
        if trace is not None:
            # trace FIRST: a traced frame must not match the servers'
            # byte-scan fast path (protocol.py's envelope contract)
            frame = {"trace": {"id": trace, "s": 1}, "id": rid,
                     "method": method, "params": params or {},
                     "deadline_ms": round(budget_s * 1e3, 3),
                     "tier": tier}
        else:
            frame = {"id": rid, "method": method, "params": params or {},
                     "deadline_ms": round(budget_s * 1e3, 3),
                     "tier": tier}
        base = next(self._rr) if index is None else index
        for probe in range(self.n_connections):
            idx = (base + probe) % self.n_connections
            try:
                ch = self._channel(idx)
            except OSError:
                continue
            posted = ch.post(frame, event=event)
            if posted is not None:
                _event, slot = posted
                return ch, rid, slot, idx
        return None
