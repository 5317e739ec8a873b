"""``ServeFront``: the multi-worker socket-facing RPC tier.

Architecture (all stdlib, DESIGN.md §19):

- an **acceptor** thread admits connections (bounded — a connection
  flood is load-shed at accept, before it owns any buffer);
- one **reader** thread per connection incrementally parses pipelined
  length-prefixed frames; a connection that stalls MID-frame past the
  read timeout is a slow-loris and is closed (it only ever held its own
  reader, never a worker); complete requests go through **admission**
  (``serve/admission.py``) — shed verdicts are answered straight from
  the reader in microseconds;
- N **worker** threads drain the two-tier queue (interactive strictly
  first), refuse work whose deadline already expired (honest
  ``timeout`` — deadline propagation means never doing work the client
  has stopped waiting for), run the handler with the remaining budget,
  and write the response under a per-connection lock;
- the DAS proof path shares the hardened ``LRUCache`` + per-(block,
  blob) single-flight with ``das/server.DasServer`` — one backing build
  per new (block, blob) however many sockets stampede it — and the
  **circuit breaker** wraps every backing-store access.

Handlers answer from the atomically published ``ServeView``
(``serve/state.py``): the driver's live stores are never touched from a
worker thread.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import socket
import struct
import threading
import time

import numpy as np

# through the package __init__ (NOT das.server directly): the das
# package controls its own submodule import order, which keeps the
# serve <-> das import cycle one-directional at module scope
from pos_evolution_tpu_torch.das import DasServer, LRUCache
from pos_evolution_tpu_torch.das.server import _MISS
from pos_evolution_tpu_torch.serve.admission import (
    AdmissionQueue,
    BrownoutController,
    CircuitBreaker,
    ServiceEstimator,
)
from pos_evolution_tpu_torch.serve.protocol import (
    MAX_FRAME_BYTES,
    ProtocolError,
    send_frame,
)
from pos_evolution_tpu_torch.serve.state import ServingState
from pos_evolution_tpu_torch.telemetry.tracing import record_span

__all__ = ["ServeFront", "TIER_INTERACTIVE", "TIER_BULK", "METHOD_TIERS"]

TIER_INTERACTIVE = 0
TIER_BULK = 1

# The server derives the tier from the method — a client-declared tier
# is advisory only, or bulk traffic would simply claim to be interactive.
METHOD_TIERS = {
    "ping": TIER_INTERACTIVE,
    "head": TIER_INTERACTIVE,
    "finality": TIER_INTERACTIVE,
    "lc_update": TIER_INTERACTIVE,
    "stats": TIER_INTERACTIVE,
    "metrics": TIER_INTERACTIVE,
    "das_cells": TIER_BULK,
    "das_aggregate": TIER_BULK,
}

_LEN = struct.Struct(">I")
_LAT_CAP = 1 << 20  # exact per-tier latency samples kept for p999

# methods the reader may answer from the response cache WITHOUT a JSON
# parse ("stats" deliberately absent: it must take the full path)
_FAST_METHODS = {b"ping": "ping", b"head": "head",
                 b"finality": "finality", b"lc_update": "lc_update"}


def _scan_interactive(body: bytes):
    """``(id, method)`` when ``body`` is a well-formed interactive
    request in the clients' canonical encoding (``{"id":N,...`` with a
    ``"method":"..."`` member), else None — the json.loads a reader
    pays per request is most of a cached reply's cost at 20k+/s, and
    anything this scan cannot prove falls back to the full parse."""
    if not body.startswith(b'{"id":') or not body.endswith(b"}"):
        return None
    try:
        rid = int(body[6:body.index(b",", 6, 24)])
    except ValueError:
        return None
    m = body.find(b'"method":"')
    if m < 0:
        return None
    m += 10
    method = _FAST_METHODS.get(body[m:body.find(b'"', m)])
    return None if method is None else (rid, method)
# caps the das_cells RESPONSE well under MAX_FRAME_BYTES (a sample is
# ~cell_bytes + depth*32 hex-encoded); a real sampling client draws ~8
MAX_SAMPLES_PER_REQUEST = 512


class _Conn:
    """One accepted connection: socket + write lock + parse buffer."""

    __slots__ = ("sock", "wlock", "alive")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.wlock = threading.Lock()
        self.alive = True

    def reply(self, obj: dict) -> bool:
        try:
            with self.wlock:
                send_frame(self.sock, obj)
            return True
        except (OSError, ProtocolError):
            # ProtocolError = the RESPONSE outgrew the frame cap; the
            # worker must survive it (and the request cap on samples
            # makes it unreachable for honest handlers anyway)
            self.alive = False
            return False

    def reply_raw(self, payload: bytes) -> bool:
        """Send pre-encoded frame bytes (length prefix included) —
        the fast path's replies are built from cached templates and
        coalesced, one ``sendall`` per recv batch."""
        try:
            with self.wlock:
                self.sock.sendall(payload)
            return True
        except OSError:
            self.alive = False
            return False

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass


class ServeFront:
    """Multi-worker RPC front over a published ``ServingState``."""

    def __init__(self, state: ServingState, scheme=None, registry=None,
                 workers: int = 4, host: str = "127.0.0.1", port: int = 0,
                 das_server: DasServer | None = None,
                 proof_cache: int | LRUCache = 4096,
                 max_depth: int = 512, admit_factor: float = 0.8,
                 brownout: BrownoutController | None = None,
                 breaker: CircuitBreaker | None = None,
                 read_timeout_s: float = 2.0, max_connections: int = 512,
                 default_deadline_ms: float = 1000.0, chaos=None,
                 reuse_port: bool = False, ident: str | None = None,
                 metrics_dir: str | None = None,
                 worker_id: int | None = None):
        self.state = state
        self.registry = registry
        self.workers = int(workers)
        self.host, self.port = host, int(port)
        self.read_timeout_s = float(read_timeout_s)
        self.max_connections = int(max_connections)
        self.default_deadline_ms = float(default_deadline_ms)
        self.chaos = chaos
        # SO_REUSEPORT lets N worker PROCESSES bind the same port and
        # have the kernel spread connections across them — the
        # multi-process plane's listener strategy (serve/workers.py)
        self.reuse_port = bool(reuse_port)
        self.ident = ident
        # fleet observability (ISSUE 18): the ``metrics`` RPC aggregates
        # sibling snapshot files under metrics_dir on top of this
        # process's live registry (labelled worker_id)
        self.metrics_dir = metrics_dir
        self.worker_id = worker_id
        # per-view interactive response cache: head/finality/lc_update
        # answers are pure functions of the published view, so the hex
        # walks run once per (view, method), not once per request
        self._resp_view = None
        self._resp_cache: dict = {}
        # encoded twin of _resp_cache: (view, {method: reply-tail
        # bytes}) swapped as ONE tuple so reader threads never pair a
        # new view with a stale method's bytes
        self._fast: tuple = (None, {})
        # the DAS proof path IS a DasServer: same hardened LRU, same
        # single-flight, same scheme_builds counter — the socket tier and
        # the in-process vectorized path are one cache domain
        if das_server is not None:
            self.das = das_server
        else:
            assert scheme is not None, \
                "ServeFront needs a commitment scheme (or a DasServer)"
            self.das = DasServer(scheme, registry=registry,
                                 proof_cache=proof_cache)
        self.estimator = ServiceEstimator()
        self.queue = AdmissionQueue(self.workers, max_depth=max_depth,
                                    admit_factor=admit_factor,
                                    estimator=self.estimator)
        self.brownout = brownout or BrownoutController()
        self.breaker = breaker or CircuitBreaker()
        self._threads: list[threading.Thread] = []
        self._active_cfg = None      # captured at start(), see there
        self._conns: list[_Conn] = []
        self._conn_lock = threading.Lock()
        self._listener: socket.socket | None = None
        self._stopping = threading.Event()
        self._lat: dict[int, list[float]] = {TIER_INTERACTIVE: [],
                                             TIER_BULK: []}
        self._lat_lock = threading.Lock()
        # fast-path tallies: {method: [count, latency_sum_s]}, folded
        # into the registry in one update per method at read time
        # (_flush_fast_metrics) — the per-request counter inc +
        # histogram observe is most of a cached reply's CPU
        self._fast_ok: dict[str, list] = {}
        self.slow_loris_closed = 0
        self.conn_rejected = 0
        self.frame_errors = 0
        self.chaos_stalls = 0
        self.started_at: float | None = None
        # chaos cache wipes ride the publish boundary: a wiped proof
        # cache on a NEW block is the maximal stampede
        if chaos is not None and hasattr(chaos, "on_publish"):
            state.on_publish(lambda view, version: chaos.on_publish(
                self, view, version))

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> tuple[str, int]:
        from pos_evolution_tpu_torch.config import cfg
        # capture the owning thread's active config: worker threads get
        # their own thread-local, and scheme handlers that read cfg()
        # (the kzg commit/aggregate geometry) must see the composition
        # the front was started under, not the defaults
        self._active_cfg = cfg()
        self.started_at = time.monotonic()
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if self.reuse_port:
            lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        lst.bind((self.host, self.port))
        lst.listen(256)
        self._listener = lst
        self.host, self.port = lst.getsockname()
        acceptor = threading.Thread(target=self._accept_loop,
                                    name="serve-accept", daemon=True)
        acceptor.start()
        # start() runs once on the owning thread before any worker exists;
        # _threads is never touched from the spawned threads
        self._threads.append(acceptor)  # pev: ignore[PEV101]
        for w in range(self.workers):
            t = threading.Thread(target=self._worker_loop, args=(w,),
                                 name=f"serve-worker-{w}", daemon=True)
            t.start()
            self._threads.append(t)  # pev: ignore[PEV101]
        return self.host, self.port

    def stop(self) -> None:
        self._stopping.set()
        self.queue.close()
        # honest drain: whatever was admitted but not yet served gets a
        # shed + retry-after answer before its connection dies — a
        # stopping (or SIGTERM'd) worker never swallows queued work
        for item in self.queue.drain():
            req, conn, _arrival, _expires, tier = item
            self._count("serve_requests_total", "requests by status",
                        method=req.get("method"), status="shed")
            self._count("serve_shed_total", "load-shed requests",
                        tier=tier, reason="draining")
            if conn is not None:  # best-effort: the conn may be gone
                conn.reply({"id": req["id"], "status": "shed",
                            "reason": "draining", "retry_after_ms": 50.0})
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._conn_lock:
            conns = list(self._conns)
        for conn in conns:
            conn.close()
        for t in self._threads:
            t.join(timeout=5.0)

    # -- metrics helpers -------------------------------------------------------

    def _count(self, name: str, help_: str, n: int = 1, **labels) -> None:
        if self.registry is not None:
            self.registry.counter(name, help_).inc(n, **labels)

    def _record_latency(self, tier: int, seconds: float,
                        status: str) -> None:
        with self._lat_lock:
            lat = self._lat[tier]
            if len(lat) < _LAT_CAP:
                lat.append(seconds)
        if self.registry is not None:
            self.registry.histogram(
                "serve_request_seconds",
                "arrival -> response write, per tier").observe(
                seconds, tier=tier, status=status)

    # -- accept / read ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            with self._conn_lock:
                # prune dead connections here (the one place that scans
                # anyway): without it the list grows for the server's
                # lifetime under connection churn
                self._conns = [c for c in self._conns if c.alive]
                n_alive = len(self._conns)
                if n_alive >= self.max_connections:
                    self.conn_rejected += 1
                    sock.close()
                    continue
                sock.settimeout(self.read_timeout_s)
                # small request/response frames ping-ponging through
                # Nagle + delayed ACK stall for whole ACK timeouts;
                # at serving rates that idleness IS the latency floor
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
                conn = _Conn(sock)
                self._conns.append(conn)
            t = threading.Thread(target=self._reader_loop, args=(conn,),
                                 name="serve-reader", daemon=True)
            t.start()

    def _reader_loop(self, conn: _Conn) -> None:
        """Incremental frame parser: pipelined requests, slow-loris
        detection (a read timeout with a PARTIAL frame buffered means the
        peer is dribbling; an empty buffer is just an idle connection)."""
        buf = bytearray()
        while conn.alive and not self._stopping.is_set():
            try:
                chunk = conn.sock.recv(65536)
            except socket.timeout:
                if buf:
                    with self._conn_lock:  # N readers share this counter
                        self.slow_loris_closed += 1
                    self._count("serve_slow_loris_closed_total",
                                "connections dropped mid-frame")
                    conn.close()
                    return
                continue  # idle is fine
            except OSError:
                conn.close()
                return
            if not chunk:
                conn.close()
                return
            buf.extend(chunk)
            # fast-path replies for THIS recv batch coalesce into one
            # sendall — a pipelined client's 64-frame burst costs one
            # write syscall, not 64
            out: list = []
            while True:
                if len(buf) < _LEN.size:
                    break
                (length,) = _LEN.unpack(buf[:_LEN.size])
                if length > MAX_FRAME_BYTES:
                    # counted: a peer streaming unframed bytes reads as
                    # a giant bogus length here, and an uncounted close
                    # makes that bug invisible in every stats bundle
                    with self._conn_lock:
                        self.frame_errors += 1
                    conn.close()
                    return
                if len(buf) < _LEN.size + length:
                    break
                body = bytes(buf[_LEN.size:_LEN.size + length])
                del buf[:_LEN.size + length]
                try:
                    self._on_request(conn, body, out)
                except Exception:
                    # ProtocolError or anything a hostile payload can
                    # provoke: close THIS connection (flushing replies
                    # already owed for earlier frames in the batch); a
                    # dead reader with a live socket would leak a slot
                    with self._conn_lock:
                        self.frame_errors += 1
                    if out:
                        conn.reply_raw(b"".join(out))
                    conn.close()
                    return
            if out:
                conn.reply_raw(b"".join(out))

    _PING_TAIL = b',"status":"ok","result":{},"served_by":-1}'

    def _on_request(self, conn: _Conn, body: bytes,
                    out: list | None = None) -> None:
        # parse-free fast path: a canonical interactive request whose
        # answer is already in the per-view cache is served straight
        # from the byte scan — id + method are the only fields a cached
        # reply depends on (the deadline cannot matter: the reply is
        # constructed inline, microseconds after arrival)
        scan = _scan_interactive(body)
        if scan is not None:
            rid, method = scan
            if method == "ping":
                tail = self._PING_TAIL
            else:
                fview, tmpl = self._fast
                tail = (tmpl.get(method)
                        if fview is self.state.current() else None)
            if tail is not None:
                arrival = time.monotonic()
                rbody = b'{"id":%d' % rid + tail
                payload = _LEN.pack(len(rbody)) + rbody
                dt = time.monotonic() - arrival
                with self._lat_lock:
                    lat = self._lat[TIER_INTERACTIVE]
                    if len(lat) < _LAT_CAP:
                        lat.append(dt)
                    row = self._fast_ok.get(method)
                    if row is None:
                        self._fast_ok[method] = row = [0, 0.0]
                    row[0] += 1
                    row[1] += dt
                if out is not None:
                    out.append(payload)
                else:
                    conn.reply_raw(payload)
                return
        try:
            req = json.loads(body)
        except json.JSONDecodeError as e:
            raise ProtocolError(str(e)) from None
        if not isinstance(req, dict) or not isinstance(req.get("id"), int):
            raise ProtocolError("request must be an object with int id")
        method = req.get("method")
        tier = (METHOD_TIERS.get(method)
                if isinstance(method, str) else None)
        if tier is None:
            # fixed label, never the raw string: attacker-chosen method
            # names must not mint unbounded counter series (or smuggle
            # ';'/'=' into the label encoding)
            self._count("serve_requests_total", "requests by status",
                        method="<unknown>", status="error")
            conn.reply({"id": req["id"], "status": "error",
                        "error": f"unknown method {str(method)[:64]!r}"})
            return
        arrival = time.monotonic()
        if method == "metrics":
            # admission-exempt introspection: answered from memory on
            # the reader thread — never queued, never breaker-gated —
            # so the fleet stays observable through overload and
            # backing outages (the whole point of a metrics scrape)
            self._count("serve_requests_total", "requests by status",
                        method=method, status="ok")
            self._record_latency(TIER_INTERACTIVE,
                                 time.monotonic() - arrival, "ok")
            conn.reply({"id": req["id"], "status": "ok",
                        "result": self._metrics_payload(),
                        "served_by": -1})
            return
        trace = req.get("trace")
        traced = (trace.get("id")
                  if isinstance(trace, dict) and trace.get("s") else None)
        # interactive fast path: when the per-view response cache
        # already holds this method's answer, serve it straight from
        # the reader — a queue hop (condvar wakeup + worker context
        # switch) costs more than the cached reply itself, and at
        # 20k+/s on a shared core that overhead IS the capacity limit.
        # The FIRST request per (view, method) still takes the full
        # admission path and populates the cache; bulk always queues.
        # A TRACED request always queues too: its spans (queue wait,
        # service) are the observation, and sampled traffic is rare
        # enough that skipping the template costs nothing measurable.
        if tier == TIER_INTERACTIVE and method != "stats" \
                and traced is None:
            if method == "ping":
                tail = self._PING_TAIL
            else:
                fview, tmpl = self._fast
                tail = (tmpl.get(method)
                        if fview is self.state.current() else None)
            if tail is not None:
                self._count("serve_requests_total",
                            "requests by status",
                            method=method, status="ok")
                self._record_latency(tier, time.monotonic() - arrival,
                                     "ok")
                rbody = b'{"id":%d' % req["id"] + tail
                payload = _LEN.pack(len(rbody)) + rbody
                if out is not None:
                    out.append(payload)
                else:
                    conn.reply_raw(payload)
                return
        deadline_ms = req.get("deadline_ms", self.default_deadline_ms)
        # NaN/Infinity parse as valid JSON numbers and would sail past
        # every `now >= expires_at` / projected-wait comparison —
        # bypassing the admission control this tier is built on. Only a
        # FINITE client deadline is honored.
        budget_s = (float(deadline_ms) / 1e3
                    if isinstance(deadline_ms, (int, float))
                    and not isinstance(deadline_ms, bool)
                    and math.isfinite(deadline_ms)
                    else self.default_deadline_ms / 1e3)
        item = (req, conn, arrival, arrival + budget_s, tier)
        verdict = self.queue.offer(item, tier, budget_s,
                                   brownout=self.brownout.active)
        if verdict is not None:
            # honest rejection from the reader thread: the worker pool
            # never sees work the tier cannot finish in time
            self._count("serve_requests_total", "requests by status",
                        method=method, status="shed")
            self._count("serve_shed_total", "load-shed requests",
                        tier=tier, reason=verdict["reason"])
            conn.reply({"id": req["id"], "status": "shed",
                        "reason": verdict["reason"],
                        "retry_after_ms": verdict["retry_after_ms"]})

    # -- workers ---------------------------------------------------------------

    def _worker_loop(self, worker_id: int) -> None:
        from pos_evolution_tpu_torch.config import use_config
        with contextlib.ExitStack() as stack:
            if self._active_cfg is not None:
                stack.enter_context(use_config(self._active_cfg))
            self._worker_body(worker_id)

    def _worker_body(self, worker_id: int) -> None:
        while not self._stopping.is_set():
            item = self.queue.take(timeout=0.25)
            if item is None:
                continue
            try:
                self._serve_item(worker_id, item)
            except Exception:
                # last-resort guard: whatever a hostile request managed
                # to provoke, a worker thread must never die — a dead
                # worker is capacity lost for the server's lifetime
                self._count("serve_worker_errors_total",
                            "requests that escaped every handler path")

    def _serve_item(self, worker_id: int, item) -> None:
        req, conn, arrival, expires_at, tier = item
        if self.chaos is not None:
            stall = self.chaos.stall_s(worker_id)
            if stall > 0:
                with self._conn_lock:  # N workers share this counter
                    self.chaos_stalls += 1
                self._count("serve_chaos_stalls_total",
                            "chaos-injected worker stalls")
                time.sleep(stall)
        now = time.monotonic()
        wait_s = now - arrival
        if tier == TIER_INTERACTIVE:
            self.brownout.observe_interactive_wait(wait_s)
        method = req["method"]
        trace = req.get("trace")
        traced = (trace.get("id")
                  if isinstance(trace, dict) and trace.get("s") else None)
        if traced is not None:
            record_span(traced, "queue_wait", time.time() - wait_s,
                        wait_s * 1e3, tid=worker_id, method=method)
        if now >= expires_at:
            # deadline propagation: the client stopped waiting —
            # touching the backing store now would be pure waste
            self._count("serve_requests_total", "requests by status",
                        method=method, status="timeout")
            self._record_latency(tier, now - arrival, "timeout")
            if traced is not None:
                record_span(traced, "service", time.time(), 0.0,
                            tid=worker_id, method=method,
                            status="timeout")
            conn.reply({"id": req["id"], "status": "timeout"})
            return
        # the circuit breaker guards the BACKING STORE, so only the
        # methods that touch it consult it — head/finality answer
        # from the in-memory view even while the store is down
        backed = method in ("das_cells", "das_aggregate")
        if backed:
            allowed, retry_s = self.breaker.allow()
            if not allowed:
                self._count("serve_requests_total",
                            "requests by status",
                            method=method, status="unavailable")
                self._record_latency(tier, now - arrival,
                                     "unavailable")
                conn.reply({"id": req["id"], "status": "unavailable",
                            "reason": "circuit_open",
                            "retry_after_ms": round(retry_s * 1e3, 3)})
                return
        t0 = time.monotonic()
        try:
            result = self._handle(method, req.get("params") or {},
                                  expires_at, trace=traced,
                                  tid=worker_id)
            if backed:
                self.breaker.record_success()
            status = "ok"
            resp = {"id": req["id"], "status": "ok", "result": result,
                    "served_by": worker_id}
        except _Expired:
            # no verdict on the backing store was reached — release
            # any probe slot we held, or a mid-handler expiry in
            # half-open would wedge the breaker forever
            if backed:
                self.breaker.abandon()
            status = "timeout"
            resp = {"id": req["id"], "status": "timeout"}
        except _BadRequest as e:
            # the CLIENT was wrong (bad hex, rotated-out root,
            # out-of-range sample) — says nothing about backing
            # health, so it must not trip the breaker open
            if backed:
                self.breaker.abandon()
            status = "error"
            resp = {"id": req["id"], "status": "error",
                    "error": str(e)}
        except _NotReady as e:
            # the SERVER isn't ready (no view yet) — also not a
            # backing-store verdict; an honest unavailable with a
            # short retry-after instead of a breaker trip
            if backed:
                self.breaker.abandon()
            status = "unavailable"
            resp = {"id": req["id"], "status": "unavailable",
                    "reason": str(e), "retry_after_ms": 50.0}
        except Exception as e:
            if backed:
                self.breaker.record_failure()
            status = "error"
            resp = {"id": req["id"], "status": "error",
                    "error": f"{type(e).__name__}: {e}"}
        service_s = time.monotonic() - t0
        if status == "ok":
            self.estimator.observe(service_s)
        self._count("serve_requests_total", "requests by status",
                    method=method, status=status)
        self._record_latency(tier, wait_s + service_s, status)
        if traced is not None:
            record_span(traced, "service", time.time() - service_s,
                        service_s * 1e3, tid=worker_id, method=method,
                        status=status, worker=self.worker_id)
        conn.reply(resp)

    # -- handlers --------------------------------------------------------------

    def _view(self):
        view = self.state.current()
        if view is None:
            # not the backing store's fault: the driver just hasn't
            # published yet — honest "come back shortly", never a
            # breaker trip
            raise _NotReady("no serving view published yet")
        return view

    def _handle(self, method: str, params: dict, expires_at: float,
                trace: str | None = None, tid: int = 0):
        if method == "ping":
            return {}
        if method == "stats":
            return self.summary()
        if method == "metrics":
            # normally answered on the reader thread; reachable here
            # only through in-process calls — same memory-served payload
            return self._metrics_payload()
        view = self._view()
        if method in ("head", "finality", "lc_update"):
            # identity-keyed per-view cache: these answers are pure
            # functions of the published view, and the hex walks are
            # most of an interactive request's CPU at high rate
            if self._resp_view is not view:
                self._resp_view, self._resp_cache = view, {}
            hit = self._resp_cache.get(method)
            if hit is None:
                if method == "head":
                    hit = view.head_summary()
                elif method == "finality":
                    hit = view.finality_summary()
                elif view.update_ssz is None:
                    hit = {"update": None, "update_root": None}
                else:
                    hit = {"update": view.update_ssz.hex(),
                           "update_root": view.update_root.hex()}
                # idempotent per-view memo: concurrent builders store
                # equal values, so a lost setitem costs one recompute
                # pev: ignore[PEV101]
                self._resp_cache[method] = hit
            fast = self._fast
            if fast[0] is not view:
                fast = (view, {})
                self._fast = fast
            if method not in fast[1]:
                enc = json.dumps(hit, separators=(",", ":")).encode()
                fast[1][method] = (b',"status":"ok","result":' + enc
                                   + b',"served_by":-1}')
            return hit
        if method == "das_aggregate":
            return self._das_aggregate(view, params, expires_at,
                                       trace=trace, tid=tid)
        assert method == "das_cells"
        return self._das_cells(view, params, expires_at,
                               trace=trace, tid=tid)

    def _parse_das_params(self, view, params: dict):
        try:
            root = bytes.fromhex(params["block_root"])
            samples = [(int(b), int(c)) for b, c in params["samples"]]
        except (KeyError, TypeError, ValueError) as e:
            raise _BadRequest(f"malformed das params: {e}") from None
        if len(samples) > MAX_SAMPLES_PER_REQUEST:
            # also bounds the RESPONSE size under the frame cap — a
            # huge sample list must be an honest refusal, not a reply
            # too large to send
            raise _BadRequest(
                f"{len(samples)} samples exceeds the per-request cap "
                f"of {MAX_SAMPLES_PER_REQUEST}")
        sidecars = view.sidecars.get(root)
        if sidecars is None:
            raise _BadRequest(f"block {root.hex()[:16]} not in the "
                              f"serving window")
        for blob, cell in samples:
            if not (0 <= blob < len(sidecars) and 0 <= cell < view.n_cells):
                raise _BadRequest(f"sample ({blob}, {cell}) outside the "
                                  f"grid")
        return root, samples, sidecars

    def _das_aggregate(self, view, params: dict, expires_at: float,
                       trace: str | None = None, tid: int = 0) -> dict:
        """One aggregated opening proof for the request's whole sampled
        set (kzg-style schemes) — the response ships |proof| bytes total
        instead of depth*32 bytes per sample."""
        scheme = self.das.scheme
        if not getattr(scheme, "aggregates", False):
            raise _BadRequest(
                f"scheme {scheme.name!r} serves per-cell branches; "
                f"use das_cells")
        root, samples, sidecars = self._parse_das_params(view, params)
        # canonical coords: the proof covers the deduped sorted set (the
        # transcript is order-sensitive, so server and client must agree)
        coords = tuple(sorted(set(samples)))
        if time.monotonic() >= expires_at:
            raise _Expired()
        if self.chaos is not None:
            self.chaos.maybe_backing_fault()
        leads0 = self.das._flight.leads
        b_wall, b_t0 = time.time(), time.monotonic()
        proof = self.das.build_aggregate_proof(root, sidecars, coords)
        if trace is not None:
            # single-flight followers share the trace id AND the time
            # range of the leader's build — the merged trace links them
            record_span(trace, "backing", b_wall,
                        (time.monotonic() - b_t0) * 1e3, tid=tid,
                        kind="das_aggregate", block=root.hex()[:16],
                        flight=("lead" if self.das._flight.leads > leads0
                                else "follow"))
        grids = {b for b, _ in coords}
        cells_out = [
            bytes(np.ascontiguousarray(sidecars[b].cells,
                                       dtype=np.uint8)[c]).hex()
            for b, c in coords]
        return {
            "block_root": root.hex(),
            "scheme": scheme.name,
            "commitments": [bytes(sc.commitment).hex() for sc in sidecars],
            "samples": [[int(b), int(c)] for b, c in coords],
            "cells": cells_out,
            "proof": [p.hex() for p in scheme.encode_proof(proof)],
            "proof_bytes": int(scheme.proof_n_bytes(proof)),
            "n_cells": int(view.n_cells),
            "blobs_opened": len(grids),
        }

    def _das_cells(self, view, params: dict, expires_at: float,
                   trace: str | None = None, tid: int = 0) -> dict:
        if getattr(self.das.scheme, "aggregates", False):
            # an aggregate scheme has no per-cell branch walk to serve —
            # honest refusal, not an AttributeError in a worker
            raise _BadRequest(
                f"scheme {self.das.scheme.name!r} serves aggregated "
                f"proofs; use das_aggregate")
        root, samples, sidecars = self._parse_das_params(view, params)
        cells_out, branches_out = [], []
        cache = self.das.proof_cache
        for blob, cell in samples:
            hit = cache.get((root, blob, cell))
            if hit is _MISS:
                # budget check before the (comparatively) expensive
                # backing build — a mid-request expiry becomes an honest
                # timeout instead of a late answer nobody reads
                if time.monotonic() >= expires_at:
                    raise _Expired()
                # the proof build IS the backing-store access: an
                # in-memory head scalar never needs the store, so only
                # this path feels a chaos backing outage (and only this
                # path's failures should trip the breaker open)
                if self.chaos is not None:
                    self.chaos.maybe_backing_fault()
                leads0 = self.das._flight.leads
                b_wall, b_t0 = time.time(), time.monotonic()
                built = self.das.build_blob_proofs(root, blob,
                                                   sidecars[blob])
                if trace is not None:
                    record_span(
                        trace, "backing", b_wall,
                        (time.monotonic() - b_t0) * 1e3, tid=tid,
                        kind="das_cells", block=root.hex()[:16],
                        blob=blob,
                        flight=("lead"
                                if self.das._flight.leads > leads0
                                else "follow"))
                hit = built[cell]
            cell_bytes, branch = hit
            cells_out.append(bytes(cell_bytes).hex())
            branches_out.append([bytes(b).hex() for b in branch])
        return {
            "block_root": root.hex(),
            "commitments": [bytes(sidecars[int(b)].commitment).hex()
                            for b, _ in samples],
            "indices": [int(c) for _, c in samples],
            "cells": cells_out,
            "branches": branches_out,
            "n_cells": int(view.n_cells),
        }

    # -- reporting -------------------------------------------------------------

    def _percentiles(self, xs: list[float]) -> dict:
        from pos_evolution_tpu_torch.utils.metrics import percentile_ms
        if not xs:
            return {"count": 0}
        return {"count": len(xs), "p50_ms": percentile_ms(xs, 50),
                "p99_ms": percentile_ms(xs, 99),
                "p999_ms": percentile_ms(xs, 99.9)}

    def _metrics_payload(self) -> dict:
        """The ``metrics`` RPC result: this process's LIVE registry plus
        every sibling snapshot under ``metrics_dir``, merged with
        per-worker labels (ISSUE 18 leg a). Served entirely from memory
        + local files — no queue, no backing store, no breaker."""
        from pos_evolution_tpu_torch.telemetry import fleet
        from pos_evolution_tpu_torch.telemetry.registry import SNAPSHOT_VERSION
        self._flush_fast_metrics()
        agg = fleet.FleetAggregator()
        own = None
        if self.metrics_dir is not None:
            if self.worker_id is not None:
                # skip our OWN snapshot file: the live registry below is
                # the same counters, fresher — merging both doubles them
                own = os.path.abspath(fleet.snapshot_path(
                    self.metrics_dir, self.worker_id, os.getpid()))
            for path in fleet.discover_snapshots(self.metrics_dir):
                if own is not None and os.path.abspath(path) == own:
                    continue
                agg.add(fleet.load_snapshot(path))
        if self.registry is not None:
            agg.add({
                "v": SNAPSHOT_VERSION,
                "worker": (self.worker_id if self.worker_id is not None
                           else 0),
                "pid": os.getpid(), "front": None, "generation": None,
                "wall": time.time(),
                "registry": self.registry.snapshot(),
            })
        return {
            "fleet": agg.summary(),
            "prometheus": agg.registry.to_prometheus(),
        }

    def _flush_fast_metrics(self) -> None:
        """Fold fast-path tallies into the registry — one counter inc
        and one batched histogram update per method instead of one of
        each per request."""
        with self._lat_lock:
            if not self._fast_ok:
                return
            pending, self._fast_ok = self._fast_ok, {}
        if self.registry is None:
            return
        for method, (n, total_s) in pending.items():
            self.registry.counter(
                "serve_requests_total", "requests by status").inc(
                n, method=method, status="ok")
            self.registry.histogram(
                "serve_request_seconds",
                "arrival -> response write, per tier").observe_n(
                total_s / n, n, tier=TIER_INTERACTIVE, status="ok")

    def summary(self) -> dict:
        """The ``serve_summary`` payload: everything the run report's
        "Serving" section and the bench_serve emission need."""
        self._flush_fast_metrics()
        with self._lat_lock:
            lat = {t: list(v) for t, v in self._lat.items()}
        by_status: dict[str, int] = {}
        by_method: dict[str, int] = {}
        if self.registry is not None:
            for key, val in self.registry.counts().items():
                if key.startswith("serve_requests_total;"):
                    labels = dict(p.split("=", 1)
                                  for p in key.split(";")[1:]
                                  if "=" in p)
                    st, me = labels.get("status"), labels.get("method")
                    by_status[st] = by_status.get(st, 0) + val
                    by_method[me] = by_method.get(me, 0) + val
        total = sum(by_status.values())
        shed = by_status.get("shed", 0)
        cache = self.das.proof_cache
        return {
            "workers": self.workers,
            "queue_depth": self.queue.depth(),
            "admitted": self.queue.admitted,
            "requests_total": total,
            "by_status": by_status,
            "by_method": by_method,
            "shed_rate": round(shed / total, 4) if total else 0.0,
            "shed_by_reason": dict(self.queue.shed),
            "interactive": self._percentiles(lat[TIER_INTERACTIVE]),
            "bulk": self._percentiles(lat[TIER_BULK]),
            "brownout_transitions": len(self.brownout.transitions),
            "brownout_active": self.brownout.active,
            "breaker_state": self.breaker.state,
            "breaker_transitions": len(self.breaker.transitions),
            "singleflight": {"leads": self.das._flight.leads,
                             "waits": self.das._flight.waits},
            "scheme_builds": self.das.scheme_builds,
            "proof_cache": {"hits": cache.hits, "misses": cache.misses,
                            "hit_rate": round(cache.hit_rate, 4)},
            "slow_loris_closed": self.slow_loris_closed,
            "conn_rejected": self.conn_rejected,
            "frame_errors": self.frame_errors,
            "chaos_stalls": self.chaos_stalls,
            "service_ema_ms": round(self.estimator.ema_s * 1e3, 4),
        }


class _Expired(Exception):
    """Internal: the request's deadline expired mid-handler."""


class _BadRequest(Exception):
    """Internal: the client's parameters were wrong. Answered as an
    honest ``error`` but NEVER counted against the backing store — a
    hostile client must not be able to trip the breaker open."""


class _NotReady(Exception):
    """Internal: the server has no published view yet. Answered as an
    honest ``unavailable`` + retry-after; not a backing-store verdict."""
