"""Length-prefixed JSON wire protocol for the serving tier.

One frame = a 4-byte big-endian length prefix + a UTF-8 JSON object. No
heavyweight RPC dependency (nothing may be pip-installed in this image),
no pickle (clients are untrusted), and self-delimiting so many requests
can be pipelined on one connection and demultiplexed by ``id``.

Request envelope::

    {"id": <int>, "method": "<name>", "params": {...},
     "deadline_ms": <float remaining budget>, "tier": <int advisory>,
     "trace": {"id": "<16-hex>", "s": 1}?}

``trace`` is OPTIONAL and backward-compatible (JSON objects ignore
unknown members): a client that sampled the request for end-to-end
tracing (``telemetry/tracing.py``) attaches its deterministic trace id;
servers record queue-wait/service/backing spans under that id and
otherwise treat the request identically. Clients serialize the trace
member FIRST so traced frames fall off the servers' byte-scan fast path
(the traced request must take the fully-observed queue path), while
untraced frames stay byte-identical to the pre-trace protocol.

Response envelope::

    {"id": <int>, "status": "ok" | "shed" | "timeout" | "unavailable"
                          | "error",
     "result": {...}?, "retry_after_ms": <float>?, "error": "<msg>"?,
     "served_by": <worker>?}

Every non-``ok`` status is an **honest rejection**: the server tells the
client it did not (and will not) do the work, and — for ``shed`` /
``unavailable`` — when it is worth asking again. Binary payloads (cells,
branches, commitments, SSZ bytes) travel hex-encoded; at DAS cell sizes
the 2x overhead is noise next to the framing and the proof bytes are the
payload either way.

``recv_frame`` reads with a per-chunk timeout so a **slow-loris** client
(one that dribbles a frame byte-by-byte forever) stalls only its own
connection reader until the timeout trips — never a worker.
"""

from __future__ import annotations

import json
import socket
import struct

__all__ = ["ProtocolError", "send_frame", "recv_frame",
           "MAX_FRAME_BYTES"]

# Generous for a full-grid cell batch, small enough that a hostile
# length prefix cannot balloon allocation.
MAX_FRAME_BYTES = 8 * 1024 * 1024

_LEN = struct.Struct(">I")


class ProtocolError(Exception):
    """Malformed frame: oversize, non-JSON, or non-object payload."""


def send_frame(sock: socket.socket, obj: dict) -> None:
    """Serialize ``obj`` and write one frame (single ``sendall`` so
    concurrent senders on a shared socket only need a per-socket lock)."""
    body = json.dumps(obj, separators=(",", ":")).encode()
    if len(body) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame of {len(body)} bytes exceeds "
                            f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    sock.sendall(_LEN.pack(len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """Read exactly ``n`` bytes; None on clean EOF at a frame boundary.
    ``socket.timeout`` propagates — the caller decides whether a stalled
    read is a slow-loris (mid-frame) or just an idle connection."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            if got == 0:
                return None
            raise ProtocolError("connection closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> dict | None:
    """Read one frame; None on clean EOF. Raises ``ProtocolError`` on
    garbage and lets ``socket.timeout`` escape on a stalled read."""
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise ProtocolError(f"declared frame length {length} exceeds "
                            f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    body = _recv_exact(sock, length)
    if body is None:
        raise ProtocolError("connection closed between header and body")
    try:
        obj = json.loads(body)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"non-JSON frame body: {e}") from None
    if not isinstance(obj, dict):
        raise ProtocolError("frame body must be a JSON object")
    return obj
