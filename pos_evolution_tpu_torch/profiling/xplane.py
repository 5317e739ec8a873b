"""xplane protobuf parsing — the importable heart of what used to live in
``scripts/trace_summary.py`` (now a deprecation stub; the CLI path is
``scripts/run_report.py --xplane TRACE``).

No ``xplane_pb2`` bindings ship in this image, so this walks the protobuf
wire format directly with the field numbers from
tsl/profiler/protobuf/xplane.proto (stable public schema):

    XSpace.planes = 1
    XPlane.name = 2, XPlane.lines = 3, XPlane.event_metadata = 4 (map)
    XLine.name = 2, XLine.timestamp_ns = 3, XLine.events = 4
    XEvent.metadata_id = 1, XEvent.offset_ps = 2, XEvent.duration_ps = 3
    XEventMetadata.id = 1, XEventMetadata.name = 2

Two views of the same bytes:

- ``parse_xspace``: the full structural view — planes with lines, each
  line with timestamped events — used by the Chrome-trace exporter
  (``profiling/export.py``) and the span-attribution pass
  (``profiling/attribution.py``);
- ``summarize_xplane`` / ``top_table`` / ``summarize_path``: the legacy
  aggregate per-op view (total_ps, count) consumed by ``bench.py
  --trace`` and folded into ``run_report.py``.

``encode_xspace`` writes the same wire format back out; parse∘encode is
the identity on the structural view, which is what lets tests pin the
parser against a small checked-in ``*.xplane.pb`` fixture instead of a
live profiler run (profiler output is nondeterministic; the wire walk
is not).
"""

from __future__ import annotations

import glob
import os


def _varint(buf, i):
    out = shift = 0
    n = len(buf)
    while True:
        if i >= n:
            # a partially written file (killed writer, full disk) must be
            # a loud ValueError, not an IndexError that callers' contracts
            # don't cover
            raise ValueError("truncated xplane message: varint past end")
        b = buf[i]
        out |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf):
    """Yield (field_number, wire_type, value) over a message buffer.
    Raises ``ValueError`` on truncated/corrupt bytes."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, i = _varint(buf, i)
        elif wtype == 1:
            val, i = buf[i:i + 8], i + 8
        elif wtype == 2:
            ln, i = _varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wtype == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        if wtype != 0 and i > n:
            raise ValueError("truncated xplane message: field past end")
        yield fnum, wtype, val


def is_device_plane(name: str) -> bool:
    """Does a plane name smell like a device timeline (vs host python)?
    THE one definition — the top-table ranking and every attribution view
    must agree on what counts as device time."""
    n = name.lower()
    return "device" in n or "tpu" in n or "gpu" in n or "xla" in n


def select_planes(planes, device_only: bool = True):
    """Device planes when any exist, else every plane: a CPU-only run has
    no device plane, and its host timeline IS the device timeline."""
    if device_only:
        chosen = [p for p in planes if is_device_plane(p["name"])]
        if chosen:
            return chosen
    return list(planes)


def _parse_plane(plane_buf) -> dict:
    name, metadata, lines = "", {}, []
    for pf, _, pv in _fields(plane_buf):
        if pf == 2:
            name = pv.decode("utf-8", "replace")
        elif pf == 3:
            lines.append(pv)
        elif pf == 4:  # map<int64, XEventMetadata> entry
            mid, mname = 0, ""
            for mf, _, mv in _fields(pv):
                if mf == 1:
                    mid = mv
                elif mf == 2:  # XEventMetadata
                    for ef, _, ev in _fields(mv):
                        if ef == 1:
                            mid = ev
                        elif ef == 2:
                            mname = ev.decode("utf-8", "replace")
            metadata[mid] = mname
    parsed_lines = []
    for line_buf in lines:
        lname, ts_ns, events = "", 0, []
        for lf, _, lv in _fields(line_buf):
            if lf == 2:
                lname = lv.decode("utf-8", "replace")
            elif lf == 3:
                ts_ns = lv
            elif lf == 4:
                mid = off = dur = 0
                for ef, _, ev in _fields(lv):
                    if ef == 1:
                        mid = ev
                    elif ef == 2:
                        off = ev
                    elif ef == 3:
                        dur = ev
                events.append({"metadata_id": mid, "offset_ps": off,
                               "duration_ps": dur})
        parsed_lines.append({"name": lname, "timestamp_ns": ts_ns,
                             "events": events})
    return {"name": name, "event_metadata": metadata, "lines": parsed_lines}


def parse_xspace(data: bytes) -> list[dict]:
    """Full structural parse: list of planes, each
    ``{name, event_metadata: {id: op_name}, lines: [{name, timestamp_ns,
    events: [{metadata_id, offset_ps, duration_ps}]}]}``."""
    return [_parse_plane(v) for f, _, v in _fields(data) if f == 1]


def iter_ops(planes):
    """Yield ``(plane_name, line_name, op_name, offset_ps, duration_ps)``
    over a ``parse_xspace`` result — the flat event stream the exporters
    consume."""
    for p in planes:
        meta = p["event_metadata"]
        for line in p["lines"]:
            for ev in line["events"]:
                yield (p["name"], line["name"],
                       meta.get(ev["metadata_id"], f"#{ev['metadata_id']}"),
                       ev["offset_ps"], ev["duration_ps"])


def summarize_planes(planes) -> list[dict]:
    """Structural view -> legacy aggregate view:
    ``[{name, ops: {op_name: [total_ps, count]}}]`` (planes with no
    events are dropped, matching the historic behavior)."""
    out = []
    for p in planes:
        ops: dict[str, list] = {}
        meta = p["event_metadata"]
        for line in p["lines"]:
            for ev in line["events"]:
                key = meta.get(ev["metadata_id"], f"#{ev['metadata_id']}")
                tot = ops.get(key)
                if tot is None:
                    ops[key] = [ev["duration_ps"], 1]
                else:
                    tot[0] += ev["duration_ps"]
                    tot[1] += 1
        if ops:
            out.append({"name": p["name"], "ops": ops})
    return out


def summarize_xplane(data: bytes) -> list[dict]:
    """-> list of planes: {name, ops: {op_name: [total_ps, count]}}."""
    return summarize_planes(parse_xspace(data))


def top_table(planes, top_n: int = 10) -> dict:
    """-> dict plane name -> top-N [{op, total_ms, count}] (device-ish
    planes sorted first)."""
    def rank(p):
        return (0 if is_device_plane(p["name"]) else 1, p["name"])

    out = {}
    for p in sorted(planes, key=rank):
        rows = sorted(p["ops"].items(), key=lambda kv: -kv[1][0])[:top_n]
        out[p["name"]] = [
            {"op": k, "total_ms": round(v[0] / 1e9, 3), "count": v[1]}
            for k, v in rows if v[0] > 0]
    return {k: v for k, v in out.items() if v}


def xplane_files(path) -> list[str]:
    """The ``*.xplane.pb`` files a trace dir (or a single file) holds."""
    path = os.fspath(path)
    return ([path] if os.path.isfile(path) else
            sorted(glob.glob(os.path.join(path, "**", "*.xplane.pb"),
                             recursive=True)))


def parse_path(path) -> list[dict]:
    """``parse_xspace`` over every xplane file under ``path``."""
    files = xplane_files(path)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {path}")
    planes = []
    for f in files:
        with open(f, "rb") as fh:
            planes.extend(parse_xspace(fh.read()))
    return planes


def summarize_path(path, top_n: int = 10) -> dict:
    """Aggregate view over a trace dir — one composition of the
    structural helpers, so file discovery/error semantics live only in
    ``parse_path``."""
    return top_table(summarize_planes(parse_path(path)), top_n)


# -- wire-format writer (fixtures / tests) -------------------------------------

def _enc_varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        out.append(b | (0x80 if x else 0))
        if not x:
            return bytes(out)


def _enc_tag(fnum: int, wtype: int) -> bytes:
    return _enc_varint((fnum << 3) | wtype)


def _enc_bytes(fnum: int, data: bytes) -> bytes:
    return _enc_tag(fnum, 2) + _enc_varint(len(data)) + data


def _enc_int(fnum: int, x: int) -> bytes:
    return _enc_tag(fnum, 0) + _enc_varint(x)


def encode_xspace(planes: list[dict]) -> bytes:
    """Encode the ``parse_xspace`` structural view back to xplane wire
    bytes (fixture generator: ``parse_xspace(encode_xspace(p)) == p`` up
    to empty-string/zero-value defaults)."""
    space = bytearray()
    for p in planes:
        plane = bytearray()
        plane += _enc_bytes(2, p["name"].encode())
        for line in p.get("lines", ()):
            lbuf = bytearray()
            if line.get("name"):
                lbuf += _enc_bytes(2, line["name"].encode())
            if line.get("timestamp_ns"):
                lbuf += _enc_int(3, line["timestamp_ns"])
            for ev in line.get("events", ()):
                ebuf = (_enc_int(1, ev["metadata_id"])
                        + (_enc_int(2, ev["offset_ps"])
                           if ev.get("offset_ps") else b"")
                        + (_enc_int(3, ev["duration_ps"])
                           if ev.get("duration_ps") else b""))
                lbuf += _enc_bytes(4, bytes(ebuf))
            plane += _enc_bytes(3, bytes(lbuf))
        for mid, mname in sorted(p.get("event_metadata", {}).items()):
            meta = _enc_int(1, mid) + _enc_bytes(2, mname.encode())
            entry = _enc_int(1, mid) + _enc_bytes(2, bytes(meta))
            plane += _enc_bytes(4, bytes(entry))
        space += _enc_bytes(1, bytes(plane))
    return bytes(space)
