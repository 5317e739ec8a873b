"""obs_top: a live terminal view of a running fleet / dense run (the
port's counterpart of ``scripts/obs_top.py``).

Everything is read from files the run already writes — heartbeat files
(``utils/watchdog.Heartbeat``: ``*.hb`` / ``*.heartbeat``), fleet
metric snapshots (``worker<id>.pid<pid>.metrics.json``), the tail of an
event log, and the flight recorder's ``*device_ledger.json`` artifact —
so it attaches to any run directory with zero cooperation from the run
itself, including one on the far side of an ssh mount. Sections it can
render (each optional; missing inputs just drop the section):

- **progress**: latest slot / justified / finalized from heartbeat
  payloads or the newest ``slot`` event, plus slots/s across refreshes;
- **worker health**: per-heartbeat age (stale > 3x the refresh interval
  is flagged), per-worker request totals from the fleet snapshots;
- **device**: HBM/RSS watermark from the device ledger artifact (or
  live ``device_memory`` events), the kernel-build count and the top
  build row (the port's build ledger), and the artifact's kernel
  launches;
- **counters**: kernel builds and launches (``kernel_builds_total``,
  ``kernel_launches_total``), transfer/dispatch totals under the JAX
  counter names ``telemetry/torchrt`` keeps, and served requests, from
  the snapshots.

``--once`` prints a single snapshot and exits (CI artifact mode);
otherwise redraws every ``--interval`` seconds until interrupted.

Usage:
    python -m pos_evolution_tpu_torch.obs_top --dir RUNDIR
        [--events events.jsonl] [--interval 2] [--once]
        [--device-ledger device_ledger.json]

No torch: it reads files, wherever Python runs.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

__all__ = ["collect", "render"]


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"


def _heartbeats(directory: str) -> list[dict]:
    from pos_evolution_tpu_torch.utils.watchdog import read_heartbeat
    rows = []
    for pat in ("*.hb", "*.heartbeat", "*heartbeat*.json"):
        for path in sorted(glob.glob(os.path.join(directory, pat))):
            hb = read_heartbeat(path)
            if hb is not None:
                rows.append({"file": os.path.basename(path),
                             "age_s": round(hb["age_s"], 1),
                             "payload": hb["payload"]})
    return rows


def _tail_events(path: str, want=("slot", "device_memory"),
                 max_bytes: int = 262144) -> dict:
    """Newest event of each wanted type from the tail of a JSONL log —
    bounded read so a multi-GB log never stalls the refresh."""
    out: dict = {}
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as fh:
            fh.seek(max(0, size - max_bytes))
            chunk = fh.read().decode("utf-8", "replace")
        for line in chunk.splitlines():
            try:
                ev = json.loads(line)
            except ValueError:
                continue  # torn first/last line of the window
            if isinstance(ev, dict) and ev.get("type") in want:
                out[ev["type"]] = ev
    except OSError:
        pass
    return out


def _device_ledger(path: str | None, directory: str | None) -> dict | None:
    candidates = [path] if path else []
    if directory:
        candidates += sorted(glob.glob(
            os.path.join(directory, "*device_ledger.json")))
    for cand in candidates:
        try:
            with open(cand) as fh:
                doc = json.load(fh)
            if isinstance(doc, dict) and "flight_recorder" in doc:
                doc["_path"] = cand
                return doc
        except (OSError, ValueError):
            continue
    return None


def collect(directory: str | None, events: str | None = None,
            device_ledger: str | None = None) -> dict:
    """One snapshot of everything obs_top can see right now."""
    snap: dict = {"unix": time.time(), "dir": directory}
    if directory and os.path.isdir(directory):
        snap["heartbeats"] = _heartbeats(directory)
        from pos_evolution_tpu_torch.telemetry.fleet import FleetAggregator
        agg = FleetAggregator.from_dir(directory)
        if agg.snapshots_merged:
            snap["fleet"] = agg.summary()
            snap["counters"] = {
                name: agg.fleet_total(name)
                for name in ("kernel_builds_total",
                             "kernel_launches_total",
                             "jax_transfer_bytes_total",
                             "jax_dispatches_total",
                             "serve_requests_total")
                if agg.fleet_total(name)}
    if events:
        snap["events"] = _tail_events(events)
    ledger = _device_ledger(device_ledger, directory)
    if ledger is not None:
        snap["device_ledger"] = ledger
    return snap


def _progress(snap: dict) -> dict:
    """Best available (slot, justified, finalized) view."""
    best: dict = {}
    for hb in snap.get("heartbeats", ()):
        payload = hb.get("payload") or {}
        if payload.get("slot") is not None and \
                payload.get("slot", -1) >= best.get("slot", -1):
            best = {k: payload.get(k) for k in
                    ("slot", "justified_epoch", "finalized_epoch")
                    if payload.get(k) is not None}
    ev = (snap.get("events") or {}).get("slot")
    if ev and ev.get("slot", -1) >= best.get("slot", -1):
        # merge, don't replace: a slot event usually carries no epoch
        # fields, and dropping the heartbeat's justified/finalized on a
        # tie would blank the finality-lag readout
        best.update({k: ev[k] for k in
                     ("slot", "justified_epoch", "finalized_epoch")
                     if ev.get(k) is not None})
    return best


def render(snap: dict, prev: dict | None = None,
           interval: float | None = None) -> str:
    lines = [f"obs_top @ {time.strftime('%H:%M:%S', time.gmtime(snap['unix']))}Z"
             f"  dir={snap.get('dir') or '-'}"]
    prog = _progress(snap)
    if prog:
        line = f"  slot {prog.get('slot', '?')}"
        if prog.get("justified_epoch") is not None:
            line += f"  justified {prog['justified_epoch']}"
        if prog.get("finalized_epoch") is not None:
            line += f"  finalized {prog['finalized_epoch']}"
            if prog.get("justified_epoch") is not None:
                # finality lag: justified-but-unfinalized epochs. 1 is
                # healthy pipelining; growing lag = liveness trouble
                lag = (int(prog["justified_epoch"])
                       - int(prog["finalized_epoch"]))
                line += f"  lag {lag}"
        if prev is not None and interval:
            p = _progress(prev)
            if p.get("slot") is not None and prog.get("slot") is not None:
                rate = (prog["slot"] - p["slot"]) / interval
                line += f"  ({rate:.2f} slots/s)"
        lines.append(line)
    for hb in snap.get("heartbeats", ()):
        stale = interval is not None and hb["age_s"] > 3 * interval
        flag = "  ** STALE **" if stale else ""
        lines.append(f"  hb {hb['file']:<28} age {hb['age_s']:>6.1f}s"
                     f"{flag}")
    fleet = snap.get("fleet")
    if fleet:
        reqs = fleet.get("requests_by_worker") or {}
        for w, meta in sorted((fleet.get("workers") or {}).items()):
            lines.append(f"  worker {w:<4} pid {meta.get('pid')} "
                         f"gen {meta.get('generation')} "
                         f"requests {int(reqs.get(w, 0))}")
    counters = snap.get("counters")
    if counters:
        parts = []
        for name, val in sorted(counters.items()):
            short = name.replace("_total", "")
            if "bytes" in name:
                parts.append(f"{short}={_fmt_bytes(val)}")
            else:
                parts.append(f"{short}={int(val)}")
        lines.append("  " + "  ".join(parts))
    ledger = snap.get("device_ledger")
    if ledger:
        fr = ledger.get("flight_recorder") or {}
        mem = fr.get("memory") or {}
        peaks = mem.get("peak_bytes") or {}
        if peaks:
            peak_line = "  hbm watermark: " + "  ".join(
                f"{dev}={_fmt_bytes(b)}" for dev, b in sorted(peaks.items()))
            peak_line += f"  (source={mem.get('source')})"
            lines.append(peak_line)
        led = fr.get("compile_ledger") or {}
        attr = led.get("attribution") or {}
        if attr.get("builds") is not None:
            lines.append(f"  kernel builds: {attr['builds']} "
                         f"({attr.get('named_pct', '-')}% named)")
        elif attr.get("backend_compiles") is not None:
            lines.append(f"  compiles: {attr['backend_compiles']} "
                         f"({attr.get('named_pct', '-')}% named)")
        rows = led.get("rows") or []
        if rows and rows[0].get("source") is not None:
            r = rows[0]
            lines.append(f"  top build row: {r.get('source')} "
                         f"{r.get('function')} phase={r.get('phase')} "
                         f"x{r.get('count')} ({r.get('seconds')}s)")
        elif rows:
            r = rows[0]
            lines.append(f"  top compile row: {r.get('function')} "
                         f"phase={r.get('phase')} x{r.get('count')} "
                         f"({r.get('seconds')}s)")
        launched = (fr.get("kernels") or {}).get("launches") or {}
        if launched:
            lines.append("  kernel launches: " + "  ".join(
                f"{k}={v}" for k, v in sorted(launched.items())))
        skew = fr.get("shard_skew") or {}
        table = skew.get("table") or []
        if table:
            worst = max(table, key=lambda r: r.get("max_ms", 0))
            lines.append(f"  worst shard skew: {worst['phase']}/"
                         f"{worst['device']} max {worst['max_ms']} ms "
                         f"over {worst['probes']} probe(s)")
    dm = (snap.get("events") or {}).get("device_memory")
    if dm and "device_ledger" not in snap:
        rows = dm.get("rows") or []
        if rows:
            lines.append("  live memory: " + "  ".join(
                f"{r['device']}={_fmt_bytes(r['bytes_in_use'])}"
                for r in rows))
    if len(lines) == 1:
        lines.append("  (nothing to show yet — no heartbeats, snapshots, "
                     "events, or device ledger found)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", help="run directory (heartbeats, fleet "
                                  "snapshots, device ledger artifacts)")
    ap.add_argument("--events", help="event log to tail for slot/memory")
    ap.add_argument("--device-ledger",
                    help="explicit flight-recorder artifact path")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (CI artifact mode)")
    args = ap.parse_args(argv)

    prev = None
    while True:
        snap = collect(args.dir, events=args.events,
                       device_ledger=args.device_ledger)
        text = render(snap, prev=prev,
                      interval=None if args.once else args.interval)
        if args.once:
            print(text)
            return 0
        # ANSI clear + home, then the frame — a plain terminal "top"
        sys.stdout.write("\x1b[2J\x1b[H" + text + "\n")
        sys.stdout.flush()
        prev = snap
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
