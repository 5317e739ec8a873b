"""Where the serving plane's time goes: the ``--mp`` phases with every process
sampled.

    python -m pos_evolution_tpu_torch.serve_probe [--device cuda|cpu] [--out DIR]

Runs ``serve.run_mp_scenario`` at the serving demo's ``--mp`` defaults (steady
60,000 arrivals at 20,000/s; chaos 30,000 at 10,000/s with 2 kills, 1 wedge and
32 held fds; 2 fronts x 2 worker processes), under the mainnet config with the
PeerDAS geometry. Each worker and the load generator run a
sampler thread: every 5 ms the top 4 Python frames of each thread, every 0.5 s
each thread's CPU seconds (``/proc/self/task``). A worker also records its boot:
its first beat, its scheme, its CUDA context and its first serving beat, in
seconds from its entry. Prints, for each phase, the load's outcome, each
process's CPU seconds by thread over the load window and its most sampled
stacks; the samples stay in ``--out``. A thread parked in a C call (``recv``,
``sendall``, ``flock``) is sampled at the Python line that made it, so a stack
with CPU seconds beside it and no Python work below it spends them in the call.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import tempfile
import threading
import time

from pos_evolution_tpu_torch.serve import balancer, workers

__all__ = ["main"]

_DIR_ENV = "POS_SERVE_PROBE_DIR"
_WORKER_MAIN = workers._worker_main
_WARM = workers._warm_device


def _thread_cpu() -> dict:
    """CPU seconds by thread name (digits folded) of this process."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out: dict = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                stat = f.read()
            with open(f"/proc/self/task/{tid}/comm") as f:
                comm = f.read().strip()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        key = re.sub(r"\d+", "#", names.get(int(tid)) or f"native:{comm}")
        out[key] = out.get(key, 0.0) + (int(fields[11]) + int(fields[12])) / tick
    return out


class _Sampler:
    def __init__(self, tag: str, heartbeat_path: str | None = None):
        self.tag, self.heartbeat_path = tag, heartbeat_path
        self.stop = threading.Event()
        self.buckets: dict = collections.defaultdict(collections.Counter)
        self.cpu: list = []
        self.boot = {"entry": time.time()}
        self.window = None
        self.thread = threading.Thread(target=self._loop, name="probe-sampler", daemon=True)
        self.thread.start()

    def _loop(self) -> None:
        from pos_evolution_tpu_torch.utils.watchdog import read_heartbeat
        me, last = threading.get_ident(), 0.0
        while not self.stop.is_set():
            now = time.time()
            names = {t.ident: t.name for t in threading.enumerate()}
            bucket = self.buckets[int(now)]
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                stack = []
                while frame is not None and len(stack) < 4:
                    code = frame.f_code
                    stack.append(f"{os.path.basename(code.co_filename)}:{code.co_name}:"
                                 f"{frame.f_lineno}")
                    frame = frame.f_back
                bucket[re.sub(r"\d+", "#", names.get(tid, "?")) + " | "
                       + " < ".join(stack)] += 1
            if now - last >= 0.5:
                self.cpu.append((now, _thread_cpu()))
                last = now
            if self.heartbeat_path and "serving_beat" not in self.boot:
                hb = read_heartbeat(self.heartbeat_path)
                if hb and hb["payload"].get("booting"):
                    self.boot.setdefault("boot_beat", hb["payload"]["unix"])
                elif hb and hb["payload"].get("unix", 0) >= self.boot["entry"]:
                    self.boot["serving_beat"] = hb["payload"]["unix"]
            time.sleep(0.005)

    def dump(self, path: str) -> None:
        self.stop.set()
        self.thread.join(1.0)
        self.cpu.append((time.time(), _thread_cpu()))
        with open(path, "w") as f:
            json.dump({"tag": self.tag, "pid": os.getpid(), "boot": self.boot,
                       "window": self.window, "cpu": self.cpu,
                       "buckets": {str(k): dict(v) for k, v in self.buckets.items()}}, f)


def _sampled_worker(spec: dict) -> None:
    """A worker's process target under the sampler (forked from the pool's
    forkserver, which imports this module when it unpickles the target)."""
    sampler = _Sampler(f"worker{spec['worker_id']}", spec["heartbeat_path"])

    def warm(scheme):
        sampler.boot["scheme"] = time.time()
        _WARM(scheme)
        sampler.boot["warm"] = time.time()

    workers._warm_device = warm
    try:
        _WORKER_MAIN(spec)
    finally:
        sampler.dump(os.path.join(os.environ[_DIR_ENV],
                                  f"w{spec['worker_id']}_{os.getpid()}.json"))


def _sampled_run(self):
    sampler = _Sampler("loadgen")
    t0 = time.time()
    try:
        return _SWARM_RUN(self)
    finally:
        sampler.window = (t0, time.time())
        sampler.dump(os.path.join(os.environ[_DIR_ENV], f"loadgen_{int(t0 * 1e3)}.json"))


_SWARM_RUN = balancer.SwarmLoadGenerator.run


def _cpu_in(snaps: list, lo: float, hi: float):
    before = [s for s in snaps if s[0] <= lo]
    after = [s for s in snaps if s[0] >= hi]
    if not before or not after:
        return None, {}
    a, b = before[-1], after[0]
    d = {k: round(b[1].get(k, 0.0) - a[1].get(k, 0.0), 3) for k in b[1]}
    return round(b[0] - a[0], 3), dict(sorted(((k, v) for k, v in d.items() if v > 0.02),
                                              key=lambda kv: -kv[1]))


def report(out: str, results: dict) -> None:
    """Print each phase's outcome and its processes' CPU and stacks."""
    gens = sorted((json.load(open(p)) for p in glob.glob(os.path.join(out, "loadgen_*.json"))),
                  key=lambda d: d["window"][0])
    procs = [json.load(open(p)) for p in glob.glob(os.path.join(out, "w*_*.json"))]
    for (tag, r), gen in zip(results.items(), gens):
        load, lo, hi = r["load"], *gen["window"]
        print(f"--- {tag}: load window {hi - lo:.2f} s, pool ready {r.get('ready_s')} s")
        print("  load:", json.dumps({k: load.get(k) for k in (
            "arrivals", "scheduled", "wall_s", "late_dispatch", "lost", "lost_by_reason",
            "resends", "shed_retries", "verified_proofs", "by_front")}))
        for tier in ("interactive", "bulk"):
            print(f"  {tier}:", json.dumps(load["tiers"][tier]))
        print("  requests by worker:", json.dumps(r["verdict"].get("fleet_requests_by_worker")))
        for d in [gen] + sorted(procs, key=lambda d: d["tag"]):
            span, per = _cpu_in(d["cpu"], lo, hi)
            if span is None:
                continue
            print(f"  CPU {d['tag']} (pid {d['pid']}): {sum(per.values()):.3f} s in {span} s:",
                  json.dumps(dict(list(per.items())[:8])))
            if d["tag"] != "loadgen":
                print("    boot s:", json.dumps({k: round(x - d["boot"]["entry"], 3)
                                               for k, x in d["boot"].items()}))
            stacks = collections.Counter()
            for sec, bucket in d["buckets"].items():
                if lo <= int(sec) <= hi:
                    stacks.update(bucket)
            for k, n in stacks.most_common(8):
                print(f"    {n:6d} {k[:220]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="the samples' directory")
    args = ap.parse_args(argv)
    from pos_evolution_tpu_torch.backend import use_backend
    from pos_evolution_tpu_torch.config import mainnet_config, use_config
    from pos_evolution_tpu_torch.device import card_line, resolve_device
    from pos_evolution_tpu_torch.serve import run_mp_scenario
    from pos_evolution_tpu_torch.sim.driver import PEERDAS

    dev = resolve_device(args.device)
    out = args.out or tempfile.mkdtemp(prefix="serve_probe_")
    os.makedirs(out, exist_ok=True)
    os.environ[_DIR_ENV] = os.path.abspath(out)
    print(f"serve_probe [{card_line(dev)}] samples in {out}")
    # the process target pickles by its module's name (run as ``-m``, this
    # module is ``__main__``, which a forkserver's child cannot import)
    from pos_evolution_tpu_torch import serve_probe
    workers._worker_main = serve_probe._sampled_worker
    balancer.SwarmLoadGenerator.run = _sampled_run
    results = {}
    try:
        with use_config(mainnet_config().replace(**PEERDAS)), use_backend("torch", device=dev):
            for tag, kw in (("steady", dict(arrivals=60_000, rate=20_000.0, kills=0, wedges=0,
                                            fd_exhaust_n=0)),
                            ("chaos", dict(arrivals=30_000, rate=10_000.0, kills=2, wedges=1,
                                           fd_exhaust_n=32))):
                results[tag] = run_mp_scenario(n_fronts=2, workers_per_front=2, seed=7,
                                               slo_ms=300.0, device=str(dev), **kw)
    finally:
        workers._worker_main = _WORKER_MAIN
        balancer.SwarmLoadGenerator.run = _SWARM_RUN
    report(out, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
