"""The port's multi-process serving plane on the CPU (``serve/shm``,
``serve/workers``, ``serve/balancer``, ``utils/singleflight.ProcessFlight``):
the JAX package's ``tests/test_serve_mp.py`` on the port's modules, with
its sizes and timeouts, the workers' schemes on ``device="cpu"``.

- the shared-memory view board: encode/decode fidelity (and the encoded
  bytes equal to the JAX package's for the same seeded view), the
  publish-once / attach-many seqlock contract, health slots and the
  supervisor's tombstone;
- the cross-process build lease: leader election, spool handoff to
  waiters, dead-leader takeover;
- the 8-process stampede pin: ``sum(leads) == n_keys`` across the pool;
- ``WorkerPool`` supervision with real spawn children: a SIGKILL'd worker
  is detected as a crash and respawned, a wedged worker as a hang, and
  respawns land on the board's current view generation; a worker asked
  for CUDA on a machine without it never becomes ready (no fallback);
- the balancer's health-biased weighting and the tombstone's trickle;
- the fleet's ``kernel_launches_total`` summed by kernel.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu_torch.config import cfg, minimal_config, use_config  # noqa: E402
from pos_evolution_tpu_torch.serve.shm import (  # noqa: E402
    LEASE_BUILDING,
    LEASE_DONE,
    ShmViewBoard,
    decode_view,
    encode_view,
    lease_digest,
)
from pos_evolution_tpu_torch.serve.state import ServeView  # noqa: E402
from pos_evolution_tpu_torch.utils.singleflight import ProcessFlight  # noqa: E402

_CTX = multiprocessing.get_context("spawn")


def _tiny_view(slot: int = 7, n_blobs: int = 2) -> ServeView:
    root = bytes([slot % 256]) * 32
    sidecars = [_Sidecar(np.full((8, 40), i + 1, dtype=np.uint8),
                         bytes([i]) * 32) for i in range(n_blobs)]
    return ServeView(
        slot=slot, head_root=root, head_slot=slot,
        justified_epoch=1, justified_root=b"\x01" * 32,
        finalized_epoch=0, finalized_root=b"\x02" * 32,
        update_ssz=b"\x5a" * 64, update_root=b"\x03" * 32,
        sidecars={root: sidecars}, n_cells=16)


class _Sidecar:
    def __init__(self, cells, commitment):
        self.cells = cells
        self.commitment = commitment


def _board(tmp, **kw):
    lock_path = os.path.join(tmp, "board.lock")
    return ShmViewBoard.create(lock_path, **kw), lock_path


# --- shared-memory view board -------------------------------------------------

class TestShmViewBoard:
    def test_encode_decode_roundtrip(self):
        view = _tiny_view()
        out = decode_view(encode_view(view))
        assert out.slot == view.slot
        assert out.head_root == view.head_root
        assert out.update_ssz == view.update_ssz
        assert out.update_root == view.update_root
        assert out.n_cells == view.n_cells
        (root, cars), = out.sidecars.items()
        assert root == view.head_root
        for got, want in zip(cars, view.sidecars[view.head_root]):
            assert got.commitment == want.commitment
            np.testing.assert_array_equal(got.cells, want.cells)

    def test_encoded_bytes_equal_jax(self):
        """A view of seeded cell grids encodes to the JAX package's bytes,
        and each package decodes the other's."""
        from pos_evolution_tpu.serve import shm as jshm
        from pos_evolution_tpu.serve.state import ServeView as JServeView
        rng = np.random.default_rng(41)
        roots = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(2)]
        fields = dict(
            slot=9, head_root=roots[-1], head_slot=9, justified_epoch=1,
            justified_root=b"\x01" * 32, finalized_epoch=0, finalized_root=b"\x02" * 32,
            update_ssz=bytes(rng.integers(0, 256, 77, dtype=np.uint8)),
            update_root=b"\x03" * 32, n_cells=16)
        cars = {r: [_Sidecar(rng.integers(0, 256, (16, 64), dtype=np.uint8),
                             bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
                    for _ in range(2)] for r in roots}
        ours = encode_view(ServeView(sidecars=cars, **fields))
        theirs = jshm.encode_view(JServeView(sidecars=cars, **fields))
        assert ours == theirs
        back = decode_view(theirs)
        assert encode_view(back) == ours
        assert jshm.encode_view(jshm.decode_view(ours)) == theirs

    def test_publish_once_attach_many(self):
        with tempfile.TemporaryDirectory() as tmp:
            board, lock_path = _board(tmp)
            try:
                assert board.current() == (0, None)
                g1 = board.publish(_tiny_view(slot=7))
                reader = ShmViewBoard.attach(board.name, lock_path)
                try:
                    gen, view = reader.current()
                    assert gen == g1 and view.slot == 7
                    # same generation decodes once: the cache is hit
                    assert reader.current()[1] is view
                    g2 = board.publish(_tiny_view(slot=8))
                    assert g2 > g1
                    gen, view = reader.current()
                    assert gen == g2 and view.slot == 8
                finally:
                    reader.close()
            finally:
                board.close()

    def test_health_slots_and_tombstone(self):
        with tempfile.TemporaryDirectory() as tmp:
            board, _ = _board(tmp, n_fronts=4)
            try:
                board.write_health(1, generation=6, brownout=True,
                                   depth=3, requests=42, shed=2)
                (row,) = board.read_health()
                assert row["front"] == 1 and row["pid"] == os.getpid()
                assert row["brownout"] and row["depth"] == 3
                assert row["requests"] == 42 and row["shed"] == 2
                assert row["age_s"] < 2.0
                # the supervisor's tombstone: the slot vanishes from
                # routing immediately, no staleness window
                board.clear_health(1)
                assert board.read_health() == []
            finally:
                board.close()


# --- build lease --------------------------------------------------------------

def _built(n: int = 4) -> dict:
    return {c: (np.full(6, c, dtype=np.uint8),
                np.full((2, 3), c, dtype=np.uint8)) for c in range(n)}


class TestBuildLease:
    def test_leader_spools_then_waiters_absorb(self):
        with tempfile.TemporaryDirectory() as tmp:
            board, _ = _board(tmp)
            try:
                digest = lease_digest(("proofs", b"\x07" * 32, 0))
                role, slot = board.lease_acquire(digest)
                assert role == "lead" and slot >= 0
                built = _built()
                board.spool_write(digest, built)
                board.lease_done(slot, digest)
                role2, slot2 = board.lease_acquire(digest)
                assert role2 == "done" and slot2 == slot
                got = board.spool_read(digest)
                assert set(got) == set(built)
                for c in built:
                    np.testing.assert_array_equal(got[c][0], built[c][0])
                    np.testing.assert_array_equal(got[c][1], built[c][1])
            finally:
                board.close()

    def test_live_leader_makes_waiters(self):
        with tempfile.TemporaryDirectory() as tmp:
            board, _ = _board(tmp)
            try:
                digest = lease_digest(("proofs", b"\x08" * 32, 1))
                role, slot = board.lease_acquire(digest)
                assert role == "lead"
                # this process IS the live leader: a second claimant
                # must wait, not build
                assert board.lease_acquire(digest) == ("wait", slot)
                assert board.lease_state(slot, digest) == (
                    LEASE_BUILDING, os.getpid())
            finally:
                board.close()

    def test_dead_leader_takeover(self):
        with tempfile.TemporaryDirectory() as tmp:
            board, _ = _board(tmp)
            try:
                # a real dead pid: spawn-and-reap a child
                proc = subprocess.run([sys.executable, "-c", "pass"])
                dead = subprocess.Popen([sys.executable, "-c", "pass"])
                dead_pid = dead.pid
                dead.wait()
                assert proc.returncode == 0
                digest = lease_digest(("proofs", b"\x09" * 32, 2))
                board._write_lease(0, digest, LEASE_BUILDING, dead_pid)
                role, slot = board.lease_acquire(digest)
                assert (role, slot) == ("lead", 0)
            finally:
                board.close()


    def test_lease_lock_excludes_the_threads_of_one_process(self, monkeypatch):
        """The lease table's file lock holds between threads that share
        one attached board, as between processes: first callers racing
        to open the lock file do not leave it held through a descriptor
        no one unlocks, and no two threads are inside at once."""
        import threading

        from pos_evolution_tpu_torch.serve import shm

        with tempfile.TemporaryDirectory() as tmp:
            board, lock_path = _board(tmp)
            worker = ShmViewBoard.attach(board.name, lock_path)
            real_open = os.open

            def slow_open(*a, **k):
                # widen the first callers' window between the check and
                # the open, as a loaded host does
                fd = real_open(*a, **k)
                time.sleep(0.05)
                return fd

            monkeypatch.setattr(shm.os, "open", slow_open)
            inside, most = [0], [0]

            def hold():
                for _ in range(5):
                    worker._flock()
                    try:
                        inside[0] += 1
                        most[0] = max(most[0], inside[0])
                        time.sleep(0.005)
                        inside[0] -= 1
                    finally:
                        worker._funlock()

            threads = [threading.Thread(target=hold, daemon=True) for _ in range(4)]
            try:
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=10.0)
                assert not any(t.is_alive() for t in threads), "lease lock never released"
                assert most[0] == 1, most
                monkeypatch.setattr(shm.os, "open", real_open)
                # another open file (another process's) takes it after them
                assert board.lease_acquire(b"\x01" * 16)[0] == "lead"
            finally:
                worker.close()
                board.close()


# --- 8-process stampede -------------------------------------------------------

def _stampede_child(board_name: str, lock_path: str, barrier,
                    out_path: str, n_keys: int) -> None:
    """Spawn entry: rendezvous with 7 siblings, then miss every key at
    once. Builds are tiny and deterministic so waiters can check the
    absorbed values."""
    board = ShmViewBoard.attach(board_name, lock_path)
    flight = ProcessFlight(board, timeout_s=60.0)
    results = {}
    try:
        barrier.wait(60.0)
        for k in range(n_keys):
            built = flight.do(("stampede", k),
                              lambda k=k: _built(4 + k))
            results[k] = int(sum(int(v[0][0]) for v in built.values()))
        payload = {"leads": flight.leads,
                   "cross_waits": flight.cross_waits,
                   "fallbacks": flight.fallbacks,
                   "results": results}
    finally:
        board.close()
    with open(out_path, "w") as f:
        json.dump(payload, f)


class TestEightProcessStampede:
    def test_builds_once_per_key_across_eight_processes(self):
        n_procs, n_keys = 8, 2
        with tempfile.TemporaryDirectory() as tmp:
            board, lock_path = _board(tmp)
            barrier = _CTX.Barrier(n_procs)
            outs = [os.path.join(tmp, f"p{i}.json")
                    for i in range(n_procs)]
            procs = [_CTX.Process(target=_stampede_child,
                                  args=(board.name, lock_path, barrier,
                                        outs[i], n_keys))
                     for i in range(n_procs)]
            try:
                for p in procs:
                    p.start()
                for p in procs:
                    p.join(120.0)
                    assert p.exitcode == 0
                reports = []
                for path in outs:
                    with open(path) as f:
                        reports.append(json.load(f))
            finally:
                for p in procs:
                    if p.is_alive():
                        p.kill()
                board.close()
            # THE stampede pin: one build per key across the entire
            # process pool — every other (process, key) pair absorbed
            # the leader's spool
            assert sum(r["leads"] for r in reports) == n_keys
            assert sum(r["fallbacks"] for r in reports) == 0
            assert (sum(r["cross_waits"] for r in reports)
                    == n_procs * n_keys - n_keys)
            # and every process saw the same built values
            want = {str(k): (4 + k) * (3 + k) // 2 for k in range(n_keys)}
            for r in reports:
                assert r["results"] == want


# --- WorkerPool supervision ---------------------------------------------------

def _free_ports(n: int) -> list[int]:
    ports, socks = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


class TestWorkerPoolSupervision:
    def test_crash_and_hang_detection_respawn_on_current_generation(self):
        from pos_evolution_tpu_torch.serve.workers import WorkerPool, worker_spec

        with use_config(minimal_config()), \
                tempfile.TemporaryDirectory() as tmp:
            board, lock_path = _board(tmp, n_fronts=4)
            board.publish(_tiny_view(slot=1))
            cfg_dict = dataclasses.asdict(cfg())

            def start(lead):
                # worker 1 wedges shortly after ready: its beat thread goes
                # silent inside the window while the process stays alive —
                # exactly what hang detection exists to catch. The window is
                # short enough that the RESPAWNED child is outside it (a
                # still-open window would wedge every respawn into parking)
                (port,) = _free_ports(1)
                wedge_at = time.time() + lead
                specs = [
                    worker_spec(0, port, board.name, lock_path, tmp,
                                threads=1, config=cfg_dict, device="cpu"),
                    worker_spec(1, port, board.name, lock_path, tmp,
                                threads=1, config=cfg_dict, device="cpu",
                                chaos={"wedge_windows":
                                       [(wedge_at, wedge_at + 2.5)]}),
                ]
                pool = WorkerPool(specs, board, hang_timeout_s=1.5,
                                  backoff_s=0.1, backoff_cap_s=0.5)
                try:
                    pool.start()
                    return pool, pool.wait_ready(60.0), wedge_at
                except BaseException:
                    pool.stop()
                    raise

            # the window must open after the pool is ready: a worker that
            # first beats after its window never wedges, and on a loaded
            # host a boot can outlast the lead, so such a pool is started
            # again with a lead twice the boot it took
            lead = 3.0
            pool, ready, wedge_at = start(lead)
            for _ in range(2):
                if not ready or time.time() < wedge_at:
                    break
                boot = time.time() - (wedge_at - lead)
                pool.stop()
                lead = 2 * boot
                pool, ready, wedge_at = start(lead)
            try:
                assert ready, "pool never became ready"
                killed = pool.kill_worker(0)
                assert killed is not None
                deadline = time.monotonic() + 60.0
                while time.monotonic() < deadline:
                    reasons = {i["reason"] for i in pool.interruptions}
                    rows = pool.worker_rows()
                    if {"crash", "hang"} <= reasons \
                            and all(r["alive"] for r in rows) \
                            and all(r["restarts"] >= 1 for r in rows):
                        break
                    time.sleep(0.1)
                reasons = [i["reason"] for i in pool.interruptions]
                assert "crash" in reasons, reasons
                assert "hang" in reasons, reasons
                by_worker = {i["worker"]: i["reason"]
                             for i in pool.interruptions}
                assert by_worker.get(0) == "crash"
                assert by_worker.get(1) == "hang"
                rows = pool.worker_rows()
                assert all(r["alive"] for r in rows), rows
                assert all(r["restarts"] >= 1 for r in rows), rows
                # respawns serve the CURRENT published view: advance the
                # generation and require both children to converge on it
                gen = board.publish(_tiny_view(slot=2))
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    rows = pool.worker_rows()
                    if all(r["generation"] == gen for r in rows):
                        break
                    time.sleep(0.1)
                assert all(r["generation"] == gen
                           for r in pool.worker_rows()), \
                    (gen, pool.worker_rows())
            finally:
                pool.stop()
                board.close()


class TestNoFallback:
    def test_cuda_worker_without_a_card_never_becomes_ready(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        from pos_evolution_tpu_torch.serve.workers import WorkerPool, worker_spec

        with use_config(minimal_config()), \
                tempfile.TemporaryDirectory() as tmp:
            board, lock_path = _board(tmp, n_fronts=4)
            board.publish(_tiny_view(slot=1))
            (port,) = _free_ports(1)
            spec = worker_spec(0, port, board.name, lock_path, tmp, threads=1,
                               config=dataclasses.asdict(cfg()))
            assert spec["device"] == "cuda"
            pool = WorkerPool([spec], board, hang_timeout_s=1.5,
                              max_failures=1, backoff_s=0.1)
            try:
                pool.start()
                deadline = time.monotonic() + 60.0
                while time.monotonic() < deadline and not pool.slots[0].parked:
                    time.sleep(0.1)
                assert not pool.wait_ready(0.5)
                (record,) = pool.interruptions
                assert record["reason"] == "crash" and record["exit_code"] != 0
                assert pool.slots[0].parked
            finally:
                pool.stop()
                board.close()


@pytest.mark.parametrize("wedged", [False, True])
def test_worker_beats_once_before_its_scheme_outside_wedges(monkeypatch, wedged):
    """A worker beats (marked ``booting``) before it builds its scheme, so
    the hang timeout covers the CUDA context's creation alone; inside a
    chaos wedge window that beat is withheld too."""
    from pos_evolution_tpu_torch.das import commitment
    from pos_evolution_tpu_torch.serve.workers import _worker_main, worker_spec
    from pos_evolution_tpu_torch.utils.watchdog import read_heartbeat

    class Booted(Exception):
        pass

    def get_scheme(*_a, **_k):
        seen.append(read_heartbeat(spec["heartbeat_path"]))
        raise Booted

    with use_config(minimal_config()), tempfile.TemporaryDirectory() as tmp:
        now = time.time()
        spec = worker_spec(3, 0, "board", os.path.join(tmp, "l"), tmp,
                           config=dataclasses.asdict(cfg()), device="cpu",
                           chaos={"wedge_windows": [(now - 1, now + 60)]}
                           if wedged else None)
        seen = []
        monkeypatch.setattr(commitment, "get_scheme", get_scheme)
        with pytest.raises(Booted):
            _worker_main(spec)
        (hb,) = seen
        if wedged:
            assert hb is None
        else:
            assert hb["payload"]["booting"] and hb["payload"]["worker"] == 3
            # the beat stamps its time rounded to the millisecond
            assert hb["payload"]["unix"] >= round(now, 3)


def test_fleet_kernel_launches_sum_by_kernel():
    from pos_evolution_tpu_torch.serve.harness import kernel_launches
    from pos_evolution_tpu_torch.telemetry import fleet
    from pos_evolution_tpu_torch.telemetry.registry import MetricsRegistry
    agg = fleet.FleetAggregator()
    for worker, n in ((0, 3), (1, 5)):
        reg = MetricsRegistry()
        c = reg.counter("kernel_launches_total", "launches")
        c.inc(n, kernel="sha256_blocks")
        c.inc(7 * n, kernel="merkle_level")
        reg.counter("serve_requests_total", "requests").inc(2, method="head", status="ok")
        agg.add({"v": 1, "worker": worker, "pid": 100 + worker, "front": None,
                 "generation": None, "wall": 0.0, "registry": reg.snapshot()})
    assert kernel_launches(agg.registry.to_prometheus()) == {
        "sha256_blocks": 8, "merkle_level": 56}
    assert kernel_launches("") == {}


# --- balancer weighting -------------------------------------------------------

class TestBalancerWeighting:
    def _shares(self, bal, n: int = 2000) -> list[float]:
        counts = [0] * bal.n_fronts
        for i in range(n):
            counts[bal.pick((i + 0.5) / n)] += 1
        return [c / n for c in counts]

    def test_health_bias_and_tombstone_trickle(self):
        from pos_evolution_tpu_torch.serve.balancer import Balancer

        with tempfile.TemporaryDirectory() as tmp:
            board, _ = _board(tmp, n_fronts=4)
            try:
                for slot in (0, 1, 2, 3):
                    board.write_health(slot, generation=2)
                bal = Balancer(2, board=board,
                               slot_map=[[0, 1], [2, 3]],
                               refresh_s=0.0)
                shares = self._shares(bal)
                assert abs(shares[0] - 0.5) < 0.05, shares
                # front 1 browns out entirely: it keeps a reduced share
                # (brownout is degradation, not death)
                board.write_health(2, generation=2, brownout=True)
                board.write_health(3, generation=2, brownout=True)
                shares = self._shares(bal)
                assert shares[0] > 0.65, shares
                assert shares[1] > 0.1, shares
                # both its workers die and the supervisor tombstones
                # them: the front drops to the probe trickle at once
                board.clear_health(2)
                board.clear_health(3)
                shares = self._shares(bal)
                assert shares[1] < 0.1, shares
                assert shares[0] > 0.9, shares
            finally:
                board.close()

    def test_no_board_is_uniform(self):
        from pos_evolution_tpu_torch.serve.balancer import Balancer

        bal = Balancer(4)
        shares = self._shares(bal)
        assert all(abs(s - 0.25) < 0.02 for s in shares), shares


def test_swarm_records_arrivals_held_by_a_displaced_connection():
    """A failover installs a fresh connection in a grid slot while the
    connection it displaces still holds unanswered arrivals: the run ends
    with every scheduled arrival recorded (those held there as lost, for
    a reason), not with fewer records than the schedule."""
    import threading

    from pos_evolution_tpu_torch.serve.balancer import SwarmLoadGenerator

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(16)
    held = []

    def black_hole():
        # accept and read, never answer
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            held.append(conn)
            threading.Thread(target=lambda c=conn: [None for _ in iter(
                lambda: c.recv(1 << 16), b"")], daemon=True).start()

    threading.Thread(target=black_hole, daemon=True).start()
    try:
        gen = SwarmLoadGenerator([srv.getsockname()], 40, 2000.0,
                                 conns_per_front=1, seed=5,
                                 interactive_deadline_s=0.05,
                                 bulk_deadline_s=0.05)
        send, displaced = gen._send, []

        def send_then_displace(conn, frames):
            send(conn, frames)
            if not displaced:
                displaced.append(conn)
                gen._fresh_conn(conn.front)

        gen._send = send_then_displace
        out = gen.run()
        assert displaced and displaced[0].pending
        assert out["arrivals"] == out["scheduled"] == 40
        assert out["lost"] == 40 and out["lost_by_reason"]["unswept"] > 0
    finally:
        srv.close()
        for c in held:
            c.close()


def test_serve_probe_reads_thread_cpu_over_the_load_window():
    """The plane's probe reads each thread's CPU seconds by name and takes
    the snapshots that bracket a load window."""
    import threading

    from pos_evolution_tpu_torch.serve_probe import _cpu_in, _thread_cpu

    stop = threading.Event()
    t = threading.Thread(target=lambda: stop.wait(5.0), name="probe-test-7", daemon=True)
    t.start()
    try:
        cpu = _thread_cpu()
        assert "MainThread" in cpu and "probe-test-#" in cpu
        assert all(v >= 0.0 for v in cpu.values())
    finally:
        stop.set()
        t.join()
    snaps = [(1.0, {"a": 1.0}), (2.0, {"a": 1.5, "b": 0.01}), (3.0, {"a": 2.5, "b": 0.5}),
             (4.0, {"a": 9.0, "b": 0.5})]
    assert _cpu_in(snaps, 2.5, 3.0) == (1.0, {"a": 1.0, "b": 0.49})
    assert _cpu_in(snaps, 0.5, 3.0) == (None, {})


# --- end-to-end scenario (heavy: full mp plane under chaos) -------------------

@pytest.mark.slow
class TestMpScenario:
    def test_chaos_scenario_verdict_ok(self):
        from pos_evolution_tpu_torch.serve.harness import run_mp_scenario

        with use_config(minimal_config()):
            result = run_mp_scenario(
                arrivals=12000, rate=6000.0, seed=11, kills=1,
                wedges=1, fd_exhaust_n=32, device="cpu")
        verdict = result["verdict"]
        assert verdict["ok"], verdict
        assert verdict["interactive_goodput_pct"] >= 99.0
        assert verdict["lost"] == 0 or \
            result["load"]["lost_by_reason"], "losses must carry reasons"
