"""Hardened live serving tier (DESIGN.md §19, ROADMAP item 3).

Turns the vectorized-batch serving story (``das/server.py``'s coalescing
``DasServer``, the light-client update builders, head/finality queries)
into an actual **traffic** story: a multi-worker async RPC front speaking
length-prefixed JSON over sockets, with the overload machinery a tier
facing 10^5+ untrusted clients needs to degrade gracefully instead of
collapsing:

- **admission control** — a bounded, priority-tiered queue whose bound is
  *deadline-derived*: a request whose projected queue wait already
  exceeds its remaining deadline budget is rejected immediately with an
  honest ``shed`` + ``retry_after_ms``, never silently dropped
  (``serve/admission.py``);
- **backpressure & brownout** — when the interactive tier's queue delay
  climbs, the controller sheds bulk sampling traffic *first* and keeps
  head/finality/update goodput high; hysteresis keeps the tier from
  flapping;
- **deadline propagation** — the client's remaining budget rides every
  frame; workers refuse expired work before touching the backing store,
  and handlers check the budget between proof batches;
- **hedged retries** — the client library (``serve/client.py``) hedges a
  slow request onto a second connection after a latency-derived delay,
  takes the first answer, and honors ``retry_after_ms`` after a shed;
- **stampede suppression** — proof-path cache misses for a new block
  collapse onto ONE backing build per (block, blob) via
  ``serve/singleflight.py`` (shared with ``DasServer.serve_samples``);
- **circuit breaker** — consecutive backing-store failures open the
  breaker; clients get honest ``unavailable`` + retry-after while the
  half-open probe tests recovery;
- **chaos & load** — a seeded open-loop load generator
  (diurnal/bursty/adversarial-hotspot arrivals, ``serve/loadgen.py``)
  and a serving chaos mode (worker stalls, cache wipes at block
  boundaries, 10x bursts, slow-loris clients, ``serve/chaos.py``)
  audited through the existing telemetry machinery — overload degrades
  throughput but never correctness: every served proof still verifies,
  every shed request gets an honest rejection.

The **multi-process plane** (PR 16) scales the same tier past the GIL:
immutable ``ServeView`` snapshots publish once into POSIX shared memory
(``serve/shm.py``'s seqlock ``ShmViewBoard``), a supervised
``WorkerPool`` (``serve/workers.py``) runs spawn-context worker
*processes* sharing SO_REUSEPORT listeners with heartbeat / crash /
hang / rss supervision and capped-backoff respawn, cross-process
stampedes collapse onto one build via the board's lease table
(``utils/singleflight.ProcessFlight``), and a health-routed
``Balancer`` (``serve/balancer.py``) spreads a pipelined swarm load
across fronts. ``serve/harness.py``'s ``run_mp_scenario`` runs the
whole plane under seeded process chaos and returns a self-judging
verdict.
"""

from pos_evolution_tpu_torch.serve.admission import (
    AdmissionQueue,
    BrownoutController,
    CircuitBreaker,
    ServiceEstimator,
)
from pos_evolution_tpu_torch.serve.balancer import Balancer, SwarmLoadGenerator
from pos_evolution_tpu_torch.serve.chaos import (
    FdExhaustSwarm,
    ServeChaos,
    SlowLorisSwarm,
)
from pos_evolution_tpu_torch.serve.client import ClientResult, ServeClient
from pos_evolution_tpu_torch.serve.harness import run_mp_scenario
from pos_evolution_tpu_torch.serve.loadgen import (
    LoadGenerator,
    arrival_times,
    discover_targets,
)
from pos_evolution_tpu_torch.serve.protocol import (
    ProtocolError,
    recv_frame,
    send_frame,
)
from pos_evolution_tpu_torch.serve.server import TIER_BULK, TIER_INTERACTIVE, ServeFront
from pos_evolution_tpu_torch.serve.shm import ShmViewBoard
from pos_evolution_tpu_torch.serve.state import ServeView, ServingState
from pos_evolution_tpu_torch.serve.workers import WorkerPool, worker_spec
from pos_evolution_tpu_torch.utils.singleflight import ProcessFlight, SingleFlight

__all__ = [
    "AdmissionQueue",
    "Balancer",
    "BrownoutController",
    "CircuitBreaker",
    "ClientResult",
    "FdExhaustSwarm",
    "LoadGenerator",
    "ProcessFlight",
    "ProtocolError",
    "ServeChaos",
    "ServeClient",
    "ServeFront",
    "ServeView",
    "ServiceEstimator",
    "ServingState",
    "ShmViewBoard",
    "SingleFlight",
    "SlowLorisSwarm",
    "SwarmLoadGenerator",
    "TIER_BULK",
    "TIER_INTERACTIVE",
    "WorkerPool",
    "arrival_times",
    "discover_targets",
    "recv_frame",
    "run_mp_scenario",
    "send_frame",
    "worker_spec",
]
