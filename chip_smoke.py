#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pos_evolution_tpu_torch``) on one GPU.

Phases, in order; any mismatch or exception ends the run non-zero:

1. build every kernel from the sources in this checkout;
2. hold kernel K1 (``csrc/agg_sig.cu``) against its plain PyTorch version
   at the main path's shapes (A=2048 committees of C=512, N=2^20
   validators), and against hashlib FakeBLS on a few committees; honest
   aggregates verify, a flipped word and an empty bitlist do not;
3. cross-check the whole epoch on the card against the CPU at a small size,
   and the shuffle against the spec's per-index swap-or-not;
4. drive the main path once -- ``run_epoch`` on 2^20 validators on cuda --
   with the launch counts zeroed just before and read just after (K6 once
   for the signers' midstates, K1 twice), and hold every output against the
   same epoch with the plain aggregation;
5. time K1, its plain version and the whole epoch with CUDA events after a
   warm-up, and work out K1's bound from this run's inputs;
6. hold kernel K2 (``csrc/merkle_level.cu``) against its plain PyTorch
   version at the slice's largest level (4,194,304 pairs, the validator
   leaves' first level at N=2^20) and at N in {1, 3, 511, 513}, bit for
   bit, and against hashlib on spot rows; a zero-size call launches
   nothing;
7. drive the second slice's path once -- ``run_state_roots`` on 2^20
   validators on cuda: the five registry-scale field roots before (full
   build) and after (incremental) the epoch -- with the launch counts
   zeroed just before and read just after; hold both root sets against the
   same run with the plain versions, the incremental roots against a fresh
   build of the post-epoch state, and three balance chunks and three
   validators against the roots by hashlib branch proofs;
8. cross-check the roots on the card against the CPU at a small size;
9. time K2 (per launch at 4,194,304 and 1,048,576 pairs), its plain
   version, the full build and the incremental update, and the roots
   path's stages, and work out K2's bound from this run's pair counts;
10. drive the third slice's path once -- ``DenseSimulation`` on 2^20
    validators, mainnet config, 90 shuffle rounds, ``run_epochs(4)``, then
    its ``state_digest`` -- with the launch counts zeroed just before and
    read just after: K6 once at setup, K1 twice a slot, K2 in the digest,
    every walk check true, 64 x 128 aggregates verified, finality reached;
    a kernel run of 1 epoch and its ``plain=True`` twin give identical
    metrics, summary and digest (run in a child process during phases
    32-33 and checked there); K1 at the path's shape (A=64, C=512)
    against its plain version;
11. a faulted and adversarial run at 2^20 (drops, delays, a crash window,
    an equivocator controlling 1/16, the default monitors) for 2 epochs,
    and the same run checkpointed after epoch 1 and resumed on the card:
    equal metrics, monitor violations, evidence and digest;
12. the dense driver on the card against the CPU at n = 256 (honest) and
    n = 384 (the faulted composition), in child processes during phases
    32-33 and checked there;
13. time the dense path: seconds per simulated epoch, its phase budget,
    and the device's busy share under ``torch.profiler`` over one epoch;
    K1 at the path's shape against its bound;
14. count the SASS instructions of every kernel (``cuobjdump -sass``), by
    opcode group (and K7's tensor-core wgmma, GMMA, K6's cp.async LDGSTS
    and mbarrier SYNCS), per signer and per pair, and the two bounds they
    give (the census runs in a child process from the end of phase 1,
    beside phases 2-13, on the host's CPU);
15. hold the field kernels K3 (``csrc/fp_modmul.cu``), K4
    (``csrc/fp_addsub.cu``) and K5 (``csrc/alg_mul.cu``) against their
    plain versions at the BLS path's shapes, digit for digit: K3's product
    at [2048], the G1 tree's level [2048, 64] (unbind views read in place),
    the line evaluation [4096, 2, 2], a scalar broadcast over Fq2
    components, and on edge values, at 1 and 4 lanes an element (and at
    4096 x 144, off the path: K5 makes the Fq12 products); K3's ladders (the inversion and
    square-root exponents) over 2048 elements in one launch; every
    registered K4 tape over 4096 lanes (the single ops at [4096, 12, 32]),
    K5 for d = 2, 6, 12 and the sparse line plan at 4096 lanes and for the
    9 Fq2 squarings of a cyclotomic squaring;
16. drive the fourth slice's path once -- ``bls_verify.run`` at 2048
    aggregates over 262,144 signers (BASELINE config 3): setup, signature
    decompression, hash-to-G2, the batched pairing and the swapped-pair
    negative control -- with the launch counts zeroed just before and read
    just after: every aggregate verifies, exactly the swapped pair fails,
    K3-K5 launched and K1, K2 not, each of the 3 inversion chains of a
    verify one K3 ladder launch;
17. hold that path at B = 2: the ``plain=True`` run on the card and the
    CPU run (child processes during phases 32-33, checked there) equal the
    kernel run in the aggregate keys, Miller values, final exponentiation
    and verdicts; 8 aggregates' hashed messages and
    verdicts equal the port's oracle copy; the field launches and other
    aten ops of each verify stage at B = 2;
18. time K3-K5 per launch at the path's shapes against their plain
    versions and bounds: kernel ms by CUDA events over raw launches,
    device ms by the replay of a CUDA graph of them, the wrappers' calls
    (K3 at each of its shapes and ladders, at 1 and 4 lanes an element;
    every K4 tape against the bytes of its rows); the pairing stage under
    ``torch.profiler``;
19. K3's SASS recounted per function and the bound it gives, and the
    SASS census of K4 and K5;
20. hold kernels K6 (``csrc/sha256_blocks.cu``, multi-block SHA-256) and
    K7 (``csrc/gf256_matmul.cu``, the batched GF(2^8) product on the int8
    tensor cores by wgmma) against their plain versions at the sync and DAS path's
    shapes (PeerDAS cells of 2,048 bytes, 33 blocks; 1-block blob streams,
    client digests and signature midstates; a 9-blob extension and regrid),
    K6 against hashlib on spot rows; and at their edge shapes: K6 at the
    crossover of its two designs (one below, at, one above) at 1, 2, 33 and
    65 blocks, on strided rows, and in each design at the path's shapes; K7
    at k in {1, 3, 31, 64, 255, 256} x r in {1, 7, 16, 129} x W in {4, 66,
    2,048}, random, broadcast, all-zero, all-0xFF and identity operands;
21. the sync verify at 2,048 updates of 512 lanes equal to
    ``verify_batch_host`` and to its ``plain=True`` run, rejecting exactly
    the forged, short, empty, misproved and unproved updates; one K6, one
    K1 and 11 K2 launches a batch;
22. the DAS sample verify at 1,152 and 36,864 samples (one block's and one
    epoch's cells) equal to ``verify_samples_host``, rejecting exactly the
    corrupted rows, and its host/card crossover at 8-36,864 samples;
23. the reconstruction of 9 blobs (k = 64) equal to the host's from the
    parity halves and from mixed subsets; a corrupted cell of a whole grid
    flips exactly its blob;
24. drive the slice's dense path once -- ``DenseSimulation`` at 2^20,
    mainnet config with the PeerDAS geometry, 90 shuffle rounds, 4 epochs,
    a DAS rider (9 blobs, 100,000 clients sampling 8 cells) and 100,000
    light clients -- with the launch counts zeroed just before and read
    just after: 9 sidecars built and verified a proposal, no failure or
    miss, every light client on the finalized checkpoint, K1, K2, K6 and
    K7 launched as the path says; the same run without riders; equal to
    its checkpoint-resumed twin; equal to its ``plain=True`` run at 1 slot,
    and the same composition under Goldfish (whose light clients adopt a
    head every slot) to its ``plain=True`` run at 2 slots (the two plain
    twins in child processes during phases 32-33, checked there);
25. time K6 and K7 per launch at the path's shapes (kernel ms by events,
    device ms by the CUDA graph timer, wrapper, plain) against their
    bounds; printed beside them (not in the kernels line): the parent's
    times (``PERF.md``, before their redesign), K6's integer-pipe bound
    from the SASS count of the design the shape takes and the round-chain
    floor of one chain's scheduler, K7's former lookup bound; each K6
    design (the chains, one thread a message in blocks of 32 and of 128)
    either side of the crossover at 33 blocks and below it at 2 and 1;
26. the KZG slice's setup on the card (16,384 powers of tau by one K11
    ladder launch and the affine pass): the ladder's lanes and the affine
    points against their plain versions, its first 256 powers against the
    host ``trusted_setup``; its window tables for K11's bucket route (c =
    13, W = 20; one doubling launch and a batch inversion), timed, the
    doubling launch at 16,384 x 19 windows and the whole tables against the
    plain route's, spot entries against the oracle's 2^(c w) [tau^j]G;
27. hold kernel K10 (``csrc/fr_ntt.cu``: the Fr NTT's passes in shared
    memory and Fr's elementwise ops) and K11's bucket route
    (``csrc/g1_bucket.cu``: recode, scan, scatter; ``g1_fill.cu``,
    ``g1_totals.cu``, ``g1_reduce.cu``) against their plain versions at the commit path's
    shapes -- a PeerDAS commit batch of 9 blobs, (9, 16,384) -- bit for
    bit: to Montgomery form, the INTT and the NTT, the canonical pass; the
    bucket route stage by stage (signed digits, window offsets, bucket
    starts, sorted entries, bucket sums, blob sums) and its affine sums,
    each plain stage timed; K10 at n in 1-1,024 and on the edge values;
    the bucket route on its edge lanes (a zero scalar, r - 1, infinity, P =
    Q and P = -Q in one bucket, at 2 x 200, c = 13 and 5, tables and
    stages) and against the host Pippenger, at the prover's 1 x 16,383;
    K11's ladder (``csrc/g1_msm.cu``) where its callers still run it: the
    edge lanes and the verifier's 10 points, each launched at its shape,
    against one plain ladder over all their lanes;
28. the commit batch's wires against the plain path's, blob 0 against the
    host path (numpy INTT, Pippenger over the setup's powers);
29. a committee's aggregate proof of 16 samples over the 9 blobs: honest
    accepted; a forged cell, a tampered W and a wrong wire rejected, each
    verdict equal to the oracle pairing;
30. drive the slice's path once -- the setup and its tables, then
    ``DenseSimulation`` at 2^20, mainnet config with the PeerDAS geometry,
    90 shuffle rounds, Gasper, 2 epochs, the kzg DAS rider (9 blobs,
    100,000 clients sampling 8 cells) and 100,000 light clients -- with the
    launch counts zeroed just before and read just after: every sidecar
    built verified, no failure or miss, one K11 ladder and one tables
    launch in the set-up, per proposal 2 K10 passes and 2 elementwise
    passes and one of each of the six bucket launches; equal to its
    ``plain=True`` twin at 1 slot, which reads the plain route's tables;
31. time K10 (the INTT at (9, 16,384)) and K11's bucket route (the MSM at
    9 x 16,384, each launch by CUDA events between them), the tables' doublings
    and the setup's ladder against their bounds counted from this run's
    data (kernel ms by events, device ms by the CUDA graph timer, wrapper,
    plain), the ladder's bound on the same scalars printed beside;
32. drive the spec tier once -- ``spec_chain.run_chain`` at 2^20
    validators, mainnet config: genesis, then 33 blocks through
    ``specs/validator.build_block`` and ``state_transition(state, sb,
    True)``, each after the first carrying the previous slot's 64
    attestations of 512 (signed by K1) and a sync aggregate, across the
    first epoch boundary -- with the launch counts zeroed just before and
    read just after: every block accepted, its state root the chain's,
    ``process_epoch`` through the torch backend (its epoch sweep twice:
    the proposer's copy and the chain), K2 under every state root, K1 once
    a slot; per-block ms, the B8 session's counts;
33. the chain's last 9 blocks (25-33, across the epoch boundary: its
    ``process_epoch`` at 2^20 inside ``on_block_batch``) through a fresh
    fork-choice store anchored at block 24 and the state phase 32 kept
    after it (one carried state, B8's resident columns patched block to
    block): the state root equal to phase 32's final root; blocks/s;
34. the twins: the first epoch boundary at 2^20 again from the state
    ``process_epoch`` met, on the card and on the CPU backend, every
    registry and state column and the state root equal; phase 32's final
    root recomputed from scratch through K2 and through its plain version,
    equal; a 4-epoch chain at 2^14 (mainnet config) on the card and on the
    CPU, run in child processes during phases 32-33, the state root equal
    after every block, finality at epoch 2 or later; and the plain twins
    of phases 10, 17 and 24, run beside them. Phase 32's times are taken
    with those children running;
35. drive the spec driver's path once, in a child process of its own
    started before phase 20, beside phases 20-34 (host-bound, its launches
    small) -- ``sim/driver.run_scale``:
    ``Simulation(65,536, accelerated_forkchoice=True, das="merkle")``
    under the mainnet config with the PeerDAS geometry (``sim/driver.
    PEERDAS``: 128 extended cells of 2,048 bytes, 9 blobs a block) for 4
    epochs, 100,000 sampling clients and 8 light clients attached, the
    resident fork-choice store on the card -- with the launch counts
    zeroed just before and read just after: justified >= 3 and finalized
    >= 2, the resident head equal to ``get_head_host`` and the spec walk,
    no resident store degraded, K2 under the state roots, fresh device
    head queries and memo answers adding up to the head queries; 9
    sidecars built and accepted a proposal, none refused; every served
    block verified with all 100,000 clients satisfied; after
    ``flush_light_clients`` every light client on the full node's
    finalized checkpoint root, none rejected; the rider phases' launches
    a call (``RIDER_LAUNCHES``: K1, K2, K6, K7); s per epoch and the
    riders' seconds by phase, the handlers' and the light clients' p50
    and p95, the sample serving's latencies, coalescing and verify ms,
    the best update a fresh head, and a fresh head query's and a
    2,048-vote flush's launches and ms under ``torch.profiler``;
36. the twins, the card against the CPU backend (both run in child
    processes during phases 32-33), equal in every per-slot record, view,
    violation and piece of evidence, no resident store degraded: BASELINE
    config 1 (1,024 validators, 32 slots, every fresh head audited); a
    faulted and adversarial run at 1,024 for 2 epochs (drops, duplicates,
    reorders, a crash-restart by checkpoint sync, an equivocator with
    1/16 of the stake, the default monitors), its checkpoint after epoch
    1 resumed on the card equal to it; Goldfish and SSF at 256; the
    riders at 1,024 under the PeerDAS geometry and a lossy plan (2,000
    samplers, 2 light clients, 4 slots), its checkpoint after slot 2
    resumed on the card equal to it in every record, blob key and served
    block;
37. B9 (``ops/forkchoice.py``'s incremental vote buckets) on the card
    against the CPU at the path's shapes (65,536 rows, 4,096 votes with
    duplicates), timed;
38. the kzg rider on the card, counted, in a child process during phases
    32-33: 1,024 validators, the PeerDAS geometry,
    ``das=BlobEngine(scheme="kzg")``, 16 samplers, 2 slots --
    every sidecar accepted, every served aggregate proof verifying, K10
    and K11 launched a proposal as phase 30 counts them; and its twin,
    the card against the CPU at the minimal geometry (16 validators, 1
    blob), run in child processes during phases 32-33;
39. run supervision (``python -m pos_evolution_tpu_torch.resilient_run``,
    in a child process during phases 32-33): the dense run at 2^20,
    mainnet config, 2 epochs, a checkpoint every 32 slots, SIGKILLed after
    slot 56 and resumed by the supervisor from step 32 (its merkle digest
    re-checked through K2), ending at slot 64 with a final checkpoint; and
    the spec driver at BASELINE config 1 (1,024 validators, mainnet, one
    epoch, a checkpoint every 8 slots, killed after slot 20, resumed from
    step 16) -- each ending on the ``state_digest`` of an uninterrupted
    twin of the same construction run in the same child process (the
    dense twin with the flight recorder armed); the events log holding one
    ``supervisor_interruption``, the checkpoints, ``run_resumed``,
    ``checkpoint_final`` and ``goodput``; every checkpoint digest computed
    by K2 on the card, one launch a tree level, each launch counted, the
    final step's digest equal to K2's plain version on the card; a
    checkpoint's bytes raw and compressed, the loop's blocked ms, the
    writer's ms, its digest's K2 launches and ms, the resume's seconds
    from the kill to the first resumed slot, goodput and the dense twin's
    peak allocated bytes printed;
40. the profiling tooling on the card, in this process right after phase
    34, beside phase 41 (b) (so its times are contended):
    (a) 8 slots of phase 10's dense
    run at 2^20 under ``profiling.ProfiledRegion("dense")`` (and 8 before
    it unprofiled, the profiler's overhead printed): no error, the
    attribution a partition of the trace's device total (0.01 ms a row),
    one ``agg_sig_kernel`` event for each K1 launch, each on a path
    through the dense phase that launched it (``aggregate_verify``) and
    credited to it, not to ``unattributed`` or the region's own name; the
    device ms by range, the attribution and the top table printed; (b)
    ``Simulation(1,024, profile=dir)`` (mainnet) for 8 slots against its
    unprofiled twin: the four artifacts, a device lane in
    ``chrome_trace.json``, one ``merkle_level_kernel`` event for each K2
    launch, the records and the final state root equal; (c) the cost table
    (``profiling/cost``) at 2^20 on the card: no error, every peak
    positive, printed; (d) ``fused_measure`` of one K2 level at 4,194,304
    pairs beside the CUDA-graph timer on the same launch, printed; (e)
    ``compile_cache=`` (a child process during phases 32-33 that runs two
    processes in turn): the first builds into a fresh directory, the
    second builds nothing, as the build ledger counts it.
41. the serving tier on the card: (a) in phase 35's child, once phase 40 and
    (b) have ended (the main process releases it), its run
    publishes a ``ServeView`` a slot (``run_scale(serve=True)``), one
    view a slot; a ``ServeFront`` of 4 threads on the run's merkle scheme
    serves them, replayed as ``serve_demo`` replays them, under the demo's
    two phases cut to 1,000 + 1,000 arrivals at 6,000/s (uniform, then
    hotspot with two 10x bursts, two worker stalls, proof-cache wipes, a
    backing outage and 8 slow-loris connections): every served proof and
    update verified, the launch counts zeroed just before and read just
    after holding K6 once and K2 7 times a scheme build; then 64 seeded
    ``das_cells`` requests of 8 samples at once over 2 blobs of each root of
    the last view, on a front on the card and on one on the plain scheme:
    the replies equal byte for byte, one build a (block, blob) requested; (b) ``python -m
    pos_evolution_tpu_torch.serve_demo --mp --mainnet`` at its defaults
    (a process of its own started after phase 32 once phase 39's supervised
    runs have ended, beside phases 33, 34 and 40; 1% of its requests traced, its events, spans,
    heartbeats and fleet snapshots kept under ``build/serve_mp``): every scheduled arrival
    recorded, proofs verified and zero verify failures in each phase, every
    kill and wedge detected, every live worker on the board's current
    generation, the fleet metrics consistent, K6 and K2 launched in the
    workers (``kernel_launches_total`` off the ``metrics`` RPC, K2 7
    times K6 in the steady phase); (c) in phase 38's child, a kzg front
    answers 4 seeded ``das_aggregate`` requests of 8 samples, each proof
    verifying through ``verify_aggregate`` on the card, K10 and K11
    counted a proof. The SLO and goodput contracts (steady interactive
    p99 <= 50 ms and chaos interactive goodput > 95% for (a); goodput
    >= 99% and p99 <= 300 ms for (b)) are printed, met or missed.
42. the offline tooling over this run's own files, in this process,
    touching no device, within 15 s: (a) ``run_report`` over phase 39's
    supervised runs' events (the kill and the resume named; goodput and
    replayed slots equal to the run's emission; the checkpoint digests'
    K2 launches equal to the run's records); (b) over phase 40 (b)'s events
    log, the top ops found through its ``profile_artifacts`` event (no
    ``--top-ops``), ``merkle_level_kernel`` with the events phase 40 held
    against the launch counter, and phase 40 (c)'s cost table under
    ``cost_analysis``; (c) over phase 41 (b)'s events log: the
    multi-process Serving section equal to (b)'s emission (goodput,
    verified proofs, kills and wedges detected), ``trace_merge
    --expect-pids`` one lane a process, ``obs_top --once`` a heartbeat and
    a fleet row for each worker, and (b)'s goodput printed beside the
    earlier runs' (``PERF.md`` §5);
    (d) ``perf_gate --count-only``: the supervised dense run's counts
    against themselves pass, against a copy with
    ``kernel_launches_total{merkle_level}`` doubled fail; (e) the analysis
    gate of the port on this checkout: ``--strict`` exits 0, ``--doctor``
    1.

Between phase groups it prints the seconds since the start (``lap``).

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and
prints no result. Run from the repository root: ``python3 chip_smoke.py``.
"""

import atexit
import contextlib
import glob
import hashlib
import io
import json
import math
import multiprocessing
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import warnings
import concurrent.futures
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pos_evolution_tpu_torch import bls_verify  # noqa: E402
from pos_evolution_tpu_torch import obs_top, perf_gate, run_report, trace_merge  # noqa: E402
from pos_evolution_tpu_torch.convert import registry_to_torch  # noqa: E402
from pos_evolution_tpu_torch.crypto import bls12_381 as oracle  # noqa: E402
from pos_evolution_tpu_torch.device import (  # noqa: E402
    MASK32,
    checksum_tree,
    words_to_bytes,
    words_to_numpy,
    words_to_rows,
    words_to_torch,
)
from pos_evolution_tpu_torch.epoch import (  # noqa: E402
    N_MAINNET,
    build_epoch_inputs,
    epoch_committees,
    head_passes,
    load_inputs,
    run_epoch,
)
from pos_evolution_tpu_torch.ops import fp, g2prep, kernels, tower  # noqa: E402
from pos_evolution_tpu_torch.ops.aggregation import (  # noqa: E402
    _committee_aggregates,
    aggregate_signatures_batch,
    aggregate_verify_batch,
    committee_aggregates,
    messages_to_words,
    pk_blocks,
    precompute_pk_states,
)
from pos_evolution_tpu_torch.ops import merkle_device  # noqa: E402
from pos_evolution_tpu_torch.ops.epoch import FAR_FUTURE_I64, process_epoch_dense  # noqa: E402
from pos_evolution_tpu_torch.ops.merkle_device import _merkle_level, merkle_level  # noqa: E402
from pos_evolution_tpu_torch.ops.pairing import (  # noqa: E402
    fast_aggregate_verify_batch,
    g2_affine_encode,
)
from pos_evolution_tpu_torch.ops.shuffle import shuffle_permutation  # noqa: E402
from pos_evolution_tpu_torch.ssz import incremental  # noqa: E402
from pos_evolution_tpu_torch.ssz.merkle import (  # noqa: E402
    ZERO_HASHES,
    _depth_for,
    is_valid_merkle_branch,
)
from pos_evolution_tpu_torch.state_roots import (  # noqa: E402
    FIELDS,
    RegistryScaleTrees,
    load_columns,
    registry_state,
    run_state_roots,
    validator_columns,
)
from pos_evolution_tpu_torch.config import mainnet_config  # noqa: E402
from pos_evolution_tpu_torch.resilience import state_digest  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_adversary import DenseEquivocator  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_driver import DenseSimulation  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_monitors import default_dense_monitors  # noqa: E402
from pos_evolution_tpu_torch.sim.faults import DenseCrashWindow, DenseFaultPlan  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_variants import dense_rider_from_config  # noqa: E402
from pos_evolution_tpu_torch.das.engine import BlobEngine  # noqa: E402
from pos_evolution_tpu_torch.das.erasure import extension_matrix  # noqa: E402
from pos_evolution_tpu_torch.das.erasure import gf_matmul as gf_matmul_host  # noqa: E402
from pos_evolution_tpu_torch.ops import das_verify, sync_verify  # noqa: E402
from pos_evolution_tpu_torch.ops.sha256 import (  # noqa: E402
    k6_chains_below, k6_chains_min_blocks, sha256_blocks)
from pos_evolution_tpu_torch.ssz.hash import _pad_messages  # noqa: E402
from pos_evolution_tpu_torch.kzg import aggregate as kzg_aggregate  # noqa: E402
from pos_evolution_tpu_torch.kzg import curve, fr, ntt  # noqa: E402
from pos_evolution_tpu_torch.kzg import setup as kzg_setup  # noqa: E402
from pos_evolution_tpu_torch.kzg.scheme import KzgCellScheme  # noqa: E402
from pos_evolution_tpu_torch.ops import pairing  # noqa: E402
from pos_evolution_tpu_torch import spec_chain  # noqa: E402
from pos_evolution_tpu_torch.backend import use_backend  # noqa: E402
from pos_evolution_tpu_torch.specs.containers import BeaconState  # noqa: E402
from pos_evolution_tpu_torch.ssz import hash_tree_root  # noqa: E402
from pos_evolution_tpu_torch.ops import forkchoice as ofc  # noqa: E402
from pos_evolution_tpu_torch.sim import (  # noqa: E402
    CrashWindow,
    Equivocator,
    FaultPlan,
    Simulation,
    default_monitors,
    faulty_schedule,
    lossy_plan,
)
from pos_evolution_tpu_torch.sim.driver import PEERDAS, run_scale  # noqa: E402
from pos_evolution_tpu_torch.das.commitment import get_scheme  # noqa: E402
from pos_evolution_tpu_torch.serve import (  # noqa: E402
    ServeClient,
    ServeFront,
    ServingState,
)
from pos_evolution_tpu_torch.config import minimal_config, use_config  # noqa: E402
from pos_evolution_tpu_torch.variants import GoldfishVariant, SsfVariant  # noqa: E402
from pos_evolution_tpu_torch.telemetry import FlightRecorder, Telemetry  # noqa: E402
from pos_evolution_tpu_torch.profiling import (  # noqa: E402
    ProfiledRegion,
    attribute_to_spans,
    xplane,
)
from pos_evolution_tpu_torch.profiling.cost import analyze_hot_paths  # noqa: E402
from pos_evolution_tpu_torch.profiling.export import DEVICE_PID  # noqa: E402
from pos_evolution_tpu_torch.utils.benchtime import checksum_tree as bench_checksum  # noqa: E402
from pos_evolution_tpu_torch.utils.benchtime import fused_measure  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): 3.35 TB/s of HBM;
# 67 TFLOP/s fp32 outside the tensor cores = 132 SMs x 128 lanes x 2 flops
# per FMA x 1.98 GHz. An SM issues at most one warp instruction per clock on
# each of its 4 schedulers, 128 32-bit lane operations per clock, so no
# integer work runs faster than 67e12 / 2 lane instructions per second.
HBM_BYTES_PER_S = 3.35e12
PEAK_LANE_OPS_PER_S = 67e12 / 2

# SHA-256 in the fewest sm_90 instructions (3-input LOP3 and IADD3, one
# funnel shift per rotate): a round is Sigma1 (3 SHF + LOP3), Ch (LOP3),
# T1 (2 IADD3), Sigma0 (3 SHF + LOP3), Maj (LOP3), e (IADD), a (IADD3) = 14;
# a schedule word is sigma0 and sigma1 (2 SHF + SHR + LOP3 each) and 2 IADD3
# = 10; the feed-forward is 8 adds.
OPS_COMPRESS_ROUNDS = 64 * 14 + 8
OPS_SCHEDULE = 48 * 10
K1_SOURCE = "pos_evolution_tpu_torch/csrc/agg_sig.cu"
K1_REPLACES = "pos_evolution_tpu/ops/pallas_aggregation.py:47"
FAKEBLS_PREFIX = b"fakebls-sig-pad!"
STAGES = ("registry", "shuffle", "sign", "verify", "head", "sweep")

# K2 per pair: the message compression with its schedule, then the padding
# block's compression from a precomputed schedule (2,288 instructions); two
# 32-byte nodes read, one written.
OPS_K2_PAIR = 2 * OPS_COMPRESS_ROUNDS + OPS_SCHEDULE
BYTES_K2_PAIR = 96
K2_SOURCE = "pos_evolution_tpu_torch/csrc/merkle_level.cu"
K2_REPLACES = "pos_evolution_tpu/ops/pallas_sha256.py:88"
K2_LARGEST = 4_194_304          # the validator leaves' first level at N = 2^20
ROOT_STAGES = ("load", "pre", "epoch", "post")
SMALL = dict(slots=4, committees_per_slot=4, capacity=16, shuffle_rounds=10)

# the dense path: 2^20 validators, mainnet config, 4 epochs; its plain=True
# twin at 1 epoch (against a kernel run of 1 epoch)
DENSE_EPOCHS, DENSE_PLAIN_EPOCHS = 4, 1
DENSE_SMALL = dict(slots_per_epoch=8, max_committees_per_slot=4)
# SM count and boost clock of the H100 SXM; its INT32 pipe has 64 lanes per
# SM, where LOP3 and SHF issue and nowhere else
H100_SMS, H100_CLOCK_HZ, INT32_LANES = 132, 1.98e9, 64
INT_PIPE_LANE_OPS_PER_S = H100_SMS * INT32_LANES * H100_CLOCK_HZ

# the BLS path (BASELINE config 3): 2048 aggregates of 128 lanes, 262,144
# signers; its Miller loop runs the doubled batch of 4096 lanes
BLS_AGGREGATES, BLS_SIGNERS = 2048, 262_144
BLS_LANES = 2 * BLS_AGGREGATES
BLS_SMALL, BLS_ORACLE = 2, 6     # the oracle's 6 + 2 swapped jobs: one a core
FIELD_KERNELS = {   # name -> (source, the JAX function it replaces): the kernels line's rows
    "fp_modmul": ("pos_evolution_tpu_torch/csrc/fp_modmul.cu", "pos_evolution_tpu/ops/fp.py:204"),
    "fp_addsub": ("pos_evolution_tpu_torch/csrc/fp_addsub.cu", "pos_evolution_tpu/ops/fp.py:210"),
    "alg_mul": ("pos_evolution_tpu_torch/csrc/alg_mul.cu", "pos_evolution_tpu/ops/tower.py:129"),
}
# K3's ladders (launch counter fp_pow, on K3's row) replace the jitted scans
K3_LADDER_REPLACES = ("pos_evolution_tpu/ops/fp.py:244", "pos_evolution_tpu/ops/g2prep.py:66")
K3_GROUPS = (1, 4)                   # lanes per element that phases 15 and 18 run
LADDERS = {"modinv": fp._P_MINUS_2_BITS, "sqrt": g2prep._SQRT_FQ_BITS}
FQ_BYTES = 128                       # one element: 32 int32 digits
# 32x32->64-bit partial products of one K3 product: 12 x 12 for a * b, 13 x 13
# for the quotient estimate, 78 for its low product with p; a squaring needs
# 78 for a * a (12 squares, 66 cross products counted once). Hopper issues 64
# 32-bit integer multiplies per SM per clock (the CUDA guide's table, cc 9.0),
# one IMAD.WIDE each at best.
PP_MODMUL = 144 + 169 + 78
PP_MODSQR = 78 + 169 + 78
IMUL_PER_S = H100_SMS * 64 * H100_CLOCK_HZ
# (d, sparse slots) of K5's calls on the path: Fq2, Fq6, Fq12 and the line
ALG_SHAPES = ((2, None), (6, None), (12, None), (12, (0, 1, 2, 3, 8, 9)))
ADDSUB_OPS = ("modadd", "modsub", "modneg", "canon")     # K4's one-step tapes

# the sync and DAS slice: PeerDAS geometry (EIP-7594: 128 extended cells of
# 2,048 bytes, k = 64; EIP-7691: 9 blobs a block), 100,000 sampling clients
# and 100,000 light clients (das/sampler.py's range), sync batches of 2,048
# updates of 512 lanes (K1's epoch shape)
DAS_BLOBS, DAS_K, DAS_CELL, DAS_CLIENTS = 9, 64, 2048, 100_000
DAS_RIDERS = ({"kind": "das", "scheme": "merkle", "n_blobs": DAS_BLOBS,
               "n_clients": DAS_CLIENTS, "samples_per_client": 8, "seed": 0, "verify_every": 1},
              {"kind": "lightclient", "n_clients": DAS_CLIENTS, "seed": 0})
RIDER_EPOCHS = 4              # Gasper finalizes epoch 2 at the boundary into epoch 4
# the plain=True rider twins' variants and depths (plain K6 at 33 blocks is slow); Goldfish
# confirms every slot, so its light clients adopt heads at once
RIDER_PLAIN_RUNS = (("gasper", 1), ("goldfish", 2))
SYNC_B, SYNC_S, SYNC_FIN_DEPTH, SYNC_SC_DEPTH = 2048, 512, 6, 5
BACKFILL_BLOCKS = 32          # one epoch's blocks: 32 x 9 x 128 = 36,864 samples
SAMPLE_SIZES = (8, 64, 128, 256, 512, 1152, 36_864)
K6_SOURCE = "pos_evolution_tpu_torch/csrc/sha256_blocks.cu"
K6_REPLACES = "pos_evolution_tpu/ops/sha256.py:95"
K7_SOURCE = "pos_evolution_tpu_torch/csrc/gf256_matmul.cu"
K7_REPLACES = "pos_evolution_tpu/ops/das_verify.py:147"
# K6's shapes on the path, (messages, bytes each; None: one unpadded block,
# a signature midstate): the cell leaves of a
# proposal's commitments, the blobs' counter streams, the sampling clients'
# digests, a backfilled epoch's samples, the sync batch's lanes
K6_SHAPES = {"cell leaves": (DAS_BLOBS * 2 * DAS_K, DAS_CELL),
             "blob streams": (DAS_BLOBS * 4096, 52),
             "client digests": (DAS_CLIENTS, 49),
             "backfill samples": (BACKFILL_BLOCKS * DAS_BLOBS * 2 * DAS_K, DAS_CELL),
             "sync lanes": (SYNC_B * SYNC_S, None)}
K6_MAIN = "cell leaves"
# K7's shapes on the path, (groups of A, groups, rows, k, width): a
# proposal's extension (one matrix for every blob) and its verifier's regrid
K7_SHAPES = {"extension": (1, DAS_BLOBS, DAS_K, DAS_K, DAS_CELL),
             "regrid": (DAS_BLOBS, DAS_BLOBS, 2 * DAS_K, DAS_K, DAS_CELL)}
K7_MAIN = "regrid"
# 32 four-byte shared-memory loads per SM per clock on the H100 (the bound of
# K7's former log/exp lookup design, printed for continuity)
SHARED_LOOKUPS_PER_S = H100_SMS * 32 * H100_CLOCK_HZ
# the H100 SXM's dense int8 tensor-core peak (NVIDIA data sheet, 700 W)
INT8_TENSOR_OPS_PER_S = 1979e12
# one chain of K6's warp-specialized design runs on one scheduler, whose
# integer pipe has 16 lanes (a warp instruction every 2 clocks); a round of
# sha256_blocks.cu::round_kw issues 11 instructions there (6 SHF, 4 LOP3, 1 IADD3)
CHAIN_ROUND_INT_OPS, INT_PIPE_CLOCKS_PER_WARP_OP = 11, 2
# K6 and K7 device ms of their first designs (the ranges PERF.md records on an
# NVIDIA H100 80GB HBM3 at 700.00 W), printed beside this run's
K6_PARENT_MS = {"cell leaves": (0.0589, 0.0595), "blob streams": (0.0070, 0.0076),
                "client digests": (0.0112, 0.0121), "backfill samples": (0.1552, 0.1578),
                "sync lanes": (0.0919, 0.0932)}
K7_PARENT_MS = {"extension": (0.0526, 0.0535), "regrid": (0.0725, 0.0749)}
# K6's edge shapes: block counts at the crossover; K7's: inner sizes, rows, widths
K6_EDGE_BLOCKS = (1, 2, 33, 65)
K7_EDGE_K, K7_EDGE_R, K7_EDGE_W = (1, 3, 31, 64, 255, 256), (1, 7, 16, 129), (4, 66, 2048)
K7_EDGE_KINDS = ("random", "broadcast", "zeros", "ones", "identity")
# K6's designs by the measuring entry point's `threads` (0: the chains; one
# thread a message in blocks of 32 or 128), and the (messages, blocks) at
# which each is timed (the crossover's neighbours are added at 33 blocks)
K6_DESIGNS = {"chains": 0, "one thread, 32": 32, "one thread, 128": 128}
K6_SWEEP = {33: (1152, 4608, 9216, 36_864), 2: (1152,), 1: (1152, 4608)}

# the KZG slice: the PeerDAS domain of the kzg scheme (128 cells x 2,048 bytes in
# 16-byte chunks: N = 128 x 128 = 16,384), 9 blobs a commit batch, a committee's
# 16 samples a proof; the rider run (Gasper, the kzg DAS rider and 100,000 light
# clients) and the setup's powers checked against the host trusted_setup
KZG_N, KZG_SAMPLES, KZG_RIDER_EPOCHS, KZG_HOST_POWERS = 16_384, 16, 2, 256
KZG_RIDERS = ({"kind": "das", "scheme": "kzg", "n_blobs": DAS_BLOBS,
               "n_clients": DAS_CLIENTS, "samples_per_client": 8, "seed": 0, "verify_every": 1},
              {"kind": "lightclient", "n_clients": DAS_CLIENTS, "seed": 0})
KZG_FR_BYTES = 88                    # one Fr element: 22 int32 digits
# one REDC's 32x32-bit partial products: the 8x8 product, the 9x9 low product
# of m (45) and the 9x8 product m * r (72)
KZG_PP_REDC = 64 + 45 + 72
K10_SOURCE = "pos_evolution_tpu_torch/csrc/fr_ntt.cu"
K10_REPLACES = "pos_evolution_tpu/kzg/ntt.py:143"
K11_SOURCE = "pos_evolution_tpu_torch/csrc/g1_msm.cu"
K11_REPLACES = "pos_evolution_tpu/ops/pairing.py:386"
# K11's bucket route over the setup's window tables: the tables'
# doublings once a setup, six launches an MSM
K11B_SOURCE = "pos_evolution_tpu_torch/csrc/g1_bucket.cu"
K11B_SOURCES = {"g1_bucket_fill": "pos_evolution_tpu_torch/csrc/g1_fill.cu",
                "g1_bucket_totals": "pos_evolution_tpu_torch/csrc/g1_totals.cu",
                "g1_bucket_reduce": "pos_evolution_tpu_torch/csrc/g1_reduce.cu"}
K11B_STAGES = ("g1_bucket_recode", "g1_bucket_scan", "g1_bucket_scatter", "g1_bucket_fill",
               "g1_bucket_totals", "g1_bucket_reduce")
# each launch's CUDA kernel function, as torch.profiler names it
K11B_FUNCS = {"g1_bucket_tables": "g1_tables_kernel", "g1_bucket_recode": "g1_recode_kernel",
              "g1_bucket_scan": "g1_scan_kernel", "g1_bucket_scatter": "g1_scatter_kernel",
              "g1_bucket_fill": "g1_fill_kernel", "g1_bucket_totals": "g1_totals_kernel",
              "g1_bucket_reduce": "g1_reduce_kernel"}

# the spec tier: 33 blocks at 2^20 cross the first epoch boundary (slot 32);
# the twins' chain of 4 epochs at 2^14 (Gasper finalizes epoch 2 at the
# boundary into epoch 4)
SPEC_SLOTS, SPEC_TWIN_N, SPEC_TWIN_EPOCHS = 33, 1 << 14, 4
# phase 33 replays the chain's last 9 blocks (all 33 until the spec driver's phases
# needed the time) from the state after block 24, across the epoch boundary, to
# phase 32's final root
SPEC_REPLAY_BLOCKS = 9
SPEC_REPLAY_FROM = SPEC_SLOTS - SPEC_REPLAY_BLOCKS
# the spec driver: Simulation(65,536, accelerated_forkchoice=True) under the mainnet
# config for 4 epochs (scripts/scale_demo.py's run); its twins at BASELINE config 1's
# 1,024 validators and the variants at 256; B9 at the path's table and a slot pair's votes
DRIVER_N, DRIVER_EPOCHS, DRIVER_TWIN_N, DRIVER_VARIANT_N = 65_536, 4, 1024, 256
B9_ROWS, B9_VOTES = 65_536, 4096
DRIVER_TWINS = ("chaos", "config1", "goldfish", "ssf", "riders")
# the spec driver's riders (phase 35; scripts/das_demo.py's): das="merkle" under the
# PeerDAS geometry, 100,000 samplers of 8 samples over a window of 2 blocks, 8 light
# clients flushed at the end
DRIVER_DAS_CLIENTS, DRIVER_LIGHT_CLIENTS = 100_000, 8
# phase 35's launches a call of each rider phase (sim/driver.RiderMeter), by kernel:
# a proposal's build (K6 for the counter streams and the cell leaves, K7 the
# extension, K2 the 7 tree levels), one sidecar's ingest (its commitment and its
# reconstruction), one light client's update (a batch of 1: K6 the committee's
# midstates, K1, K2 the 6 + 5 branch levels)
RIDER_LAUNCHES = {"blob_build": {"sha256_blocks": 2, "gf256_matmul": 1, "merkle_level": 7},
                  "sidecar_ingest": {"sha256_blocks": 1, "gf256_matmul": 1, "merkle_level": 7},
                  "lc_update": {"sha256_blocks": 1, "agg_sig": 1, "merkle_level": 11}}
# phase 36's rider twin at DRIVER_TWIN_N: the PeerDAS geometry under a lossy plan,
# RIDER_TWIN_CLIENTS samplers and RIDER_TWIN_LCS light clients for RIDER_TWIN_SLOTS slots,
# the checkpoint after RIDER_TWIN_CKPT resumed on the card
# (a slot of it costs ~10 s on the CPU backend, the plain SHA-256 over 9 x 128 cells of
# 2,048 bytes: the depth is cut from 2 epochs to 8 slots to fit beside phases 32-34, and
# to 4 slots to make room for phase 41)
RIDER_TWIN_CLIENTS, RIDER_TWIN_LCS, RIDER_TWIN_SLOTS, RIDER_TWIN_CKPT = 2000, 2, 4, 2
# phase 38: the kzg rider on the card (1,024 validators, the PeerDAS geometry, 16
# samplers), and its twin, card against CPU, at the minimal geometry (16 validators, 1 blob)
# through slot 1 (one proposal and one aggregate proof: a pairing check on the CPU
# backend's plain field arithmetic takes ~30 s)
# (4 slots cut to 2, and run in a child process beside phases 32-33, to keep the smoke
# inside its budget: a served kzg block is ~6 s of host work)
KZG_DRIVER_N, KZG_DRIVER_SLOTS, KZG_DRIVER_CLIENTS = 1024, 2, 16
KZG_TWIN_N, KZG_TWIN_SLOTS = 16, 1
KZG_PROPOSAL_LAUNCHES = {"fr_ntt": 2, "fr_ew": 2, **{f"g1_bucket_{s}": 1 for s in (
    "recode", "scan", "scatter", "fill", "totals", "reduce")}}
# phase 39: supervised runs killed once and resumed (resilient_run): the dense run at
# 2^20 (mainnet, 2 epochs, a checkpoint every 32 slots, killed after slot 56: step 32's
# write is asynchronous, and a kill 8 slots after it (about a second on the card) once
# landed, on a loaded host, before the write was durable) and the
# spec driver at BASELINE config 1 (1,024 validators, mainnet, 1 epoch, every 8, killed
# after slot 20); each against its uninterrupted twin
RESIL = {"dense": {"n": N_MAINNET, "epochs": 2, "every": 32, "crash": 56, "resumed": 32,
                   "final": 64},
         "spec": {"n": 1024, "epochs": 1, "every": 8, "crash": 20, "resumed": 16,
                  "final": 33}}
# phase 40: the profiling tooling on the card (after phase 34, beside the end of phase
# 35's run): a profiled region over PROFILE_SLOTS
# slots of phase 10's dense run at 2^20 (and as many unprofiled before it), the spec
# driver's profile= over PROFILE_SLOTS slots at BASELINE config 1's 1,024 validators
# (mainnet) against its unprofiled twin, the cost table at 2^20, fused_measure of one
# K2 level at K2_LARGEST pairs, and compile_cache= in two child processes (1,024
# validators, 2 slots each) during phases 32-33
PROFILE_SLOTS, PROFILE_SPEC_N = 8, 1024
# phase 40 (b)'s events log and (c)'s cost table, for phase 42's report
TOOLING_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "tooling")
PROFILE_EVENTS = os.path.join(TOOLING_DIR, "profile_spec", "events.jsonl")
COST_TABLE = os.path.join(TOOLING_DIR, "cost.json")
PROFILE_ARTIFACTS = ["chrome_trace.json", "flame.txt", "flame_device.txt", "top_ops.json"]
COMPILE_CACHE_CHILD = '''
import json, sys
from pos_evolution_tpu_torch.config import mainnet_config, use_config
from pos_evolution_tpu_torch.ops import kernels
from pos_evolution_tpu_torch.profiling import CompileLedger
from pos_evolution_tpu_torch.sim.driver import Simulation
from pos_evolution_tpu_torch.telemetry import MetricsRegistry, torchrt
ledger = CompileLedger()
torchrt.install(MetricsRegistry())
torchrt.attach_ledger(ledger)
with use_config(mainnet_config()):
    sim = Simulation(int(sys.argv[2]), compile_cache=sys.argv[1], device="cuda")
    sim.run_until_slot(2)
print(json.dumps({"builds": ledger.rows(), "build_dir": str(kernels.BUILD_DIR),
                  "launches": {k: v for k, v in kernels.launches.items() if v},
                  "metrics": sim.metrics}))
'''
# phase 41: the serving tier on the card. (a) In phase 35's child, after its 4 epochs
# (run_scale(serve=True)): a ServeFront of SERVE_THREADS threads on the run's merkle
# scheme serves the run's views (one a slot), replayed as the serving demo replays them,
# under the demo's two phases (uniform, then hotspot with two 10x bursts, two worker
# stalls, a backing outage and 8 slow-loris connections) cut from 100,000 arrivals to
# SERVE_ARRIVALS at SERVE_RATE/s to fit phase 35's wait (the host served ~230 requests/s
# there: 30,000 arrivals took 130 s in a probe, 4,000 26 s); then SERVE_CHECKS seeded
# das_cells requests of SERVE_CHECK_SAMPLES samples at once over 2 blobs of each root of
# the last view, on the card and on the plain scheme. (b) The serving demo's multi-process plane at its --mp
# defaults under the PeerDAS config (steady 60,000 at 20,000/s, chaos 30,000 at
# 10,000/s with 2 kills, 1 wedge and 32 held fds; 2 fronts x 2 worker processes), a
# process of its own started after phase 32 once phase 39's supervised runs have
# ended, beside phases 33, 34 and 40 (beside phases 26-31 it shared the host with their plain versions;
# beside phases 32-33 it slowed phase 39's supervised dense run until the kill landed
# before step 32 was durable).
# (c) In phase 38's child, a kzg front answers
# SERVE_AGG_REQUESTS das_aggregate requests of SERVE_AGG_SAMPLES samples.
SERVE_ARRIVALS, SERVE_RATE, SERVE_THREADS, SERVE_SLO_MS = 2_000, 6000.0, 4, 50.0
# (a) waits in phase 35's child until this file exists: the main process writes it
# once phase 40 and (b) have ended, so that (a)'s front runs on a quiet host (beside
# phase 40 and (b), its load once shed every bulk request on the card's host)
SERVE_FRONT_GO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                              "serve_front.go")
# (b)'s files (phase 42 reads them) and the share of its requests traced
SERVE_MP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "serve_mp")
SERVE_TRACE_RATE = 0.01
SERVE_CHECKS, SERVE_CHECK_SAMPLES = 64, 8
SERVE_AGG_REQUESTS, SERVE_AGG_SAMPLES = 4, 8
# a merkle proof build of one blob's 128 cells: K6 the leaves, K2 the 7 tree levels
SERVE_BUILD_LAUNCHES = {"sha256_blocks": 1, "merkle_level": 7}
# a kzg das_aggregate proof: K11's bucket route for W and W' (6 launches each); the
# two points' affine normalization (K3's ladder and products, K4); no K10, the grids'
# commitments held by the scheme's memo since their proposals
SERVE_PROOF_LAUNCHES = {**{f"g1_bucket_{s}": 2 for s in (
    "recode", "scan", "scatter", "fill", "totals", "reduce")},
    "fp_pow": 2, "fp_modmul": 8, "fp_addsub": 6}
SPEC_STATE_COLUMNS = ("balances", "previous_epoch_participation",
                      "current_epoch_participation", "inactivity_scores")
SPEC_REGISTRY_COLUMNS = ("pubkeys", "withdrawal_credentials", "effective_balance", "slashed",
                         "activation_eligibility_epoch", "activation_epoch", "exit_epoch",
                         "withdrawable_epoch")


_T_START = time.perf_counter()


def lap(label: str) -> None:
    """Print the seconds since this module's imports, after ``label``."""
    say(f"lap: {label} at {time.perf_counter() - _T_START:.3f} s")


def say(*parts):
    print(*parts, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fakebls_aggregate(pubkeys, members, bits, msg: bytes) -> bytes:
    """XOR of hashlib FakeBLS signatures (prefix | pubkey | msg, then two
    chain hashes) over the set-bit members."""
    acc = np.zeros(96, np.uint8)
    for v, b in zip(members, bits):
        if b:
            h1 = hashlib.sha256(FAKEBLS_PREFIX + pubkeys[v].tobytes() + msg).digest()
            h2 = hashlib.sha256(h1).digest()
            h3 = hashlib.sha256(h2).digest()
            acc ^= np.frombuffer(h1 + h2 + h3, np.uint8)
    return acc.tobytes()


def spec_shuffled_index(index: int, n: int, seed: bytes, rounds: int) -> int:
    """The spec's scalar swap-or-not shuffle, written out with hashlib."""
    for r in range(rounds):
        h = hashlib.sha256(seed + bytes([r])).digest()
        pivot = int.from_bytes(h[:8], "little") % n
        flip = (pivot + n - index) % n
        position = max(index, flip)
        source = hashlib.sha256(seed + bytes([r])
                                + (position // 256).to_bytes(4, "little")).digest()
        if (source[(position % 256) // 8] >> (position % 8)) % 2:
            index = flip
    return index


def stage_ms(inputs, dev) -> list:
    """ms of each of ``STAGES``: ``run_epoch``'s stages called one by one,
    with a CUDA event recorded after each."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(STAGES) + 1)]
    ev[0].record()
    t = load_inputs(inputs, dev)
    ev[1].record()
    committees = epoch_committees(inputs, dev)
    ev[2].record()
    aggs = aggregate_signatures_batch(t.pk_states, committees, t.bits, t.msg_words)
    ev[3].record()
    aggregate_verify_batch(t.pk_states, committees, t.bits, t.msg_words, aggs)
    ev[4].record()
    head_passes(t.store, inputs)
    ev[5].record()
    process_epoch_dense(t.registry, *inputs.sweep_args, inputs.cfg)
    ev[6].record()
    torch.cuda.synchronize()
    return [x.elapsed_time(y) for x, y in zip(ev, ev[1:])]


def mismatches(a, b, path="out"):
    """Names of the tensor leaves of two output trees that differ."""
    if isinstance(a, torch.Tensor):
        same = a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
        return [] if same else [path]
    names = getattr(a, "_fields", range(len(a)))
    return [m for name, x, y in zip(names, a, b) for m in mismatches(x, y, f"{path}.{name}")]


def k1_bound(bits: torch.Tensor, a: int) -> dict:
    """Least time for K1's work on this run's inputs: the set-bit signers'
    midstate rows (32 B), committee indices (4 B) and bits (1 B) per lane,
    messages and the output once; 3 compressions per set-bit signer
    (the first from a schedule built once per committee) plus masking and
    folding 24 words."""
    n_set = int(bits.sum())
    lanes = bits.numel()
    nbytes = n_set * 32 + lanes * 5 + a * 32 + a * 96
    ops = n_set * (3 * OPS_COMPRESS_ROUNDS + 2 * OPS_SCHEDULE + 48) + a * OPS_SCHEDULE
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_LANE_OPS_PER_S * 1e3
    return {"set_bits": n_set, "ops": ops, "bytes": nbytes, "ms": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes"}


def k2_bound(pairs: int) -> dict:
    """Least time for K2's work on ``pairs`` sibling pairs."""
    t_ops = pairs * OPS_K2_PAIR / PEAK_LANE_OPS_PER_S * 1e3
    t_bytes = pairs * BYTES_K2_PAIR / HBM_BYTES_PER_S * 1e3
    return {"ms": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes"}


def rand_words(rng, rows: int, dev) -> torch.Tensor:
    return words_to_torch(rng.integers(0, 2**32, (rows, 8), dtype=np.uint64)
                          .astype(np.uint32), dev)


def row_bytes(t: torch.Tensor) -> bytes:
    return words_to_bytes(words_to_numpy(t))


def sha(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def validator_root(pubkey: bytes, credentials: bytes, fields) -> bytes:
    """hash_tree_root(Validator) with hashlib: pubkey (two chunks, hashed),
    credentials, then effective balance, slashed and the four epochs, each
    a little-endian uint64 (the bool one byte) in its own chunk."""
    eff, slashed, *epochs = fields
    leaves = [sha(pubkey[:32], pubkey[32:] + bytes(16)), credentials,
              int(eff).to_bytes(8, "little") + bytes(24), bytes([int(slashed)]) + bytes(31)]
    leaves += [int(e).to_bytes(8, "little") + bytes(24) for e in epochs]
    while len(leaves) > 1:
        leaves = [sha(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    return leaves[0]


def tree_branch(tree, index: int) -> list:
    """Branch of leaf ``index`` of a ``ChunkTree``: siblings from its
    occupied levels on the card (zero-subtree roots past a level's end),
    then the zero-subtree roots up to its limit's depth."""
    branch = []
    for d, layer in enumerate(tree.levels[:-1]):
        sib = (index >> d) ^ 1
        branch.append(row_bytes(layer[sib]) if sib < layer.shape[0] else ZERO_HASHES[d])
    depth = _depth_for(tree.limit)
    return branch + ZERO_HASHES[len(tree.levels) - 1:depth]


def root_stage_ms(inputs, dev) -> list:
    """ms of each of ``ROOT_STAGES``: ``run_state_roots``'s stages called
    one by one, with a CUDA event recorded after each."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(ROOT_STAGES) + 1)]
    ev[0].record()
    cols = load_columns(inputs, dev)
    pre_state = registry_state(registry_to_torch(inputs.registry, dev), cols)
    ev[1].record()
    trees = RegistryScaleTrees(inputs.cfg)
    trees.roots(pre_state)
    ev[2].record()
    out = run_epoch(inputs, dev)
    ev[3].record()
    trees.roots(registry_state(out.result.registry, cols))
    ev[4].record()
    torch.cuda.synchronize()
    return [x.elapsed_time(y) for x, y in zip(ev, ev[1:])]


def kernel_func(name: str) -> str:
    """The CUDA function a kernel name launches, as torch.profiler names it."""
    return {"fr_ntt": "fr_ntt_pass_kernel", **K11B_FUNCS}.get(name, f"{name}_kernel")


def launch_event_ms(prepare, launches: dict, reps: int) -> dict:
    """Device ms of each launch of a pipeline: ``prepare()``, then the
    launches in order on the current stream with a CUDA event recorded
    before the first and after each, ``reps`` times after a warm-up; each
    launch's ms the mean gap between its two events."""
    names = list(launches)
    total = dict.fromkeys(names, 0.0)
    for rep in range(reps + 1):
        prepare()
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        evs[0].record()
        for name, ev in zip(names, evs[1:]):
            kernels.launch_on(torch.device("cuda", torch.cuda.current_device()), name,
                              *launches[name])
            ev.record()
        evs[-1].synchronize()
        if rep:
            for name, a, b in zip(names, evs, evs[1:]):
                total[name] += a.elapsed_time(b)
    return {name: ms / reps for name, ms in total.items()}


def profiled(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall ms (host clock,
    ending in a synchronize), the device's busy ms (kernel and copy time
    summed; the ranges the drivers open while a profiler records are left
    out) and
    each kernel's share of that (``k1_ms``, ``k2_ms``, ``kernel_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    per = {name: 0.0 for name in kernels.KERNELS}
    for e in prof.key_averages():
        # kernels and copies: host ops would count twice, and a host range's
        # projection onto the stream (a user annotation) envelops its kernels
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            busy += e.self_device_time_total
            for name in per:
                if kernel_func(name) in e.key:
                    per[name] += e.self_device_time_total
    return {"wall_ms": wall, "busy_ms": busy / 1e3, "k1_ms": per["agg_sig"] / 1e3,
            "k2_ms": per["merkle_level"] / 1e3,
            "kernel_ms": {name: us / 1e3 for name, us in per.items()}}


def device_ms(fn, reps: int = 20):
    """Mean device ms per call of ``fn`` with the host's launch rate taken
    out: ``reps`` calls captured in a CUDA graph, the graph replayed once as
    a warm-up, then once between two CUDA events. ``fn`` launches on the
    current stream (``kernels.launch_on``). None where the capture fails."""
    try:
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    except RuntimeError as exc:
        say(f"device_ms: the CUDA graph capture failed ({exc}); not measured")
        torch.cuda.synchronize()
        return None


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def sync_count(fn) -> int:
    """Host syncs of one call of ``fn``, counted by CUDA's sync debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def roots_work(trees, state) -> tuple:
    """(ms, K2 launches, pairs) of one ``trees.roots(state)``."""
    merkle_device.reset_stats()
    before = kernels.launches["merkle_level"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    trees.roots(state)
    end.record()
    end.synchronize()
    return (start.elapsed_time(end), kernels.launches["merkle_level"] - before,
            merkle_device.stats()["pairs"])


def dense_sim(dev, n: int = N_MAINNET, **kw) -> DenseSimulation:
    """The dense path's run: mainnet config and its 90 shuffle rounds, or
    the tests' small config below 2^20."""
    cfg = mainnet_config() if n == N_MAINNET else mainnet_config().replace(**DENSE_SMALL)
    kw.setdefault("shuffle_rounds", cfg.shuffle_round_count if n == N_MAINNET else 6)
    return DenseSimulation(n, cfg, device=dev, **kw)


def chaos_sim(dev, n: int, seed: int = 21) -> DenseSimulation:
    """The faulted and adversarial composition of the CPU tests, its crash
    window and the equivocator's share scaled to ``n``."""
    plan = DenseFaultPlan(seed=seed, drop_p=0.1, delay_p=0.08, gst_slot=10,
                          crashes=(DenseCrashWindow(n * 300 // 384, n * 340 // 384, 3, 9),))
    return dense_sim(dev, n, seed=seed, check_walk_every=0, fault_plan=plan,
                     adversaries=[DenseEquivocator(controlled=range(n * 24 // 384), seed=2)],
                     monitors=default_dense_monitors(parity_every=4))


def dense_twin() -> dict:
    """Phase 10's plain twin (a child process during phases 32-33): a
    kernel run and a ``plain=True`` run of ``DENSE_PLAIN_EPOCHS``; whether
    their records agree and the plain run's seconds."""
    dev = torch.device("cuda", 0)
    short = run_record(dense_sim(dev), DENSE_PLAIN_EPOCHS)
    t0 = time.perf_counter()
    ref = run_record(dense_sim(dev, plain=True), DENSE_PLAIN_EPOCHS)
    return {"equal": ref == short, "plain_s": time.perf_counter() - t0}


# phase 12's small dense runs: (make, n, epochs, keywords) by label
SMALL_DENSE = {"honest": ("dense_sim", 256, 4, {"seed": 11, "check_walk_every": 8}),
               "chaos": ("chaos_sim", 384, 3, {})}


def small_dense_twin(label: str) -> dict:
    """Phase 12's ``label`` run on the CPU and on the card (a child
    process): the keys of ``run_record`` where the two differ."""
    t0 = time.perf_counter()
    make, n, epochs, kw = SMALL_DENSE[label]
    make = globals()[make]
    a_cpu = run_record(make("cpu", n, **kw), epochs)
    a_dev = run_record(make("cuda", n, **kw), epochs)
    return {"label": label, "n": n, "epochs": epochs, "s": time.perf_counter() - t0,
            "bad": [k for k in a_cpu if a_cpu[k] != a_dev[k]]}


def run_record(sim, epochs: int) -> dict:
    """Run ``sim`` to ``epochs`` and what two runs must agree on."""
    sim.run_epochs(epochs)
    summary = sim.summary()
    summary.pop("dense_phases", None)
    return {"metrics": sim.metrics, "summary": summary,
            "violations": [(v["monitor"], v["kind"], v["slot"]) for v in sim.monitor_violations],
            "implicated": [np.flatnonzero(m.implicated).tolist() for m in sim.monitors
                           if hasattr(m, "implicated")],
            "digest": state_digest(sim)}


def kernel_key(mangled: str) -> str:
    """A kernel function's key from its mangled name: the last name of the
    nested name without ``_kernel``, and ``_g<G>`` for a template argument
    G (``fp_pow_g4``); the name itself where it is not mangled."""
    import re
    nested = mangled.startswith("_ZN")
    if not nested and not mangled.startswith("_Z"):
        return mangled
    rest, last = mangled[3 if nested else 2:], mangled
    while rest[:1].isdigit() and (nested or last is mangled):
        digits = re.match(r"\d+", rest).group()
        end = len(digits) + int(digits)
        last, rest = rest[len(digits):end], rest[end:]
    template = re.match(r"ILi(\d+)EE", rest)
    last = last.replace("_kernel_", "_").removesuffix("_kernel")     # K6's *_kernel_chains
    return last + (f"_g{template.group(1)}" if template else "")


def sass_census() -> dict:
    """Each kernel function's SASS from its built library (``cuobjdump
    -sass``), by opcode group: {kernel: {"body": {...}, "total": {...}}},
    K3's functions as ``fp_modmul_g<G>`` and ``fp_pow_g<G>`` (G lanes an
    element). K1's body is what follows the block's barrier (every signer
    runs it; before it, warp 0 builds the schedule once per block); the
    others' the whole function. None when cuobjdump is absent."""
    import re
    import shutil
    from pathlib import Path
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    line_re = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
    groups = ("LOP3", "SHF", "IADD3", "IMAD")

    def census(seq):
        c = {g: 0 for g in (*groups, "other")}
        for op in seq:
            base = op.split(".")[0]
            c[base if base in groups else "other"] += 1
        c["all"] = len(seq)
        c["IMAD_WIDE"] = sum(op.startswith("IMAD.WIDE") for op in seq)   # within IMAD
        # within other: the tensor cores' IMMA (mma.sync) and GMMA (wgmma: IGMMA for
        # int8), cp.async's LDGSTS, the mbarriers' SYNCS
        for unit in ("IMMA", "LDGSTS", "SYNCS"):
            c[unit] = sum(op.split(".")[0] == unit for op in seq)
        c["GMMA"] = sum(op.split(".")[0].endswith("GMMA") for op in seq)
        return c

    out = {}
    for name in dict.fromkeys(kernels.KERNELS[k][0] for k in kernels.KERNELS):
        lib = next(k for k in kernels.KERNELS if kernels.KERNELS[k][0] == name)
        text = subprocess.run([tool, "-sass", str(kernels._library_path(lib))],
                              capture_output=True, text=True, timeout=120, check=True).stdout
        parts = re.split(r"Function : (\S+)", text)
        for mangled, body_text in zip(parts[1::2], parts[2::2]):
            key = kernel_key(mangled)
            ops = line_re.findall(body_text)
            body = ops
            if key == "agg_sig":
                cut = next(i for i, op in enumerate(ops) if op.startswith("BAR"))
                body = ops[cut + 1:]
            out[key] = {"body": census(body), "total": census(ops)}
    return out


def sass_bounds(census: dict, units: int) -> dict:
    """Least ms for ``units`` signers or pairs at ``census`` instructions
    each: the issue bound (every instruction at 128 lanes per SM per
    clock), the integer-pipe bound (LOP3 and SHF at 64), and that bound
    with IADD3 on the integer pipe too."""
    issue = units * census["all"] / PEAK_LANE_OPS_PER_S * 1e3
    int_only = units * (census["LOP3"] + census["SHF"]) / INT_PIPE_LANE_OPS_PER_S * 1e3
    int_iadd = units * (census["LOP3"] + census["SHF"] + census["IADD3"]) \
        / INT_PIPE_LANE_OPS_PER_S * 1e3
    imul = units * census["IMAD"] / IMUL_PER_S * 1e3
    return {"issue_ms": issue, "int_pipe_ms": int_only, "int_pipe_with_iadd3_ms": int_iadd,
            "imad_ms": imul}


def field_digits(rng, shape, edges: bool = True) -> torch.Tensor:
    """Canonical int32 digits [*shape, 32] of seeded values in [0, 2p)
    (the top digit drawn below 2p's), the edge values 0, 1, p-1, p, 2p-1
    in the first rows."""
    d = rng.integers(0, 1 << fp.BITS, (*shape, fp.L), dtype=np.int32)
    d[..., -1] = rng.integers(0, int(fp.TWO_P[-1]), shape, dtype=np.int32)
    if edges:
        flat = d.reshape(-1, fp.L)
        for i, v in enumerate((0, 1, fp.P_INT - 1, fp.P_INT, 2 * fp.P_INT - 1)[:len(flat)]):
            flat[i] = fp.to_limbs(v)
    return torch.from_numpy(d)


def digit_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def distinct_rows(*ts) -> int:
    """Rows of 32 digits that the views ``ts`` address between them, each
    counted once: a broadcast row, or a row two operands share, is read once."""
    addrs = []
    for t in ts:
        off = np.zeros((), np.int64)
        for size, st in zip(t.shape[:-1], t.stride()[:-1]):
            off = np.add.outer(off, np.arange(size, dtype=np.int64) * st)
        addrs.append(t.data_ptr() // 4 + off.ravel())
    return len(np.unique(np.concatenate(addrs)))


def ladder_partial_products(n: int, bits) -> int:
    """Partial products of a ladder over n elements: a squaring for every
    bit, a product for every one bit."""
    return n * (len(bits) * PP_MODSQR + int(np.sum(bits)) * PP_MODMUL)


def field_bound(nbytes: int, partial_products: int, other_ops: int = 0) -> dict:
    """Least ms for a field kernel's work: its bytes at the memory rate,
    its partial products at the integer-multiply rate (plus any other lane
    instructions at the issue rate), the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (partial_products / IMUL_PER_S + other_ops / PEAK_LANE_OPS_PER_S) * 1e3
    return {"ms": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "partial_products": partial_products}


def alg_mul_partial_products(d: int, slots) -> int:
    """One K5 element's partial products: d * dy products as K3, then per
    output component 12 words times each of its nonzero coefficients and
    one Barrett reduction (K3's 169 + 78)."""
    tpos, tneg, _, _ = tower._plan(d, slots)
    nonzero = ((tpos + tneg) != 0).sum(axis=(0, 1))            # per output component
    return d * tpos.shape[1] * PP_MODMUL + int((12 * nonzero + 169 + 78).sum())


def oracle_check(job):
    """The port's oracle copy on one aggregate (run in a worker process):
    FastAggregateVerify of the compressed signature, and the hashed
    message as digits."""
    pubkeys, message, signature = job
    return (oracle.PyBLS.FastAggregateVerify(pubkeys, message, signature),
            g2_affine_encode(oracle.hash_to_g2(message)))


class OpCount:
    """Counts the aten ops that make a new tensor (about one kernel launch
    each on the card) while the ``with`` block runs; views are not counted."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self
        makes_tensor = {}          # op -> whether it returns a new tensor (schemas are slow to read)

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                new = makes_tensor.get(func)
                if new is None:
                    new = makes_tensor[func] = not any(r.alias_info for r in func._schema.returns)
                counter.ops += new
                return func(*args, **(kwargs or {}))

        self.ops = 0
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def bls_small_run(small, where: str, plain: bool, count_ops: bool = False) -> dict:
    """Phase 17's verify at B = 2 on ``where`` (``plain``: the plain
    versions); the plain and CPU runs go to child processes during phases
    32-33. Returns its verdicts, stage values (on the CPU), field-kernel
    launches, seconds and, with ``count_ops``, the aten ops it made."""
    args = [x.to(where) for x in small]
    stages = {}
    before = dict(kernels.launches)
    counter = OpCount() if count_ops else contextlib.nullcontext()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode(), counter:
        ok = fast_aggregate_verify_batch(*args, plain=plain, stages=stages)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    name = "kernel" if where == "cuda" and not plain else ("plain" if plain else where)
    return {"name": name, "ok": ok.cpu(), "stages": {k: v.cpu() for k, v in stages.items()},
            "s": time.perf_counter() - t0,
            "launches": {k: kernels.launches[k] - before[k] for k in bls_verify.FIELD_KERNELS},
            "ops": getattr(counter, "ops", None)}


def bls_phases(dev, card: str, census, deferred: list) -> list:
    """Phases 15-19: the field kernels K3-K5 and the real-BLS verify path
    (BASELINE config 3). Returns K3-K5's rows of the kernels line."""
    rng = np.random.default_rng(15)
    err = {}

    # 15. K3-K5 against their plain versions at the path's shapes. K3: its
    # product at each shape it has on the path, operands read in place (the
    # G1 tree's unbind views, a broadcast scalar), by every lane split; its
    # ladders (the inversion and square-root exponents) at 2048 elements
    shape3 = (BLS_LANES, 144)          # an Fq12 multiply's products: off the path (K5 makes them)
    a3, b3 = field_digits(rng, shape3).to(dev), field_digits(rng, shape3).to(dev)

    def tree_level(k):      # the G1 sum tree's Jacobian add at k lanes a committee
        jac = field_digits(rng, (BLS_AGGREGATES, 2 * k, 3), edges=False).to(dev)
        return jac[:, :k].unbind(-2)[0], jac[:, k:].unbind(-2)[2]

    c2 = field_digits(rng, (BLS_LANES, 2)).to(dev)
    k3_cases = {    # name -> (a, b): the products of the path, then the former headline
        "2048": (field_digits(rng, (BLS_AGGREGATES,)).to(dev),
                 field_digits(rng, (BLS_AGGREGATES,)).to(dev)),
        "2048x64 tree level": tree_level(64),
        "2048x32 tree level": tree_level(32),
        "2048x16 tree level": tree_level(16),
        "4096x2x2 line": (field_digits(rng, (BLS_LANES, 2, 2)).to(dev),
                          field_digits(rng, (BLS_LANES, 2, 2)).to(dev)),
        "4096x2 scale": (c2, c2[:, 0, None, :]),
        "4096x144 (off the path)": (a3, b3),
    }
    err["fp_modmul"] = 0
    for name, (x, y) in k3_cases.items():
        ref = fp._modmul(x, y)
        _, _, keep = fp._modmul_launch(x, y)
        check(keep[0].data_ptr() == x.data_ptr() and keep[1].data_ptr() == y.data_ptr(),
              f"K3 copies an operand at {name}")
        for g in K3_GROUPS:
            out, args, _ = fp._modmul_launch(x, y, g)
            kernels.launch_on(dev, "fp_modmul", *args)
            err["fp_modmul"] = max(err["fp_modmul"], digit_err(out, ref))
            check(torch.equal(out, ref), f"K3 ({g} lanes an element) differs from plain at {name}")
        check(torch.equal(fp.modmul(x, y), ref), f"K3 differs from its plain version at {name}")
    edge_vals = [0, 1, 2, fp.P_INT - 1, fp.P_INT, fp.P_INT + 1, 2 * fp.P_INT - 2,
                 2 * fp.P_INT - 1]
    e = torch.from_numpy(np.stack([fp.to_limbs(v) for v in edge_vals])).to(dev)
    ref = fp._modmul(e[:, None], e[None])       # broadcast, products up to (2p - 1)^2
    for g in K3_GROUPS:
        got, args, _ = fp._modmul_launch(e[:, None], e[None], g)
        kernels.launch_on(dev, "fp_modmul", *args)
        err["fp_modmul"] = max(err["fp_modmul"], digit_err(got, ref))
        check(torch.equal(got, ref), f"K3 ({g} lanes) differs from plain on the edge values")
    got_np = got.cpu().numpy()
    for i, x in enumerate(edge_vals):
        for j, y in enumerate(edge_vals):
            v = fp.from_limbs(got_np[i, j])
            check(v < 2 * fp.P_INT and v % fp.P_INT == x * y % fp.P_INT,
                  f"K3 edge product {i} x {j} is wrong")
    x_lad = field_digits(rng, (BLS_AGGREGATES,)).to(dev)
    x_lad[len(edge_vals):2 * len(edge_vals)] = e
    for name, bits in LADDERS.items():
        ref = fp._pow_static(x_lad, bits)
        for g in K3_GROUPS:
            out, args, _ = fp._pow_launch(x_lad, bits, g)
            kernels.launch_on(dev, "fp_pow", *args)
            err["fp_modmul"] = max(err["fp_modmul"], digit_err(out, ref))
            check(torch.equal(out, ref), f"K3's {name} ladder ({g} lanes) differs from plain")
        k = int("".join("1" if b else "0" for b in bits), 2)
        ref_np, x_np = ref.cpu().numpy(), x_lad.cpu().numpy()
        for i in (0, 1, 2, 7, 8, 100, BLS_AGGREGATES - 1):
            check(fp.from_limbs(ref_np[i]) % fp.P_INT
                  == pow(fp.from_limbs(x_np[i]) % fp.P_INT, k, fp.P_INT),
                  f"the {name} ladder's row {i} is not x^k mod p")
    check(torch.equal(fp.modinv(x_lad), fp._pow_static(x_lad, fp._P_MINUS_2_BITS)),
          "fp.modinv differs from the plain ladder")
    del got, ref
    shape4 = (BLS_LANES, 12)
    tape_in = {}
    err["fp_addsub"] = 0
    for name, tape in sorted(fp.TAPES.items()):
        lanes = shape4 if name in ADDSUB_OPS else (BLS_LANES,)
        args = [field_digits(rng, lanes + sh).to(dev) for sh in tape.in_shapes]
        tape_in[name] = args
        got, ref = fp.run_tape(tape, *args), fp._run_tape(tape, *args)
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        for g, r in zip(got, ref, strict=True):
            err["fp_addsub"] = max(err["fp_addsub"], digit_err(g, r))
            check(torch.equal(g, r), f"K4 tape {name} differs from its plain version at {lanes}")
    alg_in = {}
    err["alg_mul"] = 0
    for d, slots in ALG_SHAPES:
        dy = d if slots is None else len(slots)
        x, y = field_digits(rng, (BLS_LANES, d)).to(dev), field_digits(rng, (BLS_LANES, dy)).to(dev)
        alg_in[d, slots] = (x, y)
        got, ref = tower.alg_mul(x, y, slots), tower._alg_mul(x, y, slots)
        err["alg_mul"] = max(err["alg_mul"], digit_err(got, ref))
        check(torch.equal(got, ref), f"K5 differs from its plain version at d={d} slots={slots}")
    sq9 = fp.run_tape(fp.TAPES["fq12_cyclotomic_pre"], field_digits(rng, (BLS_LANES, 12)).to(dev))
    got, ref = tower.alg_mul(sq9, sq9), tower._alg_mul(sq9, sq9)
    err["alg_mul"] = max(err["alg_mul"], digit_err(got, ref))
    check(torch.equal(got, ref), "K5 differs from its plain version on a cyclotomic squaring's 9")
    del got, ref, sq9
    torch.cuda.empty_cache()
    say(f"K3 vs plain at {', '.join(k3_cases)} (every operand read in place), by "
        f"{', '.join(map(str, K3_GROUPS))} lanes an element, {len(edge_vals)}^2 broadcast edge "
        f"pairs (values checked mod p), and the {' and '.join(LADDERS)} ladders at "
        f"{BLS_AGGREGATES} elements in one launch (rows checked against pow); K4's "
        f"{len(tape_in)} tapes ({', '.join(ADDSUB_OPS)} at {list(shape4)}, the rest at "
        f"{BLS_LANES} lanes); K5 at {BLS_LANES} lanes for d = 2, "
        f"6, 12 and the line plan, and {BLS_LANES} x 9 Fq2 squarings: digit-equal "
        f"(max abs digit error {err})")

    # 16. the BLS path, counted
    inputs = bls_verify.build_inputs(BLS_AGGREGATES, BLS_SIGNERS)
    kernels.reset_launches()
    bls = bls_verify.run(inputs, dev)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    s = bls.summary
    check(all(launches[k] > 0 for k in bls_verify.FIELD_KERNELS)
          and launches["agg_sig"] == 0 and launches["merkle_level"] == 0,
          f"BLS path launches {launches}: want K3-K5, and neither K1 nor K2")
    vl = s["verify_launches"]
    check(vl["fp_pow"] == 3, f"K3 ladder launches per verify: {vl['fp_pow']}, want 3 (the "
          "inversions of g1_to_affine, the final exponentiation and the hash-to-G2 finish)")
    check(s["verified"] == BLS_AGGREGATES and s["negative_control_rejected"] == [0, 1]
          and s["negative_control_passed"] == BLS_AGGREGATES - 2,
          f"BLS verdicts: {s['verified']} verified, negative control {s['negative_control_rejected']}")
    t = bls.tensors
    for name, x in (("msg_g2", t.msg_g2), ("sig_g2", t.sig_g2)):
        check(x.shape == (BLS_AGGREGATES, 2, 2, fp.L) and x.dtype == torch.int32
              and bool(((x >= 0) & (x < 1 << fp.BITS)).all()), f"{name} is not canonical digits")
    say(f"BLS path B={BLS_AGGREGATES} N={BLS_SIGNERS}: K3 per verify {vl['fp_modmul']} products "
        f"and {vl['fp_pow']} ladders (one a chain of 610 products); launches {launches}; all "
        f"{s['verified']} aggregates verify; the swapped pair {s['negative_control_rejected']} "
        f"fails, the other {s['negative_control_passed']} pass")
    say(f"[{card}] BLS path summary: {json.dumps(s)}")

    # 17. the path at B = 2: kernels == plain on the card == the CPU; the oracle
    small = bls_verify.VerifyTensors(t.pk_table, *(x[:BLS_SMALL] for x in t[1:]))
    kernel_run = bls_small_run(small, "cuda", False, count_ops=True)
    check(kernel_run["ok"].tolist() == [True] * BLS_SMALL, "B=2 verdicts")
    say(f"[{card}] BLS path at B={BLS_SMALL}: kernel run {kernel_run['s']:.3f} s, "
        f"{kernel_run['launches']} field-kernel launches and {kernel_run['ops']} other ops "
        f"(counted, so slower)")

    def bls_done(run):
        name = run["name"]
        check(torch.equal(run["ok"], kernel_run["ok"]), f"B=2 verdicts: {name} differs")
        bad = [k for k, v in kernel_run["stages"].items() if not torch.equal(run["stages"][k], v)]
        check(not bad, f"B=2: the {name} run differs from the kernel run in {bad}")
        check(not any(run["launches"].values()), f"the {name} run launched a field kernel")
        say(f"phase 17 (run during phases 32-33): BLS path at B={BLS_SMALL}: the {name} run == "
            f"the kernel run (aggregate keys, Miller values, final exponentiation, verdicts); "
            f"{run['s']:.3f} s" + (f", {run['ops']} ops" if run["ops"] is not None else ""))

    cpu_small = bls_verify.VerifyTensors(*(x.cpu() for x in small))
    deferred.append((bls_small_run, (cpu_small, "cuda", True), bls_done))
    deferred.append((bls_small_run, (cpu_small, "cpu", False, True), bls_done))
    sig_x, sig_sign, _, _ = g2prep.g2_compressed_to_limbs(
        bls_verify._compress(t.sig_g2[:BLS_SMALL]))
    cand, _ = g2prep.hash_to_g2_candidates(inputs.messages[:BLS_SMALL])
    stage_ops = {}
    for stage, fn in (
            ("sig_decompress", lambda: g2prep.g2_decompress_batch(
                torch.from_numpy(sig_x).to(dev), torch.from_numpy(sig_sign).to(dev))),
            ("hash_finish", lambda: g2prep.hash_to_g2_finish(torch.from_numpy(cand).to(dev))),
            ("pairing", lambda: fast_aggregate_verify_batch(*(x.to(dev) for x in small)))):
        before = dict(kernels.launches)
        with torch.inference_mode(), OpCount() as counter:
            fn()
        stage_ops[stage] = {**{k: kernels.launches[k] - before[k]
                               for k in bls_verify.FIELD_KERNELS},
                            "aten_ops": counter.ops}
    say(f"[{card}] BLS verify stages at B={BLS_SMALL}, field-kernel launches and aten ops "
        f"(one per new tensor, the wrappers' outputs included): {json.dumps(stage_ops)}")
    sig_bytes = bls_verify._compress(t.sig_g2[:BLS_ORACLE])
    k = len(inputs.pk_comp)
    jobs = [([inputs.pk_comp[int(v) % k] for v, b in zip(inputs.committees[i], inputs.bits[i]) if b],
             inputs.messages[i], bytes(sig_bytes[i])) for i in range(BLS_ORACLE)]
    jobs += [(jobs[0][0], jobs[0][1], jobs[1][2]), (jobs[1][0], jobs[1][1], jobs[0][2])]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(min(len(jobs), os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        results = list(pool.map(oracle_check, jobs))
    oracle_s = time.perf_counter() - t0
    check([r[0] for r in results] == [True] * BLS_ORACLE + [False, False],
          f"oracle verdicts {[r[0] for r in results]}")
    check(bls.verdicts[:BLS_ORACLE].all() and not bls.negative[:2].any(),
          "device verdicts differ from the oracle's")
    msg_np = t.msg_g2[:BLS_ORACLE].cpu().numpy()
    check(all(np.array_equal(msg_np[i], results[i][1]) for i in range(BLS_ORACLE)),
          "hashed messages differ from the oracle's hash_to_g2")
    say(f"BLS path: {BLS_ORACLE} aggregates' hashed messages and verdicts, and the swapped "
        f"pair's, == the port's oracle copy (PyBLS.FastAggregateVerify, {oracle_s:.3f} s)")

    # 18. per-launch times against the plain versions and the bounds: kernel
    # ms by CUDA events over raw launches, device ms by the replay of a CUDA
    # graph of them (the host's launch rate taken out), the wrappers' calls
    rows = {}
    by_shape = {}
    kept = []           # every tensor a raw launch below reads or writes, kept alive
    for name, (x, y) in k3_cases.items():
        n = math.prod(torch.broadcast_shapes(x.shape, y.shape)[:-1])
        entry = {"elements": n, "group": fp.k3_group(n)}
        for g in K3_GROUPS:
            out, args, keep = fp._modmul_launch(x, y, g)
            kept.append((out, keep))         # the raw launches write out and read keep
            raw = lambda args=args: kernels.launch_on(dev, "fp_modmul", *args)   # noqa: E731
            entry[f"g{g}"] = {"ms": time_ms(raw, 20), "device_ms": device_ms(raw)}
        entry.update(entry[f"g{entry['group']}"])
        entry["wrapper_ms"] = time_ms(lambda: fp.modmul(x, y), 20)
        entry["plain_ms"] = time_ms(lambda: fp._modmul(x, y), 2)
        entry["bound"] = field_bound((distinct_rows(x, y) + n) * FQ_BYTES, PP_MODMUL * n)
        by_shape[name] = entry
    for name, bits in LADDERS.items():
        n, steps = BLS_AGGREGATES, len(bits) + int(np.sum(bits))
        entry = {"elements": n, "group": fp.k3_group(n), "steps": steps}
        for g in K3_GROUPS:
            out, args, keep = fp._pow_launch(x_lad, bits, g)
            kept.append((out, keep))
            raw = lambda args=args: kernels.launch_on(dev, "fp_pow", *args)      # noqa: E731
            entry[f"g{g}"] = {"ms": time_ms(raw, 5), "device_ms": device_ms(raw, 5)}
        entry.update(entry[f"g{entry['group']}"])
        entry["wrapper_ms"] = time_ms(lambda: fp.pow_static(x_lad, bits), 5)
        entry["plain_ms"] = time_ms(lambda: fp._pow_static(x_lad, bits), 1)
        entry["bound"] = field_bound(2 * FQ_BYTES * n, ladder_partial_products(n, bits))
        by_shape[f"{name} ladder {n}"] = entry
    rows["fp_modmul"] = dict(by_shape["2048x64 tree level"], shape=[BLS_AGGREGATES, 64],
                             by_shape=by_shape)
    for key, v in by_shape.items():
        say(f"[{card}] fp_modmul {key} ({v['elements']} elements"
            + (f", {v['steps']} steps" if "steps" in v else "") + f"; {v['group']} lanes an "
            f"element on the path): kernel {v['ms']:.4f} ms, device {fmt_ms(v['device_ms'])}, "
            f"wrapper {v['wrapper_ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, bound "
            f"{v['bound']['ms']:.4f} ms ({v['bound']['by']}), "
            f"{100 * v['bound']['ms'] / v['ms']:.1f}% of it by kernel ms"
            + ("" if v["device_ms"] is None else
               f", {100 * v['bound']['ms'] / v['device_ms']:.1f}% by device ms")
            + "; by lanes an element: "
            + ", ".join(f"{g}: kernel {v[f'g{g}']['ms']:.4f} ms, device "
                        f"{fmt_ms(v[f'g{g}']['device_ms'])}" for g in K3_GROUPS))
    by_tape, raw = {}, {}
    for name, args in tape_in.items():
        tape = fp.TAPES[name]
        outs, (largs, keep) = fp._tape_launch(tape, args)
        kept.append((outs, keep))            # the outputs and any input copies
        n = largs[-1]
        raw[name] = lambda largs=largs: kernels.launch_on(dev, "fp_addsub", *largs)
        by_tape[name] = {
            "lanes": n, "rows": len(tape.rows) + sum(tape.out_rows), "steps": len(tape.steps),
            "ms": time_ms(raw[name], 20),
            "wrapper_ms": time_ms(lambda: fp.run_tape(tape, *args), 20),
            "bound": field_bound((len(tape.rows) + sum(tape.out_rows)) * FQ_BYTES * n, 0)}
        if name in ADDSUB_OPS:
            plain = getattr(fp, "_" + name)
            by_tape[name]["plain_ms"] = time_ms(lambda: plain(*args), 5)
    for name, fn in raw.items():
        by_tape[name]["device_ms"] = device_ms(fn)
    a4, b4 = tape_in["modadd"]
    rows["fp_addsub"] = dict(by_tape["modadd"], shape=list(shape4), by_tape=by_tape,
                             wrapper_ms=time_ms(lambda: fp.modadd(a4, b4), 20))
    by_shape = {}
    for (d, slots), (x, y) in alg_in.items():
        dy = y.shape[-2]
        out5 = torch.empty_like(x)
        q = tower._PLAN_ID[d, slots]
        raw = (lambda x=x, y=y, out5=out5, d=d, dy=dy, q=q: kernels.launch_on(   # noqa: E731
            dev, "alg_mul", x.data_ptr(), d * fp.L, y.data_ptr(), dy * fp.L, out5.data_ptr(),
            BLS_LANES, q))
        by_shape[f"d{d}" + ("_line" if slots else "")] = {
            "ms": time_ms(raw, 20),
            "device_ms": device_ms(raw),
            "plain_ms": time_ms(lambda: tower._alg_mul(x, y, slots), 2),
            "wrapper_ms": time_ms(lambda: tower.alg_mul(x, y, slots), 20),
            "bound": field_bound((2 * d + dy) * FQ_BYTES * BLS_LANES,
                                 alg_mul_partial_products(d, slots) * BLS_LANES)}
    x, y = alg_in[12, None]
    rows["alg_mul"] = dict(by_shape["d12"], shape=[BLS_LANES, 12], by_shape=by_shape,
                           wrapper_ms=time_ms(lambda: tower.alg_mul(x, y), 20))
    for name in ("fp_addsub", "alg_mul"):
        r = rows[name]
        extra = r.get("by_tape") or r["by_shape"]
        say(f"[{card}] {name} per launch (CUDA events over 20; device ms by a CUDA graph's "
            "replay): " + "; ".join(
                f"{k} kernel {v['ms']:.4f} ms, device {fmt_ms(v.get('device_ms'))}, "
                f"wrapper {v.get('wrapper_ms', float('nan')):.4f} ms, plain "
                f"{fmt_ms(v.get('plain_ms'))}, bound {v['bound']['ms']:.4f} ms "
                f"({v['bound']['by']}), {100 * v['bound']['ms'] / v['ms']:.1f}% of it"
                + ("" if v.get("device_ms") is None else
                   f" ({100 * v['bound']['ms'] / v['device_ms']:.1f}% by device ms)")
                + (f", {v['lanes']} lanes x {v['rows']} rows, {v['steps']} steps" if "rows" in v
                   else "") for k, v in extra.items()))
    torch.cuda.empty_cache()
    with torch.inference_mode():
        prof = profiled(lambda: fast_aggregate_verify_batch(*t))
    say(f"[{card}] BLS pairing stage at B={BLS_AGGREGATES} under torch.profiler: wall "
        f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms "
        f"({100 * prof['busy_ms'] / prof['wall_ms']:.2f}%); by kernel "
        + ", ".join(f"{k} {prof['kernel_ms'][k]:.3f} ms" for k in bls_verify.FIELD_KERNELS))
    say(f"[{card}] BLS path: verify {s['verify_s']:.3f} s (signature decompression "
        f"{s['sig_decompress_s']:.3f}, hash-to-G2 {s['hash_to_g2_s']:.3f}, pairing "
        f"{s['pairing_s']:.3f}); {s['aggregates_per_s']:.3f} aggregates/s, "
        f"{s['attestations_per_s']:.1f} attestations/s")

    # 19. K3's SASS recounted: each function of its library (the product and
    # the ladder at 1 and 4 lanes an element), the bounds of the product
    # at one lane from its count at the tree level; the census of K4 (a tape
    # interpreter) and K5
    if census is not None:
        for key in sorted(k for k in census if k.startswith(("fp_modmul_g", "fp_pow_g"))):
            say(f"SASS {key} (whole function): {json.dumps(census[key]['total'])}")
        head = rows["fp_modmul"]["by_shape"]["2048x64 tree level"]
        if "fp_modmul_g1" in census:
            b = sass_bounds(census["fp_modmul_g1"]["total"], head["elements"])
            measured = head["g1"]["ms"]
            say(f"[{card}] fp_modmul at {head['elements']} elements, one lane each: measured "
                f"{measured:.4f} ms; bounds from the whole function's count "
                + ", ".join(f"{k} {v:.4f}" for k, v in b.items())
                + f"; imad / measured {b['imad_ms'] / measured:.3f}")
        for name in ("fp_addsub", "alg_mul"):
            say(f"SASS {name} (whole kernel): {json.dumps(census[name]['total'])}")

    untimed = []            # every time phase 18 took: each shape or tape, and each lane split
    for name, r in rows.items():
        for k, v in (r.get("by_tape") or r["by_shape"]).items():
            splits = [(f" at {g} lanes", v[f"g{g}"]) for g in K3_GROUPS if f"g{g}" in v]
            untimed += [f"{name} {k}{at}" for at, t in [("", v), *splits]
                        if t.get("device_ms") is None]
    check(not untimed, f"no device time (the CUDA graph timer failed) for {untimed}")

    out = []
    for name, r in rows.items():
        source, replaces = FIELD_KERNELS[name]
        counted = ("fp_modmul", "fp_pow") if name == "fp_modmul" else (name,)
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(launches[k] for k in counted), "max_abs_err": err[name],
               "matches_plain": True, "shape": r["shape"], "ms": r["ms"],
               "device_ms": r.get("device_ms"), "plain_ms": r["plain_ms"],
               "bound_ms": r["bound"]["ms"], "bound_by": r["bound"]["by"],
               "library_ms": None,
               "launches_by_stage": {st: sum(v[k] for k in counted)
                                     for st, v in s["launches"].items()},
               "wrapper_ms": r["wrapper_ms"]}
        if name == "fp_modmul":
            row["launches_by_kind"] = {"product": launches["fp_modmul"],
                                       "ladder": launches["fp_pow"]}
            row["verify_launches_by_kind"] = {"product": s["verify_launches"]["fp_modmul"],
                                              "ladder": s["verify_launches"]["fp_pow"]}
            row["ladder_replaces"] = list(K3_LADDER_REPLACES)
        for k in ("by_tape", "by_shape"):
            if k in r:
                row[k] = {kk: {"ms": vv["ms"], "device_ms": vv.get("device_ms"),
                               "plain_ms": vv.get("plain_ms"), "wrapper_ms": vv.get("wrapper_ms"),
                               "bound_ms": vv["bound"]["ms"],
                               **{f"g{g}": vv[f"g{g}"] for g in K3_GROUPS if f"g{g}" in vv}}
                          for kk, vv in r[k].items()}
        out.append(row)
    return out


def k6_bound(n: int, blocks: int) -> dict:
    """Least time for K6's work: n messages of ``blocks`` blocks, each block
    one compression with its schedule; each message byte read once, each
    digest written once."""
    t_ops = n * blocks * (OPS_COMPRESS_ROUNDS + OPS_SCHEDULE) / PEAK_LANE_OPS_PER_S * 1e3
    t_bytes = n * (64 * blocks + 32) / HBM_BYTES_PER_S * 1e3
    return {"ms": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes"}


def k7_bound(ga: int, g: int, r: int, k: int, w: int) -> dict:
    """Least time for K7's work as it runs, a product of 0/1 int8 matrices
    of 8r x 8k and 8k x W a group on the tensor cores; A, B read once and
    the output written once. ``lookup_ms``: the former design's bound, an
    exp lookup in shared memory per output byte and inner index and a log
    lookup per byte of B."""
    t_ops = 2 * g * (8 * r) * (8 * k) * w / INT8_TENSOR_OPS_PER_S * 1e3
    t_bytes = (ga * r * k + g * k * w + g * r * w) / HBM_BYTES_PER_S * 1e3
    return {"ms": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes",
            "lookup_ms": (g * r * w * k + g * k * w) / SHARED_LOOKUPS_PER_S * 1e3}


def k6_chain_floor_ms(blocks: int) -> float:
    """Least time for one chain of ``blocks`` blocks on one scheduler: its
    rounds' integer-pipe instructions, one after another."""
    return (64 * blocks * CHAIN_ROUND_INT_OPS * INT_PIPE_CLOCKS_PER_WARP_OP
            / H100_CLOCK_HZ * 1e3)


def wall_ms(fn, reps: int) -> list:
    """Host wall ms of each of ``reps`` calls of ``fn``, each ending in a
    synchronize (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def results_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                                    for k in a)


def sync_batch(rng, dev) -> sync_verify.SyncUpdateBatch:
    """SYNC_B updates of SYNC_S lanes: seeded pubkeys, 0.9 participation,
    honest aggregates signed through K6 and K1 on the card (the host oracle
    checks them independently), seeded branches with their roots by the
    host walk."""
    b, s = SYNC_B, SYNC_S
    pubkeys = rng.integers(0, 256, (b, s, 48), dtype=np.uint8)
    bits = rng.random((b, s)) < 0.9
    messages = rng.integers(0, 256, (b, 32), dtype=np.uint8)
    pk = precompute_pk_states(pubkeys.reshape(b * s, 48), dev)
    sigs = aggregate_signatures_batch(
        pk, torch.arange(b * s, dtype=torch.int32, device=dev).reshape(b, s),
        torch.from_numpy(bits).to(dev),
        torch.from_numpy(messages_to_words(messages).view(np.int32)).to(dev))
    signatures = words_to_numpy(sigs).astype(">u4").view(np.uint8).reshape(b, 96)
    groups = {}
    for name, depth in (("fin", SYNC_FIN_DEPTH), ("sc", SYNC_SC_DEPTH)):
        leaf = rng.integers(0, 256, (b, 32), dtype=np.uint8)
        branch = rng.integers(0, 256, (b, depth, 32), dtype=np.uint8)
        index = rng.integers(0, 1 << depth, b).astype(np.int64)
        groups.update({f"{name}_leaf": leaf, f"{name}_branch": branch, f"{name}_index": index,
                       f"{name}_root": sync_verify.merkle_roots_host(leaf, branch, index),
                       f"{name}_present": np.ones(b, bool)})
    return sync_verify.SyncUpdateBatch(
        pubkeys=pubkeys, bits=bits, weights=rng.integers(1, 2**35, (b, s)).astype(np.int64),
        messages=messages, signatures=signatures, **groups)


def k6_edges(rng, dev, k6_in: dict, k6_ref: dict) -> int:
    """K6 at its edge shapes, each launch bit-equal to the plain version:
    the wrapper one message below, at and above the crossover of its two
    designs at K6_EDGE_BLOCKS blocks (one launch each, the last row against
    hashlib) and on rows read in place at a stride; each of K6_DESIGNS,
    named through the measuring entry point, at the path's shapes. Returns
    the largest word difference (0)."""
    cross = k6_chains_below()
    for blocks in K6_EDGE_BLOCKS:
        msgs = rng.integers(0, 256, (cross + 1, 64 * blocks - 9), dtype=np.uint8)
        words = torch.from_numpy(_pad_messages(msgs).view(np.int32)).to(dev)
        for n in (cross - 1, cross, cross + 1):
            before = kernels.launches["sha256_blocks"]
            got = sha256_blocks(words[:n])
            ref = sha256_blocks(words[:n], plain=True)
            torch.cuda.synchronize()
            check(kernels.launches["sha256_blocks"] == before + 1 and torch.equal(got, ref),
                  f"K6 at {n} messages of {blocks} blocks differs from its plain version")
            last = words_to_numpy(got[n - 1:]).astype(">u4").view(np.uint8)
            check(last.tobytes() == hashlib.sha256(msgs[n - 1].tobytes()).digest(),
                  f"K6 at {n} messages of {blocks} blocks: the last row differs from hashlib")
        del msgs, words
    wide = torch.from_numpy(rng.integers(-2**31, 2**31, (3000, 16 * 33 + 4),
                                         dtype=np.int64).astype(np.int32)).to(dev)
    strided = wide[:, 4:]
    check(torch.equal(sha256_blocks(strided), sha256_blocks(strided.contiguous(), plain=True)),
          "K6 on strided rows differs from its plain version")
    for name, words in k6_in.items():
        n, nb = words.shape[0], words.shape[1] // 16
        for design, threads in K6_DESIGNS.items():
            out = torch.full((n, 8), -1, dtype=torch.int32, device=dev)
            kernels.launch_on(dev, "sha256_blocks_design", words.data_ptr(), words.stride(0), nb,
                              out.data_ptr(), n, threads)
            torch.cuda.synchronize()
            check(torch.equal(out, k6_ref[name]), f"K6's design {design} differs at {name}")
    say(f"K6 at the crossover ({cross} messages, chains from {k6_chains_min_blocks()} blocks; "
        f"{cross - 1}, {cross}, {cross + 1} at {', '.join(map(str, K6_EDGE_BLOCKS))} blocks; one "
        f"launch each), on strided rows and in each design ({', '.join(K6_DESIGNS)}) at every "
        f"path shape: bit-equal to the plain version")
    return 0


def k7_edge_operands(rng, kind: str, g: int, r: int, k: int, w: int):
    """K7's edge operands (A, B) as numpy: random, a broadcast A, all zero,
    all 0xFF, or the identity A."""
    if kind == "zeros":
        return np.zeros((g, r, k), np.uint8), np.zeros((g, k, w), np.uint8)
    if kind == "ones":
        return np.full((g, r, k), 0xFF, np.uint8), np.full((g, k, w), 0xFF, np.uint8)
    b = rng.integers(0, 256, (g, k, w), dtype=np.uint8)
    if kind == "identity":
        return np.eye(r, k, dtype=np.uint8)[None], b
    return rng.integers(0, 256, (1 if kind == "broadcast" else g, r, k), dtype=np.uint8), b


def k7_edges(rng, dev) -> int:
    """K7 at every k, r, W of its edge sets and every operand kind, one
    launch each, bit-equal to the plain version. Returns the largest byte
    difference (0)."""
    count = 0
    for k in K7_EDGE_K:
        for r in K7_EDGE_R:
            for w in K7_EDGE_W:
                for kind in K7_EDGE_KINDS:
                    a, b = (torch.from_numpy(x).to(dev)
                            for x in k7_edge_operands(rng, kind, 2, r, k, w))
                    before = kernels.launches["gf256_matmul"]
                    got = das_verify.gf_matmul(a, b)
                    torch.cuda.synchronize()
                    check(kernels.launches["gf256_matmul"] == before + 1
                          and torch.equal(got, das_verify.gf_matmul(a, b, plain=True)),
                          f"K7 at k={k} r={r} W={w} ({kind}) differs from its plain version")
                    count += 1
    say(f"K7 at k in {K7_EDGE_K} x r in {K7_EDGE_R} x W in {K7_EDGE_W}, {K7_EDGE_KINDS} "
        f"operands ({count} products, one launch each): bit-equal to the plain version")
    return 0


def rider_sim(dev, **kw) -> DenseSimulation:
    """The rider path's run: 2^20 validators, mainnet config with the
    PeerDAS geometry, 90 shuffle rounds, both riders."""
    return DenseSimulation(N_MAINNET, mainnet_config().replace(**PEERDAS), device=dev,
                           shuffle_rounds=90, riders=[dense_rider_from_config(dict(d))
                                                      for d in DAS_RIDERS], **kw)


def rider_twin(variant: str, depth: int) -> dict:
    """Phase 24's plain twin (a child process during phases 32-33): the
    rider run under ``variant`` and its ``plain=True`` run for ``depth``
    slots. Returns whether their records agree, the plain run's seconds
    and its light clients' stats."""
    dev = torch.device("cuda", 0)
    short = rider_sim(dev, variant=variant)
    short_p = rider_sim(dev, variant=variant, plain=True)
    t0 = time.perf_counter()
    for _ in range(depth):
        short_p.run_slot()
    ref = rider_record(short_p)
    plain_s = time.perf_counter() - t0
    for _ in range(depth):
        short.run_slot()
    return {"equal": rider_record(short) == ref, "plain_s": plain_s,
            "lc": short_p.riders[1].stats(), "variant": variant, "depth": depth}


def rider_record(sim) -> dict:
    """What two rider runs must agree on."""
    summary = sim.summary()
    summary.pop("dense_phases", None)
    das, lc = sim.riders
    return {"metrics": [dict(m) for m in sim.metrics], "summary": summary,
            "das": das.state_meta(),
            "lightclient": (lc.state_meta(), lc.head_slot.tolist(), lc.head_idx.tolist()),
            "digest": state_digest(sim)}


def das_sync_phases(dev, card: str, census, deferred: list) -> list:
    """Phases 20-25, the sync and DAS slice: K6 and K7 against their plain
    versions at the path's shapes; the sync verify at 2,048 x 512, the DAS
    sample verify at 1,152 and 36,864 samples (and the host/card crossover)
    and the 9-blob reconstruction against their host oracles; the dense run
    at 2^20 with both riders, counted, against its plain=True run and its
    checkpoint-resumed twin, and without riders; K6 and K7 timed against
    their bounds. Returns the kernels line's K6 and K7 rows."""
    rng = np.random.default_rng(20)

    # 20. K6 and K7 against their plain versions at the path's shapes
    k6_in, k6_ref, k6_err = {}, {}, 0
    for name, (n, length) in K6_SHAPES.items():
        if length is None:      # one unpadded block: the lanes' signature midstates
            msgs = rng.integers(0, 256, (n, 48), dtype=np.uint8)
            words = torch.from_numpy(pk_blocks(msgs).view(np.int32)).to(dev)
        else:
            msgs = rng.integers(0, 256, (n, length), dtype=np.uint8)
            words = torch.from_numpy(_pad_messages(msgs).view(np.int32)).to(dev)
        got = sha256_blocks(words)
        ref = sha256_blocks(words, plain=True)
        torch.cuda.synchronize()
        err = int(((got.long() & MASK32) - (ref.long() & MASK32)).abs().max())
        k6_err = max(k6_err, err)
        check(err == 0 and torch.equal(got, ref), f"K6 differs from its plain version at {name}")
        rows = words_to_numpy(got).astype(">u4").view(np.uint8).reshape(n, 32)
        for i in (0, n // 2, n - 1) if length is not None else ():
            check(rows[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest(),
                  f"K6 {name} row {i} differs from hashlib")
        k6_in[name], k6_ref[name] = words, ref
        del msgs
    say("K6 vs plain at " + ", ".join(f"{k} {w.shape[0]} x {w.shape[1] // 16}"
                                      for k, w in k6_in.items())
        + " (messages x blocks): bit-equal; 3 rows of each hashed message == hashlib")
    k7_in, k7_err = {}, 0
    half = np.zeros(2 * DAS_K, bool)
    half[DAS_K:] = True
    ext = extension_matrix(DAS_K)[None]
    regrid = das_verify._regrid_matrix(tuple(range(DAS_K, 2 * DAS_K)), DAS_K)[None]
    for name, (ga, g, r, k, w) in K7_SHAPES.items():
        a = torch.from_numpy(np.repeat(ext if name == "extension" else regrid, ga, 0)).to(dev)
        b = rng.integers(0, 256, (g, k, w), dtype=np.uint8)
        b[0, 3] = 0
        b[-1, :, w // 3] = 0
        b = torch.from_numpy(b).to(dev)
        got = das_verify.gf_matmul(a, b)
        ref = das_verify.gf_matmul(a, b, plain=True)
        torch.cuda.synchronize()
        err = int((got.int() - ref.int()).abs().max())
        k7_err = max(k7_err, err)
        check(err == 0 and torch.equal(got, ref), f"K7 differs from its plain version at {name}")
        check(np.array_equal(got[-1].cpu().numpy(),
                             gf_matmul_host(a[-1 if ga > 1 else 0].cpu().numpy(),
                                            b[-1].cpu().numpy())),
              f"K7 {name} differs from the host product")
        k7_in[name] = (a, b)
    say("K7 vs plain at " + ", ".join(f"{k} ({ga}|{g}, {r}, {kk}) x ({g}, {kk}, {w})"
                                      for k, (ga, g, r, kk, w) in K7_SHAPES.items())
        + ": bit-equal; the last group == the host product")
    cross = k6_chains_below()
    k6_err = max(k6_err, k6_edges(rng, dev, k6_in, k6_ref))
    k7_err = max(k7_err, k7_edges(rng, dev))

    # 21. the sync verify at 2,048 x 512
    batch = sync_batch(rng, dev)
    batch.signatures[3, 0] ^= 1                   # a forged aggregate
    lane = int(np.nonzero(batch.bits[6])[0][0])
    batch.bits[6, lane] = False                   # a lane dropped after signing
    batch.bits[9] = False                         # an empty bitlist
    batch.fin_branch[12, 2, 5] ^= 1               # a corrupted finality branch
    batch.sc_root[15, 0] ^= 1                     # a wrong attested root
    batch.fin_present[18] = False                 # an absent finality proof
    before = dict(kernels.launches)
    got = sync_verify.verify_batch_device(batch, dev)
    sync_launches = {k: v - before[k] for k, v in kernels.launches.items() if v > before[k]}
    t0 = time.perf_counter()
    host = sync_verify.verify_batch_host(batch)
    host_s = time.perf_counter() - t0
    plain = sync_verify.verify_batch_device(batch, dev, plain=True)
    check(results_equal(got, host) and results_equal(got, plain),
          "sync verify differs from verify_batch_host or its plain=True run")
    check(np.nonzero(~got["sig_ok"])[0].tolist() == [3, 6, 9]
          and np.nonzero(~got["fin_ok"])[0].tolist() == [12, 18]
          and np.nonzero(~got["sc_ok"])[0].tolist() == [15],
          "sync verify: the corrupted updates and only they must be rejected")
    check(sync_launches == {"sha256_blocks": 1, "agg_sig": 1,
                            "merkle_level": SYNC_FIN_DEPTH + SYNC_SC_DEPTH},
          f"sync verify launches {sync_launches}")
    sync_ms = wall_ms(lambda: sync_verify.verify_batch_device(batch, dev), 3)
    say(f"sync verify B={SYNC_B} S={SYNC_S}: == verify_batch_host ({host_s:.3f} s) and the "
        f"plain=True run; rejects exactly sig [3, 6, 9], fin [12, 18], sc [15]; launches "
        f"{sync_launches}")
    say(f"[{card}] sync verify B={SYNC_B} S={SYNC_S}: " + ", ".join(f"{x:.3f}" for x in sync_ms)
        + f" ms wall per call ({SYNC_B / (min(sync_ms) / 1e3):.1f} updates/s at the best)")
    del batch, got, host, plain

    lap("phases 20-21")
    # 22. the DAS sample verify at 1,152 and 36,864 samples, and the crossover
    cfg = mainnet_config().replace(**PEERDAS)
    engine = BlobEngine(cfg, seed=1, device=dev)
    cells, branches, idx, coms = [], [], [], []
    cell_idx = np.arange(2 * DAS_K)
    block_grids = None
    for blk in range(BACKFILL_BLOCKS):
        grids, commitments = engine.build_batch(blk + 1, hashlib.sha256(bytes([blk])).digest())
        if blk == 0:
            block_grids = grids.clone()
        host_grids = grids.cpu().numpy()
        for i in range(DAS_BLOBS):
            _, br = engine.scheme.branches(grids[i], cell_idx)
            cells.append(host_grids[i])
            branches.append(br)
            idx.append(cell_idx)
            coms.append(np.frombuffer(commitments[i] * len(cell_idx), np.uint8).reshape(-1, 32))
    big = das_verify.DasSampleBatch(cells=np.concatenate(cells), branches=np.concatenate(branches),
                                    indices=np.concatenate(idx).astype(np.int64),
                                    commitments=np.concatenate(coms))
    del cells, branches
    n = big.size
    bad_rows = {7: "cell", n // 300: "cell", n // 18: "branch", n * 5 // 6: "commitment"}
    big.cells[7, 0] ^= 1
    big.cells[n // 300, 5] ^= 1
    big.branches[n // 18, 3, 7] ^= 1
    big.commitments[n * 5 // 6, 0] ^= 1
    das_out = {}
    for s in (DAS_BLOBS * 2 * DAS_K, big.size):
        sub = das_verify.DasSampleBatch(big.cells[:s], big.branches[:s], big.indices[:s],
                                        big.commitments[:s])
        before = dict(kernels.launches)
        got = das_verify.verify_samples_device(sub, dev)
        das_launches = {k: v - before[k] for k, v in kernels.launches.items() if v > before[k]}
        t0 = time.perf_counter()
        host = das_verify.verify_samples_host(sub)
        host_once_ms = (time.perf_counter() - t0) * 1e3
        check(results_equal(got, host), f"DAS verify at {s} samples differs from the host")
        want = sorted(r for r in bad_rows if r < s)
        check(np.nonzero(~got["ok"])[0].tolist() == want,
              f"DAS verify at {s}: rejected {np.nonzero(~got['ok'])[0].tolist()}, want {want}")
        check(das_launches == {"sha256_blocks": 1, "merkle_level": 7},
              f"DAS verify launches {das_launches}")
        das_out[s] = das_launches
    say(f"DAS verify at {DAS_BLOBS * 2 * DAS_K} and {big.size} samples (PeerDAS cells, "
        f"{BACKFILL_BLOCKS} blocks of {DAS_BLOBS} blobs): == verify_samples_host; rejects "
        f"exactly the corrupted rows {sorted(bad_rows)}; launches {das_out[big.size]} a batch")
    crossover = {}
    for s in SAMPLE_SIZES:
        sub = das_verify.DasSampleBatch(big.cells[:s], big.branches[:s], big.indices[:s],
                                        big.commitments[:s])
        card_ms = wall_ms(lambda: das_verify.verify_samples_device(sub, dev), 3)
        # the largest batch's host time is its oracle call above (~9 s a call)
        host_ms = ([host_once_ms] if s == big.size
                   else wall_ms(lambda: das_verify.verify_samples_host(sub), 3))
        crossover[s] = {"card_ms": card_ms, "host_ms": host_ms}
        say(f"[{card}] DAS verify at {s} samples: card {', '.join(f'{x:.3f}' for x in card_ms)} "
            f"ms; host {', '.join(f'{x:.3f}' for x in host_ms)} ms (wall per call)")
    del big

    lap("phase 22")
    # 23. the reconstruction of 9 blobs at k = 64 x 2,048
    present = np.repeat(half[None], DAS_BLOBS, 0)
    ok, data = das_verify.reconstruct_check_batch(block_grids, present)
    check(bool(ok.all()) and torch.equal(data, block_grids[:, :DAS_K]),
          "9-blob reconstruction from the parity halves must give back the data")
    host_grids = block_grids.cpu().numpy()
    mixed = rng.random((3, 2 * DAS_K)) < 0.6
    mixed[:, :DAS_K] |= rng.random((3, DAS_K)) < 0.5
    for j in range(3):
        if mixed[j].sum() < DAS_K:
            mixed[j, :DAS_K] = True
    garbled = host_grids[:3].copy()
    garbled[~mixed] = rng.integers(0, 256, (int((~mixed).sum()), DAS_CELL), dtype=np.uint8)
    # with exactly k cells present any values lie on some polynomial, so the
    # corrupted grid is checked whole: every cell present
    corrupt = host_grids.copy()
    corrupt[4, DAS_K + DAS_K // 2 + DAS_K // 16, 17] ^= 1
    whole = np.ones_like(present)
    for label, grids_np, pres in (("parity halves", host_grids, present),
                                  ("mixed subsets", garbled, mixed),
                                  ("whole grids, one cell corrupted", corrupt, whole)):
        ok, data = das_verify.reconstruct_check_batch(torch.from_numpy(grids_np).to(dev), pres)
        ok_np, data_np = ok.cpu().numpy(), data.cpu().numpy()
        for j in range(grids_np.shape[0]):
            h_ok, h_data = das_verify.reconstruct_check_host(grids_np[j], pres[j])
            check(bool(ok_np[j]) == h_ok and np.array_equal(data_np[j], h_data),
                  f"reconstruction ({label}) blob {j} differs from the host")
    check(np.nonzero(~ok_np)[0].tolist() == [4], "one corrupted cell must flip its blob's verdict")
    recon_ms = wall_ms(lambda: das_verify.reconstruct_check_batch(block_grids, present), 5)
    say(f"reconstruction of {DAS_BLOBS} blobs (k={DAS_K}, {DAS_CELL} bytes): == "
        "reconstruct_check_host from the parity halves and from mixed subsets; of whole "
        f"grids, one corrupted cell flips exactly its blob; [{card}] "
        + ", ".join(f"{x:.3f}" for x in recon_ms)
        + " ms wall per 9-blob check")

    lap("phase 23")
    # 24. the dense run with both riders at 2^20, counted
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sim = rider_sim(dev, phase_profile=8)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim.run_epochs(RIDER_EPOCHS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rider_launches = dict(kernels.launches)
    rec = rider_record(sim)
    phases = sim.phases.summary()
    slots = sim.slot
    das, lc = rec["summary"]["workload"]["das"], rec["summary"]["workload"]["lightclient"]
    check(das["sidecar_failures"] == 0 and das["sample_misses"] == 0
          and das["sidecars_built"] == das["sidecars_verified"] == DAS_BLOBS * slots
          and das["samples_drawn"] == DAS_CLIENTS * 8 * slots,
          f"DAS rider stats {das} after {slots} proposals")
    check(lc["updates_applied"] > 0 and lc["clients_synced"] == DAS_CLIENTS
          and lc["max_head_slot"] > 0, f"light-client rider stats {lc} after {slots} slots")
    check(rider_launches["agg_sig"] == 2 * slots and rider_launches["gf256_matmul"] == 2 * slots
          and rider_launches["merkle_level"] == 14 * slots
          and rider_launches["sha256_blocks"] == 4 * slots + 2,
          f"rider run launches {rider_launches} over {slots} proposals")
    check(all(sim.walk_checks), "rider run walk checks")
    per_proposal = {k: rider_launches[k] / slots
                    for k in ("agg_sig", "merkle_level", "sha256_blocks", "gf256_matmul")}
    say(f"rider run n={N_MAINNET}, {RIDER_EPOCHS} epochs ({slots} proposals): launches "
        f"{rider_launches} (per proposal {per_proposal}; K6 also twice at setup: the signers' "
        f"midstates and the light clients' lags); das {das}; lightclient {lc}; "
        f"digest {rec['digest']}")
    base = DenseSimulation(N_MAINNET, mainnet_config().replace(**PEERDAS), device=dev,
                           shuffle_rounds=90, phase_profile=8)
    t3 = time.perf_counter()
    base.run_epochs(RIDER_EPOCHS)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    base_phases = base.phases.summary()
    del base
    t5 = time.perf_counter()
    prof_riders = profiled(lambda: [sim.run_slot() for _ in range(PROFILE_SLOTS)])
    prof_s = time.perf_counter() - t5
    with_s, without_s = (t2 - t1) / RIDER_EPOCHS, (t4 - t3) / RIDER_EPOCHS
    work = phases["phases"].get("workload", {})
    say(f"[{card}] dense path with riders: setup {t1 - t0:.3f} s, {with_s:.3f} s per simulated "
        f"epoch; without riders (same process) {without_s:.3f} s; workload phase "
        f"{work.get('total_ms')} ms = {work.get('share_pct')}% of the rider run's wall; "
        f"{PROFILE_SLOTS} more slots under torch.profiler (the trace read included "
        f"{prof_s:.3f} s) wall {prof_riders['wall_ms']:.3f} ms, device busy "
        f"{prof_riders['busy_ms']:.3f} ms "
        f"({100 * prof_riders['busy_ms'] / prof_riders['wall_ms']:.2f}%), by kernel "
        + json.dumps({k: round(v, 3) for k, v in prof_riders["kernel_ms"].items() if v}))
    say(f"[{card}] rider run phase budget: " + json.dumps(phases))
    say(f"[{card}] riderless run phase budget: " + json.dumps(base_phases))
    del sim
    # the plain twins: child processes during phases 32-33, checked there
    def rider_done(res):
        lc = res["lc"]
        check(res["equal"], f"phase 24: the rider run ({res['variant']}) differs from its "
                            f"plain=True run")
        check(res["variant"] != "goldfish"
              or (lc["updates_applied"] > 0 and lc["clients_synced"] > 0),
              f"phase 24: the {res['variant']} rider run's light clients adopted nothing: {lc}")
        say(f"phase 24 (run during phases 32-33): the {res['variant']} rider run == its "
            f"plain=True twin at {res['depth']} slots (metrics, summary, rider state, "
            f"light-client heads, digest; {lc['clients_synced']} light clients synced; "
            f"{res['plain_s']:.3f} s plain)")

    for variant, depth in RIDER_PLAIN_RUNS:
        deferred.append((rider_twin, (variant, depth), rider_done))
    half_sim = rider_sim(dev)
    half_sim.run_epochs(1)
    data = half_sim.checkpoint()
    del half_sim
    resumed = DenseSimulation.resume(data, device=dev)
    resumed.run_epochs(RIDER_EPOCHS)
    bad = [k for k, v in rider_record(resumed).items() if v != rec[k]]
    check(not bad, f"rider run: the resumed run differs from the uninterrupted one in {bad}")
    del resumed
    say(f"rider run: the Gasper run checkpointed after epoch 1 ({len(data)} bytes) and resumed "
        f"on the card == uninterrupted")

    lap("phase 24")
    # 25. K6 and K7 per launch at the path's shapes, against their bounds and
    # (in the printed lines only) beside the parent's times
    min_blocks = k6_chains_min_blocks()
    k6 = {}
    for name, words in k6_in.items():
        n, nb = words.shape[0], words.shape[1] // 16
        out = torch.empty((n, 8), dtype=torch.int32, device=dev)

        def raw(words=words, out=out, n=n, nb=nb):
            kernels.launch_on(dev, "sha256_blocks", words.data_ptr(), 16 * nb, nb,
                              out.data_ptr(), n)

        k6[name] = {"n": n, "blocks": nb, "ms": time_ms(raw, 20), "device_ms": device_ms(raw),
                    "wrapper_ms": time_ms(lambda w=words: sha256_blocks(w), 20),
                    "plain_ms": time_ms(lambda w=words: sha256_blocks(w, plain=True), 1),
                    "bound": k6_bound(n, nb),
                    "design": "chains" if n < cross and nb >= min_blocks else "one_thread"}
        r = k6[name]
        parent = K6_PARENT_MS[name]
        say(f"[{card}] K6 {name} ({n} x {nb} blocks, {r['design']}): kernel {r['ms']:.4f} ms, "
            f"device {fmt_ms(r['device_ms'])} (parent {parent[0]:.4f}-{parent[1]:.4f}), wrapper "
            f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound']['ms']:.4f} ms ({r['bound']['by']})")
    sweep = {}
    for nb, ns in K6_SWEEP.items():
        words = k6_in["backfill samples"] if nb == 33 else torch.from_numpy(
            rng.integers(-2**31, 2**31, (max(ns), 16 * nb), dtype=np.int64).astype(np.int32)
        ).to(dev)
        out = torch.empty((words.shape[0], 8), dtype=torch.int32, device=dev)
        for n in sorted({*ns, *((cross - 1, cross) if nb == 33 else ())}):
            row = {}
            for design, threads in K6_DESIGNS.items():
                def raw(n=n, nb=nb, threads=threads, words=words, out=out):
                    kernels.launch_on(dev, "sha256_blocks_design", words.data_ptr(),
                                      words.stride(0), nb, out.data_ptr(), n, threads)
                row[design] = device_ms(raw)
            sweep[f"{n}x{nb}"] = row
    say(f"[{card}] K6 designs about the crossover (chains below {cross} messages of at least "
        f"{min_blocks} blocks), device ms at messages x blocks: "
        + "; ".join(f"{k}: " + ", ".join(f"{d} {fmt_ms(t)}" for d, t in v.items())
                    for k, v in sweep.items()))
    k7 = {}
    for name, (a, b) in k7_in.items():
        ga, g, r_, k, w = K7_SHAPES[name]
        out = torch.empty((g, r_, w), dtype=torch.uint8, device=dev)

        def raw(a=a, b=b, out=out, ga=ga, g=g, r_=r_, k=k, w=w):
            kernels.launch_on(dev, "gf256_matmul", a.data_ptr(), r_ * k if ga > 1 else 0,
                              b.data_ptr(), k * w, out.data_ptr(), g, r_, k, w)

        k7[name] = {"ms": time_ms(raw, 20), "device_ms": device_ms(raw),
                    "wrapper_ms": time_ms(lambda a=a, b=b: das_verify.gf_matmul(a, b), 20),
                    "plain_ms": time_ms(lambda a=a, b=b: das_verify.gf_matmul(a, b, plain=True),
                                        2),
                    "bound": k7_bound(ga, g, r_, k, w)}
        r = k7[name]
        parent = K7_PARENT_MS[name]
        say(f"[{card}] K7 {name} ({ga}|{g}, {r_}, {k}) x ({g}, {k}, {w}): kernel "
            f"{r['ms']:.4f} ms, device {fmt_ms(r['device_ms'])} (parent "
            f"{parent[0]:.4f}-{parent[1]:.4f}), wrapper {r['wrapper_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms; tensor-core bound {r['bound']['ms']:.4f} ms "
            f"({r['bound']['by']}), share {100 * r['bound']['ms'] / r['device_ms']:.1f}%; the "
            f"former lookup bound {r['bound']['lookup_ms']:.4f} ms "
            f"({100 * r['bound']['lookup_ms'] / r['device_ms']:.1f}%)")
    untimed = [f"K6 {k}" for k, v in k6.items() if v["device_ms"] is None] + \
        [f"K7 {k}" for k, v in k7.items() if v["device_ms"] is None] + \
        [f"K6 sweep {k}" for k, v in sweep.items() if None in v.values()]
    check(not untimed, f"no device time (the CUDA graph timer failed) for {untimed}")
    if census is not None:
        for name in ("sha256_blocks", "sha256_blocks_chains", "gf256_matmul"):
            say(f"SASS {name} (whole kernel): {json.dumps(census[name]['total'])}")
        chains_sass = census["sha256_blocks_chains"]["total"]
        k7_sass = census["gf256_matmul"]["total"]
        check(k7_sass["IMMA"] + k7_sass["GMMA"] > 0,
              f"K7's SASS has no tensor-core MMA (IMMA or GMMA): {k7_sass}")
        check(chains_sass["LDGSTS"] > 0 and chains_sass["SYNCS"] > 0,
              f"K6's chains kernel has no cp.async or mbarrier in its SASS: {chains_sass}")
        for name, r in k6.items():
            units = r["n"] * r["blocks"]
            kernel = "sha256_blocks_chains" if r["design"] == "chains" else "sha256_blocks"
            b = sass_bounds(census[kernel]["total"], units)
            floor = k6_chain_floor_ms(r["blocks"])
            say(f"[{card}] {kernel} {name} at {units} blocks: measured device "
                f"{r['device_ms']:.4f} ms; bounds (the kernel's count taken as a block's) "
                + ", ".join(f"{k} {v:.4f}" for k, v in b.items())
                + f"; int_pipe / measured {b['int_pipe_ms'] / r['device_ms']:.3f}; round-chain "
                f"floor (one chain of {r['blocks']} blocks on one scheduler) {floor:.4f} ms, "
                f"measured / floor {r['device_ms'] / floor:.2f}")

    def shapes(d):
        return {k: {kk: v[kk] for kk in ("ms", "device_ms", "wrapper_ms", "plain_ms", "design")
                    if kk in v}
                | {"bound_ms": v["bound"]["ms"], "bound_by": v["bound"]["by"]}
                for k, v in d.items()}

    common = {"route": "cuda", "matches_plain": True, "library_ms": None,
              "rider_epoch_s": with_s, "riderless_epoch_s": without_s}
    return [
        {"name": "sha256_blocks", "source": K6_SOURCE, "replaces": K6_REPLACES,
         "launches": rider_launches["sha256_blocks"], "max_abs_err": k6_err,
         "shape": f"{K6_SHAPES[K6_MAIN][0]} x {k6[K6_MAIN]['blocks']} blocks",
         "ms": k6[K6_MAIN]["ms"], "device_ms": k6[K6_MAIN]["device_ms"],
         "wrapper_ms": k6[K6_MAIN]["wrapper_ms"], "plain_ms": k6[K6_MAIN]["plain_ms"],
         "bound_ms": k6[K6_MAIN]["bound"]["ms"], "bound_by": k6[K6_MAIN]["bound"]["by"],
         "launches_per_proposal": per_proposal["sha256_blocks"], "by_shape": shapes(k6),
         "designs_device_ms": sweep,
         "sync_verify_ms": sync_ms, "das_verify_crossover_ms": crossover, **common},
        {"name": "gf256_matmul", "source": K7_SOURCE, "replaces": K7_REPLACES,
         "launches": rider_launches["gf256_matmul"], "max_abs_err": k7_err,
         "shape": "({0}, {2}, {3}) x ({1}, {3}, {4})".format(*K7_SHAPES[K7_MAIN]),
         "ms": k7[K7_MAIN]["ms"], "device_ms": k7[K7_MAIN]["device_ms"],
         "wrapper_ms": k7[K7_MAIN]["wrapper_ms"], "plain_ms": k7[K7_MAIN]["plain_ms"],
         "bound_ms": k7[K7_MAIN]["bound"]["ms"], "bound_by": k7[K7_MAIN]["bound"]["by"],
         "launches_per_proposal": per_proposal["gf256_matmul"], "by_shape": shapes(k7),
         "reconstruct_9_blobs_ms": recon_ms, **common},
    ]


# --- the KZG slice (phases 26-31) ---------------------------------------------------

def kzg_rider_sim(dev, **kw) -> DenseSimulation:
    """The KZG slice's run: 2^20 validators, mainnet config with the
    PeerDAS geometry, 90 shuffle rounds, the kzg DAS rider and the light
    clients, under Gasper."""
    return DenseSimulation(N_MAINNET, mainnet_config().replace(**PEERDAS), device=dev,
                           shuffle_rounds=90, riders=[dense_rider_from_config(dict(d))
                                                      for d in KZG_RIDERS], **kw)


# K11's base-field products per group operation, as its programs run them
# (g1_msm.cu kProg): a doubling 5 squares and 2 products, an add 4 squares
# (Z1Z1, Z2Z2, H^2, r^2) and 12 products
K11_DOUBLE_PP = 5 * PP_MODSQR + 2 * PP_MODMUL
K11_ADD_PP = 4 * PP_MODSQR + 12 * PP_MODMUL


def k11_partial_products(scalars: torch.Tensor, n_blobs: int) -> int:
    """K11's 32x32-bit partial products for these scalars (this run's data):
    each lane from below its top bit, a doubling a bit and an add a further
    set bit, then the fold's n - 1 adds a blob; a square at the least a
    squaring needs (PP_MODSQR), as K3's ladders are counted."""
    s = fr.digits_to_ints(scalars)
    doublings = sum(max(x.bit_length() - 1, 0) for x in s)
    adds = sum(max(bin(x).count("1") - 1, 0) for x in s)
    folds = len(s) - n_blobs
    return doublings * K11_DOUBLE_PP + (adds + folds) * K11_ADD_PP


# the bucket route's group ops at their own cost (csrc/g1_bucket.cuh): a mixed
# add 3 squares (Z1Z1, H^2, r^2) and 8 products, a unified add 4 squares and 12
# products, a doubling 5 squares and 2 products
K11_MADD_PP = 3 * PP_MODSQR + 8 * PP_MODMUL
K11B_ADD_PP = 4 * PP_MODSQR + 12 * PP_MODMUL
K11_DBL_PP = 5 * PP_MODSQR + 2 * PP_MODMUL
FQ_WORDS_BYTES = 48                  # a base-field element as 12 words (the route's scratch)


def k11_bucket_work(stages: dict, tables) -> dict:
    """Each bucket launch's work for this run's data: (bytes each input read
    once and each output written once, 32x32-bit partial products), as
    csrc/g1_bucket.cu's code runs it. The fill's first entry of a run is a
    copy; a unified add with the zero point on either side is a copy (the
    tree's nodes over empty buckets); recode, scan and scatter do no
    products."""
    chunk = pairing.MSM_CHUNK
    start = stages["start"].cpu().numpy().astype(np.int64)
    g, nb = start.shape[0], start.shape[1] - 1
    w, k = stages["digits"].shape[1:]
    s, e = start[:, :-1], start[:, 1:]
    entries = int(start[:, -1].sum())
    nonempty = e > s
    runs = int((-(-start[:, -1] // chunk)).sum() + (nonempty & (s % chunk != 0)).sum())
    cont = np.where(nonempty, (e - 1) // chunk - s // chunk, 0)
    levels = nb.bit_length() - 1
    sub_log = min(nb, pairing.MSM_SUBTREE).bit_length() - 1
    tree_lo = tree_hi = 0                    # the tree's adds in totals, in reduce
    for blob in range(g):                    # a node point is zero iff its buckets are empty
        level = [[bool(x)] for x in nonempty[blob]]
        h = 0
        while len(level) > 1:
            nxt = []
            for lo, hi in zip(level[0::2], level[1::2]):
                adds = sum(a and b for a, b in zip(lo, hi))
                tree_lo, tree_hi = (tree_lo + adds, tree_hi) if h < sub_log else \
                    (tree_lo, tree_hi + adds)
                nxt.append([a or b for a, b in zip(lo, hi)] + [hi[0]])
            level = nxt
            h += 1
    chunks = -(-(w * k) // chunk)
    pt = 3 * FQ_BYTES
    sub_bytes = g * (nb >> sub_log) * (sub_log + 1) * 3 * FQ_WORDS_BYTES
    return {
        "g1_bucket_recode": (g * k * KZG_FR_BYTES + 4 * g * w * k + 4 * g * w * nb, 0),
        "g1_bucket_scan": (2 * 4 * g * w * nb + 4 * g * (nb + 1), 0),
        "g1_bucket_scatter": (4 * g * w * k + 4 * g * w * nb + 4 * entries, 0),
        "g1_bucket_fill": (4 * entries + (2 * FQ_BYTES + 1) * entries + 4 * g * (nb + 1)
                           + 3 * FQ_WORDS_BYTES * runs, (entries - runs) * K11_MADD_PP),
        "g1_bucket_totals": (3 * FQ_WORDS_BYTES * runs + 4 * g * (nb + 1) + g * nb * pt
                             + sub_bytes, (int(cont.sum()) + tree_lo) * K11B_ADD_PP),
        # the upper levels, then 2^k Q_k (k doublings each) and H adds of the halving tree
        "g1_bucket_reduce": (sub_bytes + g * pt,
                             (tree_hi + g * levels) * K11B_ADD_PP
                             + g * (levels * (levels - 1) // 2) * K11_DBL_PP),
        "chunks": chunks, "entries": entries, "runs": runs,
    }


def k10_partial_products(rows: int, n: int, inverse: bool) -> int:
    """K10's REDC partial products for one transform of ``rows`` x n: a
    twiddle product a butterfly a stage (and two scale products a butterfly
    of an inverse's last stage); a REDC is an 8x8 product, a 9x9 low product
    (45) and a 9x8 product (72)."""
    stages = n.bit_length() - 1
    per = KZG_PP_REDC * rows * (n // 2)
    return per * stages + (2 * per if inverse else 0)


def kzg_msm_case(rng, g: int, n: int, edges: bool):
    """(points [n, 2, 32], inf [n], scalars [g, n, 22], the oracle points and
    ints) of an MSM: random multiples of G; with ``edges``, a zero scalar,
    r - 1, an infinity lane, a lane repeated 32 apart (the fold's P = Q) and
    s, r - s on one point 32 apart (P = -Q)."""
    base = [oracle.ec_mul(oracle.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(8)]
    pts = [base[j % 8] for j in range(n)]
    ints = [[int.from_bytes(rng.bytes(32), "little") % fr.MODULUS for _ in range(n)]
            for _ in range(g)]
    if edges:
        pts[32], pts[33], pts[5] = pts[0], pts[1], None
        for s in ints:
            s[0] = s[32]
            s[1], s[33] = 12345, fr.MODULUS - 12345
            s[2], s[3] = 0, fr.MODULUS - 1
    enc, inf = pairing.g1_encode_points(pts)
    return enc, inf, torch.stack([fr.ints_to_digits(s) for s in ints]), pts, ints


BUCKET_STAGE_KEYS = ("digits", "offsets", "start", "entries", "totals", "total")


def bucket_plain_stages(tables, scalars) -> tuple:
    """K11's bucket route by its plain versions on the card, stage by stage:
    ({launch: plain seconds}, the stages by ``g1_msm_fixed``'s names)."""
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    with fp.plain_mode():
        dig, cnt = timed("g1_bucket_recode", lambda: pairing._recode_plain(scalars, tables.c))
        start, offsets = timed("g1_bucket_scan", lambda: pairing._scan_plain(cnt))
        ent = timed("g1_bucket_scatter",
                    lambda: pairing._scatter_plain(dig, tables.n, tables.buckets))
        part, bsum = timed("g1_bucket_fill", lambda: pairing._fill_plain(tables, ent, start))
        totals = timed("g1_bucket_totals", lambda: pairing._totals_plain(part, bsum, start))
        total = timed("g1_bucket_reduce", lambda: pairing._reduce_plain(totals))
    return secs, {"digits": dig, "offsets": offsets, "start": start, "entries": ent,
                  "totals": totals, "total": total}


def kzg_phases(dev, card: str, census) -> list:
    """Phases 26-31, the KZG slice: the setup on the card; K10 and K11
    against their plain versions at the commit path's shapes and edges; a
    PeerDAS commit batch against the plain path and one blob against the
    host oracle; a committee's aggregate proof and verdicts against the
    oracle pairing; the 2^20 dense run with the kzg DAS rider, counted, and
    its plain twin; K10 and K11 timed against their bounds. Returns the
    kernels line's K10 and K11 rows."""
    rng = np.random.default_rng(26)
    n = KZG_N
    scheme = KzgCellScheme(dev, cfg=mainnet_config().replace(**PEERDAS))
    check(scheme.geometry() == (2 * DAS_K, DAS_CELL // 16, n), f"geometry {scheme.geometry()}")

    # 26. the setup on the card against its plain version and the host oracle
    kzg_setup._DEVICE.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup = kzg_setup.device_setup(n, 0, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # the setup's ladder (its K11 launch) and affine pass against their plain
    # versions on the same lanes: every lane's point G, scalar tau^j
    t_scs = fr.ints_to_digits(kzg_setup._tau_powers(n, 0), dev)[None]
    gen = fp.const(pairing._G1_GEN, dev).expand(n, 2, fp.L)
    ginf = torch.zeros(n, dtype=torch.bool, device=dev)
    lanes = pairing.g1_msm_lanes(gen, ginf, t_scs)
    with fp.plain_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_lanes = pairing.g1_msm_lanes(gen, ginf, t_scs)    # the span of the ladder's ms
        torch.cuda.synchronize()
        ladder_plain_s = time.perf_counter() - t0
        aff, is_inf = pairing.g1_to_affine(plain_lanes[0])
        plain_points = fp.canon(aff)
    check(torch.equal(lanes, plain_lanes), "the setup's ladder differs from its plain version")
    check(torch.equal(setup.points, plain_points) and torch.equal(setup.inf, is_inf),
          "the setup differs from its plain version")
    del lanes, plain_lanes, plain_points
    host = kzg_setup.trusted_setup(KZG_HOST_POWERS, 0)
    check(pairing.g1_decode_points(setup.points[:KZG_HOST_POWERS], setup.inf[:KZG_HOST_POWERS])
          == list(host.powers_g1) and setup.g2_tau == host.g2_tau,
          "the setup's powers differ from the host trusted_setup")
    say(f"[{card}] setup of {n} powers on the card: {1e3 * setup_s:.3f} ms (one K11 launch, "
        f"the affine pass); its ladder's lanes and affine points == their plain versions "
        f"(the plain ladder {ladder_plain_s:.3f} s); the first {KZG_HOST_POWERS} powers == "
        f"the host trusted_setup")
    kzg_setup._TABLES.clear()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables = setup.window_tables()
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    c_win, w_win = tables.c, pairing.msm_windows(tables.c)
    check(kernels.launches["g1_bucket_tables"] == 1 and c_win == pairing.MSM_WINDOW,
          f"window tables: c = {c_win}, launches {kernels.launches['g1_bucket_tables']}")
    tables_bytes = tables.points.numel() * 4 + tables.inf.numel()
    spots = [(w, j) for w in (0, 1, w_win // 2, w_win - 1) for j in (0, 1, KZG_HOST_POWERS - 1)]
    check(all(pairing.g1_decode_points(tables.points[w, j], tables.inf[w, j])
              == [oracle.ec_mul(host.powers_g1[j], 1 << (c_win * w))] for w, j in spots),
          "the window tables differ from the oracle's 2^(c w) [tau^j]G")
    # the doubling launch at the path's shape, and the whole tables, against
    # the plain route (whose tables the plain twin of phase 30 reads)
    jac = pairing._tables_jac(setup.points, setup.inf)
    kdbl = torch.empty((w_win - 1, n, 3, fp.L), dtype=torch.int32, device=dev)
    kernels.launch_on(dev, "g1_bucket_tables", jac.data_ptr(), kdbl.data_ptr(), n, w_win - 1,
                      c_win)
    with fp.plain_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pdbl = pairing._double_windows_plain(jac, w_win - 1, c_win)   # the launch's span
        torch.cuda.synchronize()
        tables_plain_ms = 1e3 * (time.perf_counter() - t0)
        plain_tables = pairing._affine_tables(setup.points, setup.inf, pdbl, c_win)
    check(torch.equal(kdbl, pdbl), "the tables' doubling launch differs from its plain version")
    check(torch.equal(tables.points, plain_tables.points)
          and torch.equal(tables.inf, plain_tables.inf), "the tables differ from the plain route's")
    del jac, kdbl, pdbl
    say(f"[{card}] window tables of the {n} powers: c = {c_win}, W = {w_win}, "
        f"{tables_bytes} bytes on the card; built in {1e3 * tables_s:.3f} ms (one "
        f"g1_bucket_tables launch of {c_win * (w_win - 1)} doublings a power, the affine pass "
        f"by one batch inversion); the doublings ({n} x {w_win - 1} windows) and the tables == "
        f"the plain route's (its doublings {tables_plain_ms:.3f} ms); {len(spots)} spot entries "
        f"== the oracle's 2^(c w) [tau^j]G")

    # 27. K10 and K11 against their plain versions at the commit path's shapes
    grids = torch.from_numpy(rng.integers(0, 256, (DAS_BLOBS, 2 * DAS_K, DAS_CELL),
                                          dtype=np.uint8)).to(dev)
    evals = scheme._evaluations(grids)
    mont = fr.to_mont(evals)
    with fp.plain_mode():
        want = fr.to_mont(evals)
    check(torch.equal(mont, want), "K10 to_mont differs from its plain version")
    k10_err = digit_err(mont, want)
    for inverse in (True, False):
        got = ntt.ntt(mont, inverse)
        with fp.plain_mode():
            want = ntt.ntt(mont, inverse)
        torch.cuda.synchronize()
        k10_err = max(k10_err, digit_err(got, want))
        check(torch.equal(got, want), f"K10 transform (inverse={inverse}) differs from plain")
        if inverse:
            coeffs_mont = got
    coeffs = fr.from_mont(coeffs_mont)
    with fp.plain_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_coeffs = ntt.intt(mont)                  # the span of K10's ms: the INTT
        torch.cuda.synchronize()
        k10_plain_s = time.perf_counter() - t0
        plain_coeffs = fr.from_mont(plain_coeffs)
    check(torch.equal(coeffs, plain_coeffs), "K10's canonical pass differs from plain")
    edge_count = 0
    for g, m in ((3, 1), (3, 2), (2, 128), (1, 1024)):
        x = fr.to_mont(fr.ints_to_digits([int.from_bytes(rng.bytes(32), "little")
                                          for _ in range(g * m)], dev)).reshape(g, m, fr.L)
        for inverse in (False, True):
            got = ntt.ntt(x, inverse)
            with fp.plain_mode():
                check(torch.equal(got, ntt.ntt(x, inverse)), f"K10 at ({g}, {m}) differs")
            edge_count += 1
    edges = fr.ints_to_digits([0, 1, fr.MODULUS - 1], dev)
    edges = torch.cat([edges, torch.from_numpy(np.stack(
        [fr.to_limbs(v) for v in (fr.MODULUS, fr.MODULUS + 1, 2 * fr.MODULUS - 1)])
        .astype(np.int32)).to(dev)])
    for name, fn, args in (("mul", fr.mul, (edges, edges.flip(0))),
                           ("add", fr.add, (edges, edges.flip(0))),
                           ("sub", fr.sub, (edges, edges.flip(0))),
                           ("canon", fr.canon, (edges,)), ("inv", fr.inv, (edges,)),
                           ("from_mont", fr.from_mont, (edges,))):
        got = fn(*args)
        with fp.plain_mode():
            check(torch.equal(got, fn(*args)), f"K10 {name} differs on the edge values")
    say(f"K10 vs plain at ({DAS_BLOBS}, {n}): to_mont, the INTT and the NTT, the canonical "
        f"pass bit-equal; {edge_count} transforms at n in 1-1,024 and every elementwise op "
        f"on 0, 1, r-1, r, r+1, 2r-1 bit-equal")

    got = {}
    aff, inf = pairing.g1_msm_fixed(tables, coeffs, stages=got)
    torch.cuda.synchronize()
    plain_stage_s, want = bucket_plain_stages(tables, coeffs)
    k11_plain_s = sum(plain_stage_s.values())
    with fp.plain_mode():
        plain_aff, plain_inf = pairing.g1_to_affine(want["total"])
        plain_aff = fp.canon(plain_aff)
    k11_err = max(digit_err(got[k], want[k]) for k in BUCKET_STAGE_KEYS)
    for key in BUCKET_STAGE_KEYS:
        check(torch.equal(got[key], want[key]), f"K11's bucket {key} differ from the plain version")
    check(torch.equal(aff, plain_aff) and torch.equal(inf, plain_inf),
          "K11's bucket MSM differs from its plain version")
    bucket_stages = got
    say(f"K11's bucket route vs plain at {DAS_BLOBS} x {n} (the commit's scalars, c = "
        f"{c_win}): digits, window offsets, bucket starts, sorted entries, bucket sums, "
        f"blob sums and affine sums bit-equal ({int(got['start'][:, -1].sum())} entries; plain "
        + ", ".join(f"{k.replace('g1_bucket_', '')} {v:.3f} s" for k, v in plain_stage_s.items())
        + ")")
    # the edge lanes, over their own tables at the kernel's c and a small one
    enc, einf, scs, pts, ints = kzg_msm_case(rng, 2, 200, True)
    enc, einf, scs = enc.to(dev), einf.to(dev), scs.to(dev)
    # the tables' doubling launch against its plain version on the edge points
    # (infinity among them), 2 windows of c = 13
    ejac = pairing._tables_jac(enc, einf)
    edbl = torch.empty((2,) + ejac.shape, dtype=torch.int32, device=dev)
    kernels.launch_on(dev, "g1_bucket_tables", ejac.data_ptr(), edbl.data_ptr(),
                      ejac.shape[0], 2, pairing.MSM_WINDOW)
    with fp.plain_mode():
        pdbl = pairing._double_windows_plain(ejac, 2, pairing.MSM_WINDOW)
    check(torch.equal(edbl, pdbl), "the tables' doubling launch differs from its plain version")
    for c in (pairing.MSM_WINDOW, 5):
        etab = pairing.g1_window_tables(enc, einf, c)
        got, want = {}, {}
        a, i = pairing.g1_msm_fixed(etab, scs, stages=got)
        pairing.g1_msm_fixed(etab, scs, plain=True, stages=want)
        check(all(torch.equal(got[k], want[k]) for k in BUCKET_STAGE_KEYS),
              f"K11's bucket route on the edge lanes (c = {c}) differs from plain")
        check(pairing.g1_decode_points(a, i) == [curve.g1_lincomb(pts, s) for s in ints],
              f"K11's bucket route on the edge lanes (c = {c}) differs from the host Pippenger")
    # the prover's size: one blob of N - 1 scalars over the setup's tables
    pscs = coeffs[:1, 1:]
    got, want = {}, {}
    a, i = pairing.g1_msm_fixed(tables, pscs, stages=got)
    pa, pi = pairing.g1_msm_fixed(tables, pscs, plain=True, stages=want)
    check(all(torch.equal(got[k], want[k]) for k in BUCKET_STAGE_KEYS)
          and torch.equal(a, pa) and torch.equal(i, pi),
          f"K11's bucket route at the prover's 1 x {n - 1} differs from plain")
    # the ladder where its callers still run it: the edge lanes and the
    # verifier's fold over 10 points, each launched at its own shape and held
    # against one plain ladder over all their lanes (a lane depends on its own
    # point and scalar only)
    fpts, fscs = pts[:10], ints[0][:10]
    fenc, finf = pairing.g1_encode_points(fpts, dev)
    fdig = fr.ints_to_digits(fscs, dev)[None]
    lanes = pairing.g1_msm_lanes(enc, einf, scs)
    lanes_sum = pairing.g1_fold(lanes)
    a, i = pairing.g1_msm(fenc[None], finf[None], fdig)
    g_e, n_e = scs.shape[:2]
    with fp.plain_mode():
        want = pairing.g1_msm_lanes(torch.cat([enc] * g_e + [fenc]),
                                    torch.cat([einf] * g_e + [finf]),
                                    torch.cat([*scs, fdig[0]])[None])[0]
        check(torch.equal(lanes, want[:g_e * n_e].reshape(lanes.shape))
              and torch.equal(pairing.g1_fold(lanes), lanes_sum),
              "K11's ladder on the edge lanes differs from its plain version")
        pa, pi = pairing.g1_to_affine(pairing._fold_plain(want[None, g_e * n_e:]))
        pa = fp.canon(pa)
    check(torch.equal(a, pa) and torch.equal(i, pi)
          and pairing.g1_decode_points(a, i) == [curve.g1_lincomb(fpts, fscs)],
          "K11's ladder at the verifier's 10 points differs from plain or the host")
    a, i = pairing.g1_msm(enc, einf, scs)
    check(pairing.g1_decode_points(a, i) == [curve.g1_lincomb(pts, s) for s in ints],
          "K11's ladder on the edge lanes differs from the host Pippenger")
    say(f"K11's bucket route on the edge lanes (zero scalar, r-1, infinity, P = Q and P = -Q "
        f"in one bucket) at 2 x 200, c = {pairing.MSM_WINDOW} and 5: every stage bit-equal to "
        f"plain, == the host Pippenger; the tables' doublings (2 windows of "
        f"{pairing.MSM_WINDOW}) bit-equal to plain; at the prover's 1 x {n - 1}: bit-equal; "
        f"the ladder on the edge lanes and at the verifier's 10 points: bit-equal, == the host")

    # 28. the PeerDAS commit batch against the plain path and the host oracle
    wires = scheme.commit_batch(grids)
    torch.cuda.synchronize()
    plain_pts = pairing.g1_decode_points(plain_aff, plain_inf)
    plain_wires = [scheme.wire_bind(oracle.g1_compress(p)) for p in plain_pts]
    got_wires = [bytes(r) for r in words_to_rows(wires).cpu().numpy()]
    check(got_wires == plain_wires, "the commit batch differs from the plain path")
    entry = scheme.commit_entries(grids[:1])[0]
    cells = [int(v) for v in fr.digits_to_ints(evals[0])]
    host_coeffs = fr.decode(ntt.ntt_host(fr.encode(cells), inverse=True))
    check(list(entry.coeffs) == host_coeffs, "blob 0's coefficients differ from the host INTT")
    t0 = time.perf_counter()
    host_point = curve.g1_lincomb(setup.powers_g1(), host_coeffs)
    host_s = time.perf_counter() - t0
    check(entry.point == host_point and entry.wire == got_wires[0],
          "blob 0's commitment differs from the host oracle path")
    scheme._memo.clear()
    commit_ms = wall_ms(lambda: (scheme._memo.clear(), scheme.commit_batch(grids)), 3)
    say(f"[{card}] commit batch of {DAS_BLOBS} PeerDAS blobs: wires == the plain path's; "
        f"blob 0 == the host path (numpy INTT, Pippenger over the setup's powers, "
        f"{host_s:.3f} s); wall {', '.join(f'{x:.3f}' for x in commit_ms)} ms")

    # 29. a committee's aggregate proof over the 9 blobs, and its verdicts
    grids_np = list(grids.cpu().numpy())
    samples = sorted({(int(b), int(c)) for b, c in zip(rng.integers(0, DAS_BLOBS, 64),
                                                        rng.integers(0, 2 * DAS_K, 64))})
    samples = samples[:KZG_SAMPLES]
    t0 = time.perf_counter()
    proof = scheme.prove_aggregate(grids_np, samples)
    prove_s = time.perf_counter() - t0
    wire_list = [bytes(w) for w in got_wires]
    cells_s = [grids_np[b][c] for b, c in samples]
    forged = [c.copy() for c in cells_s]
    forged[len(forged) // 2][7] ^= 0x5A
    tampered = dict(proof)
    tampered["w"] = bytes(proof["points"][0])
    cases = {"honest": (wire_list, samples, cells_s, proof),
             "forged cell": (wire_list, samples, forged, proof),
             "tampered W": (wire_list, samples, cells_s, tampered),
             "wrong wire": ([wire_list[1], wire_list[0]] + wire_list[2:], samples, cells_s,
                            proof)}
    verdicts, verify_s = [], []
    for case in cases.values():
        t0 = time.perf_counter()
        verdicts.append(scheme.verify_aggregate(*case))
        verify_s.append(time.perf_counter() - t0)
    check(verdicts == [True, False, False, False],
          f"aggregate verdicts {dict(zip(cases, verdicts))}")
    n_cells, m, _n = scheme.geometry()
    oracle_verdicts = []
    for wires_c, samp, cells_c, pr in cases.values():
        claims = [(b, c, scheme.cell_values(cells_c[j])) for j, (b, c) in enumerate(samp)]
        got = kzg_aggregate._verify_host(n_cells, m, wires_c, claims, pr, scheme.wire_bind)
        if got is False:
            oracle_verdicts.append(False)
            continue
        f_pts, f_scs, wp = got
        lhs = curve.g1_lincomb(f_pts, f_scs)
        oracle_verdicts.append(oracle.pairings_equal([(lhs, setup.g2_one)],
                                                     [(wp, setup.g2_tau)]))
    check(oracle_verdicts == verdicts, f"verdicts {verdicts} vs oracle {oracle_verdicts}")
    say(f"[{card}] aggregate proof of {len(samples)} samples over {DAS_BLOBS} blobs "
        f"({scheme.proof_n_bytes(proof)} bytes): prove {prove_s:.3f} s; verify "
        + ", ".join(f"{k} {t:.3f} s" for k, t in zip(cases, verify_s)) + "; honest accepted, "
        f"forged cell, tampered W and wrong wire rejected, each == the oracle pairing")

    # 30. the dense run with the kzg DAS rider at 2^20, counted: the setup and
    # its window tables made anew in the run's set-up, as a fresh process does
    del grids, evals, mont, coeffs_mont, coeffs, plain_coeffs, tables, setup
    kzg_setup._DEVICE.clear()
    kzg_setup._TABLES.clear()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sim = kzg_rider_sim(dev, phase_profile=8)
    setup = kzg_setup.device_setup(n, 0, dev)
    tables = setup.window_tables()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim.run_epochs(KZG_RIDER_EPOCHS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    kzg_launches = dict(kernels.launches)
    rec = rider_record(sim)
    phases = sim.phases.summary()
    slots = sim.slot
    das, lc = rec["summary"]["workload"]["das"], rec["summary"]["workload"]["lightclient"]
    check(das["scheme"] == "kzg" and das["sidecar_failures"] == 0 and das["sample_misses"] == 0
          and das["sidecars_built"] == das["sidecars_verified"] == DAS_BLOBS * slots,
          f"kzg rider stats {das} after {slots} proposals")
    k10_launches = kzg_launches["fr_ntt"] + kzg_launches["fr_ew"]
    k11_launches = kzg_launches["g1_msm"] + kzg_launches["g1_fold"]
    k10_passes = len(ntt.passes(n))
    check(kzg_launches["fr_ntt"] == k10_passes * slots and kzg_launches["fr_ew"] == 2 * slots
          and all(kzg_launches[k] == slots for k in K11B_STAGES)
          and kzg_launches["g1_bucket_tables"] == 1 and kzg_launches["g1_msm"] == 1
          and kzg_launches["g1_fold"] == 0
          and kzg_launches["agg_sig"] == 2 * slots and kzg_launches["gf256_matmul"] == 2 * slots
          and kzg_launches["merkle_level"] == 0,
          f"kzg rider run launches {kzg_launches} over {slots} proposals")
    per_proposal = {k: v / slots for k, v in kzg_launches.items() if v}
    say(f"kzg rider run n={N_MAINNET}, {KZG_RIDER_EPOCHS} epochs ({slots} proposals; the setup's "
        f"ladder and its tables' doublings once in the set-up): launches {kzg_launches} (per "
        f"proposal {per_proposal}); das {das}; lightclient {lc}; digest {rec['digest']}")
    with_s = (t2 - t1) / KZG_RIDER_EPOCHS
    work = phases["phases"].get("workload", {})
    prof = profiled(lambda: sim.run_slot())
    by_func = {k: round(v, 3) for k, v in prof["kernel_ms"].items() if v}
    say(f"[{card}] dense path with the kzg rider: setup {t1 - t0:.3f} s (the powers and their "
        f"tables included), {with_s:.3f} s per simulated epoch; workload phase "
        f"{work.get('total_ms')} ms = {work.get('share_pct')}% of the run's wall; one more slot "
        f"under torch.profiler wall {prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms "
        f"({100 * prof['busy_ms'] / prof['wall_ms']:.2f}%), by kernel " + json.dumps(by_func))
    say(f"[{card}] kzg rider run phase budget: " + json.dumps(phases))
    del sim
    # the plain twin reads the plain route's tables (phase 26's, held equal to
    # the kernels' there), memoized apart from the kernels'
    plain_key = (n, 0, dev, c_win, True)
    kzg_setup._TABLES[plain_key] = plain_tables
    short = kzg_rider_sim(dev)
    short_p = kzg_rider_sim(dev, plain=True)
    t5 = time.perf_counter()
    short_p.run_slot()
    ref = rider_record(short_p)
    twin_s = time.perf_counter() - t5
    short.run_slot()
    check(rider_record(short) == ref, "the kzg rider run differs from its plain=True run")
    check(kzg_setup._TABLES.get(plain_key) is plain_tables
          and sum(1 for k in kzg_setup._TABLES if k[:4] == plain_key[:4]) == 2,
          "the plain twin did not read the plain route's tables")
    say(f"kzg rider run at 1 slot == its plain=True twin (metrics, summary, rider state, "
        f"light-client heads, digest; the twin on the plain route's tables; {twin_s:.3f} s "
        f"plain)")
    del short, short_p, plain_tables

    # 31. K10 and K11 at the path's shapes against their bounds
    grids = torch.from_numpy(rng.integers(0, 256, (DAS_BLOBS, 2 * DAS_K, DAS_CELL),
                                          dtype=np.uint8)).to(dev)
    evals = scheme._evaluations(grids)
    mont = fr.to_mont(evals)
    coeffs = fr.from_mont(ntt.intt(mont))
    tw, sc = ntt._tables(n, True, dev)
    words = torch.empty((DAS_BLOBS, n, 8), dtype=torch.int32, device=dev)
    k10_out = torch.empty_like(mont)

    def k10_raw():
        src = mont
        for i, (s0, s1) in enumerate(ntt.passes(n)):
            last = i == k10_passes - 1
            dst = k10_out if last else words
            kernels.launch_on(dev, "fr_ntt", src.data_ptr(), dst.data_ptr(), tw.data_ptr(),
                              sc.data_ptr(), DAS_BLOBS, n, s0, s1,
                              (1 if i == 0 else 0) | (6 if last else 0))
            src = dst

    k10_raw()
    check(torch.equal(k10_out, ntt.intt(mont)), "K10's raw passes differ from the wrapper")
    k10 = {"ms": time_ms(k10_raw, 20), "device_ms": device_ms(k10_raw),
           "wrapper_ms": time_ms(lambda: ntt.intt(mont), 20),
           "ew_ms": time_ms(lambda: fr.from_mont(mont), 20),
           "plain_ms": 1e3 * k10_plain_s}
    k10_bytes = 2 * DAS_BLOBS * n * KZG_FR_BYTES + (n - 1) * KZG_FR_BYTES
    k10_bound = field_bound(k10_bytes, k10_partial_products(DAS_BLOBS, n, True))
    say(f"[{card}] K10 INTT at {DAS_BLOBS} x {n}: {k10_passes} passes, kernel "
        f"{k10['ms']:.4f} ms, device {fmt_ms(k10['device_ms'])}, wrapper "
        f"{k10['wrapper_ms']:.4f} ms, plain {k10['plain_ms']:.3f} ms; bound "
        f"{k10_bound['ms']:.4f} ms ({k10_bound['by']}: {k10_bound['bytes']} bytes, "
        f"{k10_bound['partial_products']} partial products)"
        + (f", share {100 * k10_bound['ms'] / k10['device_ms']:.1f}%" if k10["device_ms"] else "")
        + f"; K10's canonical pass over {DAS_BLOBS} x {n}: {k10['ew_ms']:.4f} ms")

    # K11's bucket route: the six launches on preallocated buffers
    got = {}
    pairing.g1_msm_fixed(tables, coeffs, stages=got)
    work = k11_bucket_work(got, tables)
    g, w_k = DAS_BLOBS, w_win * n
    nb = tables.buckets
    buf = {"dig": torch.empty((g, w_win, n), dtype=torch.int32, device=dev),
           "off": torch.zeros((g, w_win, nb), dtype=torch.int32, device=dev),
           "start": torch.empty((g, nb + 1), dtype=torch.int32, device=dev),
           "ent": torch.zeros((g, w_k), dtype=torch.int32, device=dev),
           "part": torch.empty((g, work["chunks"], 3, 12), dtype=torch.int32, device=dev),
           "bsum": torch.empty((g, nb, 3, 12), dtype=torch.int32, device=dev),
           "totals": torch.empty((g, nb, 3, fp.L), dtype=torch.int32, device=dev),
           "sub": torch.empty((g, nb // pairing.MSM_SUBTREE,
                               pairing.MSM_SUBTREE.bit_length(), 3, 12),
                              dtype=torch.int32, device=dev),
           "scratch": torch.empty((2, g, nb // 2, 3, 12), dtype=torch.int32, device=dev),
           "total": torch.empty((g, 3, fp.L), dtype=torch.int32, device=dev)}
    p = {k: v.data_ptr() for k, v in buf.items()}
    launches = {
        "g1_bucket_recode": (coeffs.data_ptr(), p["dig"], p["off"], g, n, c_win),
        "g1_bucket_scan": (p["off"], p["start"], g, w_win, nb),
        "g1_bucket_scatter": (p["dig"], p["off"], p["ent"], g, n, n, c_win),
        "g1_bucket_fill": (tables.points.data_ptr(), tables.inf_u8.data_ptr(), p["ent"],
                           p["start"], p["part"], p["bsum"], g, w_k, nb),
        "g1_bucket_totals": (p["part"], p["bsum"], p["start"], p["totals"], p["sub"], g, w_k,
                             nb),
        "g1_bucket_reduce": (p["sub"], p["scratch"], p["total"], g, nb)}

    def k11_prepare():
        buf["off"].zero_()
        buf["ent"].zero_()

    def k11_raw():
        k11_prepare()
        for name, args in launches.items():
            kernels.launch_on(dev, name, *args)

    k11_raw()
    check(torch.equal(buf["total"], got["total"]) and torch.equal(buf["totals"], got["totals"]),
          "K11's raw bucket launches differ from the wrapper")
    k11 = {"ms": time_ms(k11_raw, 10), "device_ms": device_ms(k11_raw, 10),
           "wrapper_ms": time_ms(lambda: pairing.g1_msm_fixed(tables, coeffs), 10),
           "plain_ms": 1e3 * k11_plain_s}
    stage_ms = launch_event_ms(k11_prepare, launches, 5)
    k11_bytes = (DAS_BLOBS * n * KZG_FR_BYTES + work["entries"] * (2 * FQ_BYTES + 1)
                 + DAS_BLOBS * 3 * FQ_BYTES)
    k11_pp = sum(work[k][1] for k in K11B_STAGES)
    k11_bound = field_bound(k11_bytes, k11_pp)
    stage_bounds = {k: field_bound(*work[k]) for k in K11B_STAGES}
    # the ladder's bound on these scalars (the route the commit took before the
    # bucket route): a doubling a bit, an add a further set bit, the fold
    ladder_msm_bound = field_bound(
        n * (2 * FQ_BYTES + 1) + DAS_BLOBS * n * KZG_FR_BYTES + DAS_BLOBS * 3 * FQ_BYTES,
        k11_partial_products(coeffs, DAS_BLOBS))
    say(f"[{card}] K11 bucket MSM at {DAS_BLOBS} x {n} (c = {c_win}, {work['entries']} entries, "
        f"{work['runs']} runs): kernel {k11['ms']:.4f} ms, device {fmt_ms(k11['device_ms'])}, "
        f"wrapper {k11['wrapper_ms']:.4f} ms, plain {k11['plain_ms']:.3f} ms; bound "
        f"{k11_bound['ms']:.4f} ms ({k11_bound['by']}: {k11_bound['bytes']} bytes, "
        f"{k11_bound['partial_products']} partial products)"
        + (f", share {100 * k11_bound['ms'] / k11['device_ms']:.1f}%" if k11["device_ms"] else "")
        + f"; the ladder's bound on these scalars {ladder_msm_bound['ms']:.4f} ms "
        f"({ladder_msm_bound['by']})")
    for name in K11B_STAGES:
        b = stage_bounds[name]
        say(f"[{card}]   {name}: device {stage_ms[name]:.4f} ms (CUDA events, mean of 5), "
            f"plain {1e3 * plain_stage_s[name]:.3f} ms, bound {b['ms']:.5f} ms ({b['by']}: "
            f"{b['bytes']} bytes, {b['partial_products']} partial products)")
    # the tables' doublings, once a setup
    one = fp.const(fp.ONE, dev).expand(n, fp.L)
    jac = torch.cat([setup.points, one[:, None]], dim=1).contiguous()
    dbl = torch.empty((w_win - 1, n, 3, fp.L), dtype=torch.int32, device=dev)

    def tables_raw():
        kernels.launch_on(dev, "g1_bucket_tables", jac.data_ptr(), dbl.data_ptr(), n,
                          w_win - 1, c_win)

    tables_ms = time_ms(tables_raw, 3)
    tables_bound = field_bound(n * 3 * FQ_BYTES + (w_win - 1) * n * 3 * FQ_BYTES,
                               (w_win - 1) * c_win * n * K11_DBL_PP)
    say(f"[{card}] g1_bucket_tables at {n} powers x {w_win - 1} windows: {tables_ms:.4f} ms, "
        f"bound {tables_bound['ms']:.4f} ms ({tables_bound['by']}); its plain version "
        f"{tables_plain_ms:.3f} ms")
    # the ladder, where it still runs: the setup's 16,384 lanes (phase 26's inputs)
    ladder_ms = time_ms(lambda: pairing.g1_msm_lanes(gen, ginf, t_scs), 3)
    ladder_bound = field_bound(n * (2 * FQ_BYTES + 1) + n * KZG_FR_BYTES + n * 3 * FQ_BYTES,
                               k11_partial_products(t_scs, 1) - (n - 1) * K11_ADD_PP)
    say(f"[{card}] K11's ladder at the setup's {n} lanes: {ladder_ms:.4f} ms, bound "
        f"{ladder_bound['ms']:.4f} ms ({ladder_bound['by']}); its plain version "
        f"{ladder_plain_s:.3f} s")
    if census is not None:
        for key in ("fr_ntt", "fr_ew", "g1_msm", "g1_bucket_fill", "g1_bucket_reduce"):
            if key in census:
                say(f"SASS {key} (whole kernel): {json.dumps(census[key]['total'])}")
    common = {"route": "cuda", "matches_plain": True, "library_ms": None,
              "kzg_rider_epoch_s": with_s, "setup_ms": 1e3 * setup_s,
              "tables_build_ms": 1e3 * tables_s, "tables_bytes": tables_bytes,
              "commit_batch_ms": commit_ms, "prove_s": prove_s, "verify_s": verify_s[0]}
    rows = [
        {"name": "fr_ntt", "source": K10_SOURCE, "replaces": K10_REPLACES,
         "launches": k10_launches, "max_abs_err": k10_err,
         "shape": f"INTT ({DAS_BLOBS}, {n})", "ms": k10["ms"], "device_ms": k10["device_ms"],
         "wrapper_ms": k10["wrapper_ms"], "plain_ms": k10["plain_ms"],
         "bound_ms": k10_bound["ms"], "bound_by": k10_bound["by"],
         "canonical_pass_ms": k10["ew_ms"],
         "launches_per_proposal": k10_launches / slots, **common},
        {"name": "g1_msm", "source": K11_SOURCE, "replaces": K11_REPLACES,
         "launches": k11_launches, "max_abs_err": 0,
         "shape": f"ladder, the setup's {n} lanes", "ms": ladder_ms,
         "plain_ms": 1e3 * ladder_plain_s, "bound_ms": ladder_bound["ms"],
         "bound_by": ladder_bound["by"], "launches_per_proposal": 0.0, **common},
        {"name": "g1_bucket_tables", "source": K11B_SOURCE, "replaces": K11_REPLACES,
         "launches": kzg_launches["g1_bucket_tables"], "max_abs_err": 0,
         "shape": f"{n} powers x {w_win - 1} windows of {c_win} doublings", "ms": tables_ms,
         "plain_ms": tables_plain_ms, "bound_ms": tables_bound["ms"], "bound_by": tables_bound["by"], **common}]
    for name in K11B_STAGES:
        b = stage_bounds[name]
        rows.append({"name": name, "source": K11B_SOURCES.get(name, K11B_SOURCE),
                     "replaces": K11_REPLACES, "launches": kzg_launches[name],
                     "max_abs_err": k11_err, "shape": f"MSM {DAS_BLOBS} x {n}, c = {c_win}",
                     "ms": stage_ms[name], "plain_ms": 1e3 * plain_stage_s[name],
                     "bound_ms": b["ms"], "bound_by": b["by"],
                     "launches_per_proposal": kzg_launches[name] / slots,
                     "msm_ms": k11["ms"], "msm_device_ms": k11["device_ms"],
                     "msm_wrapper_ms": k11["wrapper_ms"], "msm_plain_ms": k11["plain_ms"],
                     "msm_bound_ms": k11_bound["ms"], "msm_bound_by": k11_bound["by"],
                     **common})
    return rows


# --- the spec tier (phases 32-34) ---------------------------------------------------

def spec_twin_chain(device: str) -> dict:
    """Phase 34's 4-epoch chain at 2^14 on ``device`` (a child process):
    the state root after every block, the finalized epoch, the wall."""
    t0 = time.perf_counter()
    run = spec_chain.run_chain(SPEC_TWIN_N, SPEC_TWIN_EPOCHS * 32, device=device)
    return {"roots": [r.hex() for r in run.roots], "final_root": run.summary["final_root"],
            "finalized": run.summary["finalized_epoch"], "s": time.perf_counter() - t0,
            "k2": run.summary["k2_launches"]}


def spread(xs) -> str:
    return f"{min(xs):.1f}-{max(xs):.1f} (mean {sum(xs) / len(xs):.1f})"


def spec_states_equal(a, b) -> list:
    """The columns in which two spec states differ."""
    bad = [f for f in SPEC_STATE_COLUMNS if not np.array_equal(getattr(a, f), getattr(b, f))]
    bad += [f for f in SPEC_REGISTRY_COLUMNS
            if not np.array_equal(getattr(a.validators, f), getattr(b.validators, f))]
    if not np.array_equal(a.justification_bits, b.justification_bits):
        bad.append("justification_bits")
    return bad


def spec_phases(dev, card: str, deferred: list, then=None) -> tuple:
    """Phases 32-34, and the earlier phases' ``deferred`` plain twins
    ((function, arguments, checker)) in child processes beside the spec
    chain, which leaves the card mostly idle; each checker takes its
    twin's result at the end. ``then`` = (fn, start): after phase 32, once
    every deferred job of ``fn`` has ended, ``start()`` is called. Returns
    the spec chain's launches by kernel and what ``start`` returned."""
    with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn"),
                             initializer=torch.set_num_threads, initargs=(2,)) as pool:
        twins = {d: pool.submit(spec_twin_chain, d) for d in ("cuda", "cpu")}
        futures = [(pool.submit(fn, *args), done) for fn, args, done in deferred]

        # 32. the spec chain at 2^20, counted
        kernels.reset_launches()
        run = spec_chain.run_chain(N_MAINNET, SPEC_SLOTS, device=dev, keep=(SPEC_REPLAY_FROM,))
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launches.items() if v}
        s = run.summary
        check(len(run.blocks) == SPEC_SLOTS and int(run.state.slot) == SPEC_SLOTS,
              f"spec chain: {len(run.blocks)} blocks, state at slot {int(run.state.slot)}")
        check(s["final_root"] == run.roots[-1].hex(),
              "spec chain: the final state's root differs from its last block's")
        check(s["attestations_per_block"] == [0] + [64] * (SPEC_SLOTS - 1),
              f"spec chain: attestations per block {s['attestations_per_block']}")
        check(s["epoch_sweeps"] == 2 and run.pre_epoch is not None,
              f"spec chain: the epoch boundary ran {s['epoch_sweeps']} torch-backend sweeps")
        check(launches.get("merkle_level", 0) >= s["state_roots"] > 0,
              f"spec chain: K2 launches {launches} for {s['state_roots']} state roots")
        check(launches.get("agg_sig") == SPEC_SLOTS and launches.get("sha256_blocks") == 1,
              f"spec chain: K1 once a slot and K6 once (the signers' midstates): {launches}")
        check(s["b8"]["sweeps"] == 2 * (SPEC_SLOTS - 1),
              f"spec chain: B8 swept {s['b8']['sweeps']} blocks")
        say(f"spec chain n={N_MAINNET}, {SPEC_SLOTS} blocks (64 attestations of 512 and a sync "
            f"aggregate each), every block accepted by state_transition(validate_result=True); "
            f"launches {launches}; {s['state_roots']} state roots, "
            f"{s['k2_launches_per_state_root']:.2f} K2 launches each; finalized epoch "
            f"{s['finalized_epoch']}; final root {s['final_root'][:16]}")
        started = None
        if then is not None:
            fn, start = then
            concurrent.futures.wait([f for (f, _), job in zip(futures, deferred) if job[0] is fn])
            started = start()
        say(f"[{card}] spec chain at n={N_MAINNET} (contended: beside phase 35's run and the "
            f"twins' pool): genesis {s['genesis_s']:.3f} s "
            f"({s['genesis_k2_launches']} K2 launches); per block build_block "
            f"{spread(s['build_ms'])} ms, state_transition {spread(s['transition_ms'])} ms "
            f"(the boundary block {s['transition_ms'][31]:.1f}), attesting (K1) "
            f"{spread(s['attest_ms'])} ms; B8 "
            f"{s['b8_ms_per_sweep']:.3f} ms a block over {s['b8']['sweeps']} sweeps (uploads "
            f"{s['b8']['uploads']}, patches {s['b8']['patches']}, reuses {s['b8']['reuses']})")

        # 33. the replay of the last blocks, across the epoch boundary, through a fresh store
        rep = spec_chain.replay(run, device=dev, start=SPEC_REPLAY_FROM)
        run.kept.clear()
        check(rep["blocks"] == SPEC_REPLAY_BLOCKS and rep["final_root"] == s["final_root"],
              f"replay: {rep['blocks']} blocks from block {SPEC_REPLAY_FROM}, the store's state "
              f"root differs from the chain's final root")
        check(rep["b8"]["sweeps"] == SPEC_REPLAY_BLOCKS,
              f"replay: B8 swept {rep['b8']['sweeps']}")
        say(f"[{card}] replay of blocks {SPEC_REPLAY_FROM + 1}-{SPEC_SLOTS} (across the epoch "
            f"boundary) through on_block_batch, anchored at block {SPEC_REPLAY_FROM} (contended): "
            f"{rep['seconds']:.3f} s, {rep['blocks_per_s']:.3f} blocks/s; root == the chain's "
            f"final root; B8 session uploads {rep['b8']['uploads']}, patches "
            f"{rep['b8']['patches']}, reuses {rep['b8']['reuses']}; K2 {rep['k2_launches']}")

        # 34. the twins
        post_card, epoch_ms = spec_chain.boundary(run.pre_epoch, device=dev)
        post_cpu, epoch_cpu_ms = spec_chain.boundary(run.pre_epoch, device="cpu")
        bad = spec_states_equal(post_card, post_cpu)
        check(not bad, f"the epoch boundary at 2^20: card differs from the CPU in {bad}")
        with use_backend("torch", device=dev):
            roots = {hash_tree_root(post_card), hash_tree_root(post_cpu)}
            check(len(roots) == 1, "the epoch boundary at 2^20: card and CPU roots differ")
            t0 = time.perf_counter()
            fresh = incremental.ContainerTreeCache(BeaconState, dev).root(run.state)
            fresh_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            plain = incremental.ContainerTreeCache(BeaconState, dev, plain=True).root(run.state)
            plain_s = time.perf_counter() - t0
        check(fresh.hex() == plain.hex() == s["final_root"],
              "the final state root from scratch (K2, plain) differs from the chain's")
        say(f"[{card}] process_epoch at n={N_MAINNET} (the first boundary again, contended): card "
            f"{epoch_ms:.3f} ms, "
            f"CPU backend {epoch_cpu_ms:.3f} ms; every registry and state column and the root "
            f"equal; the final root from scratch through K2 {fresh_s:.3f} s, through its plain "
            f"version {plain_s:.3f} s, both == the chain's")
        got = {d: f.result() for d, f in twins.items()}
        late = [(f.result(), done) for f, done in futures]
    check(got["cuda"]["roots"] == got["cpu"]["roots"],
          "the 4-epoch chain at 2^14: card and CPU roots differ")
    check(got["cuda"]["finalized"] == got["cpu"]["finalized"] >= 2,
          f"the 4-epoch chain at 2^14: finalized {got['cuda']['finalized']}")
    check(got["cuda"]["k2"] > 0 and got["cpu"]["k2"] == 0,
          "the 4-epoch chain at 2^14: K2 on the card only")
    say(f"4-epoch spec chain at n={SPEC_TWIN_N} ({SPEC_TWIN_EPOCHS * 32} blocks, child "
        f"processes): card ({got['cuda']['s']:.3f} s, {got['cuda']['k2']} K2 launches) == CPU "
        f"({got['cpu']['s']:.3f} s) at every block's state root; finalized epoch "
        f"{got['cuda']['finalized']}")
    for res, done in late:
        done(res)
    return launches, started


# --- the spec driver (phases 35-37) -------------------------------------------------

def driver_chaos():
    """Phase 36's faulted and adversarial run at DRIVER_TWIN_N: drops,
    duplicates and reorders, view group 1 down for slots 8-23 and back by
    checkpoint sync, an equivocator with 1/16 of the stake, the default
    monitors (their evidence broadcast as slashings)."""
    plan = FaultPlan(seed=5, drop_p=0.05, duplicate_p=0.05, reorder_p=0.05,
                     crashes=(CrashWindow(1, 8, 24),))
    return faulty_schedule(DRIVER_TWIN_N, plan, n_groups=2), \
        [Equivocator(set(range(DRIVER_TWIN_N // 16)))], default_monitors()


def driver_record(sim) -> dict:
    """What two spec-driver runs must agree on: every per-slot record, each
    view's final checkpoints, the monitors' violations and evidence."""
    acc = [m for m in sim.monitors if hasattr(m, "evidence")]
    return {"metrics": sim.metrics, "slot": sim.slot,
            "views": [(int(g.store.justified_checkpoint.epoch),
                       bytes(g.store.justified_checkpoint.root).hex(),
                       int(g.store.finalized_checkpoint.epoch), len(g.store.blocks),
                       sorted(g.store.equivocating_indices)) for g in sim.groups],
            "violations": [(v["monitor"], v["kind"], v["slot"]) for v in sim.monitor_violations],
            "evidence": [hash_tree_root(e).hex() for m in acc for e in m.evidence],
            "residents": [None if g.resident is None else
                          (g.resident.degraded, list(g.resident.incidents)) for g in sim.groups]}


def spec_rider_sim(device, resume: bytes | None = None):
    """Phase 36's rider twin on ``device`` under the active (PeerDAS)
    config: ``Simulation(DRIVER_TWIN_N, das=True)`` with the resident fork
    choice under ``lossy_plan(seed=13, drop_p=0.15)`` up to the first
    epoch's end, RIDER_TWIN_CLIENTS samplers and RIDER_TWIN_LCS light
    clients; or the checkpoint ``resume`` resumed, its samplers attached
    again (light clients are not simulation state)."""
    plan = lossy_plan(seed=13, drop_p=0.15, gst=32 * 12)
    schedule = faulty_schedule(DRIVER_TWIN_N, plan)
    if resume is not None:
        sim = Simulation.resume(resume, schedule=schedule, das=True, device=device)
    else:
        sim = Simulation(DRIVER_TWIN_N, schedule=schedule, accelerated_forkchoice=True,
                         das=True, device=device)
        for _ in range(RIDER_TWIN_LCS):
            sim.attach_light_client()
    sim.attach_das_clients(RIDER_TWIN_CLIENTS, seed=7)
    return sim


#: a served summary's fields that are wall-clock times or depend on the proof
#: cache's history (a resumed run's server starts cold)
SERVE_VOLATILE = ("p50_ms", "p95_ms", "verify_ms", "cache_hits", "cache_misses",
                  "cache_hit_rate")


def spec_rider_record(sim) -> dict:
    """What two rider runs must agree on beyond ``driver_record``: each
    view's verified blob keys, every served summary (its times aside),
    the server's counters, the refused sidecars, each view's imported
    blocks whose sidecars it does not hold (none: ``on_block`` gates on
    them), each light client's
    summary (its times aside), records and finalized root."""
    lcs = []
    for node in sim.light_clients:
        summary = node.summary()
        summary.pop("timing")
        lcs.append((summary, node.records, node.finalized_root().hex()))
    srv = sim.das_server
    return {"blob_keys": [sorted((r.hex(), i) for r, i in g.blob_store.sidecars)
                          for g in sim.groups],
            "unavailable": [sum(not g.blob_store.is_available(r, b)
                                for r, b in g.store.blocks.items()) for g in sim.groups],
            "served": [{k: v for k, v in x.items() if k not in SERVE_VOLATILE[:3]}
                       for x in sim.das_serves],
            "server": (srv.served_blocks, srv.samples_served, srv.scheme_builds,
                       srv.proof_cache.hits, srv.proof_cache.misses),
            "rejected": sim.meter.rejected_sidecars, "light_clients": lcs,
            "archived": sum(len(v) for v in sim.blob_archive.values()),
            "final_root": bytes(sim.groups[0].store.finalized_checkpoint.root).hex()}


def driver_run(kind: str, device: str) -> dict:
    """One of phase 36's runs on ``device`` (a child process during phases
    32-33): ``config1`` (BASELINE config 1,
    LMD-GHOST at 1,024 validators for 32 slots, every fresh head audited),
    ``chaos`` (``driver_chaos`` for 2 epochs, checkpointed after epoch 1;
    the checkpoint resumed with fresh adversaries and monitors and run to
    epoch 2 too), ``goldfish`` or ``ssf`` (256 validators, 1 epoch),
    ``riders`` (``spec_rider_sim``, its checkpoint resumed on the card) or
    ``kzg`` (phase 38's twin: the kzg rider at the minimal geometry)."""
    t0 = time.perf_counter()
    k2 = kernels.launches["merkle_level"]
    out = {}
    if kind == "config1":
        sim = Simulation(DRIVER_TWIN_N, accelerated_forkchoice=True, device=device)
        for g in sim.groups:
            g.resident.selfcheck_every = 1
        sim.run_until_slot(31)
        out["stats"] = dict(sim.groups[0].resident.stats)
        out["head_queries"] = len(sim.timer.samples["get_head"])
    elif kind == "riders":
        with use_config(mainnet_config().replace(**PEERDAS)):
            sim = spec_rider_sim(device)
            sim.run_until_slot(RIDER_TWIN_CKPT)
            data = sim.checkpoint()
            sim.run_until_slot(RIDER_TWIN_SLOTS)
            sim.flush_light_clients()
            out["riders"] = spec_rider_record(sim)
            if device != "cpu":
                back = spec_rider_sim(device, resume=data)
                back.run_until_slot(RIDER_TWIN_SLOTS)
                out["resumed"] = {**driver_record(back), "riders": spec_rider_record(back)}
            out["checkpoint"] = hashlib.sha256(data).hexdigest()
    elif kind == "kzg":
        with use_config(minimal_config()):
            sim = Simulation(KZG_TWIN_N, device=device, das=BlobEngine(
                minimal_config(), n_blobs=1, scheme="kzg", device=device))
            sim.attach_das_clients(KZG_DRIVER_CLIENTS)
            sim.run_until_slot(KZG_TWIN_SLOTS)
            out["riders"] = spec_rider_record(sim)
    elif kind == "chaos":
        schedule, adversaries, monitors = driver_chaos()
        sim = Simulation(DRIVER_TWIN_N, schedule=schedule, accelerated_forkchoice=True,
                         adversaries=adversaries, monitors=monitors, device=device)
        sim.run_epochs(1)
        data = sim.checkpoint()
        sim.run_epochs(2)
        schedule, adversaries, monitors = driver_chaos()
        back = Simulation.resume(data, schedule=schedule, adversaries=adversaries,
                                 monitors=monitors, device=device)
        back.run_epochs(2)
        out["resumed"] = driver_record(back)
        out["checkpoint"] = hashlib.sha256(data).hexdigest()
        out["checkpoint_bytes"] = len(data)
    else:
        variant = GoldfishVariant() if kind == "goldfish" else SsfVariant()
        sim = Simulation(DRIVER_VARIANT_N, variant=variant, device=device)
        sim.run_epochs(1)
        out["variant_state"] = json.dumps(variant.state_blob(sim), sort_keys=True, default=str)
    out.update(driver_record(sim), s=time.perf_counter() - t0, meter=sim.meter.launches,
               k2=kernels.launches["merkle_level"] - k2,
               devices=sorted({str(g.resident.buckets.device) for g in sim.groups
                               if g.resident is not None}))
    return out


def b9_inputs(dev):
    """Phase 37's operands at the path's shapes: a 65,536-row message table
    over 256 blocks, a 4,096-vote batch with duplicates (validators drawn
    from 1,500), inactive entries and votes for no block, and a tree."""
    rng = np.random.default_rng(37)
    n, nb, k = B9_ROWS, 256, B9_VOTES
    mb = rng.integers(-1, nb, n).astype(np.int32)
    me = np.where(mb >= 0, rng.integers(0, 6, n), 0).astype(np.int64)
    w = rng.integers(16, 33, n).astype(np.int64) * 10**9
    val = rng.integers(0, 1500, k).astype(np.int32)
    block = rng.integers(-1, nb, k).astype(np.int32)
    epoch = rng.integers(0, 8, k).astype(np.int64)
    active = rng.random(k) < 0.9
    parent = np.concatenate([[-1], rng.integers(np.maximum(np.arange(1, nb) - 4, 0),
                                                np.arange(1, nb))]).astype(np.int32)
    rank = rng.permutation(nb).astype(np.int32)
    viable = rng.random(nb) < 0.95
    host = [mb, me, w, val, block, epoch, active, w[val], parent, np.ones(nb, bool), rank,
            viable]
    return [torch.from_numpy(a).to(dev) for a in host]


def b9_all(t):
    """Every B9 function (and the head query from buckets) on ``b9_inputs``."""
    mb, me, w, val, block, epoch, active, wv, parent, real, rank, viable = t
    nb = parent.shape[0]
    buckets = ofc.rebuild_buckets(mb, w, nb)
    landed = ofc.apply_latest_messages(mb, me, buckets, val, block, epoch, wv, active)
    removed = ofc.remove_latest_messages(*landed, val[:64], wv[:64])
    cols = ofc.rebuild_epoch_buckets(mb, me, w, nb, 4, 2)
    windowed = ofc.apply_latest_messages_windowed(mb, me, cols, 2, val, block, epoch, wv, active)
    head = ofc.head_from_buckets(parent, real, rank, viable, 0, landed[2], 7, 32 * 10**9, nb)
    whead = ofc.head_from_epoch_buckets(parent, real, rank, viable, 0, windowed[2], 2, 4, -1, 0,
                                        nb, 4)
    return {"buckets": buckets, "landed": landed, "removed": removed, "epoch_buckets": cols,
            "windowed": windowed, "head": head, "windowed_head": whead}


def driver_twin_check(card: str, kind: str, got: dict, want: dict) -> None:
    """Phase 36 for one twin: the card's run ``got`` against the CPU's
    ``want`` (``driver_run``), and the kind's own checks."""
    keys = [k for k in want if k not in ("s", "k2", "devices", "meter")]
    bad = [k for k in keys if got[k] != want[k]]
    check(not bad, f"spec driver twin {kind}: the card differs from the CPU in {bad}")
    check(got["k2"] > 0 and want["k2"] == 0 and all(d.startswith("cuda")
                                                     for d in got["devices"]),
          f"spec driver twin {kind}: K2 {got['k2']} / {want['k2']}, residents on "
          f"{got['devices']}")
    for rec in (got, got.get("resumed")):
        if rec is not None:
            check(all(r is None or r == (False, []) for r in rec["residents"]),
                  f"spec driver twin {kind}: a resident store degraded: {rec['residents']}")
    extra = ""
    if kind == "config1":
        st = got["stats"]
        check(st["device_heads"] + st["memo_hits"] == got["head_queries"]
              and st["device_heads"] > 0, f"config 1: {st}, {got['head_queries']} queries")
        extra = (f"; {st['device_heads']} fresh head queries each audited by get_head_host, "
                 f"{st['memo_hits']} memo")
    if kind == "riders":
        resumed = got["resumed"]
        rbad = [k for k in ("metrics", "residents") if resumed[k] != got[k]]
        if [v[:4] for v in resumed["views"]] != [v[:4] for v in got["views"]]:
            rbad.append("views")
        r, rr = got["riders"], resumed["riders"]
        if rr["blob_keys"] != r["blob_keys"]:
            rbad.append("blob_keys")
        tail = r["served"][-len(rr["served"]):] if rr["served"] else []
        strip = lambda xs: [{k: v for k, v in x.items() if k not in SERVE_VOLATILE}  # noqa: E731
                            for x in xs]
        if not rr["served"] or strip(rr["served"]) != strip(tail):
            rbad.append("served")
        check(not rbad, f"riders: the resumed run differs from the uninterrupted in {rbad}")
        served = r["served"]
        check(r["rejected"] == 0 and r["unavailable"] == [0] * len(r["blob_keys"]),
              f"riders twin: {r['rejected']} sidecars refused, imported blocks without "
              f"their sidecars {r['unavailable']}")
        check(served and all(x["failed"] == 0 and x["clients_all_ok"] == RIDER_TWIN_CLIENTS
                             for x in served), "riders twin: a served block failed")
        check(all(lc[2] == r["final_root"] and lc[0]["rejected"] == 0
                  for lc in r["light_clients"]),
              "riders twin: a light client is off the full node's finalized root")
        extra = (f"; {r['archived']} sidecars built, {[len(k) for k in r['blob_keys']]} "
                 f"held (dropped ones pulled at import), none refused, every imported "
                 f"block available, "
                 f"{len(served)} blocks served with no failure, {RIDER_TWIN_LCS} light "
                 f"clients on the finalized root; the checkpoint after slot "
                 f"{RIDER_TWIN_CKPT} resumed on the card == the uninterrupted run in "
                 f"every record, view, blob key and its {len(rr['served'])} served blocks")
    if kind == "chaos":
        # Monitors are not simulation state (the JAX package's contract:
        # a stateful monitor replays exactly only from an episode-start
        # checkpoint), so the resumed run's fresh accountable-safety
        # monitor holds no vote seen before the checkpoint and can pair
        # fewer equivocations into slashings: the views' equivocator
        # sets may differ from the uninterrupted run's. Nothing else
        # may, and the resumed run equals the CPU's resumed run (above)
        # in everything; on the CPU the JAX package resumes such a
        # checkpoint to the port's record, equivocator sets included
        # (tests/test_torch_sim_driver.py).
        resumed = got["resumed"]
        rbad = [k for k in ("metrics", "residents") if resumed[k] != got[k]]
        if [v[:4] for v in resumed["views"]] != [v[:4] for v in got["views"]]:
            rbad.append("views")
        check(not rbad, f"chaos: the resumed run differs from the uninterrupted in {rbad}")
        check(got["evidence"] and all(v[4] for v in got["views"]),
              "chaos: no evidence reached a view's store")
        extra = (f"; {len(got['evidence'])} slashings of evidence, {len(got['violations'])} "
                 f"violations, equivocators in the views "
                 f"{[len(v[4]) for v in got['views']]}; the checkpoint after epoch 1 "
                 f"({got['checkpoint_bytes']} bytes, == the CPU's) resumed on the card == the "
                 f"CPU's resumed run, and == the uninterrupted run in every per-slot record "
                 f"and view checkpoint (equivocators {[len(v[4]) for v in resumed['views']]})")
    say(f"[{card}] spec driver twin {kind} (child processes during phases 32-33): card "
        f"{got['s']:.3f} s, {got['k2']} K2 launches == CPU ({want['s']:.3f} s) in every "
        f"per-slot record ({len(got['metrics'])}), view, "
        f"violation and piece of evidence; final {got['metrics'][-1]['head_root']} "
        f"justified {got['metrics'][-1]['justified_epoch']}{extra}")


def driver_scale_run() -> dict:
    """Phase 35's run, in a child process of its own beside phases 20-34
    (all host-bound and leaving the card mostly idle): the spec
    driver's path at 65,536 validators, mainnet config with the PeerDAS
    geometry, its riders attached, 4 epochs, its launch counts zeroed just
    before and read just after; the rider checks (``driver_riders_check``)
    and, after the run, a fresh head query and a flush under
    ``torch.profiler``. Returns the run's record."""
    dev = torch.device("cuda", 0)
    kernels.reset_launches()
    with use_config(mainnet_config().replace(**PEERDAS)):
        out = run_scale(DRIVER_N, DRIVER_EPOCHS, device=dev, das="merkle",
                        das_clients=DRIVER_DAS_CLIENTS, light_clients=DRIVER_LIGHT_CLIENTS,
                        serve=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launches.items() if v}
    sim = out.pop("sim")
    # the views' publication: every slot's best update (built or from the cache)
    out["serve_publish"] = {"calls": sim.meter.calls.get("serve_publish", 0),
                            "launches": sim.meter.launches.get("serve_publish", {})}
    out["riders"]["serves"] = sim.das_serves
    out["riders_ok"] = driver_riders_check(sim, out["riders"], launches)
    out["launches"] = launches
    out["slots"] = sim.slot - 1
    out["on_card"] = all(g.resident.buckets.device.type == "cuda" for g in sim.groups)
    res, store = sim.groups[0].resident, sim.groups[0].store
    with use_backend(sim.backend):
        def fresh():
            res._rev += 1
            res._device_head(store)
        out["head_prof"] = profiled_launches(fresh)
        rng = np.random.default_rng(35)
        tip = res.roots[-1]

        def flush():
            res.note_attestation(rng.integers(0, DRIVER_N, 2048), DRIVER_EPOCHS, tip)
            res.flush()
        out["flush_prof"] = profiled_launches(flush)
    out["capacity"] = res.capacity
    # 41 (a): the serving tier over this run's views, on the card, once released
    t0 = time.perf_counter()
    while not os.path.exists(SERVE_FRONT_GO):
        check(time.perf_counter() - t0 < 1200, "phase 41 (a): never released")
        time.sleep(0.1)
    out["serve_wait_s"] = time.perf_counter() - t0
    views = out.pop("serving_state").views
    check(len(views) == sim.slot and views[-1].sidecars,
          f"phase 41: {len(views)} views published in {sim.slot} slots")
    with use_config(mainnet_config().replace(**PEERDAS)):
        out["serve"] = serve_front_run(sim.das.scheme, views)
    return out


def driver_phases(dev, card: str, twins: dict, out: dict) -> dict:
    """Phases 35-37. ``twins`` holds phase 36's runs by (kind, device),
    made in child processes during phases 32-33; ``out`` phase 35's run
    (``driver_scale_run``). Returns phase 35's launches by kernel."""
    # 35. the spec driver's path at 65,536 validators, mainnet config with the PeerDAS
    # geometry, its riders attached, 4 epochs, counted (run beside phases 20-34)
    launches, riders_ok = out["launches"], out["riders_ok"]
    check(out["justified_epoch"] >= 3 and out["finalized_epoch"] >= 2,
          f"spec driver: justified {out['justified_epoch']}, finalized {out['finalized_epoch']}")
    check(out["resident_head_equals_spec_walk"] and out["resident_head_equals_host_walk"],
          "spec driver: the resident head differs from the spec walk or get_head_host")
    check(not any(out["degraded"]) and not any(out["incidents"]),
          f"spec driver: resident stores degraded {out['degraded']}: {out['incidents']}")
    check(launches.get("merkle_level", 0) >= out["state_roots"] > 0,
          f"spec driver: K2 launches {launches} for {out['state_roots']} state roots")
    st = out["resident_stats"][0]
    check(st["device_heads"] + st["memo_hits"] == out["head_queries"],
          f"spec driver: {st} against {out['head_queries']} head queries")
    check(out["on_card"], "spec driver: the resident store is not on the card")
    h = out["handler_timers_after_first_epoch"]
    say(f"spec driver n={DRIVER_N}, {DRIVER_EPOCHS} mainnet epochs ({out['slots']} slots, "
        f"{out['n_blocks']} blocks): launches {launches}; justified {out['justified_epoch']}, "
        f"finalized {out['finalized_epoch']}; resident head == get_head_host == the spec walk; "
        f"no resident store degraded; {out['state_roots']} state roots, "
        f"{out['k2_launches_per_state_root']:.2f} K2 launches each; head queries "
        f"{out['head_queries']} = {st['device_heads']} on the card + {st['memo_hits']} memo; "
        f"{st['flushes']} flushes, {st['rebuilds']} rebuilds; {riders_ok}")
    say(f"[{card}] spec driver at n={DRIVER_N} (contended: a child process beside phases "
        f"20-34 and the twins' pool; the driver's entry point alone gives the uncontended "
        f"numbers): set-up {out['init_s']:.3f} s; per epoch "
        + ", ".join(f"{x:.3f}" for x in out["per_epoch_s"])
        + f" s (mean {sum(out['per_epoch_s']) / DRIVER_EPOCHS:.3f}); after the first epoch "
        + "; ".join(f"{k} p50 {v['p50_ms']:.3f} ms p95 {v['p95_ms']:.3f} ms ({v['count']}, "
                    f"{v['total_s']:.3f} s)" for k, v in sorted(h.items())))
    driver_riders_report(card, out)
    head_prof, flush_prof = out["head_prof"], out["flush_prof"]
    say(f"[{card}] resident store at n={DRIVER_N}, capacity {out['capacity']}: a fresh head "
        f"query {head_prof['wall_ms']:.3f} ms, {head_prof['launches']:.0f} launches, device "
        f"busy {head_prof['busy_ms']:.3f} ms; a flush of 2,048 votes {flush_prof['wall_ms']:.3f} "
        f"ms, {flush_prof['launches']:.0f} launches, busy {flush_prof['busy_ms']:.3f} ms")
    lap("phase 35")

    # 36. the twins: the card against the CPU, and a checkpoint resumed (child processes)
    for kind in DRIVER_TWINS:
        driver_twin_check(card, kind, twins[(kind, "cuda")], twins[(kind, "cpu")])
    lap("phase 36")

    # 37. B9 on the card against the CPU at the path's shapes
    t_dev = b9_inputs(dev)
    got, want = b9_all(t_dev), b9_all(b9_inputs("cpu"))
    flat = lambda d: [x for v in d.values() for x in (v if isinstance(v, tuple) else (v,))]  # noqa: E731
    bad = [i for i, (a, b) in enumerate(zip(flat(got), flat(want))) if not torch.equal(a.cpu(), b)]
    check(not bad, f"B9 on the card differs from the CPU at outputs {bad}")
    mb, me, _w, val, block, epoch, active, wv = t_dev[:8]
    landed_ms = time_ms(lambda: ofc.apply_latest_messages(mb, me, got["buckets"], val, block,
                                                          epoch, wv, active), 20)
    window_ms = time_ms(lambda: ofc.apply_latest_messages_windowed(
        mb, me, got["epoch_buckets"], 2, val, block, epoch, wv, active), 20)
    say(f"[{card}] B9 at {B9_ROWS} rows, a batch of {B9_VOTES} votes with duplicates: every "
        f"output == the CPU's; apply_latest_messages {landed_ms:.3f} ms, the windowed twin "
        f"{window_ms:.3f} ms")
    lap("phase 37")
    return launches


def driver_riders_check(sim, r: dict, launches: dict) -> str:
    """Phase 35's rider checks: 9 sidecars built a proposal, every one
    accepted in every view and none refused; every served block verified
    with every one of the DRIVER_DAS_CLIENTS satisfied; after the flush,
    every light client on the full node's finalized checkpoint root with
    no update rejected; each rider phase's launches a call as
    RIDER_LAUNCHES counts them, and K1, K2, K6 and K7 launched. Returns a
    line for the log."""
    sc, srv, lc = r["sidecars"], r["das_server"], r["light_clients"]
    want = DAS_BLOBS * sc["proposals"]
    check(sc["proposals"] > 0 and sc["archived"] == want and sc["rejected"] == 0
          and sc["held"] == [want] * len(sim.groups),
          f"spec driver riders: sidecars {sc} for {sc['proposals']} proposals of {DAS_BLOBS}")
    check(srv["served_blocks"] == len(sim.das_serves) > 0 and srv["served_all_ok"]
          and all(x["clients_all_ok"] == DRIVER_DAS_CLIENTS for x in sim.das_serves),
          f"spec driver riders: a served block failed or left clients unsatisfied: {srv}")
    check(len(lc["summaries"]) == DRIVER_LIGHT_CLIENTS and all(lc["on_full_node_finalized_root"])
          and all(x["rejected"] == 0 and x["applied"] > 0 for x in lc["summaries"]),
          f"spec driver riders: light clients {lc['on_full_node_finalized_root']}, "
          f"{[x['rejected'] for x in lc['summaries']]} rejected")
    per = r["launches_per_call"]
    for phase, want_launches in RIDER_LAUNCHES.items():
        check(per.get(phase) == want_launches,
              f"spec driver riders: {phase} launches a call {per.get(phase)}, want {want_launches}")
    check(all(launches.get(k, 0) > 0 for k in ("agg_sig", "merkle_level", "sha256_blocks",
                                               "gf256_matmul")),
          f"spec driver riders: K1, K2, K6 or K7 not launched: {launches}")
    return (f"riders: {sc['proposals']} proposals x {DAS_BLOBS} sidecars, every one accepted, "
            f"none refused; {srv['served_blocks']} blocks served to {DRIVER_DAS_CLIENTS} "
            f"clients, none failed; {DRIVER_LIGHT_CLIENTS} light clients on the finalized root")


def driver_riders_report(card: str, out: dict) -> None:
    """Phase 35's rider measurements: seconds an epoch by rider phase and
    the riders' share, launches a call by phase, the sample serving's
    latencies, coalescing and verify ms, the handlers' and light clients'
    percentiles, the best update a fresh head."""
    r = out["riders"]
    split = " | ".join(", ".join(f"{k} {v:.3f}" for k, v in e.items())
                       for e in r["rider_s_per_epoch"])
    say(f"[{card}] spec driver riders, s per epoch by phase: {split}; riders' share "
        + ", ".join(f"{x:.3f}" for x in r["rider_share"])
        + f"; calls {json.dumps(r['phase_calls'])}; seconds "
        + json.dumps({k: round(v, 3) for k, v in r["phase_seconds"].items()}))
    say("spec driver riders, launches a call: " + json.dumps(
        {k: {n: round(v, 3) for n, v in d.items()} for k, d in r["launches_per_call"].items()}))
    srv, lc = r["das_server"], r["light_clients"]
    serves = r["serves"]
    say(f"[{card}] serve_samples over {len(serves)} served blocks: p50 "
        f"{spread([x['p50_ms'] for x in serves])} ms, p95 {spread([x['p95_ms'] for x in serves])} "
        f"ms, verify {spread([x['verify_ms'] for x in serves])} ms, coalescing "
        f"{spread([x['coalescing'] for x in serves])}; served {srv['served_blocks']} blocks, "
        f"{srv['samples_served']} samples, {srv['scheme_builds']} scheme builds, proof-cache hit "
        f"rate {srv['proof_cache_hit_rate']:.4f}; last {json.dumps(srv['last_serve'])}")
    timing = [x["timing"].get("process_light_client_update", {}) for x in lc["summaries"]]
    h = out["handler_timers_after_first_epoch"].get("on_blob_sidecar", {})
    say(f"[{card}] on_blob_sidecar after the first epoch p50 {h.get('p50_ms')} ms p95 "
        f"{h.get('p95_ms')} ms ({h.get('count')}); process_light_client_update p50 "
        f"{spread([t.get('p50_ms', 0) for t in timing])} ms, p95 "
        f"{spread([t.get('p95_ms', 0) for t in timing])} ms; best update "
        f"{lc['best_update_ms_per_fresh_head']:.3f} ms and "
        f"{lc['best_update_k2_per_fresh_head']:.2f} K2 launches a fresh head "
        f"({lc['fresh_heads']} heads); light clients "
        + json.dumps([{k: v for k, v in x.items() if k != "timing"} for x in lc["summaries"]]))


def kzg_card_run() -> dict:
    """Phase 38's run on the card, counted (a child process during phases
    32-33, its launch counts zeroed just before and read just after):
    KZG_DRIVER_N validators under the PeerDAS geometry,
    ``das=BlobEngine(scheme="kzg")``, KZG_DRIVER_CLIENTS samplers,
    KZG_DRIVER_SLOTS slots. Returns its record, launches, served
    summaries, launches a call and seconds by rider phase."""
    cfg = mainnet_config().replace(**PEERDAS)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with use_config(cfg):
        sim = Simulation(KZG_DRIVER_N, accelerated_forkchoice=True, device="cuda",
                         das=BlobEngine(cfg, scheme="kzg", device="cuda"), serve=True)
        sim.attach_das_clients(KZG_DRIVER_CLIENTS)
        sim.run_until_slot(KZG_DRIVER_SLOTS)
        torch.cuda.synchronize()
        out = {"s": time.perf_counter() - t0,
               "launches": {k: v for k, v in kernels.launches.items() if v},
               "record": spec_rider_record(sim), "served": sim.das_serves,
               "proposals": sim.meter.calls.get("blob_build", 0),
               "per_call": {k: sim.meter.per_call(k) for k in sim.meter.calls},
               "seconds": dict(sim.meter.seconds)}
        # 41 (c): a kzg front's das_aggregate proofs over the last view, on the card
        out["serve_kzg"] = serve_kzg_run(sim.das.scheme, sim.serving_state.current())
    return out


def kzg_driver_phase(card: str, twins: dict) -> dict:
    """Phase 38: the kzg rider on the card (``kzg_card_run``, run in a child
    process during phases 32-33) -- every sidecar accepted, every served
    block's aggregate proof verifying, K10 and K11 launched a proposal as
    phase 30 counts them; and its twin, the card against the CPU at the
    minimal geometry, run beside it. Returns the run's launches by
    kernel."""
    run = twins[("kzg", "run")]
    r, served, proposals, launches = (run["record"], run["served"], run["proposals"],
                                      run["launches"])
    check(proposals > 0 and r["archived"] == DAS_BLOBS * proposals and r["rejected"] == 0
          and all(len(k) == r["archived"] for k in r["blob_keys"]),
          f"kzg rider: {r['archived']} sidecars for {proposals} proposals, {r['rejected']} refused")
    check(served and all(x["aggregated"] and x["failed"] == 0
                         and x["clients_all_ok"] == KZG_DRIVER_CLIENTS for x in served),
          "kzg rider: an aggregate proof failed to verify")
    build = run["per_call"].get("blob_build", {})
    got = {k: build.get(k) for k in KZG_PROPOSAL_LAUNCHES}
    check(got == KZG_PROPOSAL_LAUNCHES,
          f"kzg rider: K10 and K11 launches a proposal {got}, want {KZG_PROPOSAL_LAUNCHES}")
    per = {k: {n: round(v, 3) for n, v in d.items()} for k, d in run["per_call"].items()}
    say(f"kzg rider n={KZG_DRIVER_N}, PeerDAS geometry, {KZG_DRIVER_SLOTS} slots (a child "
        f"process during phases 32-33): launches {launches}; {proposals} proposals x "
        f"{DAS_BLOBS} sidecars accepted; {len(served)} aggregate proofs served and verified "
        f"({served[-1]['proof_bytes']} bytes, {served[-1]['unique_requests']} cells); "
        f"launches a call {json.dumps(per)}")
    say(f"[{card}] kzg rider: {run['s']:.3f} s for {KZG_DRIVER_SLOTS} slots (beside phase 32); "
        "seconds by phase " + json.dumps({k: round(v, 3) for k, v in run["seconds"].items()})
        + f"; serve_samples verify {spread([x['verify_ms'] for x in served])} ms")
    got, want = twins[("kzg", "cuda")], twins[("kzg", "cpu")]
    keys = [k for k in want if k not in ("s", "k2", "devices", "meter")]
    bad = [k for k in keys if got[k] != want[k]]
    check(not bad, f"kzg rider twin: the card differs from the CPU in {bad}")
    tw = got["riders"]["served"]
    check(tw and all(x["aggregated"] and x["failed"] == 0 for x in tw),
          "kzg rider twin: an aggregate proof failed")
    say(f"[{card}] kzg rider twin at n={KZG_TWIN_N}, the minimal geometry, 1 blob, "
        f"{KZG_TWIN_SLOTS} slots (child processes during phases 32-33): card {got['s']:.3f} s "
        f"== CPU ({want['s']:.3f} s) in every per-slot record, blob key and served summary "
        f"({len(tw)} aggregate proofs verified)")
    return launches


# --- the serving tier (phase 41) ------------------------------------------------------

def _serve_requests(view, rng, method: str, n: int, k: int, blobs: int | None = None) -> list:
    """``n`` seeded requests of ``k`` samples each over ``view``'s roots (over
    the first ``blobs`` blobs of each, when given)."""
    roots = list(view.sidecars)
    out = []
    for _ in range(n):
        root = roots[int(rng.integers(len(roots)))]
        n_blobs = min(len(view.sidecars[root]), blobs or len(view.sidecars[root]))
        out.append((method, {"block_root": root.hex(),
                             "samples": [[int(rng.integers(n_blobs)),
                                          int(rng.integers(view.n_cells))] for _ in range(k)]}))
    return out


def _front_replies(view, scheme, requests, concurrent: bool) -> dict:
    """``requests`` against a fresh ``ServeFront`` of SERVE_THREADS threads on
    ``scheme`` over ``view`` (at once when ``concurrent``), the launch counts
    zeroed just before and read just after: the replies, each one's ms, the
    front's scheme builds and the launches."""
    from concurrent.futures import ThreadPoolExecutor
    state = ServingState()
    state.publish(view)
    front = ServeFront(state, scheme=scheme, workers=SERVE_THREADS)
    cli = ServeClient(front.start(), connections=16 if concurrent else 1, hedge_ms=None)

    def one(req):
        t0 = time.perf_counter()
        res = cli.request(req[0], req[1], deadline_s=120.0)
        return res, (time.perf_counter() - t0) * 1e3

    try:
        kernels.reset_launches()
        if concurrent:
            with ThreadPoolExecutor(16) as pool:
                got = list(pool.map(one, requests))
        else:
            got = [one(r) for r in requests]
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launches.items() if v}
        builds = front.summary()["scheme_builds"]
    finally:
        cli.close()
        front.stop()
    return {"replies": [(r.status, r.result, r.error) for r, _ in got],
            "ms": [ms for _, ms in got], "builds": builds, "launches": launches}


def serve_front_run(scheme, views) -> dict:
    """Phase 41 (a), in phase 35's child under its config: ``serve_demo.
    serve_views`` over the run's views on its merkle scheme (proofs built
    on the card), the launch counts zeroed just before and read just
    after; then SERVE_CHECKS seeded ``das_cells`` requests at once over 2
    blobs of each root of the last view, on a front on the card and on one
    on the plain scheme."""
    from pos_evolution_tpu_torch.config import cfg
    from pos_evolution_tpu_torch.serve_demo import serve_views
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = serve_views(views, scheme, arrivals=SERVE_ARRIVALS, rate=SERVE_RATE,
                      workers=SERVE_THREADS, seed=7, slo_ms=SERVE_SLO_MS, device="cuda")
    torch.cuda.synchronize()
    res["s"] = time.perf_counter() - t0
    res["launches"] = {k: v for k, v in kernels.launches.items() if v}
    res["views"] = len(views)
    # one backing build (a blob's 128 cells and branches to the host) alone, on
    # the card and on the plain scheme: the front's work a build, without the load
    grid = np.ascontiguousarray(next(iter(views[-1].sidecars.values()))[0].cells)
    cells = list(range(grid.shape[0]))
    res["build_ms"] = {plain: time_ms(lambda sch=get_scheme("merkle", "cuda", plain=plain,
                                                            cfg=cfg()): sch.branches(grid, cells),
                                      3 if plain else 10) for plain in (False, True)}
    # over 2 blobs of each root: 16 requests a (block, blob) at once, and a plain
    # build (~0.65 s) for each, on the path to the end of phase 35's wait
    requests = _serve_requests(views[-1], np.random.default_rng(41), "das_cells",
                               SERVE_CHECKS, SERVE_CHECK_SAMPLES, blobs=2)
    res["distinct_blobs"] = len({(p["block_root"], b) for _, p in requests
                                 for b, _ in p["samples"]})
    res["check"] = {plain: _front_replies(views[-1], get_scheme("merkle", "cuda", plain=plain,
                                                                cfg=cfg()), requests, True)
                    for plain in (False, True)}
    return res


def serve_kzg_run(scheme, view) -> dict:
    """Phase 41 (c), in phase 38's child under its config: a kzg front's
    SERVE_AGG_REQUESTS seeded ``das_aggregate`` replies over ``view`` (one
    after another, each timed), the launch counts zeroed just before and
    read just after; each proof then checked by ``scheme.verify_aggregate``
    on the card, timed."""
    requests = _serve_requests(view, np.random.default_rng(43), "das_aggregate",
                               SERVE_AGG_REQUESTS, SERVE_AGG_SAMPLES)
    out = _front_replies(view, scheme, requests, False)
    verdicts, verify_ms = [], []
    for status, result, _err in out["replies"]:
        if status != "ok":
            verdicts.append(False)
            continue
        t0 = time.perf_counter()
        proof = scheme.decode_proof([bytes.fromhex(x) for x in result["proof"]])
        verdicts.append(bool(scheme.verify_aggregate(
            [bytes.fromhex(x) for x in result["commitments"]],
            [(int(b), int(c)) for b, c in result["samples"]],
            [np.frombuffer(bytes.fromhex(c), dtype=np.uint8) for c in result["cells"]], proof)))
        torch.cuda.synchronize()
        verify_ms.append((time.perf_counter() - t0) * 1e3)
    out["verdicts"], out["verify_ms"] = verdicts, verify_ms
    out["proof_bytes"] = [scheme.proof_n_bytes(scheme.decode_proof(
        [bytes.fromhex(x) for x in r[1]["proof"]])) for r in out["replies"] if r[0] == "ok"]
    return out


def serve_mp_start():
    """Phase 41 (b), started in the background after phase 32 once phase 39's
    supervised runs have ended, beside phases 33, 34 and 40: ``python
    -m pos_evolution_tpu_torch.serve_demo --mp --mainnet`` at its defaults
    on the card, its workers started from the entry point's light main
    module, its output in files under ``build/serve_mp``: the emission, the
    events log, SERVE_TRACE_RATE of the requests traced (the span files
    under ``trace/``) and each phase's heartbeats and fleet snapshots
    (``run/``), for phase 42."""
    root = SERVE_MP_DIR
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    emitted, log = os.path.join(root, "emission.json"), os.path.join(root, "log.txt")
    with open(log, "w") as out:
        # a session of its own: if this run fails first, its exit stops the
        # demo, its forkserver and its workers together
        proc = subprocess.Popen(
            [sys.executable, "-m", "pos_evolution_tpu_torch.serve_demo", "--mp", "--mainnet",
             "--json", emitted, "--events", os.path.join(root, "events.jsonl"),
             "--trace-rate", str(SERVE_TRACE_RATE), "--trace-dir", os.path.join(root, "trace"),
             "--run-dir", os.path.join(root, "run")],
            stdout=out, stderr=subprocess.STDOUT, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)), start_new_session=True)
    atexit.register(_stop_session, proc)
    return proc, emitted, log, time.perf_counter()


def _stop_session(proc) -> None:
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def serve_mp_finish(started) -> dict:
    """Wait for phase 41 (b): its exit code, seconds, emission and log's tail."""
    proc, emitted, log, t0 = started
    rc = proc.wait(timeout=600)
    wall = time.perf_counter() - t0
    _stop_session(proc)     # any worker left behind
    with open(log) as f:
        tail = f.read()[-3000:]
    check(os.path.exists(emitted), f"serve_demo --mp: exit {rc}, no emission\n{tail}")
    with open(emitted) as f:
        emission = json.load(f)
    return {"rc": rc, "s": wall, "emission": emission, "log": tail}


def _contract(ok: bool) -> str:
    return "MET" if ok else "MISSED"


def serve_phase(card: str, front: dict, mp: dict, kzg: dict) -> dict:
    """Phase 41's checks and report: (a) the front over phase 35's views,
    (b) the multi-process plane, (c) the kzg front. Fails on any verify
    failure, a reply that differs from the plain scheme's, a build count or
    launch count off, an undetected kill or wedge, a stale respawn or an
    inconsistent fleet; prints the SLO and goodput contracts, met or
    missed. Returns the serving paths' launches by kernel."""
    # (a)
    steady, chaos, server = front["steady"], front["chaos"], front["server"]
    builds, launches = server["scheme_builds"], front["launches"]
    check(front["verify_failures"] == 0 and front["verified_proofs"] > 0,
          f"phase 41 (a): {front['verify_failures']} verify failures of "
          f"{front['verified_proofs']}")
    check(builds > 0 and launches == {k: v * builds for k, v in SERVE_BUILD_LAUNCHES.items()},
          f"phase 41 (a): launches {launches} for {builds} scheme builds")
    card_run, plain_run = front["check"][False], front["check"][True]
    check(all(r[0] == "ok" for r in card_run["replies"]),
          f"phase 41 (a): {[r[2] for r in card_run['replies'] if r[0] != 'ok'][:3]}")
    check(card_run["replies"] == plain_run["replies"],
          "phase 41 (a): das_cells replies on the card differ from the plain scheme's")
    check(card_run["builds"] == plain_run["builds"] == front["distinct_blobs"]
          and card_run["launches"] == {k: v * card_run["builds"]
                                       for k, v in SERVE_BUILD_LAUNCHES.items()}
          and plain_run["launches"] == {},
          f"phase 41 (a): {card_run['builds']} / {plain_run['builds']} builds for "
          f"{front['distinct_blobs']} (block, blob) pairs, launches {card_run['launches']}")
    s_int, c_int = steady["tiers"]["interactive"], chaos["tiers"]["interactive"]
    c_blk = chaos["tiers"]["bulk"]
    say(f"phase 41 (a): {front['views']} views of phase 35's run served by a front of "
        f"{SERVE_THREADS} threads on the card: {front['verified_proofs']} proofs verified, 0 "
        f"failures; {builds} scheme builds, launches {launches} (K6 1 and K2 7 a build); "
        f"{SERVE_CHECKS} das_cells requests of {SERVE_CHECK_SAMPLES} at once over 2 blobs of "
        f"each root of the last view == the plain scheme's byte for byte, "
        f"{card_run['builds']} builds for "
        f"{front['distinct_blobs']} (block, blob) pairs")
    say(f"[{card}] phase 41 (a) (phase 35's child, after phase 40 and 41 (b); "
        f"generator-bound: the load generator shares the front's interpreter, "
        f"{steady['late_dispatch'] + chaos['late_dispatch']} of {SERVE_ARRIVALS} arrivals "
        f"dispatched late): "
        f"{SERVE_ARRIVALS} arrivals at {SERVE_RATE:.0f}/s in {front['s']:.3f} s; steady "
        f"interactive p50 {s_int['p50_ms']} ms p99 {s_int['p99_ms']} ms p999 "
        f"{s_int['p999_ms']} ms goodput {s_int['goodput_pct']}% (SLO p99 <= {SERVE_SLO_MS} ms "
        f"{_contract(front['slo_ok'])}); chaos interactive p50 {c_int['p50_ms']} ms p99 "
        f"{c_int['p99_ms']} ms goodput {c_int['goodput_pct']}% (> 95% "
        f"{_contract(front['goodput_ok'])}), bulk goodput {c_blk['goodput_pct']}% shed "
        f"{c_blk['shed_pct']}%; shed share {server['shed_rate']}; hedges "
        f"{steady['hedges'] + chaos['hedges']}; single-flight waits "
        f"{server['singleflight']['waits']}; late dispatches {steady['late_dispatch']} + "
        f"{chaos['late_dispatch']}; the front's service EMA {server['service_ema_ms']} ms, "
        f"brownout transitions {server['brownout_transitions']}, shed by reason "
        f"{json.dumps(server['shed_by_reason'])}; a build alone {front['build_ms'][False]:.3f} "
        f"ms on the card, {front['build_ms'][True]:.3f} ms plain; the check's replies p50 "
        f"{np.percentile(card_run['ms'], 50):.3f} ms on the card, "
        f"{np.percentile(plain_run['ms'], 50):.3f} ms plain")
    # (b)
    em = mp["emission"]
    verdicts = em["verdicts"]
    for tag, v in verdicts.items():
        # every scheduled arrival recorded, at least one proof verified and
        # none failing in each phase; the throughput contracts are printed
        # below, met or missed
        check(v["records_match_schedule"] and v["integrity_ok"] and v["verify_failures"] == 0
              and (v["verified_proofs"] or 0) > 0,
              f"phase 41 (b): {tag} verdict {json.dumps(v)}")
        check(v["kills_detected"] and v["wedges_detected"]
              and v["respawned_on_current_generation"] and v["fleet_consistent"],
              f"phase 41 (b): {tag} supervision or fleet {json.dumps(v)}")
    check(verdicts["chaos"]["kills_delivered"] == 2 and verdicts["chaos"]["hang_interruptions"] >= 1,
          f"phase 41 (b): chaos {json.dumps(verdicts['chaos'])}")
    wl = em["kernel_launches"]
    check(wl["steady"] and wl["steady"].get("sha256_blocks", 0) > 0
          and wl["steady"] == {k: v * wl["steady"]["sha256_blocks"]
                               for k, v in SERVE_BUILD_LAUNCHES.items()}
          and wl["chaos"].get("sha256_blocks", 0) > 0
          and wl["chaos"].get("merkle_level", 0) > 0,
          f"phase 41 (b): the workers' launches {wl}")
    sv, cv = verdicts["steady"], verdicts["chaos"]
    say(f"phase 41 (b): serve_demo --mp --mainnet (exit {mp['rc']}, non-zero when a throughput "
        f"contract is missed): every arrival recorded; "
        f"{sv['verified_proofs'] + cv['verified_proofs']} proofs verified, 0 failures; chaos "
        f"{cv['kills_delivered']} kills detected as {cv['crash_interruptions']} crashes, "
        f"{cv['hang_interruptions']} hangs, {cv['restarts']} respawns, all live workers on the "
        f"board's generation; the fleet consistent; the workers' launches {json.dumps(wl)}")
    serving = em["serving"]
    say(f"[{card}] phase 41 (b) (contended: beside phases 33, 34 and 40): "
        f"{em['elapsed_s']:.3f} s "
        f"(collected {mp['s']:.3f} s after its start); the "
        f"pools ready after {json.dumps(em['pool_ready_s'])} s; steady "
        f"{em['arrivals'] - em['chaos']['arrivals']} at {em['rate']:.0f}/s interactive "
        f"{json.dumps(serving['steady'])} (goodput >= 99% {_contract(sv['goodput_ok'])}, p99 "
        f"<= {em['slo_ms']} ms {_contract(sv['slo_ok'])}); chaos {em['chaos']['arrivals']} at "
        f"{em['chaos']['rate']:.0f}/s interactive {json.dumps(serving['chaos_interactive'])} "
        f"(goodput {_contract(cv['goodput_ok'])}, p99 {_contract(cv['slo_ok'])}), bulk "
        f"{json.dumps(serving['chaos_bulk'])}, resends {serving['chaos_resends']}, lost "
        f"{serving['chaos_lost']}; proofs verified: steady {sv['verified_proofs']}, chaos "
        f"{cv['verified_proofs']}")
    # (c)
    check(kzg["replies"] and all(r[0] == "ok" for r in kzg["replies"]) and all(kzg["verdicts"]),
          f"phase 41 (c): kzg aggregate replies {[r[0] for r in kzg['replies']]}, verdicts "
          f"{kzg['verdicts']}")
    per = {k: v / SERVE_AGG_REQUESTS for k, v in kzg["launches"].items()}
    check(per == SERVE_PROOF_LAUNCHES,
          f"phase 41 (c): launches a proof {per}, want {SERVE_PROOF_LAUNCHES}")
    say(f"phase 41 (c): {SERVE_AGG_REQUESTS} das_aggregate proofs of {SERVE_AGG_SAMPLES} "
        f"samples from a kzg front on the card, each verifying through verify_aggregate "
        f"({kzg['proof_bytes']} bytes); launches a proof {json.dumps(per)}")
    say(f"[{card}] phase 41 (c) (contended: beside phases 32-33): ms a proof "
        + ", ".join(f"{x:.3f}" for x in kzg["ms"]) + "; verify ms "
        + ", ".join(f"{x:.3f}" for x in kzg["verify_ms"]))
    workers = {}
    for tag in ("steady", "chaos"):
        for k, v in (wl[tag] or {}).items():
            workers[k] = workers.get(k, 0) + v
    return {"front": launches, "workers": workers, "kzg": kzg["launches"]}


# --- the offline tooling (phase 42) -----------------------------------------------------

TOOLING_BUDGET_S = 15.0
# phase 41 (b)'s interactive goodput on earlier runs of this card (PERF.md §5), printed
# beside this run's
SERVE_MP_EARLIER_GOODPUT = {"steady": (82.8, 97.6), "chaos": (21.2, 95.0)}


def analysis_gate_start() -> list:
    """Phase 42 (e), started first and read last: the analysis gate of the
    port on this checkout (``--strict``) and its doctor, each in a process
    of its own (pure ``ast``: no torch, no card)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return [subprocess.Popen([sys.executable, "-m", "pos_evolution_tpu_torch.analysis", flag],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             cwd=here) for flag in ("--strict", "--doctor")]


def run_tool(main_fn, argv) -> tuple:
    """One of the port's offline tools, in this process: its exit code,
    standard output and standard error."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main_fn(argv)
    return rc, out.getvalue(), err.getvalue()


def report_of(events: str, name: str, *flags) -> tuple:
    """``run_report`` over ``events``: the report dict, its markdown and
    standard error."""
    os.makedirs(TOOLING_DIR, exist_ok=True)
    js, md = (os.path.join(TOOLING_DIR, f"{name}.{x}") for x in ("json", "md"))
    rc, _, err = run_tool(run_report.main, [events, "--json", js, "--markdown", md, *flags])
    check(rc == 0, f"phase 42: run_report {name} exited {rc}: {err[-2000:]}")
    with open(js) as f, open(md) as g:
        return json.load(f), g.read(), err


def tooling_phase(card: str, resilient: dict, spec_k2: int, mp: dict) -> None:
    """Phase 42: the port's offline tools over this run's own files, in this
    process, touching no device. (a) The run report over phase 39's
    supervised runs: the kill, the resume, goodput and replayed slots as the
    run emitted them, and the final attempt's checkpoint K2 launches as its
    records hold them; (b) over phase 40 (b)'s log: the top ops found through
    its profile_artifacts event, ``merkle_level_kernel`` with the events
    phase 40 held against the launch counter, and phase 40 (c)'s cost table;
    (c) over phase 41 (b)'s log: the multi-process Serving section equal to
    (b)'s emission, ``trace_merge`` one lane a process, ``obs_top --once`` a
    row for each worker; (d) ``perf_gate --count-only``: the dense run
    against itself passes, against a copy with its K2 launches doubled
    fails; (e) the analysis gate: ``--strict`` exits 0, ``--doctor`` 1."""
    t0 = time.perf_counter()
    gates = analysis_gate_start()
    # (a)
    for kind, r in resilient.items():
        c, em, res = RESIL[kind], r["emission"], r["result"]
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                            "resilient_run", kind)
        rep, md, _ = report_of(os.path.join(root, "events.jsonl"), f"resilient_{kind}")
        rs = rep.get("resilience") or {}
        gp = rs.get("goodput") or {}
        writes_k2 = sum(w["digest_launches"].get("merkle_level", 0)
                        for w in res["checkpoint_writes"])
        check([i.get("reason") for i in rs.get("interruptions", [])] == ["crash"]
              and [x.get("step") for x in rs.get("resumes", [])] == [c["resumed"]]
              and "interruptions: 1 — attempt 0: crash" in md
              and f"resumes: step {c['resumed']} -> slot" in md,
              f"phase 42 (a): {kind}'s report: interruptions {rs.get('interruptions')}, "
              f"resumes {rs.get('resumes')}")
        check(gp.get("goodput_pct") == em["goodput_pct"]
              and rs.get("replayed_slots") == gp.get("replayed_slots") == em["replayed_slots"]
              and gp.get("final_slot") == res["slot"],
              f"phase 42 (a): {kind}'s report: goodput {gp}, replayed {rs.get('replayed_slots')}; "
              f"the run's {em['goodput_pct']}% and {em['replayed_slots']}")
        check((rs.get("checkpoint_digest_launches") or {}).get("merkle_level") == writes_k2 > 0,
              f"phase 42 (a): {kind}'s report: checkpoint digest launches "
              f"{rs.get('checkpoint_digest_launches')}, the records' K2 {writes_k2}")
        say(f"phase 42 (a): run_report over resilient {kind}'s events: crash at attempt 0, "
            f"resumed at step {c['resumed']}, goodput {gp['goodput_pct']}% with "
            f"{gp['replayed_slots']} slots replayed == the run's; checkpoint digests "
            f"{writes_k2} K2 == its records")
    # (b)
    rep, md, err = report_of(PROFILE_EVENTS, "profile_spec", "--cost", COST_TABLE)
    found = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profile_spec",
                         "top_ops.json")
    k2 = {plane: rows.get("merkle_level_kernel")
          for plane, rows in (rep.get("top_device_kernels") or {}).items()}
    with open(COST_TABLE) as f:
        cost = json.load(f)
    check(f"auto-discovered top-ops table: {found}" in err
          and any((row or {}).get("count") == spec_k2 for row in k2.values()),
          f"phase 42 (b): top ops from {err.strip()}; merkle_level_kernel {k2}, phase 40 "
          f"held {spec_k2} events")
    check(rep.get("cost_analysis") == cost and cost["kernels"]
          and all(f"| {name} |" in md for name in cost["kernels"]),
          f"phase 42 (b): cost_analysis {sorted((rep.get('cost_analysis') or {}).get('kernels', {}))}")
    say(f"phase 42 (b): run_report over phase 40 (b)'s log: top ops found through its "
        f"profile_artifacts event; merkle_level_kernel {json.dumps(k2)} (phase 40: {spec_k2} "
        f"events); cost_analysis names {sorted(cost['kernels'])}")
    # (c)
    em = mp["emission"]
    rep, md, _ = report_of(os.path.join(SERVE_MP_DIR, "events.jsonl"), "serve_mp")
    s = rep.get("serving_mp") or {}
    got = {"steady": (s.get("steady") or {}).get("goodput_pct"),
           "chaos": (s.get("chaos") or {}).get("goodput_pct"),
           "verified": sum((s.get(p) or {}).get("verified_proofs") or 0
                           for p in ("steady", "chaos")),
           "kills": (s.get("interruptions_by_reason") or {}).get("crash", 0),
           "wedges": (s.get("interruptions_by_reason") or {}).get("hang", 0)}
    want = {"steady": em["serving"]["steady"]["goodput_pct"],
            "chaos": em["serving"]["chaos_interactive"]["goodput_pct"],
            "verified": em["serving"]["verified_proofs"],
            "kills": em["supervision"]["crash_interruptions"],
            "wedges": em["supervision"]["hang_interruptions"]}
    check(got == want, f"phase 42 (c): the report's Serving (multi-process) {got}, "
          f"(b)'s emission {want}")
    trace_dir = os.path.join(SERVE_MP_DIR, "trace")
    files = glob.glob(os.path.join(trace_dir, "spans.*.jsonl"))
    pids = {int(os.path.basename(f).split(".")[1]) for f in files}
    merged = os.path.join(TOOLING_DIR, "merged_trace.json")
    rc, out, err = run_tool(trace_merge.main, [trace_dir, "--out", merged,
                                               "--expect-pids", str(len(pids))])
    with open(merged) as f:
        lanes = [e["pid"] for e in json.load(f)["traceEvents"] if e.get("name") == "process_name"]
    check(rc == 0 and len(pids) > 1 and sorted(lanes) == sorted(pids),
          f"phase 42 (c): trace_merge exit {rc}, lanes {lanes} for span files of {sorted(pids)}: "
          f"{out}{err}")
    n_workers = em["workers"]
    rows = {}
    for phase in ("steady", "chaos"):
        rc, out, _ = run_tool(obs_top.main, ["--dir", os.path.join(SERVE_MP_DIR, "run", phase),
                                             "--once"])
        rows[phase] = (sorted({int(w) for w in re.findall(r"hb worker(\d+)\.hb", out)}),
                       sorted({int(w) for w in re.findall(r"\n  worker (\d+) ", out)}))
        check(rc == 0 and rows[phase] == (list(range(n_workers)),) * 2,
              f"phase 42 (c): obs_top --once over {phase}'s run dir: heartbeat and fleet rows "
              f"{rows[phase]} for {n_workers} workers:\n{out}")
    moved = {p: f"{got[p]}% against the earlier runs' {lo}-{hi}% "
                f"({'inside' if lo <= got[p] <= hi else 'outside'})"
             for p, (lo, hi) in SERVE_MP_EARLIER_GOODPUT.items()}
    say(f"phase 42 (c): run_report over (b)'s log == its emission {json.dumps(got)}; "
        f"trace_merge: {len(files)} span files, one lane a process ({len(lanes)}); obs_top "
        f"--once: a heartbeat and a fleet row for each of {n_workers} workers in both phases")
    say(f"[{card}] phase 41 (b) traced {SERVE_TRACE_RATE:.0%} of its requests: interactive "
        f"goodput steady {moved['steady']}, chaos {moved['chaos']}")
    # (d)
    emitted = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "resilient_run", "dense", "emission.json")
    key = "kernel_launches_total;kernel=merkle_level"
    base = resilient["dense"]["emission"]
    check(base["counts"].get(key, 0) > 0, f"phase 42 (d): the dense run's counts {base['counts']}")
    doubled = json.loads(json.dumps(base))
    doubled["counts"][key] *= 2
    doubled_path = os.path.join(TOOLING_DIR, "dense_emission_doubled.json")
    with open(doubled_path, "w") as f:
        json.dump(doubled, f)
    same = run_tool(perf_gate.main, ["--candidate", emitted, "--baseline", emitted, "--count-only"])
    worse = run_tool(perf_gate.main, ["--candidate", doubled_path, "--baseline", emitted,
                                      "--count-only"])
    check(same[0] == 0 and worse[0] == 1
          and f"[FAIL] {key}" in worse[1],
          f"phase 42 (d): perf_gate exits {same[0]} and {worse[0]}:\n{worse[1][-1500:]}")
    say(f"phase 42 (d): perf_gate --count-only on the dense supervised run's counts: against "
        f"themselves pass, with {key} doubled ({base['counts'][key]} -> {doubled['counts'][key]}) "
        f"fail")
    # (e)
    (strict, doctor), outs = gates, []
    for proc in gates:
        outs.append(proc.communicate(timeout=120)[0])
    check(strict.returncode == 0 and "0 new finding(s)" in outs[0],
          f"phase 42 (e): the analysis gate exited {strict.returncode}:\n{outs[0][-2000:]}")
    check(doctor.returncode == 1 and "doctor: all" in outs[1],
          f"phase 42 (e): the analysis doctor exited {doctor.returncode}:\n{outs[1][-2000:]}")
    say(f"phase 42 (e): the analysis gate on this checkout: {outs[0].strip().splitlines()[-1]} "
        f"(exit 0); --doctor exit 1")
    secs = time.perf_counter() - t0
    say(f"[{card}] phase 42 (the offline tooling over this run's files): {secs:.3f} s")
    check(secs <= TOOLING_BUDGET_S, f"phase 42 took {secs:.3f} s, over {TOOLING_BUDGET_S} s")


def resilient_kind(kind: str) -> dict:
    """One of phase 39's supervised runs, in a child process during phases
    32-33 (``python -m
    pos_evolution_tpu_torch.resilient_run`` on the card, its store under
    ``build/``), then its uninterrupted twin in this process: the run's
    result, emission and events; the twin's digest, its seconds and K2
    launches of ``state_digest``, and (dense) its flight recorder; the final
    step's manifest hex against K2 and K2's plain version on the card."""
    c = RESIL[kind]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "resilient_run", kind)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    store, events, emitted = (os.path.join(root, x) for x in ("store", "events.jsonl",
                                                               "emission.json"))
    argv = [sys.executable, "-m", "pos_evolution_tpu_torch.resilient_run",
            "--validators", str(c["n"]), "--config", "mainnet", "--epochs", str(c["epochs"]),
            "--every", str(c["every"]), "--crash-at-slot", str(c["crash"]),
            "--ckpt-dir", store, "--events", events, "--json", emitted]
    if kind == "dense":
        argv.insert(3, "--dense")
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"resilient_run {kind}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    with open(os.path.join(store, "result.json")) as f:
        result = json.load(f)
    with open(emitted) as f:
        emission = json.load(f)
    with open(events) as f:
        evs = [json.loads(line) for line in f]
    final = os.path.join(store, f"step_{c['final']:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(final, "payload.bin"), "rb") as f:
        payload = f.read()
    with kernels.thread_launches() as counted:
        k2_hex = merkle_device.digest_bytes(payload, "cuda").hex()
    plain_hex = merkle_device.digest_bytes(payload, "cuda", plain=True).hex()
    out = {"result": result, "emission": emission, "events": evs, "wall_s": wall,
           "final": {"manifest": manifest["files"]["payload.bin"], "k2_hex": k2_hex,
                     "plain_hex": plain_hex, "launches": counted, "bytes": len(payload)}}
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    if kind == "dense":
        tel = Telemetry()
        fr = FlightRecorder(tel, sample_every=8)
        sim = DenseSimulation(c["n"], mainnet_config(), device=dev, verify_aggregates=False,
                              check_walk_every=8, flight_recorder=fr)
        t1 = time.perf_counter()
        while sim.slot < c["epochs"] * sim.S:
            sim.run_slot()
        torch.cuda.synchronize()
        out["twin_loop_s"] = time.perf_counter() - t1
        out["twin_epoch_s"] = out["twin_loop_s"] / c["epochs"]
        out["flight"] = fr.summary()["memory"]
    else:
        with use_config(mainnet_config()):
            sim = Simulation(c["n"], device=dev)
            sim.run_until_slot(c["epochs"] * 32)
    torch.cuda.synchronize()
    out["twin_s"] = time.perf_counter() - t0
    k2 = kernels.launches["merkle_level"]
    out["twin_digest"] = state_digest(sim)
    out["twin_digest_k2"] = kernels.launches["merkle_level"] - k2
    return out


def k2_levels(nbytes: int) -> int:
    """K2 launches of a merkle payload digest: one a tree level over the
    payload's 32-byte chunks."""
    return max(math.ceil(math.log2(max(-(-nbytes // 32), 1))), 0)


def resilient_phase(card: str, runs: dict) -> None:
    """Phase 39: each supervised run ends on its twin's digest, with the
    events of one kill and one resume; every checkpoint digest is K2's, one
    launch a level, counted; the per-checkpoint numbers printed."""
    for kind, r in runs.items():
        c, res, em, evs = RESIL[kind], r["result"], r["emission"], r["events"]
        check(res["state_digest"] == r["twin_digest"],
              f"resilient {kind}: the killed and resumed run's digest differs from its twin's")
        check(res["slot"] == c["final"] and res["digest"] == "merkle" and res["device"] == "cuda",
              f"resilient {kind}: ended at slot {res['slot']}, digest {res['digest']}")
        types = [e["type"] for e in evs]
        saved = [e["step"] for e in evs if e["type"] == "checkpoint_saved"]
        resumed = [e["step"] for e in evs if e["type"] == "run_resumed"]
        finals = [e["slot"] for e in evs if e["type"] == "checkpoint_final"]
        check(types.count("supervisor_interruption") == 1 and em["attempts"] == 2
              and resumed == [c["resumed"]] and c["resumed"] in saved
              and finals == [c["final"]] and types[-1] == "goodput",
              f"resilient {kind}: events {sorted(set(types))}, saved {saved}, "
              f"resumed {resumed}, final {finals}")
        writes, ticks, resume = res["checkpoint_writes"], res["checkpoint_ticks"], res["resume"]
        for w in [*writes, *resume["verify"]]:
            check(w["digest"] == "merkle"
                  and w["digest_launches"] == {"merkle_level": k2_levels(w["bytes"])},
                  f"resilient {kind}: step {w['step']}'s digest launched "
                  f"{w['digest_launches']} for {w['bytes']} bytes")
        fin = r["final"]
        check(fin["manifest"]["merkle"] == fin["k2_hex"] == fin["plain_hex"]
              and fin["launches"] == {"merkle_level": k2_levels(fin["bytes"])},
              f"resilient {kind}: the final step's digest: manifest, K2 and plain differ")
        digest_k2 = sum(w["digest_launches"]["merkle_level"] for w in writes)
        k2_all = res["launches"].get("merkle_level", 0)
        if kind == "dense":
            # the resumed attempt launches K2 for the digests alone (writes, the
            # resume's re-check, the closing state_digest), K6 for the midstates
            check(k2_all == digest_k2 + resume["k2_launches"] + r["twin_digest_k2"]
                  and res["launches"].get("sha256_blocks", 0) >= 1,
                  f"resilient dense: launches {res['launches']}, digests {digest_k2}, "
                  f"re-check {resume['k2_launches']}, state_digest {r['twin_digest_k2']}")
        else:
            check(k2_all > digest_k2 + resume["k2_launches"] > 0,
                  f"resilient spec: K2 {k2_all} for digests {digest_k2}")
        first = [e for e in evs if e["type"] == "checkpoint_saved" and e["step"] == c["resumed"]]
        # the writes in the order they were made: one a tick, then finish()'s
        # final save, which waits (it may re-save the step a tick just wrote)
        check(len(writes) == len(ticks) + 1
              and [w["step"] for w in writes[:-1]] == [t["step"] for t in ticks]
              and writes[-1]["step"] == c["final"],
              f"resilient {kind}: writes {[w['step'] for w in writes]} against ticks "
              f"{[t['step'] for t in ticks]} and the final step {c['final']}")
        rows = [f"step {w['step']}{'' if t else ' final (waits)'}: raw "
                f"{(t or res['final_capture']).get('raw_bytes') or 'n/a'} B, compressed "
                f"{w['bytes']} B, loop blocked {t['blocked_ms'] if t else 'n/a'} ms, writer "
                f"{w['write_ms']} ms, digest {w['digest_ms']} ms / "
                f"{w['digest_launches']['merkle_level']} K2"
                for w, t in zip(writes, [*ticks, None])]
        ckpt = res["checkpoint"]
        say(f"resilient {kind} n={c['n']}: killed after slot {c['crash']}, resumed from step "
            f"{c['resumed']} (attempts {em['attempts']}), ended at slot {res['slot']} with the "
            f"twin's digest {res['state_digest'][:16]}; launches of the resumed attempt "
            f"{res['launches']}; checkpoint digests K2 one a level, counted; the final step's "
            f"hex == K2's plain version on the card")
        say(f"[{card}] resilient {kind}: step {c['resumed']} (first attempt) loop blocked "
            f"{first[0]['blocked_ms'] if first else 'n/a'} ms; " + "; ".join(rows)
            + f"; resume: load {resume['load_s']} s (its K2 re-check "
            f"{resume['verify'][0]['digest_ms']} ms, {resume['k2_launches']} K2), kill to the "
            f"first resumed slot {resume.get('kill_to_first_slot_s')} s; goodput "
            f"{em['goodput_pct']}% ({em['replayed_slots']} slots replayed); loop blocked "
            f"{ckpt['loop_blocked_s']} s, writer {ckpt['background_s']} s of the resumed "
            f"attempt's {res['run_wall_s']} s ({em['ckpt_overhead_pct']}%); supervised wall "
            f"{r['wall_s']:.3f} s, the twin {r['twin_s']:.3f} s")
        if kind == "dense":
            f = r["flight"]
            say(f"[{card}] resilient dense twin: {r['twin_epoch_s']:.3f} s per epoch; flight "
                f"recorder peak allocated {f['allocator_peak_bytes']} B (samples "
                f"{f['samples']}, source {f['source']}); loop blocked a checkpoint "
                f"{max((t['blocked_ms'] for t in ticks), default=0)} ms against an epoch's "
                f"{r['twin_epoch_s'] * 1e3:.1f} ms")


def device_ops(planes, needle: str = "") -> list:
    """(op path, ms) of each device event of a trace's planes whose op
    path holds ``needle``."""
    chosen = [p for p in planes if xplane.is_device_plane(p["name"])]
    return [(op, dur / 1e9) for _, _, op, _, dur in xplane.iter_ops(chosen) if needle in op]


def only_ops(planes, needle: str) -> list:
    """The device planes with only the events whose op path holds ``needle``."""
    out = []
    for p in planes:
        if not xplane.is_device_plane(p["name"]):
            continue
        meta = p["event_metadata"]
        out.append({**p, "lines": [{**line, "events": [
            e for e in line["events"] if needle in meta[e["metadata_id"]]]}
            for line in p["lines"]]})
    return out


def profile_dense_region(sim, card: str) -> dict:
    """Phase 40 (a): ``PROFILE_SLOTS`` slots of ``sim`` (phase 10's dense run
    at 2^20) unprofiled, then as many under ``ProfiledRegion("dense")``: no
    error; the attribution a partition of the device total (0.01 ms a row);
    one ``agg_sig_kernel`` event a K1 launch, every one on a path through its
    phase's range and credited to it, not to ``unattributed`` or the
    region. Returns the region's launches by kernel."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_SLOTS):
        sim.run_slot()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    before = dict(kernels.launches)
    tel = Telemetry()
    t0 = time.perf_counter()
    with ProfiledRegion("dense", telemetry=tel) as prof:
        for _ in range(PROFILE_SLOTS):
            sim.run_slot()
        torch.cuda.synchronize()
        slots_s = time.perf_counter() - t0
    region_s = time.perf_counter() - t0
    grown = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
    check(prof.error is None, f"phase 40: the dense region failed: {prof.error}")
    ops = device_ops(prof.planes)
    total = sum(ms for _, ms in ops)
    rows = prof.attribution
    check(abs(sum(r["total_ms"] for r in rows.values()) - total) <= 0.01 * len(rows),
          f"phase 40: the dense attribution {json.dumps(rows)} does not sum to the device "
          f"total {total:.4f} ms")
    k1 = device_ops(prof.planes, "agg_sig_kernel")
    check(len(k1) == grown.get("agg_sig", 0) == 2 * PROFILE_SLOTS,
          f"phase 40: {len(k1)} agg_sig_kernel events for {grown.get('agg_sig', 0)} K1 launches")
    k1_rows = attribute_to_spans(only_ops(prof.planes, "agg_sig_kernel"), [], region="dense",
                                 exclude_ops={"dense"})
    check(all(op.startswith("dense/slot/aggregate_verify/") for op, _ in k1)
          and set(k1_rows) == {"aggregate_verify"},
          f"phase 40: K1 credited to {sorted(k1_rows)}, paths {sorted({op for op, _ in k1})}")
    k1_ms = sum(ms for _, ms in k1)
    check(rows.get("aggregate_verify", {}).get("total_ms", 0) >= round(k1_ms, 4) - 1e-4,
          f"phase 40: aggregate_verify's row {rows.get('aggregate_verify')} holds less than "
          f"K1's {k1_ms:.4f} ms")
    n_host = sum(len(line["events"]) for p in prof.planes if not xplane.is_device_plane(p["name"])
                 for line in p["lines"])
    say(f"[{card}] phase 40 (a) (contended: beside phase 41 (b)): "
        f"{PROFILE_SLOTS} dense "
        f"slots at n={N_MAINNET}: "
        f"{plain_s:.3f} s unprofiled, {slots_s:.3f} s profiled "
        f"({100 * (slots_s / plain_s - 1):.1f}% over), the trace's stop, export and read "
        f"{region_s - slots_s:.3f} s; {len(ops)} device events ({total:.3f} ms), {n_host} "
        f"host; launches {json.dumps(grown)}; K1 {len(k1)} events, {k1_ms:.4f} ms, all on "
        f"dense/slot/aggregate_verify/, credited to aggregate_verify")
    say(f"[{card}] phase 40 (a): device ms by innermost range: " + json.dumps(
        {k: [v["total_ms"], v["count"]] for k, v in
         sorted(prof.by_jit.items(), key=lambda kv: -kv[1]["total_ms"])}))
    say(f"[{card}] phase 40 (a): attribution: " + json.dumps(rows))
    say(f"[{card}] phase 40 (a): top ops: " + json.dumps(prof.top_ops))
    return grown


def spec_root(sim) -> str:
    """The state root of group 0's head (the host walk's)."""
    store = sim.groups[0].store
    with use_backend(sim.backend):
        return hash_tree_root(store.block_states[ofc.get_head_host(store)]).hex()


def profile_spec_runs(dev, card: str) -> dict:
    """Phase 40 (b): ``Simulation(PROFILE_SPEC_N, profile=dir)`` (mainnet) for
    ``PROFILE_SLOTS`` slots and its unprofiled twin: the four artifacts,
    a device lane in ``chrome_trace.json``, one ``merkle_level_kernel``
    event a K2 launch of the profiled segment, and the records and the
    final state root equal. Returns the segment's launches by kernel."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profile_spec")
    shutil.rmtree(out_dir, ignore_errors=True)
    # its events log, for phase 42, in a directory of its own: only the log's
    # profile_artifacts event leads to the artifacts
    shutil.rmtree(os.path.dirname(PROFILE_EVENTS), ignore_errors=True)
    os.makedirs(os.path.dirname(PROFILE_EVENTS))
    with use_config(mainnet_config()):
        tel = Telemetry.to_file(PROFILE_EVENTS)
        sim = Simulation(PROFILE_SPEC_N, telemetry=tel, profile=out_dir, device=dev)
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        sim.run_until_slot(PROFILE_SLOTS - 1)
        prof_s = time.perf_counter() - t0
        grown = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
        t0 = time.perf_counter()
        plain = Simulation(PROFILE_SPEC_N, device=dev)
        t1 = time.perf_counter()
        plain.run_until_slot(PROFILE_SLOTS - 1)
        plain_s = time.perf_counter() - t1
        construct_s = t1 - t0
        roots = spec_root(sim), spec_root(plain)
    tel.close()
    region = sim.profile_region
    (ev,) = tel.bus.of_type("profile")
    check(region is not None and region.error is None and "error" not in ev,
          f"phase 40: the spec driver's profile failed: {ev.get('error')}")
    check(sorted(os.listdir(out_dir)) == PROFILE_ARTIFACTS
          and [e["files"] for e in tel.bus.of_type("profile_artifacts")] == [PROFILE_ARTIFACTS],
          f"phase 40: profile artifacts {sorted(os.listdir(out_dir))}")
    with open(os.path.join(out_dir, "chrome_trace.json")) as f:
        chrome = json.load(f)["traceEvents"]
    lanes = [e["args"]["name"] for e in chrome
             if e.get("pid") == DEVICE_PID and e.get("name") == "thread_name"]
    check(any(name.startswith("/device:GPU") for name in lanes),
          f"phase 40: chrome_trace.json has no device lane: {lanes}")
    k2 = device_ops(region.planes, "merkle_level_kernel")
    check(len(k2) == grown.get("merkle_level", 0) > 0,
          f"phase 40: {len(k2)} merkle_level_kernel events for "
          f"{grown.get('merkle_level', 0)} K2 launches")
    check(driver_record(sim) == driver_record(plain) and roots[0] == roots[1],
          "phase 40: the profiled spec run differs from its unprofiled twin")
    k2_rows = attribute_to_spans(only_ops(region.planes, "merkle_level_kernel"),
                                 region._region_span_names(), region="sim_run",
                                 exclude_ops={"sim_run"})
    say(f"[{card}] phase 40 (b) (contended): Simulation({PROFILE_SPEC_N}, profile=) "
        f"{PROFILE_SLOTS} slots "
        f"{prof_s:.3f} s with the export, its twin {plain_s:.3f} s (construction "
        f"{construct_s:.3f} s); artifacts {PROFILE_ARTIFACTS}; launches {json.dumps(grown)}; "
        f"K2 {len(k2)} events, {sum(ms for _, ms in k2):.4f} ms, credited "
        + json.dumps({k: v["count"] for k, v in k2_rows.items()})
        + f"; records and final state root {roots[0][:16]} == the unprofiled run's")
    say(f"[{card}] phase 40 (b): attribution: " + json.dumps(ev["attribution"]))
    return grown


def cost_phase(dev, card: str) -> dict:
    """Phase 40 (c): the cost table at 2^20 on the card: no row with an
    error, every peak positive. Returns its launches by kernel."""
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    table = analyze_hot_paths(n=N_MAINNET, capacity=64, device=dev)
    cost_s = time.perf_counter() - t0
    grown = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
    rows = table["kernels"]
    check(table["backend"] == "cuda" and not [k for k, v in rows.items() if "error" in v],
          f"phase 40: cost table errors: {json.dumps(rows)}")
    check(all((v["peak_bytes"] or 0) > 0 for v in rows.values()),
          f"phase 40: cost table peaks {[(k, v['peak_bytes']) for k, v in rows.items()]}")
    os.makedirs(TOOLING_DIR, exist_ok=True)
    with open(COST_TABLE, "w") as f:     # for phase 42's report
        json.dump(table, f, indent=1, sort_keys=True)
    say(f"[{card}] phase 40 (c): cost table at n={N_MAINNET}, capacity 64 ({cost_s:.3f} s; "
        f"launches {json.dumps(grown)}):")
    for name, row in rows.items():
        say(f"  {name}: " + json.dumps(row, sort_keys=True))
    return grown


def fused_measure_phase(dev, card: str) -> None:
    """Phase 40 (d): ``fused_measure`` of one K2 level at ``K2_LARGEST``
    pairs (the salt written into one word, the output's checksum folded),
    beside the CUDA-graph timer on the same launch; printed, not compared."""
    rng = np.random.default_rng(40)
    left, right = rand_words(rng, K2_LARGEST, dev), rand_words(rng, K2_LARGEST, dev)

    def body(salt, acc):
        left[0, 0] = salt
        return acc + bench_checksum(merkle_level(left, right))

    fused = fused_measure(body, k_hi=8, reps=3, tag="phase 40 K2 level") * 1e3
    graph = device_ms(lambda: merkle_level(left, right))
    say(f"[{card}] phase 40 (d) (contended): one K2 level at {K2_LARGEST} pairs: fused_measure "
        f"{fused:.4f} ms an iteration (the launch, the salt's write and the checksum); "
        f"CUDA-graph timer {fmt_ms(graph)} a launch")


def compile_cache_runs() -> dict:
    """Phase 40 (e), in a child process during phases 32-33: two processes,
    one after the other, each running ``Simulation(1,024,
    compile_cache=dir)`` (mainnet) for 3 slots on the card with a fresh
    ``dir`` the first time; each one's build ledger rows, build
    directory, launches and records."""
    root = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(root, "build", "compile_cache")
    shutil.rmtree(cache, ignore_errors=True)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", COMPILE_CACHE_CHILD, cache,
                               str(PROFILE_SPEC_N)], capture_output=True, text=True,
                              timeout=600, cwd=root)
        check(proc.returncode == 0,
              f"compile_cache child: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        runs.append({**json.loads(proc.stdout.strip().splitlines()[-1]),
                     "s": time.perf_counter() - t0})
    return {"cache": cache, "runs": runs,
            "files": sorted(os.listdir(cache)) if os.path.isdir(cache) else []}


def compile_cache_check(res: dict) -> None:
    first, second = res["runs"]
    built = sorted({r["source"] for r in first["builds"]})
    check(all(r["build_dir"] == res["cache"] for r in res["runs"]),
          f"phase 40: build dirs {[r['build_dir'] for r in res['runs']]}")
    check("merkle_level.cu" in built and second["builds"] == []
          and first["launches"].get("merkle_level", 0) > 0
          and second["launches"] == first["launches"] and second["metrics"] == first["metrics"],
          f"phase 40: compile_cache builds {first['builds']} then {second['builds']}, "
          f"launches {first['launches']} / {second['launches']}")
    say(f"phase 40 (e) (run during phases 32-33): compile_cache= at a fresh directory built "
        f"{built} ({first['s']:.3f} s), the second process built nothing ({second['s']:.3f} s); "
        f"launches {json.dumps(first['launches'])} each, records equal; the directory "
        f"{res['files']}")


def profiled_launches(fn, reps: int = 5) -> dict:
    """``fn`` ``reps`` times under ``torch.profiler``: wall ms, device
    launches (kernels and copies) and device busy ms, each a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return {"wall_ms": wall, "launches": sum(e.count for e in dev_events) / reps,
            "busy_ms": sum(e.self_device_time_total for e in dev_events) / 1e3 / reps}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs one GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # plain twins of earlier phases, run during phases 32-33 and checked there:
    # (function, arguments, checker)
    deferred = []

    # 1. build
    t0 = time.perf_counter()
    reports = kernels.build_all()
    say(f"build_seconds {time.perf_counter() - t0:.3f}; by source "
        + json.dumps({k: round(v, 3) for k, v in kernels.build_seconds.items()}))
    lap("phase 1")
    # phase 14's SASS census (cuobjdump over the built libraries: the host's
    # CPU, not the card) in a process of its own beside phases 2-13
    census_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    census_job = census_pool.submit(sass_census)
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas {name}: {line.strip()}")
    for name in ("fp_modmul", "fp_addsub", "alg_mul", "sha256_blocks", "gf256_matmul",
                 "fr_ntt", "g1_msm", "g1_bucket_tables", "g1_bucket_fill", "g1_bucket_totals",
                 "g1_bucket_reduce"):
        # the redesigned kernels: no spills
        spills = [line for line in reports[name].splitlines() if "spill" in line]
        check(spills and all("0 bytes spill stores, 0 bytes spill loads" in line
                             for line in spills), f"{name} spills registers: {spills}")

    # 2. K1 against its plain version at the main path's shapes
    inputs = build_epoch_inputs(N_MAINNET, seed=0)
    a, c = inputs.agg_bits.shape
    check((a, c) == (2048, 512), f"main path shape {(a, c)}")
    pk = precompute_pk_states(inputs.pubkeys, dev)
    perm = shuffle_permutation(inputs.shuffle_seed, N_MAINNET, inputs.shuffle_rounds, dev)
    committees = perm[: a * c].reshape(a, c)
    bits = torch.from_numpy(inputs.agg_bits).to(dev)
    msgs = words_to_torch(inputs.msg_words, dev)
    k1 = committee_aggregates(pk, committees, bits, msgs)
    plain = _committee_aggregates(pk, committees, bits, msgs)
    torch.cuda.synchronize()
    max_abs_err = int(((k1.long() & MASK32) - (plain.long() & MASK32)).abs().max())
    check(max_abs_err == 0 and torch.equal(k1, plain), "K1 differs from its plain version")
    say(f"K1 vs plain at A={a} C={c} N={N_MAINNET}: bit-equal")

    comm_np = committees.cpu().numpy()
    k1_np = words_to_numpy(k1)
    for i in (0, 1, a // 2, a - 1):
        want = fakebls_aggregate(inputs.pubkeys, comm_np[i], inputs.agg_bits[i],
                                 words_to_bytes(inputs.msg_words[i]))
        check(words_to_bytes(k1_np[i]) == want, f"K1 committee {i} differs from hashlib FakeBLS")
    say("K1 vs hashlib FakeBLS on committees 0, 1, A/2, A-1: equal")

    ok = aggregate_verify_batch(pk, committees, bits, msgs, k1)
    check(bool(ok.all()), "honest aggregates must all verify")
    tampered = k1.clone()
    tampered[5, 3] ^= 1
    ok_t = aggregate_verify_batch(pk, committees, bits, msgs, tampered)
    check(not bool(ok_t[5]) and int(ok_t.sum()) == a - 1, "a flipped word must fail only its own")
    empty = bits.clone()
    empty[7] = False
    ok_e = aggregate_verify_batch(pk, committees, empty, msgs, k1)
    check(not bool(ok_e[7]) and int(ok_e.sum()) == a - 1, "an empty bitlist must fail")
    say("verify: honest all True; flipped word False; empty bitlist False")

    # 3. small cross-device reference and the spec shuffle
    small = build_epoch_inputs(4096, seed=3, slots=4, committees_per_slot=4,
                               capacity=16, shuffle_rounds=10)
    bad = mismatches(run_epoch(small, "cpu"), run_epoch(small, dev))
    check(not bad, f"small epoch: card differs from CPU in {bad}")
    perm_np = perm.cpu().numpy()
    for i in (0, 1, 255, 256, 524287, N_MAINNET - 1):
        check(int(perm_np[i]) == spec_shuffled_index(i, N_MAINNET, inputs.shuffle_seed,
                                                      inputs.shuffle_rounds),
              f"shuffle differs from the spec at index {i}")
    say("small epoch (n=4096): card == CPU; shuffle == spec on 6 indices at n=2^20")
    del pk, perm, committees, plain, tampered

    # 4. the main path, counted
    kernels.reset_launches()
    out = run_epoch(inputs, dev)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    check(launches["agg_sig"] == 2 and launches["sha256_blocks"] == 1,
          f"K1 and K6 launches on the main path: {launches}")
    check(bool(out.ok.all()), "every honest aggregate must verify on the main path")
    check(out.heads.shape == (inputs.slots,)
          and out.weights.shape == (inputs.slots, inputs.capacity), "head output shapes")
    ref = run_epoch(inputs, dev, plain=True)
    bad = mismatches(out, ref)
    check(not bad, f"main path differs from the plain-aggregation epoch in {bad}")
    say(f"main path n={N_MAINNET}: launches {launches}; all {a} aggregates verify; "
        f"bit-equal to the plain-aggregation epoch; heads {out.heads.tolist()}; "
        f"finalize_epoch {int(out.result.finalize_epoch)}; checksum {checksum_tree(out)}")
    del ref

    # 5. timings
    pk = precompute_pk_states(inputs.pubkeys, dev)
    committees = out.committees
    stream = torch.cuda.current_stream(dev).cuda_stream
    k1_out = torch.zeros((a, 24), dtype=torch.int32, device=dev)

    def k1_kernel():
        k1_out.zero_()
        kernels.launch("agg_sig", pk.data_ptr(), committees.data_ptr(), bits.data_ptr(),
                       msgs.data_ptr(), k1_out.data_ptr(), a, c, stream)

    k1_ms = time_ms(k1_kernel, 20)
    wrapper_ms = time_ms(lambda: committee_aggregates(pk, committees, bits, msgs), 20)
    plain_ms = time_ms(lambda: _committee_aggregates(pk, committees, bits, msgs), 3)
    bound = k1_bound(bits, a)
    bound_ms, bound_by = bound["ms"], bound["by"]
    say(f"[{card}] K1 kernel {k1_ms:.4f} ms/launch (zeroing the output included), "
        f"wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {bound['set_bits']} set-bit signers, {bound['ops']} lane "
        f"instructions, {bound['bytes']} bytes)")

    epoch_ms = time_ms(lambda: run_epoch(inputs, dev), 2)
    reps = 2
    stages = [sum(col) / reps for col in zip(*(stage_ms(inputs, dev) for _ in range(reps)))]
    say(f"[{card}] epoch n={N_MAINNET}: {epoch_ms:.3f} ms; stages "
        + ", ".join(f"{s} {ms:.3f} ms" for s, ms in zip(STAGES, stages)))

    del pk, committees, k1_out, out

    lap("phases 2-5")

    # 6. K2 against its plain version and hashlib
    rng = np.random.default_rng(11)
    k2_err = 0
    for n in (K2_LARGEST, 1, 3, 511, 513):
        layer = rand_words(rng, 2 * n, dev)
        left, right = layer[0::2], layer[1::2]   # a level's even and odd rows, as trees pass them
        got = merkle_level(left, right)
        ref = _merkle_level(left, right)
        torch.cuda.synchronize()
        err = int(((got.long() & MASK32) - (ref.long() & MASK32)).abs().max())
        k2_err = max(k2_err, err)
        check(err == 0 and torch.equal(got, ref), f"K2 differs from its plain version at N={n}")
        if n == K2_LARGEST:
            for i in (0, 1, n // 2, n - 1):
                check(row_bytes(got[i]) == sha(row_bytes(left[i]), row_bytes(right[i])),
                      f"K2 row {i} differs from hashlib")
    before = kernels.launches["merkle_level"]
    check(merkle_level(layer[:0], layer[:0]).shape == (0, 8)
          and kernels.launches["merkle_level"] == before, "a zero-size K2 call must not launch")
    say(f"K2 vs plain at N={K2_LARGEST}, 1, 3, 511, 513 (strided level views): bit-equal; "
        "4 rows == hashlib; N=0 launches nothing")
    del layer, left, right, got, ref

    # 7. the roots path, counted
    kernels.reset_launches()
    merkle_device.reset_stats()
    incremental.reset_stats()
    roots = run_state_roots(inputs, dev)
    torch.cuda.synchronize()
    root_launches = dict(kernels.launches)
    mstats, istats = merkle_device.stats(), incremental.stats()
    want_k2 = 4 * istats["validator_root_passes"] + mstats["batched_launches"]
    check(root_launches["merkle_level"] == want_k2 and root_launches["agg_sig"] == 2,
          f"roots path launches {root_launches}, want K2 {want_k2} and K1 2")
    say(f"roots path n={N_MAINNET}: launches {root_launches} (validator-root passes "
        f"{istats['validator_root_passes']}, sweeper rounds {mstats['batched_launches']}, "
        f"pairs {mstats['pairs']}); dirty after the epoch {roots.dirty}")
    ref = run_state_roots(inputs, dev, plain=True)
    check(ref.pre == roots.pre and ref.post == roots.post,
          "roots differ from the run with the plain versions")
    del ref
    cols = load_columns(inputs, dev)
    post_state = registry_state(roots.epoch.result.registry, cols)
    check(RegistryScaleTrees(inputs.cfg).roots(post_state) == roots.post,
          "incremental post-epoch roots differ from a fresh build")
    n_val = N_MAINNET
    bal = roots.epoch.result.registry.balance.cpu().numpy()
    reg = {f: getattr(roots.epoch.result.registry, f).cpu().numpy()
           for f in ("effective_balance", "slashed", "activation_epoch", "exit_epoch",
                     "withdrawable_epoch")}
    host_cols = validator_columns(inputs)
    bal_tree = roots.trees.fields["balances"].tree
    reg_tree = roots.trees.fields["validators"].reg_tree.tree
    length = n_val.to_bytes(32, "little")
    for v in (0, 123457, n_val - 1):
        c = v // 4
        leaf = bal[4 * c:4 * c + 4].astype("<u8").tobytes()
        branch = tree_branch(bal_tree, c) + [length]
        check(is_valid_merkle_branch(leaf, branch, len(branch), c, roots.post["balances"]),
              f"balance chunk {c} does not prove against the balances root")
        epochs = [2**64 - 1 if int(reg[f][v]) == FAR_FUTURE_I64 else int(reg[f][v])
                  for f in ("activation_epoch", "exit_epoch", "withdrawable_epoch")]
        vroot = validator_root(
            host_cols.pubkeys[v].tobytes(), host_cols.withdrawal_credentials[v].tobytes(),
            [reg["effective_balance"][v], reg["slashed"][v],
             host_cols.activation_eligibility_epoch[v], *epochs])
        branch = tree_branch(reg_tree, v) + [length]
        check(is_valid_merkle_branch(vroot, branch, len(branch), v, roots.post["validators"]),
              f"validator {v} does not prove against the validators root")
    say("roots path: pre and post == the plain-version run; post == fresh build; "
        "balance chunks and validators 0, 123457, 2^20-1 prove by hashlib branches; "
        "post roots " + ", ".join(f"{f} {roots.post[f].hex()[:16]}" for f in FIELDS))

    # 8. small cross-device reference
    small = build_epoch_inputs(4096, seed=3, **SMALL)
    a_cpu, a_dev = run_state_roots(small, "cpu"), run_state_roots(small, dev)
    check((a_cpu.pre, a_cpu.post, a_cpu.dirty) == (a_dev.pre, a_dev.post, a_dev.dirty),
          "small state roots: card differs from CPU")
    say("small state roots (n=4096): card == CPU")

    # 9. timings
    k2 = {}
    for n in (K2_LARGEST, N_MAINNET):
        left, right = rand_words(rng, n, dev), rand_words(rng, n, dev)
        k2_out = torch.empty((n, 8), dtype=torch.int32, device=dev)

        def k2_kernel():
            kernels.launch("merkle_level", left.data_ptr(), 8, right.data_ptr(), 8,
                           k2_out.data_ptr(), n, stream)

        k2[n] = {"ms": time_ms(k2_kernel, 20),
                 "wrapper_ms": time_ms(lambda: merkle_level(left, right), 20),
                 "plain_ms": time_ms(lambda: _merkle_level(left, right), 2),
                 "bound": k2_bound(n)}
        say(f"[{card}] K2 at {n} pairs: kernel {k2[n]['ms']:.4f} ms/launch, wrapper "
            f"{k2[n]['wrapper_ms']:.4f} ms, plain {k2[n]['plain_ms']:.4f} ms, bound "
            f"{k2[n]['bound']['ms']:.4f} ms ({k2[n]['bound']['by']}: {n * OPS_K2_PAIR} lane "
            f"instructions, {n * BYTES_K2_PAIR} bytes)")
    del left, right, k2_out
    pre_state = registry_state(registry_to_torch(inputs.registry, dev), cols)
    builds, updates = [], []
    for _ in range(3):
        trees = RegistryScaleTrees(inputs.cfg)
        builds.append(roots_work(trees, pre_state))
        updates.append(roots_work(trees, post_state))
    for name, runs in (("full build", builds), ("incremental update", updates)):
        ms = [r[0] for r in runs]
        _, launches_k2, pairs = runs[-1]
        b = k2_bound(pairs)
        say(f"[{card}] {name}: {', '.join(f'{x:.3f}' for x in ms)} ms; {launches_k2} K2 "
            f"launches, {pairs} pairs; K2 bound on those pairs {b['ms']:.4f} ms ({b['by']})")
    trees = RegistryScaleTrees(inputs.cfg)
    syncs = {"full build": sync_count(lambda: trees.roots(pre_state)),
             "incremental update": sync_count(lambda: trees.roots(post_state))}
    trees = RegistryScaleTrees(inputs.cfg)
    prof = {"full build": profiled(lambda: trees.roots(pre_state)),
            "incremental update": profiled(lambda: trees.roots(post_state))}
    for name, p in prof.items():
        say(f"[{card}] {name} under torch.profiler: wall {p['wall_ms']:.3f} ms, device busy "
            f"{p['busy_ms']:.3f} ms ({100 * p['busy_ms'] / p['wall_ms']:.1f}%), K2 "
            f"{p['k2_ms']:.3f} ms; host syncs {syncs[name]} (CUDA sync debug mode)")
    reps = 2
    rstages = [sum(col) / reps for col in zip(*(root_stage_ms(inputs, dev) for _ in range(reps)))]
    say(f"[{card}] roots path n={N_MAINNET}: stages "
        + ", ".join(f"{s} {ms:.3f} ms" for s, ms in zip(ROOT_STAGES, rstages)))

    lap("phases 6-9")

    # 10. the dense path, counted
    del pre_state, post_state, cols, trees, roots
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sim = dense_sim(dev, phase_profile=8)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim.run_epochs(DENSE_EPOCHS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    run_launches = dict(kernels.launches)
    summary = sim.summary()
    before_digest = dict(kernels.launches)
    digest = state_digest(sim)
    torch.cuda.synchronize()
    dense_launches = dict(kernels.launches)
    digest_k2 = dense_launches["merkle_level"] - before_digest["merkle_level"]
    slots = sim.slot
    check(slots == DENSE_EPOCHS * 32, f"dense path ran {slots} slots")
    check(run_launches["agg_sig"] == 2 * slots and run_launches["merkle_level"] == 0
          and run_launches["sha256_blocks"] == 1,
          f"dense run launches {run_launches}, want K1 twice a slot ({2 * slots}), K6 once")
    check(digest_k2 > 0 and dense_launches["agg_sig"] == 2 * slots,
          f"state_digest launches {dense_launches}")
    check(all(sim.walk_checks) and summary["resident_head_equals_spec_walk"],
          f"walk checks {sim.walk_checks}")
    check(summary["aggregates_verified"] == 64 * slots,
          f"aggregates verified {summary['aggregates_verified']}")
    check(summary["finality_reached"] and summary["finalized_epoch"] == DENSE_EPOCHS - 2,
          f"finality: {summary}")
    phases = summary.pop("dense_phases")
    say(f"dense path n={N_MAINNET}, {DENSE_EPOCHS} epochs ({slots} slots): launches "
        f"{dense_launches} (K1 {run_launches['agg_sig']} in the run, K2 {digest_k2} in "
        f"state_digest); summary {json.dumps(summary)}; digest {digest}")
    # the plain twin at DENSE_PLAIN_EPOCHS against a kernel run of the same depth
    # (finality is checked above on the full run): a child process during
    # phases 32-33, checked there

    def dense_done(res):
        check(res["equal"], "phase 10: the dense path differs from its plain=True run")
        say(f"phase 10 (run during phases 32-33): the dense path at {DENSE_PLAIN_EPOCHS} epoch: "
            f"metrics, summary and digest == the plain=True run ({res['plain_s']:.3f} s for its "
            f"setup, {DENSE_PLAIN_EPOCHS} epoch and digest)")

    deferred.append((dense_twin, (), dense_done))
    committees = torch.from_numpy(
        sim._inv_perm[: 64 * 512].reshape(512, 64).T.astype(np.int32).copy()).to(dev)
    d_bits = torch.from_numpy(np.random.default_rng(5).random((64, 512)) < 0.99).to(dev)
    d_msgs = rand_words(rng, 64, dev)
    d_pk = sim.pk_states
    got = committee_aggregates(d_pk, committees, d_bits, d_msgs)
    want = _committee_aggregates(d_pk, committees, d_bits, d_msgs)
    dense_k1_err = int(((got.long() & MASK32) - (want.long() & MASK32)).abs().max())
    check(dense_k1_err == 0 and torch.equal(got, want), "K1 at (64, 512) differs from plain")
    say("K1 vs plain at the dense path's shape A=64 C=512: bit-equal")

    lap("phase 10")

    # 11. faulted and adversarial at 2^20, checkpoint and resume on the card
    t3 = time.perf_counter()
    full = run_record(chaos_sim(dev, N_MAINNET), 2)
    t4 = time.perf_counter()
    half = chaos_sim(dev, N_MAINNET)
    half.run_epochs(1)
    data = half.checkpoint()
    del half
    resumed = run_record(DenseSimulation.resume(data, device=dev), 2)
    bad = [k for k in full if resumed[k] != full[k]]
    check(not bad, f"chaos run: resumed differs from the uninterrupted run in {bad}")
    check(full["summary"]["resident_head_equals_spec_walk"] and full["implicated"][0],
          "chaos run: parity and evidence")
    say(f"chaos n={N_MAINNET}, 2 epochs: {len(full['violations'])} violations, "
        f"{len(full['implicated'][0])} implicated, {full['summary']['n_blocks']} blocks, "
        f"finalized {full['summary']['finalized_epoch']}; checkpoint {len(data)} bytes after "
        f"epoch 1, resumed on the card == uninterrupted (metrics, violations, evidence, "
        f"digest); {(t4 - t3) / 2:.3f} s per chaos epoch")
    del data

    # 12. the dense driver on the card against the CPU at small size: child processes
    # during phases 32-33, checked there
    def small_done(res):
        check(not res["bad"], f"small dense {res['label']} run: card differs from CPU in "
              f"{res['bad']}")
        say(f"phase 12 (run during phases 32-33): small dense {res['label']} run "
            f"(n={res['n']}, {res['epochs']} epochs): card == CPU ({res['s']:.3f} s)")

    deferred.extend((small_dense_twin, (label,), small_done) for label in SMALL_DENSE)

    lap("phase 11")
    # 13. dense timings: a steady epoch, then PROFILE_SLOTS slots under the profiler
    # (not a whole epoch: its trace's read held most of the phase)
    t5 = time.perf_counter()
    sim.run_epochs(DENSE_EPOCHS + 1)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t5
    t6 = time.perf_counter()
    prof_dense = profiled(lambda: [sim.run_slot() for _ in range(PROFILE_SLOTS)])
    prof_s = time.perf_counter() - t6
    per_epoch = (t2 - t1) / DENSE_EPOCHS
    say(f"[{card}] dense path: setup {t1 - t0:.3f} s, {DENSE_EPOCHS} epochs {t2 - t1:.3f} s "
        f"= {per_epoch:.3f} s per simulated epoch; epoch {DENSE_EPOCHS + 1} alone "
        f"{steady_s:.3f} s; {PROFILE_SLOTS} slots under torch.profiler (the trace read "
        f"included {prof_s:.3f} s) wall "
        f"{prof_dense['wall_ms']:.3f} ms, device busy {prof_dense['busy_ms']:.3f} ms "
        f"({100 * prof_dense['busy_ms'] / prof_dense['wall_ms']:.2f}%), K1 "
        f"{prof_dense['k1_ms']:.3f} ms, K2 {prof_dense['k2_ms']:.3f} ms")
    say(f"[{card}] dense phase budget (4 epochs, every 8th slot fenced): "
        + json.dumps(phases))
    t_digest = time_ms(lambda: state_digest(sim), 2)
    d_out = torch.zeros((64, 24), dtype=torch.int32, device=dev)

    def k1_dense():
        d_out.zero_()
        kernels.launch("agg_sig", d_pk.data_ptr(), committees.data_ptr(), d_bits.data_ptr(),
                       d_msgs.data_ptr(), d_out.data_ptr(), 64, 512, stream)

    dense_k1_ms = time_ms(k1_dense, 50)
    dense_plain_ms = time_ms(lambda: _committee_aggregates(d_pk, committees, d_bits, d_msgs), 5)
    dense_bound = k1_bound(d_bits, 64)
    say(f"[{card}] K1 at A=64 C=512: kernel {dense_k1_ms:.4f} ms, plain {dense_plain_ms:.4f} "
        f"ms, bound {dense_bound['ms']:.5f} ms ({dense_bound['by']}); state_digest "
        f"{t_digest:.3f} ms")

    lap("phases 11-13")

    # 14. SASS census and the two bounds
    census = census_job.result()
    census_pool.shutdown()
    if census is None:
        say("SASS census: cuobjdump not found")
    else:
        unit = {"agg_sig": "per signer", "merkle_level": "per pair"}
        for name, c in census.items():
            say(f"SASS {name}: {unit.get(name, 'whole kernel')} {json.dumps(c['body'])}; "
                f"whole kernel {json.dumps(c['total'])}")
        signers = int(bits.sum())
        for name, units, measured in (("agg_sig", signers, k1_ms),
                                      ("merkle_level", K2_LARGEST, k2[K2_LARGEST]["ms"]),
                                      ("merkle_level", N_MAINNET, k2[N_MAINNET]["ms"])):
            b = sass_bounds(census[name]["body"], units)
            say(f"[{card}] {name} at {units} units: measured {measured:.4f} ms; bounds "
                + ", ".join(f"{k} {v:.4f}" for k, v in b.items())
                + f"; measured / int_pipe {b['int_pipe_ms'] / measured:.3f}")

    lap("phase 14")
    field_rows = bls_phases(dev, card, census, deferred)
    lap("phases 15-19")
    # phase 35's run, in a process of its own beside phases 20-34 (started before
    # the rider phases: beside phases 26-34 alone it ended after phase 40)
    solo = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"),
                               initializer=torch.set_num_threads, initargs=(2,))
    # phase 41 (a), at the end of phase 35's run, waits for SERVE_FRONT_GO: written
    # once phase 40 and 41 (b) have ended (or this run has failed)
    with contextlib.suppress(FileNotFoundError):
        os.unlink(SERVE_FRONT_GO)
    scale = solo.submit(driver_scale_run)
    try:
        das_rows = das_sync_phases(dev, card, census, deferred)
        lap("phases 20-25")
        t_kzg = time.perf_counter()
        kzg_rows = kzg_phases(dev, card, census)
        say(f"KZG phases 26-31 (beside phase 35's run): {time.perf_counter() - t_kzg:.3f} s")
        lap("phases 26-31")
        # phase 36's runs on the card and the CPU, run beside phases 32-33 (first,
        # the longest first) and kept for phase 36
        driver_twins = {}
        deferred[:0] = [(driver_run, (kind, where),
                         lambda res, key=(kind, where): driver_twins.__setitem__(key, res))
                        for kind in ("riders", "kzg", *DRIVER_TWINS[:-1])
                        for where in ("cpu", "cuda")]
        deferred.insert(2, (kzg_card_run, (),
                            lambda res: driver_twins.__setitem__(("kzg", "run"), res)))
        # phase 40 (e): two child processes in turn, beside phases 32-33
        deferred.append((compile_cache_runs, (), compile_cache_check))
        # phase 39's runs, one child process each, first in the queue (the longest)
        resilient = {}
        deferred[:0] = [(resilient_kind, (kind,),
                         lambda res, key=kind: resilient.__setitem__(key, res)) for kind in RESIL]
        # phase 41 (b) in a process of its own, started after phase 32 once phase 39's
        # supervised runs have ended, beside phases 33-34 and 40: no kernel of the
        # kernels line is timed from there on (beside phases 26-31 it shared the host
        # with their plain versions; beside phase 39's supervised runs it slowed them
        # until a kill landed before its checkpoint was durable)
        t_spec = time.perf_counter()
        spec_launches, serve_mp = spec_phases(dev, card, deferred,
                                              then=(resilient_kind, serve_mp_start))
        say(f"spec phases 32-34: {time.perf_counter() - t_spec:.3f} s")
        lap("phases 32-34")
        # phase 40 (a)-(d) here, beside phase 41 (b)
        t_prof = time.perf_counter()
        profile_launches = {"dense": profile_dense_region(sim, card),
                            "spec": profile_spec_runs(dev, card), "cost": cost_phase(dev, card)}
        fused_measure_phase(dev, card)
        say(f"phase 40 (a-d, beside phase 41 (b)): "
            f"{time.perf_counter() - t_prof:.3f} s; launches " + json.dumps(profile_launches))
        lap("phase 40")
        serve_mp = serve_mp_finish(serve_mp)
    finally:
        os.makedirs(os.path.dirname(SERVE_FRONT_GO), exist_ok=True)
        with open(SERVE_FRONT_GO, "w"):
            pass
    t_driver = time.perf_counter()
    scale_run = scale.result()
    solo.shutdown()
    say(f"phase 35's run: waited {time.perf_counter() - t_driver:.3f} s after phase 41 (b) "
        f"(its 41 (a) released after {scale_run['serve_wait_s']:.3f} s)")
    driver_launches = driver_phases(dev, card, driver_twins, scale_run)
    say(f"spec driver phases 35-37: {time.perf_counter() - t_driver:.3f} s")
    kzg_driver_launches = kzg_driver_phase(card, driver_twins)
    lap("phase 38")
    resilient_phase(card, resilient)
    lap("phase 39")
    serve_launches = serve_phase(card, scale_run["serve"], serve_mp,
                                 driver_twins[("kzg", "run")]["serve_kzg"])
    lap("phase 41")
    tooling_phase(card, resilient, profile_launches["spec"]["merkle_level"], serve_mp)
    lap("phase 42")

    big = k2[K2_LARGEST]
    say(card)
    rows = [{
        "name": "agg_sig", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches["agg_sig"], "max_abs_err": max_abs_err, "matches_plain": True,
        "ms": k1_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "epoch_ms": epoch_ms,
        "dense_launches": dense_launches["agg_sig"], "dense_ms": dense_k1_ms,
        "dense_plain_ms": dense_plain_ms, "dense_bound_ms": dense_bound["ms"],
        "dense_max_abs_err": dense_k1_err}, {
        "name": "merkle_level", "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": root_launches["merkle_level"], "max_abs_err": k2_err,
        "matches_plain": True, "pairs": K2_LARGEST, "ms": big["ms"],
        "wrapper_ms": big["wrapper_ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound"]["ms"], "bound_by": big["bound"]["by"], "library_ms": None,
        "ms_1048576": k2[N_MAINNET]["ms"], "full_build_ms": builds[-1][0],
        "update_ms": updates[-1][0], "dense_launches": digest_k2}, *field_rows, *das_rows,
        *kzg_rows]
    for row in rows:   # each kernel's launches in phase 32's spec chain, phases 35, 38 and 41
        row["spec_chain_launches"] = spec_launches.get(row["name"], 0)
        row["spec_driver_launches"] = driver_launches.get(row["name"], 0)
        row["spec_driver_kzg_launches"] = kzg_driver_launches.get(row["name"], 0)
        # phase 41: the serving front's load, its workers' (steady + chaos), the kzg front's
        row["serve_front_launches"] = serve_launches["front"].get(row["name"], 0)
        row["serve_worker_launches"] = serve_launches["workers"].get(row["name"], 0)
        row["serve_kzg_launches"] = serve_launches["kzg"].get(row["name"], 0)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    rc = main()
    # every process the run started has been stopped and waited for, and every
    # line flushed: skip the interpreter's teardown of the run's heaps and its
    # CUDA context (with the imports, ~20 s after the last lap on a slow host)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
