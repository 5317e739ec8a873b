"""Checkpoint / resume (port of ``pos_evolution_tpu/utils/snapshot.py``).

The reference's own resume mechanism is the anchor-state store init
(pos-evolution.md:1077-1095) from a finalized or weak-subjectivity
checkpoint — "checkpoints that act as new genesis" (:1216). Simulator
snapshots therefore are SSZ-serialized ``BeaconState`` + anchor
``BeaconBlock`` pairs (optionally the full Store), and resume goes through
``get_forkchoice_store`` exactly like a syncing client.

A whole ``sim/driver.Simulation`` checkpoint is framed SSZ plus JSON and
names no class path, so the JAX package's checkpoints load here as they
are, and the port's there, a DAS run's too: its queued ``blob``
sidecars, the engine's ``describe()`` and each view's verified
(block, blob) keys, from which ``_restore_das`` regenerates the sidecars.
The JAX package's dense-registry offloads (``save_dense``, ``load_dense`` and
their orbax forms) are item 7b.
"""

from __future__ import annotations

import io
import json
import os
import struct


from pos_evolution_tpu_torch.specs.containers import (
    BeaconBlock,
    BeaconState,
    Checkpoint,
    LatestMessage,
)
from pos_evolution_tpu_torch.ssz import deserialize, hash_tree_root, serialize


def atomic_write_bytes(path: str | os.PathLike, data: bytes,
                       fsync: bool = True) -> str:
    """Tmp + (fsync) + rename, so a kill at ANY point leaves either the
    previous complete file or the new complete file — never a torn one
    that a later ``resume``/``load`` half-parses. Every checkpoint
    write in the repo (manual snapshot files, the dense driver's npz,
    chaos repro bundles, the resilience manager) goes through this or
    its directory-level sibling in ``resilience/manager.py``."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(data)
        if fsync:
            fh.flush()
            os.fsync(fh.fileno())
    os.replace(tmp, path)
    return path


def _frame(out: io.BytesIO, payload: bytes) -> None:
    out.write(struct.pack("<Q", len(payload)))
    out.write(payload)


def _unframe(buf: io.BytesIO) -> bytes:
    (n,) = struct.unpack("<Q", buf.read(8))
    return buf.read(n)


# --- anchor snapshots (the spec's own mechanism) ------------------------------

def save_anchor(state: BeaconState, block: BeaconBlock) -> bytes:
    """Snapshot = SSZ(state) + SSZ(block); the pair satisfies the store-init
    contract ``block.state_root == hash_tree_root(state)``."""
    assert bytes(block.state_root) == hash_tree_root(state), \
        "anchor block/state inconsistent"
    out = io.BytesIO()
    _frame(out, serialize(state))
    _frame(out, serialize(block))
    return out.getvalue()


def load_anchor(data: bytes) -> tuple[BeaconState, BeaconBlock]:
    buf = io.BytesIO(data)
    state = deserialize(_unframe(buf), BeaconState)
    block = deserialize(_unframe(buf), BeaconBlock)
    return state, block


def resume_store(data: bytes, pow_chain=None):
    """Rebuild a fork-choice store from a snapshot — the weak-subjectivity
    sync flow (pos-evolution.md:1221, 1293). ``pow_chain`` reattaches an
    isolated PoW view (see ``load_store``)."""
    from pos_evolution_tpu_torch.specs.forkchoice import get_forkchoice_store
    state, block = load_anchor(data)
    return get_forkchoice_store(state, block, pow_chain=pow_chain)


def snapshot_head(store) -> bytes:
    """Snapshot the current head block + post-state of a running store."""
    from pos_evolution_tpu_torch.specs.forkchoice import get_head
    head = get_head(store)
    return save_anchor(store.block_states[head], store.blocks[head])


# --- full-store snapshots -----------------------------------------------------

def save_store(store) -> bytes:
    """Serialize an entire Store (view) for exact-resume debugging."""
    out = io.BytesIO()
    meta = {
        "time": store.time,
        "genesis_time": store.genesis_time,
        "justified": [int(store.justified_checkpoint.epoch),
                      bytes(store.justified_checkpoint.root).hex()],
        "finalized": [int(store.finalized_checkpoint.epoch),
                      bytes(store.finalized_checkpoint.root).hex()],
        "best_justified": [int(store.best_justified_checkpoint.epoch),
                           bytes(store.best_justified_checkpoint.root).hex()],
        "proposer_boost_root": bytes(store.proposer_boost_root).hex(),
        "equivocating": sorted(store.equivocating_indices),
        "latest_messages": {str(v): [m.epoch, m.root.hex()]
                            for v, m in store.latest_messages.items()},
        "block_order": [r.hex() for r in store.blocks],
        "checkpoint_keys": [[e, r.hex()] for (e, r) in store.checkpoint_states],
    }
    _frame(out, json.dumps(meta).encode())
    for root in store.blocks:
        _frame(out, serialize(store.blocks[root]))
        _frame(out, serialize(store.block_states[root]))
    for key in store.checkpoint_states:
        _frame(out, serialize(store.checkpoint_states[key]))
    return out.getvalue()


def load_store(data: bytes, pow_chain=None):
    """Rebuild a Store from ``save_store`` bytes.

    ``pow_chain`` reattaches a PoW-chain view (specs.merge.PowChainView):
    the view can hold a live callable provider, so it is not serialized —
    a resumed store that must re-validate a merge-transition block needs
    the caller to pass the view back in (None falls back to the module
    default registry, as everywhere else).
    """
    from pos_evolution_tpu_torch.specs.forkchoice import Store
    buf = io.BytesIO(data)
    meta = json.loads(_unframe(buf).decode())
    blocks, block_states = {}, {}
    for root_hex in meta["block_order"]:
        block = deserialize(_unframe(buf), BeaconBlock)
        state = deserialize(_unframe(buf), BeaconState)
        blocks[bytes.fromhex(root_hex)] = block
        block_states[bytes.fromhex(root_hex)] = state
    checkpoint_states = {}
    for epoch, root_hex in meta["checkpoint_keys"]:
        checkpoint_states[(epoch, bytes.fromhex(root_hex))] = \
            deserialize(_unframe(buf), BeaconState)

    def cp(pair):
        return Checkpoint(epoch=pair[0], root=bytes.fromhex(pair[1]))

    return Store(
        time=meta["time"],
        genesis_time=meta["genesis_time"],
        justified_checkpoint=cp(meta["justified"]),
        finalized_checkpoint=cp(meta["finalized"]),
        best_justified_checkpoint=cp(meta["best_justified"]),
        proposer_boost_root=bytes.fromhex(meta["proposer_boost_root"]),
        equivocating_indices=set(meta["equivocating"]),
        blocks=blocks,
        block_states=block_states,
        checkpoint_states=checkpoint_states,
        latest_messages={int(v): LatestMessage(epoch=m[0], root=bytes.fromhex(m[1]))
                         for v, m in meta["latest_messages"].items()},
        pow_chain=pow_chain,
    )


# --- whole-simulation snapshots (sim/driver.py checkpoint/resume) -------------

# message kind -> SSZ payload class for queue/pool serialization
def _payload_class(kind: str):
    from pos_evolution_tpu_torch.specs.containers import (
        Attestation,
        AttesterSlashing,
        SignedBeaconBlock,
    )
    if kind == "blob":
        from pos_evolution_tpu_torch.das.containers import BlobSidecar
        return BlobSidecar
    return {"block": SignedBeaconBlock, "attestation": Attestation,
            "slashing": AttesterSlashing}[kind]


def save_simulation(sim, path: str | os.PathLike | None = None) -> bytes:
    """Serialize a running ``sim.driver.Simulation`` so that ``resume``
    continues it bit-identically: per group the full Store
    (``save_store``), the pending message queue (times + arrival sequence
    + SSZ payloads), the attestation pool, and the per-block inclusion
    index; plus the slot cursor and recorded per-slot metrics.
    ``path`` additionally lands the bytes on disk ATOMICALLY
    (``atomic_write_bytes``): a kill mid-write can never leave a torn
    file that a later manual ``resume()`` half-loads.

    Not serialized, by design: the Schedule/FaultPlan (callables — the
    caller passes the same one to ``resume``; fault decisions are
    stateless hashes so they replay identically), the PoW-chain view
    (``load_store`` contract), and wall-clock handler timings."""
    out = io.BytesIO()
    meta = {
        "version": 1,
        "n_validators": sim.n_validators,
        "genesis_time": sim.genesis_time,
        "slot": sim.slot,
        "accelerated": sim.accelerated_forkchoice,
        # Sharded mode (DESIGN.md §17): only the mesh SHAPE is simulation
        # state. Resident device arrays are never serialized — they
        # rebuild from the restored stores, placed per the partition
        # rules on whatever mesh is active at resume time, so a
        # checkpoint taken on a 2x4 mesh resumes bit-identically on 4x2,
        # 1x8, or a single device (pinned in tests/test_sharded_e2e.py).
        "sharded": getattr(sim, "sharded", None),
        "metrics": sim.metrics,
        "archive_roots": [r.hex() for r in sim.block_archive],
        # DAS (das/): sidecar CONTENT is a seeded pure function of the
        # chain, so only availability bookkeeping is recorded — which
        # (block, blob) pairs each view had verified — plus the engine
        # parameters, so ``resume(das=engine)`` can refuse a mismatched
        # engine loudly (a wrong seed/scheme would regenerate
        # self-consistent sidecars whose commitments never match any
        # block's graffiti: the chain stalls silently forever).
        "das": (sim.das.describe()
                if getattr(sim, "das", None) is not None else None),
        # Protocol variant (variants/, DESIGN.md §16): the describe()
        # fingerprint plus the full variant state (per-view vote
        # overlays, fast/kappa confirmations, per-slot FFG checkpoints
        # and evidence logs), so a resumed run — including a chaos repro
        # bundle — replays under the variant that produced it. Absent on
        # pre-seam checkpoints, which resume as Gasper.
        "variant": sim.variant.describe(),
        "variant_state": sim.variant.state_blob(sim),
        "groups": [{
            "id": g.id,
            "seq": g._seq,
            "queue": [[m.time, m.seq, m.kind] for m in sorted(g.queue)],
            "n_pool": len(g.pool),
            "blob_keys": [[r.hex(), i] for (r, i) in
                          getattr(g, "blob_store", None).sidecars]
            if getattr(g, "blob_store", None) is not None else [],
            "block_atts": {r.hex(): [a.hex() for a in atts]
                           for r, atts in g.block_atts.items()},
            # resident mirror supervision state: a degradation must
            # survive resume (the uninterrupted run answers from the host
            # path after one; a resurrected device path would break the
            # bit-identical contract in exactly the diverging case)
            "resident": None if g.resident is None else {
                "degraded": g.resident.degraded,
                "incidents": list(g.resident.incidents),
                "selfcheck_every": g.resident.selfcheck_every,
                "head_queries": g.resident._head_queries,
                "min_capacity": g.resident._min_capacity,
            },
        } for g in sim.groups],
    }
    _frame(out, json.dumps(meta).encode())
    for sb in sim.block_archive.values():
        _frame(out, serialize(sb))
    for g in sim.groups:
        _frame(out, save_store(g.store))
        for m in sorted(g.queue):
            _frame(out, serialize(m.payload))
        for att in g.pool.values():
            _frame(out, serialize(att))
    data = out.getvalue()
    if path is not None:
        atomic_write_bytes(path, data)
    return data


def load_simulation(data: bytes, schedule=None, telemetry=None,
                    adversaries=(), monitors=(), das=None, variant=None,
                    sharded=None, device=None):
    """Rebuild a ``save_simulation`` checkpoint into a live Simulation.
    ``schedule`` must be the run's original Schedule (with its FaultPlan)
    for faithful replay; crash flags re-derive from the plan + slot.
    ``telemetry`` re-attaches an event bus (not sim state; queue span ids
    are not serialized, so pre-checkpoint deliveries re-emitted after a
    resume carry no parent lineage). ``adversaries``/``monitors``
    re-attach in-loop strategies and property monitors; they bind AFTER
    the restore so their handles see the checkpointed stores, not the
    skeleton's. ``device`` is the ``Simulation``'s (the thread backend's
    when None). ``das`` re-attaches the
    run's blob engine (a ``BlobEngine``, or True or a scheme name for the
    default engine on the simulation's device) to a checkpoint of a DAS
    run; the thread's config must be the run's (``CellRows`` reads the
    cell width from it)."""
    from pos_evolution_tpu_torch.sim.driver import Simulation, _QueuedMessage
    buf = io.BytesIO(data)
    meta = json.loads(_unframe(buf).decode())
    assert meta["version"] == 1, f"unknown snapshot version {meta['version']}"
    # build the skeleton WITHOUT residents: __init__ would densify every
    # genesis store only for the mirrors to be rebuilt from the restored
    # stores below — at registry scale that doubles resume latency.
    # Telemetry attaches AFTER the restore (below), not here: __init__
    # would emit a run_start describing the skeleton (accelerated=False,
    # slot 0) instead of the checkpointed run.
    # Re-enable (or override) the sharded backend mode BEFORE residents
    # rebuild, so the restored message columns land sharded on the
    # current mesh (resume-across-mesh-shapes: the mesh shape is policy,
    # not layout — a different shape or device count re-shards).
    if sharded is None:
        meta_sharded = meta.get("sharded")
        sharded = (tuple(meta_sharded[a] for a in ("pods", "shard"))
                   if meta_sharded else None)
    sim = Simulation(meta["n_validators"], schedule=schedule,
                     genesis_time=meta["genesis_time"],
                     accelerated_forkchoice=False, sharded=sharded, device=device)
    sim.accelerated_forkchoice = meta["accelerated"]
    assert len(sim.groups) == len(meta["groups"]), \
        "schedule shape does not match the checkpointed run"
    sim.slot = meta["slot"]
    sim.metrics = list(meta["metrics"])
    sim.block_archive = {}
    for root_hex in meta["archive_roots"]:
        sb = deserialize(_unframe(buf), _payload_class("block"))
        sim.block_archive[bytes.fromhex(root_hex)] = sb
    plan = sim.schedule.faults
    for g, gm in zip(sim.groups, meta["groups"]):
        g.store = load_store(_unframe(buf), pow_chain=sim.pow_chain)
        g._seq = gm["seq"]
        g.queue = []
        for time_, seq, kind in gm["queue"]:
            payload = deserialize(_unframe(buf), _payload_class(kind))
            g.queue.append(_QueuedMessage(time_, seq, kind, payload))
        # entries were framed in sorted order, which is already heap order
        g.pool = {}
        for _ in range(gm["n_pool"]):
            att = deserialize(_unframe(buf), _payload_class("attestation"))
            g.pool[hash_tree_root(att)] = att
        g.block_atts = {bytes.fromhex(r): [bytes.fromhex(a) for a in atts]
                        for r, atts in gm["block_atts"].items()}
        g.crashed = bool(plan.crashed(g.id, sim.slot)) if plan else False
        if meta["accelerated"]:
            from pos_evolution_tpu_torch.ops.resident import ResidentForkChoice
            rm = gm.get("resident") or {}
            g.resident = ResidentForkChoice(
                g.store,
                capacity=rm.get("min_capacity", 64),
                selfcheck_every=rm.get("selfcheck_every", 64))
            # merge saved supervision state with anything the rebuild
            # itself just recorded (a still-broken device stays degraded)
            g.resident.degraded = g.resident.degraded or rm.get("degraded",
                                                                False)
            g.resident.incidents = (list(rm.get("incidents", []))
                                    + g.resident.incidents)
            g.resident._head_queries = rm.get("head_queries", 0)
    # Protocol variant: rebuild from the checkpoint's fingerprint when the
    # caller passes none (describe() round-trips via variant_from_config);
    # an explicit variant must match — a silently different rule would
    # replay a different protocol under the same evidence.
    from pos_evolution_tpu_torch.variants import variant_from_config
    meta_variant = meta.get("variant")
    if variant is None:
        variant = variant_from_config(meta_variant)
    elif meta_variant is not None and variant.describe() != meta_variant:
        raise ValueError(
            f"resumed variant {variant.describe()} does not match the "
            f"checkpointed variant {meta_variant}")
    sim.variant = variant
    variant.bind(sim)
    if variant.needs_view:
        for g in sim.groups:
            view = variant.make_view(g.id)
            g.variant_view = view
            g.store.variant_view = view
        variant.restore_blob(sim, meta.get("variant_state", {}))
    if telemetry is not None:
        # attach to the fully restored run: groups get the bus, the debug
        # checker anchors on the restored stores, the fault sink is
        # claimed for this run, and run_start describes the checkpointed
        # state (not the skeleton)
        sim.telemetry = telemetry
        for g in sim.groups:
            g.telemetry = telemetry
            if telemetry.debug:
                from pos_evolution_tpu_torch.utils.metrics import StoreInvariantChecker
                g.invariants = StoreInvariantChecker(g.store)
        if sim.schedule.faults is not None:
            sim.schedule.faults.sink = telemetry.bus
        telemetry.bus.emit(
            "run_start", n_validators=sim.n_validators,
            n_groups=sim.schedule.n_groups, genesis_time=sim.genesis_time,
            accelerated_forkchoice=sim.accelerated_forkchoice,
            debug=telemetry.debug, resumed_at_slot=sim.slot)
    if adversaries or monitors:
        sim.adversaries = list(adversaries)
        sim.monitors = list(monitors)
        sim._bind_adversaries_and_monitors()
    if meta.get("das") and das is not None and das is not False:
        from pos_evolution_tpu_torch.sim.driver import blob_engine_for
        _restore_das(sim, meta, blob_engine_for(das, sim.cfg, sim.backend.device))
    return sim


def _restore_das(sim, meta: dict, das) -> None:
    """Reattach a DAS engine to a resumed run: regenerate every archived
    block's sidecars from the seed (bit-identical by construction),
    rebuild per-group blob stores, and replay exactly the sidecars each
    view had verified at checkpoint time. Queued ``blob`` messages were
    serialized with the rest of the queue and deliver normally."""
    from pos_evolution_tpu_torch.das import BlobStore
    from pos_evolution_tpu_torch.das.containers import parse_das_graffiti
    if das.describe() != meta["das"]:
        raise ValueError(
            f"resumed DAS engine {das.describe()} does not match the "
            f"checkpointed engine {meta['das']} — regenerated sidecars "
            f"would never satisfy the availability gate")
    sim.das = das
    sim.blob_archive = {}
    for root, sb in sim.block_archive.items():
        if parse_das_graffiti(bytes(sb.message.body.graffiti)) is not None:
            sim.blob_archive[root] = das.regenerate(sb, root)
    registry = sim.telemetry.registry if sim.telemetry is not None else None
    for g, gm in zip(sim.groups, meta["groups"]):
        g.blob_store = BlobStore(das, registry=registry, group=g.id)
        g.store.blob_store = g.blob_store
        # insert directly: these sidecars were just regenerated from the
        # trusted seed (bit-identical by construction), so re-running the
        # full commitment + erasure verification per (group, block, blob)
        # would only multiply resume latency
        for root_hex, idx in gm.get("blob_keys", []):
            root = bytes.fromhex(root_hex)
            for sc in sim.blob_archive.get(root, ()):
                if int(sc.blob_index) == int(idx):
                    g.blob_store.sidecars.setdefault(
                        (root, int(idx)), {})[bytes(sc.commitment)] = sc
