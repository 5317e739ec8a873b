"""Container -> array bridge: light-client updates as a ``SyncUpdateBatch``.

The store state machine (lightclient/spec.py) verifies every update through
this module, so the light client is a true second consumer of the crypto
kernels: with the ``jax`` backend active the sync-aggregate signature and
both merkle branches of each update are checked on device; the ``numpy``
backend runs the bit-identical host path.
"""

from __future__ import annotations

import hashlib

import numpy as np

from pos_evolution_tpu_torch.config import DOMAIN_SYNC_COMMITTEE
from pos_evolution_tpu_torch.lightclient.containers import (
    FINALIZED_ROOT_INDEX,
    NEXT_SYNC_COMMITTEE_INDEX,
    LightClientUpdate,
    participation_bits,
    sync_committee_lanes,
)
from pos_evolution_tpu_torch.ops.sync_verify import SyncUpdateBatch, verify_sync_update_batch
from pos_evolution_tpu_torch.specs.containers import SyncCommittee
from pos_evolution_tpu_torch.specs.helpers import compute_domain
from pos_evolution_tpu_torch.specs.transition import compute_signing_root_bytes
from pos_evolution_tpu_torch.ssz import hash_tree_root

__all__ = [
    "is_finality_update",
    "is_sync_committee_update",
    "signing_root_for_update",
    "updates_to_batch",
    "verify_updates",
]


def _branch_rows(branch) -> np.ndarray:
    return np.ascontiguousarray(branch, dtype=np.uint8).reshape(-1, 32)


# Committees change once per sync-committee period (256 epochs at the
# mainnet preset) but validation runs per update — cache the derived (S, 48)
# pubkey table and the committee's hash_tree_root, keyed by a digest of the
# ORDERED pubkey bytes + aggregate (the XOR aggregate alone is
# order-insensitive and duplicate-canceling, so distinct lane layouts would
# alias). One flat sha256 over the member bytes is an order of magnitude
# cheaper than either derivation.
_COMMITTEE_CACHE: dict = {}
_COMMITTEE_CACHE_MAX = 8


def _committee_entry(committee: SyncCommittee) -> dict:
    key = hashlib.sha256(
        b"".join(bytes(pk) for pk in committee.pubkeys)
        + bytes(committee.aggregate_pubkey)).digest()
    entry = _COMMITTEE_CACHE.get(key)
    if entry is None:
        table = np.zeros((len(committee.pubkeys), 48), dtype=np.uint8)
        for j, pk in enumerate(committee.pubkeys):
            table[j] = np.frombuffer(bytes(pk), dtype=np.uint8)
        table.setflags(write=False)
        entry = {"table": table, "root": hash_tree_root(committee)}
        if len(_COMMITTEE_CACHE) >= _COMMITTEE_CACHE_MAX:
            _COMMITTEE_CACHE.pop(next(iter(_COMMITTEE_CACHE)))
        _COMMITTEE_CACHE[key] = entry
    return entry


def _committee_pubkey_table(committee: SyncCommittee) -> np.ndarray:
    return _committee_entry(committee)["table"]


def _committee_root(committee: SyncCommittee) -> bytes:
    return _committee_entry(committee)["root"]


def _nonzero_branch(branch) -> bool:
    return bool(_branch_rows(branch).any())


def is_finality_update(update) -> bool:
    """An update proves finality iff it carries a non-empty finality branch."""
    return _nonzero_branch(update.finality_branch)


def is_sync_committee_update(update: LightClientUpdate) -> bool:
    return _nonzero_branch(update.next_sync_committee_branch)


def signing_root_for_update(update, fork_version: bytes,
                            genesis_validators_root: bytes) -> bytes:
    """What the sync committee signed: the attested block root under the
    sync-committee domain (specs/transition.process_sync_aggregate)."""
    domain = compute_domain(DOMAIN_SYNC_COMMITTEE, fork_version,
                            genesis_validators_root)
    return compute_signing_root_bytes(
        hash_tree_root(update.attested_header.beacon), domain)


def updates_to_batch(updates: list, committees: list[SyncCommittee],
                     fork_version: bytes, genesis_validators_root: bytes,
                     weights: np.ndarray | None = None) -> SyncUpdateBatch:
    """Dense batch for ``updates[i]`` signed by ``committees[i]``.

    ``weights`` (B, S) defaults to ones, making the weighted output a plain
    participation count; pass effective balances for stake weighting.
    Updates may be full ``LightClientUpdate``s or finality/optimistic slices
    (missing proof groups flow through with ``*_present=False``).
    """
    b = len(updates)
    assert b == len(committees) and b > 0
    s = sync_committee_lanes(committees[0])
    pubkeys = np.zeros((b, s, 48), dtype=np.uint8)
    bits = np.zeros((b, s), dtype=bool)
    messages = np.zeros((b, 32), dtype=np.uint8)
    signatures = np.zeros((b, 96), dtype=np.uint8)
    fin_leaf = np.zeros((b, 32), dtype=np.uint8)
    fin_depth = LightClientUpdate._fields["finality_branch"].limit
    sc_depth = LightClientUpdate._fields["next_sync_committee_branch"].limit
    fin_branch = np.zeros((b, fin_depth, 32), dtype=np.uint8)
    fin_root = np.zeros((b, 32), dtype=np.uint8)
    fin_present = np.zeros(b, dtype=bool)
    sc_leaf = np.zeros((b, 32), dtype=np.uint8)
    sc_branch = np.zeros((b, sc_depth, 32), dtype=np.uint8)
    sc_root = np.zeros((b, 32), dtype=np.uint8)
    sc_present = np.zeros(b, dtype=bool)

    for i, (update, committee) in enumerate(zip(updates, committees)):
        assert sync_committee_lanes(committee) == s, "mixed committee sizes"
        pubkeys[i] = _committee_pubkey_table(committee)
        bits[i] = participation_bits(update.sync_aggregate, s)
        messages[i] = np.frombuffer(
            signing_root_for_update(update, fork_version, genesis_validators_root),
            dtype=np.uint8)
        signatures[i] = np.frombuffer(
            bytes(update.sync_aggregate.sync_committee_signature), dtype=np.uint8)
        attested_state_root = bytes(update.attested_header.beacon.state_root)
        if hasattr(update, "finality_branch") and is_finality_update(update):
            fin_leaf[i] = np.frombuffer(
                hash_tree_root(update.finalized_header.beacon), dtype=np.uint8)
            fin_branch[i] = _branch_rows(update.finality_branch)
            fin_root[i] = np.frombuffer(attested_state_root, dtype=np.uint8)
            fin_present[i] = True
        if (hasattr(update, "next_sync_committee_branch")
                and is_sync_committee_update(update)):
            sc_leaf[i] = np.frombuffer(
                _committee_root(update.next_sync_committee), dtype=np.uint8)
            sc_branch[i] = _branch_rows(update.next_sync_committee_branch)
            sc_root[i] = np.frombuffer(attested_state_root, dtype=np.uint8)
            sc_present[i] = True

    if weights is None:
        weights = np.ones((b, s), dtype=np.int64)
    return SyncUpdateBatch(
        pubkeys=pubkeys, bits=bits, weights=np.asarray(weights, dtype=np.int64),
        messages=messages, signatures=signatures,
        fin_leaf=fin_leaf, fin_branch=fin_branch,
        fin_index=np.full(b, FINALIZED_ROOT_INDEX, dtype=np.int64),
        fin_root=fin_root, fin_present=fin_present,
        sc_leaf=sc_leaf, sc_branch=sc_branch,
        sc_index=np.full(b, NEXT_SYNC_COMMITTEE_INDEX, dtype=np.int64),
        sc_root=sc_root, sc_present=sc_present,
    )


def verify_updates(updates: list, committees: list[SyncCommittee],
                   fork_version: bytes, genesis_validators_root: bytes,
                   weights: np.ndarray | None = None) -> dict:
    """Batch-verify through the active ExecutionBackend (numpy ⇄ jax)."""
    batch = updates_to_batch(updates, committees, fork_version,
                             genesis_validators_root, weights)
    return verify_sync_update_batch(batch)
