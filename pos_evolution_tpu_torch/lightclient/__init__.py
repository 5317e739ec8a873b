"""Sync-committee & light-client subsystem (Altair capability surface).

Four layers: containers + proofs (spec dialect), the store state machine
(lightclient/spec.py), batched device verification (ops/sync_verify.py via
lightclient/verify.py), and the simulation participant (lightclient/node.py,
served by sim/driver.py through lightclient/server.py).
"""

from pos_evolution_tpu_torch.lightclient.containers import (
    CURRENT_SYNC_COMMITTEE_INDEX,
    FINALIZED_ROOT_DEPTH,
    FINALIZED_ROOT_INDEX,
    NEXT_SYNC_COMMITTEE_INDEX,
    STATE_TREE_DEPTH,
    LightClientBootstrap,
    LightClientFinalityUpdate,
    LightClientHeader,
    LightClientOptimisticUpdate,
    LightClientUpdate,
)
from pos_evolution_tpu_torch.lightclient.node import LightClientNode
from pos_evolution_tpu_torch.lightclient.proofs import (
    current_sync_committee_branch,
    finality_branch,
    header_for_block,
    next_sync_committee_branch,
    state_field_roots,
)
from pos_evolution_tpu_torch.lightclient.server import (
    bootstrap_from_store,
    build_head_update,
    build_update,
    make_bootstrap,
)
from pos_evolution_tpu_torch.lightclient.spec import (
    MIN_SYNC_COMMITTEE_PARTICIPANTS,
    LightClientStore,
    apply_light_client_update,
    finality_update_from,
    initialize_light_client_store,
    is_better_update,
    optimistic_update_from,
    process_light_client_finality_update,
    process_light_client_optimistic_update,
    process_light_client_store_force_update,
    process_light_client_update,
    sync_period_at_slot,
    update_timeout_slots,
    validate_light_client_update,
)
from pos_evolution_tpu_torch.lightclient.verify import (
    is_finality_update,
    is_sync_committee_update,
    signing_root_for_update,
    updates_to_batch,
    verify_updates,
)

__all__ = [
    "CURRENT_SYNC_COMMITTEE_INDEX",
    "FINALIZED_ROOT_DEPTH",
    "FINALIZED_ROOT_INDEX",
    "NEXT_SYNC_COMMITTEE_INDEX",
    "STATE_TREE_DEPTH",
    "MIN_SYNC_COMMITTEE_PARTICIPANTS",
    "LightClientBootstrap",
    "LightClientFinalityUpdate",
    "LightClientHeader",
    "LightClientNode",
    "LightClientOptimisticUpdate",
    "LightClientStore",
    "LightClientUpdate",
    "apply_light_client_update",
    "bootstrap_from_store",
    "build_head_update",
    "build_update",
    "current_sync_committee_branch",
    "finality_branch",
    "finality_update_from",
    "header_for_block",
    "initialize_light_client_store",
    "is_better_update",
    "is_finality_update",
    "is_sync_committee_update",
    "make_bootstrap",
    "next_sync_committee_branch",
    "optimistic_update_from",
    "process_light_client_finality_update",
    "process_light_client_optimistic_update",
    "process_light_client_store_force_update",
    "process_light_client_update",
    "signing_root_for_update",
    "state_field_roots",
    "sync_period_at_slot",
    "update_timeout_slots",
    "updates_to_batch",
    "validate_light_client_update",
    "verify_updates",
]
