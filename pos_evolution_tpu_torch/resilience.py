"""State witnesses of a dense run (port of ``fingerprint_config`` and the
dense branch of ``state_digest`` in ``pos_evolution_tpu/resilience/__init__.py``).

The JAX package's run supervision (checkpoint manager, supervisor,
integrity guard) is not ported here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from pos_evolution_tpu_torch.ops.merkle_device import digest_bytes

__all__ = ["fingerprint_config", "state_digest"]


def fingerprint_config(cfg) -> str:
    """Stable 16-hex hash of a ``config.Config``."""
    blob = json.dumps({k: (v.hex() if isinstance(v, bytes) else v)
                       for k, v in dataclasses.asdict(cfg).items()},
                      sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def state_digest(sim) -> str:
    """Digest of a ``DenseSimulation``'s state (view 0): every registry
    column, ``msg_block`` and ``msg_epoch`` through the merkle payload
    digest where they lie (kernel K2 for a run on the card, its plain
    version with ``sim.plain`` or on the CPU), then the block tree, the
    FFG scalars, the metrics and the slot cursor. Equal to the JAX
    package's ``state_digest`` of the same run."""
    h = hashlib.sha256()
    for col in (*sim.registry, sim.msg_block, sim.msg_epoch):
        h.update(digest_bytes(col[: sim.n], plain=sim.plain))
    meta = {"slot": sim.slot, "roots": [r.hex() for r in sim.roots],
            "parents": sim.parents, "block_slots": sim.block_slots,
            "bits": [bool(b) for b in sim.bits],
            "prev_just": list(sim.prev_just),
            "cur_just": list(sim.cur_just),
            "finalized": list(sim.finalized),
            "metrics": sim.metrics}
    h.update(json.dumps(meta, sort_keys=True).encode())
    return h.hexdigest()
