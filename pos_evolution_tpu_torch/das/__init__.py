"""Data-availability-sampling subsystem (port of
``pos_evolution_tpu/das/__init__.py``).

- **data**: erasure-coded blobs (``das/erasure.py``), SSZ blob sidecars
  over the extended cell grid (``das/containers.py``), and pluggable cell
  commitments (``das/commitment.py``: merkle; ``kzg/scheme.py``: KZG);
- **verification**: batched sample checks and the erasure-reconstruction
  check on the port's backend (``ops/das_verify.py``: kernels K2, K6, K7);
- **availability**: deterministic blob production and per-view stores
  feeding the fork-choice availability gate (``das/engine.py``);
- **serving**: a vectorized 10^5+ sampling-client population with request
  coalescing and LRU proof and update caches (``das/sampler.py``,
  ``das/server.py``), driven per slot by ``sim/driver.py``; the dense
  driver's rider is ``das/dense_rider.py``.

The engine, the stores and the population take their config explicitly;
the copied server reads the thread's (``config.cfg``), so a caller runs it
under the config it built them with.
"""

from pos_evolution_tpu_torch.das.commitment import (
    CellCommitmentScheme,
    MerkleCellScheme,
    get_scheme,
    register_scheme,
)
from pos_evolution_tpu_torch.das.containers import (
    MAX_EXTENDED_CELLS,
    BlobSidecar,
    CellRows,
    das_graffiti,
    parse_das_graffiti,
)
from pos_evolution_tpu_torch.das.engine import BlobEngine, BlobStore
from pos_evolution_tpu_torch.das.erasure import (
    extend_blob,
    extension_matrix,
    gf_matmul,
    reconstruct_blob,
)
from pos_evolution_tpu_torch.das.sampler import SamplingClientPopulation
from pos_evolution_tpu_torch.das.server import DasServer, LRUCache

__all__ = [
    "MAX_EXTENDED_CELLS",
    "BlobEngine",
    "BlobSidecar",
    "BlobStore",
    "CellCommitmentScheme",
    "CellRows",
    "DasServer",
    "LRUCache",
    "MerkleCellScheme",
    "SamplingClientPopulation",
    "das_graffiti",
    "extend_blob",
    "extension_matrix",
    "get_scheme",
    "gf_matmul",
    "parse_das_graffiti",
    "reconstruct_blob",
    "register_scheme",
]
