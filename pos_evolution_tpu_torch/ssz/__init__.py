"""SSZ type system and merkleization (L1/L0 of SURVEY.md §1)."""

from pos_evolution_tpu_torch.ssz.core import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    Sedes,
    Vector,
    boolean,
    cached_root,
    deserialize,
    hash_tree_root,
    serialize,
    uint8,
    uint16,
    uint32,
    uint64,
)
from pos_evolution_tpu_torch.ssz.hash import hash_eth2, sha256, sha256_batch, sha256_pairs
from pos_evolution_tpu_torch.ssz.merkle import (
    ZERO_HASHES,
    is_valid_merkle_branch,
    merkle_tree_branch,
    merkleize,
    merkleize_chunks,
    mix_in_length,
)
