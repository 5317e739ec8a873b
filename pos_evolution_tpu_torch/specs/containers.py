"""Spec containers (L1): every ``class X(Container)`` of the reference.

Covers the full container inventory of SURVEY.md §2.1
(pos-evolution.md:36-45, 84-107, 219-221, 251-259, 286-289, 338-374,
548-557, 632-676, 689-717, 1154-1162) plus the referenced-but-not-inlined
envelope types (SignedBeaconBlock, BeaconBlockHeader, IndexedAttestation,
Eth1Data, Fork, SyncCommittee, SyncAggregate, ExecutionPayload).

Design departure from the reference (TPU-first, SURVEY.md §7): the validator
registry inside ``BeaconState`` is a dense struct-of-arrays
(``ValidatorRegistry``) rather than a Python list of ``Validator`` objects,
so registry-wide sweeps and merkleization are vectorized; ``Validator``
container views materialize on indexing for spec-level code.
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.config import FAR_FUTURE_EPOCH, cfg
from pos_evolution_tpu_torch.ssz.core import (
    Bitlist, Bitvector, ByteList, ByteVector, Bytes4, Bytes20, Bytes32, Bytes48,
    Bytes96, Container, List, Sedes, Vector, _UInt, boolean, uint8, uint64,
)
from pos_evolution_tpu_torch.ssz.hash import sha256_pairs
from pos_evolution_tpu_torch.ssz.merkle import merkleize_chunks, mix_in_length

uint256 = _UInt(32)

# Type aliases used by the reference throughout.
Slot = uint64
Epoch = uint64
CommitteeIndex = uint64
ValidatorIndex = uint64
Gwei = uint64
Root = Bytes32
BLSPubkey = Bytes48
BLSSignature = Bytes96
ParticipationFlags = uint8
DomainType = Bytes4


# --- dynamic-limit sedes helpers ---------------------------------------------
# Several BeaconState fields have config-dependent lengths; the reference
# resolves these from preset constants. We bind them at class definition to
# mainnet-scale limits and let ``Bytes32Rows``/registry adapters handle the
# actual runtime lengths (runtime arrays carry their own shape).


class Bytes32Rows(Sedes):
    """Vector/List of 32-byte roots stored as an (N, 32) uint8 array.

    Vectorized counterpart of ``Vector[Root, N]`` / ``List[Root, N]``
    (block_roots / state_roots / randao_mixes, pos-evolution.md:346-357).
    """

    def __init__(self, limit: int, is_list: bool):
        self.limit = limit
        self.is_list = is_list

    def is_fixed(self):
        # Offset-framed even in the Vector case: the runtime length is
        # config-dependent (minimal vs mainnet presets share the class).
        return False

    def serialize(self, value) -> bytes:
        return np.ascontiguousarray(value, dtype=np.uint8).tobytes()

    def deserialize(self, data: bytes) -> np.ndarray:
        return np.frombuffer(data, dtype=np.uint8).reshape(-1, 32).copy()

    def htr(self, value) -> bytes:
        arr = np.ascontiguousarray(value, dtype=np.uint8).reshape(-1, 32)
        if self.is_list:
            return mix_in_length(merkleize_chunks(arr, self.limit), arr.shape[0])
        return merkleize_chunks(arr, max(arr.shape[0], 1))

    def default(self) -> np.ndarray:
        n = 0 if self.is_list else self.limit
        return np.zeros((n, 32), dtype=np.uint8)


def RootVector(length: int) -> Bytes32Rows:
    return Bytes32Rows(length, is_list=False)


def RootList(limit: int) -> Bytes32Rows:
    return Bytes32Rows(limit, is_list=True)


# --- simple containers --------------------------------------------------------

class Fork(Container):
    previous_version: Bytes4
    current_version: Bytes4
    epoch: Epoch


class Checkpoint(Container):
    """Casper FFG checkpoint: (epoch, root) pair (pos-evolution.md:219-221)."""
    epoch: Epoch
    root: Root

    def as_key(self) -> tuple:
        return (int(self.epoch), bytes(self.root))


class Validator(Container):
    """Registry entry (pos-evolution.md:36-45)."""
    pubkey: BLSPubkey
    withdrawal_credentials: Bytes32
    effective_balance: Gwei
    slashed: boolean
    activation_eligibility_epoch: Epoch
    activation_epoch: Epoch
    exit_epoch: Epoch
    withdrawable_epoch: Epoch


class DepositMessage(Container):
    """Deposit intent (pos-evolution.md:84-87)."""
    pubkey: BLSPubkey
    withdrawal_credentials: Bytes32
    amount: Gwei


class DepositData(Container):
    """Signed deposit (pos-evolution.md:91-95)."""
    pubkey: BLSPubkey
    withdrawal_credentials: Bytes32
    amount: Gwei
    signature: BLSSignature


class Deposit(Container):
    """Merkle-proved deposit (pos-evolution.md:105-107)."""
    proof: RootVector(33)  # DEPOSIT_CONTRACT_TREE_DEPTH + 1 (length mix-in)
    data: DepositData


class VoluntaryExit(Container):
    """pos-evolution.md:251-253."""
    epoch: Epoch
    validator_index: ValidatorIndex


class SignedVoluntaryExit(Container):
    message: VoluntaryExit
    signature: BLSSignature


class Eth1Data(Container):
    deposit_root: Root
    deposit_count: uint64
    block_hash: Bytes32


class BeaconBlockHeader(Container):
    slot: Slot
    proposer_index: ValidatorIndex
    parent_root: Root
    state_root: Root
    body_root: Root


class SignedBeaconBlockHeader(Container):
    message: BeaconBlockHeader
    signature: BLSSignature


class AttestationData(Container):
    """LMD-GHOST vote + FFG vote (pos-evolution.md:689-696)."""
    slot: Slot
    index: CommitteeIndex
    beacon_block_root: Root
    source: Checkpoint
    target: Checkpoint


class Attestation(Container):
    """Aggregate attestation (pos-evolution.md:714-717)."""
    aggregation_bits: Bitlist(2048)  # MAX_VALIDATORS_PER_COMMITTEE
    data: AttestationData
    signature: BLSSignature


class IndexedAttestation(Container):
    """Referenced at pos-evolution.md:736, 975-976, 1456-1457."""
    attesting_indices: List(uint64, 2048)
    data: AttestationData
    signature: BLSSignature


class PendingAttestation(Container):
    aggregation_bits: Bitlist(2048)
    data: AttestationData
    inclusion_delay: Slot
    proposer_index: ValidatorIndex


class ProposerSlashing(Container):
    """pos-evolution.md:1154-1156."""
    signed_header_1: SignedBeaconBlockHeader
    signed_header_2: SignedBeaconBlockHeader


class AttesterSlashing(Container):
    """pos-evolution.md:1160-1162."""
    attestation_1: IndexedAttestation
    attestation_2: IndexedAttestation


class SyncCommittee(Container):
    """512 pubkeys rotated every 256 epochs (pos-evolution.md:542)."""
    pubkeys: List(Bytes48, 512)  # stored as list; length = cfg.sync_committee_size
    aggregate_pubkey: BLSPubkey


class SyncAggregate(Container):
    sync_committee_bits: Bitvector(512)
    sync_committee_signature: BLSSignature


class SyncCommitteeMessage(Container):
    """pos-evolution.md:548-557."""
    slot: Slot
    beacon_block_root: Root
    validator_index: ValidatorIndex
    signature: BLSSignature


class ExecutionPayloadHeader(Container):
    """Bellatrix execution payload header (pos-evolution.md:374)."""
    parent_hash: Bytes32
    fee_recipient: Bytes20
    state_root: Bytes32
    receipts_root: Bytes32
    logs_bloom: ByteVector(256)
    prev_randao: Bytes32
    block_number: uint64
    gas_limit: uint64
    gas_used: uint64
    timestamp: uint64
    extra_data: ByteList(32)
    base_fee_per_gas: uint256
    block_hash: Bytes32
    transactions_root: Root


class ExecutionPayload(Container):
    """pos-evolution.md:644 — transactions ride in this record."""
    parent_hash: Bytes32
    fee_recipient: Bytes20
    state_root: Bytes32
    receipts_root: Bytes32
    logs_bloom: ByteVector(256)
    prev_randao: Bytes32
    block_number: uint64
    gas_limit: uint64
    gas_used: uint64
    timestamp: uint64
    extra_data: ByteList(32)
    base_fee_per_gas: uint256
    block_hash: Bytes32
    transactions: List(ByteList(1073741824), 1048576)


class BeaconBlockBody(Container):
    """pos-evolution.md:632-644."""
    randao_reveal: BLSSignature
    eth1_data: Eth1Data
    graffiti: Bytes32
    proposer_slashings: List(ProposerSlashing, 16)
    attester_slashings: List(AttesterSlashing, 2)
    attestations: List(Attestation, 128)
    deposits: List(Deposit, 16)
    voluntary_exits: List(SignedVoluntaryExit, 16)
    sync_aggregate: SyncAggregate
    execution_payload: ExecutionPayload


class BeaconBlock(Container):
    """pos-evolution.md:671-676."""
    slot: Slot
    proposer_index: ValidatorIndex
    parent_root: Root
    state_root: Root
    body: BeaconBlockBody


class SignedBeaconBlock(Container):
    message: BeaconBlock
    signature: BLSSignature


# --- dense validator registry -------------------------------------------------

_VALIDATOR_FIXED_SIZE = 48 + 32 + 8 + 1 + 8 * 4  # 121 bytes


class ValidatorRegistry:
    """Struct-of-arrays mirror of ``List[Validator, LIMIT]``.

    The array level of SURVEY.md §7: every per-epoch sweep
    (process_effective_balance_updates pos-evolution.md:122-133, activity
    masks, churn) runs on these columns; ``registry[i]`` materializes a
    ``Validator`` container for spec-level call sites; hash_tree_root is
    computed with ~15 batched SHA-256 sweeps instead of 8N hashlib calls.
    """

    __slots__ = ("pubkeys", "withdrawal_credentials", "effective_balance", "slashed",
                 "activation_eligibility_epoch", "activation_epoch", "exit_epoch",
                 "withdrawable_epoch", "_pubkey_index")

    def __init__(self, n: int = 0):
        self._pubkey_index = None
        self.pubkeys = np.zeros((n, 48), dtype=np.uint8)
        self.withdrawal_credentials = np.zeros((n, 32), dtype=np.uint8)
        self.effective_balance = np.zeros(n, dtype=np.uint64)
        self.slashed = np.zeros(n, dtype=bool)
        self.activation_eligibility_epoch = np.full(n, FAR_FUTURE_EPOCH, dtype=np.uint64)
        self.activation_epoch = np.full(n, FAR_FUTURE_EPOCH, dtype=np.uint64)
        self.exit_epoch = np.full(n, FAR_FUTURE_EPOCH, dtype=np.uint64)
        self.withdrawable_epoch = np.full(n, FAR_FUTURE_EPOCH, dtype=np.uint64)

    def __len__(self) -> int:
        return self.effective_balance.shape[0]

    def __getitem__(self, i: int) -> Validator:
        return Validator(
            pubkey=self.pubkeys[i].tobytes(),
            withdrawal_credentials=self.withdrawal_credentials[i].tobytes(),
            effective_balance=int(self.effective_balance[i]),
            slashed=bool(self.slashed[i]),
            activation_eligibility_epoch=int(self.activation_eligibility_epoch[i]),
            activation_epoch=int(self.activation_epoch[i]),
            exit_epoch=int(self.exit_epoch[i]),
            withdrawable_epoch=int(self.withdrawable_epoch[i]),
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def set_pubkeys(self, pubkeys: np.ndarray) -> None:
        """Bulk-write the pubkey column (invalidates the lookup index).
        Use this (or set_validator) rather than writing ``.pubkeys`` rows
        directly — direct writes would leave ``find_pubkey`` stale."""
        self._pubkey_index = None
        self.pubkeys[:] = pubkeys

    def set_validator(self, i: int, v: Validator) -> None:
        self._pubkey_index = None
        self.pubkeys[i] = np.frombuffer(bytes(v.pubkey), dtype=np.uint8)
        self.withdrawal_credentials[i] = np.frombuffer(
            bytes(v.withdrawal_credentials), dtype=np.uint8)
        self.effective_balance[i] = v.effective_balance
        self.slashed[i] = v.slashed
        self.activation_eligibility_epoch[i] = v.activation_eligibility_epoch
        self.activation_epoch[i] = v.activation_epoch
        self.exit_epoch[i] = v.exit_epoch
        self.withdrawable_epoch[i] = v.withdrawable_epoch

    def append(self, v: Validator) -> None:
        n = len(self)
        self.pubkeys = np.vstack([self.pubkeys, np.zeros((1, 48), dtype=np.uint8)])
        self.withdrawal_credentials = np.vstack(
            [self.withdrawal_credentials, np.zeros((1, 32), dtype=np.uint8)])
        for f in ("effective_balance", "slashed", "activation_eligibility_epoch",
                  "activation_epoch", "exit_epoch", "withdrawable_epoch"):
            col = getattr(self, f)
            setattr(self, f, np.append(col, np.zeros(1, dtype=col.dtype)))
        self.set_validator(n, v)

    def find_pubkey(self, pubkey: bytes) -> int | None:
        """Index of ``pubkey`` in the registry, or None (pos-evolution.md:154-155).

        Backed by a lazily built dict (invalidated on registry growth):
        sync-aggregate processing does hundreds of lookups per block, and a
        linear scan is O(n) each at mainnet registry sizes.
        """
        cache = getattr(self, "_pubkey_index", None)
        if cache is None or len(cache) != len(self):
            cache = {self.pubkeys[i].tobytes(): i for i in range(len(self))}
            self._pubkey_index = cache
        return cache.get(bytes(pubkey))

    def copy(self) -> "ValidatorRegistry":
        out = ValidatorRegistry(0)
        for f in self.__slots__:
            if f == "_pubkey_index":
                continue
            setattr(out, f, getattr(self, f).copy())
        return out

    # -- vectorized SSZ -------------------------------------------------------
    def validator_roots(self) -> np.ndarray:
        """(N, 32) hash_tree_root of each Validator, fully batched."""
        n = len(self)
        if n == 0:
            return np.empty((0, 32), dtype=np.uint8)
        leaves = np.zeros((n, 8, 32), dtype=np.uint8)
        # pubkey: 48 bytes -> 2 chunks -> 1 hash
        pk_hi = np.zeros((n, 32), dtype=np.uint8)
        pk_hi[:, :16] = self.pubkeys[:, 32:]
        leaves[:, 0] = sha256_pairs(np.ascontiguousarray(self.pubkeys[:, :32]), pk_hi)
        leaves[:, 1] = self.withdrawal_credentials
        leaves[:, 2, :8] = self.effective_balance.astype("<u8").view(np.uint8).reshape(n, 8)
        leaves[:, 3, 0] = self.slashed.astype(np.uint8)
        for k, f in enumerate(("activation_eligibility_epoch", "activation_epoch",
                               "exit_epoch", "withdrawable_epoch")):
            leaves[:, 4 + k, :8] = getattr(self, f).astype("<u8").view(np.uint8).reshape(n, 8)
        # depth-3 merkle over the 8 field leaves, batched across validators
        layer = leaves.reshape(n * 8, 32)
        for _ in range(3):
            layer = sha256_pairs(layer[0::2], layer[1::2])
        return layer.reshape(n, 32)

    def __ssz_root__(self) -> bytes:
        root = merkleize_chunks(self.validator_roots(), cfg().validator_registry_limit)
        return mix_in_length(root, len(self))

    def serialize_bytes(self) -> bytes:
        n = len(self)
        buf = np.zeros((n, _VALIDATOR_FIXED_SIZE), dtype=np.uint8)
        buf[:, 0:48] = self.pubkeys
        buf[:, 48:80] = self.withdrawal_credentials
        buf[:, 80:88] = self.effective_balance.astype("<u8").view(np.uint8).reshape(n, 8)
        buf[:, 88] = self.slashed.astype(np.uint8)
        for k, f in enumerate(("activation_eligibility_epoch", "activation_epoch",
                               "exit_epoch", "withdrawable_epoch")):
            buf[:, 89 + 8 * k:97 + 8 * k] = getattr(self, f).astype(
                "<u8").view(np.uint8).reshape(n, 8)
        return buf.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "ValidatorRegistry":
        buf = np.frombuffer(data, dtype=np.uint8).reshape(-1, _VALIDATOR_FIXED_SIZE)
        n = buf.shape[0]
        out = cls(n)
        out.pubkeys = buf[:, 0:48].copy()
        out.withdrawal_credentials = buf[:, 48:80].copy()
        out.effective_balance = buf[:, 80:88].copy().view("<u8").reshape(n).astype(np.uint64)
        out.slashed = buf[:, 88].astype(bool)
        for k, f in enumerate(("activation_eligibility_epoch", "activation_epoch",
                               "exit_epoch", "withdrawable_epoch")):
            setattr(out, f, buf[:, 89 + 8 * k:97 + 8 * k].copy().view(
                "<u8").reshape(n).astype(np.uint64))
        return out


class _RegistrySedes(Sedes):
    def is_fixed(self):
        return False

    def serialize(self, value: ValidatorRegistry) -> bytes:
        return value.serialize_bytes()

    def deserialize(self, data: bytes) -> ValidatorRegistry:
        return ValidatorRegistry.from_bytes(data)

    def htr(self, value: ValidatorRegistry) -> bytes:
        return value.__ssz_root__()

    def default(self) -> ValidatorRegistry:
        return ValidatorRegistry(0)


class _U64ListSedes(Sedes):
    """List[uint64/uint8, VALIDATOR_REGISTRY_LIMIT] over numpy columns."""

    def __init__(self, dtype, limit: int):
        self.dtype = dtype
        self.byte_len = np.dtype(dtype).itemsize
        self.limit = limit

    def is_fixed(self):
        return False

    def serialize(self, value) -> bytes:
        return np.asarray(value, dtype=self.dtype).astype(f"<u{self.byte_len}").tobytes()

    def deserialize(self, data: bytes):
        return np.frombuffer(data, dtype=f"<u{self.byte_len}").astype(self.dtype).copy()

    def htr(self, value) -> bytes:
        arr = np.asarray(value, dtype=self.dtype)
        raw = arr.astype(f"<u{self.byte_len}").view(np.uint8)
        n_bytes = raw.size
        padded = np.zeros((max((n_bytes + 31) // 32, 1)) * 32, dtype=np.uint8)
        padded[:n_bytes] = raw
        per_chunk = 32 // self.byte_len
        limit_chunks = (self.limit + per_chunk - 1) // per_chunk
        chunks = (padded.reshape(-1, 32) if n_bytes
                  else np.empty((0, 32), dtype=np.uint8))
        return mix_in_length(merkleize_chunks(chunks, limit_chunks), arr.shape[0])

    def default(self):
        return np.zeros(0, dtype=self.dtype)


class _U64VectorSedes(Sedes):
    """Config-length Vector[uint64, N] over a numpy column (e.g. slashings).

    Declared variable-size so mainnet and minimal presets share one class;
    the runtime array carries its length.
    """

    def is_fixed(self):
        return False

    def serialize(self, value) -> bytes:
        return np.asarray(value, dtype=np.uint64).astype("<u8").tobytes()

    def deserialize(self, data: bytes):
        return np.frombuffer(data, dtype="<u8").astype(np.uint64).copy()

    def htr(self, value) -> bytes:
        arr = np.asarray(value, dtype=np.uint64)
        raw = arr.astype("<u8").view(np.uint8)
        padded = np.zeros(max((raw.size + 31) // 32, 1) * 32, dtype=np.uint8)
        padded[:raw.size] = raw
        return merkleize_chunks(padded.reshape(-1, 32))

    def default(self):
        return np.zeros(0, dtype=np.uint64)


_REG_LIMIT = 2**40


class BeaconState(Container):
    """The replicated state (pos-evolution.md:338-374).

    Registry-scale fields are dense numpy columns; everything else is
    spec-shaped. This is the single source of truth both levels share.
    """

    # Versioning
    genesis_time: uint64
    genesis_validators_root: Root
    slot: Slot
    fork: Fork
    # History
    latest_block_header: BeaconBlockHeader
    block_roots: RootVector(8192)
    state_roots: RootVector(8192)
    historical_roots: RootList(2**24)
    # Eth1
    eth1_data: Eth1Data
    eth1_data_votes: List(Eth1Data, 2048)
    eth1_deposit_index: uint64
    # Registry (dense columns)
    validators: _RegistrySedes()
    balances: _U64ListSedes(np.uint64, _REG_LIMIT)
    # Randomness
    randao_mixes: RootVector(65536)
    # Slashings
    slashings: _U64VectorSedes()
    # Participation (dense uint8 flag columns)
    previous_epoch_participation: _U64ListSedes(np.uint8, _REG_LIMIT)
    current_epoch_participation: _U64ListSedes(np.uint8, _REG_LIMIT)
    # Finality
    justification_bits: Bitvector(4)
    previous_justified_checkpoint: Checkpoint
    current_justified_checkpoint: Checkpoint
    finalized_checkpoint: Checkpoint
    # Inactivity
    inactivity_scores: _U64ListSedes(np.uint64, _REG_LIMIT)
    # Sync
    current_sync_committee: SyncCommittee
    next_sync_committee: SyncCommittee
    # Execution
    latest_execution_payload_header: ExecutionPayloadHeader

    def copy(self) -> "BeaconState":
        out = BeaconState.__new__(BeaconState)
        for f in self._fields:
            v = getattr(self, f)
            if isinstance(v, np.ndarray):
                setattr(out, f, v.copy())
            elif isinstance(v, (ValidatorRegistry, Container)):
                setattr(out, f, v.copy())
            elif isinstance(v, list):
                setattr(out, f, [x.copy() if hasattr(x, "copy") else x for x in v])
            else:
                setattr(out, f, v)
        # Share the incremental-merkleization cache with the copy: the
        # cache diffs against whatever it last hashed, so one cache serves
        # the whole copy lineage (ssz/incremental.py sharing contract).
        cache = self.__dict__.get("_htr_cache")
        if cache is not None:
            out._htr_cache = cache
        return out

    def __ssz_root__(self) -> bytes:
        """Route ``hash_tree_root(state)`` through the incremental
        merkleizer (ssz/incremental.py): only dirty subtrees re-hash.
        Bit-identical to ``BeaconState.htr`` (property-pinned)."""
        from pos_evolution_tpu_torch.ssz.incremental import state_root
        return state_root(self)


class LatestMessage:
    """Latest (epoch, root) vote per validator (pos-evolution.md:286-289)."""

    __slots__ = ("epoch", "root")

    def __init__(self, epoch: int, root: bytes):
        self.epoch = int(epoch)
        self.root = bytes(root)

    def __eq__(self, other):
        return (isinstance(other, LatestMessage)
                and self.epoch == other.epoch and self.root == other.root)

    def __hash__(self):
        return hash((self.epoch, self.root))

    def __repr__(self):
        return f"LatestMessage(epoch={self.epoch}, root={self.root[:4].hex()}..)"
