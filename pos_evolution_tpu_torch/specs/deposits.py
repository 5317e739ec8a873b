"""Deposit-tree construction (pos-evolution.md:81-107).

Builds the Merkle-proved deposits the state transition verifies in
``process_deposit`` (pos-evolution.md:139-147): a depth-32 incremental tree
of ``hash_tree_root(DepositData)`` leaves with the list-length mix-in as the
33rd proof element.
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.config import DOMAIN_DEPOSIT, cfg
from pos_evolution_tpu_torch.crypto.bls import bls
from pos_evolution_tpu_torch.specs.containers import Deposit, DepositData, DepositMessage
from pos_evolution_tpu_torch.specs.helpers import compute_domain, compute_signing_root
from pos_evolution_tpu_torch.ssz import hash_tree_root
from pos_evolution_tpu_torch.ssz.merkle import merkle_tree_branch, merkleize_chunks, mix_in_length


def build_deposit_data(sk: int, withdrawal_credentials: bytes, amount: int) -> DepositData:
    """Signed deposit (proof of possession, pos-evolution.md:156-163)."""
    pubkey = bls.SkToPk(sk)
    message = DepositMessage(pubkey=pubkey,
                             withdrawal_credentials=withdrawal_credentials,
                             amount=amount)
    signing_root = compute_signing_root(message, compute_domain(DOMAIN_DEPOSIT))
    return DepositData(pubkey=pubkey,
                       withdrawal_credentials=withdrawal_credentials,
                       amount=amount,
                       signature=bls.Sign(sk, signing_root))


def build_deposit_tree(deposit_datas: list[DepositData]):
    """Return (deposit_root, [Deposit]) for a batch of deposit data.

    ``deposit_root`` is ``hash_tree_root(List[DepositData, 2**32])`` — the
    eth1 contract root the state checks against; each proof is the depth-32
    branch plus the length chunk (pos-evolution.md:144).
    """
    depth = cfg().deposit_contract_tree_depth
    n = len(deposit_datas)
    leaves = np.frombuffer(
        b"".join(hash_tree_root(d) for d in deposit_datas), dtype=np.uint8
    ).reshape(n, 32) if n else np.empty((0, 32), dtype=np.uint8)
    tree_root = merkleize_chunks(leaves, 2**depth)
    deposit_root = mix_in_length(tree_root, n)
    length_chunk = n.to_bytes(32, "little")
    deposits = []
    for i, data in enumerate(deposit_datas):
        branch = merkle_tree_branch(leaves, i, depth) + [length_chunk]
        proof = np.frombuffer(b"".join(branch), dtype=np.uint8).reshape(depth + 1, 32)
        deposits.append(Deposit(proof=proof, data=data))
    return deposit_root, deposits
