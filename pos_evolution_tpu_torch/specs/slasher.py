"""Slasher (watchtower): accountability made operational (SURVEY.md §2.5).

The reference defines the violations — double votes and surround votes
(pos-evolution.md:233-238, 1128-1143) and equivocating proposals
(:1154-1156) — and notes "the evidence of the violation can be observed"
(:238, 1148). This component does the observing: it ingests indexed
attestations and signed block headers, maintains per-validator vote
histories, and emits ready-to-include ``AttesterSlashing`` /
``ProposerSlashing`` evidence, closing the accountable-safety loop
(detected evidence -> ``process_attester_slashing`` /
``on_attester_slashing`` -> stake slashed + fork-choice discounting).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from pos_evolution_tpu_torch.specs.containers import (
    AttesterSlashing,
    IndexedAttestation,
    ProposerSlashing,
    SignedBeaconBlockHeader,
)
from pos_evolution_tpu_torch.specs.helpers import is_slashable_attestation_data


class Slasher:
    """Ingests consensus messages, emits slashing evidence."""

    def __init__(self):
        # validator -> target epoch -> [(data_root, IndexedAttestation)]
        self._by_validator: dict[int, dict[int, list[tuple[bytes, IndexedAttestation]]]] = \
            defaultdict(lambda: defaultdict(list))
        # full history per validator for the surround scan
        self._spans: dict[int, list[tuple[int, int, bytes, IndexedAttestation]]] = \
            defaultdict(list)
        # (data_root, validator) pairs already ingested (replay dedup)
        self._seen: set[tuple[bytes, int]] = set()
        # (proposer, slot) -> first signed header seen
        self._headers: dict[tuple[int, int], SignedBeaconBlockHeader] = {}
        self._emitted: set = set()

    # -- attestations ---------------------------------------------------------
    def on_attestation(self, indexed: IndexedAttestation) -> list[AttesterSlashing]:
        """Record an indexed attestation; return any new evidence.

        Data roots are hashed once per ingest and cached with the history;
        replayed (data, validator) pairs are skipped outright.
        """
        out: list[AttesterSlashing] = []
        call_pairs: set = set()
        data = indexed.data
        src, tgt = int(data.source.epoch), int(data.target.epoch)
        data_root_new = self._root(data)

        for v in (int(i) for i in np.asarray(indexed.attesting_indices)):
            if (data_root_new, v) in self._seen:
                continue
            self._seen.add((data_root_new, v))
            # double vote: same target epoch, different data
            for prior_root, prior in self._by_validator[v][tgt]:
                if prior_root != data_root_new \
                        and is_slashable_attestation_data(prior.data, data):
                    out.extend(self._emit(v, prior_root, prior,
                                          data_root_new, indexed, call_pairs))
                    break
            # surround in either direction
            for (ps, pt, prior_root, prior) in self._spans[v]:
                if (ps < src and tgt < pt) or (src < ps and pt < tgt):
                    out.extend(self._emit(v, prior_root, prior,
                                          data_root_new, indexed, call_pairs))
                    break
            self._by_validator[v][tgt].append((data_root_new, indexed))
            self._spans[v].append((src, tgt, data_root_new, indexed))
        return out

    @staticmethod
    def _root(data) -> bytes:
        from pos_evolution_tpu_torch.ssz import hash_tree_root
        return hash_tree_root(data)

    def _emit(self, validator: int, root1: bytes, a1: IndexedAttestation,
              root2: bytes, a2: IndexedAttestation,
              call_pairs: set) -> list[AttesterSlashing]:
        # Keyed per implicated validator, so a *later* equivocator covered
        # by an already-reported data pair still yields evidence. Within one
        # ingest, the *exact aggregate pair* is emitted at most once: a
        # suppressed validator is then necessarily in the emitted pair's
        # intersection (it sits in both aggregates), so no evidence is lost
        # — aggregates that merely share a data root get their own emission.
        key = (validator,) + tuple(sorted((root1, root2)))
        if key in self._emitted:
            return []
        self._emitted.add(key)
        from pos_evolution_tpu_torch.ssz import hash_tree_root
        pair = tuple(sorted((hash_tree_root(a1), hash_tree_root(a2))))
        if pair in call_pairs:
            return []
        call_pairs.add(pair)
        # order so attestation_1 is the surrounding/earlier vote
        if is_slashable_attestation_data(a1.data, a2.data):
            return [AttesterSlashing(attestation_1=a1, attestation_2=a2)]
        return [AttesterSlashing(attestation_1=a2, attestation_2=a1)]

    # -- block headers --------------------------------------------------------
    def on_block_header(self, signed: SignedBeaconBlockHeader) -> ProposerSlashing | None:
        """Record a signed header; equivocating proposals yield evidence."""
        h = signed.message
        key = (int(h.proposer_index), int(h.slot))
        prior = self._headers.get(key)
        if prior is None:
            self._headers[key] = signed
            return None
        if prior.message == h:
            return None
        ekey = ("hdr", key)
        if ekey in self._emitted:
            return None
        self._emitted.add(ekey)
        return ProposerSlashing(signed_header_1=prior, signed_header_2=signed)

    # -- introspection --------------------------------------------------------
    def tracked_validators(self) -> int:
        return len(self._spans)
