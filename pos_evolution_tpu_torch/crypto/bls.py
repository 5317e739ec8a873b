"""BLS12-381 signature interface with pluggable backends (component N1).

The reference assumes a BLS library throughout: ``bls.Verify`` for deposits
(pos-evolution.md:165), aggregate signatures over ``aggregation_bits``
(:714-717), and sync aggregates (:642). Mirroring the pyspec bls-setting
toggle (SURVEY.md §4.4a), we expose one interface with two backends:

- ``FakeBLS`` (default): deterministic hash-based scheme. "Signatures" are
  sha256 commitments to (pubkey, message); aggregation is XOR, so aggregate
  verification is order-independent and batched. Protocol-logic tests run
  against this.
- ``PyBLS`` (crypto/bls12_381.py): a real BLS12-381 pairing implementation
  used as the correctness oracle for the native/TPU kernels.

Keys: a validator's secret key is an integer; ``FakeBLS`` pubkeys are 48-byte
digests of the secret key, matching the real key-size layout.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

__all__ = ["bls", "FakeBLS", "set_bls_backend", "get_bls_backend"]


def _xor_bytes(parts: Sequence[bytes], size: int) -> bytes:
    acc = np.zeros(size, dtype=np.uint8)
    for p in parts:
        acc ^= np.frombuffer(p, dtype=np.uint8)
    return acc.tobytes()


class FakeBLS:
    """Deterministic stand-in scheme preserving the BLS API shape.

    sign(sk, msg)            = H(pubkey(sk) || msg) expanded to 96 bytes
    Aggregate(sigs)          = XOR of signatures
    FastAggregateVerify      = XOR of individual expected signatures == agg
    """

    name = "fake"

    @staticmethod
    def SkToPk(sk: int) -> bytes:
        h = hashlib.sha256(b"fakebls-pk" + int(sk).to_bytes(32, "little")).digest()
        return (h + h[:16])  # 48 bytes

    # 16-byte prefix: the first SHA-256 block of (prefix | pubkey) is then
    # exactly 64 bytes and depends only on the pubkey, so the TPU batch
    # kernel (ops/aggregation.py) precomputes it once per validator.
    SIG_PREFIX = b"fakebls-sig-pad!"

    @staticmethod
    def _sig_for(pubkey: bytes, message: bytes) -> bytes:
        h1 = hashlib.sha256(FakeBLS.SIG_PREFIX + pubkey + message).digest()
        h2 = hashlib.sha256(h1).digest()
        h3 = hashlib.sha256(h2).digest()
        return h1 + h2 + h3  # 96 bytes

    @classmethod
    def Sign(cls, sk: int, message: bytes) -> bytes:
        return cls._sig_for(cls.SkToPk(sk), message)

    @classmethod
    def Verify(cls, pubkey: bytes, message: bytes, signature: bytes) -> bool:
        return signature == cls._sig_for(bytes(pubkey), bytes(message))

    @classmethod
    def Aggregate(cls, signatures: Sequence[bytes]) -> bytes:
        if not signatures:
            raise ValueError("cannot aggregate zero signatures")
        return _xor_bytes(signatures, 96)

    @classmethod
    def AggregatePKs(cls, pubkeys: Sequence[bytes]) -> bytes:
        return _xor_bytes(pubkeys, 48)

    @classmethod
    def FastAggregateVerify(cls, pubkeys: Sequence[bytes], message: bytes,
                            signature: bytes) -> bool:
        """All pubkeys signed the same message (attestation aggregation)."""
        if not pubkeys:
            return False
        expected = _xor_bytes([cls._sig_for(bytes(pk), bytes(message)) for pk in pubkeys], 96)
        return expected == bytes(signature)

    @classmethod
    def AggregateVerify(cls, pubkeys: Sequence[bytes], messages: Sequence[bytes],
                        signature: bytes) -> bool:
        if not pubkeys or len(pubkeys) != len(messages):
            return False
        expected = _xor_bytes(
            [cls._sig_for(bytes(pk), bytes(m)) for pk, m in zip(pubkeys, messages)], 96)
        return expected == bytes(signature)


class _Dispatch:
    """`bls` module-like object the spec code calls into (pos-evolution.md:165)."""

    def __init__(self):
        self._backend = FakeBLS

    def __getattr__(self, item):
        return getattr(self._backend, item)


bls = _Dispatch()


def set_bls_backend(backend) -> None:
    bls._backend = backend


def get_bls_backend():
    return bls._backend
