"""The spec's ``hash``: SHA-256 through hashlib (the port's copy of
``pos_evolution_tpu/ssz/hash.py::hash_eth2``)."""

from __future__ import annotations

import hashlib


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


hash_eth2 = sha256
