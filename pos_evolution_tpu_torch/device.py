"""Device resolution, 32-bit word helpers and the i32 checksum.

SHA-256 words travel in two forms. On a device and at every public
function they are 4 bytes wide: ``torch.int32`` holding the word's bit
pattern, which a kernel reads as ``uint32_t``. The plain PyTorch
arithmetic works on ``torch.int64`` holding the word's value in
[0, 2^32), because torch's uint32 lacks ``+``, ``>>``, ``<<`` and ``~``.
``u32`` and ``i32`` convert between the two, exactly.

Merkle tree nodes are (N, 8) int32 words; bytes appear only at the edges
(leaf packing, a root handed back as ``bytes``), and ``rows_to_words`` /
``words_to_rows`` convert (N, 32) uint8 rows on the device. Both read
int32 in the native byte order, little-endian on the CPU and the GPU.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_SIGN32 = 0x80000000


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for and there is none; nothing
    falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (``"cpu"`` for the CPU), for the JSON line of an entry point."""
    if dev.type != "cuda":
        return "cpu"
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def u32(x: torch.Tensor) -> torch.Tensor:
    """Words of any integer dtype -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def i32(x: torch.Tensor) -> torch.Tensor:
    """Words of any integer dtype -> int32 bit patterns (no overflowing cast)."""
    return (((x.to(torch.int64) & MASK32) ^ _SIGN32) - _SIGN32).to(torch.int32)


def words_to_torch(a: np.ndarray, device="cuda") -> torch.Tensor:
    """uint32 numpy words -> int32 bit-pattern tensor on ``device`` (CUDA
    unless the caller asks for another; raises without it)."""
    dev = resolve_device(device)
    a = np.array(a, dtype=np.uint32, order="C", copy=True)
    return torch.from_numpy(a.view(np.int32)).to(dev)


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Words tensor (int32 bit patterns or int64 values) -> uint32 numpy."""
    return i32(t.detach()).cpu().numpy().view(np.uint32)


def bytes_to_words(data: bytes) -> np.ndarray:
    """Big-endian u32 words of a byte string (len % 4 == 0)."""
    return np.frombuffer(data, dtype=">u4").astype(np.uint32)


def words_to_bytes(words) -> bytes:
    """u32 words -> big-endian bytes (a digest from its 8 state words)."""
    return np.asarray(words, dtype=np.uint32).astype(">u4").tobytes()


def rows_to_words(rows: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 rows -> (N, 8) int32 big-endian words, on the rows'
    device (the counterpart of ``ops/merkle_device._rows_to_words``).
    Each 4-byte group is reversed and read as one native (little-endian)
    int32, so no value is shifted or cast."""
    return rows.reshape(-1, 8, 4).flip(-1).contiguous().view(torch.int32).reshape(-1, 8)


def words_to_rows(words: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (N, 32) uint8 rows, on the words' device
    (the inverse of ``rows_to_words``)."""
    return words.contiguous().view(torch.uint8).reshape(-1, 8, 4).flip(-1).reshape(-1, 32)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        raise TypeError(f"checksum_tree: unsupported leaf {type(tree).__name__}")


def checksum_device(tree) -> torch.Tensor:
    """i32 wraparound sum of every element of every tensor leaf, as a 0-d
    int32 tensor on the first leaf's device (nothing is read back): each
    element taken as its low 32 bits (bools and bytes widened), summed
    modulo 2^32 (the counterpart of
    ``pos_evolution_tpu/utils/benchtime.py::checksum_tree``)."""
    acc = None
    for leaf in _leaves(tree):
        flat = leaf.reshape(-1)
        if flat.dtype != torch.int32:
            flat = u32(flat)
        part = flat.sum(dtype=torch.int64)
        acc = part if acc is None else acc + part.to(acc.device)
    return torch.zeros((), dtype=torch.int32) if acc is None else i32(acc)


def checksum_tree(tree) -> int:
    """``checksum_device`` read back: a signed 32-bit int."""
    return int(checksum_device(tree))
