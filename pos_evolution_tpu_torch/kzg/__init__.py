"""KZG polynomial commitments for the DAS grid (port of
``pos_evolution_tpu/kzg``).

- ``fr.py`` — the BLS12-381 scalar field Fr as Montgomery digit
  arithmetic: the numpy host twin (the oracle), the plain PyTorch
  versions, and kernel K10's elementwise entry for CUDA tensors.
- ``ntt.py`` — batched radix-2 NTT/INTT over Fr's 2^32 roots of unity:
  K10's butterfly stages on the card, the plain version on the CPU.
- ``curve.py`` — inversion-free Jacobian G1 arithmetic and a Pippenger
  MSM on Python ints, a copy of the JAX package's: the exact oracle of the
  G1 multi-scalar multiply (kernel K11, ``ops/pairing.g1_msm``).
- ``setup.py`` — the deterministic insecure powers-of-tau setup, on the
  card through K11's ladders, and the host oracle.
- ``aggregate.py`` — the two-group-element multiproof: all cells a client
  committee samples from one block verify with one pairing equation.
- ``scheme.py`` — ``KzgCellScheme``, ``get_scheme("kzg")`` of
  ``das/commitment.py``.
"""

__all__ = ["KzgCellScheme"]


def __getattr__(name):
    # lazy: importing the package for the field engine alone must not
    # drag the curve/setup modules in
    if name == "KzgCellScheme":
        from pos_evolution_tpu_torch.kzg.scheme import KzgCellScheme
        return KzgCellScheme
    raise AttributeError(name)
