"""PyTorch/CUDA port of pos_evolution_tpu's array level.

A package of its own: it imports ``torch``, never ``jax``, and nothing of
``pos_evolution_tpu``. Entry points take ``device=`` and run on CUDA
unless the caller asks for the CPU; on the CPU every kernel wrapper takes
its plain PyTorch version. The kernels are CUDA C++ for ``sm_90a`` under
``csrc/``, built at first use (``ops/kernels.py``).

The main path is one mainnet epoch: ``python -m pos_evolution_tpu_torch.epoch``;
the registry-scale state roots around it:
``python -m pos_evolution_tpu_torch.state_roots``.
"""
