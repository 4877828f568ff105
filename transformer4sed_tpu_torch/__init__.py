"""PyTorch/CUDA port of transformer4sed_tpu for NVIDIA Hopper (H100).

The JAX package ``transformer4sed_tpu`` is the reference; this package
mirrors its layout (``frontend/``, ``models/``, ``kernels/``, ``core/``,
``data/``, ``recipes/``, ``utils/``) so every module has an obvious
counterpart. It imports torch, numpy and scipy only.

The attention kernels that were Pallas TPU kernels in the reference are
CUDA C++ kernels here (``csrc/``), compiled with ``nvcc`` for ``sm_90a``
at first use and bound with ``ctypes``. Each has a plain PyTorch version
beside it, which the wrapper uses only for tensors that lie on the CPU.

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; without a CUDA device they raise.
"""
