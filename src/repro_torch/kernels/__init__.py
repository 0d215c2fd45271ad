"""Wrappers around the hand-written Hopper kernels (``csrc/``).

Each wrapper takes tensors on the CPU or on a CUDA device. On a CUDA
tensor it checks device, dtype, shape and contiguity and launches its
kernel (counted in :data:`launches`), or raises; there is no fallback. On
a CPU tensor it runs its plain PyTorch version, which is what the CPU
tests and ``chip_smoke.py``'s comparisons use.
"""
from repro_torch.kernels._build import launches, reset_launches

__all__ = ["launches", "reset_launches"]
