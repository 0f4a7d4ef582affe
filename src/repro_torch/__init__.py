"""PyTorch/CUDA port of the FT-CNN ABFT system.

The layout mirrors the JAX package module for module
(`repro_torch.core.protected` is the twin of `repro.core.protected`, and so
on). Plain tensor code is PyTorch; the kernels of the protected CNN and
serving paths (`kernels/checksum_reduce.py`, `kernels/abft_matmul.py`
with `abft_matmul` and `abft_matmul_detect`) are CUDA C++ for Hopper,
built with nvcc at first use and bound with ctypes. A tensor on the CPU
takes each kernel's plain PyTorch version; a CUDA tensor launches the
kernel or raises.
"""
from ._device import fp32_ieee, resolve_device

__all__ = ["fp32_ieee", "resolve_device"]
