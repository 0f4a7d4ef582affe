"""PyTorch/CUDA port of the FT-CNN ABFT system.

The layout mirrors the JAX package module for module
(`repro_torch.core.protected` is the twin of `repro.core.protected`, and so
on). It runs protected CNN inference under an offline ProtectionPlan
(analytic, or priced on the card's measured roofline with each layer's
kernel route chosen by profiling: `core.cost_model`, `core.policy`),
protected LLM serving (`serving`: the synchronous ProtectedSession and the
async ServingDriver, launched by `launch.serve`), the fault-injection
campaign and at-rest weight repair. Plain tensor code is PyTorch; the
kernels of the protected CNN and serving paths
(`kernels/checksum_reduce.py`, `kernels/abft_matmul.py` with
`abft_matmul` and `abft_matmul_detect`) are CUDA C++ for Hopper, built
with nvcc at first use and bound with ctypes. A tensor on the CPU takes
each kernel's plain PyTorch version; a CUDA tensor launches the kernel or
raises.
"""
from ._device import fp32_ieee, resolve_device

__all__ = ["fp32_ieee", "resolve_device"]
