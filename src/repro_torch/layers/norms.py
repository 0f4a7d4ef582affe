"""Normalisation + activation helpers (twin of repro.layers.norms): fp32
internals, cast back to the input's type."""
from __future__ import annotations

import torch

F32 = torch.float32


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (offset + scale.to(F32))
    return y.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return (cap * torch.tanh(x.to(F32) / cap)).to(x.dtype)


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    """The activation in x's own type, as jax.nn computes it (F.silu
    would upcast a bf16 input; the port keeps JAX's rounding)."""
    if act == "silu":
        return x * torch.sigmoid(x)
    if act == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if act == "relu":
        return torch.relu(x)
    raise ValueError(act)
