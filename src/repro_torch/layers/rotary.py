"""Rotary position embeddings (twin of repro.layers.rotary), decode-offset
aware."""
from __future__ import annotations

import torch

F32 = torch.float32


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> (sin, cos) of shape (..., head_dim/2)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=F32,
                                          device=positions.device) / half))
    ang = positions.to(F32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """x: (B, S, H, D); sin/cos: (S, D/2) or (B, S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.dim() == 2:
        sin = sin[None, :, None, :]
        cos = cos[None, :, None, :]
    else:
        sin = sin[:, :, None, :]
        cos = cos[:, :, None, :]
    x32_1, x32_2 = x1.to(F32), x2.to(F32)
    out = torch.cat([x32_1 * cos - x32_2 * sin, x32_2 * cos + x32_1 * sin],
                    dim=-1)
    return out.to(x.dtype)
