"""Gated-linear-unit FFN (SwiGLU/GeGLU), ABFT-protected (twin of
repro.layers.ffn)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core import (DetectEvidence, ModelReport, ProtectConfig,
                    merge_verdicts)
from .linear import apply_dense, init_dense
from .norms import activate


def init_ffn(generator: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.bfloat16, device=None) -> Dict:
    return {
        "gate": init_dense(generator, d_model, d_ff, dtype=dtype,
                           device=device),
        "up": init_dense(generator, d_model, d_ff, dtype=dtype,
                         device=device),
        "down": init_dense(generator, d_ff, d_model, dtype=dtype,
                           scale=d_ff ** -0.5, device=device),
    }


def apply_ffn(params: Dict, x: torch.Tensor, abft: ProtectConfig = None,
              act: str = "silu") -> Tuple[torch.Tensor, ModelReport]:
    g, r1 = apply_dense(params["gate"], x, abft, name="gate")
    u, r2 = apply_dense(params["up"], x, abft, name="up")
    h = activate(g, act) * u
    y, r3 = apply_dense(params["down"], h, abft, name="down")
    if isinstance(r1, DetectEvidence):
        # detect-only pass: the compact carry form, merged
        return y, merge_verdicts(merge_verdicts(r1, r2), r3)
    return y, ModelReport({"gate": r1, "up": r2, "down": r3})
