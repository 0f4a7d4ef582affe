"""Per-tensor symmetric int8 weight quantisation (twin of the serving half
of repro.optim.compression).

Only `quantize_weight`/`dequantize_weight` are ported: the at-rest repair
rung restores int8 leaves exactly, and the tests hold that against the JAX
package. The gradient-compression half (`compress`, `decompress`,
`allreduce_compressed`) belongs to training and is ROADMAP item 1.12.
"""
from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 weight quantisation for serving
    (-> (q int8, scale f32 scalar)).

    The int8 leaves compose with the at-rest protection ladder: a
    ProtectionPlan built over the *quantized* param tree encodes its
    checksums and float64 locator sums from the int8 codes, and because
    integer sums are exact in f64 the audit detects and the repair rung
    restores a corrupted code EXACTLY."""
    w32 = w.to(F32)
    scale = torch.amax(torch.abs(w32)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = F32) -> torch.Tensor:
    """Inverse of quantize_weight (the serving-time decode)."""
    return (q.to(F32) * scale).to(dtype)
