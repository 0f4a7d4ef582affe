"""Int8 error-feedback gradient compression and per-tensor symmetric int8
weight quantisation (twin of repro.optim.compression).

Gradient scheme: per-tensor symmetric int8 quantisation with an
error-feedback accumulator (the quantisation residual is added back before
the next step's compression), which keeps SGD/Adam convergence unbiased in
expectation. `allreduce_compressed` is the reduction over a process group
(a mesh axis's: launch.mesh.Mesh.group): every rank quantises against the
group's max, the int8 payloads are summed in int32 and decompressed.
Nothing wires it into the train step, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

F32 = torch.float32


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q int8, scale f32 scalar, new_err)."""
    g32 = g.to(F32) + err.to(F32)
    scale = torch.amax(torch.abs(g32)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_err = g32 - q.to(F32) * scale
    return q, scale, new_err


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def allreduce_compressed(g: torch.Tensor, err: torch.Tensor, group=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce g over `group` (a torch.distributed process group; the
    world when None) with an int8 payload and error feedback -> (g
    reduced, in g's type; new_err).

    All ranks quantise against the group's max (one max all-reduce), so
    the int32 sum decompresses exactly - no per-rank-scale bias."""
    g32 = g.to(F32) + err.to(F32)
    amax = torch.amax(torch.abs(g32)).reshape(1).clone()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax[0] / 127.0 + 1e-30
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_err = g32 - q.to(F32) * scale
    # int8 payloads summed in int32 (no overflow below 2^23 ranks)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    g_red = qsum.to(F32) * scale / n
    return g_red.to(g.dtype), new_err


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
