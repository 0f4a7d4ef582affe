"""Fused ABFT matmul: O = D @ W with the output summations in the GEMM
epilogue (twin of repro.kernels.abft_matmul's `abft_matmul`).

    colsum : (N/bm, M)    per-row-tile column sums   -> S_o1/S_o5/S_o7
    rowsum : (N, M/bn)    per-col-tile row sums      -> S_o2/S_o6
    sumsq  : (N/bm, M/bn) per-tile sum of squares    -> detection threshold

kernels.ops.chunk_sums_from_partials finishes them at any chunk
granularity that is a multiple of (bm, bn). On a CUDA tensor this launches
the CUDA kernel in csrc/abft_matmul.cu, whose block tile (64 x 64, or
16 x 32 for N <= 16) reduces to partials at granularity up to 64 in each
axis; a coarser (bm, bn) is summed from those. On a CPU tensor it runs the plain version
(ref.abft_matmul_ref). `LAUNCHES` counts the kernel's launches.

The JAX package's third kernel, `abft_matmul_detect` (the GEMM with the
CoC-D compare in its epilogue), is not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .ref import abft_matmul_ref

F32 = torch.float32
KERNEL_TILE = 64   # the coarsest partial tile the CUDA kernel reduces to
LAUNCHES = 0


def _pow2(x: int) -> bool:
    return x >= 1 and x & (x - 1) == 0


def _launch(d: torch.Tensor, w: torch.Tensor, bm: int, bn: int) -> Tuple:
    global LAUNCHES
    if d.dtype != F32 or w.dtype != F32:
        raise NotImplementedError(
            f"abft_matmul kernel takes float32, got {d.dtype} @ {w.dtype}")
    if not (d.is_contiguous() and w.is_contiguous()):
        raise ValueError("abft_matmul kernel needs contiguous operands")
    if d.device != w.device:
        raise ValueError(f"operands on {d.device} and {w.device}")
    if not (_pow2(bm) and _pow2(bn)):
        raise ValueError(f"partial tiles must be powers of two, got {bm, bn}")
    n, k = d.shape
    m = w.shape[1]
    pbm, pbn = min(bm, KERNEL_TILE), min(bn, KERNEL_TILE)
    gm, gn = bm // pbm, bn // pbn
    rows_t, cols_t = -(-n // bm), -(-m // bn)
    dev = d.device
    # tiles past the edge of O are not written; when kernel partials are
    # summed into coarser ones they must read as zero
    alloc = torch.zeros if gm > 1 or gn > 1 else torch.empty
    o = torch.empty((n, m), dtype=F32, device=dev)
    colsum = alloc((rows_t * gm, m), dtype=F32, device=dev)
    rowsum = alloc((n, cols_t * gn), dtype=F32, device=dev)
    sumsq = alloc((rows_t * gm, cols_t * gn), dtype=F32, device=dev)
    fn = _build.function("abft_matmul", "repro_abft_matmul_f32",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                         + [ctypes.c_void_p])
    _build.launch(fn, dev, d.data_ptr(), w.data_ptr(), o.data_ptr(), n,
                        k, m, pbm, pbn, colsum.data_ptr(), rowsum.data_ptr(),
                        sumsq.data_ptr(), cols_t * gn, cols_t * gn)
    LAUNCHES += 1
    if gm > 1:
        colsum = colsum.reshape(rows_t, gm, m).sum(dim=1)
        sumsq = sumsq.reshape(rows_t, gm, -1).sum(dim=1)
    if gn > 1:
        rowsum = rowsum.reshape(n, cols_t, gn).sum(dim=2)
        sumsq = sumsq.reshape(rows_t, cols_t, gn).sum(dim=2)
    return o, (colsum, rowsum, sumsq, bm, bn)


def abft_matmul(d: torch.Tensor, w: torch.Tensor, bm: int, bn: int
                ) -> Tuple[torch.Tensor, Tuple]:
    """(O, (colsum, rowsum, sumsq, bm, bn)) of O = D @ W, fp32
    accumulation, partials at (bm, bn) granularity; ragged edge tiles sum
    only the elements of O that exist."""
    if d.dim() != 2 or w.dim() != 2 or d.shape[1] != w.shape[0]:
        raise ValueError(f"abft_matmul shapes {tuple(d.shape)} @ "
                         f"{tuple(w.shape)}")
    if d.device.type == "cpu" and w.device.type == "cpu":
        return abft_matmul_ref(d, w, bm, bn)
    if d.device.type != "cuda":
        raise ValueError(f"abft_matmul: unsupported device {d.device}")
    return _launch(d, w, bm, bn)
