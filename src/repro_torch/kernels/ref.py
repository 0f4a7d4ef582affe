"""Plain PyTorch versions of the kernels (twin of repro.kernels.ref).

These are what a CPU tensor runs and what the CUDA kernels are held
against on the card. Partials follow the JAX package's edge-tile
semantics: a tile that runs past the edge of O sums only the elements
that exist, so the partials of a ragged O have ceil(N/bm) row tiles and
ceil(M/bn) column tiles.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

F32 = torch.float32


def _ceil_to(n: int, t: int) -> int:
    return -(-n // t) * t


def checksum_reduce_ref(o: torch.Tensor, bm: int, bn: int) -> Tuple:
    """(colsum (N/bm, M), rowsum (N, M/bn), sumsq (N/bm, M/bn),
    wcolsum (N/bm, M)) of O[N, M]; wcolsum weights each row by its index
    within its row tile."""
    n, m = o.shape
    o32 = o.to(F32)
    np_, mp = _ceil_to(n, bm), _ceil_to(m, bn)
    if (np_, mp) != (n, m):
        o32 = F.pad(o32, (0, mp - m, 0, np_ - n))
    tiled = o32.reshape(np_ // bm, bm, mp)
    colsum = tiled.sum(dim=1)
    rowsum = o32.reshape(np_, mp // bn, bn).sum(dim=2)
    sumsq = (o32 * o32).reshape(np_ // bm, bm, mp // bn, bn).sum(dim=(1, 3))
    wcolsum = torch.einsum("tbm,b->tm", tiled,
                           torch.arange(bm, dtype=F32, device=o.device))
    return colsum[:, :m], rowsum[:n], sumsq, wcolsum[:, :m]


def matmul_ref(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The fp32 product D @ W rounded once to D's type (abft_matmul_ref's
    O); leading batch axes on both operands are allowed."""
    return (d.to(F32) @ w.to(F32)).to(d.dtype)


def abft_matmul_ref(d: torch.Tensor, w: torch.Tensor, bm: int, bn: int
                    ) -> Tuple[torch.Tensor, Tuple]:
    """fp32 matmul plus the same tile partials, taken from the fp32
    product as the kernel takes them; O is rounded once to D's type."""
    acc = d.to(F32) @ w.to(F32)
    colsum, rowsum, sumsq, _ = checksum_reduce_ref(acc, bm, bn)
    return acc.to(d.dtype), (colsum, rowsum, sumsq, bm, bn)


def conv2d_ref(d: torch.Tensor, w: torch.Tensor, stride: int = 1,
               padding="VALID", groups: int = 1) -> torch.Tensor:
    """Independent conv oracle: im2col (strided slices) + fp32 matmul,
    never calling a convolution primitive.

    d: (N, Ch, H, W), w: (M, Ch/G, R, R) -> (N, M, E, E'), NCHW."""
    n, ch, h, wd = d.shape
    m, chg, r, _ = w.shape
    if padding == "SAME":
        # XLA's SAME is asymmetric: the low side gets the floor of the total
        def _same(size):
            out = -(-size // stride)
            total = max((out - 1) * stride + r - size, 0)
            return total // 2, total - total // 2
        pads = (_same(h), _same(wd))
    elif padding == "VALID":
        pads = ((0, 0), (0, 0))
    elif isinstance(padding, (list, tuple)):
        pads = tuple(tuple(int(p) for p in lohi) for lohi in padding)
    else:
        pads = ((int(padding),) * 2,) * 2
    if any(p for lohi in pads for p in lohi):
        d = F.pad(d, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        h, wd = h + sum(pads[0]), wd + sum(pads[1])
    e1 = (h - r) // stride + 1
    e2 = (wd - r) // stride + 1
    cols = [d[:, :, dy:dy + e1 * stride:stride, dx:dx + e2 * stride:stride]
            for dy in range(r) for dx in range(r)]
    # (N, Ch, R*R, E1, E2) -> (N, G, Ch/G * R*R, E1*E2)
    pat = torch.stack(cols, dim=2).to(F32)
    pat = pat.reshape(n, groups, chg * r * r, e1 * e2)
    wm = w.to(F32).reshape(groups, m // groups, chg * r * r)
    o = torch.einsum("ngkp,gmk->ngmp", pat, wm)
    return o.reshape(n, m, e1, e2).to(d.dtype)


def chunk_sums_ref(o: torch.Tensor, rb: int, cb: int):
    """Per-chunk (s5, s6, s7, sumsq) straight from O."""
    n, m = o.shape
    nb, mb = n // rb, m // cb
    o4 = o.to(F32).reshape(nb, rb, mb, cb)
    dev = o.device
    s5 = torch.einsum("arbc->ab", o4)
    s6 = torch.einsum("arbc,r->ab", o4, torch.arange(rb, dtype=F32,
                                                      device=dev))
    s7 = torch.einsum("arbc,c->ab", o4, torch.arange(cb, dtype=F32,
                                                      device=dev))
    sumsq = torch.einsum("arbc,arbc->ab", o4, o4)
    return s5, s6, s7, sumsq


def abft_matmul_detect_ref(d: torch.Tensor, w: torch.Tensor, c5, c6, c7,
                           absdot, rb: int, cb: int, tau_a: float,
                           tau_b: float, weighted: bool = True):
    """(O, flag, score) of abft_matmul_detect: the fp32 product, its
    per-chunk s5/s6/s7/sumsq at chunk-local index weights, then the CoC-D
    compare against c5/c6/c7 with tau5 = tau_a*sqrt(sumsq) +
    tau_b*absdot + 1e-30 (the weighted invariants' taus times rb-1 and
    cb-1). NaN/Inf on either side flags the chunk with score inf."""
    acc = d.to(F32) @ w.to(F32)
    s5, s6, s7, sumsq = chunk_sums_ref(acc, rb, cb)
    tau5 = (tau_a * torch.sqrt(torch.clamp(sumsq, min=0.0))
            + tau_b * absdot.to(F32) + 1e-30)
    pairs = [(c5, s5, tau5)]
    if weighted:
        pairs += [(c6, s6, tau5 * float(max(rb - 1, 1))),
                  (c7, s7, tau5 * float(max(cb - 1, 1)))]
    flag = torch.zeros(s5.shape, dtype=torch.bool, device=d.device)
    score = torch.zeros(s5.shape, dtype=F32, device=d.device)
    for c, s, t in pairs:
        c = c.to(F32)
        bad = ~(torch.isfinite(c) & torch.isfinite(s))
        diff = torch.abs(c - s)
        flag |= bad | (diff > t)
        score = torch.maximum(score, torch.where(
            bad, torch.full_like(score, math.inf), diff / t))
    return acc.to(d.dtype), flag.to(torch.int32), score
