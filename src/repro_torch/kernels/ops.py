"""Shape-aligned dispatch to the kernels and the partial->chunk-sum
plumbing used by repro_torch.core.protected (twin of repro.kernels.ops).

The tile rules (`_tile`, `_tile_pad`) are the JAX package's: on a CPU
tensor they decide the granularity of the partials, so the plain path
reproduces the JAX package's outputs shape for shape, degenerate views
(which the JAX package hands to its plain pass) included. They exist to
zero-pad O for the TPU; the CUDA kernels mask ragged edges themselves (and
the conv detection sums' kernel tiles O for the card on its own), so a
CUDA tensor always launches its kernel, and O is never copied.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref as _ref
from .abft_matmul import abft_matmul as _abft_matmul_kernel
from .abft_matmul import abft_matmul_detect as _abft_matmul_detect_kernel
from .checksum_reduce import checksum_reduce as _checksum_reduce_kernel
from .checksum_reduce import conv_sums as _conv_sums_kernel

F32 = torch.float32


def _tile(n: int, target: int) -> int:
    """Largest power-of-two divisor of n that is <= target (>=1)."""
    t = 1
    while t * 2 <= target and n % (t * 2) == 0:
        t *= 2
    return t


def _tile_pad(n: int, target: int) -> Optional[int]:
    """Largest power-of-two tile <= target (>= 8) whose edge waste on an
    n-sized axis stays under 25%; None when even the smallest tile wastes
    more (degenerate axis)."""
    best = None
    c = 8
    while c <= target:
        pad = (-n) % c
        if pad == 0 or pad * 4 <= n:
            best = c
        c *= 2
    return best


def _next_pow2(n: int) -> int:
    t = 1
    while t < n:
        t *= 2
    return t


def conv_tiles(m: int, p: int, tiles: Optional[Tuple[int, int]] = None,
               on_card: bool = False) -> Optional[Tuple[int, int]]:
    """(bm, bn) of the checksum_reduce pass over the (N*M, P) conv view:
    aligned tiles of >= 8, else `_tile_pad`'s edge tiles. Where an axis is
    degenerate the JAX package takes its plain pass (None); on the card the
    kernel masks any edge, so that axis gets the smallest power of two
    covering it (at most the target) and the kernel still runs."""
    out = []
    for n, target in zip((m, p), tiles or (256, 256)):
        t = _tile(n, target)
        if t < 8:
            t = _tile_pad(n, target)
        if t is None:
            if not on_card:
                return None
            t = min(_next_pow2(n), target)
        out.append(t)
    return out[0], out[1]


def _granularity(n: int, k: int, m: int, bm: int, bn: int, bk: int
                 ) -> Tuple[int, int]:
    """The (bm, bn) partial granularity the JAX wrapper lands on: aligned
    tiles when every axis tiles at >= 8, else edge tiles sized by
    `_tile_pad`, else (degenerate axis) the small aligned tiles of its
    oracle fallback."""
    bm_, bn_, bk_ = _tile(n, bm), _tile(m, bn), _tile(k, bk)
    if min(bm_, bn_, bk_) >= 8:
        return bm_, bn_
    pm = bm_ if bm_ >= 8 else _tile_pad(n, bm)
    pn = bn_ if bn_ >= 8 else _tile_pad(m, bn)
    pk = bk_ if bk_ >= 8 else _tile_pad(k, bk)
    if pm is None or pn is None or pk is None:
        return bm_, bn_
    return pm, pn


def abft_matmul(d: torch.Tensor, w: torch.Tensor, *, bm: int = 256,
                bn: int = 256, bk: int = 256) -> Tuple[torch.Tensor, Tuple]:
    """Fused GEMM + checksum epilogue: (O, (colsum, rowsum, sumsq, bm, bn)).
    `bk` only enters the JAX package's granularity rule; on the card the
    partials are the aligned tiles (the kernel masks ragged edges and walks
    K in its own steps). With a leading group axis, (G, N, K) @ (G, K, M)
    is one launch on the card and the rule is one group's."""
    n, k = d.shape[-2:]
    m = w.shape[-1]
    if d.device.type == "cuda":
        gm, gn = _tile(n, bm), _tile(m, bn)
    else:
        gm, gn = _granularity(n, k, m, bm, bn, bk)
    return _abft_matmul_kernel(d, w, gm, gn)


def abft_matmul_detect(d: torch.Tensor, w: torch.Tensor, c5, c6, c7, absdot,
                       *, rb: int, cb: int, bk: int = 256, tau_a: float,
                       tau_b: float, weighted: bool = True):
    """Single-launch GEMM + CoC-D compare per (rb x cb) detection chunk:
    (O, flag (nb, mb) int32, score (nb, mb) float32). c5/c6/c7/absdot are
    the per-chunk checksum predictions of the raw product (locally
    index-weighted, without bias adjustments). With a leading group axis
    on D, W and the checksums, flag and score lead with it too.

    On a CPU tensor it keeps the JAX package's rule and returns None where
    the chunking is not a Pallas tile (rb, cb or the K tile under 8, a
    non-dividing chunk, checksums of another grid), so the caller takes the
    partials route exactly where the JAX package does. A CUDA tensor always
    launches: the kernel masks any edge and its blocks need not be the
    chunk."""
    n, k = d.shape[-2:]
    m = w.shape[-1]
    if d.device.type != "cuda" and (
            min(rb, cb, _tile(k, bk)) < 8 or n % rb or m % cb
            or tuple(c5.shape[-2:]) != (n // rb, m // cb)):
        return None
    return _abft_matmul_detect_kernel(d, w, c5, c6, c7, absdot, rb, cb,
                                      tau_a, tau_b, weighted)


def checksum_reduce(o: torch.Tensor, *, bm: int = 512, bn: int = 512
                    ) -> Tuple:
    """Single-pass summation partials of O[N,M]:
    (colsum, rowsum, sumsq, wcolsum, bm, bn)."""
    n, m = o.shape
    bm_, bn_ = _tile(n, bm), _tile(m, bn)
    if min(bm_, bn_) < 8:
        pm = bm_ if bm_ >= 8 else _tile_pad(n, bm)
        pn = bn_ if bn_ >= 8 else _tile_pad(m, bn)
        if pm is not None and pn is not None:
            bm_, bn_ = pm, pn
    colsum, rowsum, sumsq, wcolsum = _checksum_reduce_kernel(o, bm_, bn_)
    return colsum, rowsum, sumsq, wcolsum, bm_, bn_


def chunk_sums_from_partials(parts, rb: int, cb: int, o=None):
    """Finish the epilogue partials into per-chunk (s5, s6, s7, sumsq);
    partials led by a group axis give sums led by it.

    colsum has full column resolution -> exact local m-weighting for s7;
    rowsum has full row resolution -> exact n-weighting for s6. When the
    chunk is not a multiple of the partial tile (or the partials carry a
    ragged edge tile), recombine at element resolution from a CPU `o`
    instead, as the JAX package does; with no `o`, or with `o` on the card
    (where that would be a plain pass in the kernel's place), misalignment
    is an error."""
    colsum, rowsum, sumsq, bm, bn = parts
    *lead, nt, m = colsum.shape
    n = rowsum.shape[-2]
    aligned = (rb % bm == 0 and cb % bn == 0
               and nt * bm == n and rowsum.shape[-1] * bn == m
               and n % rb == 0 and m % cb == 0)
    if not aligned:
        if o is None or o.device.type != "cpu":
            raise ValueError(
                f"chunk ({rb},{cb}) must be a multiple of the kernel tile "
                f"({bm},{bn}) to recombine from partials; only a CPU o= "
                "recombines at element resolution")
        return _ref.chunk_sums_ref(o, rb, cb)
    nb, mb = n // rb, m // cb
    dev = colsum.device
    cs = colsum.reshape(*lead, nb, rb // bm, mb, cb)
    rs = rowsum.reshape(*lead, nb, rb, mb, cb // bn)
    s5 = torch.einsum("...atbc->...ab", cs)
    s7 = torch.einsum("...atbc,c->...ab", cs, torch.arange(cb, dtype=F32,
                                                            device=dev))
    s6 = torch.einsum("...arbt,r->...ab", rs, torch.arange(rb, dtype=F32,
                                                            device=dev))
    sq = sumsq.reshape(*lead, nb, rb // bm, mb, cb // bn).sum(dim=(-3, -1))
    return s5, s6, s7, sq


def conv_detect_sums(o4: torch.Tensor, *,
                     tiles: Optional[Tuple[int, int]] = None):
    """Kernel route for `core.checksums.detect_sums`: the per-payload
    detection sums (s5, s6, s7, sumsq) of O[N,M,E,E] in one pass over its
    flattened (N*M, E*E) view.

    A CUDA tensor always launches the conv-sums kernel, which tiles O for
    the card and finishes the sums in its launch. A CPU tensor takes the
    JAX package's route shape for shape: its tile rule, the tile partials
    (row tiles never straddle a batch block: the flattened row nm has
    weights n = nm // M for s6 and m = nm % M for s7, and wcolsum carries
    only the local row weight), finished on the host; where its view is
    degenerate it returns None, so the caller takes the plain pass as the
    JAX package does."""
    if o4.device.type == "cuda":
        return _conv_sums_kernel(o4)
    n, m, e1, e2 = o4.shape
    bt = conv_tiles(m, e1 * e2, tiles)
    if bt is None:
        return None
    return _conv_sums_kernel(o4, bt)
