"""Output-summation sums of an existing O (twin of
repro.kernels.checksum_reduce), two entry points:

`conv_sums` is what the conv detection path uses: the per-payload
detection sums (s5, s6, s7, sumsq) of O[N, M, E, E] that
repro.kernels.ops.conv_detect_sums computes, one pass over its flattened
(N*M, E*E) view. On a CUDA tensor it is one launch of the CUDA kernel in
csrc/checksum_reduce.cu, which picks its own tiling and finishes the sums
in that launch; on a CPU tensor it runs the plain version,
`conv_sums_plain`: the tile partials below at the JAX package's tiles,
finished by `finish_conv_sums`, as the JAX package does it.

`checksum_reduce` is what the TPU kernel computes: one read of O emits
per-tile colsum, rowsum, sumsq and wcolsum (the column sum weighted by the
row's index within its tile). With the tile's base row, wcolsum rebuilds
any affine row weighting:

    sum_r w(r) * O[r, :]  =  w(base) * colsum_tile + step * wcolsum_tile

which is how the plain conv route gets s6 and s7 without a second pass.
On a CUDA tensor it launches its own CUDA kernel in the same source.

O is float32 or bfloat16; every sum is fp32. `LAUNCHES` counts both
kernels' launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, _counters
from .ref import _ceil_to, checksum_reduce_ref

F32 = torch.float32
# the kernel's C entry point for each type of O (the sums are fp32)
SYMBOLS = {torch.float32: "repro_checksum_reduce_f32",
           torch.bfloat16: "repro_checksum_reduce_bf16"}
CONV_SYMBOLS = {torch.float32: "repro_conv_detect_sums_f32",
                torch.bfloat16: "repro_conv_detect_sums_bf16"}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = 0


def checksum_reduce_plain(o: torch.Tensor, bm: int, bn: int,
                          segments: int = 1, rowsum: bool = True) -> Tuple:
    """Plain PyTorch version: each of the `segments` row blocks of O is
    zero-padded to a multiple of bm so that no tile straddles two of
    them, as the JAX wrapper pads before its kernel."""
    rows, cols = o.shape
    seg_rows = rows // segments
    mp = _ceil_to(seg_rows, bm)
    o3 = o.reshape(segments, seg_rows, cols)
    if mp != seg_rows:
        o3 = F.pad(o3, (0, 0, 0, mp - seg_rows))
    colsum, rs, sumsq, wcolsum = checksum_reduce_ref(
        o3.reshape(segments * mp, cols), bm, bn)
    if rowsum:
        rs = rs.reshape(segments, mp, -1)[:, :seg_rows].reshape(rows, -1)
    return colsum, (rs if rowsum else None), sumsq, wcolsum


def _check(o: torch.Tensor) -> None:
    if o.dtype not in SYMBOLS:
        raise NotImplementedError(
            f"checksum_reduce kernel takes float32 or bfloat16, got {o.dtype}")
    if not o.is_contiguous():
        raise ValueError("checksum_reduce kernel needs a contiguous O")


def _launch(o: torch.Tensor, bm: int, bn: int, segments: int,
            rowsum: bool) -> Tuple:
    global LAUNCHES
    _check(o)
    rows, cols = o.shape
    seg_rows = rows // segments
    mtiles, ptiles = -(-seg_rows // bm), -(-cols // bn)
    t = segments * mtiles
    colsum = torch.empty((t, cols), dtype=F32, device=o.device)
    wcolsum = torch.empty((t, cols), dtype=F32, device=o.device)
    sumsq = torch.empty((t, ptiles), dtype=F32, device=o.device)
    rs = torch.empty((rows, ptiles), dtype=F32, device=o.device) \
        if rowsum else None
    fn = _build.function("checksum_reduce", SYMBOLS[o.dtype],
                         [ctypes.c_void_p] + [ctypes.c_int] * 5
                         + [ctypes.c_void_p] * 5)
    _build.launch(fn, o.device, o.data_ptr(), segments, seg_rows, cols,
                        bm, bn, colsum.data_ptr(),
                        rs.data_ptr() if rowsum else None, sumsq.data_ptr(),
                        wcolsum.data_ptr())
    LAUNCHES += 1
    return colsum, rs, sumsq, wcolsum


def checksum_reduce(o: torch.Tensor, bm: int, bn: int, *, segments: int = 1,
                    rowsum: bool = True) -> Tuple[torch.Tensor,
                                                  Optional[torch.Tensor],
                                                  torch.Tensor, torch.Tensor]:
    """Partials of O[rows, cols] viewed as `segments` blocks of
    rows/segments rows, with (bm, bn) tiles that never straddle a block:
    (colsum (T, cols), rowsum (rows, PT) or None, sumsq (T, PT),
    wcolsum (T, cols)), T = segments * ceil(rows/segments/bm) and
    PT = ceil(cols/bn). Ragged tiles sum only the elements that exist."""
    if o.dim() != 2:
        raise ValueError(f"checksum_reduce takes a 2-D O, got {tuple(o.shape)}")
    if bm < 1 or bn < 1 or segments < 1 or o.shape[0] % segments:
        raise ValueError(f"bad tiling bm={bm} bn={bn} segments={segments} "
                         f"for O of shape {tuple(o.shape)}")
    if o.device.type == "cpu":
        return checksum_reduce_plain(o, bm, bn, segments, rowsum)
    if o.device.type != "cuda":
        raise ValueError(f"checksum_reduce: unsupported device {o.device}")
    return _launch(o, bm, bn, segments, rowsum)


# --------------------------------------------------------------------------
# the conv detection sums
# --------------------------------------------------------------------------

def finish_conv_sums(colsum, sumsq, wcolsum, m: int, bm: int):
    """(s5, s6, s7, sumsq) from checksum_reduce's partials of the (N*M, P)
    conv view taken as N segments of M rows in tiles of bm rows."""
    mt = -(-m // bm)                          # row tiles per batch block
    t = torch.arange(colsum.shape[0], device=colsum.device)
    nw = (t // mt).to(F32)                    # n, constant per tile
    mbase = ((t % mt) * bm).to(F32)           # m of the tile's first row
    s5 = torch.sum(colsum, dim=0)
    s6 = nw @ colsum
    s7 = mbase @ colsum + torch.sum(wcolsum, dim=0)
    sq = torch.sum(sumsq)
    return s5, s6, s7, sq


def conv_sums_plain(o4: torch.Tensor, bm: int, bn: int) -> Tuple:
    """Plain version: the tile partials of the (N*M, P) view at (bm, bn),
    row tiles never straddling a batch block, finished to (s5, s6, s7,
    sumsq)."""
    n, m, e1, e2 = o4.shape
    p = e1 * e2
    colsum, _, sumsq, wcolsum = checksum_reduce_plain(
        o4.reshape(n * m, p), bm, bn, segments=n, rowsum=False)
    return finish_conv_sums(colsum, sumsq, wcolsum, m, bm)


@functools.lru_cache(maxsize=None)
def conv_sums_layout(n: int, m: int, p: int, dtype: torch.dtype
                     ) -> Tuple[int, int]:
    """(floats, counters) a kernel launch over O[n, m, p] of `dtype`
    needs, as the CUDA source tiles it: the float32 buffer (the 3p + 1
    results, then its scratch) and the int32 counters."""
    fn = _build.function("checksum_reduce", "repro_conv_sums_layout",
                         [ctypes.c_int] * 4
                         + [ctypes.POINTER(ctypes.c_longlong),
                            ctypes.POINTER(ctypes.c_int)])
    floats, counters = ctypes.c_longlong(), ctypes.c_int()
    if fn(n, m, p, DTYPES[dtype], ctypes.byref(floats),
          ctypes.byref(counters)):
        raise ValueError(f"conv_sums: no layout for O of shape {(n, m, p)}")
    return floats.value, counters.value


def _launch_conv_sums(o4: torch.Tensor) -> Tuple:
    global LAUNCHES
    _check(o4)
    n, m, e1, e2 = o4.shape
    p = e1 * e2
    floats, count = conv_sums_layout(n, m, p, o4.dtype)
    dev = o4.device
    buf = torch.empty(floats, dtype=F32, device=dev)
    fn = _build.function("checksum_reduce", CONV_SYMBOLS[o4.dtype],
                         [ctypes.c_void_p] + [ctypes.c_int] * 3
                         + [ctypes.c_void_p] * 3)
    _build.launch(fn, dev, o4.data_ptr(), n, m, p, buf.data_ptr(),
                  _counters.counters(dev, count).data_ptr())
    LAUNCHES += 1
    s5, s6, s7 = buf[:3 * p].view(3, p).unbind(0)
    return s5, s6, s7, buf[3 * p]


def conv_sums(o4: torch.Tensor, tiles: Optional[Tuple[int, int]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """The conv detection sums of O[N, M, E, E]: s5, s6, s7 (E*E each;
    s6 weighs O[n, m] by n, s7 by m) and the scalar sum of squares, all
    float32. On a CPU tensor: the plain version at `tiles` (bm, bn), which
    the CPU route must give; the kernel on the card tiles O itself."""
    if o4.dim() != 4:
        raise ValueError(f"conv_sums takes O[N, M, E, E], got "
                         f"{tuple(o4.shape)}")
    if o4.device.type == "cpu":
        if tiles is None:
            raise ValueError("conv_sums on the CPU needs the tiles of its "
                             "plain version")
        return conv_sums_plain(o4, *tiles)
    if o4.device.type != "cuda":
        raise ValueError(f"conv_sums: unsupported device {o4.device}")
    return _launch_conv_sums(o4)
