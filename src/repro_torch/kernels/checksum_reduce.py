"""Single-pass output-summation partials of an existing O (twin of
repro.kernels.checksum_reduce).

One read of O emits per-tile colsum, rowsum, sumsq and wcolsum (the
column sum weighted by the row's index within its tile). With the tile's
base row, wcolsum rebuilds any affine row weighting:

    sum_r w(r) * O[r, :]  =  w(base) * colsum_tile + step * wcolsum_tile

which is how the conv detection path gets s6 and s7 from the flattened
(N*M, E*E) view without a second pass (kernels.ops.conv_detect_sums).

On a CUDA tensor this launches the CUDA kernel in csrc/checksum_reduce.cu
(O float32 or bfloat16, every sum in fp32); on a CPU tensor it runs the
plain version below. `LAUNCHES` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .ref import _ceil_to, checksum_reduce_ref

F32 = torch.float32
# the kernel's C entry point for each type of O (the sums are fp32)
SYMBOLS = {torch.float32: "repro_checksum_reduce_f32",
           torch.bfloat16: "repro_checksum_reduce_bf16"}
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


def _launch(o: torch.Tensor, bm: int, bn: int, segments: int,
            rowsum: bool) -> Tuple:
    global LAUNCHES
    if o.dtype not in SYMBOLS:
        raise NotImplementedError(
            f"checksum_reduce kernel takes float32 or bfloat16, got {o.dtype}")
    if not o.is_contiguous():
        raise ValueError("checksum_reduce kernel needs a contiguous O")
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
