"""Fused ABFT matmul: O = D @ W with the ABFT work in the GEMM epilogue
(twin of repro.kernels.abft_matmul's `abft_matmul` and
`abft_matmul_detect`).

`abft_matmul` returns the output summation partials

    colsum : (N/bm, M)    per-row-tile column sums   -> S_o1/S_o5/S_o7
    rowsum : (N, M/bn)    per-col-tile row sums      -> S_o2/S_o6
    sumsq  : (N/bm, M/bn) per-tile sum of squares    -> detection threshold

which kernels.ops.chunk_sums_from_partials finishes at any chunk
granularity that is a multiple of (bm, bn). `abft_matmul_detect` runs the
CoC-D compare itself and returns one flag and one score per (rb x cb)
detection chunk.

On a CUDA tensor both launch the CUDA kernel in csrc/abft_matmul.cu, one
mainloop per operand type that both entry points share (so they round O
identically): the blocks compute O^T = W^T D^T in tiles of 64 columns by
8-128 rows and split K over the blocks of a cluster when the tiles cannot
fill the card; bf16 operands run wgmma (the tensor cores), float32 ones
IEEE fp32 FMA on the CUDA cores. The tiling (block tile, split count) is
chosen by the source from (N, K, M, dtype); the wrappers ask for it
through `repro_abft_tiling`, size their buffers from it, and sum a
coarser partial granularity from the tile's. Operands are float32 or
bfloat16 (O in D's type, every sum in fp32). W is (K, M) row-major or the
transposed view of an (M, K) row-major tensor (the tied LM head), read in
place. On a CPU tensor each runs its plain version (ref.py). `LAUNCHES`
and `DETECT_LAUNCHES` count the kernel's launches.

The detect entry point is one launch: the last block to finish a
detection chunk's tiles runs its compare. The tiles of a chunk meet on
int32 counters (kernels/_counters.py) that start at zero and that the
kernel leaves zero.

Both take an optional leading group axis: G products (G, N, K) @ (G, K,
M) of one shape (a MoE layer's experts) in ONE launch, the counterpart of
the Pallas kernel under jax.vmap; a 2-D product is the launch with one
group. Each group is tiled as a product of its own shape, so a group's O
is bitwise what the 2-D product gives for it; partials, checksums, flags
and scores carry the group axis in front. `GROUPED_LAUNCHES` and
`GROUPED_DETECT_LAUNCHES` count the launches with a group axis.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import _build, _counters
from .ref import abft_matmul_detect_ref, abft_matmul_ref

F32 = torch.float32
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = 0
DETECT_LAUNCHES = 0
GROUPED_LAUNCHES = 0
GROUPED_DETECT_LAUNCHES = 0


def _pow2(x: int) -> bool:
    return x >= 1 and x & (x - 1) == 0


class Tiling(NamedTuple):
    """How the CUDA source launches an (N, K) @ (K, M) product: block tile
    tm rows x tn columns of O, the detect pass's row segment (0 without a
    chunk width) and the K split (blocks per tile)."""
    tm: int
    tn: int
    seg: int
    splits: int

    def tiles(self, n: int, m: int) -> int:
        return -(-n // self.tm) * -(-m // self.tn)


@functools.lru_cache(maxsize=None)
def kernel_tiling(n: int, k: int, m: int, dtype: torch.dtype,
                  cb: int = 0) -> Tiling:
    """The Tiling of an (n, k) @ (k, m) product of `dtype` operands as the
    CUDA source chooses it; seg is for a detection chunk width cb > 0."""
    if dtype not in DTYPES:
        raise NotImplementedError(f"abft_matmul: no kernel for {dtype}")
    fn = _build.function("abft_matmul", "repro_abft_tiling",
                         [ctypes.c_int] * 5
                         + [ctypes.POINTER(ctypes.c_int)] * 4)
    out = [ctypes.c_int() for _ in range(4)]
    if fn(n, k, m, DTYPES[dtype], cb, *(ctypes.byref(x) for x in out)):
        raise ValueError(f"abft_matmul: no tiling for n={n}, k={k}, m={m}, "
                         f"{dtype}, cb={cb}")
    return Tiling(*(x.value for x in out))


def _operands(d: torch.Tensor, w: torch.Tensor, what: str):
    """(dtype code, W layout code) of operands the kernel takes; raises on
    anything else. With a leading group axis, each group's W must have
    that layout (the groups may lie any whole number of elements apart)."""
    if d.dtype != w.dtype or d.dtype not in DTYPES:
        raise NotImplementedError(
            f"{what} kernel takes float32 or bfloat16 operands of one type, "
            f"got {d.dtype} @ {w.dtype}")
    if d.device != w.device:
        raise ValueError(f"operands on {d.device} and {w.device}")
    if not d.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous D")
    k, m = w.shape[-2:]
    strides = w.stride()[-2:]
    if strides == (m, 1) or m == 1:
        layout = 0
    elif strides == (1, k):
        layout = 1          # the transposed view of an (M, K) tensor
    else:
        raise ValueError(f"{what} kernel reads W as (K, M) row-major or as "
                         f"the transpose of an (M, K) row-major tensor; got "
                         f"strides {w.stride()} for shape {tuple(w.shape)}")
    return DTYPES[d.dtype], layout


def _shapes(d: torch.Tensor, w: torch.Tensor, what: str):
    """(n, k, m) of (N, K) @ (K, M) or of one group of (G, N, K) @ (G, K,
    M); raises on anything else."""
    if (d.dim() not in (2, 3) or w.dim() != d.dim()
            or d.shape[-1] != w.shape[-2] or d.shape[:-2] != w.shape[:-2]):
        raise ValueError(f"{what} shapes {tuple(d.shape)} @ "
                         f"{tuple(w.shape)}: want (N, K) @ (K, M) or (G, N, "
                         "K) @ (G, K, M)")
    return int(d.shape[-2]), int(d.shape[-1]), int(w.shape[-1])


def _launch(d: torch.Tensor, w: torch.Tensor, bm: int, bn: int) -> Tuple:
    """One launch over D's groups; a 2-D product is the one-group case."""
    global LAUNCHES, GROUPED_LAUNCHES
    dt, layout = _operands(d, w, "abft_matmul")
    if not (_pow2(bm) and _pow2(bn)):
        raise ValueError(f"partial tiles must be powers of two, got {bm, bn}")
    grouped = d.dim() == 3
    if not grouped:
        d, w = d[None], w[None]
    g, n, k = d.shape
    m = w.shape[2]
    t = kernel_tiling(n, k, m, d.dtype)
    pbm, pbn = min(bm, t.tm), min(bn, t.tn)
    gm, gn = bm // pbm, bn // pbn
    rows_t, cols_t = -(-n // bm), -(-m // bn)
    dev = d.device
    # tiles past the edge of O are not written; when kernel partials are
    # summed into coarser ones they must read as zero
    alloc = torch.zeros if (gm > 1 and n % bm) or (gn > 1 and m % bn) \
        else torch.empty
    o = torch.empty((g, n, m), dtype=d.dtype, device=dev)
    colsum = alloc((g, rows_t * gm, m), dtype=F32, device=dev)
    rowsum = alloc((g, n, cols_t * gn), dtype=F32, device=dev)
    sumsq = alloc((g, rows_t * gm, cols_t * gn), dtype=F32, device=dev)
    fn = _build.function("abft_matmul", "repro_abft_matmul",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                         + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                         + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    _build.launch(fn, dev, d.data_ptr(), w.data_ptr(), o.data_ptr(), dt,
                  layout, g, d.stride(0), w.stride(0), o.stride(0), n, k, m,
                  pbm, pbn, colsum.data_ptr(), rowsum.data_ptr(),
                  sumsq.data_ptr(), cols_t * gn, cols_t * gn,
                  colsum.stride(0), rowsum.stride(0), sumsq.stride(0))
    if grouped:
        GROUPED_LAUNCHES += 1
    else:
        LAUNCHES += 1
    if gm > 1:
        colsum = colsum.reshape(g, rows_t, gm, m).sum(dim=2)
        sumsq = sumsq.reshape(g, rows_t, gm, -1).sum(dim=2)
    if gn > 1:
        rowsum = rowsum.reshape(g, n, cols_t, gn).sum(dim=3)
        sumsq = sumsq.reshape(g, rows_t, cols_t, gn).sum(dim=3)
    if not grouped:
        o, colsum, rowsum, sumsq = o[0], colsum[0], rowsum[0], sumsq[0]
    return o, (colsum, rowsum, sumsq, bm, bn)


def abft_matmul(d: torch.Tensor, w: torch.Tensor, bm: int, bn: int
                ) -> Tuple[torch.Tensor, Tuple]:
    """(O, (colsum, rowsum, sumsq, bm, bn)) of O = D @ W, fp32
    accumulation, partials at (bm, bn) granularity; ragged edge tiles sum
    only the elements of O that exist. With a leading group axis, O[g] =
    D[g] @ W[g] in one launch and every result leads with G; W may be any
    (G, K, M) view whose groups are row-major (K, M) matrices, a slice of a
    stacked stage leaf too."""
    _shapes(d, w, "abft_matmul")
    if d.device.type == "cpu" and w.device.type == "cpu":
        return abft_matmul_ref(d, w, bm, bn)
    if d.device.type != "cuda":
        raise ValueError(f"abft_matmul: unsupported device {d.device}")
    return _launch(d, w, bm, bn)


def _launch_detect(d, w, c5, c6, c7, absdot, rb, cb, tau_a, tau_b,
                   weighted) -> Tuple:
    """One launch over D's groups; a 2-D product is the one-group case."""
    global DETECT_LAUNCHES, GROUPED_DETECT_LAUNCHES
    dt, layout = _operands(d, w, "abft_matmul_detect")
    grouped = d.dim() == 3
    chk = [x.contiguous() for x in (c5, c6, c7, absdot)]
    if not grouped:
        d, w = d[None], w[None]
    g, n, k = d.shape
    m = w.shape[2]
    dev = d.device
    for x in chk:
        if x.dtype != F32 or x.device != dev:
            raise ValueError("abft_matmul_detect: checksums must be float32 "
                             f"on {dev}, got {x.dtype} on {x.device}")
    t = kernel_tiling(n, k, m, d.dtype, cb)
    nb, mb = n // rb, m // cb
    o = torch.empty((g, n, m), dtype=d.dtype, device=dev)
    part = torch.empty((g, 3, n, m // t.seg), dtype=F32, device=dev)
    counters = _counters.counters(dev, g * nb * mb)
    flag = torch.empty((g, nb, mb), dtype=torch.int32, device=dev)
    score = torch.empty((g, nb, mb), dtype=F32, device=dev)
    fn = _build.function("abft_matmul", "repro_abft_matmul_detect",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                         + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 2
                         + [ctypes.c_int] + [ctypes.c_void_p] * 5)
    _build.launch(fn, dev, d.data_ptr(), w.data_ptr(), o.data_ptr(), dt,
                  layout, g, d.stride(0), w.stride(0), o.stride(0), n, k, m,
                  rb, cb, *(x.data_ptr() for x in chk), float(tau_a),
                  float(tau_b), int(bool(weighted)), part.data_ptr(),
                  counters.data_ptr(), flag.data_ptr(), score.data_ptr())
    if grouped:
        GROUPED_DETECT_LAUNCHES += 1
        return o, flag, score
    DETECT_LAUNCHES += 1
    return o[0], flag[0], score[0]


def abft_matmul_detect(d: torch.Tensor, w: torch.Tensor, c5, c6, c7, absdot,
                       rb: int, cb: int, tau_a: float, tau_b: float,
                       weighted: bool = True) -> Tuple[torch.Tensor,
                                                       torch.Tensor,
                                                       torch.Tensor]:
    """(O, flag (N/rb, M/cb) int32, score (N/rb, M/cb) float32) of
    O = D @ W with the CoC-D compare per (rb x cb) chunk against the
    chunk-local checksum predictions c5/c6/c7 and the threshold scale
    absdot (thresholds.tau_scalar's affine form with coefficients
    tau_a, tau_b). With a leading group axis on D, W and the checksums,
    one launch compares each group against its own checksums and O, flag
    and score lead with G."""
    n, k, m = _shapes(d, w, "abft_matmul_detect")
    if rb < 1 or cb < 1 or n % rb or m % cb:
        raise ValueError(f"abft_matmul_detect: chunks ({rb}, {cb}) must "
                         f"divide O's shape ({n}, {m})")
    if tuple(c5.shape) != tuple(d.shape[:-2]) + (n // rb, m // cb):
        raise ValueError(f"abft_matmul_detect: checksums of shape "
                         f"{tuple(c5.shape)} for {(n // rb, m // cb)} chunks "
                         f"of {tuple(d.shape[:-2]) or 'one'} group(s)")
    if d.device.type == "cpu" and w.device.type == "cpu":
        return abft_matmul_detect_ref(d, w, c5, c6, c7, absdot, rb, cb,
                                      tau_a, tau_b, weighted)
    if d.device.type != "cuda":
        raise ValueError(f"abft_matmul_detect: unsupported device {d.device}")
    return _launch_detect(d, w, c5, c6, c7, absdot, rb, cb, tau_a, tau_b,
                          weighted)
