"""Layerwise RC/ClC enablement (paper SS4.3) and profile-based kernel
selection; twin of repro.core.policy.

The paper profiles t0 = t(CoC+FC), t1 = t(CoC+RC), t2 = t(CoC+RC+FC) per
layer offline and enables RC iff the expected saving p_r*(t0-t1) exceeds
the expected penalty p_c*(t2-t0), with p_r/p_c estimated from the operand
element counts. This module instantiates the paper's analytic runtime
model (Table 4) with alpha (compute) and beta (memory) coefficients;
`calibrate()` fits them from measured timings. `profile_matmul_kernel`
and `profile_conv_detect_kernel` time the plain route against the
kernel route per layer shape, each finished to the same detection sums,
so that build_plan(profile_kernels=True) pins the winner. On the card the
kernel route launches the CUDA kernels; on the CPU it runs their plain
versions, so a CPU profile decides nothing about the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch

from .._device import DeviceLike, fp32_ieee, resolve_device

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OpShape:
    """Shape of one protected op in the paper's notation."""
    n: int    # fmap blocks (batch / block-rows)
    m: int    # kernel blocks (out-channels / block-cols)
    ch: int   # contraction channels
    r: int = 1
    h: int = 1  # spatial extent (1 for matmul; conv: H ~ E)

    @property
    def d_elems(self) -> int:
        return self.n * self.ch * self.h * self.h

    @property
    def w_elems(self) -> int:
        return self.m * self.ch * self.r * self.r


@dataclasses.dataclass
class CostModel:
    alpha: float = 1.0   # per conv MAC (compute-bound coefficient)
    beta: float = 0.2    # per element moved (memory-bound coefficient)

    # paper Table 4 runtimes (kernel checksums precomputed)
    def t_fc(self, s: OpShape) -> float:
        a = self.alpha * (s.n + s.m) * s.ch * s.r ** 2 * s.h ** 2
        b = self.beta * (s.n * s.ch * s.h ** 2 + 2 * s.n * s.m * s.h ** 2)
        return a + b

    def t_rc(self, s: OpShape) -> float:
        a = self.alpha * 2 * s.m * s.ch * s.r ** 2 * s.h ** 2
        b = self.beta * (2 * s.n * s.ch * s.h ** 2 + 2 * s.n * s.m * s.h ** 2)
        return a + b

    def t_clc(self, s: OpShape) -> float:
        a = self.alpha * 2 * s.n * s.ch * s.r ** 2 * s.h ** 2
        b = self.beta * (2 * s.n * s.m * s.h ** 2)
        return a + b

    def t_coc(self, s: OpShape) -> float:
        a = self.alpha * 3 * s.ch * s.r ** 2 * s.h ** 2
        b = self.beta * (2 * s.n * s.ch * s.h ** 2 + 3 * s.n * s.m * s.h ** 2)
        return a + b


def row_col_probabilities(s: OpShape) -> Tuple[float, float]:
    """p_r / p_c from operand sizes (paper: p_r/p_c = |D| / |W|)."""
    d, w = s.d_elems, s.w_elems
    tot = d + w
    return d / tot, w / tot


def decide_rc_clc(s: OpShape, model: Optional[CostModel] = None
                  ) -> Tuple[bool, bool]:
    """Enable RC (and symmetrically ClC) iff expected saving > penalty."""
    model = model or CostModel()
    p_r, p_c = row_col_probabilities(s)
    t_coc = model.t_coc(s)
    t0 = t_coc + model.t_fc(s)
    t1 = t_coc + model.t_rc(s)
    t2 = t1 + model.t_fc(s)
    rc = p_r * max(t0 - t1, 0.0) > p_c * (t2 - t0)
    t1c = t_coc + model.t_clc(s)
    t2c = t1c + model.t_fc(s)
    clc = p_c * max(t0 - t1c, 0.0) > p_r * (t2c - t0)
    return rc, clc


# --------------------------------------------------------------------------
# profile-based kernel selection (the measured sibling of calibrate():
# time the plain and the kernel route per layer shape and pin the winner
# in the plan)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelProfile:
    """One layer's measured plain-vs-fused decision."""
    use_fused: bool
    tiles: Optional[Tuple[int, int, int]]  # (bm, bn, bk) when fused
    t_plain: float                         # seconds (min over iters)
    t_fused: float                         # inf when the kernel is not viable

    def doc(self) -> dict:
        return {"use_fused": self.use_fused,
                "tiles": list(self.tiles) if self.tiles else None,
                "plain_us": self.t_plain * 1e6,
                "fused_us": (self.t_fused * 1e6
                             if self.t_fused != float("inf") else None)}


def _time_call(fn, *args, iters: int = 3, warmup: int = 2) -> float:
    """Best host seconds of one fn(*args) over `iters` after `warmup`
    calls; on the card each call ends in torch.cuda.synchronize(), which
    is what production pays (the JAX package's block_until_ready)."""
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)

    def call():
        fn(*args)
        if cuda:
            torch.cuda.synchronize()

    for _ in range(warmup):
        call()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return best


# the JAX package's Pallas tile candidates; in the port the CUDA source
# chooses its own tiling and a candidate only sets the partial granularity
# of abft_matmul, which the finishing reduction sums
_MATMUL_TILE_CANDIDATES = ((256, 256, 256), (128, 128, 256), (512, 512, 256))


def matmul_profile_programs(n: int, k: int, m: int, *,
                            tiles: Tuple[int, int, int]):
    """The two candidate programs profile_matmul_kernel times, both
    finished to the SAME outputs (o, s5, s6, s7, sumsq):

    * plain - protected.matmul_raw + the plain detection-sums pass;
    * fused - kernels.ops.abft_matmul + the chunk_sums_from_partials
      finishing reduction the protected path runs on the partials.

    Pricing the fused side at the kernel's O alone would never pay that
    finishing reduction while the plain side is priced end to end."""
    from repro_torch.kernels import ops as kops

    from .protected import matmul_raw
    bm, bn, bk = tiles

    def plain(d, w):
        o = matmul_raw(d, w)
        o32 = o.to(F32)
        wn = torch.arange(n, dtype=F32, device=o.device)
        wm = torch.arange(m, dtype=F32, device=o.device)
        s5 = torch.sum(o32)
        s6 = torch.dot(wn, torch.sum(o32, dim=1))
        s7 = torch.dot(torch.sum(o32, dim=0), wm)
        return o, s5, s6, s7, torch.sum(o32 * o32)

    def fused(d, w):
        o, parts = kops.abft_matmul(d, w, bm=bm, bn=bn, bk=bk)
        # one whole-output chunk finishes the partials to the same scalar
        # sums the plain program computes
        s5, s6, s7, sq = kops.chunk_sums_from_partials(parts, n, m, o=o)
        return o, s5[0, 0], s6[0, 0], s7[0, 0], sq[0, 0]

    return plain, fused


def profile_matmul_kernel(n: int, k: int, m: int, dtype=None,
                          device: DeviceLike = None,
                          candidates=_MATMUL_TILE_CANDIDATES,
                          iters: int = 3) -> KernelProfile:
    """Time the plain product + detection sums against abft_matmul + its
    finishing reduction on an (n,k)@(k,m) GEMM of `dtype` operands
    (float32 by default, as the JAX package profiles every site); returns
    the winner and its tiles. On the CPU the kernel route runs the
    kernels' plain versions, priced like the JAX package's interpret mode
    (one call per candidate, abandoned past 10x the plain time)."""
    dev = resolve_device(device)
    dtype = dtype or F32
    interpret = dev.type != "cuda"
    g = torch.Generator(device=dev).manual_seed(n * 131 + m)
    d = torch.randn((n, k), generator=g, dtype=F32, device=dev).to(dtype)
    w = torch.randn((k, m), generator=g, dtype=F32, device=dev).to(dtype)
    with torch.no_grad(), fp32_ieee():
        f_plain, _ = matmul_profile_programs(n, k, m, tiles=candidates[0])
        t_plain = _time_call(f_plain, d, w, iters=iters)
        k_iters, k_warm = (1, 1) if interpret else (iters, 2)
        t_fused, best_tiles = float("inf"), None
        for tiles in candidates:
            _, f = matmul_profile_programs(n, k, m, tiles=tiles)
            t = _time_call(f, d, w, iters=k_iters, warmup=k_warm)
            if t < t_fused:
                t_fused, best_tiles = t, tiles
            if interpret and t > 10 * t_plain:
                break  # hopeless; don't pay for more candidates
    use = t_fused < t_plain
    return KernelProfile(use, best_tiles if use else None, t_plain, t_fused)


def profile_conv_detect_kernel(o_shape: Tuple[int, int, int, int],
                               device: DeviceLike = None,
                               iters: int = 3) -> KernelProfile:
    """Time the plain detection-sums pass (checksums.detect_sums) against
    the conv-sums kernel (kernels.ops.conv_detect_sums) on a conv output
    of `o_shape` (N, M, E, E)."""
    from repro_torch.kernels import ops as kops

    from . import checksums as C
    dev = resolve_device(device)
    interpret = dev.type != "cuda"
    g = torch.Generator(device=dev).manual_seed(sum(o_shape))
    o = torch.randn(tuple(o_shape), generator=g, dtype=F32, device=dev)
    with torch.no_grad(), fp32_ieee():
        t_plain = _time_call(C.detect_sums, o, iters=iters)
        if kops.conv_detect_sums(o) is None:
            # degenerate flattened view: the kernel route cannot run
            return KernelProfile(False, None, t_plain, float("inf"))
        k_iters, k_warm = (1, 1) if interpret else (iters, 2)
        t_fused = _time_call(kops.conv_detect_sums, o, iters=k_iters,
                             warmup=k_warm)
    return KernelProfile(t_fused < t_plain, None, t_plain, t_fused)


def calibrate(samples) -> CostModel:
    """Least-squares fit of (alpha, beta) from measured (shape, scheme,
    seconds) samples - the offline-profiling hook."""
    import numpy as np
    rows, ys = [], []
    for s, scheme, secs in samples:
        a_fc = (s.n + s.m) * s.ch * s.r ** 2 * s.h ** 2
        b_fc = s.n * s.ch * s.h ** 2 + 2 * s.n * s.m * s.h ** 2
        a_rc = 2 * s.m * s.ch * s.r ** 2 * s.h ** 2
        b_rc = 2 * s.n * s.ch * s.h ** 2 + 2 * s.n * s.m * s.h ** 2
        a_clc = 2 * s.n * s.ch * s.r ** 2 * s.h ** 2
        b_clc = 2 * s.n * s.m * s.h ** 2
        a_coc = 3 * s.ch * s.r ** 2 * s.h ** 2
        b_coc = 2 * s.n * s.ch * s.h ** 2 + 3 * s.n * s.m * s.h ** 2
        terms = {"fc": (a_fc, b_fc), "rc": (a_rc, b_rc),
                 "clc": (a_clc, b_clc), "coc": (a_coc, b_coc)}[scheme]
        rows.append(terms)
        ys.append(secs)
    coef, *_ = np.linalg.lstsq(np.asarray(rows, float), np.asarray(ys, float),
                               rcond=None)
    alpha, beta = (float(max(c, 1e-15)) for c in coef)
    return CostModel(alpha=alpha, beta=beta)
