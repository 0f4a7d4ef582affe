"""Protected matmul / conv: the paper's ABFT around any implementation of
the underlying linear op (twin of repro.core.protected).

Matmul protection is chunked: O[N,M] is tiled into (row_chunk x col_chunk)
regions, each carrying independent checksums. The error-free cost is one
pass over D (the C_d encode), the chunked output summations (one pass
over O, or the abft_matmul kernel's epilogue), and the O(K)-sized checksum
dots; the correction ladder runs only when CoC-D flags.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import checksums as C
from . import schemes as S
from . import thresholds as TH
from . import types as T
from .workflow import run_ladder

F32 = torch.float32

# Row/column-invariant slack for post-correction verification: a correct
# scheme fix restores elements only to within eps * |corruption|, so the
# verify taus get this headroom; miscorrections leave residues ~0.25 * the
# corruption itself, six orders of magnitude above it.
VERIFY_ROWCOL_SLACK = 64.0


def pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (n itself if n <= target)."""
    if n <= target:
        return max(n, 1)
    best = 1
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            if d <= target:
                best = max(best, d)
            q = n // d
            if q <= target:
                best = max(best, q)
    return best


def matmul_raw(d2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain product D @ W as the JAX package spells it
    (jnp.dot(..., preferred_element_type=F32).astype(d.dtype)): fp32
    accumulation, one rounding to D's type. cuBLAS does that for bf16
    inside repro_torch.fp32_ieee(), which turns its reduced-precision
    reductions off; the CPU takes the fp32 product and rounds it."""
    if d2.dtype == F32 or d2.device.type == "cuda":
        return d2 @ w.to(d2.dtype)
    return (d2.to(F32) @ w.to(F32)).to(d2.dtype)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=F32, device=device)


# --------------------------------------------------------------------------
# shared multischeme scaffolding
# --------------------------------------------------------------------------

def _detect_invariants(c5, c6, c7, s5, s6, s7, tau5, rows: int, cols: int,
                       weighted: bool):
    """CoC-D: compare the scalar invariant (and optionally the two
    index-weighted ones) against their thresholds. Returns (flag, score),
    both left on the device: score is the max |C - S| / tau evidence
    ratio (>1 on a mismatch, +inf on non-finite values)."""
    if not weighted:
        c, s, t = c5, s5, torch.broadcast_to(tau5, c5.shape)
    else:
        t5 = torch.broadcast_to(tau5, c5.shape)
        c = torch.stack([c5, c6, c7])
        s = torch.stack([s5, s6, s7])
        t = torch.stack([t5, TH.tau_weighted(t5, rows),
                         TH.tau_weighted(t5, cols)])
    c32, s32 = c.to(F32), s.to(F32)
    ratio = torch.where(torch.isfinite(c32) & torch.isfinite(s32),
                        torch.abs(c32 - s32) / t,
                        torch.full_like(c32, math.inf))
    return torch.any(TH.mismatch(c, s, t)), torch.max(ratio)


def _verify_invariants(cs: T.OutputChecksums, ss: T.OutputSums, tau5,
                       t_elem, rows: int, cols: int) -> torch.Tensor:
    """Post-correction acceptance: scalar + weighted + row/column
    invariants against fresh checksums. The row/column checks catch the
    multi-element bursts whose CoC "fix" satisfies c5/c6/c7 alone."""
    ok = ~torch.any(TH.mismatch(cs.c5, ss.s5, tau5))
    ok &= ~torch.any(TH.mismatch(cs.c6, ss.s6, TH.tau_weighted(tau5, rows)))
    ok &= ~torch.any(TH.mismatch(cs.c7, ss.s7, TH.tau_weighted(tau5, cols)))
    trc = VERIFY_ROWCOL_SLACK * t_elem
    ok &= ~torch.any(TH.mismatch(cs.c1, ss.s1, trc / max(cols, 1) ** 0.5))
    ok &= ~torch.any(TH.mismatch(cs.c2, ss.s2, trc / max(rows, 1) ** 0.5))
    return ok


def _scheme_taus(kind: str, t_scalar, t_elem, rows: int, cols: int) -> tuple:
    """Residue thresholds handed to a correction scheme."""
    if kind == "scalar":
        return (t_scalar,)
    if kind == "col":
        return (t_elem / max(cols, 1) ** 0.5,)
    if kind == "row":
        return (t_elem / max(rows, 1) ** 0.5,)
    return (t_elem / max(cols, 1) ** 0.5, t_elem / max(rows, 1) ** 0.5)


def _ladder_rungs(cfg: T.ProtectConfig, run_scheme):
    """The multischeme escalation ladder (Fig. 7) from the layerwise
    policy; the CHECKSUM_REFRESH rung accepts O when fresh checksums say
    it was clean all along."""
    rungs = [
        (T.CHECKSUM_REFRESH, lambda o: (o, True)),
        (T.COC, lambda o: run_scheme(S.coc_correct, o, "scalar")),
    ]
    if cfg.rc_enabled:
        rungs.append((T.RC, lambda o: run_scheme(S.rc_correct, o, "col")))
    if cfg.clc_enabled:
        rungs.append((T.CLC, lambda o: run_scheme(S.clc_correct, o, "row")))
    if cfg.fc_enabled:
        rungs.append((T.FC, lambda o: run_scheme(S.fc_correct, o, "fc")))
    return rungs


def _clean_result(o, mode: Optional[str]):
    if mode == "detect_only":
        return o, T.DetectEvidence.clean()
    return o, T.FaultReport.clean()


def _carried(detected) -> bool:
    """A carried CoC-D flag as the ladder's gate: host bools pass through,
    device flags stay on the device until the ladder reads them."""
    if isinstance(detected, torch.Tensor):
        return detected.reshape(()).to(torch.bool)
    return bool(detected)


class WeightChecksums(NamedTuple):
    """Chunked kernel checksums of W[K,M] (precomputable)."""
    cw1: torch.Tensor  # (mb, K)  per-chunk sum over columns
    cw2: torch.Tensor  # (mb, K)  per-chunk locally-index-weighted sum
    col_chunk: int


def weight_checksums_matmul(w: torch.Tensor, col_chunk: int
                            ) -> WeightChecksums:
    k, m = w.shape
    cb = pick_chunk(m, col_chunk)
    mb = m // cb
    w32 = w.to(F32).reshape(k, mb, cb)
    cw1 = torch.einsum("kbc->bk", w32)
    cw2 = torch.einsum("kbc,c->bk", w32, _iota(cb, w.device))
    return WeightChecksums(cw1, cw2, cb)


class _ChunkedChecksums(NamedTuple):
    cd1: torch.Tensor      # (nb, K)
    cd2: torch.Tensor      # (nb, K)
    cw1: torch.Tensor      # (mb, K)
    cw2: torch.Tensor      # (mb, K)
    c5: torch.Tensor       # (nb, mb)
    c6: torch.Tensor       # (nb, mb)  n-weighted (local indices)
    c7: torch.Tensor       # (nb, mb)  m-weighted (local indices)
    absdot: torch.Tensor   # (nb, mb)  |cd1|.|cw1| threshold scale


def _encode_d_chunked(d2: torch.Tensor, rb: int):
    n, k = d2.shape
    d32 = d2.to(F32).reshape(n // rb, rb, k)
    cd1 = torch.sum(d32, dim=1)
    cd2 = torch.einsum("brk,r->bk", d32, _iota(rb, d2.device))
    return cd1, cd2


def _scalar_checksums(cd1, cd2, wck: WeightChecksums) -> _ChunkedChecksums:
    """c5/c6/c7 and the |.| threshold dot as ONE stacked (3nb,K)@(K,3mb)
    product."""
    nb, mb = cd1.shape[0], wck.cw1.shape[0]
    lhs = torch.cat([cd1, cd2, torch.abs(cd1)], dim=0)
    rhs = torch.cat([wck.cw1, wck.cw2, torch.abs(wck.cw1)], dim=0)
    out = lhs @ rhs.T
    return _ChunkedChecksums(cd1, cd2, wck.cw1, wck.cw2,
                             out[:nb, :mb], out[nb:2 * nb, :mb],
                             out[:nb, mb:2 * mb], out[2 * nb:, 2 * mb:])


def _chunk_sums(o: torch.Tensor, rb: int, cb: int):
    """Per-chunk s5/s6/s7 of O[N,M] as ONE constant-weight
    (nb*mb, rb*cb) @ (rb*cb, 3) product, plus the per-chunk sumsq."""
    n, m = o.shape
    nb, mb = n // rb, m // cb
    x = (o.to(F32).reshape(nb, rb, mb, cb).permute(0, 2, 1, 3)
         .reshape(nb * mb, rb * cb))
    dev = o.device
    enc = torch.stack([torch.ones((rb * cb,), dtype=F32, device=dev),
                       _iota(rb, dev).repeat_interleave(cb),
                       _iota(cb, dev).repeat(rb)])
    s = x @ enc.T
    sumsq = torch.sum(x * x, dim=1)
    return (s[:, 0].reshape(nb, mb), s[:, 1].reshape(nb, mb),
            s[:, 2].reshape(nb, mb), sumsq.reshape(nb, mb))


class BiasAdjust(NamedTuple):
    """Checksum-side bias adjustments (paper Table 5, applied to C)."""
    b_chunk_sum: torch.Tensor   # (mb,)
    b_chunk_wsum: torch.Tensor  # (mb,)
    b_chunks: torch.Tensor      # (mb, cb)


def _bias_adjust(bias: torch.Tensor, cb: int) -> BiasAdjust:
    b = bias.to(F32).reshape(bias.shape[0] // cb, cb)
    return BiasAdjust(torch.sum(b, dim=1), b @ _iota(cb, bias.device), b)


# --------------------------------------------------------------------------
# the protected matmul
# --------------------------------------------------------------------------

def protect_matmul_output(
    d2: torch.Tensor,
    w: torch.Tensor,
    o: torch.Tensor,
    wck: Optional[WeightChecksums] = None,
    bias: Optional[torch.Tensor] = None,
    cfg: T.ProtectConfig = T.DEFAULT_CONFIG,
    recompute_fn: Optional[Callable[[], torch.Tensor]] = None,
    tamper_checksums: Optional[Callable] = None,
    precomputed_sums=None,
    mode: Optional[str] = None,
    detected=None,
):
    """Run the multischeme workflow on an already-computed O = D @ W
    (+bias), produced by any implementation.

    `precomputed_sums` threads the abft_matmul kernel's finished partials
    (s5, s6, s7, sumsq per chunk, sums of the RAW product) so detection
    costs no extra pass over O; they are compared against the unadjusted
    checksums. `mode`: None runs what `cfg` says, "detect_only" returns
    (o, DetectEvidence) without the ladder, "correct" forces the ladder.
    `detected` gates the ladder with an externally carried flag."""
    n, k = d2.shape
    m = w.shape[1]
    rb = pick_chunk(n, cfg.row_chunk)
    cb = wck.col_chunk if wck is not None else pick_chunk(m, cfg.col_chunk)
    nb, mb = n // rb, m // cb

    if wck is None:
        wck = weight_checksums_matmul(w, cb)
    if recompute_fn is None:
        def recompute_fn():
            fresh = d2.to(F32) @ w.to(F32)
            if bias is not None:
                fresh = fresh + bias.to(F32)
            return fresh.to(o.dtype)

    cd1, cd2 = _encode_d_chunked(d2, rb)
    cs = _scalar_checksums(cd1, cd2, wck)
    if tamper_checksums is not None:
        cs = tamper_checksums(cs)

    adj = _bias_adjust(bias, cb) if bias is not None else None

    def _adjusted_scalars(cs):
        """c5/c6/c7 with the bias contribution added (Table 5)."""
        c5, c6, c7 = cs.c5, cs.c6, cs.c7
        if adj is not None:
            sum_n = rb * (rb - 1) / 2.0
            c5 = c5 + rb * adj.b_chunk_sum[None, :]
            c6 = c6 + sum_n * adj.b_chunk_sum[None, :]
            c7 = c7 + rb * adj.b_chunk_wsum[None, :]
        return c5, c6, c7

    if mode == "correct" and detected is not None:
        # the caller carries the CoC-D verdict: skip the detection sums
        detected = _carried(detected)
    else:
        if precomputed_sums is not None:
            s5, s6, s7, sumsq = precomputed_sums
            c5a, c6a, c7a = cs.c5, cs.c6, cs.c7
        else:
            s5, s6, s7, sumsq = _chunk_sums(o, rb, cb)
            c5a, c6a, c7a = _adjusted_scalars(cs)
        tau5 = TH.tau_scalar(sumsq, k, o.dtype, cfg.tau_factor, cs.absdot)
        flag, score = _detect_invariants(c5a, c6a, c7a, s5, s6, s7, tau5,
                                         rb, cb, cfg.detect_weighted)
        if mode == "detect_only":
            return o, T.DetectEvidence(flag.to(torch.int32), score)
        if cfg.detect_only and mode != "correct":
            det = flag.to(torch.int32)
            return o, T.FaultReport(det, 0, det)
        detected = flag if detected is None else _carried(detected)

    # ---------------- correction ladder (runs only when flagged) ----------
    # the fp32 operands are taken only where a rung needs them (a site
    # that does not flag reads W once, in its detection pass)
    dev = o.device

    def _chunk_view(o):
        # (nb, mb, rb, cb, P=1) chunk-major view
        return o.reshape(nb, rb, mb, cb).permute(0, 2, 1, 3)[..., None]

    def _unchunk(oc):
        return oc[..., 0].permute(0, 2, 1, 3).reshape(n, m)

    def _verify(o):
        csf = _scalar_checksums(*_encode_d_chunked(d2, rb), wck)
        ssf = _chunk_ss(o)
        t5 = TH.tau_scalar(ssf.sumsq, k, o.dtype, cfg.tau_factor,
                           csf.absdot)
        csp = _chunk_cs(csf, need_rowcol=True)
        return _verify_invariants(csp, ssf, t5[..., None],
                                  t5[..., None, None], rb, cb)

    def _rowcol_checksums(cs):
        """c1..c4 for the RC/ClC/FC rungs (only paid when flagged)."""
        w32 = w.to(F32)
        c1 = (cs.cd1 @ w32).reshape(nb, 1, mb, cb).permute(0, 2, 3, 1)
        c3 = (cs.cd2 @ w32).reshape(nb, 1, mb, cb).permute(0, 2, 3, 1)
        d3 = d2.to(F32).reshape(nb, rb, k)
        c2 = torch.einsum("brk,mk->bmr", d3, cs.cw1)[..., None]
        c4 = torch.einsum("brk,mk->bmr", d3, cs.cw2)[..., None]
        if adj is not None:
            sum_n = rb * (rb - 1) / 2.0
            c1 = c1 + rb * adj.b_chunks[None, :, :, None]
            c3 = c3 + sum_n * adj.b_chunks[None, :, :, None]
            c2 = c2 + adj.b_chunk_sum[None, :, None, None]
            c4 = c4 + adj.b_chunk_wsum[None, :, None, None]
        return c1, c2, c3, c4

    def _chunk_cs(cs, need_rowcol: bool):
        c5a_, c6a_, c7a_ = _adjusted_scalars(cs)
        if need_rowcol:
            c1, c2, c3, c4 = _rowcol_checksums(cs)
        else:
            zc = torch.zeros((nb, mb, cb, 1), dtype=F32, device=dev)
            zr = torch.zeros((nb, mb, rb, 1), dtype=F32, device=dev)
            c1, c3, c2, c4 = zc, zc, zr, zr
        return T.OutputChecksums(c1, c2, c3, c4, c5a_[..., None],
                                 c6a_[..., None], c7a_[..., None])

    def _chunk_ss(o):
        o32 = _chunk_view(o).to(F32)                       # (nb,mb,rb,cb,1)
        wn, wm = _iota(rb, dev), _iota(cb, dev)
        s1 = torch.sum(o32, dim=2)                         # (nb,mb,cb,1)
        s2 = torch.sum(o32, dim=3)                         # (nb,mb,rb,1)
        s3 = torch.einsum("abrcp,r->abcp", o32, wn)
        s4 = torch.einsum("abrcp,c->abrp", o32, wm)
        s5 = torch.einsum("abcp->abp", s1)
        s6 = torch.einsum("abrp,r->abp", s2, wn)
        s7 = torch.einsum("abcp,c->abp", s1, wm)
        sq = torch.einsum("abrcp,abrcp->ab", o32, o32)
        return T.OutputSums(s1, s2, s3, s4, s5, s6, s7, sq)

    def _run_scheme(scheme_fn, o, tau_kind):
        oc = _chunk_view(o)
        cs_c = _chunk_cs(cs, need_rowcol=tau_kind != "scalar")
        ss_c = _chunk_ss(o)
        t5 = TH.tau_scalar(ss_c.sumsq, k, o.dtype, cfg.tau_factor, cs.absdot)
        taus = _scheme_taus(tau_kind, t5[..., None], t5[..., None, None],
                            rb, cb)
        # the JAX package vmaps the scheme over the chunk grid; here the
        # (rarely taken) correction path loops over it
        fixed = torch.empty_like(oc)
        ok = torch.ones((), dtype=torch.bool, device=dev)
        for a in range(nb):
            for b in range(mb):
                f_ab, ok_ab = scheme_fn(
                    oc[a, b], T.OutputChecksums(*(x[a, b] for x in cs_c)),
                    T.OutputSums(*(x[a, b] for x in ss_c)),
                    *(t[a, b] for t in taus))
                fixed[a, b] = f_ab
                ok = ok & ok_ab
        return _unchunk(fixed), ok

    rungs = _ladder_rungs(cfg, _run_scheme)
    out, rep = run_ladder(o, detected, rungs, _verify, recompute_fn)
    if o.dtype != F32 and rep.corrected_by in (T.COC, T.RC, T.CLC, T.FC):
        out = _recompute_located(o, out, d2, w, bias)
    return out, rep


def _recompute_located(o_in, o_fixed, d2, w, bias):
    """Recompute, as fp32 dot products rounded once, the elements a
    checksum scheme changed in a sub-fp32 output.

    A scheme's fix is O + (C - S), and S sums the rounded output: in bf16
    the fix carries the chunk's summed rounding noise, ~sqrt(rb*cb) ulps
    (e.g. 0.69 on an element of 0.96 for a 128 x 960 chunk), where the
    JAX package stops (ROADMAP 3.2). The scheme has located the elements;
    their dot products restore them to the clean product's rounding."""
    changed = o_fixed != o_in
    rows = torch.nonzero(torch.any(changed, dim=1)).flatten()
    cols = torch.nonzero(torch.any(changed, dim=0)).flatten()
    if rows.numel() == 0:
        return o_fixed
    ix = (rows[:, None], cols[None, :])
    sub = d2[rows].to(F32) @ w[:, cols].to(F32)
    if bias is not None:
        sub = sub + bias[cols].to(F32)
    out = o_fixed.clone()
    out[ix] = torch.where(changed[ix], sub.to(o_fixed.dtype), o_fixed[ix])
    return out


def protected_matmul(
    d: torch.Tensor,
    w: torch.Tensor,
    wck: Optional[WeightChecksums] = None,
    bias: Optional[torch.Tensor] = None,
    cfg: T.ProtectConfig = T.DEFAULT_CONFIG,
    mode: Optional[str] = None,
    detected=None,
):
    """O = D @ W (+ bias) with the full multischeme workflow. D may have
    leading batch dims; they are flattened into the block-row axis."""
    lead = d.shape[:-1]
    k = d.shape[-1]
    m = w.shape[-1]
    d2 = d.reshape(-1, k)
    if cfg is None or not cfg.enabled:
        o = matmul_raw(d2, w)
        if bias is not None:
            o = o + bias.to(o.dtype)
        return _clean_result(o.reshape(*lead, m), mode)

    if cfg.use_fused_kernel:
        from repro_torch.kernels import ops as kops
        rb = pick_chunk(d2.shape[0], cfg.row_chunk)
        cb = wck.col_chunk if wck is not None else pick_chunk(m, cfg.col_chunk)
        if mode == "detect_only" and bias is None:
            # the single-launch detect path: GEMM + CoC-D compare per
            # (rb x cb) chunk in one kernel; only the O(K)-sized checksum
            # encode and two max-reduces over the chunk verdicts run
            # outside it. Bias-carrying sites keep the partials route (the
            # kernel compares the raw product).
            wck_d = wck if wck is not None \
                else weight_checksums_matmul(w, cb)
            cd1, cd2 = _encode_d_chunked(d2, rb)
            cs = _scalar_checksums(cd1, cd2, wck_d)
            tau_a, tau_b = TH.tau_scalar_coeffs(k, d.dtype, cfg.tau_factor)
            res = kops.abft_matmul_detect(
                d2.contiguous(), w, cs.c5, cs.c6, cs.c7, cs.absdot, rb=rb,
                cb=cb, bk=(cfg.kernel_tiles or (0, 0, 256))[2], tau_a=tau_a,
                tau_b=tau_b, weighted=cfg.detect_weighted)
            if res is not None:
                o, flag, score = res
                return (o.reshape(*lead, m),
                        T.DetectEvidence(torch.max(flag), torch.max(score)))
        bm, bn, bk = cfg.kernel_tiles or (kops._tile(rb, 256),
                                          kops._tile(cb, 256), 256)
        if d2.device.type == "cuda":
            # the kernel masks ragged edges, so its partials can always
            # divide the chunk: chunk_sums_from_partials refuses the
            # element-resolution plain pass on the card
            bm, bn = kops._tile(rb, bm), kops._tile(cb, bn)
        o, parts = kops.abft_matmul(d2.contiguous(), w,
                                    bm=bm, bn=bn, bk=bk)
        pre = kops.chunk_sums_from_partials(parts, rb, cb, o=o)
    else:
        o = matmul_raw(d2, w)
        pre = None
    if bias is not None:
        o = (o.to(F32) + bias.to(F32)).to(o.dtype)
    o, rep = protect_matmul_output(d2, w, o, wck=wck, bias=bias, cfg=cfg,
                                   precomputed_sums=pre, mode=mode,
                                   detected=detected)
    return o.reshape(*lead, m), rep


# --------------------------------------------------------------------------
# backward protection (paper SS5.3)
# --------------------------------------------------------------------------

def _backward_product(a, b, cfg: T.ProtectConfig, hook):
    """One protected product of the backward. A fault hook (registered at
    the call site's path + "/dD" or "/dW" by injection.fault_scope when
    the forward ran) corrupts the site's raw product, which then takes the
    workflow as an injected output, as core.plan.protect_site does."""
    if hook is None:
        return protected_matmul(a, b, cfg=cfg)
    from .plan import _site_product
    o = hook(_site_product(a, b, cfg))
    return protect_matmul_output(a, b, o, cfg=cfg)


class _AbftMatmulVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, w, cfg, reports):
        from .injection import site_fault
        from .plan import current_path
        o, _ = protected_matmul(d, w, cfg=cfg)
        ctx.save_for_backward(d, w)
        ctx.cfg, ctx.reports = cfg, reports
        # the hooks are looked up here: the backward may run on autograd's
        # device thread, where the caller's context is not set
        ctx.hooks = (site_fault(current_path("dD")),
                     site_fault(current_path("dW")))
        return o

    @staticmethod
    def backward(ctx, g):
        """dW = D^T @ dO and dD = dO @ W^T, each protected with checksums
        of the runtime operands (the paper's back-propagation extension:
        checksums of grad-O play the role of the kernel checksums)."""
        d, w = ctx.saved_tensors
        cfg = ctx.cfg
        lead, k = d.shape[:-1], d.shape[-1]
        d2 = d.reshape(-1, k)
        g2 = g.reshape(-1, g.shape[-1])
        # W^T is a view the kernel reads in place (its transposed-W layout)
        wt = w.T.to(g2.dtype)
        if cfg is not None and cfg.protect_backward:
            dd2, rep_d = _backward_product(g2, wt, cfg, ctx.hooks[0])
            # D^T is copied: the kernel reads D row-major only
            dw, rep_w = _backward_product(d2.T.contiguous(), g2.to(d2.dtype),
                                          cfg, ctx.hooks[1])
            if ctx.reports is not None:
                ctx.reports += [rep_d, rep_w]
        else:
            dd2 = matmul_raw(g2, wt)
            dw = matmul_raw(d2.T, g2.to(d2.dtype))
        return dd2.reshape(*lead, k).to(d.dtype), dw.to(w.dtype), None, None


def abft_matmul_vjp(d: torch.Tensor, w: torch.Tensor,
                    cfg: Optional[T.ProtectConfig],
                    reports: Optional[list] = None) -> torch.Tensor:
    """O = D @ W through protected_matmul, whose backward protects both
    products: dD = dO W^T and dW = D^T dO each run the multischeme
    workflow (`cfg.protect_backward`; plain products otherwise). With
    `cfg.use_fused_kernel` on the card each of the three products is one
    abft_matmul launch. The JAX package drops the backward's reports; a
    `reports` list, when given, receives dD's then dW's."""
    return _AbftMatmulVJP.apply(d, w, cfg, reports)


# --------------------------------------------------------------------------
# the protected convolution (the paper's native object)
# --------------------------------------------------------------------------

def protected_conv(
    d: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding="VALID",
    groups: int = 1,
    wck: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cfg: T.ProtectConfig = T.DEFAULT_CONFIG,
    o: Optional[torch.Tensor] = None,
    tamper_checksums: Optional[Callable] = None,
    mode: Optional[str] = None,
    detected=None,
):
    """Protected conv (paper Eq. 1): D[N,Ch,H,H] (x) W[M,Ch,R,R] + bias.

    `o` injects a precomputed *complete* output (bias included); `wck`
    carries the precomputed (C_w1, C_w2). `mode`/`detected` as in
    protect_matmul_output."""
    conv = lambda: C.conv2d(d, w, stride=stride, padding=padding,
                            groups=groups)
    if o is None:
        o = conv()
        if bias is not None:
            o = (o.to(F32) + bias[None, :, None, None].to(F32)).to(o.dtype)
    if cfg is None or not cfg.enabled:
        return _clean_result(o, mode)

    n_, m_ = o.shape[0], o.shape[1]
    p = o.shape[2] * o.shape[3]
    k_eq = d.shape[1] * w.shape[2] * w.shape[3]  # Ch*R*R contraction length
    dev = o.device

    cd1, cd2 = C.encode_d_conv(d)
    if wck is None:
        wck = C.encode_w_conv(w, groups=groups)
    cw1, cw2 = wck

    def recompute_fn():
        out = conv()
        if bias is not None:
            out = (out.to(F32)
                   + bias[None, :, None, None].to(F32)).to(out.dtype)
        return out

    def _bias_adjusted(cs):
        """Checksum-side bias additions (paper Table 5)."""
        if bias is None:
            return cs
        b = bias.to(F32)
        sum_n = n_ * (n_ - 1) / 2.0
        wm = _iota(m_, dev)
        return T.OutputChecksums(
            None if cs.c1 is None else cs.c1 + n_ * b[:, None],
            None if cs.c2 is None else cs.c2 + torch.sum(b),
            None if cs.c3 is None else cs.c3 + sum_n * b[:, None],
            None if cs.c4 is None else cs.c4 + torch.dot(wm, b),
            cs.c5 + n_ * torch.sum(b),
            cs.c6 + sum_n * torch.sum(b),
            cs.c7 + n_ * torch.dot(wm, b),
        )

    def _cs(need_rowcol):
        cs = C.output_checksums_conv(d, w, cd1, cd2, cw1, cw2, stride=stride,
                                     padding=padding, groups=groups,
                                     need_rowcol=need_rowcol)
        if tamper_checksums is not None:
            cs = tamper_checksums(cs)
        return _bias_adjusted(cs)

    # ---------------- CoC-D detection: the error-free hot path ------------
    # one stacked checksum conv (c5/c6/c7 + the |.| threshold conv) and one
    # pass over O (s5/s6/s7/sumsq); everything at full row/column
    # resolution waits behind the ladder's gate
    c5d, c6d, c7d, absd = C.detect_checksums_conv(
        cd1, cd2, cw1, cw2, stride=stride, padding=padding)
    if mode == "correct" and detected is not None:
        # trust the carried CoC-D flag: no detection pass, no second read
        detected = _carried(detected)
    else:
        cs0 = T.OutputChecksums(None, None, None, None, c5d, c6d, c7d)
        if tamper_checksums is not None:
            cs0 = tamper_checksums(cs0)
        cs0 = _bias_adjusted(cs0)
        s5, s6, s7, sumsq = C.detect_sums(o, use_kernel=cfg.use_fused_kernel)
        tau5 = TH.tau_scalar(sumsq, k_eq, o.dtype, cfg.tau_factor, absd)
        tau5v = torch.broadcast_to(tau5, (p,))
        flag, score = _detect_invariants(cs0.c5, cs0.c6, cs0.c7,
                                         s5, s6, s7, tau5v, n_, m_,
                                         cfg.detect_weighted)
        if mode == "detect_only":
            return o, T.DetectEvidence(flag.to(torch.int32), score)
        if cfg.detect_only and mode != "correct":
            det = flag.to(torch.int32)
            return o, T.FaultReport(det, 0, det)
        detected = flag if detected is None else _carried(detected)

    def _norm(o):
        return o.reshape(n_, m_, p)

    def _denorm(o3):
        return o3.reshape(o.shape)

    def _verify(oo):
        ssv = C.output_sums_conv(oo)
        # verification uses trusted checksums: re-encode when the
        # detection-path set was tampered with (test hook)
        csf = _cs(need_rowcol=True) if tamper_checksums is None else \
            _bias_adjusted(C.output_checksums_conv(
                d, w, *C.encode_d_conv(d), *C.encode_w_conv(w, groups=groups),
                stride=stride, padding=padding, groups=groups,
                need_rowcol=True))
        t5 = TH.tau_scalar(ssv.sumsq, k_eq, oo.dtype, cfg.tau_factor, absd)
        t5 = torch.broadcast_to(t5, (p,))
        return _verify_invariants(csf, ssv, t5, t5[None, :], n_, m_)

    def _run_scheme(fn, oo, tau_kind):
        o3 = _norm(oo)
        cs = _cs(need_rowcol=True)
        ss = C.output_sums_conv(oo)
        t5 = TH.tau_scalar(ss.sumsq, k_eq, oo.dtype, cfg.tau_factor, absd)
        t5v = torch.broadcast_to(t5, (p,))
        taus = _scheme_taus(tau_kind, t5v, t5v[None, :], n_, m_)
        fixed, ok = fn(o3, cs, ss, *taus)
        return _denorm(fixed), ok

    rungs = _ladder_rungs(cfg, _run_scheme)
    return run_ladder(o, detected, rungs, _verify, recompute_fn)
