"""In-place repair of at-rest weight corruption from locator sums (twin of
repro.core.weight_repair).

The solver views damage per 2D block: a block B[R,C] carries four plan
sums - row-side r1[r]=sum_c B, r2[r]=sum_c c*B and column-side
c1[c]=sum_r B, c2[c]=sum_r r*B (checksums.WeightLocators). Residuals of
the live block against the plan localize the damage:

* exactly one row diverges  -> the per-column residuals dc1 ARE that
  row's per-element damage: subtract dc1 from the row;
* exactly one column diverges -> symmetric with dr1 down the column;
* both sides quiet            -> clean;
* anything else               -> unrepairable: escalate (restore rung).

Every attempted repair is verified by re-encoding the fixed block against
all four sums - a cancellation pattern that fooled the first-order masks
fails the index-weighted re-check and the verdict stays "escalate"
instead of serving a miscorrection.

The solver runs every block of an entry at once, branchless, in torch on
the device the weight lies on, in the dtype the caller picks: float32
(the default, the device path the fault campaign scores, as the JAX
package's jnp path) or float64 (the audit ladder's repair rung in
runtime.ft: the precision of the JAX package's numpy host path, without
copying the weights to the host). In float64 the residual noise is
~1e-13 relative, so f32 and bf16 leaves repair bitwise and integer
leaves exactly.

Verdict encoding (scalar int): 0 = clean, 1 = repaired (verified),
2 = unrepairable / escalate.
"""
from __future__ import annotations

import numpy as np
import torch

from .checksums import WeightLocators

F32 = torch.float32

CLEAN, REPAIRED, ESCALATE = 0, 1, 2

# float32-path relative tolerance: f32 re-encode noise of a block scales
# ~sqrt(R*C)*eps32 per unit of sum magnitude (~1e-4 at campaign shapes),
# while material corruption deltas sit orders of magnitude above it.
REPAIR_RTOL = 5e-4
# float64-path relative tolerance: f64 sums over f32/int8 data leave
# ~1e-13-relative residual noise; 1e-9 separates it from any corruption
# the f32 audit (rtol 1e-5) can flag in the first place.
HOST_RTOL = 1e-9


def locator_tol(wlc: WeightLocators, rtol: float,
                dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Absolute residual tolerance for one entry's locator sums: rtol
    against the largest plan-sum magnitude (the +1 floors all-zero
    entries), as a 0-d CPU tensor. float64 is the host scalar of the
    audit's repair rung; float32 is what the campaign's device path
    sees."""
    scale = torch.stack([
        torch.as_tensor(np.asarray(a), dtype=dtype).abs().max()
        for a in (wlc.r1, wlc.r2, wlc.c1, wlc.c2)]).max()
    return rtol * (scale + 1.0)


def _solve_block(b, r1, r2, c1, c2, tol):
    """Repair 2D blocks b (..., R, C) against their four locator sums
    r1/r2 (..., R) and c1/c2 (..., C), any leading batch of blocks at
    once. Returns (fixed_blocks, verdicts), branchless."""
    rows, cols = b.shape[-2], b.shape[-1]
    ir = torch.arange(rows, dtype=b.dtype, device=b.device)
    ic = torch.arange(cols, dtype=b.dtype, device=b.device)
    dr1 = b.sum(-1) - r1
    dr2 = b @ ic - r2
    dc1 = b.sum(-2) - c1
    dc2 = ir @ b - c2
    rows_hit = (dr1.abs() > tol) | (dr2.abs() > tol)
    cols_hit = (dc1.abs() > tol) | (dc2.abs() > tol)
    nr = rows_hit.sum(-1)
    nc = cols_hit.sum(-1)
    clean = (nr == 0) & (nc == 0)
    use_row = nr == 1
    use_col = (nc == 1) & ~use_row
    rstar = (dr1.abs() + dr2.abs()).argmax(-1)
    cstar = (dc1.abs() + dc2.abs()).argmax(-1)
    # single corrupted row r*: dc1 is exactly that row's per-element
    # damage (sub-tolerance noise elsewhere vanishes in the cast back);
    # single corrupted column c*: symmetric with dr1
    row_fix = b - (ir == rstar[..., None]).to(b.dtype)[..., :, None] \
        * dc1[..., None, :]
    col_fix = b - dr1[..., :, None] \
        * (ic == cstar[..., None]).to(b.dtype)[..., None, :]
    fixed = torch.where(use_row[..., None, None], row_fix,
                        torch.where(use_col[..., None, None], col_fix, b))
    # verify: re-encode the candidate against ALL four sums
    vr1 = (fixed.sum(-1) - r1).abs().amax(-1)
    vr2 = (fixed @ ic - r2).abs().amax(-1)
    vc1 = (fixed.sum(-2) - c1).abs().amax(-1)
    vc2 = (ir @ fixed - c2).abs().amax(-1)
    ok = (vr1 <= tol) & (vr2 <= tol) & (vc1 <= tol) & (vc2 <= tol)
    verdict = torch.where(clean, CLEAN,
                          torch.where((use_row | use_col) & ok,
                                      REPAIRED, ESCALATE))
    fixed = torch.where((verdict == REPAIRED)[..., None, None], fixed, b)
    return fixed, verdict


def _combine(verdicts):
    """Fold per-block verdicts into the entry verdict: all clean -> clean;
    exactly one touched block, repaired -> repaired; multi-block damage
    (or any failed repair) -> escalate, per the restore-rung contract."""
    touched = (verdicts != CLEAN).sum()
    repaired = (verdicts == REPAIRED).sum()
    return torch.where(touched == 0, CLEAN,
                       torch.where((touched == 1) & (repaired == 1),
                                   REPAIRED, ESCALATE))


def _sums(like, wlc: WeightLocators):
    return tuple(torch.as_tensor(np.asarray(getattr(wlc, f)),
                                 dtype=like.dtype, device=like.device)
                 for f in ("r1", "r2", "c1", "c2"))


def repair_matmul_weight(w, wlc: WeightLocators, tol,
                         dtype: torch.dtype = F32):
    """W[K,M] -> (fixed W in `dtype`, verdict). Blocks are solved
    independently; exactly one damaged block may repair, more
    escalates."""
    k, m = int(w.shape[0]), int(w.shape[1])
    cb = int(wlc.cb) or m
    mb = m // cb
    blocks = w.to(dtype).reshape(k, mb, cb).permute(1, 0, 2)
    fixed, verd = _solve_block(blocks, *_sums(blocks, wlc), tol)
    return fixed.permute(1, 0, 2).reshape(k, m), _combine(verd)


def repair_stacked_matmul_weight(w, wlc: WeightLocators, tol,
                                 dtype: torch.dtype = F32):
    """Stacked (reps, K, M) stage weight; locator sums carry a matching
    leading reps axis. The single-damaged-block gate is global across
    every repeat slice."""
    reps, k, m = (int(s) for s in w.shape)
    cb = int(wlc.cb) or m
    mb = m // cb
    w3 = w.to(dtype)
    blocks = w3.reshape(reps, k, mb, cb).permute(0, 2, 1, 3)
    r1, r2, c1, c2 = _sums(w3, wlc)
    fixed, verd = _solve_block(
        blocks.reshape(reps * mb, k, cb),
        r1.reshape(reps * mb, k), r2.reshape(reps * mb, k),
        c1.reshape(reps * mb, cb), c2.reshape(reps * mb, cb), tol)
    fixed = fixed.reshape(reps, mb, k, cb)
    return fixed.permute(0, 2, 1, 3).reshape(reps, k, m), _combine(verd)


def repair_conv_weight(w, wlc: WeightLocators, tol,
                       dtype: torch.dtype = F32):
    """W[M,Ch,R,R] -> (fixed W in `dtype`, verdict), solved as one
    (M, Ch*R*R) block (rows = filters, columns = kernel positions)."""
    m = int(w.shape[0])
    flat = w.to(dtype).reshape(m, -1)
    fixed, verd = _solve_block(flat, *_sums(flat, wlc), tol)
    return fixed.reshape(w.shape), _combine(verd.reshape(1))
