"""The four ABFT schemes of the paper (SS3.3-3.6) over the normalised block
form: O is (N, M, P), rows/columns are the paper's blocks and P is the
per-block payload (1 for matmul, E*E for conv). Twin of
repro.core.schemes.

Location uses arithmetic + one-hot masks, never host control flow. Each
corrector returns (O_fixed, ok); ok means every flagged discrepancy was
resolved by a legal location, and the workflow re-verifies and escalates
when it is not (paper Fig. 7).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .thresholds import mismatch
from .types import OutputChecksums, OutputSums

F32 = torch.float32


def _round_index(x_f: torch.Tensor, size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round a float locator to an integer index; legal iff near-integral
    and in range. Non-finite locators are illegal. torch.round rounds half
    to even, as jnp.round does."""
    finite = torch.isfinite(x_f)
    x_f = torch.where(finite, x_f, torch.full_like(x_f, -1.0))
    idx = torch.round(x_f)
    legal = finite & (torch.abs(x_f - idx) <= 0.25) & (idx >= 0) & (idx < size)
    return idx.to(torch.int32), legal


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def detect(cs: OutputChecksums, ss: OutputSums, tau5, tau6, tau7,
           weighted: bool = True) -> torch.Tensor:
    """CoC-D (paper SS3.6): C_o5 vs S_o5, plus the index-weighted
    invariants when `weighted`."""
    bad = torch.any(mismatch(cs.c5, ss.s5, tau5))
    if weighted:
        bad = bad | torch.any(mismatch(cs.c6, ss.s6, tau6))
        bad = bad | torch.any(mismatch(cs.c7, ss.s7, tau7))
    return bad


def coc_correct(o, cs: OutputChecksums, ss: OutputSums, tau5):
    """CoC (paper SS3.6): locate a single corrupted block via the weighted
    checksum ratios and add delta back. O: (N, M, P)."""
    n, m, _ = o.shape
    delta = (cs.c5 - ss.s5).to(F32)                        # (P,)
    flagged = torch.abs(delta) > tau5
    safe = torch.where(flagged, delta, torch.ones_like(delta))
    i_idx, i_ok = _round_index((cs.c6 - ss.s6) / safe, n)
    j_idx, j_ok = _round_index((cs.c7 - ss.s7) / safe, m)
    legal = i_ok & j_ok
    hit = ((_arange(n, o)[:, None, None] == i_idx[None, None, :])
           & (_arange(m, o)[None, :, None] == j_idx[None, None, :]))
    upd = torch.where(hit & flagged[None, None, :] & legal[None, None, :],
                      delta[None, None, :], torch.zeros((), dtype=F32,
                                                        device=o.device))
    fixed = (o.to(F32) + upd).to(o.dtype)
    ok = torch.all(torch.where(flagged, legal, torch.ones_like(legal)))
    return fixed, ok


def rc_correct(o, cs: OutputChecksums, ss: OutputSums, tau1):
    """RC (paper SS3.4): per column m, locate the corrupted row via
    i = (C_o3-S_o3)/(C_o1-S_o1)."""
    n, m, _ = o.shape
    diff = (cs.c1 - ss.s1).to(F32)                         # (M, P)
    flagged = torch.abs(diff) > tau1
    safe = torch.where(flagged, diff, torch.ones_like(diff))
    i_idx, legal = _round_index((cs.c3 - ss.s3) / safe, n)
    hit = _arange(n, o)[:, None, None] == i_idx[None, :, :]
    upd = torch.where(hit & flagged[None] & legal[None], diff[None],
                      torch.zeros((), dtype=F32, device=o.device))
    fixed = (o.to(F32) + upd).to(o.dtype)
    ok = torch.all(torch.where(flagged, legal, torch.ones_like(legal)))
    return fixed, ok


def clc_correct(o, cs: OutputChecksums, ss: OutputSums, tau2):
    """ClC (paper SS3.5): per row n locate the corrupted column via
    j = (C_o4-S_o4)/(C_o2-S_o2)."""
    n, m, _ = o.shape
    diff = (cs.c2 - ss.s2).to(F32)                         # (N, P)
    flagged = torch.abs(diff) > tau2
    safe = torch.where(flagged, diff, torch.ones_like(diff))
    j_idx, legal = _round_index((cs.c4 - ss.s4) / safe, m)
    hit = _arange(m, o)[None, :, None] == j_idx[:, None, :]
    upd = torch.where(hit & flagged[:, None] & legal[:, None], diff[:, None],
                      torch.zeros((), dtype=F32, device=o.device))
    fixed = (o.to(F32) + upd).to(o.dtype)
    ok = torch.all(torch.where(flagged, legal, torch.ones_like(legal)))
    return fixed, ok


def fc_correct(o, cs: OutputChecksums, ss: OutputSums, tau1, tau2):
    """FC (paper SS3.3 + SS4.1.6): row+column checksums.

    - exactly one bad row index  -> repair that row with column residues
    - exactly one bad column     -> repair that column with row residues
    - no bad rows/columns        -> O already consistent -> accept as-is
    - anything else              -> not correctable here (ok=False)
    """
    n, m, _ = o.shape
    res1 = (cs.c1 - ss.s1).to(F32)                         # (M, P)
    res2 = (cs.c2 - ss.s2).to(F32)                         # (N, P)
    mm1 = torch.abs(res1) > tau1
    mm2 = torch.abs(res2) > tau2
    colbad = torch.any(mm1, dim=-1)                        # (M,)
    rowbad = torch.any(mm2, dim=-1)                        # (N,)
    n_col = torch.sum(colbad.to(torch.int32))
    n_row = torch.sum(rowbad.to(torch.int32))
    # argmax of a bool needs an int view; ties resolve to the first index
    # as jnp.argmax does
    i_star = torch.argmax(rowbad.to(torch.int32))
    j_star = torch.argmax(colbad.to(torch.int32))
    zero = torch.zeros((), dtype=F32, device=o.device)
    row_hit = _arange(n, o)[:, None, None] == i_star
    col_hit = _arange(m, o)[None, :, None] == j_star
    row_fix = torch.where(row_hit & mm1[None], res1[None], zero)
    col_fix = torch.where(col_hit & mm2[:, None], res2[:, None], zero)
    use_row = n_row == 1
    use_col = (~use_row) & (n_col == 1)
    upd = torch.where(use_row, row_fix, torch.where(use_col, col_fix, zero))
    fixed = (o.to(F32) + upd).to(o.dtype)
    clean = (n_row == 0) & (n_col == 0)
    ok = use_row | use_col | clean
    return fixed, ok
