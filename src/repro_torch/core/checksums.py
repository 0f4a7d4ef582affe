"""Input/output checksum encodings (paper Eq. 5/6), for matmul and conv
(twin of repro.core.checksums).

Matmul block view: O[N,M] = D[N,K] @ W[K,M]; every identity of the paper
holds with per-block payload P=1. Conv view: D[N,Ch,H,H], W[M,Ch,R,R],
O[N,M,E,E]; the payload is the E*E output map. All checksums are carried
in fp32 regardless of the operand dtype.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .types import OutputChecksums, OutputSums

F32 = torch.float32


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=F32, device=device)


# --------------------------------------------------------------------------
# matmul path
# --------------------------------------------------------------------------

def encode_d_matmul(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """C_d1, C_d2 of D[N,K] (fp32)."""
    d32 = d.to(F32)
    return torch.sum(d32, dim=0), _iota(d.shape[0], d.device) @ d32


def encode_w_matmul(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """C_w1, C_w2 of W[K,M] (fp32)."""
    w32 = w.to(F32)
    return torch.sum(w32, dim=1), w32 @ _iota(w.shape[1], w.device)


def output_sums_matmul(o: torch.Tensor) -> OutputSums:
    """All seven summations + sumsq of O[N,M] in fp32, payload axis P=1
    appended."""
    n, m = o.shape
    o32 = o.to(F32)
    wn, wm = _iota(n, o.device), _iota(m, o.device)
    s1 = torch.sum(o32, dim=0)
    s2 = torch.sum(o32, dim=1)
    s3 = wn @ o32
    s4 = o32 @ wm
    s5 = torch.sum(s1)
    s6 = torch.dot(wn, s2)
    s7 = torch.dot(s1, wm)
    sumsq = torch.sum(o32 * o32)
    return OutputSums(s1[:, None], s2[:, None], s3[:, None], s4[:, None],
                      s5[None], s6[None], s7[None], sumsq)


def output_checksums_matmul(d, w, cd1, cd2, cw1, cw2,
                            need_rowcol: bool = True) -> OutputChecksums:
    """C_o1..C_o7. The scalar triple is O(K); c1..c4 are single GEMVs."""
    c5 = torch.dot(cd1, cw1)[None]
    c6 = torch.dot(cd2, cw1)[None]
    c7 = torch.dot(cd1, cw2)[None]
    if need_rowcol:
        w32, d32 = w.to(F32), d.to(F32)
        c1 = (cd1 @ w32)[:, None]
        c2 = (d32 @ cw1)[:, None]
        c3 = (cd2 @ w32)[:, None]
        c4 = (d32 @ cw2)[:, None]
    else:
        c1 = c2 = c3 = c4 = None
    return OutputChecksums(c1, c2, c3, c4, c5, c6, c7)


def absdot_matmul(cd1: torch.Tensor, cw1: torch.Tensor) -> torch.Tensor:
    """|C_d1| . |C_w1| - checksum-side magnitude for the threshold model."""
    return torch.dot(torch.abs(cd1), torch.abs(cw1))


# --------------------------------------------------------------------------
# conv path (NCHW / OIHW)
# --------------------------------------------------------------------------

def _conv(d, w, stride: int, padding, groups: int = 1) -> torch.Tensor:
    """F.conv2d with the JAX package's padding spellings: "VALID", "SAME"
    (XLA's asymmetric split, applied with F.pad), an int, or per-axis
    (lo, hi) pairs."""
    if padding == "VALID":
        pad = 0
    elif padding == "SAME":
        r = w.shape[2]

        def _same(size):
            out = -(-size // stride)
            total = max((out - 1) * stride + r - size, 0)
            return total // 2, total - total // 2
        (hl, hh), (wl, wh) = _same(d.shape[2]), _same(d.shape[3])
        d, pad = F.pad(d, (wl, wh, hl, hh)), 0
    elif isinstance(padding, (list, tuple)):
        (hl, hh), (wl, wh) = padding
        if hl == hh and wl == wh:
            pad = (int(hl), int(wl))
        else:
            d, pad = F.pad(d, (int(wl), int(wh), int(hl), int(hh))), 0
    else:
        pad = int(padding)
    return F.conv2d(d, w, stride=stride, padding=pad, groups=groups)


def conv2d(d: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding="VALID", groups: int = 1) -> torch.Tensor:
    """The unprotected convolution (paper Eq. 1 without bias); the
    checksums sit above whichever implementation runs it."""
    return _conv(d, w.to(d.dtype), stride, padding, groups)


def encode_d_conv(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """C_d1, C_d2 over the batch axis of D[N,Ch,H,W], as ONE
    (2,N)@(N,Ch*H*W) product with the constant weights [ones; iota]."""
    n = d.shape[0]
    enc = torch.stack([torch.ones((n,), dtype=F32, device=d.device),
                       _iota(n, d.device)])
    cd = (enc @ d.to(F32).reshape(n, -1)).reshape(2, *d.shape[1:])
    return cd[0], cd[1]


def encode_w_conv(w: torch.Tensor, groups: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """C_w1, C_w2 over the output-channel axis of W[M,Ch,R,R]; grouped
    convs concatenate the per-group checksums along channels."""
    w32 = w.to(F32)
    m = w.shape[0]
    if groups == 1:
        return torch.sum(w32, dim=0), torch.tensordot(_iota(m, w.device),
                                                      w32, dims=1)
    mg = m // groups
    wg = w32.reshape(groups, mg, *w32.shape[1:])
    weights = _iota(m, w.device).reshape(groups, mg)
    cw1 = torch.cat(list(torch.sum(wg, dim=1)), dim=0)
    cw2 = torch.cat(list(torch.einsum("gm,gmchw->gchw", weights, wg)), dim=0)
    return cw1, cw2


def detect_sums(o: torch.Tensor, *, use_kernel: bool = False,
                tiles: Optional[Tuple[int, int]] = None,
                exact_order: bool = False):
    """The CoC-D detection summations of O[N,M,E,E]: (s5, s6, s7, sumsq),
    per payload position p (sumsq scalar), in ONE pass over O.

    The default is one (3,N*M)@(N*M,P) product with the constant weights
    [1; n; m] plus a dot for the sum of squares. `exact_order=True`
    reduces in output_sums_conv's order and is bitwise identical to it on
    fp32. `use_kernel=True` routes the pass through the checksum_reduce
    module's conv sums (kernels.ops.conv_detect_sums); only a CPU tensor
    whose view is degenerate falls through to the plain pass, as in the
    JAX package."""
    if use_kernel and not exact_order:
        from repro_torch.kernels import ops as kops
        out = kops.conv_detect_sums(o, tiles=tiles)
        if out is not None:
            return out
    n, m, e1, e2 = o.shape
    p = e1 * e2
    dev = o.device
    if exact_order:
        o32 = o.to(F32).reshape(n, m, p)
        s1 = torch.sum(o32, dim=0)
        s2 = torch.sum(o32, dim=1)
        s5 = torch.sum(s1, dim=0)
        s6 = torch.tensordot(_iota(n, dev), s2, dims=1)
        s7 = torch.tensordot(_iota(m, dev), s1, dims=1)
        sumsq = torch.sum(o32 * o32)
        return s5, s6, s7, sumsq
    o2 = o.to(F32).reshape(n * m, p)
    enc = torch.stack([torch.ones((n * m,), dtype=F32, device=dev),
                       _iota(n, dev).repeat_interleave(m),
                       _iota(m, dev).repeat(n)])
    s = enc @ o2
    flat = o2.reshape(-1)
    sumsq = torch.dot(flat, flat)
    return s[0], s[1], s[2], sumsq


def detect_checksums_conv(cd1, cd2, cw1, cw2, stride: int = 1,
                          padding="VALID"):
    """(c5, c6, c7, absdot) for CoC-D in ONE batched convolution: the batch
    [cd1, cd2, |cd1|] against the filters [cw1, cw2, |cw1|]."""
    dstk = torch.stack([cd1.to(F32), cd2.to(F32), torch.abs(cd1).to(F32)])
    wstk = torch.stack([cw1.to(F32), cw2.to(F32), torch.abs(cw1).to(F32)])
    out = _conv(dstk, wstk, stride, padding)
    return (out[0, 0].reshape(-1), out[1, 0].reshape(-1),
            out[0, 1].reshape(-1), torch.max(out[2, 2]))


def output_sums_conv(o: torch.Tensor) -> OutputSums:
    """Summations of O[N,M,E,E], payload-flattened to (., P=E*E)."""
    n, m, e1, e2 = o.shape
    p = e1 * e2
    o32 = o.to(F32).reshape(n, m, p)
    wn, wm = _iota(n, o.device), _iota(m, o.device)
    s1 = torch.sum(o32, dim=0)
    s2 = torch.sum(o32, dim=1)
    s3 = torch.tensordot(wn, o32, dims=1)
    s4 = torch.einsum("nmp,m->np", o32, wm)
    s5 = torch.sum(s1, dim=0)
    s6 = torch.tensordot(wn, s2, dims=1)
    s7 = torch.tensordot(wm, s1, dims=1)
    sumsq = torch.sum(o32 * o32)
    return OutputSums(s1, s2, s3, s4, s5, s6, s7, sumsq)


def output_checksums_conv(d, w, cd1, cd2, cw1, cw2, stride: int = 1,
                          padding="VALID", groups: int = 1,
                          need_rowcol: bool = True) -> OutputChecksums:
    """C_o1..C_o7 via small convolutions of the checksum blocks; grouped
    convs run the checksum convs dense (the paper's SS5.2 identity)."""
    d32, w32 = d.to(F32), w.to(F32)
    c5 = _conv(cd1[None], cw1[None], stride, padding)[0, 0].reshape(-1)
    c6 = _conv(cd2[None], cw1[None], stride, padding)[0, 0].reshape(-1)
    c7 = _conv(cd1[None], cw2[None], stride, padding)[0, 0].reshape(-1)
    if need_rowcol:
        c1 = _conv(cd1[None], w32, stride, padding, groups)[0]
        c3 = _conv(cd2[None], w32, stride, padding, groups)[0]
        c2 = _conv(d32, cw1[None], stride, padding)[:, 0]
        c4 = _conv(d32, cw2[None], stride, padding)[:, 0]
        c1, c2, c3, c4 = (x.reshape(x.shape[0], -1) for x in (c1, c2, c3, c4))
    else:
        c1 = c2 = c3 = c4 = None
    return OutputChecksums(c1, c2, c3, c4, c5, c6, c7)


def absdot_conv(cd1, cw1, stride: int = 1, padding="VALID") -> torch.Tensor:
    """|cd1| (x) |cw1| maximised over positions: one threshold scale per
    op."""
    c = _conv(torch.abs(cd1)[None], torch.abs(cw1)[None], stride, padding)
    return torch.max(c)


# --------------------------------------------------------------------------
# weight locator sums (at-rest repair side information), kept on the host
# in float64 like the JAX package's, so plans round-trip between the two
# --------------------------------------------------------------------------

class WeightLocators(NamedTuple):
    """Per-block 2D locator sums of one weight tensor (numpy float64).

    matmul W[K,M] with block width `cb`: r1/r2 (mb, K) per-block row sums
    (plain / column-index-weighted), c1/c2 (mb, cb) per-block column sums
    (plain / row-index-weighted). conv W[M,Ch,R,R] flattened to one
    (M, J=Ch*R*R) block (`cb` = 0): r1/r2 (M,), c1/c2 (J,)."""
    r1: Any
    r2: Any
    c1: Any
    c2: Any
    cb: int


def _host64(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().to("cpu", torch.float64).numpy()
    return np.asarray(w, dtype=np.float64)


def weight_locators_matmul(w, col_chunk: int) -> WeightLocators:
    """Locator sums of W[K,M], chunked like weight_checksums_matmul."""
    from .protected import pick_chunk
    k, m = int(w.shape[0]), int(w.shape[1])
    cb = pick_chunk(m, col_chunk)
    mb = m // cb
    w3 = _host64(w).reshape(k, mb, cb)
    r1 = np.einsum("kbc->bk", w3)
    r2 = np.einsum("kbc,c->bk", w3, np.arange(cb, dtype=np.float64))
    c1 = np.einsum("kbc->bc", w3)
    c2 = np.einsum("kbc,k->bc", w3, np.arange(k, dtype=np.float64))
    return WeightLocators(r1, r2, c1, c2, cb)


def weight_locators_conv(w) -> WeightLocators:
    """Locator sums of W[M,Ch,R,R] viewed as one (M, Ch*R*R) block."""
    m = int(w.shape[0])
    wf = _host64(w).reshape(m, -1)
    iota_j = np.arange(wf.shape[1], dtype=np.float64)
    iota_m = np.arange(m, dtype=np.float64)
    return WeightLocators(wf.sum(axis=1), wf @ iota_j,
                          wf.sum(axis=0), iota_m @ wf, 0)
