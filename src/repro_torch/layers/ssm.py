"""Mamba-2 (SSD, state-space duality) block (twin of repro.layers.ssm).

Training and prefill use the chunked SSD algorithm: quadratic
attention-like products inside chunks of length Q plus a sequential
inter-chunk state recurrence (the JAX package's `lax.scan` over S/Q steps
becomes a Python loop; state (B, H, P, N)). Decode is the O(1) per-step
recurrence.

The in/out projections (the dominant FLOPs) go through apply_dense, so
they are protected plan sites ("ssm/in_proj", "ssm/out_proj"). The scan
is a data-dependent recurrence with no weight-stationary linear
invariant and is not protected, as in the JAX package.

Types are the reference's: the depthwise conv runs in the type its
concatenation gives (the model's, or float32 where a bfloat16 tail meets a
float32 input), the SSD math in float32 (the SiLU of the fp32 conv output,
the fp32 softplus of dt), and A_log, D and dt_bias are float32 parameters
in any model. The recurrent state is {"h": (B, H, P, N) float32, "conv":
(B, K-1, C) bfloat16} as made; the block returns a new state and leaves
the one it was given as it was.

Under a mesh (runtime.sharding.parallel_scope) the JAX package's rules
split in_proj's packed [z, x, B, C, dt] columns, conv_w's x|B|C columns
and out_proj's rows contiguously over 'model', which does not follow the
block's segments. So in_proj's output is gathered over 'model', the
depthwise conv runs on this rank's columns of x|B|C with its conv tail
(B, K-1, C/tp) and its output is gathered too, the SSD scan runs on this
rank's heads (those of its out_proj rows and of its state h (B, H/tp, P,
N)) with the whole B and C, the gated RMSNorm sums its fp32 squares over
'model', and out_proj is row-parallel. A_log, D, dt_bias and norm are
replicated leaves of which a rank uses its heads' slice: they enter
through Megatron's f, so each rank's copy gets the gradient summed over
'model'.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core import FaultReport, ProtectConfig, merge_verdicts
from ..core.plan import current_path
from ..runtime.sharding import (copy_to_model, current_parallel,
                                gather_from_model, is_sharded,
                                reduce_from_model)
from .linear import apply_dense, init_dense
from .norms import activate, rms_norm

F32 = torch.float32


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_head_dim, cfg.ssm_state


def init_ssm(generator: torch.Generator, cfg, dtype=torch.bfloat16,
             device=None) -> Dict:
    """Random block params, drawn in fp32 from `generator` on its
    device."""
    d = cfg.d_model
    d_inner, h, p, n = _dims(cfg)
    # in_proj packs [z (gate), x, B, C, dt]
    d_in_proj = 2 * d_inner + 2 * n + h
    in_proj = init_dense(generator, d, d_in_proj, dtype=dtype, device=device)
    conv_w = (torch.randn((cfg.conv_kernel, d_inner + 2 * n),
                          generator=generator, dtype=F32,
                          device=generator.device)
              * cfg.conv_kernel ** -0.5)
    out_proj = init_dense(generator, d_inner, d, dtype=dtype,
                          scale=d_inner ** -0.5, device=device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=F32)
                           ).to(device),
        "D": torch.ones((h,), dtype=F32, device=device),
        "dt_bias": torch.zeros((h,), dtype=F32, device=device),
        "norm": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": out_proj,
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x: (B, S, C); w: (K, C); tail: (B, K-1, C)
    carries state across decode steps. Returns (y, new_tail), both in the
    promoted type of the tail and x."""
    k = w.shape[0]
    pad = tail if tail is not None else x.new_zeros(
        (x.shape[0], k - 1, x.shape[2]))
    dt = torch.promote_types(pad.dtype, x.dtype)
    xp = torch.cat([pad.to(dt), x.to(dt)], dim=1)     # (B, S+K-1, C)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    new_tail = xp[:, xp.shape[1] - (k - 1):] if k > 1 else pad
    return y, new_tail


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[i,j] = sum_{j<k<=i} x[k] (lower-tri)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def _ssd_chunked(xh, dt, a, bmat, cmat, chunk: int, h0=None):
    """SSD forward. xh: (B,S,H,P); dt: (B,S,H); a: (H,) = -exp(A_log);
    bmat/cmat: (B,S,N). Returns (y (B,S,H,P), h_last (B,H,P,N))."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    nc = s // q
    if s % q:
        raise ValueError(f"_ssd_chunked: length {s} is not a multiple of "
                         f"the chunk {q}")

    da = dt * a[None, None, :]                         # (B,S,H)
    xr = xh.reshape(b, nc, q, h, p)
    dtr = dt.reshape(b, nc, q, h)
    dar = da.reshape(b, nc, q, h)
    br = bmat.reshape(b, nc, q, n)
    cr = cmat.reshape(b, nc, q, n)

    # intra-chunk (diagonal block) output
    l = torch.exp(_segsum(dar.permute(0, 1, 3, 2)))   # (B,NC,H,Q,Q)
    att = torch.einsum("bcqn,bckn,bchqk,bckh->bchqk", cr, br, l, dtr)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", att, xr)

    # chunk-final states
    da_cum = torch.cumsum(dar, dim=2)                  # (B,NC,Q,H)
    decay = torch.exp(da_cum[:, :, -1:, :] - da_cum)   # (B,NC,Q,H)
    states = torch.einsum("bcqn,bcqh,bcqh,bcqhp->bchpn",
                          br, decay, dtr, xr)          # (B,NC,H,P,N)

    # inter-chunk recurrence (sequential over chunks)
    chunk_decay = torch.exp(da_cum[:, :, -1, :])       # (B,NC,H)
    hcur = (xh.new_zeros((b, h, p, n), dtype=F32) if h0 is None
            else h0.to(F32))
    hprevs = []
    for c in range(nc):
        hprevs.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + states[:, c]
    hprev = torch.stack(hprevs, dim=1)                 # (B,NC,H,P,N)

    # contribution of the carried-in state to each position
    state_decay = torch.exp(da_cum)                    # (B,NC,Q,H)
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cr, state_decay, hprev)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, hcur


def _model_shard(params, p: int):
    """(mesh, first head, heads, first conv column) of this rank's part
    of the block under a mesh that shards it over 'model'; None off one
    (or where the rules replicate the block's leaves)."""
    par = current_parallel()
    if (par is None or par.tp == 1
            or not is_sharded(par.spec(current_path("out_proj/w")))):
        return None
    rows = params["out_proj"]["w"].shape[0]
    if rows % p:
        raise NotImplementedError(
            f"ssm on {par.tp} model ranks: {rows} out_proj rows a rank do "
            f"not hold whole heads of {p}")
    r = par.mesh.index("model")
    cols = params["conv_w"].shape[-1]
    c0 = r * cols if is_sharded(par.spec(current_path("conv_w"))) else 0
    return par.mesh, r * (rows // p), rows // p, c0


def _rms_norm_over_model(y, scale, eps: float, width: int, mesh):
    """layers.norms.rms_norm of rows whose `width` features are split
    over 'model': the fp32 sums of squares summed over it (their gradient
    too: every rank's rows depend on the sum)."""
    y32 = y.to(F32)
    ss = reduce_from_model(torch.sum(y32 * y32, dim=-1, keepdim=True), mesh)
    var = copy_to_model(ss, mesh) / width
    return (y32 * torch.rsqrt(var + eps) * scale.to(F32)).to(y.dtype)


def apply_ssm(params: Dict, x: torch.Tensor, cfg,
              abft: Optional[ProtectConfig],
              state: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, FaultReport, Optional[Dict]]:
    """state = {"h": (B,H,P,N), "conv": (B,K-1,C)} for prefill and decode;
    None for the uncached forward (training, teacher forcing). Returns
    (out, report, new_state); new_state is None without a state. Under a
    mesh the state is this rank's (module docstring)."""
    b, s, d = x.shape
    d_inner, h, p, n = _dims(cfg)
    shard = _model_shard(params, p)
    a_log, d_skip = params["A_log"], params["D"]
    dt_bias, norm = params["dt_bias"], params["norm"]

    zxbcdt, rep = apply_dense(params["in_proj"], x, abft, name="in_proj")
    if shard is not None:
        mesh, h0, hl, c0 = shard
        if zxbcdt.shape[-1] < 2 * d_inner + 2 * n + h:
            zxbcdt = gather_from_model(zxbcdt, mesh)
        a_log, d_skip, dt_bias, norm = (
            copy_to_model(t, mesh)[sl] for t, sl in (
                (a_log, slice(h0, h0 + hl)), (d_skip, slice(h0, h0 + hl)),
                (dt_bias, slice(h0, h0 + hl)),
                (norm, slice(h0 * p, (h0 + hl) * p))))
    z, xin, bmat, cmat, dt = torch.split(
        zxbcdt, [d_inner, d_inner, n, n, h], dim=-1)
    if shard is not None:
        z, dt = z[..., h0 * p:(h0 + hl) * p], dt[..., h0:h0 + hl]
    dt = torch.nn.functional.softplus(dt.to(F32) + dt_bias)
    a = -torch.exp(a_log)                              # (H,)

    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_w = params["conv_w"]
    split_conv = shard is not None and conv_w.shape[-1] < conv_in.shape[-1]
    if split_conv:
        conv_in = conv_in[..., c0:c0 + conv_w.shape[-1]]
    tail = state["conv"] if state is not None else None
    conv_out, new_tail = _causal_conv(conv_in, conv_w, tail)
    conv_out = activate(conv_out.to(F32), "silu")
    if split_conv:
        conv_out = gather_from_model(conv_out, mesh)
    xc = conv_out[..., :d_inner].reshape(b, s, h, p)
    if shard is not None:
        xc = xc[:, :, h0:h0 + hl]
    bc = conv_out[..., d_inner:d_inner + n]
    cc = conv_out[..., d_inner + n:]

    if state is None or s > 1:
        # pad to a chunk multiple; padded steps have dt=0 => exp(dt*a)=1 and
        # zero input contribution, so the state recurrence is unaffected
        q = min(cfg.ssm_chunk, s)
        pad = (-s) % q
        if pad:
            def pz(t):
                shape = list(t.shape)
                shape[1] = pad
                return torch.cat([t, t.new_zeros(shape)], dim=1)
            xc_, dt_, bc_, cc_ = pz(xc), pz(dt), pz(bc), pz(cc)
        else:
            xc_, dt_, bc_, cc_ = xc, dt, bc, cc
        y, hlast = _ssd_chunked(xc_, dt_, a, bc_, cc_, q,
                                h0=None if state is None else state["h"])
        y = y[:, :s]
    else:
        # single-step decode recurrence
        dab = torch.exp(dt[:, 0, :] * a[None, :])                  # (B,H)
        hprev = state["h"].to(F32)
        hnew = (hprev * dab[..., None, None]
                + torch.einsum("bn,bh,bhp->bhpn", bc[:, 0], dt[:, 0],
                               xc[:, 0]))
        y = torch.einsum("bn,bhpn->bhp", cc[:, 0], hnew)[:, None]  # (B,1,H,P)
        hlast = hnew

    y = y + xc * d_skip[None, None, :, None]
    y = y.reshape(b, s, -1)
    y = y * activate(z.to(F32), "silu")
    if shard is None:
        y = rms_norm(y.to(x.dtype), norm, cfg.norm_eps)
    else:
        y = _rms_norm_over_model(y.to(x.dtype), norm, cfg.norm_eps,
                                 d_inner, mesh)
    out, r2 = apply_dense(params["out_proj"], y, abft, name="out_proj")
    rep = merge_verdicts(rep, r2)

    new_state = None
    if state is not None:
        new_state = {"h": hlast.to(state["h"].dtype), "conv": new_tail}
    return out, rep, new_state


def init_ssm_state(cfg, batch: int, device=None) -> Dict:
    """A zero state: h in float32 and the conv tail in bfloat16, whatever
    the model's type, as the JAX package's model makes it."""
    d_inner, h, p, n = _dims(cfg)
    return {
        "h": torch.zeros((batch, h, p, n), dtype=F32, device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, d_inner + 2 * n),
                            dtype=torch.bfloat16, device=device),
    }
