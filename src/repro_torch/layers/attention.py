"""GQA attention (twin of repro.layers.attention): full / sliding-window /
local-global / chunked variants, ABFT-protected projections, RoPE,
optional QK-norm and logit softcapping.

The score x value core is plain PyTorch in fp32 (scores and softmax), as
the JAX package's is jnp, computed in q-blocks so the live score buffer is
(B, Hkv, G, q_block, S_kv). Decode attends one query row per slot against
the cache (per-slot positions supported). The cache is updated in place:
the model's forward hands each call a copy it owns."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core import FaultReport, ProtectConfig, merge_verdicts
from ..core.protected import pick_chunk
from .linear import apply_dense, init_dense
from .norms import rms_norm
from .rotary import apply_rope, rope_tables

F32 = torch.float32
NEG_INF = -1e30


def init_attention(generator: torch.Generator, cfg, dtype=torch.bfloat16,
                   device=None) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": init_dense(generator, d, cfg.num_heads * hd, dtype=dtype,
                         device=device),
        "wk": init_dense(generator, d, cfg.num_kv_heads * hd, dtype=dtype,
                         device=device),
        "wv": init_dense(generator, d, cfg.num_kv_heads * hd, dtype=dtype,
                         device=device),
        "wo": init_dense(generator, cfg.num_heads * hd, d, dtype=dtype,
                         scale=(cfg.num_heads * hd) ** -0.5, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _mask(kind: str, q_pos, kv_pos, window: int, chunk: int):
    """q_pos: (B, Sq) or (1, Sq); kv_pos: (Skv,) -> (B, Sq, Skv) bool."""
    q = q_pos[..., None].to(torch.int64)
    k = kv_pos[None, None, :].to(torch.int64)
    m = k <= q  # causal
    if kind in ("attn_swa", "attn_local"):
        m = m & ((q - k) < window)
    elif kind == "attn_chunk":
        m = m & (torch.div(q, chunk, rounding_mode="floor")
                 == torch.div(k, chunk, rounding_mode="floor"))
    return m


def _attn_core(q, k, v, q_pos, kv_pos, *, kind, window, chunk,
               attn_cap: float, q_block: int = 0):
    """q: (B,Sq,Hkv,G,hd); k/v: (B,Skv,Hkv,hd) -> (B,Sq,Hkv,G,hd)."""
    b, sq, hkv, g, hd = q.shape
    skv = k.shape[1]
    scale = hd ** -0.5
    if not q_block:
        q_block = max(16, min(512, (1 << 32) // max(b * hkv * g * skv * 4,
                                                    1)))
    qb = pick_chunk(sq, min(q_block, sq))
    k32, v32 = k.to(F32), v.to(F32)
    q_pos = torch.broadcast_to(q_pos, (q_pos.shape[0], sq))
    outs = []
    for i in range(sq // qb):
        qblk = q[:, i * qb:(i + 1) * qb]
        s = torch.einsum("bqkgh,bskh->bkgqs", qblk.to(F32), k32) * scale
        if attn_cap:
            s = attn_cap * torch.tanh(s / attn_cap)
        m = _mask(kind, q_pos[:, i * qb:(i + 1) * qb], kv_pos, window, chunk)
        s = torch.where(m[:, None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", p, v32))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.to(q.dtype)


def apply_attention(
    params: Dict,
    x: torch.Tensor,                   # (B, S, d)
    *,
    kind: str,
    cfg,                               # ModelConfig
    abft: Optional[ProtectConfig],
    positions: torch.Tensor,           # (B, S) or (1, S)
    cache: Optional[Dict] = None,      # {"k","v": (B, L, Hkv, hd)}, in place
    cache_pos=None,                    # int, or (B,) tensor of positions
) -> Tuple[torch.Tensor, FaultReport, Optional[Dict]]:
    b, s, d = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    g = cfg.q_per_kv

    q, r1 = apply_dense(params["wq"], x, abft, name="wq")
    k, r2 = apply_dense(params["wk"], x, abft, name="wk")
    v, r3 = apply_dense(params["wv"], x, abft, name="wv")
    rep = merge_verdicts(merge_verdicts(r1, r2), r3)

    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)

    sin, cos = rope_tables(positions, hd, cfg.rope_theta)    # (B|1, S, hd/2)
    sin_b = torch.broadcast_to(sin, (b, s, hd // 2))
    cos_b = torch.broadcast_to(cos, (b, s, hd // 2))
    q = apply_rope(q, sin_b, cos_b)
    k = apply_rope(k, sin_b, cos_b)

    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1:
            cp = cache_pos.to(x.device)
            # continuous batching: one new row per slot at its own
            # position (the same writes as the JAX package's one-hot
            # masked update)
            if s != 1:
                raise ValueError(
                    "apply_attention: vector cache_pos requires a single "
                    f"new position per row (got seq len {s})")
            rows = torch.arange(b, device=x.device)
            ck[rows, cp] = k[:, 0].to(ck.dtype)
            cv[rows, cp] = v[:, 0].to(cv.dtype)
        else:
            p0 = int(cache_pos)       # a host int: no device read
            ck[:, p0:p0 + s] = k.to(ck.dtype)
            cv[:, p0:p0 + s] = v.to(cv.dtype)
        kv_pos = torch.arange(ck.shape[1], device=x.device)
        out = _attn_core(q.reshape(b, s, hkv, g, hd), ck, cv, positions,
                         kv_pos, kind=kind, window=cfg.window_size,
                         chunk=cfg.attn_chunk, attn_cap=cfg.attn_softcap)
    else:
        kv_pos = positions[0] if positions.shape[0] == 1 else \
            torch.arange(s, device=x.device)
        out = _attn_core(q.reshape(b, s, hkv, g, hd), k, v, positions,
                         kv_pos, kind=kind, window=cfg.window_size,
                         chunk=cfg.attn_chunk, attn_cap=cfg.attn_softcap)

    out = out.reshape(b, s, hq * hd)
    y, r4 = apply_dense(params["wo"], out, abft, name="wo")
    return y, merge_verdicts(rep, r4), cache


def init_cache(cfg, kind: str, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Full-length cache."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
