"""GQA attention (twin of repro.layers.attention): full / sliding-window /
local-global / chunked variants, ABFT-protected projections, RoPE,
optional QK-norm and logit softcapping.

The score x value core is plain PyTorch in fp32 (scores and softmax), as
the JAX package's is jnp, computed in q-blocks so the live score buffer is
(B, Hkv, G, q_block, S_kv). Decode attends one query row per slot against
the cache (per-slot positions supported). The cache is updated in place:
the model's forward hands each call a copy it owns.

Under a mesh (runtime.sharding.parallel_scope) the head counts are the
local weights': wq/wk/wv column-sharded over 'model' give each rank its
query heads and the KV heads they use, and wo's row-sharded partials are
summed (layers.linear). Where wq shards and wk/wv replicate (the KV heads
do not divide the axis: yi-9b-smoke's 2 on 4 ranks) every rank computes
and caches every KV head and attends with the ones its query heads use;
those replicated weights then enter through Megatron's f, since each rank
back-propagates only its own heads' share of their gradient.

In a context-parallel scope (parallel_scope(..., context_parallel=True))
each data rank's cache holds its L/D block of the sequence: a write lands
only on the rank that owns the position, at its local offset, each rank
attends its block with the key positions offset by its start, and the
softmax partials (row max, row sum, weighted values) merge over 'data'
before the output projection (runtime.sharding.merge_softmax_partials)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core import FaultReport, ProtectConfig, merge_verdicts
from ..core.protected import pick_chunk
from ..runtime.sharding import (copy_to_model, current_parallel, data_axes,
                                data_index, merge_softmax_partials)
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
               attn_cap: float, q_block: int = 0, merge=None):
    """q: (B,Sq,Hkv,G,hd); k/v: (B,Skv,Hkv,hd) -> (B,Sq,Hkv,G,hd).
    `merge` (mesh, axes): k/v are this rank's block of a sequence split
    over `axes`, whose softmax partials are merged over them."""
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
        if merge is None:
            p = torch.softmax(s, dim=-1)
            outs.append(torch.einsum("bkgqs,bskh->bqkgh", p, v32))
            continue
        # this block's partials; a row masked whole weighs nothing
        mx = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - mx) * m[:, None, None]
        o = torch.einsum("bkgqs,bskh->bkgqh", p, v32)
        o = merge_softmax_partials(mx, torch.sum(p, dim=-1, keepdim=True),
                                   o, *merge)
        outs.append(o.permute(0, 3, 1, 2, 4))
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
    hd = cfg.head_dim
    # local head counts: the full ones off a mesh
    hq = params["wq"]["w"].shape[-1] // hd
    hkv = params["wk"]["w"].shape[-1] // hd
    g = hq // hkv
    par = current_parallel()
    select = None
    wk_p, wv_p, x_kv = params["wk"], params["wv"], x
    q_norm, k_norm = params.get("q_norm"), params.get("k_norm")
    if par is not None and par.tp > 1 and hq != cfg.num_heads:
        mesh = par.mesh
        if hkv == cfg.num_kv_heads:
            g = cfg.q_per_kv
            if hq % g and g % hq:
                raise NotImplementedError(
                    f"attention on {par.tp} model ranks: {hq} local query "
                    f"heads do not tile groups of {g} (ROADMAP item 1.12)")
            kv0 = mesh.index("model") * hq // g
            select = (kv0, max(hq // g, 1))
            g = hq // select[1]
            x_kv = copy_to_model(x, mesh)
            wk_p = {n: copy_to_model(t, mesh) for n, t in wk_p.items()}
            wv_p = {n: copy_to_model(t, mesh) for n, t in wv_p.items()}
        if cfg.qk_norm:
            q_norm = copy_to_model(q_norm, mesh)
            k_norm = copy_to_model(k_norm, mesh)

    q, r1 = apply_dense(params["wq"], x, abft, name="wq")
    k, r2 = apply_dense(wk_p, x_kv, abft, name="wk")
    v, r3 = apply_dense(wv_p, x_kv, abft, name="wv")
    rep = merge_verdicts(merge_verdicts(r1, r2), r3)

    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)

    sin, cos = rope_tables(positions, hd, cfg.rope_theta)    # (B|1, S, hd/2)
    sin_b = torch.broadcast_to(sin, (b, s, hd // 2))
    cos_b = torch.broadcast_to(cos, (b, s, hd // 2))
    q = apply_rope(q, sin_b, cos_b)
    k = apply_rope(k, sin_b, cos_b)

    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        # context parallelism: this rank's block [off, off + L) of the
        # sequence (the whole of it off a context-parallel scope)
        off, merge = None, None
        if par is not None and par.context_parallel:
            off = data_index(par.mesh)[0] * ck.shape[1]
            merge = (par.mesh, data_axes(par.mesh))
        _write_cache(ck, cv, k, v, cache_pos, off)
        start = off or 0
        kv_pos = torch.arange(start, start + ck.shape[1], device=x.device)
        ck, cv = _kv_heads(ck, select), _kv_heads(cv, select)
        out = _attn_core(q.reshape(b, s, -1, g, hd), ck, cv, positions,
                         kv_pos, kind=kind, window=cfg.window_size,
                         chunk=cfg.attn_chunk, attn_cap=cfg.attn_softcap,
                         merge=merge)
    else:
        kv_pos = positions[0] if positions.shape[0] == 1 else \
            torch.arange(s, device=x.device)
        out = _attn_core(q.reshape(b, s, -1, g, hd), _kv_heads(k, select),
                         _kv_heads(v, select), positions,
                         kv_pos, kind=kind, window=cfg.window_size,
                         chunk=cfg.attn_chunk, attn_cap=cfg.attn_softcap)

    out = out.reshape(b, s, hq * hd)
    y, r4 = apply_dense(params["wo"], out, abft, name="wo")
    return y, merge_verdicts(rep, r4), cache


def _write_cache(ck, cv, k, v, cache_pos, off: Optional[int]) -> None:
    """Write the new rows into the cache, in place: rows [p0, p0 + S) for
    a host int position, one row per slot for a (B,) position vector
    (continuous batching, the same writes as the JAX package's one-hot
    masked update). `off`: the cache is the block of a context-parallel
    sequence that starts at that position, and a position outside it is
    another rank's and is not written (None: the whole sequence)."""
    b, s = k.shape[:2]
    if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1:
        if s != 1:
            raise ValueError(
                "apply_attention: vector cache_pos requires a single "
                f"new position per row (got seq len {s})")
        cp = cache_pos.to(k.device)
        rows = torch.arange(b, device=k.device)
        kn, vn = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
        if off is not None:
            n = ck.shape[1]
            own = ((cp >= off) & (cp < off + n))[:, None, None]
            cp = (cp - off).clamp(0, n - 1)
            # another rank's row rewrites this block's row with itself: no
            # data-dependent shape, so no device read
            kn = torch.where(own, kn, ck[rows, cp])
            vn = torch.where(own, vn, cv[rows, cp])
        ck[rows, cp] = kn
        cv[rows, cp] = vn
        return
    p0 = int(cache_pos)               # a host int: no device read
    if off is None:
        ck[:, p0:p0 + s] = k.to(ck.dtype)
        cv[:, p0:p0 + s] = v.to(cv.dtype)
        return
    lo, hi = max(p0, off), min(p0 + s, off + ck.shape[1])
    if lo < hi:
        ck[:, lo - off:hi - off] = k[:, lo - p0:hi - p0].to(ck.dtype)
        cv[:, lo - off:hi - off] = v[:, lo - p0:hi - p0].to(cv.dtype)


def _kv_heads(t, select):
    """The KV heads this rank's query heads use (all of them off a mesh)."""
    if select is None:
        return t
    return t[:, :, select[0]:select[0] + select[1]]


def init_cache(cfg, kind: str, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Full-length cache."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
