"""Mixture-of-experts block with sort-based capacity dispatch and ABFT on
both the router GEMM and the expert-batched GEMMs (twin of
repro.layers.moe).

Expert GEMMs are protected with *per-expert* checksums via
protected_grouped_matmul - the analogue of the paper's grouped
convolution (SS5.2): expert groups never mix, so per-group invariants are
exact. The top-k router decision itself is discrete (no linear
invariant); its GEMM is protected and the decision follows from its
corrected logits.

Dispatch: flatten the (token, k) assignments, sort them stably by expert
id, give each expert a contiguous capacity-C buffer (dropped assignments
fall through the residual), run the three expert GEMMs batched over E,
and combine each token's k weighted outputs. Every step is a device op on
shapes fixed by (tokens, E, C): no host read.

Three spellings keep the JAX package's semantics where a straight port
would not: top-k breaks ties by the lower expert index (jax.lax.top_k;
torch.topk does not promise it), so it is a stable descending sort; the
dispatch sort is stable (jnp.argsort), so the expert id and then the
assignment's flat index decide which assignment keeps a capacity slot;
and the combine, an fp32 scatter-add of k contributions per token in the
JAX package, un-permutes the contributions to (T, k) and sums them over k
in index order, with no float atomics (index_add_ on the card would sum in
an order that changes from run to run). The dispatch's gather is spelled
so that its backward is as deterministic: the tokens repeated k times,
then permuted, so the backward un-permutes (each row written once) and
sums the k copies of a token in a reduction, where a gather by token
index would accumulate them in an index_put_.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core import (OpSpec, ProtectConfig, ambient_mode, merge_verdicts,
                    path_scope, protect_site, protected_grouped_matmul,
                    resolve_entry)
from .ffn import apply_ffn, init_ffn
from .linear import apply_dense, init_dense
from .norms import activate

F32 = torch.float32
_GROUPED = OpSpec("grouped_matmul")


def _grouped(name: str, h, w, abft):
    """One expert-batched GEMM through the plan path: the ambient
    PlanEntry (its policy; per-expert checksums from the entry or, for a
    stage-stacked leaf, from the weight) or the threaded abft config,
    passed by keyword (the JAX package's positional call at
    src/repro/layers/moe.py:41 lands it in `wck`, ROADMAP 3.8)."""
    entry = resolve_entry(name)
    if entry is not None or ambient_mode() is not None:
        return protect_site(name, (h, w), entry=entry, op=_GROUPED,
                            cfg=abft)
    return protected_grouped_matmul(h, w, cfg=abft)


def _experts(generator: torch.Generator, e: int, d_in: int, d_out: int,
             scale: float, dtype, device) -> torch.Tensor:
    """(e, d_in, d_out) Normal(0, scale) weights, each expert drawn in fp32
    on the generator's device and cast into place, so no fp32 copy of the
    whole stack is made (22.5 GB for one of Kimi-K2's)."""
    out = torch.empty((e, d_in, d_out), dtype=dtype, device=device)
    for i in range(e):
        out[i] = (torch.randn((d_in, d_out), generator=generator, dtype=F32,
                              device=generator.device) * scale).to(dtype)
    return out


def init_moe(generator: torch.Generator, cfg, dtype=torch.bfloat16,
             device=None) -> Dict:
    d, ff, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    scale = d ** -0.5
    p = {
        "router": init_dense(generator, d, e, dtype=F32,   # router in fp32
                             device=device),
        "gate": _experts(generator, e, d, ff, scale, dtype, device),
        "up": _experts(generator, e, d, ff, scale, dtype, device),
        "down": _experts(generator, e, ff, d, ff ** -0.5, dtype, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(generator, d, ff * cfg.n_shared_experts,
                               dtype=dtype, device=device)
    return p


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top_w, top_e) (T, k): the k largest router probabilities of each
    token and their experts, ties to the lower expert index, as
    jax.lax.top_k gives them (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def dispatch(top_e: torch.Tensor, e: int, cap: int):
    """(order, slot, valid, token_of), each (T*k,), of the capacity
    dispatch: assignments sorted stably by expert, the i-th of an expert
    kept in its slot expert*cap + i while i < cap, every dropped one sent
    to the spare row e*cap; token_of is the token of each sorted
    assignment."""
    t, k = top_e.shape
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(sorted_e, sorted_e, right=False)
    pos = torch.arange(t * k, device=top_e.device) - group_start
    valid = pos < cap
    slot = torch.where(valid, sorted_e * cap + pos,
                       torch.full_like(sorted_e, e * cap))
    return order, slot, valid, order // k


def capacity(cfg, t: int) -> int:
    """Rows per expert for t tokens: Python's round, as the JAX package
    spells it (ties to even: 2.5 -> 2)."""
    return int(max(1, round(cfg.capacity_factor * t * cfg.top_k
                            / cfg.num_experts)))


def apply_moe(params: Dict, x: torch.Tensor, cfg,
              abft: ProtectConfig):
    """x: (B, S, d) -> (y, report, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)

    logits, rep = apply_dense(params["router"], xt.to(F32), abft,
                              name="router")
    probs = torch.softmax(logits.to(F32), dim=-1)                # (T, E)
    top_w, top_e = route(probs, k)                               # (T, k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    # load-balancing aux loss (Switch-style)
    density = torch.mean(
        torch.nn.functional.one_hot(top_e[:, 0], e).to(F32), dim=0)
    mean_probs = torch.mean(probs, dim=0)
    aux = e * torch.sum(density * mean_probs)

    cap = capacity(cfg, t)
    order, slot, valid, token_of = dispatch(top_e, e, cap)

    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    # xt[token_of], with a deterministic backward (see the docstring)
    buf[slot] = xt[:, None].expand(t, k, d).reshape(t * k, d)[order]
    h = buf[:e * cap].reshape(e, cap, d)

    g, r1 = _grouped("gate", h, params["gate"], abft)
    u, r2 = _grouped("up", h, params["up"], abft)
    act = activate(g, cfg.act) * u
    y, r3 = _grouped("down", act, params["down"], abft)
    for r in (r1, r2, r3):
        rep = merge_verdicts(rep, r)

    yb = torch.cat([y.reshape(e * cap, d),
                    torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    w_assign = top_w.reshape(-1)[order]                          # (T*k,)
    wv = torch.where(valid, w_assign, torch.zeros_like(w_assign))
    contrib = (yb[slot] * wv[:, None].to(y.dtype)).to(F32)
    # back to (token, k) order, summed over k in index order
    per_token = torch.empty_like(contrib)
    per_token[order] = contrib
    per_token = per_token.reshape(t, k, d)
    out = per_token[:, 0]
    for j in range(1, k):
        out = out + per_token[:, j]

    if "shared" in params:
        with path_scope("shared"):
            ys, rs = apply_ffn(params["shared"], xt, abft, cfg.act)
        out = out + ys.to(F32)
        rep = merge_verdicts(rep, rs)

    return out.to(x.dtype).reshape(b, s, d), rep, aux
