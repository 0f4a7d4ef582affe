"""Decoder-LM assembler (twin of repro.models.transformer: attention,
dense-FFN, MoE, Mamba-2 SSD and RG-LRU blocks, and multi-codebook token
I/O): init, caches, the protected forward, the training forward (autograd
through the protected route), prefill and decode, and the ProtectedModel
apply_fns.

Params are nested dicts of tensors in the JAX package's layouts. Stage
params keep JAX's leading repeats axis; the `lax.scan` over stages becomes
a Python loop over repeats that indexes `t[r]` (a view). The report merges
every repeat's carry into one "stages" section, as the scan carry does,
and each repeat's stacked plan entries are swapped for the view carrying
that repeat's checksum slice (`_stage_overrides`), so serving pays no
per-call weight encode (a stage's expert stacks excepted: the plan
fingerprints them only, and each call encodes its experts from the
weight, as in the JAX package). An ssm or rec block's cache is its
recurrent state, which each step replaces whole; attention writes one row
of its KV buffer. A moe block has no cache; its load-balancing loss is
summed over the blocks into the forward's `aux`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, fp32_ieee, resolve_device
from .._tree import tree_map
from ..core import (ModelReport, ProtectConfig, WeightChecksums,
                    ambient_mode, ambient_plan, as_fault_report,
                    clean_report, entry_overrides, merge_verdicts,
                    path_scope)
from ..core.plan import capture_scope, repeat_scope, replay_scope
from ..layers.attention import apply_attention, init_attention, init_cache
from ..layers.embedding import embed, init_embedding, logits_head
from ..layers.ffn import apply_ffn, init_ffn
from ..layers.moe import apply_moe, init_moe
from ..layers.norms import rms_norm, softcap
from ..layers.rglru import apply_rglru, init_rglru, init_rglru_state
from ..layers.ssm import apply_ssm, init_ssm, init_ssm_state

F32 = torch.float32

ATTN_KINDS = ("attn_full", "attn_swa", "attn_local", "attn_global",
              "attn_chunk")


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def abft_config(cfg) -> Optional[ProtectConfig]:
    if not cfg.abft:
        return None
    return ProtectConfig(row_chunk=cfg.abft_row_chunk,
                         col_chunk=cfg.abft_col_chunk,
                         detect_only=cfg.abft_detect_only)


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if len(trees) == 1:
        # one repeat: a view with the repeats axis, not a second copy of
        # the stage (an expert stack is tens of GB)
        return first.unsqueeze(0)
    return torch.stack(trees)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_block(kind: str, gen, cfg, device) -> Dict:
    dt = _dtype(cfg)
    p: Dict[str, Any] = {"norm": torch.ones((cfg.d_model,), dtype=dt,
                                            device=device)}
    if cfg.use_post_norm:
        p["post_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    if kind in ATTN_KINDS:
        p["attn"] = init_attention(gen, cfg, dt, device)
    elif kind == "ffn":
        p["ffn"] = init_ffn(gen, cfg.d_model, cfg.d_ff, dt, device)
    elif kind == "ssm":
        p["ssm"] = init_ssm(gen, cfg, dt, device)
    elif kind == "rec":
        p["rec"] = init_rglru(gen, cfg, dt, device)
    elif kind == "moe":
        p["moe"] = init_moe(gen, cfg, dt, device)
    else:
        raise ValueError(kind)
    return p


def _init_blocks(gen, pattern, cfg, device):
    return {f"b{i}_{kind}": _init_block(kind, gen, cfg, device)
            for i, kind in enumerate(pattern)}


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict:
    """Random params of `cfg`: drawn in fp32 from `generator` (a CPU
    torch.Generator seeded 0 when None), cast to the config's dtype and
    moved to `device` (the card unless the caller asks for the CPU). A
    CPU generator draws on the host, so one seed gives the same params on
    every device; a CUDA generator draws on its card (another stream, and
    seconds instead of a minute for a model of billions of params). Stage
    params are stacked on a leading repeats axis."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    pattern, reps, rem = cfg.stages()
    params: Dict[str, Any] = {
        "embed": init_embedding(generator, cfg, _dtype(cfg), dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=_dtype(cfg),
                                 device=dev)}
    if cfg.prefix_pattern:
        params["prefix"] = _init_blocks(generator, cfg.prefix_pattern, cfg,
                                        dev)
    if reps:
        params["stages"] = _stack_trees(
            [_init_blocks(generator, pattern, cfg, dev) for _ in range(reps)])
    if rem:
        params["rem"] = _init_blocks(generator, rem, cfg, dev)
    return params


def params_from_numpy(np_params, device: DeviceLike = None) -> Dict:
    """Carry a nested dict of arrays (the JAX package's params, converted
    with np.asarray) across as tensors on `device`. A bfloat16 array (an
    ml_dtypes array, which torch cannot take) crosses bit for bit, as
    uint16 viewed as torch.bfloat16."""
    dev = resolve_device(device)
    if isinstance(np_params, dict):
        return {k: params_from_numpy(v, dev) for k, v in np_params.items()}
    arr = np.asarray(np_params)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                                .view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.as_tensor(np.array(arr), device=dev)


def train_state_from_numpy(np_state, device: DeviceLike = None) -> Dict:
    """Carry a train state of the JAX package (launch.steps'
    {"params", "opt", "step"}, converted with np.asarray leaf by leaf)
    across as the port's: params, the optimizer's tree (AdamW's
    {"step", "m", "v"} or Adafactor's {"step", "v"}) and the step counter,
    each leaf as params_from_numpy carries it (bf16 bit for bit), so both
    packages start a step from the same state."""
    missing = {"params", "opt", "step"} - set(np_state)
    if missing:
        raise KeyError(f"not a train state: missing {sorted(missing)}")
    dev = resolve_device(device)
    return {k: params_from_numpy(np_state[k], dev)
            for k in ("params", "opt", "step")}


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def _init_block_cache(kind: str, cfg, batch: int, max_len: int, dt, device):
    if kind in ATTN_KINDS:
        return init_cache(cfg, kind, batch, max_len, dt, device)
    # ssm and rec: the reference's types, not the model's: h float32, the
    # conv tail bfloat16
    if kind == "ssm":
        return init_ssm_state(cfg, batch, device=device)
    if kind == "rec":
        return init_rglru_state(cfg, batch, device=device)
    return {}


def init_caches(cfg, batch: int, max_len: int,
                device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    dt = _dtype(cfg)
    pattern, reps, rem = cfg.stages()

    def blocks(pat, lead=()):
        out = {}
        for i, kind in enumerate(pat):
            c = _init_block_cache(kind, cfg, batch, max_len, dt, dev)
            out[f"b{i}_{kind}"] = {k: v.new_zeros(lead + tuple(v.shape))
                                   for k, v in c.items()}
        return out

    caches: Dict[str, Any] = {}
    if cfg.prefix_pattern:
        caches["prefix"] = blocks(cfg.prefix_pattern)
    if reps:
        caches["stages"] = blocks(pattern, (reps,))
    if rem:
        caches["rem"] = blocks(rem)
    return caches


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _apply_block(kind: str, bp: Dict, x, cfg, abft, positions,
                 cache=None, cache_pos=None):
    h = rms_norm(x, bp["norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=F32, device=x.device)
    new_cache = cache
    if kind in ATTN_KINDS:
        with path_scope("attn"):
            y, rep, new_cache = apply_attention(
                bp["attn"], h, kind=kind, cfg=cfg, abft=abft,
                positions=positions, cache=cache, cache_pos=cache_pos)
    elif kind == "ffn":
        with path_scope("ffn"):
            y, rep = apply_ffn(bp["ffn"], h, abft, cfg.act)
    elif kind in ("ssm", "rec"):
        apply = apply_ssm if kind == "ssm" else apply_rglru
        with path_scope(kind):
            y, rep, new = apply(bp[kind], h, cfg, abft, cache)
        if cache is not None:
            # the forward's own copy of the state, replaced whole
            for k, t in new.items():
                cache[k].copy_(t)
    elif kind == "moe":
        with path_scope("moe"):
            y, rep, aux = apply_moe(bp["moe"], h, cfg, abft)
    else:
        raise ValueError(kind)
    if cfg.use_post_norm:
        y = rms_norm(y, bp["post_norm"], cfg.norm_eps)
    # blocks may return per-op ModelReports (ffn); the stage carry takes
    # the scalar view (DetectEvidence in the deferred detect pass)
    return x + y.to(x.dtype), as_fault_report(rep), new_cache, aux


def _apply_blocks(pattern, blocks, x, cfg, abft, positions, caches=None,
                  cache_pos=None):
    rep = clean_report(ambient_mode())
    aux = torch.zeros((), dtype=F32, device=x.device)
    new_caches = {} if caches is not None else None
    for i, kind in enumerate(pattern):
        name = f"b{i}_{kind}"
        c = caches.get(name) if caches is not None else None
        c = c if c else None  # {} -> None (stateless block)
        with path_scope(name):
            x, r, nc, a = _apply_block(kind, blocks[name], x, cfg, abft,
                                       positions, c, cache_pos)
        rep = merge_verdicts(rep, r)
        aux = aux + a
        if caches is not None:
            new_caches[name] = nc if nc is not None else {}
    return x, rep, new_caches, aux


def _own_caches(caches, cfg):
    """The forward's own copy of the caches, which its blocks update in
    place. An ssm or rec block's conv tail takes the type that its
    concatenation with the block's input gives (as the JAX package's
    does): a float32 model's tail, made bfloat16, comes back float32."""
    dt = _dtype(cfg)

    def leaf(name, key, t):
        if name.endswith(("_ssm", "_rec")) and key == "conv":
            return t.to(torch.promote_types(t.dtype, dt), copy=True)
        return t.clone()

    return {sec: {name: {k: leaf(name, k, t) for k, t in blk.items()}
                  for name, blk in blocks.items()}
            for sec, blocks in caches.items()}


# -- stage plan plumbing ----------------------------------------------------

def _stage_wck_xs() -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Offline checksums of the stacked stages, keyed by entry path, with
    their leading repeats axis intact; the stage loop hands each repeat
    its slice."""
    plan = ambient_plan()
    if plan is None:
        return {}
    return {name: (e.wck.cw1, e.wck.cw2)
            for name, e in plan.entries.items()
            if name.startswith("stages/") and e.stack and e.wck is not None}


def _stage_overrides(wcks: Dict[str, Tuple[torch.Tensor, torch.Tensor]]):
    """entry_overrides mapping for one repeat: each stacked stage entry
    swapped for a per-repeat view carrying that repeat's checksum slice."""
    plan = ambient_plan()
    if plan is None or not wcks:
        return entry_overrides({})
    ov = {}
    for name, (cw1, cw2) in wcks.items():
        e = plan.entries[name]
        ov[name] = dataclasses.replace(
            e, wck=WeightChecksums(cw1, cw2, e.wck.col_chunk),
            w_shape=None if e.w_shape is None else e.w_shape[e.stack:],
            stack=0)
    return entry_overrides(ov)


def _rematerialised(stage_fn, *args):
    """stage_fn(*args) with its activations recomputed in the backward
    (torch.utils.checkpoint, the JAX package's jax.checkpoint of a stage
    repeat). The recompute runs after the forward's scopes have exited,
    so it re-enters what the forward saw (core.plan.replay_scope): the
    same plan entries and overrides, the same fault hooks - a fault fires
    and is corrected again - its host reads counted as a recompute's. Its
    reports are dropped: the step reports what the forward saw."""
    captured = capture_scope()
    return checkpoint(stage_fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          replay_scope(captured)))


def _forward(params, tokens, cfg, *, caches=None, cache_pos=None,
             positions=None, remat=False):
    """Shared trunk. tokens: (B, S), or (B, S, K) for multi-codebook
    archs (logits (B, S, K, V)). Returns (logits, sectioned
    ModelReport, aux, new_caches); aux is the moe blocks' load-balancing
    loss summed through the prefix, the stages and the remainder (0
    without moe blocks). Report keys: "prefix" /
    "stages" (every repeat merged into one carry) / "rem", plus the LM
    head under its plan path ("embed/head" or "embed/table"), so the
    deferred corrective rerun trusts the head's carried flag while stage
    sites re-derive theirs.
    The caches are copied once and updated in place in the copy, so the
    caller's caches are left as they were (the JAX package's functional
    semantics): a deferred corrective rerun starts from the step's input
    state, the ssm's and the rec's recurrences included.
    `remat` rematerialises each stage repeat on the uncached path under
    autograd (_rematerialised), as the JAX package's forward_train does."""
    abft = abft_config(cfg)
    mode = ambient_mode()
    pattern, reps, rem = cfg.stages()
    b, s = tokens.shape[:2]
    x = embed(params["embed"], tokens, cfg)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None, :]   # (1, S)
    if caches is not None:
        caches = _own_caches(caches, cfg)

    sections: Dict[str, Any] = {}
    aux = torch.zeros((), dtype=F32, device=x.device)
    if cfg.prefix_pattern:
        pc = caches.get("prefix") if caches is not None else None
        with path_scope("prefix"):
            x, sections["prefix"], _, a = _apply_blocks(
                cfg.prefix_pattern, params["prefix"], x, cfg, abft,
                positions, pc, cache_pos)
        aux = aux + a

    if reps:
        stage_wck = _stage_wck_xs()
        remat = remat and caches is None and torch.is_grad_enabled()

        def stage_once(x, r_i):
            sp = tree_map(lambda t: t[r_i], params["stages"])
            wcks = {n: (c1[r_i], c2[r_i]) for n, (c1, c2) in stage_wck.items()}
            sc = None if caches is None else \
                tree_map(lambda t: t[r_i], caches["stages"])
            with path_scope("stages"), _stage_overrides(wcks), \
                    repeat_scope(r_i):
                x, r, _, a = _apply_blocks(pattern, sp, x, cfg, abft,
                                           positions, sc, cache_pos)
            return x, r, a

        srep = clean_report(mode)
        for r_i in range(reps):
            x, r, a = (_rematerialised(stage_once, x, r_i) if remat
                       else stage_once(x, r_i))
            srep, aux = merge_verdicts(srep, r), aux + a
        sections["stages"] = srep

    if rem:
        rc = caches.get("rem") if caches is not None else None
        with path_scope("rem"):
            x, sections["rem"], _, a = _apply_blocks(
                rem, params["rem"], x, cfg, abft, positions, rc, cache_pos)
        aux = aux + a

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits, r = logits_head(params["embed"], x, cfg, abft)
    head_key = "embed/table" if cfg.tie_embeddings else "embed/head"
    sections[head_key] = as_fault_report(r)
    if cfg.logit_softcap:
        logits = softcap(logits, cfg.logit_softcap)
    return logits, ModelReport(sections), aux, caches


def _positions(position, device):
    """(positions rows, cache write position) of a decode step: an int is
    the synchronized batch's one position, a (B,) tensor one per slot."""
    if isinstance(position, torch.Tensor) and position.dim() == 1:
        position = position.to(device)
        return position[:, None], position
    p = int(position)
    return torch.full((1, 1), p, dtype=torch.int64, device=device), p


def prefill(params, tokens, cfg, max_len: int):
    """Fill caches for `tokens` (B, S) or (B, S, K); returns
    (last-position logits, report, caches), the cache buffers sized to
    max_len."""
    with torch.no_grad(), fp32_ieee():
        caches = init_caches(cfg, tokens.shape[0], max_len, tokens.device)
        logits, rep, _, caches = _forward(params, tokens, cfg,
                                          caches=caches, cache_pos=0)
    return logits[:, -1:], as_fault_report(rep), caches


def decode_step(params, tokens, caches, position, cfg):
    """One decode step. tokens: (B, 1) or (B, 1, K); position: an int
    (synchronized batch) or a (B,) tensor (per-slot continuous batching)
    write position. Returns (logits (B, 1, V) or (B, 1, K, V), report,
    caches)."""
    with torch.no_grad(), fp32_ieee():
        positions, cp = _positions(position, tokens.device)
        logits, rep, _, caches = _forward(params, tokens, cfg,
                                          caches=caches, cache_pos=cp,
                                          positions=positions)
    return logits, as_fault_report(rep), caches


def forward_train(params, tokens, cfg):
    """tokens: (B, S) or (B, S, K) -> (logits (B, S, V) or (B, S, K, V)
    fp32, FaultReport, aux), with autograd through every op (the caller
    takes the gradients). The report keeps the scalar FaultReport
    contract (step runners and the microbatch loop merge it); use
    `train_apply` + core.ProtectedModel for the sectioned / deferred
    workflow. aux is the moe blocks' load-balancing loss (0 without
    them). With `cfg.remat` each stage repeat keeps only its input for
    the backward, which recomputes the repeat (the JAX package's
    jax.checkpoint of the stage); the gradients are bitwise those without
    it."""
    with fp32_ieee():
        logits, rep, aux, _ = _forward(params, tokens, cfg, remat=cfg.remat)
    return logits, as_fault_report(rep), aux


# --------------------------------------------------------------------------
# ProtectedModel apply_fns (the model-agnostic protection surface)
# --------------------------------------------------------------------------

def train_apply(cfg):
    """apply_fn for core.ProtectedModel: the full-sequence forward.

        pm = ProtectedModel(train_apply(cfg), plan)   # plan: build_plan
        (logits, aux), report = pm(params, tokens)
        (logits, aux), report = pm(params, tokens, correction="deferred")

    The deferred mode runs the whole forward detect-only and reruns it
    with full correction only when something flagged (one host read)."""
    def apply_fn(params, tokens):
        logits, rep, aux, _ = _forward(params, tokens, cfg)
        return (logits, aux), rep
    return apply_fn


def prefill_apply(cfg, max_len: int, last: Optional[int] = None):
    """apply_fn for core.ProtectedModel: prefill, returning the caches in
    its output so the deferred rerun redoes the cache writes too. `last`
    indexes the final real prompt row of a trailing-padded prompt
    (default: the last column)."""
    def apply_fn(params, tokens):
        caches = init_caches(cfg, tokens.shape[0], max_len, tokens.device)
        logits, rep, _, caches = _forward(params, tokens, cfg,
                                          caches=caches, cache_pos=0)
        i = tokens.shape[1] - 1 if last is None else last
        return (logits[:, i:i + 1], caches), rep
    return apply_fn


def prefill_apply_at(cfg, max_len: int):
    """apply_fn for core.ProtectedModel: prefill with the last real row
    as an argument - (params, tokens, last). One function serves every
    prompt padded into a bucket: the padded cache rows are overwritten in
    order by later decode writes before any query can attend them."""
    def apply_fn(params, tokens, last):
        caches = init_caches(cfg, tokens.shape[0], max_len, tokens.device)
        logits, rep, _, caches = _forward(params, tokens, cfg,
                                          caches=caches, cache_pos=0)
        li = int(last)
        return (logits[:, li:li + 1], caches), rep
    return apply_fn


def decode_apply(cfg):
    """apply_fn for core.ProtectedModel: one decode step -
    (params, tokens, caches, position), position as in decode_step."""
    def apply_fn(params, tokens, caches, position):
        positions, cp = _positions(position, tokens.device)
        logits, rep, _, caches = _forward(params, tokens, cfg,
                                          caches=caches, cache_pos=cp,
                                          positions=positions)
        return (logits, caches), rep
    return apply_fn


# --------------------------------------------------------------------------
# parameter accounting
# --------------------------------------------------------------------------

def _block_params(kind: str, cfg, active_only=False) -> int:
    d, hd = cfg.d_model, cfg.head_dim
    if kind in ATTN_KINDS:
        return d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2
    if kind == "ffn":
        return 3 * d * cfg.d_ff
    if kind == "moe":
        ff = cfg.moe_d_ff or cfg.d_ff
        e = cfg.top_k if active_only else cfg.num_experts
        n = d * cfg.num_experts + e * 3 * d * ff
        if cfg.n_shared_experts:
            n += 3 * d * ff * cfg.n_shared_experts
        return n
    if kind == "ssm":
        di = cfg.ssm_expand * d
        h = di // cfg.ssm_head_dim
        n = cfg.ssm_state
        return d * (2 * di + 2 * n + h) + cfg.conv_kernel * (di + 2 * n) \
            + di * d + di
    if kind == "rec":
        w = cfg.lru_width or d
        return 2 * d * w + 2 * w * w + cfg.conv_kernel * w + w * d
    raise ValueError(kind)


def count_params(cfg, active_only: bool = False) -> int:
    pattern, reps, rem = cfg.stages()
    n = max(cfg.num_codebooks, 1) * cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        n *= 2
    for kind in cfg.prefix_pattern:
        n += _block_params(kind, cfg, active_only)
    for kind in pattern:
        n += reps * _block_params(kind, cfg, active_only)
    for kind in rem:
        n += _block_params(kind, cfg, active_only)
    return n
