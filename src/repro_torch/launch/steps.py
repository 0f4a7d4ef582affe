"""Step functions (train / prefill / serve) shared by the drivers and the
tests (twin of repro.launch.steps).

train_step supports microbatch gradient accumulation - the
activation-memory knob - and emits the merged FaultReport so the FT
runtime can apply verdict-driven retry. It is functional: the state it is
given is left as it was, so a step can be recomputed from it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .._device import DeviceLike, fp32_ieee
from .._tree import tree_leaves, tree_map, tree_unflatten
from ..configs.base import ModelConfig
from ..core import FaultReport
from ..models import transformer as M
from ..optim import (OptConfig, apply_updates, clip_by_global_norm,
                     cosine_schedule, init_opt_state)

F32 = torch.float32


def _no_mesh(mesh_axes) -> None:
    if mesh_axes is not None:
        raise NotImplementedError(
            "sharded training (mesh_axes) is not ported yet (ROADMAP item "
            "1.12)")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mesh_axes: Optional[Tuple] = None) -> torch.Tensor:
    """Mean NLL in fp32 (logsumexp minus the target logit); multi-codebook
    labels average over codebooks."""
    _no_mesh(mesh_axes)
    l32 = logits.to(F32)
    lse = torch.logsumexp(l32, dim=-1)
    tgt = torch.gather(l32, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - tgt)


def init_train_state(generator: Optional[torch.Generator], cfg: ModelConfig,
                     opt_cfg: OptConfig, device: DeviceLike = None) -> Dict:
    """Random params of `cfg` (models.transformer.init_params: drawn from
    the CPU `generator`, seed 0 when None) on `device`, the optimizer's
    zero state and step 0."""
    params = M.init_params(cfg, generator, device)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"params": params, "opt": init_opt_state(params, opt_cfg),
            "step": step}


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    microbatches: int = 1,
                    mesh_axes: Optional[Tuple] = None,
                    total_steps: int = 10000, warmup: int = 100,
                    grad_dtype=None):
    """Returns train_step(state, batch) -> (state, metrics), metrics
    {"loss", "gnorm", "lr", "report"} on the params' device.

    grad_dtype: dtype of the microbatch gradient accumulator (default
    fp32; bf16 halves the accumulator memory). The forward and the
    backward both run inside fp32_ieee(): cuBLAS picks a backward GEMM's
    precision when it runs, so a backward outside the scope would take
    TF32 products. Gradients are taken with torch.autograd.grad over
    fresh leaves that share the params' storage, so no `.grad` is left on
    the caller's tensors."""
    _no_mesh(mesh_axes)
    lr_fn = cosine_schedule(opt_cfg.lr, warmup, total_steps)
    acc_dtype = F32 if not grad_dtype else (
        getattr(torch, grad_dtype) if isinstance(grad_dtype, str)
        else grad_dtype)

    def loss_fn(params, tokens, labels):
        logits, rep, aux = M.forward_train(params, tokens, cfg)
        loss = cross_entropy(logits, labels)
        if cfg.num_experts:
            loss = loss + 0.01 * aux
        return loss, rep

    def one_micro(params, tokens, labels):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, rep = loss_fn(tree_unflatten(params, leaves), tokens,
                                labels)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach gets a zero gradient, as jax.grad's
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), rep, tree_unflatten(params, grads)

    def train_step(state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        params = state["params"]
        with torch.no_grad(), fp32_ieee():
            if microbatches > 1:
                b = tokens.shape[0]
                mb = b // microbatches
                loss = torch.zeros((), dtype=F32, device=tokens.device)
                rep = FaultReport.clean()
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=acc_dtype, device=p.device), params)
                for i in range(microbatches):
                    sl = slice(i * mb, (i + 1) * mb)
                    l_i, r_i, g_i = one_micro(params, tokens[sl],
                                              labels[sl])
                    grads = tree_map(lambda a, g: a + g.to(acc_dtype),
                                     grads, g_i)
                    loss, rep = loss + l_i, FaultReport.merge(rep, r_i)
                loss = loss / microbatches
                grads = tree_map(lambda g: g / microbatches, grads)
            else:
                loss, rep, grads = one_micro(params, tokens, labels)

            grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
            lr = lr_fn(state["step"])
            new_params, new_opt = apply_updates(params, grads, state["opt"],
                                                opt_cfg, lr)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": loss, "gnorm": gnorm, "lr": lr, "report": rep}
        return new_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch):
        logits, rep, caches = M.prefill(params, batch["tokens"], cfg, max_len)
        return {"logits": logits, "report": rep, "caches": caches}
    return prefill_step


def make_serve_step(cfg: ModelConfig, greedy: bool = True):
    """One decode step: returns sampled tokens, updated caches, report."""
    def serve_step(params, batch):
        logits, rep, caches = M.decode_step(
            params, batch["tokens"], batch["caches"], batch["positions"], cfg)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return {"next_tokens": nxt, "logits": logits, "report": rep,
                "caches": caches,
                "positions": batch["positions"] + 1}
    return serve_step
