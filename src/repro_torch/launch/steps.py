"""Step functions (train / prefill / serve) shared by the drivers and the
tests (twin of repro.launch.steps).

train_step supports microbatch gradient accumulation - the
activation-memory knob - and emits the merged FaultReport so the FT
runtime can apply verdict-driven retry. It is functional: the state it is
given is left as it was, so a step can be recomputed from it.

With `mesh_axes` = (data axes, model axis) the step runs on the ambient
mesh (runtime.sharding.parallel_scope, whose specs place the params):
the state is this rank's shards, each rank takes its data shard of every
microbatch, the loss and the gradients are averaged over the data axes,
the global norm sums the squares of sharded leaves over 'model' (each
replicated leaf counted once) and AdamW updates the local shards.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .._device import DeviceLike, fp32_ieee
from .._tree import (tree_flatten_with_path, tree_leaves, tree_map,
                     tree_unflatten)
from ..configs.base import ModelConfig
from ..core import FaultReport
from ..models import transformer as M
from ..runtime import sharding as SH
from ..optim import (OptConfig, apply_updates, clip_by_global_norm,
                     cosine_schedule, init_opt_state)

F32 = torch.float32


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mesh_axes: Optional[Tuple] = None) -> torch.Tensor:
    """Mean NLL in fp32 (logsumexp minus the target logit); multi-codebook
    labels average over codebooks.

    With `mesh_axes` the logits may be vocab-sharded over the model axis
    (the head's output under a mesh): the JAX package's iota == label
    form, with the max, the sum of exponentials and the target logit each
    reduced over 'model' (Megatron's vocab-parallel loss; the sums go
    through the g of runtime.sharding, so each rank back-propagates into
    its own slice). Off a mesh it is the same formula over one slice."""
    l32 = logits.to(F32)
    if mesh_axes is None:
        lse = torch.logsumexp(l32, dim=-1)
        tgt = torch.gather(l32, -1, labels[..., None].long())[..., 0]
        return torch.mean(lse - tgt)
    mesh = SH.current_mesh()
    v = l32.shape[-1]
    m = SH.axis_max(torch.amax(l32, dim=-1).detach(), mesh, "model")
    se = SH.reduce_from_model(torch.sum(torch.exp(l32 - m[..., None]),
                                        dim=-1), mesh)
    lse = m + torch.log(se)
    v0 = v * (mesh.index("model") if mesh is not None else 0)
    hit = (torch.arange(v, device=l32.device) + v0
           == labels[..., None].long())
    tgt = SH.reduce_from_model(
        torch.sum(torch.where(hit, l32, torch.zeros_like(l32)), dim=-1),
        mesh)
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
    the caller's tensors.

    `mesh_axes` = (data axes, model axis), e.g. ("data", "model"): the
    step runs on the ambient mesh (module docstring); the attention, ffn,
    ssm and rec blocks (not moe, whose expert d_ff is placed over 'data'),
    AdamW only."""
    if mesh_axes is not None:
        M.check_mesh_support(cfg)
        if opt_cfg.kind != "adamw":
            raise NotImplementedError(
                f"{opt_cfg.kind} under a mesh: its factored moments and "
                "update clipping reduce over sharded axes (ROADMAP item "
                "1.12)")
    lr_fn = cosine_schedule(opt_cfg.lr, warmup, total_steps)
    acc_dtype = F32 if not grad_dtype else (
        getattr(torch, grad_dtype) if isinstance(grad_dtype, str)
        else grad_dtype)

    def loss_fn(params, tokens, labels):
        logits, rep, aux = M.forward_train(params, tokens, cfg)
        loss = cross_entropy(logits, labels, mesh_axes)
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
        mesh = None
        if mesh_axes is not None:
            mesh = SH.current_mesh()
            if mesh is None:
                raise RuntimeError(
                    "make_train_step(mesh_axes=...): run the step inside "
                    "runtime.sharding.parallel_scope(mesh, specs)")
            tokens = _data_shard(tokens, mesh, microbatches)
            labels = _data_shard(labels, mesh, microbatches)
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
                    # in place: the step owns its accumulators, so one
                    # tree of them is held, not two
                    grads = tree_map(lambda a, g: a.add_(g.to(acc_dtype)),
                                     grads, g_i)
                    del g_i
                    loss, rep = loss + l_i, FaultReport.merge(rep, r_i)
                loss = loss / microbatches
                grads = tree_map(lambda g: g.div_(microbatches), grads)
            else:
                loss, rep, grads = one_micro(params, tokens, labels)

            if mesh is not None:
                n = SH.data_index(mesh)[1]
                loss = _data_sum(loss, mesh) / n
                grads = tree_map(lambda g: _data_mean(g, mesh, n), grads)
                rep = _world_report(rep, mesh)
                grads, gnorm = _clip_sharded(grads, opt_cfg.grad_clip,
                                             mesh)
            else:
                grads, gnorm = clip_by_global_norm(grads,
                                                   opt_cfg.grad_clip)
            lr = lr_fn(state["step"])
            new_params, new_opt = apply_updates(params, grads, state["opt"],
                                                opt_cfg, lr)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": loss, "gnorm": gnorm, "lr": lr, "report": rep}
        return new_state, metrics

    return train_step


def _data_sum(t, mesh):
    for a in SH.data_axes(mesh):
        t = SH.axis_sum(t, mesh, a)
    return t


def _data_mean(g, mesh, n: int):
    """A gradient summed over the data axes and divided by their ranks:
    in place for a contiguous fp32 one (the microbatch accumulator, which
    the step owns: no second copy of the tree is held), as _data_sum(g) /
    n otherwise; the same values either way."""
    if g.dtype != F32 or not g.is_contiguous():
        return _data_sum(g, mesh) / n
    for a in SH.data_axes(mesh):
        SH.axis_sum_(g, mesh, a)
    return g.div_(n)


def _data_shard(t, mesh, microbatches: int):
    """This rank's rows of each microbatch: microbatch i holds rows
    [i*mb, (i+1)*mb) of the batch, and its rows split into equal shards
    over the data axes, as the JAX package's (microbatch, batch over data)
    reshape lays them out."""
    idx, n = SH.data_index(mesh)
    if n == 1:
        return t
    b = t.shape[0]
    if b % (n * microbatches):
        raise ValueError(f"a batch of {b} does not split into "
                         f"{microbatches} microbatches over {n} data ranks")
    per = b // microbatches // n
    t = t.reshape(microbatches, n * per, *t.shape[1:])
    return t[:, idx * per:(idx + 1) * per].reshape(-1, *t.shape[2:])


def _world_report(rep: FaultReport, mesh) -> FaultReport:
    """The step's verdict as every rank sees it: each field's max over the
    world, so a verdict-driven retry is taken by all ranks or none."""
    f = torch.stack([torch.as_tensor(x, dtype=torch.int64).reshape(())
                     .to(mesh.device) for x in rep])
    return FaultReport(*SH.axis_max(f, mesh, "world").unbind())


def _clip_sharded(grads, max_norm: float, mesh):
    """clip_by_global_norm over a sharded tree: the squares of leaves
    sharded over 'model' are summed over it, a replicated leaf (the same
    on every model rank) is counted once."""
    par = SH.current_parallel()
    rep_sq = torch.zeros((), dtype=F32, device=mesh.device)
    sh_sq = torch.zeros((), dtype=F32, device=mesh.device)
    for path, g in tree_flatten_with_path(grads):
        sq = torch.sum(torch.square(g.to(F32)))
        if SH.is_sharded(par.specs.get(path, ())):
            sh_sq = sh_sq + sq
        else:
            rep_sq = rep_sq + sq
    gn = torch.sqrt(rep_sq + SH.axis_sum(sh_sq, mesh, "model"))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    # an fp32 gradient (the step's own) is scaled in place
    return tree_map(lambda g: g.mul_(scale) if g.dtype == F32
                    else g.to(F32) * scale, grads), gn


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
