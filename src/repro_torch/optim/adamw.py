"""Functional optimizers (twin of repro.optim.adamw): AdamW with
dtype-configurable states, and Adafactor (factored second moment).

Every function returns new trees and never writes into its arguments: the
step runner recomputes a failed step from the same state
(runtime/ft.py::StepRunner), which an in-place optimizer would have
already changed. Trees are nested dicts of tensors (`repro_torch._tree`);
the step counters are 0-d int32 tensors on the params' device, so a step
reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from .._tree import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # float32 | bfloat16
    # adafactor
    factored_min: int = 128        # factor 2D dims >= this


def _sdt(cfg):
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else F32


def _device(tree):
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    dt = _sdt(cfg)
    step = torch.zeros((), dtype=torch.int32, device=_device(params))
    if cfg.kind == "adamw":
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        return {"step": step, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}
    if cfg.kind == "adafactor":
        def vshape(p):
            z = lambda shape: torch.zeros(shape, dtype=dt, device=p.device)
            if p.dim() >= 2 and p.shape[-1] >= cfg.factored_min \
                    and p.shape[-2] >= cfg.factored_min:
                return {"r": z(p.shape[:-1]),
                        "c": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"step": step, "v": tree_map(vshape, params)}
    raise ValueError(cfg.kind)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g.to(F32) * scale, grads), gn


def apply_updates(params, grads, state, cfg: OptConfig, lr
                  ) -> Tuple[Any, Dict[str, Any]]:
    """One optimizer step; grads in fp32 (post-clip). `lr` is a float or
    a 0-d tensor (cosine_schedule's)."""
    step = state["step"] + 1
    if cfg.kind == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1.0 - b1 ** step.to(F32)
        bc2 = 1.0 - b2 ** step.to(F32)

        def upd(p, g, m, v):
            g = g.to(F32)
            m32 = b1 * m.to(F32) + (1 - b1) * g
            v32 = b2 * v.to(F32) + (1 - b2) * g * g
            u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            u = u + cfg.weight_decay * p.to(F32)
            newp = p.to(F32) - lr * u
            return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

        out = tree_map(upd, params, grads, state["m"], state["v"])
        pick = lambda i: tree_map(lambda _, t: t[i], params, out)
        return pick(0), {"step": step, "m": pick(1), "v": pick(2)}

    # adafactor (beta1=0 variant)
    d2 = 1.0 - 1.0 / step.to(F32) ** 0.8     # beta2 schedule

    def upd(p, g, v):
        # the reference's arithmetic, op for op; the full-size fp32
        # temporaries are dropped or reused as soon as they are spent (an
        # expert stack of Kimi-K2's is 3.8 GB in fp32 per temporary)
        g32 = g.to(F32)
        g2 = g32 * g32
        g2.add_(1e-30)
        if "r" in v:
            r = d2 * v["r"].to(F32) + (1 - d2) * torch.mean(g2, dim=-1)
            c = d2 * v["c"].to(F32) + (1 - d2) * torch.mean(g2, dim=-2)
            del g2
            u = r[..., None] * c[..., None, :]
            u.div_(torch.mean(r, dim=-1, keepdim=True)[..., None] + 1e-30)
            u.sqrt_().add_(1e-30)
            torch.div(g32, u, out=u)
            newv = {"r": r.to(v["r"].dtype), "c": c.to(v["c"].dtype)}
        else:
            vv = d2 * v["v"].to(F32) + (1 - d2) * g2
            del g2
            u = g32 / (torch.sqrt(vv) + 1e-30)
            newv = {"v": vv.to(v["v"].dtype)}
        del g32
        # relative step-size clipping (Adafactor's d=1.0)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u.div_(torch.clamp(rms_u, min=1.0))
        p32 = p.to(F32)
        step_ = p32 * cfg.weight_decay
        step_.add_(u)
        del u
        step_.mul_(lr)
        newp = (p32 - step_).to(p.dtype)
        return newp, newv

    out = tree_map(upd, params, grads, state["v"])
    pick = lambda i: tree_map(lambda _, t: t[i], params, out)
    return pick(0), {"step": step, "v": pick(1)}


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        s = torch.as_tensor(step).to(F32)
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return lr
