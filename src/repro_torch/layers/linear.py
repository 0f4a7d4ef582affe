"""ABFT-protected dense layer (twin of repro.layers.linear): every weight
GEMM of the transformer routes through here.

Call sites name themselves (`apply_dense(..., name="wq")`) inside the
layer's `path_scope`: under an ambient plan context (a ProtectedModel run)
the PlanEntry at the joined param-tree path supplies the offline config
and precomputed weight checksums, and the ambient execution mode
(detect_only / correct) decides what the call returns."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import (DEFAULT_CONFIG, FaultReport, ProtectConfig, ambient_mode,
                    protect_site, protected_matmul, resolve_entry)
from ..core.protected import matmul_raw

F32 = torch.float32


def init_dense(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.bfloat16,
               scale: Optional[float] = None, device=None):
    """Normal(0, scale) weights (scale d_in^-0.5 by default), drawn in fp32
    on the CPU from `generator` and cast, then moved to `device`."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator, dtype=F32) * scale
    p = {"w": w.to(device=device, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def apply_dense(params, x: torch.Tensor,
                cfg: Optional[ProtectConfig] = DEFAULT_CONFIG,
                wck=None, entry=None, name: str = "w"
                ) -> Tuple[torch.Tensor, FaultReport]:
    """y = x @ W (+ b), protected when cfg.enabled. x: (..., d_in).

    Resolution order: explicit `entry`, then the ambient plan context's
    entry at the current path + `name`, then the per-call cfg/wck path.
    Under an ambient "detect_only" mode the second return is a
    DetectEvidence carry instead of a FaultReport."""
    w = params["w"]
    b = params.get("b")
    if entry is None:
        entry = resolve_entry(name)
    if entry is not None or ambient_mode() is not None:
        inputs = (x, w) if b is None else (x, w, b)
        y, rep = protect_site(name, inputs, entry=entry, cfg=cfg)
        return y.to(x.dtype), rep
    if cfg is None or not cfg.enabled:
        lead = x.shape[:-1]
        y = matmul_raw(x.reshape(-1, x.shape[-1]), w.to(x.dtype))
        y = y.reshape(*lead, w.shape[-1])
        if b is not None:
            y = y + b.to(y.dtype)
        return y, FaultReport.clean()
    y, rep = protected_matmul(x, w, wck=wck, bias=b, cfg=cfg)
    return y.to(x.dtype), rep
