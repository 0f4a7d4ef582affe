"""ABFT-protected dense layer (twin of repro.layers.linear): every weight
GEMM of the transformer routes through here.

Call sites name themselves (`apply_dense(..., name="wq")`) inside the
layer's `path_scope`: under an ambient plan context (a ProtectedModel run)
the PlanEntry at the joined param-tree path supplies the offline config
and precomputed weight checksums, and the ambient execution mode
(detect_only / correct) decides what the call returns.

Under a mesh (runtime.sharding.parallel_scope) the weight is this rank's
shard, and the leaf's spec, found by the same path, says which collective
the product needs: a column-sharded weight (output axis over 'model')
leaves its output sharded, and its input enters through Megatron's f (the
gradient summed over 'model' in the backward); a row-sharded one
(contraction axis over 'model') protects this rank's partial product and
sums the partials over 'model' in fp32, rounded once (Megatron's g). A
replicated weight needs neither. An input that runtime.sharding
.gather_from_model made (`gathered=True`) enters a column-sharded weight
without f: the gather's backward sums its gradient already."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import (DEFAULT_CONFIG, FaultReport, ProtectConfig, ambient_mode,
                    protect_site, protected_matmul, resolve_entry)
from ..core.plan import current_path
from ..core.protected import matmul_raw
from ..runtime.sharding import (copy_to_model, current_parallel, is_sharded,
                                reduce_from_model)

F32 = torch.float32


def init_dense(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.bfloat16,
               scale: Optional[float] = None, device=None):
    """Normal(0, scale) weights (scale d_in^-0.5 by default), drawn in fp32
    from `generator` on its device (the CPU for a CPU generator) and
    cast, then moved to `device`."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator, dtype=F32,
                    device=generator.device) * scale
    p = {"w": w.to(device=device, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def apply_dense(params, x: torch.Tensor,
                cfg: Optional[ProtectConfig] = DEFAULT_CONFIG,
                wck=None, entry=None, name: str = "w",
                gathered: bool = False
                ) -> Tuple[torch.Tensor, FaultReport]:
    """y = x @ W (+ b), protected when cfg.enabled. x: (..., d_in).

    Resolution order: explicit `entry`, then the ambient plan context's
    entry at the current path + `name`, then the per-call cfg/wck path.
    Under an ambient "detect_only" mode the second return is a
    DetectEvidence carry instead of a FaultReport."""
    par = current_parallel()
    spec = par.spec(current_path(name) + "/w") if par is not None else ()
    if par is not None and par.tp > 1 and spec:
        w, b = params["w"], params.get("b")
        if is_sharded(spec[-1:]) and not gathered:
            x = copy_to_model(x, par.mesh)
        if is_sharded(spec[:1]):
            # the bias joins the sum once, on the first model rank
            local = {"w": w} if (b is None or par.mesh.index("model")) \
                else params
            y, rep = _apply_local(local, x, cfg, wck, entry, name)
            return reduce_from_model(y, par.mesh), rep
    return _apply_local(params, x, cfg, wck, entry, name)


def _apply_local(params, x, cfg, wck, entry, name):
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
