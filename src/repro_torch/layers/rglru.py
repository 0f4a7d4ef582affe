"""RG-LRU recurrent block (twin of repro.layers.rglru: Griffin /
RecurrentGemma).

Recurrence: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), with
a_t = exp(-c * softplus(Lambda) * r_t), r_t and i_t input-dependent gates.
Training and prefill run the recurrence as a log-depth doubling scan over
the sequence (the JAX package's `lax.associative_scan`: ceil(log2 S)
steps of multiplies and adds on shifted slices, not S steps); decode is
the one-step update. The five projections go through apply_dense, so
they are protected plan sites ("rec/in_x", "rec/in_gate", "rec/gate_a",
"rec/gate_i", "rec/out"); the elementwise, data-dependent recurrence has
no weight-stationary checksum invariant and is not protected, as in the
JAX package.

Types are the reference's: `lam` is a float32 parameter in any model,
the gates and the recurrence run in float32, the depthwise conv in the
type its concatenation gives (as the ssm block's). The recurrent state is
{"h": (B, W) float32, "conv": (B, K-1, W) bfloat16} as made; the block
returns a new state and leaves the one it was given as it was.

Under a mesh (runtime.sharding.parallel_scope) the JAX package's rules
shard the lru width over 'model' in Megatron's column/row pattern: in_x
and in_gate give this rank's columns, the depthwise conv runs on them
with this rank's conv tail (B, K-1, W/tp), gate_a and gate_i take the
whole conv output through one gather_from_model and give local columns,
`lam` and the state h are local, and `out` is row-parallel (its partials
summed over 'model' by layers.linear).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core import FaultReport, ProtectConfig, merge_verdicts
from ..core.plan import current_path
from ..runtime.sharding import current_parallel, gather_from_model, is_sharded
from .linear import apply_dense, init_dense
from .norms import activate
from .ssm import _causal_conv

F32 = torch.float32
_C = 8.0  # Griffin's fixed temperature


def init_rglru(generator: torch.Generator, cfg, dtype=torch.bfloat16,
               device=None) -> Dict:
    """Random block params, drawn in fp32 from `generator` on its device;
    `lam` is deterministic and stays float32."""
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    in_x = init_dense(generator, d, w, dtype=dtype, device=device)
    in_gate = init_dense(generator, d, w, dtype=dtype, device=device)
    conv_w = (torch.randn((cfg.conv_kernel, w), generator=generator,
                          dtype=F32, device=generator.device)
              * cfg.conv_kernel ** -0.5)
    # Lambda init so a^c in [0.9, 0.999] (Griffin §2.4)
    a = torch.linspace(0.9, 0.999, w, dtype=F32)
    lam = torch.log(torch.expm1(-torch.log(a) / _C))
    return {
        "in_x": in_x,
        "in_gate": in_gate,
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "lam": lam.to(device),
        "gate_a": init_dense(generator, w, w, dtype=dtype, device=device),
        "gate_i": init_dense(generator, w, w, dtype=dtype, device=device),
        "out": init_dense(generator, w, d, dtype=dtype, scale=w ** -0.5,
                          device=device),
    }


def _scan_recurrence(a: torch.Tensor, bx: torch.Tensor,
                     h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bx_t over axis 1, h0 folded into step 0.
    A doubling scan: after the step of shift d every position holds the
    composition of the (up to) 2d steps ending there."""
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0.to(F32)[:, None],
                        bx[:, 1:]], dim=1)
    s, d = bx.shape[1], 1
    while d < s:
        bx = torch.cat([bx[:, :d], a[:, d:] * bx[:, :-d] + bx[:, d:]], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return bx


def apply_rglru(params: Dict, x: torch.Tensor, cfg,
                abft: Optional[ProtectConfig],
                state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, FaultReport, Optional[Dict]]:
    """state = {"h": (B, W), "conv": (B, K-1, W)} for prefill and decode;
    None for the uncached forward (training, teacher forcing). Returns
    (out, report, new_state); new_state is None without a state."""
    s = x.shape[1]
    xb, r1 = apply_dense(params["in_x"], x, abft, name="in_x")
    gb, r2 = apply_dense(params["in_gate"], x, abft, name="in_gate")
    rep = merge_verdicts(r1, r2)

    tail = state["conv"] if state is not None else None
    xc, new_tail = _causal_conv(xb, params["conv_w"], tail)

    # under a mesh that shards the width, the gates see the whole conv
    # output and give this rank's columns
    par = current_parallel()
    tp = (par is not None and par.tp > 1
          and is_sharded(par.spec(current_path("lam"))))
    xg = gather_from_model(xc, par.mesh) if tp else xc
    ra, r3 = apply_dense(params["gate_a"], xg, abft, name="gate_a",
                         gathered=tp)
    ri, r4 = apply_dense(params["gate_i"], xg, abft, name="gate_i",
                         gathered=tp)
    rep = merge_verdicts(merge_verdicts(rep, r3), r4)

    r_t = torch.sigmoid(ra.to(F32))
    i_t = torch.sigmoid(ri.to(F32))
    log_a = (-_C * torch.nn.functional.softplus(params["lam"])[None, None, :]
             * r_t)
    a_t = torch.exp(log_a)
    gated = i_t * xc.to(F32)
    # jnp.maximum's spelling: its gradient at the floor splits as the
    # reference's does
    bx = torch.sqrt(torch.maximum(1.0 - torch.exp(2.0 * log_a),
                                  log_a.new_tensor(1e-12))) * gated

    if state is None or s > 1:
        h = _scan_recurrence(a_t, bx, None if state is None else state["h"])
    else:
        hprev = state["h"].to(F32)
        h = (a_t[:, 0] * hprev + bx[:, 0])[:, None]
    h_last = h[:, -1]

    y = h.to(x.dtype) * activate(gb, "gelu")
    out, r5 = apply_dense(params["out"], y, abft, name="out")
    rep = merge_verdicts(rep, r5)

    new_state = None
    if state is not None:
        new_state = {"h": h_last.to(state["h"].dtype), "conv": new_tail}
    return out, rep, new_state


def init_rglru_state(cfg, batch: int, device=None) -> Dict:
    """A zero state: h in float32 and the conv tail in bfloat16, whatever
    the model's type, as the JAX package's model makes it."""
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, w),
                                dtype=torch.bfloat16, device=device)}
