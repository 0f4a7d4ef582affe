"""Token embeddings and LM heads (twin of repro.layers.embedding).

The lookup is a gather (no weight-stationary invariant); the LM head GEMM
is protected through protect_site: the plan entry at "embed/head" (untied)
or "embed/table" (tied, through the plan's "tied_head" weight view, whose
GEMM weight is the transposed embedding table, read in place).
Multi-codebook I/O is not ported yet (ROADMAP item 1.7)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core import (FaultReport, ProtectConfig, ambient_mode, path_scope,
                    protect_site, resolve_entry)
from ..core.protected import matmul_raw
from .linear import apply_dense, init_dense

F32 = torch.float32


def _no_codebooks(cfg) -> None:
    if cfg.num_codebooks:
        raise NotImplementedError(
            "multi-codebook embeddings are not ported yet (ROADMAP item "
            "1.7)")


def init_embedding(generator: torch.Generator, cfg, dtype=torch.bfloat16,
                   device=None) -> Dict:
    _no_codebooks(cfg)
    v, d = cfg.vocab_size, cfg.d_model
    table = torch.randn((1, v, d), generator=generator, dtype=F32) * d ** -0.5
    p = {"table": table.to(device=device, dtype=dtype)}
    if not cfg.tie_embeddings:
        p["head"] = init_dense(generator, d, v, dtype=dtype, device=device)
    return p


def embed(params: Dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens: (B, S) -> (B, S, d)."""
    _no_codebooks(cfg)
    return params["table"][0][tokens]


def logits_head(params: Dict, x: torch.Tensor, cfg,
                abft: ProtectConfig = None
                ) -> Tuple[torch.Tensor, FaultReport]:
    """x: (B, S, d) -> fp32 logits (B, S, V)."""
    _no_codebooks(cfg)
    b, s, d = x.shape
    v = cfg.vocab_size
    with path_scope("embed"):
        if cfg.tie_embeddings:
            w = params["table"].reshape(v, d).T            # (d, V), a view
            entry = resolve_entry("table")
            if (entry is not None or ambient_mode() is not None
                    or (abft is not None and abft.enabled)):
                y, rep = protect_site("table", (x, w), entry=entry,
                                      cfg=abft)
            else:
                y = matmul_raw(x.reshape(-1, d), w.to(x.dtype))
                rep = FaultReport.clean()
        else:
            y, rep = apply_dense(params["head"], x, abft, name="head")
    return y.to(F32).reshape(b, s, v), rep
