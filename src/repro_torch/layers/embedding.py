"""Token embeddings and LM heads (twin of repro.layers.embedding).

The lookup is a gather (no weight-stationary invariant); the LM head GEMM
is protected through protect_site: the plan entry at "embed/head" (untied)
or "embed/table" (tied, through the plan's "tied_head" weight view, whose
GEMM weight is the transposed embedding table, read in place).
MusicGen-style multi-codebook I/O: K embedding tables (K, V, d) summed on
input for (B, S, K) tokens, and one head GEMM of width K·V on output whose
logits come out as (B, S, K, V); the EnCodec frontend is a stub, as in the
JAX package (tokens arrive precomputed).

Under a mesh (runtime.sharding.parallel_scope) a (K, V, d) table under
(None, "model", None) holds this rank's slice of the vocabulary: the
lookup takes the tokens that fall in it, zeroes the rest and sums the
ranks' rows over 'model' (exact: one rank contributes each row), and the
head's logits stay vocab-sharded, (B, S, V / model)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core import (FaultReport, ProtectConfig, ambient_mode, path_scope,
                    protect_site, resolve_entry)
from ..core.protected import matmul_raw
from ..runtime.sharding import (copy_to_model, current_parallel,
                                reduce_from_model)
from .linear import apply_dense, init_dense

F32 = torch.float32


def init_embedding(generator: torch.Generator, cfg, dtype=torch.bfloat16,
                   device=None) -> Dict:
    """A (K, V, d) table (K = 1 without codebooks) and, untied, a head of
    d x K·V."""
    v, d = cfg.vocab_size, cfg.d_model
    nc = max(cfg.num_codebooks, 1)
    table = torch.randn((nc, v, d), generator=generator, dtype=F32,
                        device=generator.device) * d ** -0.5
    p = {"table": table.to(device=device, dtype=dtype)}
    if not cfg.tie_embeddings:
        p["head"] = init_dense(generator, d, nc * v, dtype=dtype,
                               device=device)
    return p


def embed(params: Dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens: (B, S), or (B, S, K) for multi-codebook archs -> (B, S, d),
    the sum of the K codebook embeddings."""
    table = params["table"]
    par = current_parallel()
    if par is not None and table.shape[1] != cfg.vocab_size:
        if cfg.num_codebooks:
            raise NotImplementedError(
                "multi-codebook embeddings under a mesh (ROADMAP item "
                "1.12)")
        v_loc = table.shape[1]
        local = tokens - par.mesh.index("model") * v_loc
        hit = (local >= 0) & (local < v_loc)
        rows = table[0][torch.where(hit, local, torch.zeros_like(local))]
        rows = rows * hit[..., None].to(rows.dtype)
        return reduce_from_model(rows, par.mesh)
    if cfg.num_codebooks:
        # table[k][tokens[..., k]] for every k at once: (B, S, K, d)
        cb = torch.arange(cfg.num_codebooks, device=tokens.device)
        return table[cb, tokens].sum(dim=2)
    return table[0][tokens]


def logits_head(params: Dict, x: torch.Tensor, cfg,
                abft: ProtectConfig = None
                ) -> Tuple[torch.Tensor, FaultReport]:
    """x: (B, S, d) -> fp32 logits (B, S, V), or (B, S, K, V)."""
    b, s, d = x.shape
    v = cfg.vocab_size
    nc = max(cfg.num_codebooks, 1)
    with path_scope("embed"):
        if cfg.tie_embeddings:
            table = params["table"]
            par = current_parallel()
            if par is not None and table.shape[1] != v:
                # vocab-sharded: a column-parallel head over this rank's
                # rows of the table
                x = copy_to_model(x, par.mesh)
            w = table.reshape(-1, d).T                     # (d, K·V), a view
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
    y = y.to(F32)
    v = y.shape[-1] // nc                     # the local vocabulary
    if cfg.num_codebooks:
        return y.reshape(b, s, nc, v), rep
    return y.reshape(b, s, v), rep
