"""Model configuration schema (twin of repro.configs.base).

A model is a stack of *stages*; each stage is a short tuple of block kinds
that repeats (stacked params with a leading repeats axis; the forward
loops over the repeats). Heterogeneous archs express their per-layer
pattern here:

    gemma2          ("attn_local", "ffn", "attn_global", "ffn") x 21
    recurrentgemma  ("rec", "ffn", "rec", "ffn", "attn_swa", "ffn") x 8 (+rem)
    llama4          ("attn_chunk", "ffn", "attn_full", "moe") x 12 ...

Block kinds: attn_full, attn_swa (sliding window), attn_local /
attn_global (gemma2 alternation), attn_chunk (llama4 iRoPE), ffn (dense
GLU), moe, ssm (mamba2 SSD), rec (RG-LRU).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # stage structure: prefix blocks, then pattern repeated `repeats` times,
    # then remainder blocks (prefix: e.g. kimi-k2's dense first layer)
    stage_pattern: Tuple[str, ...] = ("attn_full", "ffn")
    stage_repeats: int = 0            # 0 -> derived from num_layers
    remainder_pattern: Tuple[str, ...] = ()
    prefix_pattern: Tuple[str, ...] = ()
    use_post_norm: bool = False       # gemma2 sandwich norms
    embed_scale: bool = False         # gemma-family sqrt(d) embed scaling

    # attention details
    window_size: int = 4096           # for attn_swa / attn_local
    attn_chunk: int = 8192            # for attn_chunk (llama4 iRoPE)
    attn_softcap: float = 0.0         # gemma2 attn logit softcapping
    logit_softcap: float = 0.0        # gemma2 final logit softcapping
    qk_norm: bool = False             # chameleon-style qk layernorm
    rope_theta: float = 10000.0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_kernel: int = 4

    # RG-LRU (recurrentgemma)
    lru_width: int = 0

    # audio (musicgen)
    num_codebooks: int = 0

    # misc
    act: str = "silu"                 # silu|gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ABFT + memory policy
    abft: bool = True
    abft_detect_only: bool = False    # paper's CoC-D-only hot path
    abft_row_chunk: int = 1024
    abft_col_chunk: int = 1024
    # kept field for field so configs compare across the packages; an
    # eager forward neither rematerialises nor scans, so neither has an
    # effect here, in training too (forward_train's backward keeps the
    # forward's activations)
    remat: bool = True
    scan_stages: bool = True

    # -------------------------------------------------------------- helpers
    def layers_per_stage(self) -> int:
        """Number of model 'layers' one stage consumes. A 'layer' is one
        mixer (attn/ssm/rec); ffn/moe blocks ride along with the preceding
        mixer (llama convention: layer = attn + ffn/moe)."""
        mixers = sum(1 for b in self.stage_pattern
                     if not (b.startswith("ffn") or b == "moe"))
        return max(mixers, 1)

    def stages(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        if self.stage_repeats:
            return self.stage_pattern, self.stage_repeats, self.remainder_pattern
        lps = self.layers_per_stage()
        prefix_mixers = sum(1 for b in self.prefix_pattern
                            if not b.startswith("ffn") and b != "moe")
        reps = (self.num_layers - prefix_mixers) // lps
        rem_layers = self.num_layers - prefix_mixers - reps * lps
        rem: Tuple[str, ...] = ()
        if rem_layers:
            # remainder reuses the head of the pattern
            taken, out = 0, []
            for b in self.stage_pattern:
                if taken >= rem_layers and not b.startswith("ffn"):
                    break
                out.append(b)
                if not b.startswith("ffn") and b != "moe_ffn":
                    taken += 1
            rem = tuple(out)
        return self.stage_pattern, reps, rem

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def param_count(self) -> int:
        """Total parameters (for 6ND model-FLOPs accounting)."""
        from ..models.transformer import count_params  # lazy
        return count_params(self)

    def active_param_count(self) -> int:
        from ..models.transformer import count_params
        return count_params(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
