"""The 10 architectures of the JAX package (twin of repro.configs.archs)
plus reduced smoke variants; see also the per-arch modules
(repro_torch/configs/<id>.py), which re-export these. The port runs
every block family (attention, dense FFN, moe, Mamba-2 ssm, RG-LRU rec)
and multi-codebook I/O, in serving and in training."""
from __future__ import annotations

from .base import ModelConfig


def chameleon_34b() -> ModelConfig:
    # [vlm] early-fusion: VQ image tokens share the 65536 vocab; frontend
    # stub = tokens arrive pre-quantised. QK-norm per the Chameleon paper.
    return ModelConfig(
        name="chameleon-34b", family="vlm", num_layers=48, d_model=8192,
        num_heads=64, num_kv_heads=8, head_dim=128, d_ff=22016,
        vocab_size=65536, stage_pattern=("attn_full", "ffn"), qk_norm=True)


def h2o_danube3_4b() -> ModelConfig:
    # [dense] llama+mistral mix with sliding-window attention.
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense", num_layers=24, d_model=3840,
        num_heads=32, num_kv_heads=8, head_dim=120, d_ff=10240,
        vocab_size=32000, stage_pattern=("attn_swa", "ffn"),
        window_size=4096, rope_theta=500000.0)


def yi_9b() -> ModelConfig:
    return ModelConfig(
        name="yi-9b", family="dense", num_layers=48, d_model=4096,
        num_heads=32, num_kv_heads=4, head_dim=128, d_ff=11008,
        vocab_size=64000, stage_pattern=("attn_full", "ffn"))


def smollm_360m() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense", num_layers=32, d_model=960,
        num_heads=15, num_kv_heads=5, head_dim=64, d_ff=2560,
        vocab_size=49152, stage_pattern=("attn_full", "ffn"),
        tie_embeddings=True)


def gemma2_9b() -> ModelConfig:
    # local/global alternating, softcaps, sandwich norms, tied embeddings.
    return ModelConfig(
        name="gemma2-9b", family="dense", num_layers=42, d_model=3584,
        num_heads=16, num_kv_heads=8, head_dim=256, d_ff=14336,
        vocab_size=256000,
        stage_pattern=("attn_local", "ffn", "attn_global", "ffn"),
        window_size=4096, attn_softcap=50.0, logit_softcap=30.0,
        use_post_norm=True, embed_scale=True, tie_embeddings=True,
        act="gelu")


def mamba2_1p3b() -> ModelConfig:
    # attn-free SSD; ssm_state=128 per the assignment.
    return ModelConfig(
        name="mamba2-1.3b", family="ssm", num_layers=48, d_model=2048,
        num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50280,
        stage_pattern=("ssm",), ssm_state=128, ssm_expand=2,
        ssm_head_dim=64, ssm_chunk=256)


def kimi_k2() -> ModelConfig:
    # trillion-param MoE: 384 experts top-8 (+1 shared), dense first layer.
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe", num_layers=61, d_model=7168,
        num_heads=64, num_kv_heads=8, head_dim=112, d_ff=2048,
        vocab_size=163840, prefix_pattern=("attn_full", "ffn"),
        stage_pattern=("attn_full", "moe"), num_experts=384, top_k=8,
        moe_d_ff=2048, n_shared_experts=1)


def llama4_maverick() -> ModelConfig:
    # iRoPE: 3 chunked-local layers per full-attn layer (public Llama-4
    # config); MoE every other layer, top-1 routed + shared expert.
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe", num_layers=48,
        d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        stage_pattern=("attn_chunk", "ffn", "attn_chunk", "moe",
                       "attn_chunk", "ffn", "attn_full", "moe"),
        attn_chunk=8192, num_experts=128, top_k=1, moe_d_ff=8192,
        n_shared_experts=1)


def musicgen_large() -> ModelConfig:
    # decoder-only over EnCodec tokens; 4 codebooks, delay pattern handled
    # by the (stubbed) frontend; near-MHA (kv=32).
    return ModelConfig(
        name="musicgen-large", family="audio", num_layers=48, d_model=2048,
        num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192,
        vocab_size=2048, stage_pattern=("attn_full", "ffn"),
        num_codebooks=4, act="gelu")


def recurrentgemma_2b() -> ModelConfig:
    # Griffin 1:2 pattern - two RG-LRU blocks per local-attention block.
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid", num_layers=26,
        d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
        d_ff=7680, vocab_size=256000,
        stage_pattern=("rec", "ffn", "rec", "ffn", "attn_swa", "ffn"),
        window_size=2048, lru_width=2560, embed_scale=True,
        tie_embeddings=True, act="gelu")


ARCH_BUILDERS = {
    "chameleon-34b": chameleon_34b,
    "h2o-danube-3-4b": h2o_danube3_4b,
    "yi-9b": yi_9b,
    "smollm-360m": smollm_360m,
    "gemma2-9b": gemma2_9b,
    "mamba2-1.3b": mamba2_1p3b,
    "kimi-k2-1t-a32b": kimi_k2,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "musicgen-large": musicgen_large,
    "recurrentgemma-2b": recurrentgemma_2b,
}

# archs whose every attention layer is sub-quadratic / state-bounded; only
# these run the long_500k cell (DESIGN.md SSlong_500k).
LONG_CONTEXT_OK = frozenset({
    "h2o-danube-3-4b", "gemma2-9b", "mamba2-1.3b",
    "llama4-maverick-400b-a17b", "recurrentgemma-2b",
})


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family tiny config for CPU smoke tests: preserves the stage
    pattern, GQA ratio, MoE/SSM/LRU structure; shrinks every dimension."""
    kv = max(min(cfg.num_kv_heads, 2), 0)
    heads = max(kv * max(cfg.q_per_kv if cfg.num_kv_heads else 0, 1), 0)
    mixers = max(cfg.layers_per_stage(), 1)
    prefix_m = sum(1 for b in cfg.prefix_pattern
                   if not (b.startswith("ffn") or b == "moe"))
    return cfg.replace(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, prefix_m + 2 * mixers),
        d_model=64,
        num_heads=heads or 0,
        num_kv_heads=kv,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=96 if cfg.d_ff else 0,
        moe_d_ff=48 if cfg.moe_d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        window_size=min(cfg.window_size, 8),
        attn_chunk=min(cfg.attn_chunk, 8),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=8,
        lru_width=64 if cfg.lru_width else 0,
        abft_row_chunk=64, abft_col_chunk=64,
        dtype="float32",
    )
