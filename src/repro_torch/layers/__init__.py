"""Model layers (twin of repro.layers: attention, dense FFN, the MoE
block, the Mamba-2 SSD block and the RG-LRU block), every weight GEMM
routed through the ABFT core."""
from . import (attention, embedding, ffn, linear, moe, norms, rglru, rotary,
               ssm)
from .moe import apply_moe, init_moe

__all__ = ["attention", "embedding", "ffn", "linear", "moe", "norms",
           "rglru", "rotary", "ssm", "apply_moe", "init_moe"]
