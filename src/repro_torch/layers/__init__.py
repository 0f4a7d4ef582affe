"""Model layers (twin of repro.layers: attention, dense FFN, the Mamba-2
SSD block and the RG-LRU block), every weight GEMM routed through the
ABFT core."""
from . import (attention, embedding, ffn, linear, norms, rglru, rotary,
               ssm)

__all__ = ["attention", "embedding", "ffn", "linear", "norms", "rglru",
           "rotary", "ssm"]
