"""Model layers (twin of repro.layers: attention, dense FFN and the
Mamba-2 SSD block), every weight GEMM routed through the ABFT core."""
from . import attention, embedding, ffn, linear, norms, rotary, ssm

__all__ = ["attention", "embedding", "ffn", "linear", "norms", "rotary",
           "ssm"]
