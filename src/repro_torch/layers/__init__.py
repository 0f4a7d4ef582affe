"""Model layers (twin of repro.layers, the attention + dense-FFN slice),
every weight GEMM routed through the ABFT core."""
from . import attention, embedding, ffn, linear, norms, rotary

__all__ = ["attention", "embedding", "ffn", "linear", "norms", "rotary"]
