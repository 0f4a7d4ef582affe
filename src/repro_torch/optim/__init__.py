"""Optimisers and compression (twin of repro.optim): the int8 weight
quantisation the at-rest repair serves. AdamW and gradient compression
are ROADMAP item 1.12."""
from .compression import dequantize_weight, quantize_weight

__all__ = ["dequantize_weight", "quantize_weight"]
