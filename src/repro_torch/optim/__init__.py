"""Optimisers and compression (twin of repro.optim): the functional AdamW
and Adafactor with clipping and the cosine schedule the trainer runs, and
the int8 weight quantisation the at-rest repair serves. Gradient
compression is ROADMAP item 1.12."""
from .adamw import (OptConfig, apply_updates, clip_by_global_norm,
                    cosine_schedule, global_norm, init_opt_state)
from .compression import dequantize_weight, quantize_weight

__all__ = ["OptConfig", "apply_updates", "clip_by_global_norm",
           "cosine_schedule", "dequantize_weight", "global_norm",
           "init_opt_state", "quantize_weight"]
