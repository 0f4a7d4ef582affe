"""Optimisers and compression (twin of repro.optim): the functional AdamW
and Adafactor with clipping and the cosine schedule the trainer runs, and
the int8 weight quantisation the at-rest repair serves, and the int8
error-feedback gradient compression with its all-reduce over a process
group."""
from .adamw import (OptConfig, apply_updates, clip_by_global_norm,
                    cosine_schedule, global_norm, init_opt_state)
from .compression import (allreduce_compressed, compress, decompress,
                          dequantize_weight, quantize_weight)

__all__ = ["OptConfig", "allreduce_compressed", "apply_updates",
           "clip_by_global_norm", "compress", "cosine_schedule",
           "decompress", "dequantize_weight", "global_norm",
           "init_opt_state", "quantize_weight"]
