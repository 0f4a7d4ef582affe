"""Device resolution and the fp32 precision scope shared by the entry
points."""
from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    CUDA card. A host without a card raises unless the caller asked for
    the CPU explicitly - the port never drops to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless device='cpu' is "
            "passed, and this host has none")
    return torch.device("cuda")


@contextlib.contextmanager
def fp32_ieee(enabled: bool = True) -> Iterator[None]:
    """Run fp32 convolutions and matmuls in IEEE fp32, not TF32.

    The detection thresholds (core/thresholds.py) price fp32 accumulation
    noise; cuDNN runs fp32 convs in TF32 by default, ~2^13 times coarser,
    which would flag every clean layer. The flags are process-global, so
    the scope sets both and restores what it found."""
    if not enabled:
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
