"""Int32 counters on which the blocks of one kernel launch meet: the last
block to count itself in finishes the launch's sums (the compare of a
detection chunk in csrc/abft_matmul.cu, the conv detection sums in
csrc/checksum_reduce.cu).

A launch needs counters that are zero when it starts and that no other
launch uses while it runs. Every kernel leaves its counters zero, so no
call pays a memset (it would add a launch's latency to kernels of a few
µs). Eager launches of one stream run in its order and share one set;
launches captured in a CUDA graph take their capture's set, whose zero
fill is captured with them, so a replay never meets an eager launch's
set or another graph's.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import _build

MIN_COUNTERS = 4096
# sets by (device, stream) for eager launches, and by (device, stream,
# capture id) for launches captured in a graph, kept until the capture has
# ended
_EAGER: Dict[tuple, torch.Tensor] = {}
_CAPTURED: Dict[tuple, torch.Tensor] = {}


def held(dev: torch.device, stream: int, capture: Optional[int],
         count: int) -> torch.Tensor:
    """At least `count` zeroed int32 counters on `dev` for a launch on
    `stream`, inside the graph capture `capture` (None: an eager launch)."""
    if capture is None:
        _CAPTURED.clear()
        table, key = _EAGER, (dev, stream)
    else:
        table, key = _CAPTURED, (dev, stream, capture)
    got = table.get(key)
    if got is None or got.numel() < count:
        got = torch.zeros(max(count, MIN_COUNTERS), dtype=torch.int32,
                          device=dev)
        table[key] = got
    return got


def _capture_id(dev: torch.device, stream: int) -> Optional[int]:
    """The id of the graph capture `stream` is part of, or None."""
    if (dev.index in (None, torch.cuda.current_device())
            and not torch.cuda.is_current_stream_capturing()):
        return None
    fn = _build.function("abft_matmul", "repro_capture_id",
                         [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(ctypes.c_ulonglong)])
    capturing, capture = ctypes.c_int(), ctypes.c_ulonglong()
    if fn(stream, ctypes.byref(capturing), ctypes.byref(capture)):
        raise RuntimeError("cudaStreamGetCaptureInfo failed")
    return capture.value if capturing.value else None


def counters(dev: torch.device, count: int) -> torch.Tensor:
    """At least `count` zeroed int32 counters for a launch on `dev`'s
    current stream."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    return held(dev, stream, _capture_id(dev, stream), count)
