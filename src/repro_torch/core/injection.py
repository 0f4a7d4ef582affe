"""Ambient site-fault hooks for serving drills (twin of the
`fault_scope`/`site_fault` seam of repro.core.injection; the fault-model
registry, FaultSpec and the campaign are not ported yet).

A serving drill needs a fault to land inside a full forward at one named
plan path, so that per-request attribution can be tested end to end.
`fault_scope` registers a hook keyed by the exact param-tree path;
core.plan.protect_site consults it and routes the corrupted output through
the ordinary `o=` injection seam, so detection and the correction ladder
see exactly what a campaign cell sees. Hooks fire at every call of the
site inside the scope, in every repeat of a stage path.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Optional, Tuple

import torch

Hook = Callable[[torch.Tensor], torch.Tensor]

_SITE_FAULTS: contextvars.ContextVar[Tuple[Tuple[str, Hook], ...]] = \
    contextvars.ContextVar("repro_torch_site_faults", default=())


@contextlib.contextmanager
def fault_scope(path: str, fn: Hook) -> Iterator[None]:
    """Corrupt the raw output of the protected matmul site at `path`
    (exact match against core.plan.current_path) with `fn(o) -> o_bad`.
    `o` arrives in the call site's natural shape (e.g. (B, S, V) for the
    LM head), so a hook can target one batch row or one position, and can
    leave a call alone by its shape (`o.shape[1] > 1` selects prefill)."""
    token = _SITE_FAULTS.set(_SITE_FAULTS.get() + ((path, fn),))
    try:
        yield
    finally:
        _SITE_FAULTS.reset(token)


def site_fault(path: str) -> Optional[Hook]:
    """Innermost registered hook for `path`, or None."""
    for p, fn in reversed(_SITE_FAULTS.get()):
        if p == path:
            return fn
    return None
