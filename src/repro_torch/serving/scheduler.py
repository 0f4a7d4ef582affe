"""Slot scheduler for continuous batching (twin of
repro.serving.scheduler; host-side bookkeeping only).

Decode runs at a fixed (slots, 1) token shape ((slots, 1, K) for a
multi-codebook arch, whose prompts are (S, K) arrays of length S); what
changes between steps is which requests occupy which slots. The
scheduler owns that mapping: an admission FIFO, per-slot prompt lengths,
eviction on EOS/max-len, and refill from the queue each step. Prompt
shapes are bucketed (next power of two, clamped to max_len) so the number
of distinct prefill shapes stays bounded under mixed traffic; recurrent
blocks (ssm/rec) disable bucketing because trailing padding would pollute
their sequential state (attention-only caches are safe: padded rows are
causally masked until overwritten in order by decode writes).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

_RECURRENT_KINDS = ("ssm", "rec")


@dataclasses.dataclass
class Request:
    """One serving request: a prompt plus generation bounds."""
    id: int
    tokens: np.ndarray                 # (plen,) or (plen, K) int
    max_new_tokens: int
    eos_id: Optional[int] = None

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


def bucket_for(plen: int, max_len: int, exact: bool = False,
               floor: int = 8) -> int:
    """Prefill pad target for a prompt of length `plen`: the next power of
    two (>= floor), clamped into [plen, max_len]. `exact` returns plen
    unchanged (recurrent models)."""
    if exact:
        return plen
    b = floor
    while b < plen:
        b *= 2
    return max(plen, min(b, max_len))


class SlotScheduler:
    """Admission queue + slot occupancy for a fixed-slot decode step.

    submit() enqueues (rejecting prompts that cannot fit max_len);
    admit() drains the queue into free slots (FIFO) and returns the
    placements; evict() frees a slot. The scheduler never touches device
    state - the session performs the prefill/insert for each placement.
    """

    def __init__(self, slots: int, max_len: int, cfg=None,
                 bucket_floor: int = 8):
        if slots < 1:
            raise ValueError(f"SlotScheduler: need >= 1 slot (got {slots})")
        self.slots = slots
        self.max_len = max_len
        self.bucket_floor = bucket_floor
        self.exact_prefill = False
        if cfg is not None:
            kinds = (tuple(cfg.prefix_pattern) + tuple(cfg.stage_pattern)
                     + tuple(cfg.remainder_pattern))
            self.exact_prefill = any(k in _RECURRENT_KINDS for k in kinds)
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}     # slot -> request
        self.dropped: List[Request] = []
        self._next_id = 0

    # -- admission ---------------------------------------------------------
    def make_request(self, tokens, max_new_tokens: int,
                     eos_id: Optional[int] = None) -> Tuple[Request, bool]:
        """Validate + allocate a request WITHOUT queueing it (the async
        driver owns its own bounded queue). Returns (request, ok); ok is
        False when the prompt cannot fit the session's cache even alone,
        in which case the request is recorded in `dropped`."""
        tokens = np.asarray(tokens)
        req = Request(self._next_id, tokens, int(max_new_tokens), eos_id)
        self._next_id += 1
        if req.prompt_len < 1 or req.prompt_len >= self.max_len:
            self.dropped.append(req)
            return req, False
        return req, True

    def submit(self, tokens, max_new_tokens: int,
               eos_id: Optional[int] = None) -> Optional[Request]:
        """Enqueue a request; returns it, or None when the prompt cannot
        fit the session's cache even alone (counted as dropped)."""
        req, ok = self.make_request(tokens, max_new_tokens, eos_id)
        if not ok:
            return None
        self.queue.append(req)
        return req

    def free_slots(self) -> List[int]:
        return [s for s in range(self.slots) if s not in self.active]

    def admit(self) -> List[Tuple[int, Request]]:
        """Place queued requests into free slots (FIFO); returns the new
        (slot, request) placements for the session to prefill."""
        placed = []
        for slot in self.free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            self.active[slot] = req
            placed.append((slot, req))
        return placed

    def place(self, req: Request) -> Optional[int]:
        """Claim the lowest free slot for `req` directly (bypassing the
        FIFO - the async driver pops from its own deadline-aware queue).
        Returns the slot, or None when every slot is occupied. A slot
        freed by evict() is claimable in the same scheduler tick - the
        evict-then-refill edge the continuous-batching refill leans on."""
        free = self.free_slots()
        if not free:
            return None
        slot = free[0]
        self.active[slot] = req
        return slot

    def evict(self, slot: int) -> Request:
        return self.active.pop(slot)

    # -- queries -----------------------------------------------------------
    def bucket(self, plen: int) -> int:
        return bucket_for(plen, self.max_len, exact=self.exact_prefill,
                          floor=self.bucket_floor)

    def active_slots(self) -> List[int]:
        return sorted(self.active)

    def busy(self) -> bool:
        return bool(self.queue) or bool(self.active)
