"""Per-request fault/SLO accounting for the serving session (twin of
repro.serving.stats; the same "repro.serving/v2" report schema).

The paper's serving story needs more than one summed fault scalar: an
operator has to know WHICH request was touched by a fault, whether it was
corrected, and what the protection cost in first-token latency. Each
request therefore carries submission/admission/first-token/completion
timestamps, token counts and fault attribution, and the session surfaces
them as a `ServingStats` report.

Schema: "repro.serving/v2". v2 is a superset of v1 - every v1 field keeps
its name and meaning; new in v2 are the per-request `submitted_at` /
`queue_delay_s` (submit -> prefill wait, the async driver's backpressure
signal) and `deadline_s`, the aggregate `ttft_p99_s` and
`queue_delay_p50_s`/`queue_delay_p95_s`, the `finish_reason` values
"timeout" (deadline expired while queued) and "rejected" (bounded
admission queue full / draining), and the `timeouts`/`rejected` counters.
Consumers keyed to v1 fields read v2 reports unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional


@dataclasses.dataclass
class RequestRecord:
    """SLO + fault ledger for one request (timestamps from
    time.perf_counter, relative to session creation)."""
    id: int
    prompt_len: int
    max_new_tokens: int
    slot: Optional[int] = None
    submitted_at: Optional[float] = None     # entered the admission queue
    admitted_at: Optional[float] = None      # left the queue (prefill start)
    first_token_at: Optional[float] = None
    completed_at: Optional[float] = None
    # "eos" | "length" | "max_len" | "dropped" | "timeout" | "rejected"
    finish_reason: Optional[str] = None
    deadline_s: Optional[float] = None       # TTL granted at submit
    tokens: List = dataclasses.field(default_factory=list)
    prefill_detected: int = 0
    faults_detected: int = 0                 # steps whose fault hit this slot
    corrections_applied: int = 0
    residuals: int = 0
    audit_verdicts: List[str] = dataclasses.field(default_factory=list)

    @property
    def tokens_generated(self) -> int:
        return len(self.tokens)

    @property
    def ttft(self) -> Optional[float]:
        if self.admitted_at is None or self.first_token_at is None:
            return None
        return self.first_token_at - self.admitted_at

    @property
    def queue_delay(self) -> Optional[float]:
        """Time spent waiting in the admission queue (submit -> prefill).
        None until admitted (or forever, for timeout/rejected verdicts)."""
        if self.submitted_at is None or self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    def as_dict(self) -> dict:
        return {"id": self.id, "slot": self.slot,
                "prompt_len": self.prompt_len,
                "max_new_tokens": self.max_new_tokens,
                "submitted_at": self.submitted_at,
                "admitted_at": self.admitted_at,
                "first_token_at": self.first_token_at,
                "completed_at": self.completed_at,
                "queue_delay_s": self.queue_delay,
                "ttft_s": self.ttft,
                "deadline_s": self.deadline_s,
                "finish_reason": self.finish_reason,
                "tokens_generated": self.tokens_generated,
                "prefill_detected": self.prefill_detected,
                "faults_detected": self.faults_detected,
                "corrections_applied": self.corrections_applied,
                "residuals": self.residuals,
                "audit_verdicts": list(self.audit_verdicts)}


def _pct(xs: List[Optional[float]], q: float) -> Optional[float]:
    """Nearest-rank percentile, hardened for the ledgers a drained-early
    session produces: None/NaN entries are dropped, an empty ledger
    returns None (never NaN), and a singleton returns its one sample for
    every q (no IndexError from rank rounding)."""
    xs = [x for x in xs if x is not None and math.isfinite(x)]
    if not xs:
        return None
    xs = sorted(xs)
    i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[i]


class ServingStats:
    """Aggregates RequestRecords + session counters into the report."""

    SCHEMA = "repro.serving/v2"

    def __init__(self):
        self.records: Dict[int, RequestRecord] = {}
        self.counters: Dict[str, int] = {
            "steps": 0, "decode_steps": 0, "prefills": 0,
            "faults_detected": 0, "faults_corrected": 0,
            "faults_unattributed": 0, "residual_steps": 0,
            "weight_audits": 0, "weight_repairs": 0, "weight_restores": 0,
            "dropped": 0, "timeouts": 0, "rejected": 0,
        }
        # per-event in-place repair latencies (the MTTR ledger: time from
        # audit hit to verified repaired weights, seconds)
        self.repair_s: List[float] = []
        self.wall_s: float = 0.0
        # one entry per decode step, outside the report's schema: the
        # host seconds of its dispatch (the session: launch to the read
        # of the next tokens, which waits for the device; the async
        # driver: launch to the return of the forward, whose deferred
        # flag read waits for the device), the slot localizer's per-slot
        # hit vector and the session-clock second it was launched at
        self.decode_log: List[dict] = []

    def log_decode(self, dispatch_s: float, hit, launched_at: float) -> None:
        self.decode_log.append({"dispatch_s": dispatch_s,
                                "hit": [int(h) for h in hit],
                                "launched_at": launched_at})

    def record(self, rid: int) -> RequestRecord:
        return self.records[rid]

    def add(self, rec: RequestRecord) -> RequestRecord:
        self.records[rec.id] = rec
        return rec

    def completed(self) -> List[RequestRecord]:
        return [r for r in self.records.values()
                if r.completed_at is not None]

    def report(self) -> dict:
        done = self.completed()
        ttfts = [r.ttft for r in done]
        qdelays = [r.queue_delay for r in done]
        toks = sum(r.tokens_generated for r in done)
        return {
            "schema": self.SCHEMA,
            "requests": [r.as_dict() for r in
                         sorted(self.records.values(), key=lambda r: r.id)],
            "counters": dict(self.counters),
            "completed": len(done),
            "tokens_total": toks,
            "wall_s": self.wall_s,
            "tok_per_s": toks / self.wall_s if self.wall_s > 0 else None,
            "ttft_p50_s": _pct(ttfts, 0.50),
            "ttft_p95_s": _pct(ttfts, 0.95),
            "ttft_p99_s": _pct(ttfts, 0.99),
            "queue_delay_p50_s": _pct(qdelays, 0.50),
            "queue_delay_p95_s": _pct(qdelays, 0.95),
            "mttr_repair_s": (sum(self.repair_s) / len(self.repair_s)
                              if self.repair_s else None),
        }
