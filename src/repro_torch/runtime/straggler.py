"""Straggler mitigation (twin of repro.runtime.straggler; host-only).

On a 1000+-node job the slowest host sets the step time. The monitor
tracks a robust running estimate (median) of per-step/host latency and
flags outliers; the mitigation hooks are:

1. deadline policy - a step exceeding `deadline_factor x median` is
   abandoned and recomputed from the last good state (cheap because the
   data pipeline is stateless/step-indexed),
2. hot-spare policy - flagged hosts are queued for replacement at the
   next checkpoint boundary. Re-planning the mesh without the sick host
   (runtime/elastic.py) is ROADMAP item 1.12.

The single-card trainer runs the monitor for real on its one host; the
multi-host actions are exercised in tests via injected timings.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional


@dataclasses.dataclass
class StragglerPolicy:
    window: int = 50
    deadline_factor: float = 3.0
    flag_factor: float = 2.0
    min_samples: int = 8


class StragglerMonitor:
    def __init__(self, policy: StragglerPolicy = StragglerPolicy()):
        self.policy = policy
        self.samples: Deque[float] = deque(maxlen=policy.window)
        self.per_host: Dict[int, Deque[float]] = {}
        self.flagged: List[int] = []
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self, host_id: int = 0) -> float:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.record(dt, host_id)
        return dt

    def record(self, seconds: float, host_id: int = 0) -> None:
        self.samples.append(seconds)
        self.per_host.setdefault(host_id, deque(maxlen=self.policy.window)
                                 ).append(seconds)

    def median(self) -> float:
        s = sorted(self.samples)
        return s[len(s) // 2] if s else 0.0

    def deadline(self) -> float:
        """Abandon-and-recompute threshold for the current step."""
        if len(self.samples) < self.policy.min_samples:
            return float("inf")
        return self.policy.deadline_factor * self.median()

    def check_hosts(self) -> List[int]:
        """Hosts whose median latency exceeds flag_factor x fleet median."""
        if len(self.samples) < self.policy.min_samples:
            return []
        fleet = self.median()
        out = []
        for host, dq in self.per_host.items():
            if len(dq) >= self.policy.min_samples:
                s = sorted(dq)
                if s[len(s) // 2] > self.policy.flag_factor * fleet:
                    out.append(host)
        self.flagged = out
        return out
