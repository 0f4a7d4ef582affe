"""Protected continuous-batching serving (twin of repro.serving): slot
scheduler + ProtectedSession + per-request fault/SLO accounting. The async
ServingDriver is not ported yet (ROADMAP item 1.10)."""
from .scheduler import Request, SlotScheduler, bucket_for
from .session import ProtectedSession, greedy_reference
from .stats import RequestRecord, ServingStats

__all__ = ["Request", "SlotScheduler", "bucket_for", "ProtectedSession",
           "greedy_reference", "RequestRecord", "ServingStats"]
