"""Protected continuous-batching serving (twin of repro.serving): slot
scheduler + ProtectedSession (the synchronous loop) + ServingDriver (the
async controller/runner split with bounded, deadline-aware admission) +
per-request fault/SLO accounting."""
from .driver import ServingDriver, SubmitVerdict
from .scheduler import Request, SlotScheduler, bucket_for
from .session import ProtectedSession, greedy_reference
from .stats import RequestRecord, ServingStats

__all__ = ["Request", "SlotScheduler", "bucket_for", "ProtectedSession",
           "ServingDriver", "SubmitVerdict", "greedy_reference",
           "RequestRecord", "ServingStats"]
