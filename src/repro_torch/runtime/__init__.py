"""Runtime fault tolerance (twin of repro.runtime): the plan-trusted
at-rest weight audit, the step runner and the straggler monitor.
Sharding and elastic re-planning are ROADMAP item 1.12."""
from . import ft, straggler

__all__ = ["ft", "straggler"]
