"""Runtime fault tolerance (twin of repro.runtime): the plan-trusted
at-rest weight audit, the step runner, the straggler monitor and the
sharding rules with their execution on a mesh. Elastic re-planning is
ROADMAP item 1.12's later step."""
from . import ft, sharding, straggler

__all__ = ["ft", "sharding", "straggler"]
