"""Runtime fault tolerance (twin of repro.runtime): the plan-trusted
at-rest weight audit and the step runner. Sharding, elastic and
straggler handling are ROADMAP item 1.12."""
from . import ft

__all__ = ["ft"]
