"""Config registry (twin of repro.configs): the 10 architectures by id
(`get("smollm-360m")`, `get("smollm-360m-smoke")` for the reduced twin).
The input-shape specs (`shapes.py`) wait for the dry-run."""
from .archs import ARCH_BUILDERS, LONG_CONTEXT_OK, reduced
from .base import ModelConfig


def get(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get(name[: -len("-smoke")]))
    if name not in ARCH_BUILDERS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCH_BUILDERS)}")
    return ARCH_BUILDERS[name]()


def list_archs():
    return sorted(ARCH_BUILDERS)


__all__ = ["ARCH_BUILDERS", "LONG_CONTEXT_OK", "ModelConfig", "get",
           "list_archs", "reduced"]
