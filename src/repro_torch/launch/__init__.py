"""Launch entry points (twin of repro.launch): `serve` drives protected
serving end to end, `train` the single-card fault-tolerant trainer over
the step functions of `steps`. The mesh (`launch/mesh.py`) waits for
ROADMAP item 1.12."""
import importlib

from . import steps

__all__ = ["steps", "train"]


def __getattr__(name):
    # `train` is imported on first use, so `python -m
    # repro_torch.launch.train` does not find it imported already
    if name == "train":
        return importlib.import_module(f"{__name__}.train")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
