"""Launch entry points (twin of repro.launch): `serve` drives protected
serving end to end, `train` the single-card fault-tolerant trainer over
the step functions of `steps`, and `mesh`, the (data, model) mesh over
torch.distributed ranks with `run_ranks` to start them."""
import importlib

from . import mesh, steps

__all__ = ["mesh", "steps", "train"]


def __getattr__(name):
    # `train` is imported on first use, so `python -m
    # repro_torch.launch.train` does not find it imported already
    if name == "train":
        return importlib.import_module(f"{__name__}.train")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
