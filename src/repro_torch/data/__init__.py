"""Deterministic synthetic token pipeline (twin of repro.data)."""
from .pipeline import DataConfig, DataIterator, host_batch

__all__ = ["DataConfig", "DataIterator", "host_batch"]
