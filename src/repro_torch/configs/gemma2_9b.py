"""Arch config module (twin of repro.configs.gemma2_9b): `build`, the
architecture's config function, and its `CONFIG`."""
from .archs import gemma2_9b as build
CONFIG = build()
