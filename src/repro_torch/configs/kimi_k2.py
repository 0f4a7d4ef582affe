"""Arch config module (twin of repro.configs.kimi_k2): `build`, the
architecture's config function, and its `CONFIG`."""
from .archs import kimi_k2 as build
CONFIG = build()
