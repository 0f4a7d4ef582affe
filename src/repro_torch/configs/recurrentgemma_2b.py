"""Arch config module (twin of repro.configs.recurrentgemma_2b): `build`, the
architecture's config function, and its `CONFIG`."""
from .archs import recurrentgemma_2b as build
CONFIG = build()
