"""Arch config module (twin of repro.configs.yi_9b): `build`, the
architecture's config function, and its `CONFIG`."""
from .archs import yi_9b as build
CONFIG = build()
