"""Arch config module (twin of repro.configs.mamba2_1p3b): `build`, the
architecture's config function, and its `CONFIG`."""
from .archs import mamba2_1p3b as build
CONFIG = build()
