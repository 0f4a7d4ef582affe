"""Arch config module (twin of repro.configs.chameleon_34b): `build`, the
architecture's config function, and its `CONFIG`."""
from .archs import chameleon_34b as build
CONFIG = build()
