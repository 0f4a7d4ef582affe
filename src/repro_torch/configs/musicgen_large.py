"""Arch config module (twin of repro.configs.musicgen_large): `build`, the
architecture's config function, and its `CONFIG`."""
from .archs import musicgen_large as build
CONFIG = build()
