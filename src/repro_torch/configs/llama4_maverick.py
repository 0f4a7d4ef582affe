"""Arch config module (twin of repro.configs.llama4_maverick): `build`, the
architecture's config function, and its `CONFIG`."""
from .archs import llama4_maverick as build
CONFIG = build()
