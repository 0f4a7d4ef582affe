"""Arch config module (twin of repro.configs.smollm_360m): `build`, the
architecture's config function, and its `CONFIG`."""
from .archs import smollm_360m as build
CONFIG = build()
