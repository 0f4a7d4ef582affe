"""Arch config module (twin of repro.configs.h2o_danube3_4b): `build`, the
architecture's config function, and its `CONFIG`."""
from .archs import h2o_danube3_4b as build
CONFIG = build()
