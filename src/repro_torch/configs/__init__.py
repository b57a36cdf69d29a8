"""Assigned-architecture registry: ``get_arch(name)`` / ``--arch <id>``.

The port's own copy of the JAX package's plain dataclasses and data (the
port imports nothing of that package); the tests hold every config and its
``smoke()`` equal field by field."""
from __future__ import annotations

from .base import SHAPES, ArchConfig, ShapeConfig, shape_applicable
from .qwen15_4b import CONFIG as _qwen
from .gemma3_1b import CONFIG as _g1
from .granite_8b import CONFIG as _granite
from .gemma3_27b import CONFIG as _g27
from .falcon_mamba_7b import CONFIG as _mamba
from .musicgen_large import CONFIG as _musicgen
from .moonshot_v1_16b import CONFIG as _moonshot
from .llama4_maverick import CONFIG as _llama4
from .pixtral_12b import CONFIG as _pixtral
from .zamba2_7b import CONFIG as _zamba

ARCHS = {c.name: c for c in [
    _qwen, _g1, _granite, _g27, _mamba, _musicgen, _moonshot, _llama4,
    _pixtral, _zamba,
]}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "get_arch",
           "shape_applicable"]
