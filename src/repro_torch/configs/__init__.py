"""Assigned-architecture registry: ``--arch <id>`` resolves here.

The JAX package's ``configs/``, every arch file the same published
configuration, plus the archs only the port runs (:data:`PORT_ONLY`: their
configs set fields the JAX package lacks, ``ArchConfig.port_only``).

Each module defines ``CONFIG`` (the exact published configuration); the
reduced smoke config of the same family comes from ``ArchConfig.reduced()``.
"""
from __future__ import annotations

from ..models.config import ArchConfig, SHAPES, ShapeConfig
from . import (deepseek_67b, phi3_medium_14b, qwen2_5_3b, gemma_7b,
               phi3_5_moe, llama4_maverick, jamba_v0_1, falcon_mamba_7b,
               internvl2_2b, musicgen_medium, granite_4_0_h_small)

ARCHS: dict = {m.CONFIG.name: m.CONFIG for m in (
    deepseek_67b, phi3_medium_14b, qwen2_5_3b, gemma_7b,
    phi3_5_moe, llama4_maverick, jamba_v0_1, falcon_mamba_7b,
    internvl2_2b, musicgen_medium, granite_4_0_h_small)}

#: The archs with no JAX counterpart.
PORT_ONLY = frozenset(n for n, c in ARCHS.items() if c.port_only())

#: Families with sub-quadratic sequence handling — the only ones that run
#: the long_500k cell (full-attention archs skip it per the assignment).
SUBQUADRATIC = ("ssm", "hybrid")


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def cell_applicable(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """Whether (arch, shape) is a runnable cell per the assignment rules."""
    if shape.name == "long_500k":
        return arch.family in SUBQUADRATIC
    return True


def all_cells(include_skipped: bool = False):
    """Every (arch, shape) pair, optionally including the noted skips."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            if include_skipped or cell_applicable(arch, shape):
                yield arch, shape
