"""Config registry: ``get_arch(name)`` / ``get_smoke(name)`` for every
architecture of the reference's registry (the dense transformers, the
MoE, vision and audio families, RWKV-6 and the Zamba2 SSM hybrid)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, RunConfig, ShapeConfig

__all__ = ["ARCH_NAMES", "SHAPES", "ArchConfig", "RunConfig", "ShapeConfig",
           "all_cells", "cells", "get_arch", "get_smoke"]

_MODULES = {
    "stablelm-3b": "stablelm_3b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "glm4-9b": "glm4_9b",
    "minitron-4b": "minitron_4b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "rwkv6-7b": "rwkv6_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "zamba2-2.7b": "zamba2_2p7b",
    "musicgen-medium": "musicgen_medium",
}
ARCH_NAMES = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(ARCH_NAMES)}"
        )
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_arch(name: str) -> ArchConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE


def cells(arch: str) -> list:
    """Shape names applicable to one arch (long_500k: sub-quadratic only)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if get_arch(arch).supports_long_context:
        out.append("long_500k")
    return out


def all_cells() -> list:
    return [(a, s) for a in ARCH_NAMES for s in cells(a)]
