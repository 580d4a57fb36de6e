"""Config registry: ``get_arch(name)`` / ``get_smoke(name)`` for the
architectures the port runs (the dense transformers, the MoE, vision and
audio families).  The other names of the reference's registry (RWKV and
the SSM hybrid) raise a "not ported yet" error."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, RunConfig

__all__ = ["ARCH_NAMES", "ArchConfig", "RunConfig", "get_arch", "get_smoke"]

_MODULES = {
    "stablelm-3b": "stablelm_3b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "glm4-9b": "glm4_9b",
    "minitron-4b": "minitron_4b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "musicgen-medium": "musicgen_medium",
}
# the reference's other architectures: their families (rwkv, hybrid ssm)
# are not ported yet
_NOT_PORTED = ("rwkv6-7b", "zamba2-2.7b")

ARCH_NAMES = list(_MODULES)


def _module(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: repro_torch runs "
            f"{', '.join(ARCH_NAMES)}; see ROADMAP.md"
        )
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(ARCH_NAMES)}"
        )
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_arch(name: str) -> ArchConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE
