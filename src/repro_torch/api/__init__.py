"""The front door: declare (:class:`ModuleSpec`) -> :func:`compile` ->
``CompiledModel.apply``."""
from repro_torch.api.compile import compile  # noqa: A004
from repro_torch.api.module import LayerSpec, ModuleSpec
from repro_torch.api.program import CompiledModel

__all__ = ["compile", "CompiledModel", "LayerSpec", "ModuleSpec"]
