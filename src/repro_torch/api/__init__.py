"""The front door: declare (:class:`ModuleSpec`) -> :func:`compile` ->
``CompiledModel.apply``."""
from repro_torch.api.compile import compile  # noqa: A004
from repro_torch.api.compile import (block_spec, compile_block,
                                     iter_analog_layers, lower_tree,
                                     swap_calibration, tree_spec)
from repro_torch.api.module import (GroupSpec, LayerSpec, ModuleSpec,
                                    linear_spec)
from repro_torch.api.program import CompiledModel, apply_linear

__all__ = ["compile", "CompiledModel", "GroupSpec", "LayerSpec",
           "ModuleSpec", "apply_linear", "block_spec", "compile_block",
           "iter_analog_layers", "linear_spec", "lower_tree",
           "swap_calibration", "tree_spec"]
