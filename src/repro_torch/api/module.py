"""Declarative module specs: the "declare once" half of the front door
(port of the stack kind of ``repro.api.module``).

A :class:`ModuleSpec` of kind ``"stack"`` names every analog layer of a
model exactly once - name, in/out dims, inter-layer epilogue - and
:func:`repro_torch.api.compile` turns (spec, params, config) into a
:class:`repro_torch.api.program.CompiledModel`.  The ``"tree"`` and
``"block"`` kinds and fusion groups are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

STACK = "stack"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One analog layer, declared once.

    name:         layer name ("fc1"), the key of its params.
    in_dim/out_dim: logical matmul dims (pre chunk padding).
    signed_input: per-layer override of ``cfg.signed_input`` or None.
    epilogue:     ADC hand-off to the NEXT stacked layer ("none" float
                  glue | "relu_shift" code-domain chain).
    flatten_out:  flatten trailing output dims before the next layer.
    """

    name: str
    in_dim: int
    out_dim: int
    signed_input: Optional[str] = None
    epilogue: str = "none"
    flatten_out: bool = False


@dataclasses.dataclass(frozen=True)
class ModuleSpec:
    """A model's analog declaration: what to compile, not how to run it.

    ``apply_fn(model, *args, **kw)`` is the host program executed by
    ``CompiledModel.apply`` (stacks default to running their plan).
    ``input_domain`` declares what the compiled program's INITIAL input
    is: "codes" (unsigned 5-bit event codes, quantization skipped) or
    "float" (quantized on entry); None infers it from the first layer's
    epilogue.
    """

    name: str
    layers: Tuple[LayerSpec, ...] = ()
    kind: str = STACK
    apply_fn: Optional[Callable] = None
    input_domain: Optional[str] = None

    def __post_init__(self):
        if self.kind != STACK:
            raise NotImplementedError(
                f"spec {self.name!r}: kind {self.kind!r} is not ported yet; "
                "only 'stack' specs compile"
            )
        object.__setattr__(self, "layers", tuple(self.layers))
        names = [l.name for l in self.layers]
        if len(set(names)) != len(names):
            raise ValueError(
                f"spec {self.name!r}: duplicate layer names in {names}"
            )
