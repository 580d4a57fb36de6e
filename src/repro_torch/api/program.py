"""Compiled analog programs: :class:`CompiledModel` (port of the stack part
of ``repro.api.program``).

    model = api.compile(spec, params, run_cfg)   # on the CUDA device
    y     = model.apply(x)                       # run the compiled program
    plan  = model.lower()                        # the baked AnalogPlan

Serving compiles once and replays the plan for every request.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.exec.plan import AnalogPlan
from repro_torch.exec.run import run as run_plan


@dataclasses.dataclass(frozen=True)
class CompiledModel:
    """An executable analog model: declaration + params + the baked plan,
    all on ``device``."""

    spec: Any                      # ModuleSpec
    params: Any                    # the float master parameters
    run_cfg: Any                   # AnalogConfig (or an object with .analog)
    lowered: AnalogPlan
    device: torch.device

    def apply(self, *args, **kw):
        """Run the compiled program: the spec's host program
        (``spec.apply_fn(model, *args, **kw)``) when it declares one, else
        the layer chain (``(x, *, megakernel="auto")``)."""
        if self.spec.apply_fn is not None:
            return self.spec.apply_fn(self, *args, **kw)
        return self.run_stack(*args, **kw)

    def run_stack(self, x: torch.Tensor, *, megakernel="auto"
                  ) -> torch.Tensor:
        """Replay the layer chain (megakernel-routed when eligible)."""
        return run_plan(self.lowered, x, megakernel=megakernel)

    def lower(self) -> AnalogPlan:
        """The compiled artifact: the stack's :class:`AnalogPlan`."""
        return self.lowered
