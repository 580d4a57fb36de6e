"""``compile(spec, params, run_cfg)``: the compile half of the front door
(port of the stack branch of ``repro.api.compile``).

Every analog layer of a stack spec is lowered exactly once, on the
target device, into one :class:`~repro_torch.exec.plan.AnalogPlan`.
The static verify step of the reference, digital mode, tree/block specs
and measured calibration are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.api.module import ModuleSpec
from repro_torch.api.program import CompiledModel
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.exec.lower import lower_stack


def _acfg(run_cfg) -> AnalogConfig:
    """Accept a config with an ``.analog`` field or a bare AnalogConfig."""
    return getattr(run_cfg, "analog", run_cfg)


def _is_analog_layer(node) -> bool:
    """An analog linear's parameter dict (2-D master weights)."""
    return (
        isinstance(node, dict)
        and "w" in node and "w_scale" in node and "gain" in node
        and getattr(node["w"], "ndim", 0) == 2
    )


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _stack_params(spec: ModuleSpec, params) -> list:
    layer_params = []
    for l in spec.layers:
        if _is_analog_layer(params):          # single-layer convenience:
            p = params                        # the layer dict itself
        elif isinstance(params, dict) and l.name in params:
            p = params[l.name]
        else:
            raise ValueError(
                f"spec layer {l.name!r}: no analog layer params found"
            )
        if not _is_analog_layer(p):
            raise ValueError(
                f"spec layer {l.name!r}: params are not an analog layer "
                "dict (need w / w_scale / gain)"
            )
        got = tuple(p["w"].shape[-2:])
        if got != (l.in_dim, l.out_dim):
            raise ValueError(
                f"spec layer {l.name!r} declares "
                f"{(l.in_dim, l.out_dim)} but params are {got}"
            )
        layer_params.append(p)
    return layer_params


def compile(spec: ModuleSpec, params, run_cfg, *,  # noqa: A001
            device: DeviceLike = None) -> CompiledModel:
    """Compile a declared stack against concrete parameters on ``device``
    (``None`` = the CUDA device; raises when there is none).  The
    parameters are moved there first, then lowered once."""
    dev = resolve_device(device)
    acfg = _acfg(run_cfg)
    if acfg.mode == "digital":
        raise NotImplementedError(
            f"spec {spec.name!r}: digital mode is not ported yet"
        )
    params = _to_device(params, dev)
    layer_params = _stack_params(spec, params)
    lowered = lower_stack(
        layer_params, acfg,
        signed_inputs=[l.signed_input for l in spec.layers],
        epilogues=[l.epilogue for l in spec.layers],
        flatten_outs=[l.flatten_out for l in spec.layers],
        input_domain=spec.input_domain,
    )
    return CompiledModel(spec=spec, params=params, run_cfg=run_cfg,
                         lowered=lowered, device=dev)
