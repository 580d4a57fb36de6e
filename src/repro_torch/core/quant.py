"""Quantizers for the BSS-2 datapath (paper Fig. 4), forward semantics.

- activations: 5-bit unsigned pulse lengths, values in [0, 31]
- weights:     6-bit signed synaptic weights, values in [-63, 63]
- ADC:         8-bit signed readout, values in [-128, 127]

Mirrors ``repro.core.quant`` value for value (round half to even, the
same divide-then-round order).  The straight-through gradients of the
hardware-in-the-loop training path are not part of this module yet: the
serve path runs without autograd.
"""
from __future__ import annotations

import torch

from repro_torch.core.hw import BSS2


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """5-bit unsigned codes (float dtype, integer values):
    ``clip(round(x / scale), 0, 31)``.  Negative inputs saturate at 0."""
    return torch.clamp(torch.round(x / scale), 0.0, float(BSS2.a_max))


def quantize_weight(w: torch.Tensor, scale) -> torch.Tensor:
    """6-bit signed codes (float dtype, integer values):
    ``clip(round(w / scale), -63, 63)``; ``scale`` broadcasts
    (per-output-column by default)."""
    return torch.clamp(torch.round(w / scale), -float(BSS2.w_max),
                       float(BSS2.w_max))


def act_scale_from_max(max_abs: torch.Tensor) -> torch.Tensor:
    """LSB so that ``max_abs`` maps to the top activation code."""
    return torch.clamp_min(max_abs, 1e-8) / float(BSS2.a_max)


def weight_scale_from_max(max_abs: torch.Tensor) -> torch.Tensor:
    """LSB so that ``max_abs`` maps to the top weight code."""
    return torch.clamp_min(max_abs, 1e-8) / float(BSS2.w_max)


def calibrate_weight_scale(w: torch.Tensor,
                           per_column: bool = True) -> torch.Tensor:
    """Per-column (neuron) weight scale, matching per-neuron calibration."""
    wa = w.detach().abs()
    if per_column:
        return weight_scale_from_max(wa.amax(dim=0, keepdim=True))
    return weight_scale_from_max(wa.max())


def adc_readout(v: torch.Tensor) -> torch.Tensor:
    """8-bit saturating ADC conversion (round half to even, then clip)."""
    return torch.clamp(torch.round(v), float(BSS2.adc_min),
                       float(BSS2.adc_max))


def requantize_5bit(adc_code: torch.Tensor, shift: int) -> torch.Tensor:
    """SIMD-CPU requantization of ADC results to 5-bit input activations
    (paper §II-A: subtract V_reset, then bitwise right shifts): floor
    division by ``2**shift``, clipped onto [0, 31]."""
    return torch.clamp(torch.floor(adc_code / float(1 << shift)), 0.0,
                       float(BSS2.a_max))
