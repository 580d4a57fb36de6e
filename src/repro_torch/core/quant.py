"""Quantizers for the BSS-2 datapath (paper Fig. 4) with straight-through
estimators for hardware-in-the-loop training (paper §III-B).

- activations: 5-bit unsigned pulse lengths, values in [0, 31]
- weights:     6-bit signed synaptic weights, values in [-63, 63]
- ADC:         8-bit signed readout, values in [-128, 127]

Mirrors ``repro.core.quant`` value for value (round half to even, the
same divide-then-round order) and gradient for gradient: the rounds pass
the gradient straight through, and the clips pass it inside the range,
mask it outside, and pass HALF of it at exactly ``lo`` or ``hi`` - the
tie rule of ``jnp.clip`` and ``jnp.maximum``, where ``torch.clamp``
passes all of it.  Activation codes sit exactly at 0 all the time, so
the tie rule matters.

A tensor that does not require grad takes the plain ops (the serve
path): the straight-through forms give the same values bit for bit
(``v + (round(v) - v)`` is exact in fp32), so only the op count differs.
"""
from __future__ import annotations

import torch

from repro_torch.core.hw import BSS2


def _round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with a straight-through gradient."""
    if not x.requires_grad:
        return torch.round(x)
    return x + (torch.round(x) - x).detach()


def _floor_ste(x: torch.Tensor) -> torch.Tensor:
    """Floor with a straight-through gradient."""
    if not x.requires_grad:
        return torch.floor(x)
    return x + (torch.floor(x) - x).detach()


def _tie_mask(x: torch.Tensor, lo: float, hi=None) -> torch.Tensor:
    """The gradient factor of a clip onto [lo, hi] (``hi=None``: no upper
    bound): 1 strictly inside, 0.5 at exactly a bound, 0 outside."""
    m = torch.ones_like(x)
    m = torch.where(x > lo, m, torch.where(x == lo, 0.5 * m, 0.0 * m))
    if hi is not None:
        m = torch.where(x < hi, m, torch.where(x == hi, 0.5 * m, 0.0 * m))
    return m


class _ClipSTE(torch.autograd.Function):
    """``clamp`` forward; ``jnp.clip``'s gradient backward (1 inside, 0.5
    at a bound, 0 outside).  The forward keeps that factor, not ``x``,
    for the backward: twice the factor as uint8, a quarter of ``x``'s
    bytes (the weight quantizer of a full-size LM saves one per weight
    every training step)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward((2 * _tie_mask(x, lo, hi)).to(torch.uint8))
        if hi is None:
            return torch.clamp_min(x, lo)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (m2,) = ctx.saved_tensors
        return g * (m2.to(g.dtype) * 0.5), None, None


def _clip_ste(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clip onto [lo, hi] whose gradient is masked outside the range and
    halved at exactly ``lo`` or ``hi`` (``jnp.clip``; never
    ``torch.clamp``, which passes the whole gradient at a bound)."""
    if not x.requires_grad:
        return torch.clamp(x, lo, hi)
    return _ClipSTE.apply(x, lo, hi)


def _maximum0(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` with ``jnp.maximum(x, 0.0)``'s gradient: 1 above 0,
    0.5 at exactly 0, 0 below (``torch.relu`` gives 0 at 0, the rule of
    ``jax.nn.relu``)."""
    if not x.requires_grad:
        return torch.clamp_min(x, 0.0)
    return _ClipSTE.apply(x, 0.0, None)


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """5-bit unsigned codes (float dtype, integer values):
    ``clip(round(x / scale), 0, 31)``.  Negative inputs saturate at 0."""
    return _clip_ste(_round_ste(x / scale), 0.0, float(BSS2.a_max))


def dequantize_act(code: torch.Tensor, scale) -> torch.Tensor:
    return code * scale


def quantize_weight(w: torch.Tensor, scale) -> torch.Tensor:
    """6-bit signed codes (float dtype, integer values):
    ``clip(round(w / scale), -63, 63)``; ``scale`` broadcasts
    (per-output-column by default).  The gradient reaches both ``w`` and
    ``scale``."""
    return _clip_ste(_round_ste(w / scale), -float(BSS2.w_max),
                     float(BSS2.w_max))


def dequantize_weight(code: torch.Tensor, scale) -> torch.Tensor:
    return code * scale


_DIVISORS: dict = {}


def _div_exact(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d``, correctly rounded on every device.  PyTorch divides a
    CUDA tensor by a Python number as a product with the number's rounded
    reciprocal (up to 1 ulp off, where the CPU and the reference divide),
    so on the card the divisor goes in as a tensor (made once per
    device)."""
    if t.device.type == "cpu":
        return t / d
    key = (t.device, t.dtype, d)
    div = _DIVISORS.get(key)
    if div is None:
        div = _DIVISORS[key] = torch.tensor(d, dtype=t.dtype,
                                            device=t.device)
    return t / div


def act_scale_from_max(max_abs: torch.Tensor) -> torch.Tensor:
    """LSB so that ``max_abs`` maps to the top activation code."""
    return _div_exact(torch.clamp_min(max_abs, 1e-8), float(BSS2.a_max))


def calibrate_act_scale(x: torch.Tensor, pct: float = 99.9) -> torch.Tensor:
    """Percentile-calibrated activation scale (robust against outliers;
    linear interpolation between order statistics, as ``jnp.percentile``)."""
    hi = torch.quantile(x.detach().abs().reshape(-1).to(torch.float32),
                        pct / 100.0)
    return act_scale_from_max(hi)


def weight_scale_from_max(max_abs: torch.Tensor) -> torch.Tensor:
    """LSB so that ``max_abs`` maps to the top weight code."""
    return _div_exact(torch.clamp_min(max_abs, 1e-8), float(BSS2.w_max))


def calibrate_weight_scale(w: torch.Tensor,
                           per_column: bool = True) -> torch.Tensor:
    """Per-column (neuron) weight scale, matching per-neuron calibration."""
    wa = w.detach().abs()
    if per_column:
        return weight_scale_from_max(wa.amax(dim=0, keepdim=True))
    return weight_scale_from_max(wa.max())


def adc_readout(v: torch.Tensor) -> torch.Tensor:
    """8-bit saturating ADC conversion (round half to even, then clip),
    straight-through gradient masked outside the ADC range."""
    return _clip_ste(_round_ste(v), float(BSS2.adc_min),
                     float(BSS2.adc_max))


def requantize_5bit(adc_code: torch.Tensor, shift: int) -> torch.Tensor:
    """SIMD-CPU requantization of ADC results to 5-bit input activations
    (paper §II-A: subtract V_reset, then bitwise right shifts): floor
    division by ``2**shift`` (straight-through), clipped onto [0, 31]."""
    return _clip_ste(_floor_ste(adc_code / float(1 << shift)), 0.0,
                     float(BSS2.a_max))
