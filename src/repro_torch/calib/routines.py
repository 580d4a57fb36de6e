"""Measurement-driven calibration routines (measure -> fit, blind; port of
``repro.calib.routines``).

The three fits of the BSS-2 calibration pipeline (paper §III-B), written
against the opaque :class:`repro_torch.calib.device.VirtualChip`
interface - no routine here ever sees ground-truth deviations:

1. **offset nulling** (:func:`null_offsets`): zero weights, zero events -
   each chunk pass reads back its ADC offset plus readout noise; the
   average over repeats recovers the offset below one LSB (the readout
   noise dithers the ADC rounding).
2. **gain fit** (:func:`fit_gain_table`): per chunk, a unit weight probe
   on that chunk's rows and a linearity ramp of input levels; the
   least-squares slope of ADC code against level per column, normalized
   by the probe, is that (chunk, column)'s gain.
3. **activation scaling** (:func:`fit_activation_scales` /
   :func:`share_group_input_scale`): static per-layer input LSBs from a
   calibration batch through the (offset + gain)-calibrated chain;
   fused dispatch groups share one input encoding (``a_scale_in``).

:func:`calibrate_model` drives all three over every analog layer of a
:class:`repro_torch.api.module.ModuleSpec` and returns the
:class:`~repro_torch.calib.snapshot.CalibrationSnapshot` that
``api.compile(spec, params, run, calibration=...)`` consumes.  Every
measurement runs on the chips' device; the divisions by Python numbers
divide exactly there (:func:`repro_torch.core.quant._div_exact`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.calib.device import VirtualChip
from repro_torch.calib.snapshot import CalibrationSnapshot, LayerCalibration
from repro_torch.core import quant
from repro_torch.core.hw import BSS2
from repro_torch.core.noise import NoiseConfig

# ramp levels for the linearity sweep: spread over the 5-bit range,
# avoiding the extremes (0 carries no signal; 31 sits closest to ADC
# saturation for high-gain columns)
DEFAULT_RAMP = (2, 6, 10, 14, 18, 22, 26, 30)


def probe_gain(chunk_rows: int, headroom: float = 0.8) -> float:
    """Requested analog gain for the ramp sweep: the top ramp level on a
    full unit-weight chunk lands at ``headroom`` of the ADC range, so no
    column saturates even with fixed-pattern gain spread."""
    return headroom * float(BSS2.adc_max) / (float(BSS2.a_max) * chunk_rows)


def null_offsets(chip: VirtualChip, *, repeats: int = 64) -> torch.Tensor:
    """Measure the per-(chunk, column) ADC offsets: zero weights, zero
    events, average ``repeats`` passes.  Returns [C, N]."""
    f32 = dict(dtype=torch.float32, device=chip.device)
    w = torch.zeros((chip.k, chip.n), **f32)
    a = torch.zeros((repeats, chip.k), **f32)
    adc = chip.measure(w, a)                       # [R, C, N]
    return adc.mean(dim=0)


def _chunk_rows_real(chip: VirtualChip, c: int) -> int:
    hi = min(chip.k, (c + 1) * chip.chunk_rows)
    return hi - c * chip.chunk_rows


def fit_gain_chunk(
    chip: VirtualChip,
    c: int,
    *,
    levels: Sequence[int] = DEFAULT_RAMP,
    repeats: int = 8,
) -> torch.Tensor:
    """One chunk's linearity-ramp gain fit (ONE measurement): unit
    weights on chunk ``c``'s rows only, events ramped over ``levels``
    (each level measured ``repeats`` times), least-squares slope per
    column.  Returns [N] unitless multipliers (1.0 = nominal).  The unit
    of :class:`~repro_torch.calib.monitor.DriftMonitor`'s background gain
    sweep."""
    f32 = dict(dtype=torch.float32, device=chip.device)
    g = probe_gain(chip.chunk_rows)
    alphas = torch.tensor(levels, **f32)
    lo, hi = c * chip.chunk_rows, min(chip.k, (c + 1) * chip.chunk_rows)
    w = torch.zeros((chip.k, chip.n), **f32)
    w[lo:hi] = 1.0
    a = torch.zeros((len(levels), repeats, chip.k), **f32)
    a[:, :, lo:hi] = alphas[:, None, None]
    adc = chip.measure(w, a, gain=g)[..., c, :]  # [L, R, N]
    y = adc.mean(dim=1)                          # [L, N]
    da = alphas - alphas.mean()
    slope = (da[:, None] * (y - y.mean(dim=0))).sum(0) / (da ** 2).sum()
    return quant._div_exact(slope, g * _chunk_rows_real(chip, c))


def fit_gain_table(
    chip: VirtualChip,
    *,
    levels: Sequence[int] = DEFAULT_RAMP,
    repeats: int = 8,
) -> torch.Tensor:
    """The per-(chunk, column) fixed-pattern gain by linearity ramp
    sweeps, one :func:`fit_gain_chunk` per chunk.  Returns [C, N]
    unitless multipliers (1.0 = nominal): the probe gain cancels in the
    normalization, offsets in the slope, readout noise and ADC rounding
    average out over the sweep."""
    return torch.stack([
        fit_gain_chunk(chip, c, levels=levels, repeats=repeats)
        for c in range(chip.n_chunks)
    ], dim=0)


def calibrate_chip(
    chip: VirtualChip,
    *,
    offset_repeats: int = 64,
    gain_levels: Sequence[int] = DEFAULT_RAMP,
    gain_repeats: int = 8,
) -> LayerCalibration:
    """Full blind calibration of one chip: offset nulling + gain fit."""
    return LayerCalibration(
        gain_table=fit_gain_table(
            chip, levels=gain_levels, repeats=gain_repeats
        ),
        chunk_offset=null_offsets(chip, repeats=offset_repeats),
    )


# --------------------------------------------------------------------------
# activation scaling (model-level: needs the layer chain, not one chip)
# --------------------------------------------------------------------------
def fit_activation_scales(
    spec,
    params,
    acfg,
    snapshot: CalibrationSnapshot,
    sample: torch.Tensor,
    *,
    pct: float = 99.9,
) -> CalibrationSnapshot:
    """Static activation-scale calibration for a STACK spec: run the
    calibration batch through the chain lowered from the (offset + gain)
    snapshot under dynamic calibration, and fit a percentile-robust
    static LSB for every layer that consumes float activations (layers
    fed 5-bit codes keep ``a_scale=None``).  ``sample`` is the input of
    the FIRST analog layer (after host preprocessing such as the ECG
    im2col), on the parameters' device."""
    from repro_torch.exec.plan import EPILOGUE_NONE, EPILOGUE_RELU_SHIFT
    from repro_torch.exec.run import run_layer

    acfg = getattr(acfg, "analog", acfg)
    if spec.kind != "stack":
        raise ValueError(
            "activation-scale calibration walks a layer chain; tree "
            "specs keep their per-layer static scales"
        )
    plan = _lower_stack_from_spec(
        spec, params, acfg.replace(act_calib="dynamic"), snapshot
    )
    h = sample.to(torch.float32)
    is_codes = plan.expects_codes
    out = snapshot
    n = len(plan.layers)
    with torch.no_grad():
        for i, (layer, lp) in enumerate(zip(spec.layers, plan.layers)):
            if not is_codes:
                rec = out.layer(layer.name) or LayerCalibration()
                out = out.with_layer(layer.name, rec.replace(
                    a_scale=quant.calibrate_act_scale(h, pct)
                ))
            h = run_layer(lp, h, plan.cfg, x_is_codes=is_codes)
            if lp.epilogue == EPILOGUE_NONE and i < n - 1:
                h = torch.relu(h)
                is_codes = False
            else:
                is_codes = lp.epilogue == EPILOGUE_RELU_SHIFT
            if lp.flatten_out:
                h = h.reshape(h.shape[:-2] + (-1,))
    return out


def share_group_input_scale(
    snapshot: CalibrationSnapshot,
    names: Sequence[str],
    *,
    scales: Optional[Sequence] = None,
) -> CalibrationSnapshot:
    """Give a fused dispatch group ONE physical input encoding: set every
    member's ``a_scale_in`` to the widest member scale (no member's range
    is truncated), keeping each member's own ``a_scale``.  ``scales``
    overrides the per-member scales when the snapshot does not carry
    them.  Both concat kinds take it (``names`` from
    ``spec.group(name).members``): a ``column_concat`` group needs the
    shared LSB to fuse at all under static activation calibration; a
    ``batch_concat`` group fuses either way (each member encodes at its
    own scale), and a shared ``a_scale_in`` gives the whole fused pass
    one event LSB.  ``expert_stack`` groups keep dynamic activation
    scaling and take no part."""
    if scales is None:
        scales = []
        for name in names:
            rec = snapshot.layer(name)
            if rec is None or rec.a_scale is None:
                raise ValueError(
                    f"no calibrated a_scale for group member {name!r}; "
                    "pass scales= explicitly"
                )
            scales.append(rec.a_scale)
    scales = [torch.as_tensor(s, dtype=torch.float32) for s in scales]
    shared = torch.max(torch.stack(scales))
    out = snapshot
    for name, s in zip(names, scales):
        rec = out.layer(name) or LayerCalibration()
        out = out.with_layer(name, rec.replace(a_scale=s, a_scale_in=shared))
    return out


# --------------------------------------------------------------------------
# whole-model drive
# --------------------------------------------------------------------------
def _stack_layer_params(spec, params):
    from repro_torch.api.compile import _stack_params

    return _stack_params(spec, params)


def _lower_stack_from_spec(spec, params, acfg, snapshot):
    from repro_torch.exec.lower import lower_stack

    return lower_stack(
        _stack_layer_params(spec, params), acfg,
        signed_inputs=[layer.signed_input for layer in spec.layers],
        epilogues=[layer.epilogue for layer in spec.layers],
        flatten_outs=[layer.flatten_out for layer in spec.layers],
        input_domain=spec.input_domain,
        calibs=[snapshot.layer(layer.name) for layer in spec.layers],
    )


def chip_generator(generator: torch.Generator, i: int,
                   device: torch.device) -> torch.Generator:
    """The readout-noise generator of chip ``i`` of a model, on
    ``device``: seeded from ``generator``'s seed and ``i`` (no draw, so
    making it costs no device round trip)."""
    seed = (generator.initial_seed() * 1_000_003 + i + 1) % (1 << 63)
    return torch.Generator(device=device).manual_seed(seed)


def model_chips(
    spec,
    params,
    generator: torch.Generator,
    *,
    noise: NoiseConfig = NoiseConfig(),
    chunk_rows: int = BSS2.signed_rows,
) -> Dict[str, VirtualChip]:
    """One :class:`VirtualChip` per analog layer of the model, on the
    parameters' device, wrapping that layer's frozen deviations
    (``params[...]["fpn"]``) as the hidden device state, each with its
    own readout-noise generator (:func:`chip_generator`).  Keys are spec
    layer names (stack) or dotted tree paths (tree) - the names the
    snapshot uses."""
    from repro_torch.api.compile import iter_analog_layers

    if spec.kind == "stack":
        named = list(zip([layer.name for layer in spec.layers],
                         _stack_layer_params(spec, params)))
    else:
        named = [
            (path, node) for path, node in iter_analog_layers(params)
            if node["w"].ndim == 2        # scan-stacked layers: no chip
        ]
    return {
        name: VirtualChip.from_params(
            p, chip_generator(generator, i, p["w"].device), noise=noise,
            chunk_rows=chunk_rows,
        )
        for i, (name, p) in enumerate(named)
    }


def calibrate_model(
    spec,
    params,
    generator: torch.Generator,
    *,
    acfg=None,
    chips: Optional[Dict[str, VirtualChip]] = None,
    noise: NoiseConfig = NoiseConfig(),
    sample: Optional[torch.Tensor] = None,
    offset_repeats: int = 64,
    gain_levels: Sequence[int] = DEFAULT_RAMP,
    gain_repeats: int = 8,
    source: str = "",
) -> CalibrationSnapshot:
    """Measure every analog layer's device and return the model's
    :class:`CalibrationSnapshot` - the measure -> fit half of the
    measure -> fit -> apply pipeline (apply = ``api.compile(...,
    calibration=snapshot)``).

    ``chips`` supplies the devices (default: :func:`model_chips` over the
    params' own frozen deviations, seeded from ``generator``).
    ``sample`` (stack specs, with ``acfg``) also fits static activation
    scales from a calibration batch.
    """
    if chips is None:
        chips = model_chips(spec, params, generator, noise=noise)
    snap = CalibrationSnapshot(source=source)
    for name, chip in chips.items():
        snap = snap.with_layer(name, calibrate_chip(
            chip, offset_repeats=offset_repeats,
            gain_levels=gain_levels, gain_repeats=gain_repeats,
        ))
    if sample is not None:
        if acfg is None:
            raise ValueError("sample-based activation scaling needs acfg")
        snap = fit_activation_scales(spec, params, acfg, snap, sample)
    return snap
