"""The analog-inference execution backend: BSS-2 VMM semantics as PyTorch
functions (a port of ``repro.core.analog``).

Faithful dataflow (paper Fig. 4 + §II-A + hxtorch row-split semantics):

    a_code  = clip(round(x / a_scale), 0, 31)                  # 5-bit events
    w_code  = clip(round(w / w_scale), -63, 63)                # 6-bit synapses
    w_eff   = w_code * (1 + fixed_pattern_gain)                # analog mismatch
    per 128-row chunk c:
        v_c   = gain * (a_chunk @ w_eff_chunk) + offset_c
        adc_c = clip(round(v_c), -128, 127)                    # saturating ADC
    y_int   = sum_c adc_c                                      # digital sum
    y       = y_int * a_scale * w_scale / gain  (+ bias)       # dequantize

``analog_faithful`` runs exactly the above; ``analog_fast`` accumulates
all chunks in fp32 and applies one saturating conversion at the end
(range scaled by the number of chunks).  In hardware-in-the-loop
training (paper §III-B) ``v_c`` also carries temporal readout noise, and
every round and clip passes a straight-through gradient: the forward
runs the noisy, saturating model, the backward its linearization onto
the float master weights.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import noise as noise_lib
from repro_torch.core import quant
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.hw import BSS2
from repro_torch.core.noise import NoiseConfig

Params = dict


@dataclasses.dataclass(frozen=True)
class AnalogConfig:
    """Execution configuration for analog layers (how to run, not what).

    ``use_kernels`` replaces the reference's ``use_pallas``: True routes
    the hot loop through the :mod:`repro_torch.kernels.ops` wrappers (the
    hand-written CUDA kernel for a CUDA tensor, its plain PyTorch version
    for a CPU tensor); False runs the reference's ``use_pallas=False``
    path (chunk scan for faithful mode, one matmul for fast mode), and
    only on the CPU: it exists so that both reference routes can be
    checked there, and a CUDA tensor under it raises.
    """

    mode: str = "analog_faithful"   # "digital" | "analog_faithful" | "analog_fast"
    signed_input: str = "split"     # "none" | "split" | "offset"
    act_calib: str = "dynamic"      # "dynamic" (per-call abs-max) | "static"
    chunk_rows: int = BSS2.signed_rows
    gain_headroom: float = 3.0      # sigma headroom against chunk saturation
    act_rms_codes: float = 9.0      # assumed RMS of activation codes (calib.)
    noise: NoiseConfig = dataclasses.field(default_factory=NoiseConfig)
    deterministic: bool = True      # no temporal readout noise (standalone mode)
    use_kernels: bool = True        # dispatch the hot loop to the kernels
    fused_split: bool = True        # one fused kernel for signed-split pairs
    fused_epilogue: bool = False    # emit ADC epilogues inside the kernel
    #                                 (inference-only; needs use_kernels)

    def replace(self, **kw) -> "AnalogConfig":
        return dataclasses.replace(self, **kw)


def check_route(cfg: AnalogConfig, t: torch.Tensor) -> None:
    """Raise when ``cfg.use_kernels`` is False and ``t`` lies on a CUDA
    device: the ``use_pallas=False`` arithmetic runs on the CPU only, so
    work on the card always goes through the kernels."""
    if not cfg.use_kernels and t.device.type == "cuda":
        raise ValueError(
            "AnalogConfig(use_kernels=False) runs on the CPU only; on a "
            "CUDA device the analog layers run through the kernels "
            "(use_kernels=True)")


def _pad_to_chunks(a_code: torch.Tensor, w_eff: torch.Tensor,
                   chunk_rows: int):
    k = a_code.shape[-1]
    pad = (-k) % chunk_rows
    if pad:
        a_code = torch.nn.functional.pad(a_code, (0, pad))
        w_eff = torch.nn.functional.pad(w_eff, (0, 0, 0, pad))
    return a_code, w_eff, (k + pad) // chunk_rows


def analog_matmul(
    a_code: torch.Tensor,
    w_eff: torch.Tensor,
    gain: torch.Tensor,
    chunk_offset,
    cfg: AnalogConfig,
    *,
    noise=None,
) -> torch.Tensor:
    """Chunked saturating analog VMM.  Returns integer-valued float
    [..., N] (the digitally accumulated ADC codes).

    a_code: [..., K] integer-valued float in [0, 31]
    w_eff:  [K, N] effective analog weights (quantized codes x fp gain)
    gain:   scalar or [N] analog gain (code domain)
    chunk_offset: [C, N] fixed-pattern ADC offsets or None
    noise:  temporal readout noise: None (deterministic readout), a
            ``torch.Generator`` on ``a_code``'s device to draw it from,
            or an injected draw (:func:`repro_torch.core.noise.readout_noise`)
            of shape ``[..., C, N]`` (faithful) or ``[..., N]`` (fast).

    Routes (the reference's): the kernels when ``cfg.use_kernels`` and
    the readout is deterministic or noiseless; else fast mode's one
    matmul, or faithful mode's chunk scan (:class:`_FaithfulMM`,
    deterministic) or per-chunk noisy readout.  Every route carries the
    hardware-in-the-loop gradient (paper §III-B).
    """
    check_route(cfg, a_code)
    a_code, w_eff, n_chunks = _pad_to_chunks(a_code, w_eff, cfg.chunk_rows)
    n = w_eff.shape[-1]
    batch_shape = a_code.shape[:-1]
    gain = torch.as_tensor(gain, dtype=torch.float32, device=w_eff.device)

    if cfg.use_kernels and (cfg.deterministic or noise is None):
        from repro_torch.kernels import ops as kernel_ops

        y2 = kernel_ops.analog_mvm(
            a_code.reshape(-1, a_code.shape[-1]), w_eff,
            torch.broadcast_to(gain, (n,)), chunk_offset,
            chunk_rows=cfg.chunk_rows, faithful=cfg.mode != "analog_fast",
        )
        return y2.reshape(batch_shape + (n,))

    dev = a_code.device
    if cfg.mode == "analog_fast":
        # one matmul over all chunks, a single final saturation with the
        # accumulated range (C * [-128, 127])
        v = torch.matmul(a_code, w_eff) * gain
        if chunk_offset is not None:
            v = v + chunk_offset.sum(dim=0)
        rn = noise_lib.readout_noise(noise, batch_shape + (n,), cfg.noise,
                                     device=dev)
        if rn is not None:
            v = v + rn * math.sqrt(float(n_chunks))
        lo = float(BSS2.adc_min) * n_chunks
        hi = float(BSS2.adc_max) * n_chunks
        return quant._clip_ste(quant._round_ste(v), lo, hi)

    rn = noise_lib.readout_noise(noise, batch_shape + (n_chunks, n),
                                 cfg.noise, device=dev)
    if rn is None:
        return _FaithfulMM.apply(a_code, w_eff, gain, chunk_offset,
                                 cfg.chunk_rows)
    # noisy faithful readout: every chunk's partial sum digitized on its
    # own, with its own noise draw, before the digital sum
    cr = cfg.chunk_rows
    a_c = a_code.reshape(-1, n_chunks, cr).transpose(0, 1)     # [C, M, cr]
    v = torch.matmul(a_c, w_eff.reshape(n_chunks, cr, n))      # [C, M, N]
    v = v.transpose(0, 1).reshape(batch_shape + (n_chunks, n)) * gain
    if chunk_offset is not None:
        v = v + chunk_offset
    adc = quant.adc_readout(v + rn)
    return adc.sum(dim=-2)


class _FaithfulMM(torch.autograd.Function):
    """Deterministic faithful VMM, chunk by chunk with an O([..., N]) live
    set (the reference's chunk scan, ``_faithful_mm``), whose backward is
    the HIL linearization ``y ~= gain * (a @ w_eff)``: rounding and
    saturation are not differentiated, gain and offsets are frozen
    calibration state (zero gradient)."""

    @staticmethod
    def forward(ctx, a_code, w_eff, gain, chunk_offset, chunk_rows):
        ctx.save_for_backward(a_code, w_eff, gain)
        n = w_eff.shape[-1]
        acc = torch.zeros(a_code.shape[:-1] + (n,), dtype=torch.float32,
                          device=a_code.device)
        for c in range(a_code.shape[-1] // chunk_rows):
            rows = slice(c * chunk_rows, (c + 1) * chunk_rows)
            v = torch.matmul(a_code[..., rows], w_eff[rows]) * gain
            if chunk_offset is not None:
                v = v + chunk_offset[c]
            acc = acc + quant.adc_readout(v)
        return acc

    @staticmethod
    def backward(ctx, g):
        a_code, w_eff, gain = ctx.saved_tensors
        gg = (g * gain).to(torch.float32)
        da = torch.matmul(gg, w_eff.t())
        dw = torch.matmul(a_code.reshape(-1, a_code.shape[-1]).t(),
                          gg.reshape(-1, gg.shape[-1]))
        return (da.to(a_code.dtype), dw.to(w_eff.dtype),
                torch.zeros_like(gain), None, None)


def analog_linear_init(
    generator: torch.Generator,
    in_dim: int,
    out_dim: int,
    *,
    bias: bool = False,
    noise: NoiseConfig = NoiseConfig(),
    chunk_rows: int = BSS2.signed_rows,
    w_init_scale: float = 1.0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> Params:
    """Initialize master weights, static quantization scales, the analog
    gain and the frozen fixed-pattern noise for one logical linear layer.

    Draws come from ``generator`` (on its own device) and the tensors are
    placed on ``device`` (``None`` = the CUDA device)."""
    dev = resolve_device(device)
    std = w_init_scale / math.sqrt(in_dim)
    w = (std * noise_lib._normal(generator, (in_dim, out_dim), dev)).to(dtype)
    w32 = w.to(torch.float32)
    n_chunks = -(-in_dim // chunk_rows)
    params = {
        "w": w,
        "w_scale": quant.calibrate_weight_scale(w32),
        # activation scale: static, recalibratable
        "a_scale": torch.tensor(1.0 / BSS2.a_max, dtype=torch.float32,
                                device=dev),
        "gain": _statistical_gain(w32, chunk_rows),
    }
    if bias:
        params["b"] = torch.zeros((out_dim,), dtype=dtype, device=dev)
    fpn = noise_lib.init_fixed_pattern(generator, in_dim, out_dim, n_chunks,
                                       noise, device=dev)
    if fpn:
        params["fpn"] = fpn
    return params


def _statistical_gain(w: torch.Tensor, chunk_rows: int,
                      act_rms: float = 9.0,
                      headroom: float = 3.0) -> torch.Tensor:
    """Analog gain so that ``headroom`` sigmas of the typical chunk partial
    sum stay inside the 8-bit ADC range (per-layer calibration)."""
    w_scale = quant.calibrate_weight_scale(w)
    # the mean as the reference's XLA program takes it: the sum times the
    # fp32 reciprocal of the count (torch.mean divides by the count)
    sq = (w / w_scale) ** 2
    inv = torch.tensor(1.0 / sq.numel(), dtype=torch.float32, device=w.device)
    w_code_rms = torch.sqrt(torch.sum(sq) * inv + 1e-6)
    # fp32 throughout, in the reference's operation order
    root = torch.sqrt(torch.tensor(float(chunk_rows), dtype=torch.float32,
                                   device=w.device))
    partial_rms = root * act_rms * w_code_rms
    # a tensor numerator: PyTorch divides a Python number by a tensor as
    # a product with the tensor's reciprocal (not correctly rounded)
    top = torch.tensor(float(BSS2.adc_max), dtype=torch.float32,
                       device=w.device)
    return torch.clamp_max(top / (headroom * partial_rms + 1e-6), 1.0)
