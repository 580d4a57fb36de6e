"""Plain PyTorch versions of the kernels (ports of ``repro.kernels.ref``).

Each is the forward reference semantics of one CUDA kernel: the wrappers
in :mod:`repro_torch.kernels.ops` run them for CPU tensors, and the chip
smoke test holds every kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.hw import BSS2


def analog_mvm_ref(
    a_code: torch.Tensor,                 # [M, K] integer-valued float, 0..31
    w_eff: torch.Tensor,                  # [K, N] effective analog weights
    gain: torch.Tensor,                   # [N] or scalar
    chunk_offset: Optional[torch.Tensor],  # [C, N] or None
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
) -> torch.Tensor:
    """Chunked saturating analog VMM.  K must divide into chunks."""
    m, k = a_code.shape
    n = w_eff.shape[1]
    if k % chunk_rows:
        raise ValueError(f"K={k} is not a multiple of chunk_rows={chunk_rows}")
    c = k // chunk_rows
    a_c = a_code.reshape(m, c, chunk_rows).to(torch.float32)
    w_c = w_eff.reshape(c, chunk_rows, n).to(torch.float32)
    v = torch.einsum("mck,ckn->mcn", a_c, w_c)
    v = v * gain
    if chunk_offset is not None:
        v = v + chunk_offset[None, :, :]
    if faithful:
        adc = torch.clamp(torch.round(v), BSS2.adc_min, BSS2.adc_max)
        return adc.sum(dim=1)
    total = v.sum(dim=1)
    return torch.clamp(torch.round(total), BSS2.adc_min * c, BSS2.adc_max * c)


def analog_mvm_split_ref(
    a_pos: torch.Tensor,
    a_neg: torch.Tensor,
    w_eff: torch.Tensor,
    gain: torch.Tensor,
    chunk_offset: Optional[torch.Tensor],
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
) -> torch.Tensor:
    """Two-pass signed split: the positive and the negative activation
    parts as two independent analog runs on the same tiles, subtracted
    digitally (the semantics the fused kernel reproduces)."""
    yp = analog_mvm_ref(a_pos, w_eff, gain, chunk_offset,
                        chunk_rows=chunk_rows, faithful=faithful)
    yn = analog_mvm_ref(a_neg, w_eff, gain, chunk_offset,
                        chunk_rows=chunk_rows, faithful=faithful)
    return yp - yn


def adc_epilogue_ref(y_int: torch.Tensor, epilogue) -> torch.Tensor:
    """ADC epilogue (paper §II-A): ReLU at the readout + right-shift
    requantization onto 5-bit codes; ``epilogue`` is None or
    ``("relu_shift", shift)``."""
    if epilogue is None:
        return y_int
    kind, shift = epilogue
    if kind != "relu_shift":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    y = torch.clamp_min(y_int, 0.0)
    y = torch.floor(y / float(1 << shift))
    return torch.clamp(y, 0.0, float(BSS2.a_max))


def analog_plan_ref(
    x_in: torch.Tensor,         # [B * m_mult0, k0_pad] 5-bit codes
    w_cat: torch.Tensor,        # [sum(k_pad), n_max] packed weights
    gain_all: torch.Tensor,     # [L, n_max] per-layer gains
    off_cat: torch.Tensor,      # [sum(n_chunks), n_max] offsets
    schedule,                   # tuple of MegaLayerMeta
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
) -> torch.Tensor:
    """A whole packed layer chain, code-domain subset: every layer
    consumes 5-bit codes (encode ``"codes"``), hands codes on (``"codes"``,
    with the optional ``flatten`` position merge) and the last layer
    returns its raw accumulated ADC codes (``"raw"``), shape
    ``[B * m_mult_last, n_last]``.  Same per-chunk arithmetic and op order
    as the per-layer route."""
    h = x_in.to(torch.float32)
    last = len(schedule) - 1
    for li, meta in enumerate(schedule):
        if meta.encode != "codes" or meta.handoff not in ("codes", "raw"):
            raise ValueError(
                f"layer {li}: encode {meta.encode!r} / hand-off "
                f"{meta.handoff!r} is outside the code-domain schedule"
            )
        w_l = w_cat[meta.row0:meta.row0 + meta.k_pad, :meta.n]
        gain = gain_all[li, :meta.n]
        acc = torch.zeros((h.shape[0], meta.n), dtype=torch.float32,
                          device=h.device)
        for c in range(meta.n_chunks):
            v = torch.matmul(h[:, c * chunk_rows:(c + 1) * chunk_rows],
                             w_l[c * chunk_rows:(c + 1) * chunk_rows])
            v = v * gain + off_cat[meta.c0 + c, :meta.n]
            if faithful:
                v = torch.clamp(torch.round(v), BSS2.adc_min, BSS2.adc_max)
            acc = acc + v
        if not faithful:
            lo = float(BSS2.adc_min) * meta.n_chunks
            hi = float(BSS2.adc_max) * meta.n_chunks
            acc = torch.clamp(torch.round(acc), lo, hi)
        if li == last:
            return acc
        codes = torch.clamp_min(acc, 0.0)
        codes = torch.clamp(torch.floor(codes / float(1 << meta.shift)), 0.0,
                            float(BSS2.a_max))
        if meta.flatten > 1:
            codes = codes.reshape(codes.shape[0] // meta.flatten,
                                  meta.flatten * meta.n)
        pad = schedule[li + 1].k_pad - codes.shape[1]
        if pad:
            codes = torch.nn.functional.pad(codes, (0, pad))
        h = codes
    return acc


def maxmin_pool_ref(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """FPGA preprocessing pooling (paper Fig. 7): per non-overlapping
    window, max - min.  x: [..., T] with T % window == 0 -> [..., T/window]."""
    t = x.shape[-1]
    if t % window:
        raise ValueError(f"T={t} is not a multiple of window={window}")
    xw = x.reshape(x.shape[:-1] + (t // window, window))
    return xw.amax(dim=-1) - xw.amin(dim=-1)
