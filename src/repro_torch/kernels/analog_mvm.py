"""CUDA kernel for the BSS-2 analog VMM emulation: every analog-mapped
linear layer reduces to chunked saturating ``[M, K] x [K, N]`` matmuls.

``csrc/analog_mvm.cu`` replaces the TPU kernel
``repro/kernels/analog_mvm.py::analog_mvm_pallas``: per 128-row chunk a
dot, the analog gain and the fixed-pattern offset, an 8-bit ADC
round/clip (faithful) and the digital accumulation, with the optional
``relu_shift`` epilogue fused into the store.  The chunk loop runs inside
each output-tile block (the TPU's sequential grid axis has no Hopper
counterpart: blocks run in parallel and share nothing).  fp32 operands
and accumulation; M and N are masked, not padded.  The plain version is
:func:`repro_torch.kernels.ref.analog_mvm_ref` (+ ``adc_epilogue_ref``).

``csrc/analog_mvm_split.cu`` replaces ``analog_mvm_split_pallas``: the
signed-split pair ``mvm(a_pos) - mvm(a_neg)`` in one launch, each weight
slice staged once for both passes, each pass rounded and clipped on its
own; plain version :func:`repro_torch.kernels.ref.analog_mvm_split_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.hw import BSS2
from repro_torch.kernels import _build

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def _epilogue_shift(epilogue) -> int:
    """The kernels' ``shift`` argument: -1 for no epilogue."""
    if epilogue is None:
        return -1
    kind, shift = epilogue
    if kind != "relu_shift" or not 0 <= shift < 31:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return shift


def _chunk_offsets(chunk_offset, n_chunks, n, dev):
    if chunk_offset is None:
        return torch.zeros((n_chunks, n), dtype=torch.float32, device=dev)
    return chunk_offset


def analog_mvm_cuda(
    a_code: torch.Tensor,                  # [M, K]
    w_eff: torch.Tensor,                   # [K, N]
    gain: torch.Tensor,                    # [N]
    chunk_offset: Optional[torch.Tensor],  # [C, N] or None
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
    epilogue=None,                         # None | ("relu_shift", shift)
) -> torch.Tensor:
    """Launch the chunked saturating analog VMM on the CUDA device."""
    dev = a_code.device
    if dev.type != "cuda":
        raise ValueError(f"analog_mvm_cuda needs CUDA tensors, got {dev}")
    m, k = a_code.shape
    n = w_eff.shape[1]
    if k % chunk_rows or chunk_rows % 32:
        raise ValueError(f"K={k} must be a multiple of chunk_rows="
                         f"{chunk_rows}, itself a multiple of 32")
    n_chunks = k // chunk_rows
    chunk_offset = _chunk_offsets(chunk_offset, n_chunks, n, dev)
    shift = _epilogue_shift(epilogue)
    for name, t, shape in (("a_code", a_code, (m, k)),
                           ("w_eff", w_eff, (k, n)), ("gain", gain, (n,)),
                           ("chunk_offset", chunk_offset, (n_chunks, n))):
        _build.check_operand(name, t, dev, shape)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(
            "analog_mvm", _ARGTYPES, _build.ptr(a_code), _build.ptr(w_eff),
            _build.ptr(gain), _build.ptr(chunk_offset), _build.ptr(out),
            m, k, n, chunk_rows, int(faithful), shift,
            _build.current_stream(dev),
        )
    return out


_SPLIT_ARGTYPES = (ctypes.c_void_p,) + _ARGTYPES


def analog_mvm_split_cuda(
    a_pos: torch.Tensor,                   # [M, K] codes of max(x, 0)
    a_neg: torch.Tensor,                   # [M, K] codes of max(-x, 0)
    w_eff: torch.Tensor,                   # [K, N]
    gain: torch.Tensor,                    # [N]
    chunk_offset: Optional[torch.Tensor],  # [C, N] or None
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
    epilogue=None,                         # None | ("relu_shift", shift)
) -> torch.Tensor:
    """Launch the signed-split analog VMM ``mvm(a_pos) - mvm(a_neg)`` on
    the CUDA device."""
    dev = a_pos.device
    if dev.type != "cuda":
        raise ValueError(
            f"analog_mvm_split_cuda needs CUDA tensors, got {dev}")
    m, k = a_pos.shape
    n = w_eff.shape[1]
    if k % chunk_rows or chunk_rows % 32:
        raise ValueError(f"K={k} must be a multiple of chunk_rows="
                         f"{chunk_rows}, itself a multiple of 32")
    n_chunks = k // chunk_rows
    chunk_offset = _chunk_offsets(chunk_offset, n_chunks, n, dev)
    shift = _epilogue_shift(epilogue)
    for name, t, shape in (("a_pos", a_pos, (m, k)), ("a_neg", a_neg, (m, k)),
                           ("w_eff", w_eff, (k, n)), ("gain", gain, (n,)),
                           ("chunk_offset", chunk_offset, (n_chunks, n))):
        _build.check_operand(name, t, dev, shape)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(
            "analog_mvm_split", _SPLIT_ARGTYPES, _build.ptr(a_pos),
            _build.ptr(a_neg), _build.ptr(w_eff), _build.ptr(gain),
            _build.ptr(chunk_offset), _build.ptr(out), m, k, n, chunk_rows,
            int(faithful), shift, _build.current_stream(dev),
        )
    return out
