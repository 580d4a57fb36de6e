"""CUDA kernel for the FPGA preprocessing hot loop (paper Fig. 7):
non-overlapping max-min window pooling over the derivative signal.

``csrc/maxmin_pool.cu`` replaces the TPU kernel
``repro/kernels/preproc.py::maxmin_pool_pallas``: one warp per output
window, a coalesced load of the window and a shuffle reduction, with no
[.., T/32, 32] reshape materialized in device memory.  The plain version
is :func:`repro_torch.kernels.ref.maxmin_pool_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)


def maxmin_pool_cuda(x: torch.Tensor, *, window: int = 32) -> torch.Tensor:
    """[rows, T] float32 on a CUDA device -> [rows, T // window]."""
    if x.device.type != "cuda":
        raise ValueError(f"maxmin_pool_cuda needs a CUDA tensor, got {x.device}")
    if x.dim() != 2 or x.shape[1] % window:
        raise ValueError(f"expected [rows, T] with T % {window} == 0, got "
                         f"{tuple(x.shape)}")
    rows, t = x.shape
    _build.check_operand("x", x, x.device, (rows, t))
    out = torch.empty((rows, t // window), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        _build.launch("maxmin_pool", _ARGTYPES, _build.ptr(x),
                      _build.ptr(out), rows, t, window,
                      _build.current_stream(x.device))
    return out
