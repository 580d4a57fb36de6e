"""CUDA kernel for the FPGA preprocessing hot loop (paper Fig. 7):
non-overlapping max-min window pooling over the derivative signal.

``csrc/maxmin_pool.cu`` replaces the TPU kernel
``repro/kernels/preproc.py::maxmin_pool_pallas``: 16-byte loads, a group
of ``window / 4`` lanes per window, several windows' loads in flight per
thread before the shuffle reductions, and no [.., T/32, 32] reshape
materialized in device memory.  The plain version is
:func:`repro_torch.kernels.ref.maxmin_pool_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_build.declare("maxmin_pool", (ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_longlong, ctypes.c_int))


def maxmin_pool_cuda(x: torch.Tensor, *, window: int = 32) -> torch.Tensor:
    """[rows, T] float32 on a CUDA device -> [rows, T // window].

    The kernel reads each window as ``window / 4`` float4 loads, so the
    window is 4 times a power of two up to 128 samples, and ``x`` starts
    on a 16-byte boundary (each row then does too: T is a multiple of
    the window)."""
    if x.device.type != "cuda":
        raise ValueError(f"maxmin_pool_cuda needs a CUDA tensor, got {x.device}")
    lanes = window // 4
    if window % 4 or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"window {window} is not 4 x a power of two <= 128")
    if x.dim() != 2 or x.shape[1] % window:
        raise ValueError(f"expected [rows, T] with T % {window} == 0, got "
                         f"{tuple(x.shape)}")
    rows, t = x.shape
    _build.check_operand("x", x, x.device, (rows, t))
    if x.data_ptr() % 16:
        raise ValueError("x does not start on a 16-byte boundary (the kernel "
                         "reads float4)")
    out = torch.empty((rows, t // window), dtype=torch.float32,
                      device=x.device)
    _build.launch("maxmin_pool", x.device, x.data_ptr(), out.data_ptr(),
                  rows * (t // window), window)
    return out
