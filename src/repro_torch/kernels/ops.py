"""Public kernel wrappers with device dispatch (port of
``repro.kernels.ops``, forward only).

Each wrapper launches its hand-written CUDA kernel when the tensors lie
on a CUDA device and runs the plain PyTorch version of
:mod:`repro_torch.kernels.ref` when they lie on the CPU - and only then.
There is no fallback: a CUDA tensor whose kernel fails to build or to
launch raises.  Each kernel counts its launches
(:func:`launch_counts`, :func:`reset_launch_counts`), so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.hw import BSS2
from repro_torch.kernels import _build
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels.analog_mvm import analog_mvm_cuda
from repro_torch.kernels.analog_plan import analog_plan_cuda
from repro_torch.kernels.preproc import maxmin_pool_cuda

launch_counts = _build.launch_counts
reset_launch_counts = _build.reset_launch_counts


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return False


def _contiguous(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.contiguous()


def analog_mvm(
    a_code: torch.Tensor,
    w_eff: torch.Tensor,
    gain: torch.Tensor,
    chunk_offset: Optional[torch.Tensor],
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
    epilogue=None,
) -> torch.Tensor:
    """[M, K] x [K, N] chunked saturating analog VMM: raw ADC codes, or
    5-bit codes when ``epilogue=("relu_shift", shift)`` is fused into the
    kernel (the per-layer hot path of the plan executor)."""
    if _on_cuda(a_code):
        return analog_mvm_cuda(a_code.contiguous(), w_eff.contiguous(),
                               gain.contiguous(), _contiguous(chunk_offset),
                               chunk_rows=chunk_rows, faithful=faithful,
                               epilogue=epilogue)
    y = ref_lib.analog_mvm_ref(a_code, w_eff, gain, chunk_offset,
                               chunk_rows=chunk_rows, faithful=faithful)
    return ref_lib.adc_epilogue_ref(y, epilogue)


def analog_plan_codes(
    x_in: torch.Tensor,
    w_cat: torch.Tensor,
    gain_all: torch.Tensor,
    off_cat: torch.Tensor,
    *,
    schedule,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
) -> torch.Tensor:
    """Whole-plan dispatch of a code-domain chain: ONE kernel launch.
    Returns the final layer's raw accumulated ADC codes
    ``[B * m_last, n_last]``."""
    if _on_cuda(x_in):
        return analog_plan_cuda(x_in.contiguous(), w_cat.contiguous(),
                                gain_all.contiguous(), off_cat.contiguous(),
                                schedule=schedule, chunk_rows=chunk_rows,
                                faithful=faithful)
    return ref_lib.analog_plan_ref(x_in, w_cat, gain_all, off_cat, schedule,
                                   chunk_rows=chunk_rows, faithful=faithful)


def maxmin_pool(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """[..., T] -> [..., T/window] max-min pooling (preprocessing chain)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if _on_cuda(x2):
        y = maxmin_pool_cuda(x2.contiguous(), window=window)
    else:
        y = ref_lib.maxmin_pool_ref(x2, window=window)
    return y.reshape(shape[:-1] + (shape[-1] // window,))
