"""The FPGA preprocessing chain of paper Fig. 7, bit-exact:

  raw 12-bit samples
    -> discrete derivative          (suppresses baseline fluctuations)
    -> max-min pooling over 32      (rate reduction, positive activations)
    -> 5-bit quantization           (input activations for the analog VMM)

The pooling runs in the ``maxmin_pool`` CUDA kernel on the card and in
its plain version on the CPU (:func:`repro_torch.kernels.ops.maxmin_pool`).
"""
from __future__ import annotations

import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.hw import BSS2
from repro_torch.kernels import ops as kernel_ops

POOL_WINDOW = 32


def preprocess(raw, *, window: int = POOL_WINDOW, quant_shift: int = 4,
               device: DeviceLike = None) -> torch.Tensor:
    """raw: [..., C, T] 12-bit sample values (numpy array or tensor) ->
    [..., C, (T-1)//window] 5-bit activation codes (integer-valued
    float32) on ``device`` (``None`` = the CUDA device).

    ``quant_shift``: right-shift applied by the FPGA quantizer; 4 bits maps
    the typical max-min derivative range (<512 counts) onto [0, 31].
    """
    dev = resolve_device(device)
    raw = torch.as_tensor(raw, dtype=torch.float32).to(dev)
    deriv = torch.diff(raw, dim=-1)                      # discrete derivative
    t = deriv.shape[-1]
    deriv = deriv[..., :(t // window) * window]
    pooled = kernel_ops.maxmin_pool(deriv, window)
    codes = torch.floor(pooled / (1 << quant_shift))
    return torch.clamp(codes, 0, BSS2.a_max)


def preprocess_batch(raw_batch, **kw) -> torch.Tensor:
    """[N, C, T] raw records -> [N, C, T'] activation codes."""
    return preprocess(raw_batch, **kw)
