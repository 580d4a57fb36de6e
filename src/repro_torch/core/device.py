"""Device resolution shared by the port's entry points.

``device=None`` means the CUDA device.  There is no silent fallback: when
no CUDA device is present the entry point raises, and the CPU runs only
when the caller asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch device an entry point runs on (``None`` -> ``"cuda"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev


def to_device(tree, device: torch.device):
    """A nested dict of tensors moved to ``device`` (a tensor already there
    is not copied)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


@contextlib.contextmanager
def fp32_matmuls():
    """fp32 products at full precision (no TF32) inside the block, the
    caller's setting restored after: the HIL backward's and flash
    attention's products must be the reference's fp32 arithmetic."""
    was = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(was)
