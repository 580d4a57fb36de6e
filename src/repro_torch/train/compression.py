"""Int8 gradient compression with error feedback (port of
``repro.train.compression``).

Per-leaf symmetric int8 quantization with a per-leaf scale; the
quantization residual is carried in an error-feedback buffer so the
compression bias vanishes over steps (Karimireddy et al. 2019).  The
compressed codes are what would cross the data-parallel axes: 4x less
all-reduce traffic than fp32.  On one device the train step compresses
and decompresses in place of that all-reduce, so the update sees the
same values a multi-device run would.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import _div_exact
from repro_torch.train.optimizer import tree_leaves, tree_map


def ef_init(params):
    """Zero error-feedback buffers shaped like the gradients (fp32)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress(g: torch.Tensor, axes=()):
    """Symmetric int8 quantization; returns (codes int8, scale f32).
    ``axes``: the mesh axes that split ``g`` into this rank's block (the
    scale is the whole leaf's)."""
    from repro_torch.distributed import sharding as shd

    amax = g.abs().max()
    if axes:
        amax = shd.all_reduce(amax, axes, op="max")
    scale = _div_exact(torch.clamp_min(amax, 1e-30), 127.0)
    codes = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return codes, scale


def decompress(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def compress_grads(grads, ef, shardings=None):
    """Apply error feedback, compress each leaf.  Returns (a tree of
    ``(codes, scale)`` pairs, the new error buffers).  ``shardings``: the
    leaves' sharding tree when they are this rank's blocks."""

    from repro_torch.distributed import sharding as shd

    def one(g, e, ns=None):
        corrected = g.to(torch.float32) + e
        axes = () if ns is None else shd.spec_axes(ns.spec)
        codes, scale = compress(corrected, axes)
        return (codes, scale), corrected - decompress(codes, scale)

    if shardings is None:
        pairs = tree_map(one, grads, ef)  # a (codes, scale) tuple is a leaf
    else:
        pairs = tree_map(one, grads, ef, shardings)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def decompress_grads(comp):
    return tree_map(lambda pair: decompress(*pair), comp)


def compression_ratio(grads) -> float:
    """Bytes saved against fp32 transport."""
    leaves = tree_leaves(grads)
    fp32 = sum(x.numel() * 4 for x in leaves)
    int8 = sum(x.numel() * 1 + 4 for x in leaves)
    return fp32 / int8
