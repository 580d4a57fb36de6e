"""Shared model building blocks (port of ``repro.models.layers``): norms,
RoPE, embeddings and MLPs - every parameter matmul runs through the
analog backend (:func:`repro_torch.api.program.apply_linear`).

Module convention: ``<name>_init(generator, ..., device) -> params`` and
``<name>_apply(params, x, ...) -> y`` on plain dicts of tensors.  The
reference's sharding hints (``constrain``) have no effect on one device
and are left out.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.api.program import apply_linear
from repro_torch.core.analog import AnalogConfig, analog_linear_init
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.noise import NoiseConfig, _normal
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp


# ---------------------------------------------------------------- linear
def linear_init(generator, in_dim, out_dim, *, bias=False,
                noise: NoiseConfig = NoiseConfig(), w_init_scale=1.0,
                dtype=torch.float32, device: DeviceLike = None):
    return analog_linear_init(
        generator, in_dim, out_dim, bias=bias, noise=noise,
        w_init_scale=w_init_scale, dtype=dtype, device=device,
    )


def linear_apply(params, x, acfg: AnalogConfig, *, noise=None):
    return apply_linear(params, x, acfg, noise=noise)


def linear_specs(in_name: Optional[str], out_name: Optional[str],
                 *, bias=False, noise: NoiseConfig = NoiseConfig()):
    """The logical axes of :func:`linear_init`'s dict (the reference's
    sharding spec: a declaration, read by the ``sharding-specs`` verifier
    rule)."""
    specs = {
        "w": (in_name, out_name),
        "w_scale": (None, out_name),
        "a_scale": (),
        "gain": (),
    }
    if bias:
        specs["b"] = (out_name,)
    if noise.mode != "none":
        fpn = {}
        if noise.gain_std > 0:
            if noise.mode == "full":
                fpn["gain"] = (in_name, out_name)
            else:
                fpn["row_gain"] = (in_name,)
                fpn["col_gain"] = (out_name,)
        if noise.offset_std > 0:
            fpn["chunk_offset"] = ("chunks", out_name)
        if fpn:
            specs["fpn"] = fpn
    return specs


# ----------------------------------------------------------------- norms
def norm_init(dim, kind="rmsnorm", device: DeviceLike = None):
    dev = resolve_device(device)
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=dev)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=dev)
    return p


def norm_specs(kind="rmsnorm"):
    p = {"scale": (None,)}
    if kind == "layernorm":
        p["bias"] = (None,)
    return p


def norm_apply(params, x, kind="rmsnorm", eps=1e-5):
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * params["scale"]
    if "bias" in params:
        y = y + params["bias"]
    return y.to(x.dtype)


# ------------------------------------------------------------------ RoPE
@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    even = 2.0 * torch.arange(head_dim // 2, dtype=torch.float32)
    return (1.0 / (theta ** (even / head_dim))).to(device)


def rope_freqs(head_dim: int, theta: float,
               device: DeviceLike = "cpu") -> torch.Tensor:
    """``1 / theta^(2i / head_dim)``, computed on the CPU and copied to
    ``device`` (cached; do not write to it): the card's ``pow``, and its
    division of a number by a tensor, round a frequency's last bit
    otherwise, and position ``p`` multiplies that into ``p`` ulps of the
    angle (M-RoPE's positions reach the hundreds)."""
    return _rope_freqs(head_dim, float(theta), torch.device(device))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, dh]; positions: [B, S] integers."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # [dh/2]
    angle = positions[..., None].to(torch.float32) * freqs   # [B, S, dh/2]
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mrope_section_ids(sections: tuple, device: torch.device) -> torch.Tensor:
    """The section (0 temporal, 1 height, 2 width) of each frequency slot,
    made once per device: no host-to-device copy per attention call."""
    return torch.repeat_interleave(
        torch.arange(len(sections), device=device),
        torch.tensor(sections, device=device), output_size=sum(sections))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191): the ``head_dim / 2``
    frequency slots split into (temporal, height, width) sections, each
    rotated by its own position id.  x: [B, S, H, dh]; positions:
    [B, S, 3] integers."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to "
                         f"head_dim / 2 = {dh // 2}")
    freqs = rope_freqs(dh, theta, x.device)                  # [dh/2]
    sec_ids = _mrope_section_ids(tuple(sections), x.device)  # [dh/2]
    angle = positions.to(torch.float32)[..., sec_ids] * freqs  # [B, S, dh/2]
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- embedding
def embedding_init(generator, vocab, dim, dtype=torch.float32,
                   device: DeviceLike = None):
    dev = resolve_device(device)
    return {"table": (_normal(generator, (vocab, dim), dev) * 0.02).to(dtype)}


def embedding_apply(params, tokens):
    """``table[tokens]``.  A view whose table is this rank's vocabulary
    block (:func:`~repro_torch.distributed.tensor_parallel.embedding_view`)
    looks up the tokens in its range, zeros elsewhere, and sums the ranks'
    rows over the ``model`` axis: one term of each sum is the row, the
    others exact zeros."""
    table = params["table"]
    if not tp.split_cols(params):
        return table[tokens]
    v = table.shape[0]
    local = tokens - shd.axis_index("model") * v
    mine = (local >= 0) & (local < v)
    rows = table[torch.clamp(local, 0, v - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return shd.sum_over(rows, "model")


def embedding_specs():
    return {"table": ("vocab", "embed")}


# ------------------------------------------------------------------- MLP
def mlp_init(generator, d_model, d_ff, *, act="swiglu",
             noise: NoiseConfig = NoiseConfig(), dtype=torch.float32,
             device: DeviceLike = None):
    kw = dict(noise=noise, dtype=dtype, device=device)
    p = {
        "up": linear_init(generator, d_model, d_ff, **kw),
        "down": linear_init(generator, d_ff, d_model, **kw),
    }
    if act == "swiglu":
        p["gate"] = linear_init(generator, d_model, d_ff, **kw)
    return p


def mlp_specs(*, act="swiglu", noise: NoiseConfig = NoiseConfig()):
    p = {
        "up": linear_specs("embed", "mlp", noise=noise),
        "down": linear_specs("mlp", "embed", noise=noise),
    }
    if act == "swiglu":
        p["gate"] = linear_specs("embed", "mlp", noise=noise)
    return p


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it: ``x * (1 / (1 +
    exp(-x)))``, every operation rounded to ``x``'s dtype.  ``F.silu``
    rounds once from fp32, which at bf16 activations differs from the
    reference in the last bit of about a third of the elements, and a
    flipped bit moves the next layer's dynamic 5-bit codes."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x * (one / (one + torch.exp(-x)))


def mlp_apply(params, x, acfg: AnalogConfig, *, act="swiglu", noise=None):
    """``down(act(gate(x)) * up(x))``.  Under a mesh a view whose ``up``
    holds this rank's hidden columns
    (:func:`~repro_torch.distributed.tensor_parallel.mlp_view`) computes the
    activation on them; ``down`` then runs row-parallel on them, or on
    their all-gather."""
    split = tp.split_cols(params["up"])
    if split:
        # every rank's columns read x: its gradient sums over the ranks
        x = shd.psum_grad(x, shd.split_axes(tp.MODEL))
    up = linear_apply(params["up"], x, acfg, noise=noise)
    if act == "swiglu":
        gate = linear_apply(params["gate"], x, acfg, noise=noise)
        h = silu(gate) * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")
    elif act == "relu":
        h = torch.relu(up)
    elif act == "relu2":      # squared ReLU (Nemotron/Minitron, Primer)
        h = torch.square(torch.relu(up))
    else:
        raise ValueError(act)
    if split and not tp.split_rows(params["down"]):
        h = shd.gather_blocks(h, tp.MODEL, dim=-1)
    return linear_apply(params["down"], h, acfg, noise=noise)


# ------------------------------------------------------ recurrent scans
# Time steps per segment of the per-token recurrences' backward
# (``models.rwkv.wkv_scan``, ``models.ssm.ssd_scan``): under autograd the
# forward keeps the state at every segment's start, and the backward
# recomputes one segment's states at a time.  ``None``: plain autograd
# through the loop, every step's tensors kept (the reference's memory; a
# test or a measurement sets it, read at each call).
SCAN_SEGMENT = 128


def scan_needs_segments(*tensors) -> bool:
    """Does a recurrence on ``tensors`` run its segmented backward (under
    autograd, with :data:`SCAN_SEGMENT` set)?"""
    return SCAN_SEGMENT is not None and torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)
