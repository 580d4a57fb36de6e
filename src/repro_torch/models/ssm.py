"""Mamba-2 (SSD, arXiv:2405.21060) block for the Zamba2 hybrid
architecture (port of ``repro.models.ssm``).

Analog mapping: the in / out projections are analog tile matmuls; the
causal depthwise conv and the selective state-space recurrence are
stateful dynamics and stay digital, plain fp32 PyTorch.  The recurrence
is the reference's sequential scan over time, one step per token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.device import DeviceLike, fp32_matmuls, resolve_device
from repro_torch.core.noise import NoiseConfig, _normal
from repro_torch.models import layers as L

CONV_K = 4


def mamba_init(generator, d_model, *, d_state=64, expand=2, head_dim=64,
               noise: NoiseConfig = NoiseConfig(), dtype=torch.float32,
               device: DeviceLike = None):
    dev = resolve_device(device)
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    d_conv_ch = d_inner + 2 * d_state       # x plus the B and C streams
    kw = dict(noise=noise, dtype=dtype, device=dev)
    return {
        # fused input projection: [z | xBC | dt]
        "in_proj": L.linear_init(generator, d_model,
                                 d_inner + d_conv_ch + n_heads, **kw),
        "conv_w": _normal(generator, (CONV_K, d_conv_ch), dev) * 0.2,
        "conv_b": torch.zeros((d_conv_ch,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          dtype=torch.float32, device=dev)),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "norm": L.norm_init(d_inner, "rmsnorm", dev),
        "out_proj": L.linear_init(generator, d_inner, d_model, **kw),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv over time.  x: [B, T, C]; w: [K, C];
    conv_state: the [B, K-1, C] carry for decode.  Returns (silu(out),
    the new carry)."""
    k = w.shape[0]
    if conv_state is None:
        conv_state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([conv_state, x], dim=1)               # [B, T+K-1, C]
    out = 0
    for i in range(k):      # the reference's sum(), in its order
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return F.silu(out + b), xp[:, -(k - 1):]


def ssd_scan(xh, dt, a_decay, B, C, state0):
    """Selective state-space recurrence, one step per token.

    xh: [B, T, H, P] inputs per head; dt, a_decay: [B, T, H]; B, C:
    [B, T, N] (one group); state0: [B, H, P, N] -> (y [B, T, H, P],
    state [B, H, P, N])."""
    state, ys = state0, []
    with fp32_matmuls():
        for t in range(xh.shape[1]):
            # state <- a * state + dt * x (x) B
            upd = (dt[:, t][..., None] * xh[:, t])[..., None] * \
                B[:, t][:, None, None, :]
            state = a_decay[:, t][..., None, None] * state + upd
            ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    return torch.stack(ys, dim=1), state


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def mamba_apply(params, x, *, acfg: AnalogConfig, d_state=64, expand=2,
                head_dim=64, cache=None, noise=None):
    """x: [B, T, d].  cache: ``{"conv": [B, K-1, C], "state": [B, H, P,
    N]}`` for decode, None for a prefill from the zero state.  Returns
    ``(out, {"conv", "state"})``."""
    b, t, d = x.shape
    d_inner = expand * d
    n_heads = d_inner // head_dim
    d_conv_ch = d_inner + 2 * d_state

    zxbcdt = L.linear_apply(params["in_proj"], x, acfg, noise=noise)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_conv_ch]
    dt_raw = zxbcdt[..., d_inner + d_conv_ch:]

    xbc, new_conv = _causal_conv(
        xbc.to(torch.float32), params["conv_w"], params["conv_b"],
        None if cache is None else cache["conv"])
    xs = xbc[..., :d_inner]
    B = xbc[..., d_inner:d_inner + d_state]
    C = xbc[..., d_inner + d_state:]

    dt = _softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    a = torch.exp(-dt * torch.exp(params["A_log"]))     # [B, T, H] in (0, 1)
    xh = xs.reshape(b, t, n_heads, head_dim)
    state0 = cache["state"] if cache is not None else torch.zeros(
        (b, n_heads, head_dim, d_state), dtype=torch.float32,
        device=x.device)
    y, state = ssd_scan(xh, dt, a, B, C, state0)
    y = y + params["D"][None, None, :, None] * xh
    y = L.norm_apply(params["norm"], y.reshape(b, t, d_inner), "rmsnorm")
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    out = L.linear_apply(params["out_proj"], y, acfg, noise=noise)
    return out, {"conv": new_conv, "state": state}
