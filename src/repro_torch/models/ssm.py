"""Mamba-2 (SSD, arXiv:2405.21060) block for the Zamba2 hybrid
architecture (port of ``repro.models.ssm``).

Analog mapping: the in / out projections are analog tile matmuls; the
causal depthwise conv and the selective state-space recurrence are
stateful dynamics and stay digital, plain fp32 PyTorch.  The recurrence
is the reference's sequential scan over time, one step per token; under
autograd its backward recomputes the states a segment at a time, so its
memory stays bounded at 4096 positions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.device import DeviceLike, fp32_matmuls, resolve_device
from repro_torch.core.noise import NoiseConfig, _normal
from repro_torch.models import layers as L

CONV_K = 4


def mamba_cache_specs():
    """The logical axes of the Mamba layer's decode cache."""
    return {
        "conv": ("batch", None, "mlp"),
        "state": ("batch", "mlp", None, None),
    }


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


def mamba_specs(noise: NoiseConfig = NoiseConfig()):
    return {
        "in_proj": L.linear_specs("embed", "mlp", noise=noise),
        "conv_w": (None, "mlp"),
        "conv_b": ("mlp",),
        "A_log": (None,),
        "dt_bias": (None,),
        "D": (None,),
        "norm": L.norm_specs("rmsnorm"),
        "out_proj": L.linear_specs("mlp", "embed", noise=noise),
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


def _ssd_steps(xh, dt, a_decay, B, C, state, seg=0):
    """The per-token SSD loop: ``(y, state, starts)``, ``starts`` the state
    at the start of every ``seg`` steps (none for ``seg=0``)."""
    ys, starts = [], []
    with fp32_matmuls():
        for t in range(xh.shape[1]):
            if seg and t % seg == 0:
                starts.append(state)
            # state <- a * state + dt * x (x) B
            upd = (dt[:, t][..., None] * xh[:, t])[..., None] * \
                B[:, t][:, None, None, :]
            state = a_decay[:, t][..., None, None] * state + upd
            ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    return torch.stack(ys, dim=1), state, starts


class _SSDScan(torch.autograd.Function):
    """The SSD loop under autograd with its memory bounded: the forward is
    :func:`_ssd_steps` (the serving loop, bit-identical values) keeping
    only the state at each segment's start; the backward walks the
    segments in reverse, recomputes a segment's states from its start (the
    same ops) and runs the recurrence's adjoint.  With ``S_t = a_t S_{t-1}
    + (dt_t x_t) (x) B_t``, ``y_t = S_t C_t`` and ``H_t = dL/dS_t``:
    ``H_t = dy_t (x) C_t + a_{t+1} H_{t+1}`` (the only serial step), then
    over the segment at once ``dC = S_t dy_t``, ``da = sum H_t S_{t-1}``,
    ``d(dt x) = H_t B_t``, ``dB = sum H_t (dt x)``.  The same derivatives
    as autograd's, summed in another order."""

    @staticmethod
    def forward(ctx, xh, dt, a_decay, B, C, state0):
        ctx.seg = L.SCAN_SEGMENT
        y, state, starts = _ssd_steps(xh, dt, a_decay, B, C, state0, ctx.seg)
        ctx.save_for_backward(xh, dt, a_decay, B, C, torch.stack(starts))
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        xh, dt, a_decay, B, C, starts = ctx.saved_tensors
        seg = ctx.seg
        dx, ddt, da, dB, dC = (torch.zeros_like(t)
                               for t in (xh, dt, a_decay, B, C))
        carry = gstate                              # dL/dS after the last step
        with fp32_matmuls():
            for i in reversed(range(starts.shape[0])):
                sl = slice(i * seg, (i + 1) * seg)
                xs, dts, as_, bs, cs, dys = (t[:, sl] for t in
                                             (xh, dt, a_decay, B, C, gy))
                n = xs.shape[1]
                xd = dts[..., None] * xs                     # [B, n, H, P]
                bb = bs[:, :, None, None, :]
                upd = xd[..., None] * bb                     # [B, n, H, P, N]
                a4 = as_[..., None, None]
                states, s = [], starts[i]
                for t in range(n):
                    s = a4[:, t] * s + upd[:, t]
                    states.append(s)
                st = torch.stack(states, dim=1)              # S_t
                prev = torch.cat([starts[i][:, None], st[:, :-1]], dim=1)
                e = dys[..., None] * cs[:, :, None, None, :]
                hs = [None] * n
                for t in reversed(range(n)):
                    hs[t] = e[:, t] + carry
                    carry = a4[:, t] * hs[t]
                h = torch.stack(hs, dim=1)                   # dL/dS_t
                dC[:, sl] = torch.einsum("blhpn,blhp->bln", st, dys)
                da[:, sl] = (h * prev).sum(dim=(-2, -1))
                dxd = (h * bb).sum(-1)
                dB[:, sl] = (h * xd[..., None]).sum(dim=(2, 3))
                ddt[:, sl] = (dxd * xs).sum(-1)
                dx[:, sl] = dxd * dts[..., None]
        return dx, ddt, da, dB, dC, carry


def ssd_scan(xh, dt, a_decay, B, C, state0):
    """Selective state-space recurrence, one step per token; under
    autograd with its memory bounded (:class:`_SSDScan`: segments of
    :data:`~repro_torch.models.layers.SCAN_SEGMENT` steps).

    xh: [B, T, H, P] inputs per head; dt, a_decay: [B, T, H]; B, C:
    [B, T, N] (one group); state0: [B, H, P, N] -> (y [B, T, H, P],
    state [B, H, P, N])."""
    if L.scan_needs_segments(xh, dt, a_decay, B, C, state0):
        return _SSDScan.apply(xh, dt, a_decay, B, C, state0)
    return _ssd_steps(xh, dt, a_decay, B, C, state0)[:2]


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``, with its gradient
    ``exp(x - out)`` (``logaddexp``'s JVP).  Autograd through the forward
    formula would give 1 at exactly ``x = 0``, where the true slope is
    0.5: an analog ``in_proj`` puts integer ADC codes of 0 on ``dt`` all
    the time."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
    return _Softplus.apply(x)


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
