"""RWKV-6 "Finch" block (arXiv:2404.05892; port of ``repro.models.rwkv``):
data-dependent-decay linear attention + squared-ReLU channel mix.

Analog mapping: the R/K/V/G/O and channel-mix projections are analog tile
matmuls; the WKV recurrence is stateful elementwise dynamics (the BSS-2
*neuron* mode, not the multiplexable VMM mode) and stays digital, plain
fp32 PyTorch.  A compiled block (:func:`rwkv_module_spec`, or an LM tree
through ``api.compile``) runs r/k/v/g as ONE ``batch_concat`` dispatch:
the split kernel's member axis on the card.

The recurrence is the O(T) sequential scan of the reference, one step per
token; under autograd its backward recomputes the states a segment at a time,
so its memory stays bounded at 4096 positions.  The reference's sharding hints
(``constrain``) have no effect on one device and are left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.device import DeviceLike, fp32_matmuls, resolve_device
from repro_torch.core.noise import NoiseConfig, _normal
from repro_torch.exec.plan import GROUP_BATCH_CONCAT, find_group
from repro_torch.models import layers as L

LORA_RANK = 64
_RKVG = ("wr", "wk", "wv", "wg")


def rwkv_init(generator, d_model, n_heads, *,
              noise: NoiseConfig = NoiseConfig(), dtype=torch.float32,
              device: DeviceLike = None):
    """One time-mix block's parameters, drawn from ``generator``."""
    dev = resolve_device(device)
    head_dim = d_model // n_heads

    def small(shape, s=0.01):
        return _normal(generator, shape, dev) * s

    kw = dict(noise=noise, dtype=dtype, device=dev)
    return {
        "tm": {  # time-mix interpolation factors (token shift)
            name: small((d_model,))
            for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")
        },
        **{name: L.linear_init(generator, d_model, d_model, **kw)
           for name in ("wr", "wk", "wv", "wg", "wo")},
        # data-dependent decay: w_t = exp(-exp(w0 + lora(x)))
        "w0": torch.full((n_heads, head_dim), -2.0, dtype=torch.float32,
                         device=dev),
        "w_lora_a": small((d_model, LORA_RANK), 0.02),
        "w_lora_b": small((LORA_RANK, d_model), 0.02),
        # per-(head, channel) current-token bonus
        "u": torch.zeros((n_heads, head_dim), dtype=torch.float32,
                         device=dev),
    }


def rwkv_specs(noise: NoiseConfig = NoiseConfig()):
    return {
        "tm": {k: (None,) for k in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")},
        "wr": L.linear_specs("embed", "heads", noise=noise),
        "wk": L.linear_specs("embed", "heads", noise=noise),
        "wv": L.linear_specs("embed", "heads", noise=noise),
        "wg": L.linear_specs("embed", "heads", noise=noise),
        "wo": L.linear_specs("heads", "embed", noise=noise),
        "w0": ("heads", None),
        "w_lora_a": (None, None),
        "w_lora_b": (None, "heads"),
        "u": ("heads", None),
    }


def rwkv_module_spec(d_model, n_heads, *,
                     noise: NoiseConfig = NoiseConfig()):
    """Declare one RWKV-6 time-mix block for the front door:
    ``api.compile(rwkv_module_spec(d, h), params, run)`` bakes the five
    projections once - r/k/v/g fused into ONE ``batch_concat`` dispatch
    group (4 -> 1 analog dispatches) - and ``CompiledModel.apply(x,
    cache=, noise=)`` is :func:`rwkv_apply` over the pre-lowered tree.
    ``params`` is :func:`rwkv_init`'s dict."""
    from repro_torch import api

    def _apply(model, x, *, cache=None, noise=None):
        return rwkv_apply(model.lower(), x, acfg=model.acfg,
                          n_heads=n_heads, cache=cache, noise=noise)

    return api.ModuleSpec(
        name=f"rwkv_tmix_{d_model}x{n_heads}",
        kind="tree",
        apply_fn=_apply,
        layers=tuple(
            [api.LayerSpec(n, d_model, d_model, group="rkvg") for n in _RKVG]
            + [api.LayerSpec("wo", d_model, d_model)]),
        groups=(api.GroupSpec("rkvg", GROUP_BATCH_CONCAT, _RKVG),),
        param_axes=rwkv_specs(noise),
    )


def _token_shift(x, x_prev):
    """Shift the sequence right by one; ``x_prev`` is the carry for step 0
    (the two concatenate at their promoted dtype, as ``jnp.concatenate``
    does)."""
    dt = torch.promote_types(x.dtype, x_prev.dtype)
    return torch.cat([x_prev[:, None].to(dt), x[:, :-1].to(dt)], dim=1)


def _lerp(x, x_shift, mu):
    return x + (x_shift - x) * mu


def _wkv_steps(r, k, v, w, u, state, seg=0):
    """The per-token WKV-6 loop: ``(out, state, starts)``, ``starts`` the
    state at the start of every ``seg`` steps (none for ``seg=0``)."""
    ys, starts = [], []
    with fp32_matmuls():
        for t in range(r.shape[1]):
            if seg and t % seg == 0:
                starts.append(state)
            k_t, v_t = k[:, t], v[:, t]
            kv = k_t[..., :, None] * v_t[..., None, :]          # [B, H, D, D]
            ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                                   state + u[None, :, :, None] * kv))
            state = w[:, t][..., :, None] * state + kv
    return torch.stack(ys, dim=1), state, starts


class _WKVScan(torch.autograd.Function):
    """The WKV loop under autograd with its memory bounded: the forward is
    :func:`_wkv_steps` (the serving loop, so the values are bit-identical)
    keeping only the state at each segment's start; the backward walks
    the segments in reverse, recomputes a segment's states ``S_{t-1}``
    from its start (the same ops), and runs the recurrence's adjoint.  With
    ``y_t = r_t (S_{t-1} + u kv_t)``, ``S_t = w_t S_{t-1} + kv_t`` and
    ``H_t = dL/dS_t``: ``G_t = r_t (x) dy_t``, ``H_{t-1} = G_t + w_t
    H_t`` (the only serial step), then over the segment at once ``dr =
    (S_{t-1} + u kv_t) dy_t``, ``dkv = u G_t + H_t``, ``dk = dkv v_t``,
    ``dv = k_t dkv``, ``dw = sum_j H_t S_{t-1}``, ``du = sum G_t kv_t``.
    The same derivatives as autograd's, summed in another order."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        ctx.seg = L.SCAN_SEGMENT
        y, state, starts = _wkv_steps(r, k, v, w, u, state0, ctx.seg)
        ctx.save_for_backward(r, k, v, w, u, torch.stack(starts))
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        r, k, v, w, u, starts = ctx.saved_tensors
        seg = ctx.seg
        dr, dk, dv, dw = (torch.zeros_like(t) for t in (r, k, v, w))
        du = torch.zeros_like(u)
        uu = u[None, None, :, :, None]
        carry = gstate                              # dL/dS after the last step
        with fp32_matmuls():
            for i in reversed(range(starts.shape[0])):
                sl = slice(i * seg, (i + 1) * seg)
                rs, ks, vs, ws, dys = (t[:, sl] for t in (r, k, v, w, gy))
                n = rs.shape[1]
                kv = ks[..., :, None] * vs[..., None, :]    # [B, n, H, D, D]
                wk = ws[..., :, None]
                prev, s = [], starts[i]
                for t in range(n):
                    prev.append(s)
                    s = wk[:, t] * s + kv[:, t]
                prev = torch.stack(prev, dim=1)             # S_{t-1}
                g = rs[..., :, None] * dys[..., None, :]
                hs = [None] * n
                for t in reversed(range(n)):
                    hs[t] = carry
                    carry = g[:, t] + wk[:, t] * carry
                h = torch.stack(hs, dim=1)                  # dL/dS_t
                dkv = uu * g + h
                dr[:, sl] = torch.einsum("blhij,blhj->blhi", prev + uu * kv,
                                         dys)
                dk[:, sl] = (dkv * vs[..., None, :]).sum(-1)
                dv[:, sl] = (dkv * ks[..., :, None]).sum(-2)
                dw[:, sl] = (h * prev).sum(-1)
                du += (g * kv).sum(dim=(0, 1, 4))
        return dr, dk, dv, dw, du, carry


def wkv_scan(r, k, v, w, u, state0):
    """Sequential WKV-6 recurrence, one step per token; under autograd
    with its memory bounded (:class:`_WKVScan`: segments of
    :data:`~repro_torch.models.layers.SCAN_SEGMENT` steps).

    r, k, v: [B, T, H, D]; w: [B, T, H, D] decay in (0, 1); u: [H, D];
    state0: [B, H, D, D] -> (out [B, T, H, D], state [B, H, D, D])."""
    if L.scan_needs_segments(r, k, v, w, u, state0):
        return _WKVScan.apply(r, k, v, w, u, state0)
    return _wkv_steps(r, k, v, w, u, state0)[:2]


def _rkvg(params, xs, acfg: AnalogConfig, noise):
    """The four r/k/v/g projections: ONE batch_concat dispatch when the
    tree holds the group (resolved by kind and exact members, its baked
    encoding matching this call), else four solo ones."""
    gp = None
    if acfg.mode != "digital":
        gp = find_group(params.get("_groups"), GROUP_BATCH_CONCAT, _RKVG)
    if gp is not None and (gp.fused.signed_input != acfg.signed_input
                           or gp.fused.chunk_rows != acfg.chunk_rows):
        gp = None        # baked attributes disagree with this call site
    if gp is not None:
        from repro_torch.exec.run import run_batch_concat

        return run_batch_concat(gp, xs, acfg, noise=noise)
    return tuple(L.linear_apply(params[n], x, acfg, noise=noise)
                 for n, x in zip(_RKVG, xs))


def rwkv_apply(params, x, *, acfg: AnalogConfig, n_heads, cache=None,
               noise=None):
    """x: [B, T, d].  cache: ``{"x_prev": [B, d], "state": [B, H, D, D]}``
    for decode; None for a prefill from the zero state.  Returns ``(out,
    {"x_prev", "state"})``.  ``noise``: the readout-noise source of the
    block's analog layers, drawn in call order."""
    b, t, d = x.shape
    hd = d // n_heads
    x_prev = cache["x_prev"] if cache is not None else torch.zeros_like(
        x[:, 0])
    xs = _token_shift(x, x_prev)
    tm = params["tm"]
    xr, xk, xv, xg, xw = (_lerp(x, xs, tm[f"mu_{c}"]) for c in "rkvgw")
    r, k, v, g = _rkvg(params, (xr, xk, xv, xg), acfg, noise)

    with fp32_matmuls():
        dd = torch.tanh(xw.to(torch.float32) @ params["w_lora_a"]) @ params[
            "w_lora_b"]
    w_log = params["w0"].reshape(1, 1, d) + dd.reshape(b, t, d)
    w = torch.exp(-torch.exp(w_log))                    # decay in (0, 1)

    shape = (b, t, n_heads, hd)
    r, k, v, w = (a.to(torch.float32).reshape(shape) for a in (r, k, v, w))
    state0 = cache["state"] if cache is not None else torch.zeros(
        (b, n_heads, hd, hd), dtype=torch.float32, device=x.device)
    y, state = wkv_scan(r, k, v, w, params["u"], state0)
    # group norm over heads, then the output gate and projection
    yh = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-5)
    y = (yh.reshape(b, t, d) * F.silu(g.to(torch.float32))).to(x.dtype)
    out = L.linear_apply(params["wo"], y, acfg, noise=noise)
    return out, {"x_prev": x[:, -1], "state": state}


def rwkv_cache_specs():
    """The logical axes of the time mix's decode cache."""
    return {"x_prev": ("batch", None), "state": ("batch", "heads", None, None)}


# ------------------------------------------------------- channel mix (FFN)
def channel_mix_init(generator, d_model, d_ff, *,
                     noise: NoiseConfig = NoiseConfig(), dtype=torch.float32,
                     device: DeviceLike = None):
    dev = resolve_device(device)
    kw = dict(noise=noise, dtype=dtype, device=dev)
    return {
        "mu_k": torch.zeros((d_model,), dtype=torch.float32, device=dev),
        "wk": L.linear_init(generator, d_model, d_ff, **kw),
        "wv": L.linear_init(generator, d_ff, d_model, **kw),
    }


def channel_mix_specs(noise: NoiseConfig = NoiseConfig()):
    return {
        "mu_k": (None,),
        "wk": L.linear_specs("embed", "mlp", noise=noise),
        "wv": L.linear_specs("mlp", "embed", noise=noise),
    }


def channel_mix_apply(params, x, *, acfg: AnalogConfig, cache=None,
                      noise=None):
    """The squared-ReLU channel mix: ``(y, {"x_prev": [B, d]})``."""
    x_prev = cache["x_prev"] if cache is not None else torch.zeros_like(
        x[:, 0])
    xk = _lerp(x, _token_shift(x, x_prev), params["mu_k"])
    h = L.linear_apply(params["wk"], xk, acfg, noise=noise)
    h = torch.square(torch.relu(h))
    y = L.linear_apply(params["wv"], h, acfg, noise=noise)
    return y, {"x_prev": x[:, -1]}
