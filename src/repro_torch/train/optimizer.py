"""AdamW written out (port of ``repro.train.optimizer``; not
``torch.optim``, so that every step is the reference's arithmetic): a
cosine schedule with linear warmup, global-norm clipping, and a
trainable mask that freezes the analog calibration buffers (fpn, scales,
gain) - those are hardware properties, not weights (paper §III-B trains
only the synaptic weights through the HIL loop).

Parameters, gradients and the moment slots are nested dicts of tensors
with the same keys.  Frozen leaves keep scalar moment slots and are not
updated, but their gradients count in the global norm, as the
reference's ``jax.value_and_grad`` returns them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.quant import _div_exact

FROZEN_KEYS = ("fpn", "a_scale", "w_scale", "gain")


def trainable_mask(params) -> dict:
    """True for leaves that receive optimizer updates."""

    def walk(tree, frozen):
        if isinstance(tree, dict):
            return {k: walk(v, frozen or k in FROZEN_KEYS)
                    for k, v in tree.items()}
        return not frozen

    return walk(params, False)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts with the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"     # "bfloat16" halves optimizer memory


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warmup times a cosine
    decay to ``min_lr_frac``, in fp32."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(
        _div_exact(step, float(max(cfg.warmup_steps, 1))), 1.0)
    prog = torch.clamp(_div_exact(
        step - cfg.warmup_steps,
        float(max(cfg.total_steps - cfg.warmup_steps, 1))), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments for trainable leaves, scalar slots for frozen ones,
    and the step counter, on the parameters' device."""
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    mask = trainable_mask(params)

    def zeros(p, m):
        if m:
            return torch.zeros(p.shape, dtype=dt, device=p.device)
        return torch.zeros((), dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(zeros, params, mask),
        "v": tree_map(zeros, params, mask),
    }


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32.  Under a mesh
    ``shardings`` (the leaves' :class:`~repro_torch.distributed.sharding.
    NamedSharding` tree) says which leaves are this rank's blocks: each
    such leaf's partial sum is all-reduced over the axes that split it,
    so every rank gets the norm of the whole tree."""
    def sumsq(x, ns=None):
        s = torch.sum(torch.square(x.to(torch.float32)))
        if ns is None:
            return s
        from repro_torch.distributed import sharding as shd

        return shd.all_reduce(s, shd.spec_axes(ns.spec))

    rest = () if shardings is None else (shardings,)
    return torch.sqrt(sum(tree_leaves(tree_map(sumsq, tree, *rest))))


def _upd(p, g, m, v, lr, scale, bc1, bc2, cfg: AdamWConfig):
    """One leaf's AdamW update in fp32: ``(param, m, v)`` in their own
    dtypes."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.to(torch.float32) * scale
    m32 = m.to(torch.float32)
    v32 = v.to(torch.float32)
    m_new = b1 * m32 + (1 - b1) * g
    v_new = b2 * v32 + (1 - b2) * g * g
    mhat = m_new / bc1
    vhat = v_new / bc2
    delta = mhat / (torch.sqrt(vhat) + cfg.eps)
    p32 = p.to(torch.float32)
    p_new = p32 - lr * (delta + cfg.weight_decay * p32)
    return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


def adamw_update_(params, grads, state, cfg: AdamWConfig,
                  shardings=None) -> dict:
    """One AdamW step with global-norm clipping, in place: each trainable
    leaf of ``params`` and of ``state``'s moments is overwritten with its
    new value, leaf by leaf, and ``state["step"]`` advanced, so one leaf's
    temporaries are live at a time (the reference donates its state to
    the same end).  Runs on the parameters' device, reads nothing back to
    the host, and returns ``{"grad_norm", "lr"}``.  ``shardings``: the
    parameters' sharding tree when ``params``, ``grads`` and the moments
    are this rank's blocks (the norm is then the whole tree's,
    :func:`global_norm`)."""
    mask = trainable_mask(params)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads, shardings)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v, trainable):
        if not trainable:
            return
        # a scan-stacked leaf one group at a time (elementwise, so the
        # values do not change; the temporaries shrink by the stack depth)
        for i in range(p.shape[0]) if p.ndim >= 3 else (slice(None),):
            for dst, src in zip((p[i], m[i], v[i]), _upd(
                    p[i], g[i], m[i], v[i], lr, scale, bc1, bc2, cfg)):
                dst.copy_(src)

    tree_map(upd, params, grads, state["m"], state["v"], mask)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}


def adamw_update(params, grads, state, cfg: AdamWConfig):
    """:func:`adamw_update_` on copies: returns ``(new_params, new_state,
    {"grad_norm", "lr"})`` and leaves its arguments as they were."""
    params = tree_map(torch.clone, params)
    state = {"step": state["step"], "m": tree_map(torch.clone, state["m"]),
             "v": tree_map(torch.clone, state["v"])}
    metrics = adamw_update_(params, grads, state, cfg)
    return params, state, metrics


def opt_state_specs(param_specs):
    """Sharding specs of the optimizer state: the moments mirror the
    parameters' for trainable leaves and are replicated scalars for the
    frozen calibration buffers."""
    mask = trainable_mask(param_specs)
    mv = tree_map(lambda s, m: s if m else (), param_specs, mask)
    return {"step": (), "m": mv, "v": mv}
