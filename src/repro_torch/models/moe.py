"""Mixture-of-Experts layer (port of ``repro.models.moe`` without a
mesh): top-k routing, capacity-bounded sort-based dispatch, and the
expert products of every expert of a stack as ONE analog dispatch.

Analog mapping: each expert's FFN matrices are analog tile grids; one
``expert_stack`` dispatch runs them all (the split kernel's expert axis
on the card, :func:`repro_torch.exec.run.run_expert_stack`).

Dispatch algorithm (dropping, capacity factor c), the reference's
arithmetic step for step:
  1. router logits -> softmax -> top-k experts (ties to the lower expert
     index, as ``jax.lax.top_k``) -> weights renormalized by
     ``max(sum, 1e-9)``
  2. position-in-expert via a stable sort over expert ids and the
     segment starts
  3. scatter tokens into a ``[B, E, C, d]`` buffer (over-capacity tokens
     drop; their clamped slot receives zeros)
  4. the expert FFNs, then each token's k contributions gathered back and
     summed in the sorted dispatch order (ascending expert id), with no
     atomics, so the sum is the same on every run and device.

A dense fallback (``dense=True``) runs every expert on every token, for
tiny smoke configs.  Under a mesh with a ``model`` axis,
``dispatch="shard_map"`` is the expert-parallel dispatch
(:func:`_expert_block_shard_map`): each model rank fills and runs its own
experts' buffer, and one all-gather assembles the expert outputs.
Without a mesh it is the ``gspmd_ep`` path, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.noise import NoiseConfig, _normal
from repro_torch.distributed import sharding as shd
from repro_torch.exec.plan import (GROUP_EXPERT_STACK, PYTREE_FIELDS,
                                   GroupPlan, find_group)
from repro_torch.models import layers as L

# the reference's dispatch names: the two GSPMD paths build the whole
# buffer on every rank; shard_map is the expert-parallel dispatch
DISPATCH = ("shard_map", "gspmd_ep", "replicated_buf")
# Experts per block when an expert stack is drawn (:func:`moe_init`) or
# lowered without grad (``exec.lower.lower_expert_stack``): one block of
# fp32 values exists at a time, never a whole stack (llama4-maverick's is
# 128 x 5120 x 8192, 21.5 GB in fp32).  Every SMOKE stack is one block.
EXPERT_BLOCK = 8


class Routes:
    """The routing ``(topw, topi)`` of every :func:`moe_apply` call it is
    handed, in call order (:attr:`taken`, detached).  Given another run's
    routes (``replay``), each call takes the next of those in place of its
    router's top-k: a card-against-CPU check routes the card's run as the
    CPU's, whose router may round a near tie the other way.  Under
    autograd the replayed weights keep their values and take the gradient
    of this call's router at the replayed experts (its probabilities
    gathered there and renormalized), so the router trains as it would
    have routed.  A test hook: no entry point routes through it unless
    the caller passes one."""

    def __init__(self, replay=None):
        self.taken: list = []
        self._replay = None if replay is None else iter(replay)

    @property
    def replaying(self) -> bool:
        return self._replay is not None

    def route(self, topw: torch.Tensor, topi: torch.Tensor,
              probs: Optional[torch.Tensor] = None):
        if self._replay is not None:
            w, i = (t.to(topw.device) for t in next(self._replay))
            if probs is not None and probs.requires_grad:
                own = _renormalize(torch.gather(probs, -1, i))
                w = w + (own - own.detach())
            topw, topi = w, i
        self.taken.append((topw.detach(), topi))
        return topw, topi


def moe_init(generator, d_model, d_ff, n_experts, *, n_shared=0,
             act="swiglu", noise: NoiseConfig = NoiseConfig(),
             dtype=torch.float32, device: DeviceLike = None):
    """Router ``[d, E]`` (fp32) and the expert stacks ``up`` / ``gate``
    ``[E, d, d_ff]`` and ``down`` ``[E, d_ff, d]``, normal draws at the
    reference's scales (1/sqrt(fan-in)), plus a shared-expert MLP of
    width ``d_ff * n_shared``.  A stack is drawn :data:`EXPERT_BLOCK`
    experts at a time, each block cast to ``dtype`` at once."""
    dev = resolve_device(device)
    s_up = d_model ** -0.5
    s_down = d_ff ** -0.5

    def stack(k, n, scale):
        # EXPERT_BLOCK experts at a time, each block cast to ``dtype`` at
        # once (one block is the whole stack up to EXPERT_BLOCK experts)
        out = torch.empty((n_experts, k, n), dtype=dtype, device=dev)
        for e0 in range(0, n_experts, EXPERT_BLOCK):
            e1 = min(e0 + EXPERT_BLOCK, n_experts)
            out[e0:e1] = _normal(generator, (e1 - e0, k, n), dev) * scale
        return out

    p = {
        "router": {"w": (_normal(generator, (d_model, n_experts), dev)
                         * s_up).to(torch.float32)},
        "up": stack(d_model, d_ff, s_up),
        "down": stack(d_ff, d_model, s_down),
    }
    if act == "swiglu":
        p["gate"] = stack(d_model, d_ff, s_up)
    if n_shared:
        p["shared"] = L.mlp_init(generator, d_model, d_ff * n_shared,
                                 act=act, noise=noise, dtype=dtype,
                                 device=dev)
    return p


def moe_specs(*, act="swiglu", n_shared=0,
              noise: NoiseConfig = NoiseConfig()):
    """The logical axes of :func:`moe_init`'s tree (the reference's
    sharding spec; on one device a declaration only)."""
    p = {
        "router": {"w": (None, None)},
        "up": ("expert", "embed", None),
        "down": ("expert", None, "embed"),
    }
    if act == "swiglu":
        p["gate"] = ("expert", "embed", None)
    if n_shared:
        p["shared"] = L.mlp_specs(act=act, noise=noise)
    return p


def _expert_names(act: str) -> list:
    return ["up", "down"] + (["gate"] if act == "swiglu" else [])


def moe_module_spec(d_model, d_ff, n_experts, *, top_k, act="swiglu",
                    n_shared=0, capacity_factor: float = 1.25,
                    dense: bool = False,
                    noise: NoiseConfig = NoiseConfig()):
    """Declare one MoE layer for the front door:
    ``api.compile(moe_module_spec(...), params, run)`` lowers every
    expert stack ONCE (one ``expert_stack`` group per stacked matrix:
    codes, column scales and gains baked) and ``CompiledModel.apply(x)``
    is :func:`moe_apply` over the pre-lowered tree.  ``params`` is
    :func:`moe_init`'s dict."""
    from repro_torch import api

    def _apply(model, x, *, noise=None):
        return moe_apply(model.lower(), x, acfg=model.acfg, top_k=top_k,
                         capacity_factor=capacity_factor, act=act,
                         dense=dense, noise=noise)

    names = _expert_names(act)
    layers = tuple(
        api.LayerSpec(n, d_ff if n == "down" else d_model,
                      d_model if n == "down" else d_ff, stacked=n_experts)
        for n in names)
    groups = tuple(api.GroupSpec(n, GROUP_EXPERT_STACK, (n,))
                   for n in names)
    return api.ModuleSpec(name=f"moe_{d_model}x{d_ff}x{n_experts}",
                          kind="tree", apply_fn=_apply, layers=layers,
                          groups=groups,
                          param_axes=moe_specs(act=act, n_shared=n_shared,
                                               noise=noise))


def _analog_expert_matmul(xe, w, acfg: AnalogConfig):
    """The PER-CALL expert product ``xe [E, C, K] x w [E, K, N]``: the
    expert stack's codes, column scales and gains derived in this call
    (:func:`repro_torch.exec.lower.lower_expert_stack`, one lowering),
    then the same single dispatch as a pre-lowered plan
    (:func:`repro_torch.exec.run.run_expert_stack`), so both paths agree
    bit for bit."""
    from repro_torch.exec.lower import lower_expert_stack
    from repro_torch.exec.run import run_expert_stack

    gp = GroupPlan(kind=GROUP_EXPERT_STACK,
                   fused=lower_expert_stack(w, acfg),
                   member_names=("w",), member_ns=(int(w.shape[-1]),))
    return run_expert_stack(gp, xe, acfg)


def _expert_matmul(xe, w, acfg: AnalogConfig, plan=None):
    """``xe [..., E, C, K] x w [E, K, N] -> [..., E, C, N]``; ``plan`` (a
    pre-lowered ``expert_stack`` :class:`GroupPlan`) replays the bake.
    Leading group dims fold into the capacity axis, so one dispatch runs
    the whole buffer."""
    if acfg.mode == "digital":
        return torch.matmul(xe, w.to(xe.dtype))

    def one(x3):
        if plan is not None:
            from repro_torch.exec.run import run_expert_stack

            return run_expert_stack(plan, x3, acfg)
        return _analog_expert_matmul(x3, w, acfg)

    if xe.ndim == 3:
        return one(xe)
    lead = xe.shape[:-3]
    e, c, k = xe.shape[-3:]
    x3 = xe.reshape(-1, e, c, k).transpose(0, 1).reshape(e, -1, k)
    y3 = one(x3)
    n = y3.shape[-1]
    return y3.reshape(e, -1, c, n).transpose(0, 1).reshape(*lead, e, c, n)


def _expert_ffn(params, xe, act, acfg: AnalogConfig):
    """``xe [..., E, C, d] -> [..., E, C, d]`` through the expert FFNs.  A
    compiled tree carries pre-lowered ``expert_stack`` plans in
    ``params["_groups"]`` (keyed by the member weight's name); raw
    params take the per-call derivation."""
    gps = params.get("_groups")

    def plan_of(name):
        return find_group(gps, GROUP_EXPERT_STACK, (name,))

    up = _expert_matmul(xe, params["up"], acfg, plan=plan_of("up"))
    if act == "swiglu":
        gate = _expert_matmul(xe, params["gate"], acfg,
                              plan=plan_of("gate"))
        h = L.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return _expert_matmul(h, params["down"], acfg, plan=plan_of("down"))


def _expert_rows(obj, lo: int, hi: int, e: int):
    """An expert-stack plan (or any plan dataclass below it) with every
    tensor whose leading axis is the expert axis (``e``) cut to experts
    ``lo:hi``; stores are rebuilt, so their derived tables are the cut's."""
    if isinstance(obj, torch.Tensor):
        return obj[lo:hi] if obj.ndim and obj.shape[0] == e else obj
    if type(obj) not in PYTREE_FIELDS:
        return obj
    return dataclasses.replace(obj, **{
        f: _expert_rows(getattr(obj, f), lo, hi, e)
        for f in PYTREE_FIELDS[type(obj)][0]})


def _local_experts(params, lo: int, hi: int) -> dict:
    """The expert FFN parameters (and pre-lowered ``expert_stack`` plans)
    of experts ``lo:hi``."""
    e = params["up"].shape[0]
    if hi - lo == e:        # a 1-way model axis: every expert is local
        return params
    out = {k: params[k][lo:hi] for k in ("up", "gate", "down")
           if k in params}
    if "_groups" in params:
        out["_groups"] = {
            name: _expert_rows(gp, lo, hi, e) if gp.kind == GROUP_EXPERT_STACK
            else gp for name, gp in params["_groups"].items()}
    return out


def _expert_block_shard_map(params, x, eg, pos_c, keep, tok, e, capacity,
                            act, acfg):
    """Expert-parallel FFN with explicit collectives (the reference's
    ``shard_map`` block): each ``model`` rank scatters the tokens of its
    ``e_loc`` LOCAL experts into a ``[B, e_loc, C, d]`` buffer (a copy
    routed elsewhere is masked out), runs its experts (one
    ``expert_stack`` dispatch on the card), and one all-gather of the
    expert outputs along axis 1 over ``model`` gives ``[B, E, C, d]``.
    The dynamic abs-max spans every rank's buffer, so the codes are the
    whole buffer's (``gspmd_ep``'s).  Under autograd the tokens' gradient
    is all-reduced over ``model`` (every rank's experts read them), and
    each rank's output block takes its part of the (agreeing) cotangent."""
    n_model = shd.axis_sizes()["model"]
    if e % n_model:
        raise ValueError(f"{e} experts do not split over a {n_model}-way "
                         "model axis")
    e_loc = e // n_model
    lo = shd.axis_index("model") * e_loc
    b, _, d = x.shape
    x = shd.psum_grad(x, "model")
    se_loc = eg - lo
    valid = keep & (se_loc >= 0) & (se_loc < e_loc)
    se_c = torch.clamp(se_loc, 0, e_loc - 1)
    src = torch.where(valid[..., None], x[:, tok], 0.0)
    buf = torch.zeros((b, e_loc * capacity, d), dtype=x.dtype,
                      device=x.device)
    buf.index_put_((torch.arange(b, device=x.device)[:, None],
                    se_c * capacity + pos_c), src, accumulate=True)
    with shd.amax_over("model"):
        ye_loc = _expert_ffn(_local_experts(params, lo, lo + e_loc),
                             buf.reshape(b, e_loc, capacity, d), act, acfg)
    return shd.gather_blocks(ye_loc, "model", dim=1)


def top_k_lower_index(probs: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries of the last
    axis, descending, equal values ordered by the lower index (the order
    ``jax.lax.top_k`` gives; ``torch.topk`` promises none on ties)."""
    idx = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(probs, -1, idx), idx


def _renormalize(topw: torch.Tensor) -> torch.Tensor:
    """The top-k weights over ``max(sum, 1e-9)``, the k summed in order."""
    tot = topw[..., :1]
    for j in range(1, topw.shape[-1]):
        tot = tot + topw[..., j:j + 1]
    return topw / torch.clamp_min(tot, 1e-9)


def route(probs: torch.Tensor, top_k: int, routes=None):
    """The router's top-k and the Switch aux loss from the softmax
    ``probs [B, S, E]``: ``(topw, topi, aux)``, weights renormalized by
    ``max(sum, 1e-9)``, ``aux = E * sum_e mean_prob_e * frac_routed_e``.
    ``routes`` (a :class:`Routes`) records the top-k, or replays another
    run's in its place, the aux loss's routed fractions included.  Inside
    a sharded step whose batch is split, both means are the whole
    batch's (summed over the split's ranks)."""
    e = probs.shape[-1]
    topw, topi = top_k_lower_index(probs, top_k)
    topw = _renormalize(topw)
    if routes is not None:
        topw, topi = routes.route(topw, topi, probs)
    n = shd.batch_count()
    if n == 1:
        me = probs.mean(dim=(0, 1))
    else:
        me = shd.batch_sum(probs.sum(dim=(0, 1))) / (
            probs.shape[0] * probs.shape[1] * n)
    ce = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    ce = ce.index_put_((topi.reshape(-1),),
                       torch.full((topi.numel(),), 1.0 / (topi.numel() * n),
                                  device=probs.device), accumulate=True)
    ce = shd.batch_sum(ce)
    aux = e * torch.sum(me * ce)
    return topw, topi, aux


def dispatch_layout(topi: torch.Tensor, e: int, capacity: int):
    """Group-local routing metadata of ``topi [B, S, k]`` for a
    ``[B, E, C]`` buffer: per routed copy (token-major flat index
    ``s * k + slot``) its expert, its clamped slot ``pos_c`` in that
    expert and whether it is kept (position < capacity), plus each
    token's slots in the sorted dispatch order.  Positions come from a
    stable sort over the expert ids and the segment starts, as in the
    reference."""
    b, s, k = topi.shape
    eg = topi.reshape(b, s * k)
    order = torch.argsort(eg, dim=-1, stable=True)
    se = torch.gather(eg, 1, order)
    n = s * k
    pos_global = torch.arange(n, device=topi.device).expand(b, n)
    seg_start = torch.full((b, e), n, dtype=torch.int64, device=topi.device)
    seg_start = seg_start.scatter_reduce(1, se, pos_global, reduce="amin")
    pos_sorted = pos_global - torch.gather(seg_start, 1, se)
    # back to the token-major order of the routed copies
    inv = torch.argsort(order, dim=-1)
    pos = torch.gather(pos_sorted, 1, inv)
    keep = pos < capacity
    pos_c = torch.where(keep, pos, capacity - 1)
    # each token's slots by their place in the sorted order (ascending
    # expert id): the order the reference's scatter-add sums them in
    slot_order = torch.argsort(inv.reshape(b, s, k), dim=-1)
    return eg, pos_c, keep, slot_order


def moe_apply(params, x, *, acfg: AnalogConfig, top_k: int,
              capacity_factor: float = 1.25, act="swiglu",
              dense: bool = False, dispatch: str = "gspmd_ep", noise=None,
              routes: Optional[Routes] = None):
    """``x [B, S, d] -> (y, aux)``.  The batch axis is the dispatch group:
    every routing index is group-local.  ``routes``: a :class:`Routes` that
    records this call's top-k, or replays another run's in its place (the aux
    loss's probabilities stay this call's router's).  ``noise`` reaches the
    shared expert (the expert products have no readout noise, as in the
    reference).  ``dispatch``: ``"shard_map"`` is the expert-parallel
    dispatch under a mesh with a ``model`` axis
    (:func:`_expert_block_shard_map`) and the ``"gspmd_ep"`` path without
    one; ``"gspmd_ep"`` and ``"replicated_buf"`` build the whole buffer
    (the same values: the reference's two differ only in a layout
    constraint)."""
    if dispatch not in DISPATCH:
        raise ValueError(f"moe dispatch {dispatch!r}: one of {DISPATCH}")
    b, s, d = x.shape
    e = params["router"]["w"].shape[-1]
    logits = x.to(torch.float32) @ params["router"]["w"]          # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    topw, topi, aux = route(probs, top_k, routes)

    if dense:
        # smoke-config fallback: every expert sees every token
        t = b * s
        w_full = torch.zeros((t, e), dtype=torch.float32, device=x.device)
        w_full.scatter_(1, topi.reshape(t, top_k), topw.reshape(t, top_k))
        xf = x.reshape(t, d)
        ye = _expert_ffn(params, xf[None].expand(e, t, d), act, acfg)
        y = torch.einsum("te,etd->td", w_full, ye.to(torch.float32))
        y = y.to(x.dtype).reshape(b, s, d)
    else:
        capacity = int(max(top_k, capacity_factor * s * top_k / e))
        eg, pos_c, keep, slot_order = dispatch_layout(topi, e, capacity)
        tok = torch.arange(s * top_k, device=x.device) // top_k     # [S k]
        if dispatch == "shard_map" and "model" in shd.axis_sizes():
            ye = _expert_block_shard_map(params, x, eg, pos_c, keep, tok, e,
                                         capacity, act, acfg)
        else:
            src = torch.where(keep[..., None], x[:, tok], 0.0)  # [B, Sk, d]
            # the [B, E, C, d] buffer: a kept copy owns its slot; the
            # dropped copies' clamped slot receives their zeros
            buf = torch.zeros((b, e * capacity, d), dtype=x.dtype,
                              device=x.device)
            buf.index_put_(
                (torch.arange(b, device=x.device)[:, None],
                 eg * capacity + pos_c), src, accumulate=True)
            ye = _expert_ffn(params, buf.reshape(b, e, capacity, d), act,
                             acfg)
        # combine: each routed copy's output at its slot, weighted (zero
        # when dropped), then each token's k copies summed in the sorted
        # dispatch order, in the activation dtype
        got = torch.gather(ye.reshape(b, e * capacity, d), 1,
                           (eg * capacity + pos_c)[..., None].expand(-1, -1, d))
        wk = torch.where(keep, topw.reshape(b, s * top_k), 0.0)
        contrib = (got * wk[..., None].to(x.dtype)).reshape(b, s, top_k, d)
        y = torch.zeros((b, s, d), dtype=x.dtype, device=x.device)
        for j in range(top_k):
            y = y + torch.gather(
                contrib, 2, slot_order[:, :, j, None, None].expand(
                    -1, -1, 1, d))[:, :, 0]

    if "shared" in params:
        y = y + L.mlp_apply(params["shared"], x, acfg, act=act, noise=noise)
    return y, aux
