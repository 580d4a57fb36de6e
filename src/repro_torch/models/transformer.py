"""Decoder LM (port of ``repro.models.transformer``): the dense
transformers, the MoE families, M-RoPE (Qwen2-VL), frontends fed
precomputed embeddings (Qwen2-VL, MusicGen), RWKV-6 (the ``rwkv`` kind)
and the Zamba2 hybrid (the ``mamba`` kind with a shared attention block).

Layers are grouped into homogeneous scan groups with stacked parameters,
as in the reference (dense: one layer per group; Llama-4: a [dense, moe]
pair per group; Zamba2: ``attn_every`` Mamba layers behind the shared
attention block, whose one unstacked parameter set every group applies
at its entry; every layer leaf with a leading ``[n_groups]`` axis).  The
reference scans the groups with ``lax.scan``; the port loops over them,
handing group ``i`` the ``i``-th slice of every parameter, plan and cache
leaf (:func:`stack_index`), and writes group ``i``'s recurrent states back
into slice ``i`` of the stacked cache (:func:`_store_group_cache`).

Every parameter matmul dispatches through the analog backend; the
execution mode (digital / analog_faithful / analog_fast) is a RunConfig
knob.  :func:`attach_block_plans` adds fused attention+MLP block plans
that replay a static prefill one dispatch per block.  :func:`lm_loss` is
the training objective, for every family; under autograd ``cfg.remat``
recomputes each scan group in the backward (``torch.utils.checkpoint``),
Zamba2's shared block at its entry included, its readout noise and its
MoE routing replayed.  Under autograd the RWKV and Mamba recurrences
recompute their states a segment at a time in the backward, so their
memory stays bounded at 4096 positions.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.noise import NoiseConfig, NoiseFeed
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.exec.plan import PlanStack
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as S

NOISE = NoiseConfig()  # module-level default, as in the reference


# ----------------------------------------------------------- group layout
def group_def(cfg: ArchConfig) -> list:
    """Kinds of the layers inside one scan group."""
    if cfg.block == "mamba" and cfg.attn_every:
        return ["mamba"] * cfg.attn_every          # + shared attn at entry
    if cfg.n_experts and cfg.moe_every > 1:
        return [cfg.layer_kind(i) for i in range(cfg.moe_every)]
    return [cfg.layer_kind(0)]


def n_groups(cfg: ArchConfig) -> int:
    g = len(group_def(cfg))
    if cfg.n_layers % g:
        raise ValueError(f"{cfg.n_layers} layers do not split into groups "
                         f"of {g}")
    return cfg.n_layers // g


def stack_index(node, i: int):
    """Group ``i`` of a scan-stacked tree: slice ``i`` of every tensor,
    member ``i`` of every :class:`PlanStack` and of every list."""
    if isinstance(node, dict):
        return {k: stack_index(v, i) for k, v in node.items()}
    if isinstance(node, (torch.Tensor, PlanStack, list)):
        return node[i]
    return node


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _stack(make, n: int):
    """``n`` draws of ``make()`` stacked along a new leading axis, filled
    in place (peak memory: the stack plus one draw; one draw is its own
    stack, a view with no copy)."""
    first = make()
    if n == 1:
        return _map(first, lambda t: t.unsqueeze(0))
    out = _map(first, lambda t: t.new_empty((n,) + tuple(t.shape)))

    def fill(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    fill(out, first, 0)
    del first
    for i in range(1, n):
        fill(out, make(), i)
    return out


# ------------------------------------------------------------------ init
def _layer_init(generator, kind: str, cfg: ArchConfig, device):
    kw = dict(noise=NOISE, dtype=cfg.dtype, device=device)
    if kind == "rwkv":
        return {
            "ln1": L.norm_init(cfg.d_model, cfg.norm, device),
            "rwkv": R.rwkv_init(generator, cfg.d_model, cfg.n_heads, **kw),
            "ln2": L.norm_init(cfg.d_model, cfg.norm, device),
            "cmix": R.channel_mix_init(generator, cfg.d_model, cfg.d_ff,
                                       **kw),
        }
    if kind == "mamba":
        return {"ln1": L.norm_init(cfg.d_model, cfg.norm, device),
                "mamba": S.mamba_init(generator, cfg.d_model,
                                      d_state=cfg.ssm_state, **kw)}
    if kind not in ("attn_mlp", "attn_moe"):
        raise ValueError(f"unknown layer kind {kind!r}")
    p = {
        "ln1": L.norm_init(cfg.d_model, cfg.norm, device),
        "attn": A.attention_init(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            noise=NOISE, dtype=cfg.dtype, device=device,
        ),
        "ln2": L.norm_init(cfg.d_model, cfg.norm, device),
    }
    if kind == "attn_mlp":
        p["mlp"] = L.mlp_init(generator, cfg.d_model,
                              cfg.moe_dense_d_ff or cfg.d_ff, act=cfg.act,
                              noise=NOISE, dtype=cfg.dtype, device=device)
    else:
        p["moe"] = M.moe_init(
            generator, cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
            n_shared=cfg.n_shared_experts, act=cfg.act, noise=NOISE,
            dtype=cfg.dtype, device=device)
    return p


def _layer_specs(kind: str, cfg: ArchConfig):
    p = {"ln1": L.norm_specs(cfg.norm)}
    if kind in ("attn_mlp", "attn_moe"):
        p["attn"] = A.attention_specs(NOISE)
        p["ln2"] = L.norm_specs(cfg.norm)
        if kind == "attn_mlp":
            p["mlp"] = L.mlp_specs(act=cfg.act, noise=NOISE)
        else:
            p["moe"] = M.moe_specs(act=cfg.act,
                                   n_shared=cfg.n_shared_experts, noise=NOISE)
    elif kind == "rwkv":
        p["rwkv"] = R.rwkv_specs(NOISE)
        p["ln2"] = L.norm_specs(cfg.norm)
        p["cmix"] = R.channel_mix_specs(NOISE)
    elif kind == "mamba":
        p["mamba"] = S.mamba_specs(NOISE)
    return p


def _group_init(generator, cfg: ArchConfig, device):
    return {f"l{i}": _layer_init(generator, kind, cfg, device)
            for i, kind in enumerate(group_def(cfg))}


def lm_init(generator: torch.Generator, cfg: ArchConfig,
            device: DeviceLike = None):
    """Random LM parameters from ``generator`` (drawn on the generator's
    own device), placed on ``device`` (``None`` = the CUDA device).  The
    tree has the reference's layout: ``embed``, ``layers`` (stacked
    groups), ``shared_attn`` (Zamba2's shared attention block, one
    unstacked parameter set), ``final_norm``, ``lm_head``."""
    dev = resolve_device(device)
    params = {}
    if cfg.embed_inputs:
        params["embed"] = L.embedding_init(generator, cfg.vocab_size,
                                           cfg.d_model, dtype=cfg.dtype,
                                           device=dev)
    params["layers"] = _stack(lambda: _group_init(generator, cfg, dev),
                              n_groups(cfg))
    if cfg.attn_every:   # zamba2's shared attention block
        params["shared_attn"] = {
            "ln": L.norm_init(cfg.d_model, cfg.norm, dev),
            "attn": A.attention_init(
                generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                noise=NOISE, dtype=cfg.dtype, device=dev),
        }
    params["final_norm"] = L.norm_init(cfg.d_model, cfg.norm, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.linear_init(
            generator, cfg.d_model, cfg.vocab_size, noise=NOISE,
            dtype=cfg.dtype, device=dev,
        )
    return params


def _prepend(specs, name="layers"):
    """Every logical-name tuple of a spec tree with ``name`` in front (the
    stacked groups' leading axis)."""
    if isinstance(specs, dict):
        return {k: _prepend(v, name) for k, v in specs.items()}
    return (name,) + tuple(specs)


def lm_specs(cfg: ArchConfig):
    """The logical axes of :func:`lm_init`'s tree (the reference's
    sharding spec; the ``param_axes`` of :func:`lm_module_spec`)."""
    specs = {}
    if cfg.embed_inputs:
        specs["embed"] = L.embedding_specs()
    group = {f"l{i}": _layer_specs(kind, cfg)
             for i, kind in enumerate(group_def(cfg))}
    specs["layers"] = _prepend(group)
    if cfg.attn_every:
        specs["shared_attn"] = {
            "ln": L.norm_specs(cfg.norm),
            "attn": A.attention_specs(NOISE),
        }
    specs["final_norm"] = L.norm_specs(cfg.norm)
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.linear_specs("embed", "vocab", noise=NOISE)
    return specs


def lm_module_spec(cfg: ArchConfig, params):
    """Declare the LM's analog layers once for the front door:
    ``api.compile(lm_module_spec(cfg, params), params, run)`` bakes every
    parameter matmul - the attention QKV fused into one dispatch group per
    scan-stacked layer - and ``CompiledModel.apply(batch, cache=,
    noise=)`` is :func:`lm_apply` over the pre-lowered tree."""
    from repro_torch import api

    def _apply(model, batch, *, cache=None, noise=None):
        return lm_apply(model.lower(), batch, cfg, model.run_cfg,
                        cache=cache, noise=noise)

    return api.tree_spec(f"lm_{cfg.name}", params, param_axes=lm_specs(cfg),
                         apply_fn=_apply)


# ------------------------------------------------------------------ apply
def _layer_apply(p, kind, x, *, cfg, run, positions, cache, noise=None,
                 routes=None):
    """One layer: ``(x, new_cache, aux)`` (aux: the MoE layer's
    load-balancing loss, 0.0 for a dense layer).  ``routes``: the MoE
    layers' :class:`~repro_torch.models.moe.Routes`."""
    acfg = run.analog
    if kind == "rwkv":
        h = L.norm_apply(p["ln1"], x, cfg.norm)
        y, c1 = R.rwkv_apply(p["rwkv"], h, acfg=acfg, n_heads=cfg.n_heads,
                             cache=None if cache is None else cache["tmix"],
                             noise=noise)
        x = x + y.to(x.dtype)
        h = L.norm_apply(p["ln2"], x, cfg.norm)
        y, c2 = R.channel_mix_apply(
            p["cmix"], h, acfg=acfg,
            cache=None if cache is None else cache["cmix"], noise=noise)
        x = x + y.to(x.dtype)
        return x, (None if cache is None else {"tmix": c1, "cmix": c2}), 0.0
    if kind == "mamba":
        h = L.norm_apply(p["ln1"], x, cfg.norm)
        y, c = S.mamba_apply(p["mamba"], h, acfg=acfg, d_state=cfg.ssm_state,
                             cache=None if cache is None else cache["mamba"],
                             noise=noise)
        x = x + y.to(x.dtype)
        return x, (None if cache is None else {"mamba": c}), 0.0
    bp = p.get("_block_plan")
    if (bp is not None and cache is None and not cfg.mrope
            and x.shape[1] == bp.block.seq):
        # pre-lowered fused block plan (attach_block_plans): the whole
        # attention+MLP block replays as ONE dispatch.  Static prefill
        # only - the baked attention assumes positions 0..seq-1 and no
        # cache; decode and other lengths keep the per-layer path below
        from repro_torch.exec.run import run as run_plan

        return run_plan(bp, x, noise=noise), None, 0.0
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    attn_out, c = A.attention_apply(
        p["attn"], h, positions=positions, acfg=acfg,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, mrope=cfg.mrope,
        cache=None if cache is None else cache["attn"],
        flash_blocks=(run.flash_block_q, run.flash_block_kv), noise=noise,
        attn_cp=run.attn_cp,
    )
    x = x + attn_out.to(x.dtype)
    h = L.norm_apply(p["ln2"], x, cfg.norm)
    if kind == "attn_mlp":
        y = L.mlp_apply(p["mlp"], h, acfg, act=cfg.act, noise=noise)
        aux = 0.0
    else:
        y, aux = M.moe_apply(
            p["moe"], h, acfg=acfg, top_k=cfg.top_k,
            capacity_factor=run.capacity_factor, act=cfg.act, noise=noise,
            dispatch=run.moe_dispatch, routes=routes)
    x = x + y.to(x.dtype)
    return x, (None if cache is None else {"attn": c}), aux


def _group_view(gp, shardings, cfg: ArchConfig, run: RunConfig):
    """One scan group's parameters as this rank runs them under a mesh
    (:mod:`repro_torch.distributed.tensor_parallel`): the group's leaves
    gathered over every axis but the ``model`` axis's blocks of the
    attention heads, the MLP columns and the expert stacks; an RWKV or
    Mamba layer and a block plan whole."""
    acfg = run.analog
    out = {}
    for i, kind in enumerate(group_def(cfg)):
        p, sh = gp[f"l{i}"], shardings[f"l{i}"]
        if kind not in ("attn_mlp", "attn_moe") or "_block_plan" in p:
            out[f"l{i}"] = shd.gather_leaf(p, sh)
            continue
        v = {"ln1": shd.gather_leaf(p["ln1"], sh["ln1"]),
             "attn": tp.attention_view(p["attn"], sh["attn"], acfg,
                                       cfg.n_heads, cfg.n_kv_heads),
             "ln2": shd.gather_leaf(p["ln2"], sh["ln2"])}
        if kind == "attn_mlp":
            v["mlp"] = tp.mlp_view(p["mlp"], sh["mlp"], acfg)
        else:
            v["moe"] = tp.moe_view(p["moe"], sh["moe"], run.moe_dispatch)
        out[f"l{i}"] = v
    return out


def _group_apply(gp, x, *, cfg, run, positions, cache, noise=None,
                 routes=None, shared_attn=None, shardings=None):
    """One scan group: ``(x, new_cache, aux)``, the group's MoE aux
    losses summed in layer order.  ``shared_attn``: Zamba2's shared
    attention block, applied at the group's entry with the group's own
    KV cache.  ``shardings``: the group's, when ``gp`` holds this rank's
    blocks (the group's view is gathered here, :func:`_group_view`, so a
    remat recompute gathers it again)."""
    if shardings is not None:
        gp = _group_view(gp, shardings, cfg, run)
    new_cache = {} if cache is not None else None
    aux_total = 0.0
    if shared_attn is not None:
        h = L.norm_apply(shared_attn["ln"], x, cfg.norm)
        y, c = A.attention_apply(
            shared_attn["attn"], h, positions=positions, acfg=run.analog,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta,
            cache=None if cache is None else cache["shared_attn"],
            flash_blocks=(run.flash_block_q, run.flash_block_kv), noise=noise,
            attn_cp=run.attn_cp)
        x = x + y.to(x.dtype)
        if cache is not None:
            new_cache["shared_attn"] = c
    for i, kind in enumerate(group_def(cfg)):
        x, c, aux = _layer_apply(
            gp[f"l{i}"], kind, x, cfg=cfg, run=run, positions=positions,
            cache=None if cache is None else cache[f"l{i}"], noise=noise,
            routes=routes,
        )
        aux_total = aux_total + aux
        if cache is not None:
            new_cache[f"l{i}"] = c
    return x, new_cache, aux_total


def _noise_state(noise):
    if isinstance(noise, torch.Generator):
        return noise.get_state()
    if isinstance(noise, NoiseFeed):
        return noise.pos
    return None


def _set_noise_state(noise, state) -> None:
    if isinstance(noise, torch.Generator):
        noise.set_state(state)
    elif isinstance(noise, NoiseFeed):
        noise.pos = state


def _remat_group(gp, x, *, cfg, run, positions, noise, routes=None,
                 shared_attn=None, shardings=None):
    """One scan group under ``torch.utils.checkpoint``: ``(x, aux)``, the
    backward recomputing the group from its input ``x`` (the reference's
    ``jax.checkpoint``).  The checkpoint restores only the default
    generators, so the recompute rewinds the readout-noise source (a
    generator's state, a feed's position) to where the first forward
    drew, replays the same draws - the HIL backward linearizes around the
    same codes - and leaves the source where the first forward left it.
    The MoE layers' routing is replayed too: when ``routes`` (a
    :class:`~repro_torch.models.moe.Routes`, which sees each call once)
    replays another run's, the recompute takes the routes the first
    forward took."""
    start = _noise_state(noise)
    first = len(routes.taken) if routes is not None else 0
    calls = []

    def apply(h, rts):
        y, _, aux = _group_apply(gp, h, cfg=cfg, run=run,
                                 positions=positions, cache=None,
                                 noise=noise, routes=rts,
                                 shared_attn=shared_attn,
                                 shardings=shardings)
        return y, torch.as_tensor(aux, dtype=torch.float32, device=y.device)

    def fn(h):
        if not calls:
            calls.append(1)
            return apply(h, routes)
        end = _noise_state(noise)
        _set_noise_state(noise, start)
        rts = None
        if routes is not None:
            # the ops the first forward ran: a replay replays, a recording
            # run routes itself again (the same routes on one device)
            rts = M.Routes(replay=routes.taken[first:]) \
                if routes.replaying else M.Routes()
        try:
            return apply(h, rts)
        finally:
            _set_noise_state(noise, end)

    return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)


def lm_apply(params, batch, cfg: ArchConfig, run: RunConfig, *,
             cache: Optional[dict] = None, noise=None, routes=None):
    """batch: {"tokens": [B,S] ints} or {"embeds": [B,S,d]}, optional
    {"positions": [B,S]} ([B,S,3] (t, h, w) ids under M-RoPE; without
    them the positions broadcast over the three).  Returns (logits,
    new_cache, aux), aux the MoE layers' load-balancing loss summed over
    the groups (0.0 without MoE layers).  ``routes``: a
    :class:`~repro_torch.models.moe.Routes` that records the MoE layers'
    routing, or replays another run's.

    With a cache (:func:`init_lm_cache`) the KV tensors are updated in
    place, the recurrent states (RWKV's ``x_prev`` / ``state``, Mamba's
    ``conv`` / ``state``) are written into the stacked cache, and the
    returned cache holds the advanced lengths.  ``noise``:
    the readout-noise source of every analog layer (a ``torch.Generator``
    drawn in call order, or a :class:`~repro_torch.core.noise.NoiseFeed`
    of injected draws), ignored when ``run.analog.deterministic``.  Under
    autograd without a cache, ``cfg.remat`` recomputes each group in the
    backward (:func:`_remat_group`); the values do not change.

    Inside :func:`~repro_torch.distributed.sharding.sharded_params`,
    ``params`` are this rank's blocks: each scan group's leaves are
    gathered as the group runs (never the whole tree), the heads, MLP
    columns and vocabulary computed on this rank's block of the
    ``model`` axis (:mod:`repro_torch.distributed.tensor_parallel`).  The
    logits are then this rank's vocabulary block: the loss reduces them
    where they are (:func:`lm_loss`), the serve steps gather the last
    position's (:func:`repro_torch.serve.serve_step.serve_decode`)."""
    acfg = run.analog
    psh = shd.param_shardings()
    if psh is not None and not shd.splits(psh):
        psh = None          # a mesh of 1-sized axes: the tree is whole

    def sh(*keys):
        """The shardings under ``keys`` (None: the tree is whole)."""
        node = psh
        for k in keys:
            node = None if node is None else node[k]
        return node
    adt = (torch.bfloat16 if run.activation_dtype == "bfloat16"
           else torch.float32)
    if cfg.embed_inputs:
        x = L.embedding_apply(tp.embedding_view(params["embed"],
                                                sh("embed")), batch["tokens"])
    else:
        x = batch["embeds"]
    x = x.to(adt)
    b, s = x.shape[:2]
    if "positions" in batch:
        positions = batch["positions"]
    else:
        start = cache["step"] if cache is not None else 0
        pos = start + torch.arange(s, dtype=torch.int32, device=x.device)
        positions = torch.broadcast_to(pos[None, :], (b, s))
        if cfg.mrope:
            positions = torch.broadcast_to(positions[..., None], (b, s, 3))

    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    layer_cache = None if cache is None else cache["layers"]
    shared = params.get("shared_attn")
    if shared is not None:
        shared = {"ln": shd.gather_leaf(shared["ln"],
                                        sh("shared_attn", "ln")),
                  "attn": tp.attention_view(
                      shared["attn"], sh("shared_attn", "attn"), acfg,
                      cfg.n_heads, cfg.n_kv_heads)}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    retyped: dict = {}
    for i in range(n_groups(cfg)):
        gp = stack_index(params["layers"], i)
        gsh = shd.stack_shardings(sh("layers"), i)
        if remat:
            x, aux_g = _remat_group(gp, x, cfg=cfg, run=run,
                                    positions=positions, noise=noise,
                                    routes=routes, shared_attn=shared,
                                    shardings=gsh)
            aux = aux + aux_g
            continue
        x, nc, aux_g = _group_apply(
            gp, x, cfg=cfg, run=run, positions=positions,
            cache=None if layer_cache is None else stack_index(layer_cache,
                                                               i),
            noise=noise, routes=routes, shared_attn=shared, shardings=gsh,
        )
        aux = aux + aux_g
        if layer_cache is not None:
            _store_group_cache(layer_cache, nc, i, retyped)
    for node, k, vals in retyped.values():
        node[k] = torch.stack(vals)

    x = L.norm_apply(shd.gather_leaf(params["final_norm"],
                                     sh("final_norm")), x, cfg.norm)
    if cfg.tie_embeddings:
        head = tp.embedding_view(params["embed"], sh("embed"))
    else:
        head = tp.linear_view(params["lm_head"], sh("lm_head"), "col", acfg)
    if tp.split_cols(head):
        # every rank's vocabulary block reads x: its gradient sums over
        # the ranks
        x = shd.psum_grad(x, shd.split_axes(tp.MODEL))
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, head["table"].to(x.dtype))
    else:
        logits = L.linear_apply(head, x, acfg, noise=noise)
    new_cache = None
    if cache is not None:
        new_cache = {"layers": layer_cache, "step": cache["step"] + s}
    return logits, new_cache, aux


def attach_block_plans(params, cfg: ArchConfig, acfg, *, seq: int):
    """Pre-lower every ``attn_mlp`` block of an LM into a fused
    attention+MLP plan (:func:`repro_torch.exec.lower.lower_block`) and
    attach it as a ``"_block_plan"`` entry beside the block's parameters.
    :func:`lm_apply` then replays each of those blocks as ONE dispatch on
    static prefills of length ``seq`` (no cache, default positions);
    decode and other lengths keep the per-layer path.

    The scan groups hold stacked parameters: each slice is lowered on its
    own into a :class:`~repro_torch.exec.plan.PlanStack` of block plans
    (the reference vmaps the lowering), so every block's weights stay
    contiguous.  ``acfg`` must be megakernel-eligible (``act_calib ==
    "static"``, none/split signed encoding); the architecture must use
    the glue the kernel bakes (rmsnorm + swiglu, plain RoPE).  ``params``
    may be a raw or a pre-lowered tree.
    """
    from repro_torch.exec.lower import lower_block

    if cfg.norm != "rmsnorm" or cfg.act != "swiglu" or cfg.mrope:
        raise ValueError(
            "attach_block_plans: the fused block kernel bakes rmsnorm + "
            f"swiglu + plain RoPE glue; got norm={cfg.norm!r}, "
            f"act={cfg.act!r}, mrope={cfg.mrope}"
        )
    acfg = getattr(acfg, "analog", acfg)
    new_layers = dict(params["layers"])
    for i, kind in enumerate(group_def(cfg)):
        if kind != "attn_mlp":
            continue
        node = new_layers[f"l{i}"]
        block = {k: node[k] for k in ("ln1", "attn", "ln2", "mlp")}
        plans = PlanStack(
            lower_block(stack_index(block, s), acfg, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                        seq=seq, rope_theta=cfg.rope_theta)
            for s in range(n_groups(cfg)))
        new_layers[f"l{i}"] = {**node, "_block_plan": plans}
    return {**params, "layers": new_layers}


_STATES = ("x_prev", "state", "conv")


def _store_group_cache(stacked, group_cache, i: int, retyped: dict) -> None:
    """Write group ``i``'s advanced cache back into the stacked cache: its
    lengths, and its recurrent states into slice ``i`` (its KV tensors
    were updated in place).  A state whose dtype differs from the stacked
    leaf's (RWKV's ``x_prev`` leaves the layer in the activation dtype,
    as in the reference) is collected in ``retyped`` under ``(node,
    key)``; the caller stacks those anew once every group has read its
    slice."""
    for k, v in group_cache.items():
        if isinstance(v, dict):
            _store_group_cache(stacked[k], v, i, retyped)
        elif k == "len":
            stacked[k][i] = v
        elif k in _STATES:
            if v.dtype == stacked[k].dtype:
                stacked[k][i].copy_(v)
            else:
                retyped.setdefault((id(stacked), k), (stacked, k, []))[
                    2].append(v)


# ------------------------------------------------------------------ cache
def init_lm_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device: DeviceLike = None):
    """The decode cache: per group and layer a cache with a leading
    ``[n_groups]`` axis, plus the global step.  An attention layer (and
    Zamba2's shared attention block, one cache per group) holds a KV
    cache with one length per group; ``dtype=torch.int8`` stores int8
    codes with fp32 per-(position, head) ``k_scale`` / ``v_scale``.  An
    RWKV layer holds the time mix's ``x_prev`` (in ``dtype``) and fp32
    WKV ``state``, and the channel mix's ``x_prev``; a Mamba layer its
    fp32 conv carry and SSM ``state``."""
    ng = n_groups(cfg)
    dev = resolve_device(device)

    def zeros(shape, dt=torch.float32):
        return torch.zeros((ng,) + tuple(shape), dtype=dt, device=dev)

    def stacked_attn():
        c = A.init_cache(batch * ng, max_len, cfg.n_kv_heads, cfg.hd,
                         dtype, dev)
        out = {k: t.reshape((ng, batch) + tuple(t.shape[1:]))
               for k, t in c.items() if k != "len"}
        out["len"] = [0] * ng
        return out

    def layer(kind):
        if kind == "rwkv":
            hd = cfg.d_model // cfg.n_heads
            return {"tmix": {"x_prev": zeros((batch, cfg.d_model), dtype),
                             "state": zeros((batch, cfg.n_heads, hd, hd))},
                    "cmix": {"x_prev": zeros((batch, cfg.d_model), dtype)}}
        if kind == "mamba":
            d_in = 2 * cfg.d_model
            return {"mamba": {
                "conv": zeros((batch, S.CONV_K - 1,
                               d_in + 2 * cfg.ssm_state)),
                "state": zeros((batch, d_in // 64, 64, cfg.ssm_state))}}
        return {"attn": stacked_attn()}

    group = {f"l{i}": layer(kind) for i, kind in enumerate(group_def(cfg))}
    if cfg.attn_every:
        group["shared_attn"] = stacked_attn()
    return {"layers": group, "step": 0}


def _layer_cache_specs(kind, dtype=torch.bfloat16):
    if kind == "rwkv":
        return {"tmix": R.rwkv_cache_specs(),
                "cmix": {"x_prev": ("batch", None)}}
    if kind == "mamba":
        return {"mamba": S.mamba_cache_specs()}
    return {"attn": A.cache_specs(dtype)}


def lm_cache_specs(cfg: ArchConfig, dtype=torch.bfloat16):
    """The logical axes of :func:`init_lm_cache`'s tree: every leaf with
    the groups' leading ``layers`` axis; the step and the lengths are
    replicated."""
    group = {f"l{i}": _layer_cache_specs(kind, dtype)
             for i, kind in enumerate(group_def(cfg))}
    if cfg.attn_every:
        group["shared_attn"] = A.cache_specs(dtype)
    return {"layers": _prepend(group), "step": ()}


# ------------------------------------------------------------------- loss
def _vocab_block_logz_gold(logits, labels):
    """``(logsumexp, gold logit)`` of logits split along the vocabulary
    over ``model`` (this rank's block), in fp32: the max all-reduced, the
    exponentials' sums and the gold logit (each label's one rank holds
    it, the others add zeros) summed over the ranks, each rank's term
    taking its own gradient.  Within fp32 rounding of the whole
    vocabulary's ``torch.logsumexp`` (the sums run in another order)."""
    lf = logits.to(torch.float32)
    v = lf.shape[-1]
    top = shd.all_reduce(lf.detach().amax(dim=-1, keepdim=True), tp.MODEL,
                         op="max")
    logz = torch.log(shd.sum_over(torch.exp(lf - top).sum(dim=-1),
                                  tp.MODEL)) + top[..., 0]
    local = labels.to(torch.int64) - shd.axis_index(tp.MODEL) * v
    mine = (local >= 0) & (local < v)
    gold = torch.gather(logits, -1, torch.clamp(local, 0, v - 1)[..., None]
                        )[..., 0].to(torch.float32)
    gold = shd.sum_over(torch.where(mine, gold, torch.zeros_like(gold)),
                        tp.MODEL)
    return logz, gold


def lm_loss(params, batch, cfg: ArchConfig, run: RunConfig, noise=None,
            routes=None):
    """Next-token cross-entropy + 0.01 x the MoE aux loss (0 for the
    dense families).  ``batch`` needs ``"labels"``; an optional ``"mask"``
    weights the positions.  Returns ``(loss, {"nll", "aux",
    "logit_z"})``; the reductions run in fp32 over the activation-dtype
    logits, as in the reference.  ``routes``: :func:`lm_apply`'s.  Logits
    that are this rank's vocabulary block (tensor parallelism) reduce
    vocabulary-parallel (:func:`_vocab_block_logz_gold`), never
    gathered."""
    logits, _, aux = lm_apply(params, batch, cfg, run, noise=noise,
                              routes=routes)
    labels = batch["labels"]
    if logits.shape[-1] != cfg.vocab_size:
        logz, gold = _vocab_block_logz_gold(logits, labels)
    else:
        logz = torch.logsumexp(logits.to(torch.float32), dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].to(torch.int64)
                            )[..., 0].to(torch.float32)
    nll = logz - gold
    mask = batch.get("mask")
    n = shd.batch_count()
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp_min(shd.batch_sum(mask.sum()), 1.0)
    else:
        denom = nll.numel() * n
    aux = torch.as_tensor(aux, dtype=torch.float32, device=nll.device)
    # inside a sharded step whose batch is split, the sums are the whole
    # batch's (batch_sum; the identity without a split)
    nll_sum = shd.batch_sum(nll.sum())
    loss = nll_sum / denom + 0.01 * aux
    logit_z = torch.mean(logz ** 2) if n == 1 else \
        shd.batch_sum(torch.sum(logz ** 2)) / (logz.numel() * n)
    metrics = {"nll": nll_sum / denom, "aux": aux, "logit_z": logit_z}
    return loss, metrics
