"""The LM training step (port of ``repro.train.train_step``).

State layout, as in the reference:
    state = {"params": ..., "opt": {"step", "m", "v"}, ["ef": ...]}
``ef`` (the int8 compression's error feedback) appears when
``run.grad_compression`` is on.  The state is donated: a step updates
the caller's tensors in place (the reference's jit donates its state the
same way), so a full-size model never holds two copies of its
parameters and moments.

Under a mesh (:func:`make_train_step` with one active) the state and the
batch are this rank's blocks (``shard_tree`` of :func:`state_specs` /
:func:`batch_specs`): the step runs the forward and backward on its batch
block, each layer's leaves gathered as it runs and the heads, MLP columns
and vocabulary computed on this rank's ``model`` block
(:mod:`repro_torch.distributed.tensor_parallel`; whole-batch reductions
summed over the batch axes).  The gathers' backward hands each leaf's
gradient back as this rank's block, summed over the batch axes that
split it (an FSDP leaf's reduce-scatter over ``data``);
:func:`reduce_grads` sums it over the batch axes that do not, and AdamW
updates the blocks with the whole tree's gradient norm.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.device import DeviceLike
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.train import compression as C
from repro_torch.train import optimizer as O


def make_opt_config(run: RunConfig, total_steps: int = 10_000
                    ) -> O.AdamWConfig:
    return O.AdamWConfig(
        lr=run.learning_rate,
        weight_decay=run.weight_decay,
        grad_clip=run.grad_clip,
        warmup_steps=run.warmup_steps,
        total_steps=total_steps,
        state_dtype=run.optim_dtype,
    )


def init_state(generator: torch.Generator, cfg: ArchConfig, run: RunConfig,
               opt_cfg: Optional[O.AdamWConfig] = None,
               device: DeviceLike = None):
    """Random parameters from ``generator`` (:func:`~repro_torch.models.
    transformer.lm_init`) on ``device`` (``None`` = the CUDA device),
    zero AdamW moments and, under ``run.grad_compression``, zero error
    feedback."""
    opt_cfg = opt_cfg or make_opt_config(run)
    params = T.lm_init(generator, cfg, device=device)
    state = {"params": params, "opt": O.adamw_init(params, opt_cfg)}
    if run.grad_compression:
        state["ef"] = C.ef_init(params)
    return state


def state_specs(cfg: ArchConfig, run: RunConfig):
    """The logical axes of :func:`init_state`'s tree."""
    pspecs = T.lm_specs(cfg)
    specs = {"params": pspecs, "opt": O.opt_state_specs(pspecs)}
    if run.grad_compression:
        specs["ef"] = pspecs
    return specs


def batch_specs(cfg: ArchConfig):
    """The logical axes of a training batch."""
    if cfg.embed_inputs:
        return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    return {"embeds": ("batch", "seq", None), "labels": ("batch", "seq")}


def loss_and_grads(params, batch, noise=None, *, cfg: ArchConfig,
                   run: RunConfig, routes=None):
    """The differentiated half of a step: ``(loss, metrics, grads)`` of
    :func:`~repro_torch.models.transformer.lm_loss` with respect to every
    leaf of ``params`` (zeros where a leaf does not reach the loss, as
    ``jax.value_and_grad`` gives them).

    The analog layers go through the front door INSIDE the differentiated
    function: ``api.compile`` re-bakes the plans from the float masters
    every step (QKV fused into one dispatch group), and the STE
    quantizers of the lowering carry the HIL gradients back to the
    masters - compile-per-step is the hardware-in-the-loop contract.
    ``noise``: the readout-noise source (a ``torch.Generator`` or a
    :class:`~repro_torch.core.noise.NoiseFeed`), ignored when
    ``run.analog`` is deterministic or digital.  ``routes``: a
    :class:`~repro_torch.models.moe.Routes` that records the MoE layers'
    routing or replays another run's (a card-against-CPU check; off by
    default)."""
    from repro_torch import api

    acfg = run.analog
    if acfg.deterministic or acfg.mode == "digital":
        noise = None
    # leaf views of the masters that record gradients (shared storage)
    params = O.tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = O.tree_leaves(params)
    pshard = shd.param_shardings()
    with torch.enable_grad():
        if pshard is not None and shd.splits(pshard):
            # this rank's blocks: each layer is lowered from its gathered
            # view as it runs (a block's lowering is not the whole leaf's)
            tree = params
        else:
            tree = api.compile(T.lm_module_spec(cfg, params), params, run,
                               device=leaves[0].device).lower()
        loss, metrics = T.lm_loss(tree, batch, cfg, run, noise=noise,
                                  routes=routes)
        del tree
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, _unflatten(params, iter(grads))


def apply_update(state, grads, *, opt_cfg: O.AdamWConfig,
                 shardings=None) -> dict:
    """The update half of a step, in place on ``state``: the optional int8
    gradient compression with error feedback, then AdamW.  Returns the
    optimizer's metrics.  Not safe to repeat after a failure: the leaves
    written before it are written again on a second call.
    ``shardings``: the parameters' sharding tree when the state and the
    gradients are this rank's blocks."""
    with torch.no_grad():
        if "ef" in state:
            # int8 gradient compression with error feedback: the codes are
            # what would cross the data-parallel axes
            comp, state["ef"] = C.compress_grads(grads, state["ef"],
                                                 shardings)
            grads = C.decompress_grads(comp)
        return O.adamw_update_(state["params"], grads, state["opt"], opt_cfg,
                               shardings)


def train_step(state, batch, noise=None, *, cfg: ArchConfig,
               run: RunConfig, opt_cfg: O.AdamWConfig, routes=None):
    """One optimization step (:func:`loss_and_grads`, then
    :func:`apply_update`); returns ``(state, metrics)``, ``state`` updated
    in place.  The metrics stay on the device."""
    loss, metrics, grads = loss_and_grads(state["params"], batch, noise,
                                          cfg=cfg, run=run, routes=routes)
    opt_metrics = apply_update(state, grads, opt_cfg=opt_cfg)
    return state, {**metrics, **opt_metrics, "loss": loss}


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    return next(it)


def reduce_grads(grads, shardings, batch_axes):
    """This rank's block gradients of one batch block -> its blocks of the
    whole batch's gradients: summed over the ``batch_axes`` that do not
    split the leaf.  The per-layer gathers' backward
    (:func:`~repro_torch.distributed.sharding.gather_leaf`) already summed
    each leaf's over the batch axes that split it, and cut it to this
    rank's block."""
    def one(g, ns):
        split = {a for _, axes in shd.split_dims(ns, g.ndim) for a in axes}
        rest = tuple(a for a in batch_axes if a not in split)
        return shd.all_reduce(g, rest) if rest else g

    return O.tree_map(one, grads, shardings)


class MeshTrainStep:
    """The step under a mesh: ``step(state, batch, noise=None,
    routes=None) -> (state, metrics)`` on this rank's blocks of the state
    and the batch (``shard_tree(state, step.state_shardings)``,
    ``shard_tree(batch, step.batch_shardings)``), the state updated in
    place.  ``noise`` and ``routes`` are the whole batch's (each rank
    takes its rows of every draw)."""

    def __init__(self, cfg: ArchConfig, run: RunConfig,
                 opt_cfg: O.AdamWConfig, state_shardings, batch_shardings):
        self.cfg, self.run, self.opt_cfg = cfg, run, opt_cfg
        self.state_shardings = state_shardings
        self.batch_shardings = batch_shardings
        lead = next(iter(batch_shardings.values())).spec
        self.batch_axes = shd.split_axes(lead[0] if lead else None)

    def loss_and_grads(self, state, batch, noise=None, routes=None):
        """``(loss, metrics, grads)``: the whole batch's loss and metrics,
        this rank's blocks of the whole batch's gradients."""
        pshard = self.state_shardings["params"]
        with shd.batch_split(self.batch_axes), shd.sharded_params(pshard):
            loss, metrics, grads = loss_and_grads(
                state["params"], batch, noise, cfg=self.cfg, run=self.run,
                routes=routes)
        return loss, metrics, reduce_grads(grads, pshard, self.batch_axes)

    def __call__(self, state, batch, noise=None, routes=None):
        loss, metrics, grads = self.loss_and_grads(state, batch, noise,
                                                   routes)
        opt_metrics = apply_update(
            state, grads, opt_cfg=self.opt_cfg,
            shardings=self.state_shardings["params"])
        return state, {**metrics, **opt_metrics, "loss": loss}


def make_train_step(cfg: ArchConfig, run: RunConfig,
                    opt_cfg: Optional[O.AdamWConfig] = None,
                    total_steps: int = 10_000, abstract_state=None,
                    abstract_batch=None):
    """``step(state, batch, noise=None, routes=None) -> (state, metrics)``,
    the state donated (updated in place).  ``batch`` holds ``tokens`` (or
    ``embeds`` for the configs fed precomputed embeddings) and ``labels``
    on the state's device.  Every family of the registry trains.

    Without a mesh, the step for one device.  Under a mesh, a
    :class:`MeshTrainStep` whose shardings resolve shape-aware against
    ``abstract_state`` / ``abstract_batch`` (trees of tensors of the
    whole shapes, on the meta device if need be; the state's default is
    :func:`init_state`'s on meta)."""
    opt_cfg = opt_cfg or make_opt_config(run, total_steps)
    if shd.get_mesh() is None:
        return functools.partial(train_step, cfg=cfg, run=run,
                                 opt_cfg=opt_cfg)
    if abstract_state is None:
        abstract_state = init_state(torch.Generator(), cfg, run, opt_cfg,
                                    device="meta")
    sspec = shd.sharding_like(state_specs(cfg, run), abstract_state)
    if abstract_batch is not None:
        bspec = shd.sharding_like(batch_specs(cfg), abstract_batch)
    else:
        bspec = shd.tree_sharding(batch_specs(cfg))
    return MeshTrainStep(cfg, run, opt_cfg, sspec, bspec)
