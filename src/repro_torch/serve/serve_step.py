"""Serving steps (port of ``repro.serve.serve_step``): prefill (process a
full prompt, fill the cache) and decode (one new token against the
cache), over a float or an int8 KV cache (``T.init_lm_cache(dtype=)``).
The steps run eagerly; the reference jits them.

Under a mesh the parameters are this rank's blocks, and each step
all-gathers them first; the batch splits over the mesh's batch axes
(each rank runs its rows against its block of the cache, which it holds
whole along every other dim), and the logits are all-gathered, so every
rank samples the same tokens.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as T


def serve_prefill(params, batch, cache, *, cfg: ArchConfig, run: RunConfig):
    """Prompt pass: fills the cache, returns last-position logits."""
    logits, cache, _ = T.lm_apply(params, batch, cfg, run, cache=cache)
    return logits[:, -1], cache


def serve_decode(params, tokens_or_embeds, cache, *, cfg: ArchConfig,
                 run: RunConfig):
    """One decode step: [B, 1] token (or embed) -> [B, vocab] logits."""
    key = "tokens" if cfg.embed_inputs else "embeds"
    logits, cache, _ = T.lm_apply(params, {key: tokens_or_embeds}, cfg, run,
                                  cache=cache)
    return logits[:, -1], cache


def cache_sharding(cfg: ArchConfig, dtype=torch.bfloat16):
    """The decode cache's shardings (shape-unaware), None without a
    mesh."""
    return shd.tree_sharding(T.lm_cache_specs(cfg, dtype))


def batch_axes(b: int) -> tuple:
    """The mesh axes (of size > 1) a batch of ``b`` rows splits over: the
    ``batch`` rule's, shape-aware (a batch they do not divide stays whole
    on every rank)."""
    return shd.split_axes(shd.resolve_spec(("batch",), (b,))[0])


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None):
    """A zero decode cache for ``batch`` rows: under a mesh this rank's
    rows of it (the batch's split, :func:`batch_axes`)."""
    _, n = shd.block_index(batch_axes(batch)) if shd.get_mesh() is not None \
        else (0, 1)
    return T.init_lm_cache(cfg, batch // n, max_len, dtype=dtype,
                           device=device)


class MeshServeStep:
    """A prefill or decode step under a mesh: ``step(params, inputs,
    cache) -> (logits, cache)`` with ``params`` this rank's blocks
    (:attr:`param_shardings`), ``inputs`` the whole batch (a batch dict or
    a ``[B, 1]`` tensor) and ``cache`` this rank's rows of the decode
    cache (:func:`init_cache`); the logits are the whole batch's."""

    def __init__(self, fn, cfg: ArchConfig, param_shardings):
        self.fn, self.cfg = fn, cfg
        self.param_shardings = param_shardings

    def __call__(self, params, inputs, cache):
        full = shd.gather_tree(params, self.param_shardings)
        b = (next(iter(inputs.values())) if isinstance(inputs, dict)
             else inputs).shape[0]
        axes = batch_axes(b)
        i, n = shd.block_index(axes)

        def rows(t):
            return t.narrow(0, i * (b // n), b // n)

        local = ({k: rows(v) for k, v in inputs.items()}
                 if isinstance(inputs, dict) else rows(inputs))
        with shd.batch_split(axes):
            logits, cache = self.fn(full, local, cache)
        return shd.all_gather(logits, axes, dim=0), cache


def make_serve_steps(cfg: ArchConfig, run: RunConfig, *,
                     abstract_params=None, param_specs=None):
    """``(prefill, decode)``.  The cache each takes is updated in place and
    returned (the reference donates it).

    Without a mesh, the steps for one device.  Under a mesh, two
    :class:`MeshServeStep` whose parameter shardings resolve shape-aware
    against ``abstract_params`` (the whole tree; default :func:`~repro_
    torch.models.transformer.lm_init`'s on meta).  ``param_specs``
    overrides the raw parameters' logical axes: the serve engine passes
    its pre-lowered tree's (``CompiledModel.sharding_specs()``) with that
    tree."""
    pf = functools.partial(serve_prefill, cfg=cfg, run=run)
    dc = functools.partial(serve_decode, cfg=cfg, run=run)
    if shd.get_mesh() is None:
        return pf, dc
    if abstract_params is None:
        abstract_params = T.lm_init(torch.Generator(), cfg, device="meta")
    if param_specs is None:
        param_specs = T.lm_specs(cfg)
    pshard = shd.sharding_like(param_specs, abstract_params)
    return MeshServeStep(pf, cfg, pshard), MeshServeStep(dc, cfg, pshard)
