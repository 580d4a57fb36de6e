"""Serving steps (port of ``repro.serve.serve_step``): prefill (process a
full prompt, fill the cache) and decode (one new token against the
cache), over a float or an int8 KV cache (``T.init_lm_cache(dtype=)``).
The steps run eagerly; the reference jits them.

Under a mesh the parameters are this rank's blocks between steps, and a
step gathers one layer's leaves at a time as the layer runs, computing
the heads, MLP columns and vocabulary on this rank's block of the
``model`` axis (:mod:`repro_torch.distributed.tensor_parallel`).  The
batch splits over the mesh's batch axes; the decode cache is this rank's
block (:func:`init_cache`): its rows, and its KV heads where they divide
the ``model`` axis, else its block of the sequence.  The logits are
all-gathered, so every rank samples the same tokens.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as T


def _last_logits(logits, cfg: ArchConfig):
    """The last position's logits, whole along the vocabulary: a rank's
    vocabulary block (tensor parallelism) is all-gathered after the cut,
    so a prefill moves one position's logits, not the prompt's."""
    last = logits[:, -1]
    if last.shape[-1] != cfg.vocab_size:
        last = shd.all_gather(last, "model", dim=-1)
    return last


def serve_prefill(params, batch, cache, *, cfg: ArchConfig, run: RunConfig):
    """Prompt pass: fills the cache, returns last-position logits."""
    logits, cache, _ = T.lm_apply(params, batch, cfg, run, cache=cache)
    return _last_logits(logits, cfg), cache


def serve_decode(params, tokens_or_embeds, cache, *, cfg: ArchConfig,
                 run: RunConfig):
    """One decode step: [B, 1] token (or embed) -> [B, vocab] logits."""
    key = "tokens" if cfg.embed_inputs else "embeds"
    logits, cache, _ = T.lm_apply(params, {key: tokens_or_embeds}, cfg, run,
                                  cache=cache)
    return _last_logits(logits, cfg), cache


def cache_sharding(cfg: ArchConfig, dtype=torch.bfloat16, batch=None,
                   max_len=None):
    """The decode cache's shardings, None without a mesh: shape-unaware,
    or resolved against the whole cache of ``batch`` rows and ``max_len``
    positions (the reference's shape-aware rule: ``kv_heads`` takes the
    ``model`` axis where it divides the KV heads, else ``kv_seq`` does) -
    the tree :func:`init_cache` allocates, an attention cache split over
    ``kv_seq`` with its ``"kv_block"`` entry (no tensor, so None)."""
    if batch is None:
        return shd.tree_sharding(T.lm_cache_specs(cfg, dtype))
    if shd.get_mesh() is None:
        return None
    whole = T.init_lm_cache(cfg, batch, max_len, dtype=dtype, device="meta")
    return _layout(shd.sharding_like(T.lm_cache_specs(cfg, dtype), whole),
                   whole)


def _layout(sh, whole):
    """The recurrent states (RWKV's, Mamba's) split over the batch alone:
    their layers run whole on every rank (gathered per layer).  An
    attention cache (a node with ``k`` and ``len``) keeps its split, and
    gains ``"kv_block"`` where that split is over the sequence."""
    if isinstance(sh, dict):
        if "k" in sh and "len" in sh:
            if _kv_seq_axes(sh, whole):
                return {**sh, "kv_block": None}
            return sh
        return {k: _layout(v, whole[k]) for k, v in sh.items()}
    if isinstance(sh, shd.NamedSharding):
        return shd.NamedSharding(sh.mesh, shd.P(*(
            e if i == 1 else None for i, e in enumerate(tuple(sh.spec)))))
    return sh


def _kv_seq_axes(sh, whole):
    """The mesh axes that split an attention cache's sequence dim (dim 2
    of the stacked ``[groups, B, S, H, D]`` keys), or None."""
    axes = [ax for d, ax in shd.split_dims(sh["k"], whole["k"].ndim)
            if d == 2]
    return axes[0] if axes else None


def batch_axes(b: int) -> tuple:
    """The mesh axes (of size > 1) a batch of ``b`` rows splits over: the
    ``batch`` rule's, shape-aware (a batch they do not divide stays whole
    on every rank)."""
    return shd.split_axes(shd.resolve_spec(("batch",), (b,))[0])


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None):
    """A zero decode cache for ``batch`` rows: under a mesh this rank's
    block of it, as :func:`cache_sharding` lays it out - allocated at the
    block's size, the whole cache never is.  An attention cache split
    over ``kv_seq`` records its block (``"kv_block"``: index, count,
    mesh axes) for split-KV decoding."""
    sh = cache_sharding(cfg, dtype, batch, max_len)
    if sh is None or not shd.splits(sh):
        return T.init_lm_cache(cfg, batch, max_len, dtype=dtype,
                               device=device)
    whole = T.init_lm_cache(cfg, batch, max_len, dtype=dtype, device="meta")
    dev = resolve_device(device)

    def alloc(node, ns):
        if isinstance(node, dict):
            out = {k: alloc(v, ns[k]) for k, v in node.items()}
            if "kv_block" in ns:
                axes = _kv_seq_axes(ns, node)
                out["kv_block"] = shd.block_index(axes) + (axes,)
            return out
        if isinstance(node, torch.Tensor):
            local = shd.shard_tree(node, ns)
            return torch.zeros(local.shape, dtype=node.dtype, device=dev)
        return list(node) if isinstance(node, list) else node

    return alloc(whole, sh)


class MeshServeStep:
    """A prefill or decode step under a mesh: ``step(params, inputs,
    cache) -> (logits, cache)`` with ``params`` this rank's blocks
    (:attr:`param_shardings`), ``inputs`` the whole batch (a batch dict or
    a ``[B, 1]`` tensor) and ``cache`` this rank's block of the decode
    cache (:func:`init_cache`); the logits are the whole batch's.  No
    whole-tree gather: the model gathers each layer as it runs."""

    def __init__(self, fn, cfg: ArchConfig, param_shardings):
        self.fn, self.cfg = fn, cfg
        self.param_shardings = param_shardings

    def __call__(self, params, inputs, cache):
        b = (next(iter(inputs.values())) if isinstance(inputs, dict)
             else inputs).shape[0]
        axes = batch_axes(b)
        i, n = shd.block_index(axes)

        def rows(t):
            return t.narrow(0, i * (b // n), b // n)

        local = ({k: rows(v) for k, v in inputs.items()}
                 if isinstance(inputs, dict) else rows(inputs))
        with shd.batch_split(axes), shd.sharded_params(self.param_shardings):
            logits, cache = self.fn(params, local, cache)
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
