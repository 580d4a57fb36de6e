"""Serving steps (port of ``repro.serve.serve_step``): prefill (process a
full prompt, fill the cache) and decode (one new token against the
cache), over a float or an int8 KV cache (``T.init_lm_cache(dtype=)``).
The steps run eagerly; the reference jits them.  Its mesh branch waits
for the mesh code (ROADMAP)."""
from __future__ import annotations

import functools

from repro_torch.configs.base import ArchConfig, RunConfig
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


def make_serve_steps(cfg: ArchConfig, run: RunConfig):
    """(prefill, decode) for one device: the reference's no-mesh steps.
    The cache each takes is updated in place and returned (the reference
    donates it)."""
    return (functools.partial(serve_prefill, cfg=cfg, run=run),
            functools.partial(serve_decode, cfg=cfg, run=run))
