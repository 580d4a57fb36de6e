"""Grouped-query attention with a dense float KV cache (port of the
fused-QKV plan path, the dense prefill and the float-cache branch of
``repro.models.attention``).

The parameter projections (QKV/O) run on the analog backend; the
activation x activation products (logits, AV) stay digital - the BSS-2
synapse array holds static weights only.  :func:`prefill_attention_glue`
is the static-prefill glue of a fused attention+MLP block.  A prefill
past ``flash_threshold`` positions without a cache runs
:func:`repro_torch.models.flash.flash_attention`; the cache is float or
int8 (per-(position, head) scales).  Under a mesh the attention runs on
this rank's heads (:func:`~repro_torch.distributed.tensor_parallel.
attention_view`), or context-parallel where
the heads do not divide the ``model`` axis, and decodes split-KV on a
cache split over its sequence (:func:`_decode_kv_block`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.quant import _div_exact
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.noise import NoiseConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.exec.plan import GROUP_COLUMN_CONCAT, find_group
from repro_torch.exec.run import run_layer
from repro_torch.models import layers as L
from repro_torch.models.flash import flash_attention, flash_attention_cp

NEG_INF = -1e30


def attention_init(generator, d_model, n_heads, n_kv_heads, head_dim, *,
                   noise: NoiseConfig = NoiseConfig(), dtype=torch.float32,
                   device: DeviceLike = None):
    kw = dict(noise=noise, dtype=dtype, device=device)
    return {
        "wq": L.linear_init(generator, d_model, n_heads * head_dim, **kw),
        "wk": L.linear_init(generator, d_model, n_kv_heads * head_dim, **kw),
        "wv": L.linear_init(generator, d_model, n_kv_heads * head_dim, **kw),
        "wo": L.linear_init(generator, n_heads * head_dim, d_model, **kw),
    }


def attention_specs(noise: NoiseConfig = NoiseConfig()):
    return {
        "wq": L.linear_specs("embed", "heads", noise=noise),
        "wk": L.linear_specs("embed", "heads", noise=noise),
        "wv": L.linear_specs("embed", "heads", noise=noise),
        "wo": L.linear_specs("heads", "embed", noise=noise),
    }


def _dense_attention(q, k, v, *, causal: bool, q_offset=0):
    """q: [B,Sq,KVH,G,dh], k/v: [B,Sk,KVH,dh].  Direct path for short S."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = qpos >= kpos
        s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.to(q.dtype)


def prefill_attention_glue(qkv, *, batch: int, seq: int, n_heads: int,
                           n_kv_heads: int, head_dim: int,
                           rope_theta: float) -> torch.Tensor:
    """The digital glue between the fused QKV projection and the output
    projection for a STATIC prefill (positions ``0..seq-1``, no cache,
    dense causal attention): split the concatenated QKV columns, apply
    RoPE, group the query heads, attend.

    ``qkv``: ``[batch * seq, nq + 2 * nkv]`` (the column layout of the
    ``column_concat`` QKV group) -> ``[batch * seq, nq]``.  The per-layer
    block fallback (``repro_torch.exec.run._run_block_fallback``) and the
    whole-block plain version (``repro_torch.kernels.ref``) both call it.
    """
    nq = n_heads * head_dim
    nkv = n_kv_heads * head_dim
    g = n_heads // n_kv_heads
    qkv = qkv.reshape(batch, seq, nq + 2 * nkv)
    q, k, v = torch.split(qkv, [nq, nkv, nkv], dim=-1)
    q = q.reshape(batch, seq, n_heads, head_dim)
    k = k.reshape(batch, seq, n_kv_heads, head_dim)
    v = v.reshape(batch, seq, n_kv_heads, head_dim)
    pos = torch.arange(seq, dtype=torch.int32, device=qkv.device)
    positions = torch.broadcast_to(pos[None, :], (batch, seq))
    q = L.apply_rope(q, positions, rope_theta)
    k = L.apply_rope(k, positions, rope_theta)
    qg = q.reshape(batch, seq, n_kv_heads, g, head_dim)
    o = _dense_attention(qg, k, v, causal=True)
    return o.reshape(batch * seq, nq)


def qkv_plan(params, acfg: AnalogConfig):
    """The compiled QKV dispatch group of this attention node (resolved by
    kind and exact members), or None when there is none or its baked
    attributes disagree with the call site."""
    if acfg.mode == "digital":
        return None
    gp = find_group(params.get("_groups"), GROUP_COLUMN_CONCAT,
                    ("wq", "wk", "wv"))
    if gp is None:
        return None
    lp = gp.fused
    if (lp.signed_input != acfg.signed_input
            or lp.chunk_rows != acfg.chunk_rows
            or acfg.act_calib != "dynamic"):
        return None
    return lp


def _quantize_kv(t: torch.Tensor):
    """int8 codes of ``t [B, S, H, dh]`` and their per-(position, head)
    scales ``max|t| / 127`` (floored at 1e-9): the reference's int8 KV
    cache ("store at ADC resolution").  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    sc = torch.clamp_min(
        _div_exact(t.abs().amax(dim=-1).to(torch.float32), 127.0), 1e-9)
    q = torch.clamp(torch.round(t / sc[..., None]), -127, 127)
    return q.to(torch.int8), sc


def decode_scores(qg: torch.Tensor, ck_f: torch.Tensor) -> torch.Tensor:
    """The cached decode's attention logits ``q . k / sqrt(head_dim)`` of
    ``qg [B, S, KVH, G, dh]`` against the float cache ``ck_f [B, Smax,
    KVH, dh]`` -> ``[B, KVH, G, S, Smax]``, divided exactly on every
    device."""
    return _div_exact(torch.einsum("bqhgd,bkhd->bhgqk",
                                   qg.to(torch.float32), ck_f),
                      math.sqrt(qg.shape[-1]))


def _cp_wanted(attn_cp: str, n_heads: int) -> bool:
    """Context-parallel attention: 'auto' turns it on exactly when the
    head count cannot take the model mesh axis (24/28/40 heads vs 16)."""
    sizes = shd.axis_sizes()
    if attn_cp == "off" or "model" not in sizes:
        return False
    if attn_cp == "cp":
        return True
    return n_heads % sizes["model"] != 0


def _decode_kv_block(qg, k, v, ck, cv, cache, length, s, kv_block):
    """Decode attention on this rank's ``kv_seq`` block of the cache (the
    reference's split-KV layout, where the KV heads do not divide the
    ``model`` axis): the new keys and values written where their
    positions fall in the block, the scores of the block's positions,
    then flash-decoding - the max and the softmax sum all-reduced over
    the block's axes, and the weighted values summed.  Within fp32
    rounding of the whole cache's softmax (the sums run in another
    order)."""
    i, n, axes = kv_block
    sl = ck.shape[1]
    lo = i * sl
    first, end = max(length, lo), min(length + s, lo + sl)
    int8 = ck.dtype == torch.int8
    if first < end:
        src, dst = slice(first - length, end - length), \
            slice(first - lo, end - lo)
        if int8:
            kq, ks = _quantize_kv(k[:, src])
            vq, vs = _quantize_kv(v[:, src])
            ck[:, dst], cache["k_scale"][:, dst] = kq, ks
            cv[:, dst], cache["v_scale"][:, dst] = vq, vs
        else:
            ck[:, dst] = k[:, src].to(ck.dtype)
            cv[:, dst] = v[:, src].to(cv.dtype)
    if int8:
        ck_f = ck.to(torch.float32) * cache["k_scale"][..., None]
        cv_f = cv.to(torch.float32) * cache["v_scale"][..., None]
    else:
        ck_f, cv_f = ck.to(torch.float32), cv.to(torch.float32)
    kpos = lo + torch.arange(sl, device=qg.device)
    qpos = length + torch.arange(s, device=qg.device)
    mask = qpos[:, None] >= kpos[None, :]
    mask &= (kpos < length + s)[None, :]
    sc = decode_scores(qg, ck_f)
    sc = torch.where(mask[None, None, None], sc, NEG_INF)
    top = shd.all_reduce(sc.amax(dim=-1, keepdim=True), axes, op="max")
    p = torch.exp(sc - top)
    den = shd.all_reduce(p.sum(dim=-1, keepdim=True), axes)
    o = shd.all_reduce(torch.einsum("bhgqk,bkhd->bqhgd", p, cv_f), axes)
    return o / den.permute(0, 3, 1, 2, 4)


def attention_apply(params, x, *, positions, acfg: AnalogConfig, n_heads,
                    n_kv_heads, head_dim, rope_theta, mrope=False,
                    cache=None, flash_threshold=2048,
                    flash_blocks=(256, 512), noise=None, attn_cp="auto"):
    """Returns (out, new_cache).  ``cache``: dict(k, v, len) for decode,
    plus ``k_scale`` / ``v_scale`` when its ``k`` is int8.

    The cache is updated IN PLACE: the new keys and values (int8 codes and
    their scales for an int8 cache) are written at positions ``len ..
    len+S-1`` (the reference's functional update donates its cache the
    same way), and the returned cache holds the same tensors and the
    advanced length.  Without a cache, more than ``flash_threshold``
    positions take :func:`~repro_torch.models.flash.flash_attention`
    with ``flash_blocks = (block_q, block_kv)``; under a mesh whose
    ``model`` axis the heads cannot take (``attn_cp``, :func:`_cp_wanted`)
    the prompt pass is context-parallel
    (:func:`~repro_torch.models.flash.flash_attention_cp`, the
    reference's default blocks).  ``noise``: the
    projections' readout-noise source (a generator or a
    :class:`~repro_torch.core.noise.NoiseFeed`).

    Under a mesh, a view on this rank's heads
    (:func:`~repro_torch.distributed.tensor_parallel.attention_view`,
    ``params["_tp"] == "col"``) runs its ``n_heads / m`` query and
    ``n_kv_heads / m`` KV heads (``m`` the ``model`` axis's size) against
    its heads' block of the cache; a cache split over ``kv_seq`` instead
    (its ``"kv_block"``) runs split-KV decoding
    (:func:`_decode_kv_block`)."""
    b, s, _ = x.shape
    heads = tp.split_cols(params)
    if heads:
        # every rank's heads read x: its gradient sums over the ranks
        x = shd.psum_grad(x, shd.split_axes(tp.MODEL))
        m = tp.model_size()
        n_heads, n_kv_heads = n_heads // m, n_kv_heads // m
    g = n_heads // n_kv_heads
    nq = n_heads * head_dim
    nkv = n_kv_heads * head_dim
    qkv_lp = qkv_plan(params, acfg)
    if qkv_lp is not None:
        # the three same-input projections as ONE analog dispatch over the
        # concatenated output columns
        qkv = run_layer(qkv_lp, x, acfg, noise=noise)
        q, k, v = torch.split(qkv, [nq, nkv, nkv], dim=-1)
    else:
        q = L.linear_apply(params["wq"], x, acfg, noise=noise)
        k = L.linear_apply(params["wk"], x, acfg, noise=noise)
        v = L.linear_apply(params["wv"], x, acfg, noise=noise)
    q = q.reshape(b, s, n_heads, head_dim)
    k = k.reshape(b, s, n_kv_heads, head_dim)
    v = v.reshape(b, s, n_kv_heads, head_dim)
    rope = L.apply_mrope if mrope else L.apply_rope
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    qg = q.reshape(b, s, n_kv_heads, g, head_dim)

    if cache is not None and cache.get("kv_block") is not None:
        ck, cv = cache["k"], cache["v"]
        length = cache["len"]
        new_cache = {k_: v_ for k_, v_ in cache.items() if k_ != "len"}
        new_cache["len"] = length + s
        o = _decode_kv_block(qg, k, v, ck, cv, cache, length, s,
                             cache["kv_block"]).to(x.dtype)
    elif cache is not None:
        # decode: append to the cache, attend over the valid prefix
        ck, cv = cache["k"], cache["v"]
        length = cache["len"]
        if ck.shape[2] != n_kv_heads:
            raise ValueError(f"a cache of {ck.shape[2]} KV heads for "
                             f"{n_kv_heads} KV heads on this rank")
        new_cache = {"k": ck, "v": cv, "len": length + s}
        at = slice(length, length + s)
        if ck.dtype == torch.int8:
            # int8 KV cache (beyond the paper): per-(position, head)
            # symmetric scales, about half the decode bytes of bf16
            cks, cvs = cache["k_scale"], cache["v_scale"]
            ck[:, at], cks[:, at] = _quantize_kv(k)
            cv[:, at], cvs[:, at] = _quantize_kv(v)
            ck_f = ck.to(torch.float32) * cks[..., None]
            cv_f = cv.to(torch.float32) * cvs[..., None]
            new_cache.update(k_scale=cks, v_scale=cvs)
        else:
            ck[:, at] = k.to(ck.dtype)
            cv[:, at] = v.to(cv.dtype)
            ck_f, cv_f = ck.to(torch.float32), cv.to(torch.float32)
        smax = ck.shape[1]
        kpos = torch.arange(smax, device=x.device)
        qpos = length + torch.arange(s, device=x.device)
        mask = qpos[:, None] >= kpos[None, :]
        mask &= (kpos < length + s)[None, :]
        sc = decode_scores(qg, ck_f)
        sc = torch.where(mask[None, None, None], sc, NEG_INF)
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, cv_f)
        o = o.to(x.dtype)
    elif not heads and _cp_wanted(attn_cp, n_heads):
        o = flash_attention_cp(qg, k, v, causal=True)
        new_cache = None
    elif s <= flash_threshold:
        o = _dense_attention(qg, k, v, causal=True)
        new_cache = None
    else:
        o = flash_attention(qg, k, v, causal=True,
                            block_q=flash_blocks[0],
                            block_kv=flash_blocks[1])
        new_cache = None

    o = o.reshape(b, s, nq)
    if heads and not tp.split_rows(params["wo"]):
        o = shd.gather_blocks(o, "model", dim=-1)
    return L.linear_apply(params["wo"], o, acfg, noise=noise), new_cache


def cache_specs(dtype=torch.bfloat16):
    """The logical axes of :func:`init_cache`'s tree (``len``: replicated)."""
    c = {
        "k": ("batch", "kv_seq", "kv_heads", None),
        "v": ("batch", "kv_seq", "kv_heads", None),
        "len": (),
    }
    if dtype == torch.int8:
        c["k_scale"] = ("batch", "kv_seq", "kv_heads")
        c["v_scale"] = ("batch", "kv_seq", "kv_heads")
    return c


def init_cache(batch, max_len, n_kv_heads, head_dim, dtype=torch.bfloat16,
               device: DeviceLike = None):
    """A zero KV cache; ``dtype=torch.int8`` adds the fp32 per-(position,
    head) ``k_scale`` / ``v_scale``."""
    dev = resolve_device(device)
    shape = (batch, max_len, n_kv_heads, head_dim)
    c = {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "len": 0,
    }
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            c[name] = torch.zeros(shape[:3], dtype=torch.float32, device=dev)
    elif not dtype.is_floating_point:
        raise ValueError(f"a KV cache is float or int8, not {dtype}")
    return c
