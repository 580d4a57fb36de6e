"""Flash attention with a blockwise backward (port of
``repro.models.flash``).

A naively differentiated online softmax saves every block's scores for
the backward - O(Sq x Sk) memory.  This module writes the FlashAttention
backward recurrence out (Dao et al., arXiv:2205.14135): the forward saves
only ``(q, k, v, o, lse, qpos0)``, and the backward recomputes each
block's scores, so train-time attention memory is O(S) + O(block^2).

It is plain PyTorch, as the reference's is plain JAX outside any Pallas
kernel, and it walks the reference's blocks in the reference's order with
its additive ``-1e30`` mask penalty and its padding, so both compute the
same recurrence.  Every product runs at full fp32 precision.

Layout: q [B, Sq, KVH, G, dh]; k, v [B, Sk, KVH, dh]; GQA-native (no head
replication; the G axis rides along in the einsums).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.device import fp32_matmuls

NEG_INF = -1e30


def _scale(dh: int, device) -> torch.Tensor:
    """``1 / sqrt(dh)`` rounded as the reference rounds it (fp32 sqrt,
    then an fp32 division)."""
    return 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32,
                                         device=device))


def _blocked(x: torch.Tensor, n_blocks: int, block: int, axis: int = 1):
    """Block ``i`` of axis ``axis`` at index ``i`` of a new leading axis."""
    shape = x.shape[:axis] + (n_blocks, block) + x.shape[axis + 1:]
    return torch.movedim(x.reshape(shape), axis, 0)


def _mask_penalty(qpos, kpos, causal, window, sk):
    """Additive fp32 ``[bq, bk]`` penalty (0 or NEG_INF): padding keys,
    and under ``causal`` the future and keys outside ``window``."""
    kposf = kpos.to(torch.float32)
    m = (kposf < sk)[None, :]                        # padding
    if causal:
        cm = qpos[:, None] >= kposf[None, :]
        if window is not None:
            cm &= (qpos[:, None] - kposf[None, :]) < window
        m = m & cm
    zero = torch.zeros((), dtype=torch.float32, device=qpos.device)
    return torch.where(m, zero, NEG_INF)


def _fwd_blocks(q, k, v, qpos0, *, causal, block_q, block_kv, window):
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    nq, nk = sq // block_q, sk // block_kv
    dev = q.device
    scale = _scale(dh, dev)
    qb = _blocked(q, nq, block_q)                 # [nq, b, bq, kvh, g, dh]
    kb = _blocked(k, nk, block_kv)                # [nk, b, bk, kvh, dh]
    vb = _blocked(v, nk, block_kv)
    qpos_b = qpos0.reshape(nq, block_q)
    o = torch.empty((nq, b, block_q, kvh, g, dh), dtype=q.dtype, device=dev)
    lse = torch.empty((nq, b, block_q, kvh, g), dtype=torch.float32,
                      device=dev)
    for iq in range(nq):
        qi = qb[iq].to(torch.float32)
        m_run = torch.full((b, block_q, kvh, g), NEG_INF,
                           dtype=torch.float32, device=dev)
        l_run = torch.zeros((b, block_q, kvh, g), dtype=torch.float32,
                            device=dev)
        acc = torch.zeros((b, block_q, kvh, g, dh), dtype=torch.float32,
                          device=dev)
        for ik in range(nk):
            s = torch.einsum("bqhgd,bkhd->bqhgk", qi,
                             kb[ik].to(torch.float32)) * scale
            kpos = ik * block_kv + torch.arange(block_kv, device=dev)
            pen = _mask_penalty(qpos_b[iq], kpos, causal, window, sk)
            s = s + pen[None, :, None, None, :]
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            corr = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p, vb[ik].to(torch.float32))
            m_run = m_new
        l_safe = torch.clamp_min(l_run, 1e-30)
        o[iq] = (acc / l_safe[..., None]).to(q.dtype)
        lse[iq] = m_run + torch.log(l_safe)
    o = torch.movedim(o, 0, 1).reshape(b, sq, kvh, g, dh)
    lse = torch.movedim(lse, 0, 1).reshape(b, sq, kvh, g)
    return o, lse


def _bwd_blocks(q, k, v, o, lse, qpos0, do, *, causal, block_q, block_kv,
                window):
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    nq, nk = sq // block_q, sk // block_kv
    dev = q.device
    scale = _scale(dh, dev)
    f32 = torch.float32
    # D_i = rowsum(dO * O)
    delta = torch.einsum("bqhgd,bqhgd->bqhg", do.to(f32), o.to(f32))
    qb = _blocked(q, nq, block_q)
    dob = _blocked(do, nq, block_q)
    lseb = _blocked(lse, nq, block_q)
    deltab = _blocked(delta, nq, block_q)
    qpos_b = qpos0.reshape(nq, block_q)
    kb = _blocked(k, nk, block_kv)
    vb = _blocked(v, nk, block_kv)
    dq = torch.zeros((nq, b, block_q, kvh, g, dh), dtype=f32, device=dev)
    dk = torch.empty((nk, b, block_kv, kvh, dh), dtype=f32, device=dev)
    dv = torch.empty((nk, b, block_kv, kvh, dh), dtype=f32, device=dev)
    for ik in range(nk):
        ki, vi = kb[ik].to(f32), vb[ik].to(f32)
        kpos = ik * block_kv + torch.arange(block_kv, device=dev)
        dk_acc = torch.zeros((b, block_kv, kvh, dh), dtype=f32, device=dev)
        dv_acc = torch.zeros((b, block_kv, kvh, dh), dtype=f32, device=dev)
        for iq in range(nq):
            qi, doi = qb[iq].to(f32), dob[iq].to(f32)
            s = torch.einsum("bqhgd,bkhd->bqhgk", qi, ki) * scale
            pen = _mask_penalty(qpos_b[iq], kpos, causal, window, sk)
            s = s + pen[None, :, None, None, :]
            p = torch.exp(s - lseb[iq][..., None])              # [b,q,h,g,k]
            dp = torch.einsum("bqhgd,bkhd->bqhgk", doi, vi)
            ds = p * (dp - deltab[iq][..., None]) * scale
            dv_acc = dv_acc + torch.einsum("bqhgk,bqhgd->bkhd", p, doi)
            dk_acc = dk_acc + torch.einsum("bqhgk,bqhgd->bkhd", ds, qi)
            dq[iq] = dq[iq] + torch.einsum("bqhgk,bkhd->bqhgd", ds, ki)
        dk[ik], dv[ik] = dk_acc, dv_acc
    dq = torch.movedim(dq, 0, 1).reshape(b, sq, kvh, g, dh).to(q.dtype)
    dk = torch.movedim(dk, 0, 1).reshape(b, sk, kvh, dh).to(k.dtype)
    dv = torch.movedim(dv, 0, 1).reshape(b, sk, kvh, dh).to(v.dtype)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the forward saves ``(q, k,
    v, o, lse, qpos0)`` and nothing per block; the backward recomputes
    each block's scores."""

    @staticmethod
    def forward(ctx, q, k, v, qpos0, causal, block_q, block_kv, window):
        with fp32_matmuls():
            o, lse = _fwd_blocks(q, k, v, qpos0, causal=causal,
                                 block_q=block_q, block_kv=block_kv,
                                 window=window)
        ctx.save_for_backward(q, k, v, o, lse, qpos0)
        ctx.static = (causal, block_q, block_kv, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, qpos0 = ctx.saved_tensors
        causal, block_q, block_kv, window = ctx.static
        with fp32_matmuls():
            dq, dk, dv = _bwd_blocks(q, k, v, o, lse, qpos0, do,
                                     causal=causal, block_q=block_q,
                                     block_kv=block_kv, window=window)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, q_offset=0, block_q=256,
                    block_kv=512, window: Optional[int] = None):
    """Memory-O(S) attention with the blockwise backward.

    q: [B, Sq, KVH, G, dh]; k, v: [B, Sk, KVH, dh] -> [B, Sq, KVH, G, dh]
    """
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    block_q = min(block_q, sq)
    block_kv = min(block_kv, sk)
    pq = (-sq) % block_q
    pk = (-sk) % block_kv
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    qpos0 = torch.arange(sq + pq, dtype=torch.float32,
                         device=q.device) + q_offset
    o = _Flash.apply(q, k, v, qpos0, causal, block_q, block_kv, window)
    return o[:, :sq]


class _CPFlash(torch.autograd.Function):
    """Context-parallel flash attention on one ``model`` rank: q's
    sequence block ``idx`` against the whole k/v (the reference's
    ``shard_map`` body).  Forward: the local block's flash attention, then
    the blocks all-gathered along the sequence - no other collective.
    Backward: the local block's blockwise backward; dq's blocks are
    all-gathered, and dk / dv, which every rank's block contributes to,
    are all-reduced over ``model`` (the ``shard_map`` transpose)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_kv, window):
        from repro_torch.distributed import sharding as shd

        b, sq, kvh, g, dh = q.shape
        n_model = shd.axis_sizes()["model"]
        idx = shd.axis_index("model")
        s_loc = sq // n_model
        bq = min(block_q, s_loc)
        bk = min(block_kv, k.shape[1])
        pq = (-s_loc) % bq
        pk = (-k.shape[1]) % bk
        ql = q[:, idx * s_loc:(idx + 1) * s_loc]
        if pq:
            ql = F.pad(ql, (0, 0, 0, 0, 0, 0, 0, pq))
        kl, vl = k, v
        if pk:
            kl = F.pad(kl, (0, 0, 0, 0, 0, pk))
            vl = F.pad(vl, (0, 0, 0, 0, 0, pk))
        qpos = (idx * s_loc + torch.arange(s_loc + pq, device=q.device)
                ).to(torch.float32)
        with fp32_matmuls():
            o, lse = _fwd_blocks(ql, kl, vl, qpos, causal=causal,
                                 block_q=bq, block_kv=bk, window=window)
        ctx.save_for_backward(ql, kl, vl, o, lse, qpos)
        ctx.static = (causal, bq, bk, window, s_loc, k.shape[1])
        ctx.mesh, ctx.idx = shd.get_mesh(), idx
        return shd.all_gather(o[:, :s_loc].contiguous(), "model", dim=1)

    @staticmethod
    def backward(ctx, do):
        from repro_torch.distributed import sharding as shd

        ql, kl, vl, o, lse, qpos = ctx.saved_tensors
        causal, bq, bk, window, s_loc, sk = ctx.static
        idx = ctx.idx
        dol = do[:, idx * s_loc:(idx + 1) * s_loc]
        pq = o.shape[1] - s_loc
        if pq:
            dol = F.pad(dol, (0, 0, 0, 0, 0, 0, 0, pq))
        with fp32_matmuls():
            dq, dk, dv = _bwd_blocks(ql, kl, vl, o, lse, qpos, dol,
                                     causal=causal, block_q=bq, block_kv=bk,
                                     window=window)
        with shd.use_mesh(ctx.mesh):
            dq = shd.all_gather(dq[:, :s_loc].contiguous(), "model", dim=1)
            dk = shd.all_reduce(dk[:, :sk].contiguous(), "model")
            dv = shd.all_reduce(dv[:, :sk].contiguous(), "model")
        return dq, dk, dv, None, None, None, None


def flash_attention_cp(q, k, v, *, causal=True, block_q=256, block_kv=512,
                       window: Optional[int] = None):
    """Context-parallel flash attention: q's sequence axis splits over the
    ``model`` mesh axis, each rank's block offset by ``rank * s_loc`` in
    position; k and v stay whole on every rank (they already are for
    every config whose head count does not divide the model axis).  The
    forward needs no collective but the output's all-gather; the
    backward all-reduces dk / dv over ``model`` (:class:`_CPFlash`).
    Falls back to :func:`flash_attention` where the reference does: no
    mesh, no ``model`` axis, or ``sq`` not divisible by it.

    The batch is whatever the caller holds: inside a sharded step its
    block, else the whole batch on every rank."""
    from repro_torch.distributed import sharding as shd

    sizes = shd.axis_sizes()
    sq = q.shape[1]
    if "model" not in sizes or sq % sizes["model"]:
        return flash_attention(q, k, v, causal=causal, block_q=block_q,
                               block_kv=block_kv, window=window)
    return _CPFlash.apply(q, k, v, causal, block_q, block_kv, window)
