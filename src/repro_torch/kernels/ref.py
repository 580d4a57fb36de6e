"""Plain PyTorch versions of the kernels (ports of ``repro.kernels.ref``).

Each is the forward reference semantics of one CUDA kernel: the wrappers
in :mod:`repro_torch.kernels.ops` run them for CPU tensors, and the chip
smoke test holds every kernel against them on the card.  The chain
(:func:`analog_plan_ref`) is also differentiable with the reference's
straight-through contract; ``analog_mvm_ref`` and ``adc_epilogue_ref``
are inference-only, like the reference's.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.hw import BSS2


def analog_mvm_ref(
    a_code: torch.Tensor,                 # [M, K] integer-valued float, 0..31
    w_eff: torch.Tensor,                  # [K, N] effective analog weights
    gain: torch.Tensor,                   # [N] or scalar
    chunk_offset: Optional[torch.Tensor],  # [C, N] or None
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
) -> torch.Tensor:
    """Chunked saturating analog VMM.  K must divide into chunks."""
    m, k = a_code.shape
    n = w_eff.shape[1]
    if k % chunk_rows:
        raise ValueError(f"K={k} is not a multiple of chunk_rows={chunk_rows}")
    c = k // chunk_rows
    a_c = a_code.reshape(m, c, chunk_rows).to(torch.float32)
    w_c = w_eff.reshape(c, chunk_rows, n).to(torch.float32)
    v = torch.einsum("mck,ckn->mcn", a_c, w_c)
    v = v * gain
    if chunk_offset is not None:
        v = v + chunk_offset[None, :, :]
    if faithful:
        adc = torch.clamp(torch.round(v), BSS2.adc_min, BSS2.adc_max)
        return adc.sum(dim=1)
    total = v.sum(dim=1)
    return torch.clamp(torch.round(total), BSS2.adc_min * c, BSS2.adc_max * c)


def analog_mvm_split_ref(
    a_pos: torch.Tensor,
    a_neg: torch.Tensor,
    w_eff: torch.Tensor,
    gain: torch.Tensor,
    chunk_offset: Optional[torch.Tensor],
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
) -> torch.Tensor:
    """Two-pass signed split: the positive and the negative activation
    parts as two independent analog runs on the same tiles, subtracted
    digitally (the semantics the fused kernel reproduces)."""
    yp = analog_mvm_ref(a_pos, w_eff, gain, chunk_offset,
                        chunk_rows=chunk_rows, faithful=faithful)
    yn = analog_mvm_ref(a_neg, w_eff, gain, chunk_offset,
                        chunk_rows=chunk_rows, faithful=faithful)
    return yp - yn


def analog_mvm_split_experts_ref(
    a_pos: torch.Tensor,                   # [E, M, K] codes of max(x, 0)
    a_neg: torch.Tensor,                   # [E, M, K] codes of max(-x, 0)
    w_eff: torch.Tensor,                   # [E, K, N]
    gain: torch.Tensor,                    # [E, N]
    *,
    post_gain: Optional[torch.Tensor] = None,  # [E, N] (fast mode) or None
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
) -> torch.Tensor:
    """Plain version of the split kernel's expert axis: the signed split
    of every matrix of an expert stack, as one chunk scan batched over
    the experts.  Per pass and chunk ``v_c = (a_c @ w_c) * gain[e]``;
    faithful sums ``clip(rint(v_c))`` of the positive pass minus the
    negative's, fast sums each pass's ``v_c`` in ascending chunk order,
    scales the total by ``post_gain[e]`` when given, then rounds and
    clips it once."""
    e, m, k = a_pos.shape
    n = w_eff.shape[-1]
    if k % chunk_rows:
        raise ValueError(f"K={k} is not a multiple of chunk_rows={chunk_rows}")
    c = k // chunk_rows
    g = gain[:, None, :]
    acc = [torch.zeros((e, m, n), dtype=torch.float32, device=a_pos.device)
           for _ in range(2)]
    for ci in range(c):
        rows = slice(ci * chunk_rows, (ci + 1) * chunk_rows)
        w_c = w_eff[:, rows].to(torch.float32)
        vs = [torch.bmm(a[:, :, rows].to(torch.float32), w_c) * g
              for a in (a_pos, a_neg)]
        if faithful:
            acc[0] = acc[0] + (
                torch.clamp(torch.round(vs[0]), BSS2.adc_min, BSS2.adc_max)
                - torch.clamp(torch.round(vs[1]), BSS2.adc_min,
                              BSS2.adc_max))
        else:
            acc = [t + v for t, v in zip(acc, vs)]
    if faithful:
        return acc[0]
    if post_gain is not None:
        acc = [t * post_gain[:, None, :] for t in acc]
    lo, hi = BSS2.adc_min * c, BSS2.adc_max * c
    return (torch.clamp(torch.round(acc[0]), lo, hi)
            - torch.clamp(torch.round(acc[1]), lo, hi))


def split_chunk_scan_ref(a_pos, a_neg, w_eff, gain, chunk_offset, *,
                         chunk_rows: int = BSS2.signed_rows) -> torch.Tensor:
    """Faithful signed split as one chunk scan: both passes share each
    weight chunk and their ADC codes subtract into a single [M, N]
    accumulator (no [2M, K] concat, no [2M, C, N] per-chunk tensor).
    The codes are integer-valued fp32, so the per-chunk subtraction is
    bit-exact against ``yp - yn`` of the two-pass version."""
    m, k = a_pos.shape
    n = w_eff.shape[1]
    if k % chunk_rows:
        raise ValueError(f"K={k} is not a multiple of chunk_rows={chunk_rows}")
    acc = torch.zeros((m, n), dtype=torch.float32, device=a_pos.device)
    for c in range(k // chunk_rows):
        rows = slice(c * chunk_rows, (c + 1) * chunk_rows)
        w_c = w_eff[rows].to(torch.float32)
        o = 0.0 if chunk_offset is None else chunk_offset[c]
        vp = torch.matmul(a_pos[:, rows].to(torch.float32), w_c) * gain + o
        vn = torch.matmul(a_neg[:, rows].to(torch.float32), w_c) * gain + o
        acc = acc + (torch.clamp(torch.round(vp), BSS2.adc_min, BSS2.adc_max)
                     - torch.clamp(torch.round(vn), BSS2.adc_min,
                                   BSS2.adc_max))
    return acc


def split_plain_ref(a_pos, a_neg, w_eff, gain, chunk_offset, *,
                    chunk_rows: int = BSS2.signed_rows,
                    faithful: bool = True) -> torch.Tensor:
    """The signed split as the 2-D wrapper computes it on the CPU: the
    faithful chunk scan (:func:`split_chunk_scan_ref`), or for fast mode
    both passes stacked ``[2M, K]`` through :func:`analog_mvm_ref`
    (pre-round sums are order-sensitive, so fast mode keeps the oracle's
    arithmetic)."""
    if faithful:
        return split_chunk_scan_ref(a_pos, a_neg, w_eff, gain, chunk_offset,
                                    chunk_rows=chunk_rows)
    m = a_pos.shape[0]
    y2 = analog_mvm_ref(torch.cat([a_pos, a_neg], dim=0), w_eff, gain,
                        chunk_offset, chunk_rows=chunk_rows, faithful=False)
    return y2[:m] - y2[m:]


def analog_mvm_split_members_ref(
    a_pos: torch.Tensor,                   # [G, M, K] codes of max(x, 0)
    a_neg: torch.Tensor,                   # [G, M, K] codes of max(-x, 0)
    w_eff: torch.Tensor,                   # [G, K, N]
    gain: torch.Tensor,                    # [G, N]
    chunk_offset: Optional[torch.Tensor],  # [G, C, N] or None
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
) -> torch.Tensor:
    """Plain version of the split kernel's member axis (a batch_concat
    group): member ``g`` is the 2-D signed split of its own operands at
    its own gain and chunk offsets (:func:`split_plain_ref`), so each
    member equals its solo dispatch bit for bit.  ``[G, M, N]``."""
    return torch.stack([
        split_plain_ref(a_pos[i], a_neg[i], w_eff[i], gain[i],
                        None if chunk_offset is None else chunk_offset[i],
                        chunk_rows=chunk_rows, faithful=faithful)
        for i in range(a_pos.shape[0])])


def rebuild_w_eff_ref(codes: torch.Tensor,
                      col_gain: Optional[torch.Tensor],
                      row_gain: Optional[torch.Tensor],
                      col_blocks=None) -> torch.Tensor:
    """The split kernel's int8 code operand rebuilt into fp32 effective
    weights: ``(code * col_gain[n]) * row_gain[block(n), k]``, each an
    fp32 multiply, a missing factor skipped; ``col_blocks`` (member
    widths of a column_concat fusion) pick the row-gain vector of each
    column, row 0 serving all columns without them."""
    w = codes.to(torch.float32)
    if col_gain is not None:
        w = w * col_gain[None, :]
    if row_gain is not None:
        blocks = (w.shape[1],) if col_blocks is None else tuple(col_blocks)
        parts, c0 = [], 0
        for b, nb in enumerate(blocks):
            parts.append(w[:, c0:c0 + nb] * row_gain[b, :, None])
            c0 += nb
        w = torch.cat(parts, dim=1)
    return w


def analog_mvm_split_codes_ref(a_pos, a_neg, codes, col_gain, row_gain,
                               gain, chunk_offset, *, col_blocks=None,
                               chunk_rows: int = BSS2.signed_rows,
                               faithful: bool = True) -> torch.Tensor:
    """Plain version of the split kernel's code operand: the weights
    rebuilt (:func:`rebuild_w_eff_ref`), then the two-pass split."""
    w = rebuild_w_eff_ref(codes, col_gain, row_gain, col_blocks)
    return analog_mvm_split_ref(a_pos, a_neg, w, gain, chunk_offset,
                                chunk_rows=chunk_rows, faithful=faithful)


def bf16_split3_ref(w: torch.Tensor):
    """The split kernel's exact cut of fp32 weights into three bf16
    values (held in fp32): ``hi`` keeps the top 8 significand bits
    (truncation), ``mid`` the top 8 of the rest, ``lo`` what remains
    (at most 8 bits), so ``hi + mid + lo == w`` exactly."""
    mask = -65536  # 0xffff0000 as int32

    def trunc(x):
        return (x.contiguous().view(torch.int32) & mask).view(torch.float32)

    hi = trunc(w.to(torch.float32))
    r1 = w - hi
    mid = trunc(r1)
    return hi, mid, r1 - mid


def split_chunk_range_ref(a_pos, a_neg, w_eff, gain, chunk_offset, c0, c1,
                          *, chunk_rows: int = BSS2.signed_rows
                          ) -> torch.Tensor:
    """One CTA's partial total of the faithful split kernel: the sum over
    chunks ``[c0, c1)`` of ``clip(rint(v_pos)) - clip(rint(v_neg))``.
    Integer-valued, so the partial totals of any cut of the chunks sum
    to the whole in any order."""
    rows = slice(c0 * chunk_rows, c1 * chunk_rows)
    off = None if chunk_offset is None else chunk_offset[c0:c1]
    yp = analog_mvm_ref(a_pos[:, rows], w_eff[rows], gain, off,
                        chunk_rows=chunk_rows, faithful=True)
    yn = analog_mvm_ref(a_neg[:, rows], w_eff[rows], gain, off,
                        chunk_rows=chunk_rows, faithful=True)
    return yp - yn


def adc_epilogue_ref(y_int: torch.Tensor, epilogue) -> torch.Tensor:
    """ADC epilogue (paper §II-A): ReLU at the readout + right-shift
    requantization onto 5-bit codes; ``epilogue`` is None or
    ``("relu_shift", shift)``."""
    if epilogue is None:
        return y_int
    kind, shift = epilogue
    if kind != "relu_shift":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    y = torch.clamp_min(y_int, 0.0)
    y = torch.floor(y / float(1 << shift))
    return torch.clamp(y, 0.0, float(BSS2.a_max))


def _layer_weights(weights, schedule):
    """Per-layer ``[k_pad, n]`` weights: slices of a packed ``w_cat`` (a
    chain's pack), or a block's per-layer tensors or
    :class:`~repro_torch.exec.plan.WeightStore` records (a store stands
    for its ``w_eff``, which its int8 codes and gain tables rebuild bit for
    bit: :func:`rebuild_w_eff_ref`)."""
    if isinstance(weights, torch.Tensor):
        return [weights[m.row0:m.row0 + m.k_pad, :m.n] for m in schedule]
    return [getattr(w, "w_eff", w) for w in weights]


def _adc_ste(v, lo, hi):
    """``clip(round(v), lo, hi)`` as a pure straight-through term (``v +
    (adc - v).detach()``, the same value bit for bit): the HIL readout of
    the chain, whose gradient is the linearization, unmasked."""
    adc = torch.clamp(torch.round(v), lo, hi)
    return v + (adc - v).detach() if v.requires_grad else adc


def _chunk_adc(a, w_l, gain, offs, n_chunks, chunk_rows, faithful):
    """The chunked saturating analog VMM of one pass, chunk by chunk in
    ascending order (the order the CUDA kernels sum in), with the HIL
    gradient: straight through every readout, gain and offsets frozen."""
    gain = gain.detach()
    acc = torch.zeros((a.shape[0], w_l.shape[1]), dtype=torch.float32,
                      device=a.device)
    for c in range(n_chunks):
        v = torch.matmul(a[:, c * chunk_rows:(c + 1) * chunk_rows],
                         w_l[c * chunk_rows:(c + 1) * chunk_rows])
        v = v * gain + offs[c].detach()
        if faithful:
            v = _adc_ste(v, BSS2.adc_min, BSS2.adc_max)
        acc = acc + v
    if not faithful:
        lo = float(BSS2.adc_min) * n_chunks
        hi = float(BSS2.adc_max) * n_chunks
        acc = _adc_ste(acc, lo, hi)
    return acc


def plan_layer_ref(h, w_l, gain, offs, meta, scale, *,
                   chunk_rows: int = BSS2.signed_rows,
                   faithful: bool = True, vmm=None,
                   pair=None) -> torch.Tensor:
    """One scheduled layer: ``h`` holds 5-bit codes padded to ``k_pad``
    (encode ``"codes"``) or float features whose first ``k`` columns are
    quantized at ``scale`` and then padded (``"unsigned"``; ``"split"``
    runs the positive and the negative part as two passes and subtracts
    them).  Returns the accumulated ADC codes ``[rows, n]``.  ``vmm(a,
    w_l, gain, offs)``, when given, computes each pass in place of the
    chunk scan here (the chain's HIL backward passes the ``analog_mvm``
    wrapper); ``pair(a_pos, a_neg, w_l, gain, offs)``, when given,
    computes a ``"split"`` layer's two passes as one difference (the
    block's HIL backward passes the ``analog_mvm_split`` wrapper)."""
    from repro_torch.core.quant import quantize_act

    def mvm(a):
        if vmm is not None:
            return vmm(a, w_l, gain, offs)
        return _chunk_adc(a, w_l, gain, offs, meta.n_chunks, chunk_rows,
                          faithful)

    if meta.encode == "codes":
        return mvm(h)
    f = h[:, :meta.k]
    pad = meta.k_pad - meta.k

    def codes(v):
        return torch.nn.functional.pad(quantize_act(v, scale), (0, pad))

    if meta.encode == "split" and pair is not None:
        return pair(codes(f), codes(-f), w_l, gain, offs)
    acc = mvm(codes(f))
    if meta.encode == "split":
        acc = acc - mvm(codes(-f))
    elif meta.encode != "unsigned":
        raise ValueError(f"unknown encode {meta.encode!r}")
    return acc


def block_glue_ref(handoff: str, y: torch.Tensor, res, ln_row, block):
    """The float glue after a dequantized layer output ``y``: returns the
    next layer's input features and the residual stream.  ``"relu"`` is
    the chain's float hand-off; ``"attn"``, ``"res_ln"`` and ``"swiglu"``
    are a transformer block's, computed by the model path's own functions
    (:func:`repro_torch.models.attention.prefill_attention_glue`,
    :func:`repro_torch.models.layers.norm_apply`, SwiGLU as in
    :func:`repro_torch.models.layers.mlp_apply`)."""
    if handoff == "relu":
        return torch.relu(y), res
    if handoff == "attn":
        from repro_torch.models.attention import prefill_attention_glue

        return prefill_attention_glue(
            y, batch=y.shape[0] // block.seq, seq=block.seq,
            n_heads=block.n_heads, n_kv_heads=block.n_kv_heads,
            head_dim=block.head_dim, rope_theta=block.rope_theta), res
    if handoff == "res_ln":
        from repro_torch.models.layers import norm_apply

        res = res + y
        return norm_apply({"scale": ln_row}, res, eps=block.eps), res
    if handoff == "swiglu":
        return (torch.nn.functional.silu(y[:, block.d_ff:])
                * y[:, :block.d_ff]), res
    raise ValueError(f"unknown hand-off {handoff!r}")


def analog_plan_ref(
    x_in: torch.Tensor,         # [B * m_mult0, k0_pad] codes, or floats
    weights,                    # w_cat [sum(k_pad), n_max] | per-layer list
    gain_all: torch.Tensor,     # [L, n_max] per-layer gains
    off_cat: torch.Tensor,      # [sum(n_chunks), n_max] offsets
    schedule,                   # tuple of MegaLayerMeta
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
    extras=None,                # (deq [L,n_max], bias [L,n_max], enc [L,1],
                                #  ln [2,n_max] | None)
    block=None,                 # BlockMeta | None (transformer glue)
    trace: Optional[list] = None,
    vmm=None,                   # per-pass VMM of plan_layer_ref | None
    pair=None,                  # split-pair VMM pair(li, ...) | None
) -> torch.Tensor:
    """A whole packed layer chain - code-domain hand-offs, float-domain
    hand-offs, or one attention+MLP block - with the per-layer route's
    arithmetic: the encodes of :func:`plan_layer_ref`, the ``"codes"``
    hand-off's ReLU + right-shift requantization, and the float hand-offs
    dequantized as ``acc * deq + bias`` (``deq = a_scale * w_scale /
    gain``, run_layer's expression) before :func:`block_glue_ref`.  The
    ``flatten`` merge relabels position rows into the next layer's
    features.  Returns the last layer's raw accumulated ADC codes
    ``[B * m_mult_last, n_last]`` (``"raw"``) or the block output
    (``"res_out"``).  ``trace``, when a list, receives each layer's
    ``(input, accumulated ADC codes)``; ``vmm`` replaces each layer's
    chunk scan, ``pair(li, a_pos, a_neg, w_l, gain, offs)`` the two
    passes of layer ``li`` when it encodes ``"split"``
    (:func:`plan_layer_ref`).

    Differentiable with the HIL contract of the reference's oracle: each
    readout is a pure straight-through term, gain and offsets are frozen,
    the ``codes`` hand-off carries ``_maximum0``'s, the floor's and
    ``_clip_ste``'s straight-through gradients, the ``relu`` hand-off
    ``relu``'s, the float encodes ``quantize_act``'s; gradients reach the
    weights and the float-glue rows.  The forward values do not change.
    The chain's HIL backward (``kernels.ops._PlanChain``) differentiates
    this walk with ``vmm`` set to the ``analog_mvm`` wrapper."""
    from repro_torch.core.quant import _maximum0, requantize_5bit
    from repro_torch.kernels.analog_plan import layer_handoff, needs_extras

    deq = bias = enc = ln = None
    if extras is not None:
        deq, bias, enc, ln = extras
    elif needs_extras(schedule):
        raise ValueError(
            "float-domain schedule entries need the packed deq/bias/enc "
            "operands (extras); without them only the code-domain "
            "schedule runs")
    ws = _layer_weights(weights, schedule)
    h = x_in.to(torch.float32)
    res = None
    last = len(schedule) - 1
    if block is not None:
        from repro_torch.models.layers import norm_apply

        d0 = schedule[0].k
        res = h[:, :d0]
        h = norm_apply({"scale": ln[0, :d0]}, res, eps=block.eps)
    for li, meta in enumerate(schedule):
        acc = plan_layer_ref(
            h, ws[li], gain_all[li, :meta.n],
            off_cat[meta.c0:meta.c0 + meta.n_chunks, :meta.n], meta,
            None if meta.encode == "codes" else enc[li, 0],
            chunk_rows=chunk_rows, faithful=faithful, vmm=vmm,
            pair=None if pair is None else functools.partial(pair, li))
        if trace is not None:
            trace.append((h, acc))
        handoff = layer_handoff(meta, li == last)
        if li == last:
            if handoff == "res_out":
                return res + (acc * deq[li, :meta.n] + bias[li, :meta.n])
            if handoff != "raw":
                raise ValueError(f"unknown final hand-off {handoff!r}")
            return acc
        if handoff == "codes":
            # the ADC epilogue with STE gradients (exec.run's relu_shift)
            nxt = requantize_5bit(_maximum0(acc), meta.shift)
        else:
            y = acc * deq[li, :meta.n] + bias[li, :meta.n]
            ln_row = None if ln is None else ln[1, :meta.n]
            nxt, res = block_glue_ref(handoff, y, res, ln_row, block)
        if meta.flatten > 1:
            nxt = nxt.reshape(nxt.shape[0] // meta.flatten,
                              meta.flatten * meta.n)
        if schedule[li + 1].encode == "codes":
            pad = schedule[li + 1].k_pad - nxt.shape[1]
            if pad:
                nxt = torch.nn.functional.pad(nxt, (0, pad))
        h = nxt
    return acc


def block_stages_ref(x_in, stages, weights, gain_all, off_cat, schedule,
                     block, extras, *, chunk_rows: int = BSS2.signed_rows,
                     faithful: bool = True) -> dict:
    """Every stage of the block kernel by the plain version, each fed the
    kernel's OWN input to that stage: ``stages`` is the dict of stage
    regions :func:`repro_torch.kernels.analog_plan.analog_plan_block_cuda`
    returns.  Returns a dict of the same names plus ``"out"`` (the block
    output from the kernel's ``res2`` and ``acc_dn``), so that each stage
    can be held against its plain version on its own; the code regions
    (``*_pos``, ``*_neg``) are the encodes of the kernel's own float
    regions."""
    from repro_torch.models.layers import norm_apply

    deq, bias, enc, ln = extras
    d = schedule[0].k
    weights = _layer_weights(weights, schedule)

    def dq(acc, li):
        n = schedule[li].n
        return acc * deq[li, :n] + bias[li, :n]

    def mvm(li, h):
        m = schedule[li]
        return plan_layer_ref(h, weights[li], gain_all[li, :m.n],
                              off_cat[m.c0:m.c0 + m.n_chunks, :m.n], m,
                              enc[li, 0], chunk_rows=chunk_rows,
                              faithful=faithful)

    def codes(li, name):
        # a VMM's code operands: the codes of its float input and of the
        # negated input (zeros for an unsigned layer), chunk-padded
        from repro_torch.core.quant import quantize_act

        m = schedule[li]
        h = stages[name][:, :m.k]
        pad = (0, m.k_pad - m.k)
        pos = torch.nn.functional.pad(quantize_act(h, enc[li, 0]), pad)
        neg = (torch.nn.functional.pad(quantize_act(-h, enc[li, 0]), pad)
               if m.encode == "split" else torch.zeros_like(pos))
        return {f"{name}_pos": pos, f"{name}_neg": neg}

    want = {"n1": norm_apply({"scale": ln[0, :d]}, x_in, eps=block.eps)}
    for li, name in enumerate(("n1", "attn", "n2", "sw")):
        want.update(codes(li, name))
    want["acc_qkv"] = mvm(0, stages["n1"])
    want["attn"] = block_glue_ref("attn", dq(stages["acc_qkv"], 0), None,
                                  None, block)[0]
    want["acc_o"] = mvm(1, stages["attn"])
    want["n2"], want["res2"] = block_glue_ref(
        "res_ln", dq(stages["acc_o"], 1), x_in, ln[1, :d], block)
    want["acc_ug"] = mvm(2, stages["n2"])
    want["sw"] = block_glue_ref("swiglu", dq(stages["acc_ug"], 2), None,
                                None, block)[0]
    want["acc_dn"] = mvm(3, stages["sw"])
    want["out"] = stages["res2"] + dq(stages["acc_dn"], 3)
    return want


def maxmin_pool_ref(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """FPGA preprocessing pooling (paper Fig. 7): per non-overlapping
    window, max - min.  x: [..., T] with T % window == 0 -> [..., T/window]."""
    t = x.shape[-1]
    if t % window:
        raise ValueError(f"T={t} is not a multiple of window={window}")
    xw = x.reshape(x.shape[:-1] + (t // window, window))
    return xw.amax(dim=-1) - xw.amin(dim=-1)
