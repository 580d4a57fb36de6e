"""Plan execution: ``run(plan, x)`` replays a pre-lowered analog program
(port of the stack part of ``repro.exec.run``).

Left to run time (everything else was baked by
:mod:`repro_torch.exec.lower`):

- dynamic activation calibration (one abs-max over the whole batch) when
  ``cfg.act_calib == "dynamic"``,
- signed-input encoding of float activations: ``"split"`` runs both
  passes as ONE dispatch (the ``analog_mvm_split`` kernel on the card,
  reading the store's int8 codes and gain tables unless the store holds
  a full gain map), or as two ``analog_matmul`` passes when
  ``cfg.fused_split`` is off or readout noise is drawn (each pass its own
  draw); ``"offset"`` runs one pass on ``a + 16`` codes with a derated
  gain and subtracts ``gain * 16 * colsum`` digitally,
- the analog passes of each layer (the ``analog_mvm`` kernel when
  ``cfg.use_kernels``), and the column split of a fused group
  (:func:`run_group`),
- the inter-layer ADC epilogue: ReLU + right-shift requantization to
  5-bit codes (paper §II-A), as elementwise STE ops, or fused into the
  kernel when ``cfg.fused_epilogue`` and ``cfg.use_kernels`` on the
  deterministic inference path (never under autograd),
- temporal readout noise (hardware-in-the-loop training): a
  ``torch.Generator`` or one injected draw per layer, ignored when
  ``cfg.deterministic``; a noisy call replays layer by layer,
- megakernel routing: an eligible plan - a code-domain chain, or a
  static-calibration chain with float hand-offs - replays as ONE
  dispatch (the ``analog_plan`` kernel, or its plain version when
  ``cfg.use_kernels`` is False, on the CPU); ``megakernel=True`` raises
  with the first reason a plan or call cannot,
- block plans (:func:`repro_torch.exec.lower.lower_block`): the whole
  attention+MLP block as ONE dispatch (the ``analog_plan_block``
  kernel), or the 4-dispatch per-layer fallback, which a noisy call
  takes (one readout-noise source per layer),
- MoE expert stacks (:func:`run_expert_stack`): every expert of a stacked
  weight as ONE dispatch (the split kernel's expert axis),
- batch_concat groups (:func:`run_batch_concat`): the RWKV r/k/v/g
  projections, each member encoded at its own input scale, as ONE
  dispatch (the split kernel's member axis, each member with its own
  tables).

Every analog dispatch the executor issues adds one to
:func:`dispatch_count` and to the ``exec.dispatches`` counter of
:mod:`repro_torch.obs.metrics`, and every :func:`run` call to
``exec.run.megakernel`` or ``exec.run.per_layer`` by the route it took
(on every device: the kernels' own launch counts,
:func:`repro_torch.kernels.ops.launch_counts`, move only on the card).
The reference counts these at trace time, once per compiled program;
the port is eager and counts every call.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.core import quant
from repro_torch.core.analog import AnalogConfig, analog_matmul, check_route
from repro_torch.core.hw import BSS2
from repro_torch.core.noise import NoiseFeed
from repro_torch.distributed import sharding as shd
from repro_torch.exec.plan import (
    EPILOGUE_NONE,
    EPILOGUE_RELU_SHIFT,
    GROUP_BATCH_CONCAT,
    GROUP_COLUMN_CONCAT,
    GROUP_EXPERT_STACK,
    AnalogPlan,
    GroupPlan,
    LayerPlan,
    WeightStore,
)
from repro_torch.kernels.ops import needs_grad
from repro_torch.obs import metrics as _obs_metrics

_DISPATCHES = 0
_QUIET = 0     # > 0: a group replays member by member as one dispatch


def reset_dispatch_count() -> None:
    global _DISPATCHES
    _DISPATCHES = 0


def dispatch_count() -> int:
    """Analog dispatches since the last :func:`reset_dispatch_count`."""
    return _DISPATCHES


def _count(n: int = 1) -> None:
    global _DISPATCHES
    if _QUIET:
        return
    _DISPATCHES += n
    _obs_metrics.counter("exec.dispatches").inc(n)


def _pad_codes(a: torch.Tensor, k_pad: int) -> torch.Tensor:
    pad = k_pad - a.shape[-1]
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
    return a


def run_layer(
    lp: LayerPlan,
    x: torch.Tensor,
    cfg: AnalogConfig,
    *,
    noise=None,
    x_is_codes: bool = False,
) -> torch.Tensor:
    """Execute one lowered layer: x [..., K] -> y [..., N].

    ``x_is_codes=True`` means ``x`` already holds unsigned 5-bit event
    codes (LSB 1.0), so quantization is skipped.  ``noise`` is this
    layer's readout-noise source (a ``torch.Generator`` or an injected
    draw, :func:`repro_torch.core.analog.analog_matmul`), ignored when
    ``cfg.deterministic``.  Output: float activations when
    ``lp.epilogue == "none"`` (dequantized, bias applied), else 5-bit
    codes for the next stacked layer.
    """
    in_dtype = x.dtype
    x = x.to(torch.float32)
    rn = None if cfg.deterministic else noise
    if x_is_codes:
        a_scale = 1.0       # codes have LSB 1 (x * 1.0 is exact)
    elif cfg.act_calib == "dynamic":
        # per-call abs-max calibration over the WHOLE batch (the FPGA
        # preprocessing / SIMD-CPU right-shift choice on hardware)
        a_scale = quant.act_scale_from_max(
            shd.batch_amax(x.detach().abs().max()) + 1e-9)
    else:
        # static: a member of a snapshot-calibrated fused group encodes at
        # the group's shared LSB; dequantization below uses the same
        a_scale = lp.in_scale
    signed = "none" if x_is_codes else lp.signed_input
    gain = lp.gain_row
    if signed == "none":
        a_code = x if x_is_codes else quant.quantize_act(x, a_scale)
        a_code = _pad_codes(a_code, lp.k_pad)
        _count()
        y_int = analog_matmul(a_code, lp.w_eff, gain, lp.chunk_offset, cfg,
                              noise=rn)
    elif signed == "split":
        a_pos = _pad_codes(quant.quantize_act(x, a_scale), lp.k_pad)
        a_neg = _pad_codes(quant.quantize_act(-x, a_scale), lp.k_pad)
        if cfg.fused_split and rn is None:
            # ONE dispatch over shared weight tiles for both passes.  The
            # store picks the kernel's operand: int8 codes + their gain
            # tables (rank-1, and a calibrated bake's per-(chunk, column)
            # chunk_gain), or fp32 w_eff for a full gain map
            from repro_torch.kernels import ops as kernel_ops

            check_route(cfg, x)
            batch_shape = a_pos.shape[:-1]
            _count()
            y_int = kernel_ops.analog_mvm_split(
                a_pos.reshape(-1, lp.k_pad), a_neg.reshape(-1, lp.k_pad),
                _split_weights(lp, x), lp.gain_row, lp.chunk_offset,
                chunk_rows=lp.chunk_rows,
                faithful=cfg.mode != "analog_fast", store=lp.store,
            ).reshape(batch_shape + (lp.n,))
        else:
            # two passes (noisy passes need independent draws): the
            # positive pass draws first, then the negative one
            n_pos, n_neg = _pass_noise(rn)
            _count(2)
            y_int = analog_matmul(a_pos, lp.w_eff, lp.gain_row,
                                  lp.chunk_offset, cfg, noise=n_pos) - \
                analog_matmul(a_neg, lp.w_eff, lp.gain_row, lp.chunk_offset,
                              cfg, noise=n_neg)
    elif signed == "offset":
        # one pass on offset-encoded activations with a digital
        # correction, y = (a + h) @ W - h * colsum(W); the gain derated
        # for the common-mode ADC headroom (cf. Weis et al.)
        half = (BSS2.a_max + 1) // 2
        a_scale = a_scale * 2.0
        rms = cfg.act_rms_codes
        gain = gain * rms / torch.sqrt(torch.tensor(
            rms ** 2 + float(half) ** 2, dtype=torch.float32,
            device=gain.device))
        a_code = quant._clip_ste(quant._round_ste(x / a_scale) + half, 0.0,
                                 float(BSS2.a_max))
        a_code = _pad_codes(a_code, lp.k_pad)
        _count()
        y_int = analog_matmul(a_code, lp.w_eff, gain, lp.chunk_offset, cfg,
                              noise=rn)
        y_int = y_int - gain * half * lp.colsum
    else:
        raise ValueError(f"unknown signed_input {signed!r}")

    if lp.epilogue == EPILOGUE_RELU_SHIFT:
        # inter-layer ADC epilogue: output is 5-bit codes, not floats.
        # Straight-through gradients (max(., 0) with jnp.maximum's tie
        # rule, then the floor shift), value-identical to the in-kernel
        # epilogue
        return quant.requantize_5bit(quant._maximum0(y_int), lp.shift)
    y = y_int * (a_scale * lp.w_scale.reshape(-1) / gain)
    if lp.bias is not None:
        y = y + lp.bias
    return y.to(in_dtype)


def _split_weights(lp: LayerPlan, x: torch.Tensor):
    """The fp32 ``w_eff`` operand of a fused split call, or None where the
    store's int8 codes can stand for it and nothing differentiates
    through the call: the kernel wrapper then reads the codes on the card
    (a store that has not derived its ``w_eff`` never does) and the view
    only for the CPU's plain version."""
    st = lp.store
    if st.code_operand and not needs_grad(x) and not st.records_grad():
        return None
    return lp.w_eff


def _pass_noise(noise):
    """The two passes' readout-noise sources of a two-pass split: a
    generator or a feed for both (they draw in sequence, positive pass
    first), or a pair of injected draws."""
    if noise is None or isinstance(noise, (torch.Generator, NoiseFeed)):
        return noise, noise
    if not isinstance(noise, (tuple, list)) or len(noise) != 2:
        raise ValueError("a two-pass split layer takes a generator, a "
                         "NoiseFeed or a pair of injected draws")
    return tuple(noise)


def run_group(gp: GroupPlan, x, cfg: AnalogConfig, *, noise=None):
    """Replay a lowered fusion group: for a column_concat group ``x`` is
    the members' shared input and the tuple of member outputs comes back
    (one fused dispatch, the columns split back per member); a
    batch_concat group takes the sequence of member inputs and returns
    the tuple of member outputs (:func:`run_batch_concat`); an
    expert_stack group takes the dispatch buffer ``[E, C, K]`` and
    returns ``[E, C, N]`` (:func:`run_expert_stack`)."""
    if gp.kind == GROUP_EXPERT_STACK:
        return run_expert_stack(gp, x, cfg)
    if gp.kind == GROUP_BATCH_CONCAT:
        return run_batch_concat(gp, x, cfg, noise=noise)
    if gp.kind != GROUP_COLUMN_CONCAT:
        raise ValueError(f"unknown group kind {gp.kind!r}")
    y = run_layer(gp.fused, x, cfg)
    return tuple(torch.split(y, list(gp.member_ns), dim=-1))


@contextlib.contextmanager
def _one_dispatch():
    """Count everything dispatched inside the block as ONE dispatch."""
    global _QUIET
    _QUIET += 1
    try:
        yield
    finally:
        _QUIET -= 1
    _count()


def _member_plan(lp: LayerPlan, i: int) -> LayerPlan:
    """Member ``i`` of a member-axis plan (a batch_concat group's fused
    plan) as a solo plan: slice ``i`` of every leaf, its gain per
    column."""
    st = lp.store

    def pick(t):
        return None if t is None else t[i]

    store = WeightStore(  # verify: allow-packed-weights
        codes=st.codes[i], w_scale=st.w_scale[i], gain=st.gain[i],
        col_gain=pick(st.col_gain), row_gain=pick(st.row_gain),
        chunk_gain=pick(st.chunk_gain), gain_map=pick(st.gain_map),
        chunk_rows=st.chunk_rows, col_blocks=st.col_blocks)
    return dataclasses.replace(
        lp, store=store, a_scale=lp.a_scale[i],
        chunk_offset=pick(lp.chunk_offset), colsum=pick(lp.colsum),
        bias=pick(lp.bias), a_scale_in=pick(lp.a_scale_in))


def run_batch_concat(gp: GroupPlan, xs, cfg: AnalogConfig, *, noise=None):
    """Replay a ``batch_concat`` group: G same-geometry layers with
    DIFFERENT inputs as ONE analog dispatch (the RWKV r/k/v/g fusion,
    4 -> 1).  ``xs`` holds the member inputs in ``gp.member_names``
    order (one shape); the tuple of member outputs comes back.

    Each member encodes at its own input scale - under dynamic
    calibration its own abs-max, under static its own ``in_scale`` (the
    group's shared ``a_scale_in`` when it was calibrated together) - then
    one split call on ``[G, M, K]`` operands runs every member at its
    own gain, offsets and gain tables (the split kernel's member axis on
    the card, :func:`repro_torch.kernels.ops.analog_mvm_split_members`),
    and each member dequantizes as :func:`run_layer` does, so the result
    equals the G solo dispatches bit for bit (the reference vmaps
    ``run_layer`` over the members).  With readout noise, and for the
    other signed encodings, the members replay one after another through
    :func:`run_layer` (``noise``: one source for all, drawn in member
    order, or one injected draw per member); that too counts one
    dispatch.  Differentiable: the fused call's HIL backward is the 2-D
    split pair's batched over the members
    (:func:`repro_torch.kernels.ops.analog_mvm_split_members`), and the
    member-by-member replay differentiates through :func:`run_layer`."""
    from repro_torch.kernels import ops as kernel_ops

    g = len(gp.member_names)
    if len(xs) != g:
        raise ValueError(f"group has {g} members ({gp.member_names}), got "
                         f"{len(xs)} inputs")
    lp = gp.fused
    if lp.store.codes.ndim != 3:
        raise ValueError(
            "run_batch_concat expects member-leading [G, K_pad, N] plan "
            "leaves (a scan-stacked group is a PlanStack: pick its member "
            f"first), got codes of shape {tuple(lp.store.codes.shape)}")
    x = torch.stack(list(xs))
    rn = None if cfg.deterministic else noise
    if lp.signed_input != "split" or not cfg.fused_split or rn is not None:
        with _one_dispatch():
            return tuple(
                run_layer(_member_plan(lp, i), xs[i], cfg, noise=nz)
                for i, nz in enumerate(_layer_noise(rn, g)))
    check_route(cfg, x)
    in_dtype = x.dtype
    xf = x.to(torch.float32)
    if cfg.act_calib == "dynamic":
        a_scale = quant.act_scale_from_max(
            shd.batch_amax(xf.detach().abs().reshape(g, -1).amax(dim=1))
            + 1e-9)
    else:
        a_scale = lp.in_scale
    lead = (g,) + (1,) * (x.ndim - 1)
    a_scale = a_scale.reshape(lead)
    k_pad = lp.k_pad
    a_pos = _pad_codes(quant.quantize_act(xf, a_scale), k_pad)
    a_neg = _pad_codes(quant.quantize_act(-xf, a_scale), k_pad)
    batch_shape = a_pos.shape[1:-1]
    gain = lp.gain_row                                            # [G, N]
    _count()
    y_int = kernel_ops.analog_mvm_split_members(
        a_pos.reshape(g, -1, k_pad), a_neg.reshape(g, -1, k_pad), gain,
        lp.chunk_offset, store=lp.store, chunk_rows=lp.chunk_rows,
        faithful=cfg.mode != "analog_fast",
    ).reshape((g,) + batch_shape + (lp.n,))
    cols = (g,) + (1,) * len(batch_shape) + (lp.n,)
    y = y_int * (a_scale * lp.w_scale.reshape(cols) / gain.reshape(cols))
    if lp.bias is not None:
        y = y + lp.bias.reshape(cols)
    y = y.to(in_dtype)
    return tuple(y[i] for i in range(g))


def run_expert_stack(gp: GroupPlan, xe: torch.Tensor,
                     cfg: AnalogConfig) -> torch.Tensor:
    """Replay an ``expert_stack`` group: ``xe [E, C, K]`` through the
    pre-lowered per-expert plan -> ``[E, C, N]``, as ONE dispatch (the
    split kernel's expert axis on the card, its plain version on the
    CPU).  One dynamic activation scale over the whole dispatch buffer,
    signed inputs through the pos / neg split, each expert's codes at its
    gain, then ``y_int * (a_scale * w_scale / gain)`` in the reference's
    order.  Expert readout noise is omitted, as on the per-call path.
    Differentiable: a store of fp32 STE codes (lowered under autograd)
    hands its codes to the split call as ``w_eff``, whose HIL backward is
    batched over the experts; the gain's gradient reaches the masters
    through the dequantization (and in fast mode through the product),
    the abs-max none (the reference's ``stop_gradient``)."""
    from repro_torch.kernels import ops as kernel_ops

    lp = gp.fused
    in_dtype = xe.dtype
    xf = xe.to(torch.float32)
    a_scale = quant.act_scale_from_max(
        shd.batch_amax(xf.detach().abs().max()) + 1e-9)
    a_pos = _pad_codes(quant.quantize_act(xf, a_scale), lp.k_pad)
    a_neg = _pad_codes(quant.quantize_act(-xf, a_scale), lp.k_pad)
    gain = lp.gain_row                                            # [E, N]
    _count()
    w = None if lp.store.codes.dtype == torch.int8 else lp.w_eff
    y_int = kernel_ops.analog_mvm_split(
        a_pos, a_neg, w, gain, None, chunk_rows=lp.chunk_rows,
        faithful=cfg.mode != "analog_fast", store=lp.store)
    y = y_int * (a_scale * lp.w_scale / gain[:, None, :1])
    return y.to(in_dtype)


def _run_layer_fused_infer(lp: LayerPlan, codes: torch.Tensor,
                           cfg: AnalogConfig) -> torch.Tensor:
    """Deterministic code-domain layer with the epilogue fused into the
    ``analog_mvm`` kernel (inference only: ``run`` never takes it under
    autograd)."""
    from repro_torch.kernels import ops as kernel_ops

    a = _pad_codes(codes.to(torch.float32), lp.k_pad)
    batch_shape = a.shape[:-1]
    epi = (EPILOGUE_RELU_SHIFT, lp.shift) \
        if lp.epilogue == EPILOGUE_RELU_SHIFT else None
    _count()
    y = kernel_ops.analog_mvm(
        a.reshape(-1, a.shape[-1]), lp.w_eff, lp.gain_row, lp.chunk_offset,
        chunk_rows=lp.chunk_rows, faithful=cfg.mode != "analog_fast",
        epilogue=epi,
    )
    return y.reshape(batch_shape + (lp.n,))


def _megakernel_batch_shape(plan: AnalogPlan, x: torch.Tensor):
    """The megakernel's output batch shape from ``x``'s leading dims, or a
    reason string when the shapes cannot feed the packed schedule.  Every
    flatten_out layer consumes the then-trailing batch dim."""
    lead = list(x.shape[:-1])
    for lp, meta in zip(plan.layers[:-1], plan.mega.schedule[:-1]):
        if not lp.flatten_out:
            continue
        if not lead or lead[-1] != meta.flatten:
            return (
                f"flatten layer expects a trailing batch dim of "
                f"{meta.flatten} positions, got input shape "
                f"{tuple(x.shape)}"
            )
        lead.pop()
    return tuple(lead)


def _run_megakernel(plan: AnalogPlan, x: torch.Tensor,
                    lead: tuple) -> torch.Tensor:
    """Replay a packed plan as ONE dispatch, the inter-layer activations -
    5-bit codes or re-encoded float features - kept inside the kernel.
    Bit-exact vs the layer-by-layer replay on the same device (same
    per-chunk ADC arithmetic, same floor-shift epilogue, same static
    encoding LSB and dequantization expression)."""
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels.ref import analog_plan_ref

    cfg, mega = plan.cfg, plan.mega
    lp = plan.layers[-1]
    x2 = x.to(torch.float32).reshape(-1, x.shape[-1])
    if mega.schedule[0].encode == "codes":
        x2 = _pad_codes(x2, plan.layers[0].k_pad)
    run_chain = (kernel_ops.analog_plan_codes if cfg.use_kernels
                 else analog_plan_ref)
    _count()
    y_int = run_chain(
        x2, mega.weights, mega.gain, mega.off, schedule=mega.schedule,
        chunk_rows=mega.chunk_rows, faithful=cfg.mode != "analog_fast",
        extras=mega.extras,
    )
    y_int = y_int.reshape(lead + (lp.n,))
    # run_layer's dequantization at the LSB the last layer's input was
    # encoded at: 1.0 for raw codes, the baked static scale for floats
    a_scale = 1.0 if mega.schedule[-1].encode == "codes" else lp.in_scale
    y = y_int * (a_scale * lp.w_scale.reshape(-1) / lp.gain)
    if lp.bias is not None:
        y = y + lp.bias
    if lp.flatten_out:
        y = y.reshape(y.shape[:-2] + (-1,))
    return y


def _megakernel_route(plan: AnalogPlan, x: torch.Tensor, x_is_codes: bool,
                      noise=None):
    """The output batch-shape tuple when this call can take the megakernel
    route, else the reason string it cannot."""
    if plan.mega is None:
        from repro_torch.exec.lower import megakernel_ineligible_reason

        return megakernel_ineligible_reason(plan) or "plan was not packed"
    entry = plan.mega.schedule[0].encode
    if entry == "codes" and not x_is_codes:
        return (
            "input is float but the packed chain consumes 5-bit codes "
            "(layer 0 encode 'codes')"
        )
    if entry != "codes" and x_is_codes:
        return (
            "input is codes but the packed chain encodes float "
            f"activations in-kernel (layer 0 encode {entry!r})"
        )
    if noise is not None and not plan.cfg.deterministic:
        return "noisy replay (readout-noise keys) is layer-by-layer"
    return _megakernel_batch_shape(plan, x)


def megakernel_fallback_reason(plan: AnalogPlan, x: torch.Tensor, *,
                               noise=None) -> Optional[str]:
    """Why a ``run(plan, x, noise=noise)`` call cannot take the megakernel
    route (None = it can)."""
    if plan.block is not None:
        return _block_fallback_reason(plan, noise, "auto")
    route = _megakernel_route(plan, x, plan.expects_codes, noise)
    return route if isinstance(route, str) else None


def _block_fallback_reason(plan: AnalogPlan, noise, megakernel
                           ) -> Optional[str]:
    if megakernel is False:
        return "megakernel=False"
    if noise is not None and not plan.cfg.deterministic:
        return "noisy replay (readout-noise keys) is layer-by-layer"
    return None


def _run_block_fallback(plan: AnalogPlan, x: torch.Tensor,
                        noise=None) -> torch.Tensor:
    """Per-layer replay of a block plan: 4 analog dispatches (fused QKV,
    o, fused up|gate, down) with the digital glue in PyTorch - the glue
    functions the whole-block plain version calls, so on one device the
    two routes agree bit for bit (tested).  ``noise`` gives each layer its
    readout-noise source (:func:`_layer_noise`; the reference's
    ``jax.random.split(key, 4)``)."""
    from repro_torch.models.attention import prefill_attention_glue
    from repro_torch.models.layers import norm_apply

    bg, cfg = plan.block, plan.cfg
    qkv_lp, o_lp, ug_lp, dn_lp = plan.layers
    ns = _layer_noise(noise, 4)
    b, s, _ = x.shape
    res = x.to(torch.float32)
    h = norm_apply({"scale": bg.ln1}, res, eps=bg.eps)
    qkv = run_layer(qkv_lp, h, cfg, noise=ns[0])
    o_in = prefill_attention_glue(
        qkv.reshape(b * s, qkv_lp.n), batch=b, seq=s,
        n_heads=bg.n_heads, n_kv_heads=bg.n_kv_heads,
        head_dim=bg.head_dim, rope_theta=bg.rope_theta,
    )
    res = res + run_layer(o_lp, o_in.reshape(b, s, o_lp.k), cfg,
                          noise=ns[1])
    h = norm_apply({"scale": bg.ln2}, res, eps=bg.eps)
    ug = run_layer(ug_lp, h, cfg, noise=ns[2])
    up, gate = ug[..., :bg.d_ff], ug[..., bg.d_ff:]
    y = run_layer(dn_lp, torch.nn.functional.silu(gate) * up, cfg,
                  noise=ns[3])
    return (res + y).to(x.dtype)


def _run_block(plan: AnalogPlan, x: torch.Tensor, *, noise,
               megakernel) -> torch.Tensor:
    """Execute a block plan (:func:`repro_torch.exec.lower.lower_block`):
    ``x [batch, seq, d_model]`` -> same shape, the whole attention+MLP
    block as ONE dispatch (the ``analog_plan_block`` kernel on the card),
    or 4 on the per-layer fallback (``megakernel=False``, or a noisy
    call: ``megakernel=True`` then raises with the reason).  Computes in
    fp32 and casts the output back to ``x``'s dtype once."""
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels.ref import analog_plan_ref

    bg, cfg, mega = plan.block, plan.cfg, plan.mega
    if x.ndim != 3 or x.shape[-1] != plan.layers[0].k:
        raise ValueError(
            f"block plan expects [batch, seq, {plan.layers[0].k}] float "
            f"activations, got shape {tuple(x.shape)}"
        )
    if x.shape[1] != bg.seq:
        raise ValueError(
            f"block plan was lowered for the static prefill length "
            f"seq={bg.seq}, got seq={x.shape[1]}; re-lower for this "
            "length (the in-kernel attention bakes its positions)"
        )
    reason = _block_fallback_reason(plan, noise, megakernel)
    if reason is not None:
        if megakernel is True:
            raise ValueError(f"megakernel=True, but: {reason}")
        _obs_metrics.counter("exec.run.per_layer").inc()
        return _run_block_fallback(plan, x, noise)
    _obs_metrics.counter("exec.run.megakernel").inc()
    b, s, d = x.shape
    run_block = (kernel_ops.analog_plan_codes if cfg.use_kernels
                 else analog_plan_ref)
    _count()
    y = run_block(
        x.to(torch.float32).reshape(b * s, d), mega.stores, mega.gain,
        mega.off, schedule=mega.schedule, chunk_rows=mega.chunk_rows,
        faithful=cfg.mode != "analog_fast", extras=mega.extras,
        block=mega.block,
    )
    return y.reshape(b, s, d).to(x.dtype)


def _layer_noise(noise, n: int) -> list:
    """One readout-noise source per layer: the generator for every layer
    (it draws in sequence), or the per-layer injected draws (they stand in
    for the reference's ``jax.random.split(key, n)``)."""
    if noise is None or isinstance(noise, (torch.Generator, NoiseFeed)):
        return [noise] * n
    noise = list(noise)
    if len(noise) != n:
        raise ValueError(f"{len(noise)} readout-noise draws for {n} layers")
    return noise


def run(
    plan: AnalogPlan,
    x: torch.Tensor,
    *,
    noise=None,
    megakernel="auto",
) -> torch.Tensor:
    """Execute a whole lowered stack.

    Layers whose predecessor emitted a ``relu_shift`` epilogue consume
    5-bit codes directly; the plan's baked ``input_domain`` states
    whether the initial input already is codes.

    ``noise``: temporal readout noise, a ``torch.Generator`` on ``x``'s
    device or a sequence of one injected draw per layer
    (:func:`repro_torch.core.analog.analog_matmul`); ignored when
    ``plan.cfg.deterministic``.  A noisy call replays layer by layer (a
    block plan too: one source per layer, :func:`_run_block_fallback`).

    ``megakernel``: ``"auto"`` (default) takes the whole-plan route
    whenever the plan and the call are eligible, ``False`` forces the
    layer-by-layer replay, ``True`` requires the whole-plan route and
    raises ``ValueError`` with the reason when it cannot be taken.  A
    block plan takes ``x [batch, seq, d_model]`` (:func:`_run_block`).

    ``cfg.use_kernels=False`` (the reference's plain arithmetic) runs on
    the CPU only; a CUDA input under it raises ``ValueError``.
    """
    cfg = plan.cfg
    check_route(cfg, x)
    n = len(plan.layers)
    if megakernel not in (True, False, "auto"):
        raise ValueError(f"megakernel must be 'auto'|True|False, "
                         f"got {megakernel!r}")
    if plan.block is not None:
        return _run_block(plan, x, noise=noise, megakernel=megakernel)
    x_is_codes = plan.expects_codes
    if megakernel is True or megakernel == "auto":
        route = _megakernel_route(plan, x, x_is_codes, noise)
        if not isinstance(route, str):
            _obs_metrics.counter("exec.run.megakernel").inc()
            return _run_megakernel(plan, x, route)
        if megakernel is True:
            raise ValueError(f"megakernel=True, but: {route}")
    _obs_metrics.counter("exec.run.per_layer").inc()
    is_codes = x_is_codes
    h = x
    for i, (lp, nz) in enumerate(zip(plan.layers, _layer_noise(noise, n))):
        fuse_in_kernel = (
            cfg.fused_epilogue and cfg.use_kernels and is_codes
            and lp.signed_input == "none"
            and lp.epilogue == EPILOGUE_RELU_SHIFT
            and (nz is None or cfg.deterministic)
            and not needs_grad(h) and not lp.store.records_grad()
        )
        if fuse_in_kernel:
            h = _run_layer_fused_infer(lp, h, cfg)
        else:
            h = run_layer(lp, h, cfg, noise=nz, x_is_codes=is_codes)
        if lp.epilogue == EPILOGUE_NONE and i < n - 1:
            # float hand-off between layers: ReLU in the float domain,
            # the next layer re-quantizes
            h = torch.relu(h)
            is_codes = False
        else:
            is_codes = lp.epilogue == EPILOGUE_RELU_SHIFT
        if lp.flatten_out:
            # merge the position axis into the feature axis, preserving
            # any leading batch dims
            h = h.reshape(h.shape[:-2] + (-1,))
    return h
