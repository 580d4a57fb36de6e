"""Public kernel wrappers with device dispatch (port of
``repro.kernels.ops``).

Each wrapper launches its hand-written CUDA kernel when the tensors lie
on a CUDA device and runs the plain PyTorch version of
:mod:`repro_torch.kernels.ref` when they lie on the CPU - and only then.
There is no fallback: a CUDA tensor whose kernel fails to build or to
launch raises.  Each kernel counts its launches
(:func:`launch_counts`, :func:`reset_launch_counts`), so a run can show
that its main path went through the kernels.

Hardware-in-the-loop training (paper §III-B) differentiates through
:func:`analog_mvm` and the chain form of :func:`analog_plan_codes`: their
forward is the kernel (the hardware), their backward the straight-through
linearization ``y ~= gain * (a @ w_eff)`` with frozen gain and offsets,
as plain tensor ops and ``torch.matmul`` (the reference's backwards are
plain products outside any Pallas kernel too), at full fp32 precision.
The signed-split pair (:func:`analog_mvm_split`) has the reference's
``_analog_mvm_split_bwd``, and so has the split kernel's leading axis -
the members of a batch_concat group (:func:`analog_mvm_split_members`)
and the experts of an MoE expert stack - as one batched product
(:class:`_AnalogMVMLead`).  The block form of :func:`analog_plan_codes`
differentiates through :class:`_PlanBlock`: the forward is the one
``analog_plan_block`` launch, the backward the VJP of the block's STE
walk with each VMM through the per-layer ops above.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.device import fp32_matmuls
from repro_torch.core.hw import BSS2
from repro_torch.core.quant import _tie_mask
from repro_torch.kernels import _build
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels.analog_mvm import (analog_mvm_cuda,
                                            analog_mvm_split_codes_cuda,
                                            analog_mvm_split_cuda,
                                            analog_mvm_split_experts_cuda,
                                            analog_mvm_split_members_cuda,
                                            int8_codes)
from repro_torch.kernels.analog_plan import (analog_plan_block_cuda,
                                             analog_plan_cuda)
from repro_torch.kernels.preproc import maxmin_pool_cuda

launch_counts = _build.launch_counts
reset_launch_counts = _build.reset_launch_counts


def _on_cuda(t: torch.Tensor) -> bool:
    """True: launch the kernel.  False: the plain version, on the CPU, or
    on ``meta`` tensors, whose shapes it traces (the dry run)."""
    if t.device.type == "cuda":
        return True
    if t.device.type not in ("cpu", "meta"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return False


def _contiguous(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.contiguous()


def needs_grad(*tensors) -> bool:
    """Does autograd record a call on these tensors?"""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _mvm(a_code, w_eff, gain, chunk_offset, *, chunk_rows, faithful,
         epilogue=None):
    """One ``analog_mvm`` call: the kernel on the card, the plain version
    on the CPU."""
    if _on_cuda(a_code):
        return analog_mvm_cuda(a_code.contiguous(), w_eff.contiguous(),
                               gain.contiguous(), _contiguous(chunk_offset),
                               chunk_rows=chunk_rows, faithful=faithful,
                               epilogue=epilogue)
    y = ref_lib.analog_mvm_ref(a_code, w_eff, gain, chunk_offset,
                               chunk_rows=chunk_rows, faithful=faithful)
    return ref_lib.adc_epilogue_ref(y, epilogue)


class _AnalogMVM(torch.autograd.Function):
    """``analog_mvm`` with the HIL backward of the reference's
    ``_analog_mvm_bwd``: ``da = (g * gain) @ w_eff^T``, ``dw = a^T @ (g *
    gain)``, zero gradient for the gain and the chunk offsets."""

    @staticmethod
    def forward(ctx, a_code, w_eff, gain, chunk_offset, chunk_rows,
                faithful):
        ctx.save_for_backward(a_code, w_eff, gain)
        return _mvm(a_code, w_eff, gain, chunk_offset,
                    chunk_rows=chunk_rows, faithful=faithful)

    @staticmethod
    def backward(ctx, g):
        a_code, w_eff, gain = ctx.saved_tensors
        gg = g * gain
        with fp32_matmuls():
            return (torch.matmul(gg, w_eff.t()),
                    torch.matmul(a_code.t(), gg),
                    torch.zeros_like(gain), None, None, None)


def analog_mvm(
    a_code: torch.Tensor,
    w_eff: torch.Tensor,
    gain: torch.Tensor,
    chunk_offset: Optional[torch.Tensor],
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
    epilogue=None,
) -> torch.Tensor:
    """[M, K] x [K, N] chunked saturating analog VMM: raw ADC codes, or
    5-bit codes when ``epilogue=("relu_shift", shift)`` is fused into the
    kernel (the per-layer hot path of the plan executor; inference only).
    Differentiable without an epilogue (HIL backward, :class:`_AnalogMVM`)."""
    if not needs_grad(a_code, w_eff):
        return _mvm(a_code, w_eff, gain, chunk_offset, chunk_rows=chunk_rows,
                    faithful=faithful, epilogue=epilogue)
    if epilogue is not None:
        raise ValueError(
            "the fused in-kernel epilogue is inference-only; the "
            "differentiable path applies it as elementwise STE ops")
    return _AnalogMVM.apply(a_code, w_eff, gain, chunk_offset, chunk_rows,
                            faithful)


def _split(a_pos, a_neg, w_eff, gain, chunk_offset, *, chunk_rows,
           faithful, epilogue, store):
    """One signed-split call: the kernel on the card, the plain version on
    the CPU (:func:`analog_mvm_split`)."""
    on_card = _on_cuda(a_pos)
    if on_card and store is not None and store.code_operand:
        return analog_mvm_split_codes_cuda(
            a_pos.contiguous(), a_neg.contiguous(), int8_codes(store),
            store.col_gain, store.row_gain, gain.contiguous(),
            _contiguous(chunk_offset),
            chunk_gain=_contiguous(store.chunk_gain),
            col_blocks=store.col_blocks,
            chunk_rows=chunk_rows, faithful=faithful, epilogue=epilogue)
    if w_eff is None:       # the store's codes stood for it
        w_eff = store.w_eff
    if on_card:
        return analog_mvm_split_cuda(
            a_pos.contiguous(), a_neg.contiguous(), w_eff.contiguous(),
            gain.contiguous(), _contiguous(chunk_offset),
            chunk_rows=chunk_rows, faithful=faithful, epilogue=epilogue)
    y = ref_lib.split_plain_ref(a_pos, a_neg, w_eff, gain, chunk_offset,
                                chunk_rows=chunk_rows, faithful=faithful)
    return ref_lib.adc_epilogue_ref(y, epilogue)


class _AnalogMVMSplit(torch.autograd.Function):
    """The split pair with the HIL backward of the reference's
    ``_analog_mvm_split_bwd``, the linearization ``y ~= gain * ((a_pos -
    a_neg) @ w_eff)``: ``da_pos = (g * gain) @ w_eff^T``, ``da_neg =
    -da_pos``, ``dw = (a_pos - a_neg)^T @ (g * gain)``, zero gradient for
    the gain and the chunk offsets.  The forward is the kernel."""

    @staticmethod
    def forward(ctx, a_pos, a_neg, w_eff, gain, chunk_offset, chunk_rows,
                faithful, store):
        ctx.save_for_backward(a_pos, a_neg, w_eff, gain)
        return _split(a_pos, a_neg, w_eff, gain, chunk_offset,
                      chunk_rows=chunk_rows, faithful=faithful,
                      epilogue=None, store=store)

    @staticmethod
    def backward(ctx, g):
        a_pos, a_neg, w_eff, gain = ctx.saved_tensors
        gg = g * gain
        with fp32_matmuls():
            da = torch.matmul(gg, w_eff.t())
            dw = torch.matmul((a_pos - a_neg).t(), gg)
        return (da, -da, dw, torch.zeros_like(gain), None, None, None,
                None)


def _split_experts(a_pos, a_neg, w_eff, gain, *, chunk_rows, faithful,
                   store):
    """The expert axis of :func:`analog_mvm_split`: ``[E, M, K]``
    operands against ``[E, K, N]`` weights, the reference's expert
    products (``analog_matmul`` without a kernel: faithful mode reads
    out every chunk at ``gain``, fast mode scales each pass's total by
    it), in one launch on the card.  The card reads the store's int8
    codes; the fp32 STE codes of a store lowered under autograd hold the
    same 6-bit integers and are cast."""
    post = None
    if not faithful:
        post, gain = gain, torch.ones_like(gain)
    if _on_cuda(a_pos):
        if store is None or not store.code_operand or \
                store.codes.dtype not in (torch.int8, torch.float32) or \
                store.col_gain is not None:
            raise ValueError("the expert axis reads a table-free expert-"
                             "stack store of int8 (or fp32 STE) codes on "
                             "the card")
        return analog_mvm_split_experts_cuda(
            a_pos.contiguous(), a_neg.contiguous(), int8_codes(store),
            gain.contiguous(), post_gain=_contiguous(post),
            chunk_rows=chunk_rows, faithful=faithful)
    return ref_lib.analog_mvm_split_experts_ref(
        a_pos, a_neg, store.w_eff if w_eff is None else w_eff, gain,
        post_gain=post, chunk_rows=chunk_rows, faithful=faithful)


def _split_members(a_pos, a_neg, gain, chunk_offset, *, store, chunk_rows,
                   faithful):
    """The member axis of :func:`analog_mvm_split_members`: one launch
    on the card, the plain version on the CPU."""
    if _on_cuda(a_pos):
        if store.code_operand:
            return analog_mvm_split_members_cuda(
                a_pos.contiguous(), a_neg.contiguous(), int8_codes(store),
                _contiguous(store.col_gain), _contiguous(store.row_gain),
                gain.contiguous(), _contiguous(chunk_offset),
                chunk_gain=_contiguous(store.chunk_gain),
                chunk_rows=chunk_rows, faithful=faithful)
        return analog_mvm_split_members_cuda(
            a_pos.contiguous(), a_neg.contiguous(),
            store.w_eff.detach().contiguous(), None, None, gain.contiguous(),
            _contiguous(chunk_offset), chunk_rows=chunk_rows,
            faithful=faithful)
    return ref_lib.analog_mvm_split_members_ref(
        a_pos, a_neg, store.w_eff, gain, chunk_offset, chunk_rows=chunk_rows,
        faithful=faithful)


class _AnalogMVMLead(torch.autograd.Function):
    """The split kernel's leading axis - the G members of a batch_concat
    group or the E experts of an expert stack - with the HIL backward of
    the 2-D pair batched over that axis (the reference vmaps
    ``analog_mvm_split``'s custom VJP over the members, and its expert
    products' faithful backward is ``_faithful_mm_bwd`` per expert):
    ``da_pos = bmm(g * gain, w_eff^T)``, ``da_neg = -da_pos``, ``dw =
    bmm((a_pos - a_neg)^T, g * gain)``, zero gradient for the gain and
    the chunk offsets.  The forward is the one launch.

    The experts in fast mode differentiate as the reference's jnp
    expert product does (``clip(round_ste(total * gain))`` per pass):
    the gradient passes each pass's unclipped outputs (half of it at a
    clip bound, ``jnp.clip``'s rule), and reaches the gain - there it is
    not frozen."""

    @staticmethod
    def forward(ctx, a_pos, a_neg, w_eff, gain, chunk_offset, experts,
                chunk_rows, faithful, store):
        ctx.save_for_backward(a_pos, a_neg, w_eff, gain)
        ctx.fast_experts = experts and not faithful
        ctx.chunk_rows = chunk_rows
        if experts:
            return _split_experts(a_pos, a_neg, w_eff, gain,
                                  chunk_rows=chunk_rows, faithful=faithful,
                                  store=store)
        return _split_members(a_pos, a_neg, gain, chunk_offset, store=store,
                              chunk_rows=chunk_rows, faithful=faithful)

    @staticmethod
    def backward(ctx, g):
        a_pos, a_neg, w_eff, gain = ctx.saved_tensors
        gain3 = gain[:, None, :]
        w_t = w_eff.transpose(1, 2)
        with fp32_matmuls():
            if not ctx.fast_experts:
                gg = g * gain3
                da = torch.bmm(gg, w_t)
                dw = torch.bmm((a_pos - a_neg).transpose(1, 2), gg)
                return (da, -da, dw, torch.zeros_like(gain), None, None,
                        None, None, None)
            c = a_pos.shape[-1] // ctx.chunk_rows
            lo, hi = float(BSS2.adc_min * c), float(BSS2.adc_max * c)
            grads, dw, dgain = [], 0.0, 0.0
            for a, ga in ((a_pos, g), (a_neg, -g)):
                total = torch.bmm(a, w_eff)
                dv = ga * _tie_mask(torch.round(total * gain3), lo, hi)
                dt = dv * gain3
                grads.append(torch.bmm(dt, w_t))
                dw = dw + torch.bmm(a.transpose(1, 2), dt)
                dgain = dgain + (dv * total).sum(dim=1)
        return (grads[0], grads[1], dw, dgain, None, None, None, None,
                None)


def analog_mvm_split(
    a_pos: torch.Tensor,
    a_neg: torch.Tensor,
    w_eff: torch.Tensor,
    gain: torch.Tensor,
    chunk_offset: Optional[torch.Tensor],
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
    epilogue=None,
    store=None,
) -> torch.Tensor:
    """Signed-split analog VMM ``mvm(a_pos) - mvm(a_neg)`` as ONE dispatch
    (the per-layer hot path of LM plans), with the optional fused
    ``relu_shift`` epilogue.  On the card, a ``store`` (the layer's
    :class:`~repro_torch.exec.plan.WeightStore`, whose ``w_eff`` this is)
    without a full gain map (:attr:`WeightStore.code_operand`: rank-1
    tables and a measured ``chunk_gain``) selects the kernel's int8 code
    operand - under autograd too, where the store holds its codes as fp32
    STE values; a store with a gain map, or none, the fp32 ``w_eff``
    operand; ``w_eff`` None: the store's codes stand for it (the plain
    version and the fp32 operand read the store's view).  On the CPU: the
    faithful chunk scan, or for fast mode the
    stacked ``[2M, K]`` plain version (pre-round sums are
    order-sensitive, so fast mode keeps the oracle's arithmetic).
    Differentiable without an epilogue (HIL backward,
    :class:`_AnalogMVMSplit`).

    ``[E, M, K]`` operands with ``w_eff [E, K, N]`` (or None: the
    store's) and ``gain [E, N]`` run the expert axis
    (:func:`_split_experts`): the E matrices of an MoE expert stack, no
    chunk offsets and no epilogue, differentiable through
    :class:`_AnalogMVMLead`."""
    if a_pos.ndim == 3:
        if chunk_offset is not None or epilogue is not None:
            raise ValueError("the expert axis takes no chunk offsets and "
                             "no epilogue")
        if needs_grad(a_pos, a_neg, w_eff, gain):
            return _AnalogMVMLead.apply(
                a_pos, a_neg, store.w_eff if w_eff is None else w_eff, gain,
                None, True, chunk_rows, faithful, store)
        return _split_experts(a_pos, a_neg, w_eff, gain,
                              chunk_rows=chunk_rows, faithful=faithful,
                              store=store)
    if not needs_grad(a_pos, a_neg, w_eff):
        return _split(a_pos, a_neg, w_eff, gain, chunk_offset,
                      chunk_rows=chunk_rows, faithful=faithful,
                      epilogue=epilogue, store=store)
    if epilogue is not None:
        raise ValueError(
            "the fused in-kernel epilogue is inference-only; the "
            "differentiable path applies it as elementwise STE ops")
    return _AnalogMVMSplit.apply(a_pos, a_neg, w_eff, gain, chunk_offset,
                                 chunk_rows, faithful, store)


def analog_mvm_split_members(
    a_pos: torch.Tensor,
    a_neg: torch.Tensor,
    gain: torch.Tensor,
    chunk_offset: Optional[torch.Tensor],
    *,
    store,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
) -> torch.Tensor:
    """The member axis of :func:`analog_mvm_split`: the G members of a
    batch_concat group (``store``, a member-axis
    :class:`~repro_torch.exec.plan.WeightStore`: codes ``[G, K, N]`` and
    each member's gain tables) against ``[G, M, K]`` operands, each
    member at its own ``gain [G, N]`` and ``chunk_offset [G, C, N]``, as
    ONE launch on the card (:func:`~repro_torch.kernels.analog_mvm.
    analog_mvm_split_members_cuda`, counted as
    ``analog_mvm_split_members``) and as the plain version on the CPU.
    Member ``g`` equals the 2-D call on member ``g``'s operands bit for
    bit.  Differentiable: under autograd the same launch runs inside
    :class:`_AnalogMVMLead`, whose backward is the 2-D pair's batched
    over the members (the weights' gradient reaches ``store.w_eff``)."""
    if needs_grad(a_pos, a_neg) or store.records_grad():
        return _AnalogMVMLead.apply(a_pos, a_neg, store.w_eff, gain,
                                    chunk_offset, False, chunk_rows,
                                    faithful, store)
    return _split_members(a_pos, a_neg, gain, chunk_offset, store=store,
                          chunk_rows=chunk_rows, faithful=faithful)


def _plan_forward(x_in, weights, gain_all, off_cat, *, schedule, chunk_rows,
                  faithful, extras, block):
    """One whole-plan call: the kernel on the card, the plain version on
    the CPU."""
    if _on_cuda(x_in):
        args = (x_in.contiguous(), gain_all.contiguous(), off_cat.contiguous())
        if extras is not None:
            extras = tuple(_contiguous(t) for t in extras)
        if block is not None:
            return analog_plan_block_cuda(
                args[0], tuple(weights), *args[1:],
                schedule=schedule, block=block, extras=extras,
                chunk_rows=chunk_rows, faithful=faithful)[0]
        return analog_plan_cuda(args[0], weights.contiguous(), *args[1:],
                                schedule=schedule, chunk_rows=chunk_rows,
                                faithful=faithful, extras=extras)
    return ref_lib.analog_plan_ref(x_in, weights, gain_all, off_cat, schedule,
                                   chunk_rows=chunk_rows, faithful=faithful,
                                   extras=extras, block=block)


def analog_plan_codes(
    x_in: torch.Tensor,
    weights,
    gain_all: torch.Tensor,
    off_cat: torch.Tensor,
    *,
    schedule,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
    extras=None,
    block=None,
) -> torch.Tensor:
    """Whole-plan dispatch: ONE kernel launch for a packed layer chain
    (``weights`` is its ``w_cat``) or for one attention+MLP block
    (``block`` set; ``weights`` holds the four layers'
    :class:`~repro_torch.exec.plan.WeightStore` records, whose int8 codes
    the kernel reads unless a store holds a full gain map, or their fp32
    ``w_eff`` tensors).
    ``extras`` carries the packed float-glue rows ``(deq, bias, enc,
    ln)``.  Returns the final layer's raw accumulated ADC codes
    ``[B * m_last, n_last]``, or the block output.

    Both forms are differentiable: the forward is still the one launch,
    the backward the STE/HIL chain rule of the reference's
    ``_plan_codes`` (:class:`_PlanChain`, :class:`_PlanBlock`)."""
    kw = dict(schedule=schedule, chunk_rows=chunk_rows, faithful=faithful,
              extras=extras, block=block)
    operands = list(extras or ())
    if block is None:
        operands.append(weights)
    else:
        # a store is asked, not read: a read of its w_eff derives it
        operands.extend(w for w in weights if isinstance(w, torch.Tensor))
    if not needs_grad(x_in, *operands) and not any(
            w.records_grad() for w in weights
            if block is not None and not isinstance(w, torch.Tensor)):
        return _plan_forward(x_in, weights, gain_all, off_cat, **kw)
    if block is not None:
        stores = None
        if getattr(weights[0], "codes", None) is not None:
            stores = tuple(weights)
        return _PlanBlock.apply(x_in, *extras, gain_all, off_cat,
                                stores, schedule, block, chunk_rows,
                                faithful, *(getattr(w, "w_eff", w)
                                            for w in weights))
    deq = bias = enc = None
    if extras is not None:
        deq, bias, enc, _ = extras
    return _PlanChain.apply(x_in, weights, gain_all, off_cat, deq, bias, enc,
                            schedule, chunk_rows, faithful)


class _PlanChain(torch.autograd.Function):
    """A packed layer chain with the HIL backward of the reference's
    ``_plan_codes`` (the VJP of its STE reference chain): the forward is
    the ``analog_plan`` launch; the backward replays the chain's walk
    (:func:`repro_torch.kernels.ref.analog_plan_ref`) with each layer's
    VMM through :func:`analog_mvm` - the ``analog_mvm`` kernel on the
    card, bit-identical to the chain kernel, whose HIL backward is the
    linearization - and differentiates it.  Gain and offsets are frozen
    (zero gradient); the float-glue rows (dequant, bias, encode LSB) get
    real gradients, as through the per-layer dequantization."""

    @staticmethod
    def forward(ctx, x_in, w_cat, gain_all, off_cat, deq, bias, enc,
                schedule, chunk_rows, faithful):
        ctx.save_for_backward(x_in, w_cat, gain_all, off_cat, deq, bias, enc)
        ctx.static = (schedule, chunk_rows, faithful)
        extras = None if deq is None else (deq, bias, enc, None)
        return _plan_forward(x_in, w_cat, gain_all, off_cat,
                             schedule=schedule, chunk_rows=chunk_rows,
                             faithful=faithful, extras=extras, block=None)

    @staticmethod
    def backward(ctx, g):
        schedule, chunk_rows, faithful = ctx.static
        # gain_all and off_cat (positions 2, 3) stay frozen
        need = [n and i not in (2, 3)
                for i, n in enumerate(ctx.needs_input_grad[:7])]
        with torch.enable_grad():
            args = [None if t is None else t.detach().requires_grad_(n)
                    for t, n in zip(ctx.saved_tensors, need)]
            x_in, w_cat, gain_all, off_cat, deq, bias, enc = args
            extras = None if deq is None else (deq, bias, enc, None)

            def vmm(a, w_l, gain, offs):
                return analog_mvm(a, w_l, gain, offs, chunk_rows=chunk_rows,
                                  faithful=faithful)

            y = ref_lib.analog_plan_ref(
                x_in, w_cat, gain_all, off_cat, schedule,
                chunk_rows=chunk_rows, faithful=faithful, extras=extras,
                vmm=vmm)
            wrt = [t for t, n in zip(args, need) if n]
            got = iter(torch.autograd.grad(y, wrt, g, allow_unused=True))
        grads = tuple(next(got) if n else None for n in need)
        return grads + (None, None, None)


class _PlanBlock(torch.autograd.Function):
    """One attention+MLP block plan with the HIL backward of the
    reference's ``_plan_codes`` (the VJP of its STE walk): the forward is
    the ONE ``analog_plan_block`` launch (the plain version on the CPU);
    the backward replays the block's walk
    (:func:`repro_torch.kernels.ref.analog_plan_ref`) with each VMM
    through the per-layer ops whose HIL backward exists - a ``"split"``
    layer's pair through :func:`analog_mvm_split` (the split kernel on
    the card, reading the store's codes), an ``"unsigned"`` layer's pass
    through :func:`analog_mvm` - and the block glue (RMSNorms, RoPE and
    attention, residuals, SwiGLU, the dequantization), and
    differentiates it.  Gain and offsets are frozen (zero gradient);
    the input, the four layers' effective weights and the glue rows
    (``deq``, ``bias``, ``enc``, ``ln``) get real gradients - a store's
    ``w_eff`` carries its gradient on to the STE codes and the gain
    tables it was derived from.  The attention inside bakes the plan's
    static positions, as the forward does."""

    @staticmethod
    def forward(ctx, x_in, deq, bias, enc, ln, gain_all, off_cat, stores,
                schedule, block, chunk_rows, faithful, *w_effs):
        ctx.save_for_backward(x_in, deq, bias, enc, ln, gain_all, off_cat,
                              *w_effs)
        ctx.static = (stores, schedule, block, chunk_rows, faithful)
        return _plan_forward(x_in, w_effs if stores is None else stores, gain_all, off_cat,
                             schedule=schedule, chunk_rows=chunk_rows,
                             faithful=faithful, extras=(deq, bias, enc, ln),
                             block=block)

    @staticmethod
    def backward(ctx, g):
        stores, schedule, block, chunk_rows, faithful = ctx.static
        # gain_all and off_cat (positions 5, 6) stay frozen
        need = [n and i not in (5, 6)
                for i, n in enumerate(ctx.needs_input_grad[:7])]
        need += list(ctx.needs_input_grad[12:])
        with torch.enable_grad():
            args = [t.detach().requires_grad_(n)
                    for t, n in zip(ctx.saved_tensors, need)]
            x_in, deq, bias, enc, ln, gain_all, off_cat = args[:7]

            def vmm(a, w_l, gain, offs):
                return analog_mvm(a, w_l, gain, offs, chunk_rows=chunk_rows,
                                  faithful=faithful)

            def pair(li, a_pos, a_neg, w_l, gain, offs):
                return analog_mvm_split(
                    a_pos, a_neg, w_l, gain, offs, chunk_rows=chunk_rows,
                    faithful=faithful,
                    store=None if stores is None else stores[li])

            y = ref_lib.analog_plan_ref(
                x_in, args[7:], gain_all, off_cat, schedule,
                chunk_rows=chunk_rows, faithful=faithful,
                extras=(deq, bias, enc, ln), block=block, vmm=vmm,
                pair=pair)
            wrt = [t for t, n in zip(args, need) if n]
            got = iter(torch.autograd.grad(y, wrt, g, allow_unused=True))
        grads = [next(got) if n else None for n in need]
        return tuple(grads[:7]) + (None,) * 5 + tuple(grads[7:])


def maxmin_pool(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """[..., T] -> [..., T/window] max-min pooling (preprocessing chain)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if _on_cuda(x2):
        y = maxmin_pool_cuda(x2.contiguous(), window=window)
    else:
        y = ref_lib.maxmin_pool_ref(x2, window=window)
    return y.reshape(shape[:-1] + (shape[-1] // window,))
