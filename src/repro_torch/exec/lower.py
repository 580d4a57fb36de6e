"""Lowering: analog-layer parameters -> :class:`~repro_torch.exec.plan.AnalogPlan`
(port of the stack part of ``repro.exec.lower``).

The compile step of the compile-once/run-many split: everything that
depends only on the master weights and the frozen calibration state is
computed here, once - 6-bit weight quantization, the gain tables, chunk
padding of the weights, the chunk-offset table, the column-concatenated
plan of a fusion group (:func:`lower_fused`), the member-axis plan of a
batch_concat group (:func:`lower_batch_concat`), the per-expert plan of
an MoE expert stack (:func:`lower_expert_stack`), the fused attention+MLP
block (:func:`lower_block`) and, for eligible chains, the whole-plan
megakernel packing.  Per-call quantities (the dynamic
activation scale, the readout noise) stay in :mod:`repro_torch.exec.run`.

Calibration state comes from one of two sources, selected per layer:

- **oracle bake** (default): the frozen fixed-pattern dict in
  ``params["fpn"]`` - ground-truth deviations, known only in simulation;
- **measured bake**: a ``calib`` record (canonically a
  :class:`repro_torch.calib.snapshot.LayerCalibration`) from blind
  measurement of a device: its per-(chunk, column) ``gain_table`` and
  ``chunk_offset`` replace ``params["fpn"]``, an optional static
  ``a_scale`` / shared-group ``a_scale_in`` the params scale.  Fields
  the record did not measure (None) keep the oracle bake.

Every :func:`lower_layer` call adds one to :func:`lowering_count`, so a
caller can show that a hot-swap or a plan-store load lowered nothing.

Lowering is differentiable: the weight quantizer is the STE one and no
parameter is detached, so a gradient through ``lower`` + ``run``
reaches the float masters, and ``w_scale``, the analog gain and the
fixed-pattern tables get theirs too (hardware-in-the-loop training
re-lowers every step; serve and eval lower once under ``no_grad`` and
replay).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import noise as noise_lib
from repro_torch.core import quant
from repro_torch.core.analog import AnalogConfig, Params
from repro_torch.exec.plan import (
    EPILOGUE_NONE,
    EPILOGUE_RELU_SHIFT,
    INPUT_CODES,
    INPUT_FLOAT,
    AnalogPlan,
    BlockGlue,
    LayerPlan,
    MegakernelPack,
    PlanStack,
    WeightStore,
    default_shift,
)

# Lowering accounting (the reference's ``LOWERINGS``): the port is eager,
# so this counts every lower_layer call.
_LOWERINGS = 0


def reset_lowering_count() -> None:
    global _LOWERINGS
    _LOWERINGS = 0


def lowering_count() -> int:
    """:func:`lower_layer` calls since the last
    :func:`reset_lowering_count`."""
    return _LOWERINGS


def _table(x, dev: torch.device) -> torch.Tensor:
    """A measured calibration table as an fp32 tensor on ``dev``."""
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _calib_tables(calib) -> dict:
    """The measured tables a calibration record carries (its non-None
    fields), by field name."""
    return {f.name: getattr(calib, f.name) for f in dataclasses.fields(calib)
            if getattr(calib, f.name) is not None}


def stacked_calib(calib, s: int) -> bool:
    """True when ``calib`` is a per-stack-member calibration record whose
    every table carries a leading stack axis of length ``s`` - one
    measured device per scan-stack member (the fleet gather's ``[S, C,
    N]`` tables)."""
    if calib is None:
        return False
    tables = _calib_tables(calib).values()
    return bool(tables) and all(
        getattr(v, "ndim", 0) >= 1 and v.shape[0] == s for v in tables)


def stack_calibs(calib, s: int) -> list:
    """The per-member records of a scan stack of ``s`` members: slice
    ``i`` of every table of a per-stack-member record
    (:func:`stacked_calib`) for member ``i``, else ``s`` Nones (a record
    without a stack axis measured no single device of a stacked layer, so
    the stack keeps the oracle bake, as in the reference)."""
    if not stacked_calib(calib, s):
        return [None] * s
    tables = _calib_tables(calib)
    return [dataclasses.replace(calib, **{k: v[i] for k, v in tables.items()})
            for i in range(s)]


def lower_layer(
    params: Params,
    cfg: AnalogConfig,
    *,
    signed_input: Optional[str] = None,
    epilogue: str = EPILOGUE_NONE,
    flatten_out: bool = False,
    calib=None,
) -> LayerPlan:
    """Lower ONE analog linear layer's parameters to a :class:`LayerPlan`
    (on the device the parameters live on).

    ``signed_input`` overrides ``cfg.signed_input`` per layer;
    ``epilogue`` selects the inter-layer ADC treatment, whose right shift
    is the range-matched one for this layer's chunk count.  ``calib`` (a
    measured :class:`repro_torch.calib.snapshot.LayerCalibration`)
    replaces the oracle ``params["fpn"]`` bake with measured tables; its
    tables are moved to the parameters' device.
    """
    global _LOWERINGS
    _LOWERINGS += 1
    if epilogue not in (EPILOGUE_NONE, EPILOGUE_RELU_SHIFT):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue == EPILOGUE_RELU_SHIFT and params.get("b") is not None:
        # a relu_shift layer hands off raw 5-bit codes - a float bias has
        # no place to act (it would be silently dropped by the executor)
        raise ValueError(
            "bias is not representable in a relu_shift (code-domain) "
            "hand-off; lower the layer without bias or with epilogue='none'"
        )
    w = params["w"].to(torch.float32)
    k, n = w.shape
    w_scale = params["w_scale"]
    w_code = quant.quantize_weight(w, w_scale)
    n_chunks = -(-k // cfg.chunk_rows)
    pad = n_chunks * cfg.chunk_rows - k
    fpn = params.get("fpn", {})  # verify: allow-fpn-access
    dev = w.device
    a_scale = torch.as_tensor(params["a_scale"], dtype=torch.float32)
    a_scale_in = None
    # packed bake: the plan stores the 6-bit codes plus the gain TABLES;
    # the fp32 w_eff product is a derived view (same elementwise multiply
    # order as the reference, pad entries exact 1.0)
    col_gain = row_gain = chunk_gain = gain_map = None
    gt = None if calib is None else calib.gain_table
    chunk_off = None if calib is None else calib.chunk_offset
    if gt is not None:
        # measured bake: the per-(chunk, column) tables of blind device
        # measurement stand in for the ground-truth fixed pattern
        if tuple(gt.shape) != (n_chunks, n):
            raise ValueError(
                f"gain_table shape {tuple(gt.shape)} does not match the "
                f"({n_chunks}, {n}) chunk grid of a {k}x{n} layer"
            )
        chunk_gain = _table(gt, dev)
    if chunk_off is not None:
        if tuple(chunk_off.shape) != (n_chunks, n):
            raise ValueError(
                f"chunk_offset shape {tuple(chunk_off.shape)} does not "
                f"match the ({n_chunks}, {n}) chunk grid of a "
                f"{k}x{n} layer"
            )
        chunk_off = _table(chunk_off, dev)
    else:
        # a record without offsets keeps the oracle's: a scales-only
        # record must not silently model an ideal chip
        chunk_off = noise_lib.chunk_offsets(fpn, n_chunks, n)
    if calib is not None:
        if calib.a_scale is not None:
            a_scale = _table(calib.a_scale, dev)
        if calib.a_scale_in is not None:
            a_scale_in = _table(calib.a_scale_in, dev)
    if gt is None:
        if "gain" in fpn:
            gain_map = F.pad(fpn["gain"].to(torch.float32), (0, 0, 0, pad),
                             value=1.0)
        else:
            if "col_gain" in fpn:
                col_gain = fpn["col_gain"].to(torch.float32)
            if "row_gain" in fpn:
                row_gain = F.pad(fpn["row_gain"].to(torch.float32),
                                 (0, pad), value=1.0)[None, :]
    codes = F.pad(w_code, (0, 0, 0, pad))
    if not codes.requires_grad:
        # pack to int8; codes that require grad stay fp32, since the cast
        # would cut the straight-through gradient to the float masters
        # (HIL training re-lowers inside every step)
        codes = codes.to(torch.int8)
    store = WeightStore(  # verify: allow-packed-weights
        codes=codes,
        w_scale=w_scale,
        gain=torch.as_tensor(params["gain"], dtype=torch.float32),
        col_gain=col_gain,
        row_gain=row_gain,
        chunk_gain=chunk_gain,
        gain_map=gain_map,
        chunk_rows=cfg.chunk_rows,
    )
    signed = cfg.signed_input if signed_input is None else signed_input
    return LayerPlan(
        store=store,
        a_scale=a_scale,
        a_scale_in=a_scale_in,
        chunk_offset=chunk_off,
        # the offset encoding's digital correction reads the column sums
        colsum=store.w_eff.sum(dim=0) if signed == "offset" else None,
        bias=params.get("b"),
        k=k,
        n=n,
        chunk_rows=cfg.chunk_rows,
        signed_input=signed,
        epilogue=epilogue,
        shift=default_shift(n_chunks),
        flatten_out=flatten_out,
    )


def lower_fused(
    layer_params: Sequence[Params],
    cfg: AnalogConfig,
    *,
    signed_input: Optional[str] = None,
    calibs: Optional[Sequence] = None,
) -> LayerPlan:
    """Lower N same-input layers into ONE dispatch: their output columns
    concatenate into a single ``[K_pad, sum(N_i)]`` plan, so the executor
    issues one analog pass where the per-layer path issued N (the
    attention QKV group).

    Column-exact by construction: every per-column quantity (weight
    scale, gain, chunk offsets, the per-chunk ADC saturation) is
    independent across columns, so the fused dispatch equals the
    per-layer ones whenever the layers share the input encoding - always
    under dynamic activation calibration (the scale is recomputed from
    the shared input per call).  Under static calibration the group bakes
    ONE input LSB: when every ``calibs[i]`` carries the group's shared
    ``a_scale_in`` (:func:`repro_torch.calib.routines.
    share_group_input_scale`), the fused plan encodes and dequantizes at
    it; otherwise differing per-layer ``a_scale`` raise.
    """
    cs = list(calibs) if calibs is not None else [None] * len(layer_params)
    plans = [lower_layer(p, cfg, signed_input=signed_input, calib=c)
             for p, c in zip(layer_params, cs)]
    p0 = plans[0]
    for lp in plans:
        if lp.k != p0.k or lp.chunk_rows != p0.chunk_rows:
            raise ValueError(
                "fused layers must share the input dim and chunk geometry: "
                f"{[(p.k, p.chunk_rows) for p in plans]}"
            )
    a_scale, a_scale_in = p0.a_scale, None
    if cfg.act_calib == "static":
        if all(lp.a_scale_in is not None for lp in plans):
            # snapshot-calibrated group: encode AND dequantize the whole
            # group at the shared input LSB
            ins = [float(lp.a_scale_in) for lp in plans]
            if any(sc != ins[0] for sc in ins):
                raise ValueError(
                    "fused layers carry differing shared input scales "
                    f"a_scale_in={ins}; calibrate the group together "
                    "(repro_torch.calib.routines.share_group_input_scale)"
                )
            a_scale = a_scale_in = p0.a_scale_in
        else:
            scales = [float(lp.a_scale) for lp in plans]
            if any(sc != scales[0] for sc in scales):
                raise ValueError(
                    "lower_fused with act_calib='static' requires "
                    f"identical a_scale across the fused layers, got "
                    f"{scales}; lower them per-layer, recalibrate to a "
                    "shared scale, or calibrate the group "
                    "(repro_torch.calib.routines.share_group_input_scale)"
                )

    def cat(parts):
        return torch.cat(parts, dim=-1)

    def cat_or_fill(vals, fill):
        if all(v is None for v in vals):
            return None
        return cat([fill(lp) if v is None else v for v, lp in zip(vals, plans)])

    dev = p0.store.codes.device
    c, k_pad = p0.n_chunks, p0.k_pad
    f32 = dict(dtype=torch.float32, device=dev)
    stores = [lp.store for lp in plans]
    row_gain = col_blocks = None
    if any(s.row_gain is not None for s in stores):
        # per-member row gains cannot fold into one vector: one row per
        # column block (absent ones exact 1.0, and x * 1.0 is exact)
        row_gain = torch.stack([
            s.row_gain[0] if s.row_gain is not None
            else torch.ones((k_pad,), **f32) for s in stores
        ], dim=0)
        col_blocks = tuple(lp.n for lp in plans)
    store = WeightStore(  # verify: allow-packed-weights
        codes=cat([s.codes for s in stores]),
        w_scale=cat([s.w_scale for s in stores]),
        gain=cat([torch.broadcast_to(s.gain, (lp.n,))
                  for s, lp in zip(stores, plans)]),
        col_gain=cat_or_fill([s.col_gain for s in stores],
                             lambda lp: torch.ones((lp.n,), **f32)),
        row_gain=row_gain,
        chunk_gain=cat_or_fill([s.chunk_gain for s in stores],
                               lambda lp: torch.ones((c, lp.n), **f32)),
        gain_map=cat_or_fill([s.gain_map for s in stores],
                             lambda lp: torch.ones((k_pad, lp.n), **f32)),
        chunk_rows=p0.chunk_rows,
        col_blocks=col_blocks,
    )
    return LayerPlan(
        store=store,
        a_scale=a_scale,
        a_scale_in=a_scale_in,
        chunk_offset=cat_or_fill([lp.chunk_offset for lp in plans],
                                 lambda lp: torch.zeros((c, lp.n), **f32)),
        colsum=cat_or_fill([lp.colsum for lp in plans],
                           lambda lp: torch.zeros((lp.n,), **f32)),
        bias=cat_or_fill([lp.bias for lp in plans],
                         lambda lp: torch.zeros((lp.n,), **f32)),
        k=p0.k,
        n=sum(lp.n for lp in plans),
        chunk_rows=p0.chunk_rows,
        signed_input=p0.signed_input,
    )


def _stack_layer_plans(plans: Sequence[LayerPlan]) -> LayerPlan:
    """Stack G same-geometry plans along a new leading member axis (the
    reference's ``_stack_layer_plans``): every leaf gains the member
    axis, optional tables are filled for members that lack them (gains
    with exact 1.0, offsets, column sums and biases with 0.0, so each
    member's arithmetic is its own plan's), the gain broadcast per
    column, and ``a_scale_in`` stacked only when every member carries it
    (a partial group calibration must not unlock a shared encoding)."""
    p0 = plans[0]
    for lp in plans:
        if (lp.k, lp.n, lp.chunk_rows, lp.signed_input) != (
                p0.k, p0.n, p0.chunk_rows, p0.signed_input):
            raise ValueError(
                "batch-concat members must share the weight geometry and "
                "input encoding: "
                f"{[(p.k, p.n, p.chunk_rows, p.signed_input) for p in plans]}"
            )
        if lp.store.col_blocks != p0.store.col_blocks:
            raise ValueError(
                "batch-concat members must share the column-block layout: "
                f"{[p.store.col_blocks for p in plans]}")
    dev = p0.store.codes.device
    f32 = dict(dtype=torch.float32, device=dev)
    c, k_pad, n = p0.n_chunks, p0.k_pad, p0.n
    stores = [lp.store for lp in plans]
    g_rows = next((s.row_gain.shape[-2] for s in stores
                   if s.row_gain is not None), 1)

    def stk(vals, fill=None):
        if all(v is None for v in vals):
            return None
        if any(v is None for v in vals):
            if fill is None:
                return None
            vals = [fill() if v is None else v for v in vals]
        return torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                            device=dev) for v in vals])

    codes = [s.codes for s in stores]
    if any(t.dtype != torch.int8 for t in codes):
        codes = [t.to(torch.float32) for t in codes]
    store = WeightStore(  # verify: allow-packed-weights
        codes=torch.stack(codes),
        w_scale=stk([torch.broadcast_to(s.w_scale, (1, n)) for s in stores]),
        # per column whatever the members' (scalar) gains: equal values,
        # the same arithmetic
        gain=stk([torch.broadcast_to(s.gain, (n,)) for s in stores]),
        col_gain=stk([s.col_gain for s in stores],
                     lambda: torch.ones((n,), **f32)),
        row_gain=stk([s.row_gain for s in stores],
                     lambda: torch.ones((g_rows, k_pad), **f32)),
        chunk_gain=stk([s.chunk_gain for s in stores],
                       lambda: torch.ones((c, n), **f32)),
        gain_map=stk([s.gain_map for s in stores],
                     lambda: torch.ones((k_pad, n), **f32)),
        chunk_rows=p0.chunk_rows,
        col_blocks=p0.store.col_blocks,
    )
    return LayerPlan(
        store=store,
        a_scale=stk([lp.a_scale for lp in plans]),
        chunk_offset=stk([lp.chunk_offset for lp in plans],
                         lambda: torch.zeros((c, n), **f32)),
        colsum=stk([lp.colsum for lp in plans],
                   lambda: torch.zeros((n,), **f32)),
        bias=stk([lp.bias for lp in plans], lambda: torch.zeros((n,), **f32)),
        a_scale_in=stk([lp.a_scale_in for lp in plans]),
        k=p0.k,
        n=n,
        chunk_rows=p0.chunk_rows,
        signed_input=p0.signed_input,
        epilogue=EPILOGUE_NONE,
        shift=0,
    )


def _slice_params(node, i: int):
    """Slice ``i`` of a scan-stacked layer's params (every tensor leaf)."""
    if isinstance(node, dict):
        return {k: _slice_params(v, i) for k, v in node.items()}
    return node[i]


def lower_batch_concat(
    layer_params: Sequence[Params],
    cfg: AnalogConfig,
    *,
    signed_input: Optional[str] = None,
    calibs: Optional[Sequence] = None,
):
    """Lower G same-geometry, DIFFERENT-input layers into ONE dispatch
    group (the RWKV r/k/v/g fusion): on hardware the member matrices sit
    on disjoint column blocks of one array configuration and every
    member's input batch streams through in the same pass.

    Each member is lowered on its own (:func:`lower_layer`, ``calibs[i]``
    baking member ``i``) and the plans are stacked along a leading member
    axis: codes ``[G, K_pad, N]``, ``w_scale [G, 1, N]``, ``gain [G,
    N]``, ``col_gain [G, N]`` and ``row_gain [G, 1, K_pad]`` when rank-1,
    ``chunk_offset`` and a measured ``chunk_gain [G, C, N]``, ``a_scale``,
    ``a_scale_in`` and ``bias`` per member.
    :func:`repro_torch.exec.run.run_batch_concat` replays it as one
    member-axis dispatch, each member encoded at its own input scale, so
    the result equals the G solo dispatches bit for bit.

    Scan-stacked members (``[S, K, N]`` weights) lower into a
    :class:`PlanStack` of S member-axis plans, slice ``i`` of every
    member together, baked from slice ``i`` of per-stack-member records
    (:func:`stacked_calib`); a record without a stack axis bakes no
    stacked member, as in the reference."""
    cs = list(calibs) if calibs is not None else [None] * len(layer_params)
    if layer_params[0]["w"].ndim == 3:
        s = layer_params[0]["w"].shape[0]
        per = [stack_calibs(c, s) for c in cs]
        return PlanStack(
            lower_batch_concat([_slice_params(p, i) for p in layer_params],
                               cfg, signed_input=signed_input,
                               calibs=[m[i] for m in per])
            for i in range(s))
    return _stack_layer_plans([
        lower_layer(p, cfg, signed_input=signed_input, calib=c)
        for p, c in zip(layer_params, cs)])


def lower_expert_stack(w: torch.Tensor, cfg: AnalogConfig) -> LayerPlan:
    """Lower a raw stacked expert weight ``[E, K, N]`` (an MoE ``up`` /
    ``gate`` / ``down`` matrix) ONCE into a per-expert plan whose every
    leaf carries the leading expert axis: the 6-bit codes ``[E, K_pad,
    N]`` (int8, rows zero-padded to whole chunks: the split kernel's code
    operand; fp32 straight-through codes when ``w`` requires grad), the
    per-expert column scales ``w_scale [E, 1, N]`` from ``max|w|`` over K
    plus 1e-9 (no gradient: the reference's ``stop_gradient``), and the
    statistical gain ``[E]`` of each expert (the reference vmaps
    ``_statistical_gain`` over the experts; its gradient reaches ``w``).
    There is no fixed pattern (the reference
    omits expert fixed-pattern noise), so each expert's effective weights
    are its integer codes and the gain applies after the sum; activation
    scaling stays dynamic at run time (``a_scale`` ones).  Without
    autograd the stack is lowered ``models.moe.EXPERT_BLOCK`` experts at a
    time into a preallocated int8 ``[E, K_pad, N]`` (bit-identical to the
    whole stack at once: every number is per expert).  The same
    formulas as the per-call path
    (:func:`repro_torch.models.moe._analog_expert_matmul`), so
    :func:`repro_torch.exec.run.run_expert_stack` replays it bit-exactly.
    Counts one lowering."""
    from repro_torch.core.analog import _statistical_gain
    from repro_torch.models.moe import EXPERT_BLOCK

    global _LOWERINGS
    _LOWERINGS += 1
    if w.ndim != 3:
        raise ValueError(f"expert stacks are [E, K, N] weight arrays, got "
                         f"shape {tuple(w.shape)}")
    e, k, n = w.shape
    n_chunks = -(-k // cfg.chunk_rows)
    k_pad = n_chunks * cfg.chunk_rows

    def bake(wb):
        """(codes, w_scale [b, 1, N], gain [b]) of a block of experts;
        each expert's numbers come from its own slice alone."""
        wb = wb.to(torch.float32)
        scale = quant.weight_scale_from_max(
            wb.detach().abs().amax(dim=1, keepdim=True) + 1e-9)
        return (quant.quantize_weight(wb, scale), scale,
                torch.stack([_statistical_gain(wb[i], cfg.chunk_rows)
                             for i in range(wb.shape[0])]))

    if w.requires_grad and torch.is_grad_enabled():
        # under autograd the whole stack: the codes stay fp32
        # straight-through values (an int8 cast would cut the gradient to
        # the masters), and the card casts them to its int8 operand
        codes, w_scale, gain = bake(w)
        codes = F.pad(codes, (0, 0, 0, k_pad - k))
    else:
        # serving: EXPERT_BLOCK experts at a time, into the int8 operand,
        # so no fp32 copy of the whole stack exists
        codes = torch.zeros((e, k_pad, n), dtype=torch.int8, device=w.device)
        w_scale = torch.empty((e, 1, n), dtype=torch.float32,
                              device=w.device)
        gain = torch.empty((e,), dtype=torch.float32, device=w.device)
        for e0 in range(0, e, EXPERT_BLOCK):
            e1 = min(e0 + EXPERT_BLOCK, e)
            c, w_scale[e0:e1], gain[e0:e1] = bake(w[e0:e1])
            codes[e0:e1, :k] = c.to(torch.int8)
            del c
    store = WeightStore(  # verify: allow-packed-weights
        codes=codes,
        w_scale=w_scale,
        gain=gain,
        chunk_rows=cfg.chunk_rows,
    )
    return LayerPlan(
        store=store,
        a_scale=torch.ones((e,), dtype=torch.float32, device=w.device),
        chunk_offset=None,
        bias=None,
        k=k,
        n=n,
        chunk_rows=cfg.chunk_rows,
        signed_input="none",
        shift=default_shift(n_chunks),
    )


def _resolve_input_domain(
    layers: Sequence[LayerPlan], input_domain: Optional[str]
) -> str:
    """Bake the plan's input domain; when the caller does not state it,
    infer it from the first layer's own hand-off format."""
    if input_domain is not None:
        if input_domain not in (INPUT_CODES, INPUT_FLOAT):
            raise ValueError(f"unknown input_domain {input_domain!r}")
        return input_domain
    first_codes = (
        len(layers) > 0 and layers[0].epilogue == EPILOGUE_RELU_SHIFT
    )
    return INPUT_CODES if first_codes else INPUT_FLOAT


def lower_stack(
    layer_params: Sequence[Params],
    cfg: AnalogConfig,
    *,
    signed_inputs: Optional[Sequence[Optional[str]]] = None,
    epilogues: Optional[Sequence[str]] = None,
    flatten_outs: Optional[Sequence[bool]] = None,
    input_domain: Optional[str] = None,
    calibs: Optional[Sequence] = None,
) -> AnalogPlan:
    """Lower an ordered stack of layers into one :class:`AnalogPlan`.

    ``epilogues[i]`` is the ADC epilogue BETWEEN layer i and i+1; the last
    layer's epilogue is forced to "none" (final outputs dequantize to
    float).  ``calibs[i]`` (optional) is layer i's measured
    :class:`~repro_torch.calib.snapshot.LayerCalibration`
    (:func:`lower_layer`).  Eligible chains also get the megakernel
    packing baked (:func:`pack_megakernel`), from the calibrated stores.
    """
    n = len(layer_params)
    signed_inputs = signed_inputs or [None] * n
    epilogues = list(epilogues or [EPILOGUE_NONE] * n)
    flatten_outs = flatten_outs or [False] * n
    calibs = calibs or [None] * n
    if n:
        epilogues[-1] = EPILOGUE_NONE
    layers = tuple(
        lower_layer(p, cfg, signed_input=s, epilogue=e, flatten_out=f,
                    calib=c)
        for p, s, e, f, c in zip(layer_params, signed_inputs, epilogues,
                                 flatten_outs, calibs)
    )
    plan = AnalogPlan(layers=layers, cfg=cfg,
                      input_domain=_resolve_input_domain(layers, input_domain))
    mega = pack_megakernel(plan)
    if mega is not None:
        plan = AnalogPlan(layers=layers, cfg=cfg, mega=mega,
                          input_domain=plan.input_domain)
    return plan


def megakernel_ineligible_reason(plan: AnalogPlan) -> Optional[str]:
    """Structural megakernel eligibility of a lowered plan (None when
    eligible, else a reason naming the first offending layer); the walk
    lives in :func:`repro_torch.verify.domains.chain_ineligible_reason`."""
    from repro_torch.verify.domains import chain_ineligible_reason

    return chain_ineligible_reason(plan)


def lower_block(
    block_params: Params,
    cfg: AnalogConfig,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    seq: int,
    rope_theta: float,
    eps: float = 1e-5,
    calibs: Optional[dict] = None,
) -> AnalogPlan:
    """Lower ONE attention+MLP transformer block into a 4-layer
    :class:`AnalogPlan` that replays as a single whole-block dispatch.

    ``block_params`` is the standard block node ``{"ln1", "attn": {wq, wk,
    wv, wo}, "ln2", "mlp": {up, down, gate}}``.  The three QKV projections
    fuse into one ``column_concat`` layer (:func:`lower_fused`, which holds
    the group to one static LSB), up/gate likewise; the digital glue
    between the four analog dispatches - RoPE + causal attention, residual
    adds, RMSNorms, SwiGLU - is carried as hand-off tags in the schedule
    plus a :class:`BlockGlue` record, and runs inside the kernel.  ``seq``
    is baked: the in-kernel attention needs the static prefill length
    (positions ``0..seq-1``).

    ``calibs`` optionally maps the block's seven physical members
    (``"wq"``, ``"wk"``, ``"wv"``, ``"wo"``, ``"up"``, ``"gate"``,
    ``"down"``) to measured
    :class:`~repro_torch.calib.snapshot.LayerCalibration` records: each
    member bakes its own device's tables before the fusion concatenates
    them (a member without a record keeps the oracle bake).

    Raises ``ValueError`` when the block cannot pack: every layer consumes
    float activations, so it needs a static input LSB (``act_calib ==
    "static"``) and a none/split signed encoding, and the MLP a gate.
    """
    if cfg.act_calib != "static":
        raise ValueError(
            "lower_block: every layer of a fused block consumes float "
            f"activations, and act_calib={cfg.act_calib!r} cannot bake "
            "the in-kernel encoding LSB; lower with act_calib='static' "
            "(or replay the block per-layer via the model path)"
        )
    if cfg.signed_input not in ("none", "split"):
        raise ValueError(
            f"lower_block: signed_input {cfg.signed_input!r} is not "
            "packable in-kernel (the offset encoding's column-sum "
            "correction stays per-layer); use 'none' or 'split'"
        )
    attn, mlp = block_params["attn"], block_params["mlp"]
    if mlp.get("gate") is None:
        raise ValueError(
            "lower_block: the block MLP has no gate projection; the "
            "fused swiglu hand-off needs act='swiglu'"
        )
    cal = calibs or {}
    qkv = lower_fused([attn["wq"], attn["wk"], attn["wv"]], cfg,
                      calibs=[cal.get("wq"), cal.get("wk"), cal.get("wv")])
    o = lower_layer(attn["wo"], cfg, calib=cal.get("wo"))
    upgate = lower_fused([mlp["up"], mlp["gate"]], cfg,
                         calibs=[cal.get("up"), cal.get("gate")])
    down = lower_layer(mlp["down"], cfg, calib=cal.get("down"))

    d_model = qkv.k
    d_ff = mlp["up"]["w"].shape[1]
    nq = n_heads * head_dim
    nkv = n_kv_heads * head_dim
    if qkv.n != nq + 2 * nkv:
        raise ValueError(
            f"lower_block: fused QKV width {qkv.n} != "
            f"n_heads*head_dim + 2*n_kv_heads*head_dim = {nq + 2 * nkv}"
        )
    if o.k != nq or o.n != d_model:
        raise ValueError(
            f"lower_block: wo maps {o.k}->{o.n}, expected {nq}->{d_model}"
        )
    if upgate.n != 2 * d_ff or down.k != d_ff or down.n != d_model:
        raise ValueError(
            "lower_block: MLP widths do not chain: "
            f"up|gate {upgate.k}->{upgate.n}, down {down.k}->{down.n}, "
            f"expected {d_model}->{2 * d_ff} and {d_ff}->{d_model}"
        )
    glue = BlockGlue(
        ln1=block_params["ln1"]["scale"].to(torch.float32),
        ln2=block_params["ln2"]["scale"].to(torch.float32),
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
        seq=seq, rope_theta=rope_theta, d_ff=d_ff, eps=eps,
    )
    plan = AnalogPlan(layers=(qkv, o, upgate, down), cfg=cfg,
                      input_domain=INPUT_FLOAT, block=glue)
    return dataclasses.replace(plan, mega=pack_megakernel(plan))


def _packed_offsets(layers, n_max: int) -> torch.Tensor:
    """The chunk-offset tables of a pack: each layer's [C, N] table (zeros
    where it has none) column-padded to ``n_max``, chunk-concatenated."""
    dev = layers[0].store.codes.device
    return torch.cat([
        F.pad(lp.chunk_offset if lp.chunk_offset is not None
              else torch.zeros((lp.n_chunks, lp.n), dtype=torch.float32,
                               device=dev), (0, n_max - lp.n))
        for lp in layers], dim=0)


def pack_megakernel(plan: AnalogPlan) -> Optional[MegakernelPack]:
    """Pack an eligible :class:`AnalogPlan` into the stacked operands and
    static schedule of the whole-plan kernels, or None when the plan is
    structurally ineligible.

    Per-layer gain and chunk-offset tables are column-padded to one common
    lane width and concatenated; column padding is inert (zero weights x
    zero gain x zero offset accumulate to zero ADC codes), and each
    layer's zero output columns double as the next layer's chunk padding.
    Chains with float-domain hand-offs also get the in-kernel glue rows:
    per-column dequantization (``a_scale * w_scale / gain``, product
    first), biases, and the static input LSB of every layer.  Block plans
    (:func:`lower_block`) carry the attention+MLP hand-off tags and the
    RMSNorm scale rows.
    """
    from repro_torch.kernels.analog_plan import BLOCK_HANDOFFS, MegaLayerMeta
    from repro_torch.verify import domains as dom

    if plan.block is None and megakernel_ineligible_reason(plan) is not None:
        return None
    layers = plan.layers
    last = len(layers) - 1
    if plan.block is not None:
        handoffs = BLOCK_HANDOFFS
        domains = [dom.DOMAIN_FLOAT] * len(layers)
        factors = [1] * len(layers)
        # every layer of a block sees seq rows per batch element
        m_mults = [plan.block.seq] * len(layers)
    else:
        domains = dom.consumed_domains(plan)
        handoffs = tuple(dom.handoff_tag(lp.epilogue, i == last)
                         for i, lp in enumerate(layers))
        # flatten factor INTO the next layer (the im2col position merge)
        # and the resulting rows-per-batch-row multiplier at each input
        factors = [
            layers[i + 1].k // lp.n if i < last and lp.flatten_out else 1
            for i, lp in enumerate(layers)
        ]
        m_mults = [1] * len(layers)
        for i in range(last - 1, -1, -1):
            m_mults[i] = m_mults[i + 1] * factors[i]
    encodes = [
        dom.encode_tag(d, lp.signed_input) for d, lp in zip(domains, layers)
    ]

    lane = 128
    n_max = max(
        max(lp.n for lp in layers),
        max(lp.k_pad for lp in layers[1:]),
    )
    n_max = -(-n_max // lane) * lane
    needs_extras = any(e != "codes" for e in encodes) or any(
        h not in ("codes", "raw") for h in handoffs
    )
    dev = layers[0].store.codes.device
    schedule, gain_rows = [], []
    deq_rows, bias_rows, enc_rows = [], [], []
    row0 = c0 = 0
    for i, lp in enumerate(layers):
        gain_b = torch.broadcast_to(
            torch.as_tensor(lp.gain, dtype=torch.float32), (lp.n,))
        gain_rows.append(F.pad(gain_b, (0, n_max - lp.n)))
        if needs_extras:
            # the static input LSB this layer encodes (and therefore
            # dequantizes) with: the group's shared a_scale_in when
            # calibrated together, else its own; 1.0 for raw code inputs
            if encodes[i] == "codes":
                in_scale = torch.tensor(1.0, dtype=torch.float32, device=dev)
            else:
                in_scale = lp.in_scale.reshape(())
            enc_rows.append(in_scale[None])
            # per-column dequant row: EXACTLY run_layer's expression
            # (product first, then the gain divide) for bit-exactness
            deq = (in_scale * lp.w_scale.reshape(-1)) / gain_b
            deq_rows.append(F.pad(deq, (0, n_max - lp.n)))
            bias = (lp.bias.to(torch.float32) if lp.bias is not None
                    else torch.zeros((lp.n,), dtype=torch.float32,
                                     device=dev))
            bias_rows.append(F.pad(bias, (0, n_max - lp.n)))
        schedule.append(MegaLayerMeta(
            row0=row0, c0=c0, k=lp.k, k_pad=lp.k_pad, n=lp.n,
            n_chunks=lp.n_chunks, shift=lp.shift,
            relu_shift=lp.epilogue == EPILOGUE_RELU_SHIFT,
            flatten=factors[i], m_mult=m_mults[i],
            encode=encodes[i], handoff=handoffs[i],
        ))
        row0 += lp.k_pad
        c0 += lp.n_chunks
    extras = {}
    if needs_extras:
        extras = dict(
            deq=torch.stack(deq_rows, dim=0),
            bias=torch.stack(bias_rows, dim=0),
            enc=torch.stack(enc_rows, dim=0),
        )
    if plan.block is not None:
        bg = plan.block
        ln = torch.zeros((2, n_max), dtype=torch.float32, device=dev)
        ln[0, :layers[0].k] = bg.ln1
        ln[1, :layers[1].n] = bg.ln2
        extras.update(ln=ln, block=bg.meta)
    return MegakernelPack(
        stores=tuple(lp.store for lp in layers),
        gain=torch.stack(gain_rows, dim=0),
        off=_packed_offsets(layers, n_max),
        schedule=tuple(schedule),
        n_max=n_max,
        chunk_rows=layers[0].chunk_rows,
        **extras,
    )


def layer_with_tables(lp: LayerPlan, *, chunk_offset=None,
                      chunk_gain=None) -> LayerPlan:
    """Swap ONE lowered layer's measured tables (the drift hot-swap);
    ``None`` keeps a table.  An offset swap replaces the ``chunk_offset``
    tensor only (the store, and its derived ``w_eff``, are shared); a gain
    swap that changes the store's ``chunk_gain`` rebuilds the store's
    derived weights from its codes.  Neither lowers anything.  Raises when
    the plan was lowered without the table (re-lower instead) or the
    shapes differ."""
    if chunk_offset is not None:
        if lp.chunk_offset is None:
            raise ValueError(
                "cannot hot-swap offsets into a plan lowered without an "
                "offset table; re-lower the layer")
        chunk_offset = _table(chunk_offset, lp.chunk_offset.device)
        if chunk_offset.shape != lp.chunk_offset.shape:
            raise ValueError(
                f"offset table shape {tuple(chunk_offset.shape)} != baked "
                f"{tuple(lp.chunk_offset.shape)}")
        lp = dataclasses.replace(lp, chunk_offset=chunk_offset)
    if chunk_gain is not None:
        cg = lp.store.chunk_gain
        if cg is None:
            raise ValueError(
                "cannot hot-swap a gain table into a plan lowered without "
                "one; re-lower the layer")
        if lp.colsum is not None:
            raise ValueError(
                "cannot hot-swap gains under an offset-encoding column "
                "sum (colsum folds the baked gains); re-lower the layer")
        chunk_gain = _table(chunk_gain, cg.device)
        if chunk_gain.shape != cg.shape:
            raise ValueError(f"gain table shape {tuple(chunk_gain.shape)} "
                             f"!= baked {tuple(cg.shape)}")
        if not torch.equal(chunk_gain, cg):
            lp = dataclasses.replace(lp, store=dataclasses.replace(
                lp.store, chunk_gain=chunk_gain))
    return lp


def plan_with_tables(plan: AnalogPlan, offsets: Sequence, gains=None
                     ) -> AnalogPlan:
    """Swap per-layer offset and gain tables of a lowered stack
    (:func:`layer_with_tables` per layer; ``None`` entries keep a table).
    When only offsets changed, the megakernel pack keeps its stores and
    ``w_cat`` and takes the new offset table; a changed gain table
    re-packs from the swapped stores.  Nothing is lowered."""
    n = len(plan.layers)
    gains = list(gains) if gains is not None else [None] * n
    if len(offsets) != n or len(gains) != n:
        raise ValueError(f"{len(offsets)} offset / {len(gains)} gain "
                         f"tables for {n} layers")
    layers = tuple(layer_with_tables(lp, chunk_offset=off, chunk_gain=g)
                   for lp, off, g in zip(plan.layers, offsets, gains))
    out = dataclasses.replace(plan, layers=layers)
    if plan.mega is None:
        return out
    if all(a.store is b.store for a, b in zip(layers, plan.layers)):
        return dataclasses.replace(out, mega=plan.mega.with_off(
            _packed_offsets(layers, plan.mega.n_max)))
    return dataclasses.replace(out, mega=pack_megakernel(out))


def layer_with_offsets(lp: LayerPlan, chunk_offset) -> LayerPlan:
    """Swap ONE lowered layer's ADC offset table (the drift refresh; the
    reference's signature over :func:`layer_with_tables`): only the
    ``chunk_offset`` tensor changes, so the plan keeps its structure and
    static metadata.  Raises when the plan was lowered without an offset
    table (re-lower instead) or the shapes differ."""
    return layer_with_tables(lp, chunk_offset=chunk_offset)


def plan_with_offsets(plan: AnalogPlan, offsets: Sequence) -> AnalogPlan:
    """Swap the per-layer ADC offset tables of a lowered stack (the
    reference's signature over :func:`plan_with_tables`; ``offsets[i] =
    None`` keeps layer i's table).  The megakernel pack keeps its stores
    and schedule and takes the new offset table."""
    if len(offsets) != len(plan.layers):
        raise ValueError(
            f"{len(offsets)} offset tables for {len(plan.layers)} layers")
    return plan_with_tables(plan, offsets)
