"""Whole-plan CUDA kernels: one launch per packed AnalogPlan chain, and one
launch per transformer block.

The paper's headline figure - 276 us / 192 uJ per ECG sample (§IV) -
comes from the conv->fc1->fc2 CDNN running as ONE uninterrupted analog
program on the ASIC: inter-layer activations never leave the chip
(§II-A).  Both kernels here replace the TPU kernel
``repro/kernels/analog_plan.py::analog_plan_pallas``, whose static
schedule (:class:`MegaLayerMeta`, plus :class:`BlockMeta` for a block)
they run:

- ``csrc/analog_plan.cu`` (:func:`analog_plan_cuda`): a layer chain, the
  grid over batch elements, each block owning ``per_block`` records end
  to end with the inter-layer activations in shared memory.  Encodes
  ``"codes"`` (5-bit codes as they are), ``"unsigned"`` and ``"split"``
  (float features quantized at the layer's baked LSB, the split as two
  passes against the same weights); hand-offs ``"codes"`` (ReLU +
  right-shift requantization at the ADC), ``"relu"`` (in-kernel dequant
  + bias + ReLU, re-encoded by the next layer), both with the ``flatten``
  im2col merge, and the final ``"raw"`` (accumulated ADC codes out).
  Each layer's input block is encoded once into shared memory, and every
  layer's real weight columns (134 KB for the ECG chain, of its 512 KiB
  lane-padded ``w_cat``) are staged there with ``cp.async`` at the start,
  a later layer's landing while the earlier ones compute.
- ``csrc/analog_plan_block.cu`` (:func:`analog_plan_block_cuda`): one
  attention+MLP block (hand-offs ``attn``, ``res_ln``, ``swiglu``,
  ``res_out``) as ONE cooperative launch.  At phi4-mini width one row of
  the widest hand-off is 64 KiB and the block's weights 403 MB, so the
  batch-parallel design cannot carry over: every stage is spread over the
  whole grid, the stages are separated by grid-wide barriers, and the
  activations between them live in a global scratch (one region per
  stage, L2-resident).  The VMM stages run the split kernel's CTA work
  item (``csrc/analog_split_tile.cuh``) on each layer's
  :class:`~repro_torch.exec.plan.WeightStore` in place - its int8 codes
  and gain tables, or ``w_eff`` for a store with a full gain map
  (:func:`block_operand`) - with the chunks of each column tile cut over
  the grid (:func:`block_plans`).

The plain version of both is :func:`repro_torch.kernels.ref.analog_plan_ref`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.hw import BSS2
from repro_torch.kernels import _build
from repro_torch.kernels.analog_mvm import (SplitPlan, code_operand_ends,
                                             int8_codes,
                                            split_plan, split_tile_rows)

MAX_LAYERS = 8
MAX_PER_BLOCK = 4
_SMEM_LIMIT = 227 * 1024
ENCODES = {"codes": 0, "unsigned": 1, "split": 2}
CHAIN_HANDOFFS = {"codes": 0, "relu": 1, "raw": 2}
BLOCK_HANDOFFS = ("attn", "res_ln", "swiglu", "res_out")
# the stage regions of the block kernel's scratch, in execution order:
# (name, layer whose width sets the row length, "k" input or "n" output)
BLOCK_STAGES = (
    ("n1", 0, "k"),          # RMSNorm(ln1) of the residual stream
    ("n1_pos", 0, "k_pad"),  # its 5-bit codes, and those of -n1: the
    ("n1_neg", 0, "k_pad"),  # QKV VMM's code operands (chunk-padded)
    ("acc_qkv", 0, "n"),     # fused QKV: accumulated ADC codes
    ("attn", 1, "k"),        # dequant + RoPE + causal attention
    ("attn_pos", 1, "k_pad"),
    ("attn_neg", 1, "k_pad"),
    ("acc_o", 1, "n"),       # o: accumulated ADC codes
    ("res2", 1, "n"),        # residual + dequantized o
    ("n2", 2, "k"),          # RMSNorm(ln2) of res2
    ("n2_pos", 2, "k_pad"),
    ("n2_neg", 2, "k_pad"),
    ("acc_ug", 2, "n"),      # fused up|gate: accumulated ADC codes
    ("sw", 3, "k"),          # dequant + SwiGLU
    ("sw_pos", 3, "k_pad"),
    ("sw_neg", 3, "k_pad"),
    ("acc_dn", 3, "n"),      # down: accumulated ADC codes
)
# per-layer ints of the block kernel's schedule (csrc/analog_plan_block.cu)
_BLOCK_FIELDS = 15
_build.declare("analog_plan", (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
))
_P, _I = ctypes.c_void_p, ctypes.c_int
_build.declare("analog_plan_block", (
    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
    ctypes.c_float, ctypes.c_float, _P,
))


class MegaLayerMeta(NamedTuple):
    """Static schedule entry for one layer of a packed megakernel chain
    (the same fields, in the same order, as the reference's)."""

    row0: int        # first row of this layer's weights in w_cat
    c0: int          # first row of this layer's offsets in off_cat
    k: int           # logical input width (pre chunk padding)
    k_pad: int       # padded input width (w_eff rows)
    n: int           # output width
    n_chunks: int    # k_pad // chunk_rows
    shift: int       # relu_shift right-shift amount (inter-layer layers)
    relu_shift: bool  # True: hand 5-bit codes to the next layer in-kernel
    flatten: int     # cols-merge factor into the next layer (1 = none)
    m_mult: int      # input rows per final batch row at this layer
    # input encoding of THIS layer: "codes" | "unsigned" | "split"
    encode: str = "codes"
    # hand-off to the NEXT layer: "codes" | "relu" | "attn" | "res_ln" |
    # "swiglu" (inter-layer), "raw" | "res_out" (final)
    handoff: str = ""


class BlockMeta(NamedTuple):
    """Static transformer-block glue geometry (attention+MLP megakernel):
    the companion of the 4-layer schedule ``[qkv, o, up_gate, down]`` with
    hand-offs ``[attn, res_ln, swiglu, res_out]``."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    seq: int
    rope_theta: float
    d_ff: int
    eps: float = 1e-5


def layer_handoff(meta: MegaLayerMeta, last: bool) -> str:
    """A schedule entry's hand-off tag (entries built before the domain
    tags carry ``handoff == ""``)."""
    if meta.handoff:
        return meta.handoff
    if last:
        return "raw"
    return "codes" if meta.relu_shift else "relu"


def needs_extras(schedule: Sequence[MegaLayerMeta]) -> bool:
    """Does the schedule need the packed deq/bias/enc rows (a float
    encode or a float-domain hand-off anywhere)?"""
    last = len(schedule) - 1
    return any(m.encode != "codes" for m in schedule) or any(
        layer_handoff(m, i == last) not in ("codes", "raw")
        for i, m in enumerate(schedule))


def default_per_block(batch: int, device: torch.device) -> int:
    """Records per block: as few as keep every block in one wave of one
    block per SM, at most :data:`MAX_PER_BLOCK` (the kernel takes fewer
    when its shared memory asks for it)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(MAX_PER_BLOCK, -(-batch // sms)))


def _check_extras(extras, dev, n_layers, n_max, *, block: bool):
    if extras is None:
        raise ValueError(
            "float-domain schedule entries need the packed deq/bias/enc "
            "operands (extras; repro_torch.exec.lower.pack_megakernel "
            "builds them)")
    deq, bias, enc, ln = extras
    for name, t, shape in (("deq", deq, (n_layers, n_max)),
                           ("bias", bias, (n_layers, n_max)),
                           ("enc", enc, (n_layers, 1))):
        _build.check_operand(name, t, dev, shape)
    if block:
        if ln is None:
            raise ValueError("a block schedule needs the packed ln rows")
        _build.check_operand("ln", ln, dev, (2, n_max))
    return deq, bias, enc, ln


def analog_plan_cuda(
    x_in: torch.Tensor,          # [B * m_mult0, k0_pad] codes, or k0 floats
    w_cat: torch.Tensor,         # [sum(k_pad), n_max]
    gain_all: torch.Tensor,      # [L, n_max]
    off_cat: torch.Tensor,       # [sum(n_chunks), n_max]
    *,
    schedule: Tuple[MegaLayerMeta, ...],
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
    extras=None,                 # (deq [L,n_max], bias [L,n_max], enc [L,1], ln)
) -> torch.Tensor:
    """Run a packed layer chain in one launch; returns the last layer's
    raw accumulated ADC codes ``[B * m_mult_last, n_last]``.  ``x_in``
    holds 5-bit codes padded to ``k_pad`` when layer 0 encodes
    ``"codes"``, else ``k`` float features."""
    dev = x_in.device
    if dev.type != "cuda":
        raise ValueError(f"analog_plan_cuda needs CUDA tensors, got {dev}")
    n_layers = len(schedule)
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"schedule needs 1..{MAX_LAYERS} layers, got "
                         f"{n_layers}")
    hand = []
    for i, meta in enumerate(schedule):
        h = layer_handoff(meta, i == n_layers - 1)
        allowed = ("raw",) if i == n_layers - 1 else ("codes", "relu")
        if meta.encode not in ENCODES or h not in allowed:
            raise ValueError(
                f"layer {i} encodes {meta.encode!r} and hands off {h!r}: "
                "the chain kernel runs encodes codes/unsigned/split and "
                "hand-offs codes/relu/raw (a transformer block runs "
                "through analog_plan_block_cuda)")
        hand.append(CHAIN_HANDOFFS[h])
    for i, (meta, nxt) in enumerate(zip(schedule, schedule[1:])):
        if (meta.flatten * meta.n > nxt.k_pad
                or meta.m_mult != nxt.m_mult * meta.flatten):
            raise ValueError(f"layer {i} does not feed layer {i + 1}: "
                             f"{meta} -> {nxt}")
    m0, first, lastm = schedule[0].m_mult, schedule[0], schedule[-1]
    rows, cols = x_in.shape
    want = first.k_pad if first.encode == "codes" else first.k
    if rows % m0 or cols != want:
        raise ValueError(f"x_in {tuple(x_in.shape)} does not match layer 0 "
                         f"(m_mult {m0}, {want} columns for encode "
                         f"{first.encode!r})")
    if chunk_rows <= 0 or any(m.k_pad % chunk_rows for m in schedule):
        raise ValueError(f"chunk_rows={chunk_rows} does not divide k_pad")
    batch = rows // m0
    n_max = w_cat.shape[1]
    for name, t, shape in (
            ("x_in", x_in, (rows, cols)),
            ("w_cat", w_cat, (sum(m.k_pad for m in schedule), n_max)),
            ("gain_all", gain_all, (n_layers, n_max)),
            ("off_cat", off_cat, (sum(m.n_chunks for m in schedule), n_max))):
        _build.check_operand(name, t, dev, shape)
    deq = bias = enc = None
    if needs_extras(schedule):
        deq, bias, enc, _ = _check_extras(extras, dev, n_layers, n_max,
                                          block=False)
    if n_max % 4 or chunk_rows % 4 or any(
            t is not None and t.data_ptr() % 16
            for t in (w_cat, gain_all, off_cat, deq, bias)):
        raise ValueError("the chain kernel reads 16-byte rows: n_max and "
                         "chunk_rows must be multiples of 4, and w_cat, "
                         "gain_all, off_cat, deq and bias 16-byte aligned")
    pb = default_per_block(batch, dev)
    sched = _chain_schedule(schedule, hand)
    out = torch.empty((batch * lastm.m_mult, lastm.n), dtype=torch.float32,
                      device=dev)

    _build.launch(
        "analog_plan", dev, x_in.data_ptr(), w_cat.data_ptr(),
        gain_all.data_ptr(), off_cat.data_ptr(), _build.ptr(deq),
        _build.ptr(bias), _build.ptr(enc), out.data_ptr(), batch, cols,
        n_max, ctypes.cast(sched, ctypes.c_void_p), n_layers, chunk_rows,
        int(faithful), pb,
    )
    return out


def _chain_schedule(schedule, hand):
    """The chain kernel's schedule: 11 C ints per layer."""
    return (ctypes.c_int * (11 * len(schedule)))(*[
        v for m, h in zip(schedule, hand)
        for v in (m.row0, m.c0, m.k, m.k_pad, m.n, m.n_chunks, m.shift,
                  m.flatten, m.m_mult, ENCODES[m.encode], h)])


def chain_layout(schedule, batch: int, x_cols: int, n_max: int,
                 device: torch.device, *,
                 chunk_rows: int = BSS2.signed_rows
                 ) -> Tuple[int, Tuple[bool, ...]]:
    """The shared-memory layout :func:`analog_plan_cuda` launches with for
    ``batch`` records: (records per block, whether each layer's weights
    are staged in shared memory or read in place), from the kernel
    library's own choice."""
    last = len(schedule) - 1
    hand = [CHAIN_HANDOFFS[layer_handoff(m, i == last)]
            for i, m in enumerate(schedule)]
    query = _build.function("analog_plan", "analog_plan_layout",
                            (ctypes.c_void_p,) + (ctypes.c_int,) * 6
                            + (ctypes.c_void_p,))
    out = (ctypes.c_int * (1 + len(schedule)))()
    rc = query(ctypes.cast(_chain_schedule(schedule, hand), ctypes.c_void_p),
               len(schedule), chunk_rows, x_cols, n_max,
               int(needs_extras(schedule)),
               default_per_block(batch, device), ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"the chain kernel takes no layout for {schedule} "
                         f"(CUDA error {rc})")
    return out[0], tuple(bool(v) for v in out[1:])


@functools.lru_cache(maxsize=16)
def rope_table(seq: int, head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    """``[2, seq, head_dim // 2]``: cos and sin of RoPE's angles at the
    positions ``0..seq-1``, with the arithmetic of
    :func:`repro_torch.models.layers.apply_rope` on ``device`` (the block
    kernel takes them as an operand, so its rotation rounds like the
    model path's)."""
    from repro_torch.models.layers import rope_freqs

    pos = torch.arange(seq, dtype=torch.int32, device=device)
    angle = pos[:, None].to(torch.float32) * rope_freqs(head_dim, theta,
                                                        device)
    return torch.stack([torch.cos(angle), torch.sin(angle)]).contiguous()


def _check_block(schedule, block: BlockMeta, x_in: torch.Tensor,
                 chunk_rows: int):
    if len(schedule) != 4 or tuple(
            layer_handoff(m, i == 3) for i, m in enumerate(schedule)
    ) != BLOCK_HANDOFFS:
        raise ValueError(f"a block schedule is 4 layers handing off "
                         f"{BLOCK_HANDOFFS}, got {schedule}")
    if any(m.encode not in ("unsigned", "split") for m in schedule):
        raise ValueError("every layer of a block encodes float features "
                         "('unsigned' or 'split')")
    d = schedule[0].k
    nq = block.n_heads * block.head_dim
    nkv = block.n_kv_heads * block.head_dim
    widths = [(m.k, m.n) for m in schedule]
    if widths != [(d, nq + 2 * nkv), (nq, d), (d, 2 * block.d_ff),
                  (block.d_ff, d)]:
        raise ValueError(f"block widths {widths} do not chain (d_model {d}, "
                         f"heads {block.n_heads}/{block.n_kv_heads} of "
                         f"{block.head_dim}, d_ff {block.d_ff})")
    if block.n_heads % block.n_kv_heads or block.head_dim % 2:
        raise ValueError(f"bad attention geometry {block}")
    if chunk_rows <= 0 or chunk_rows % 32 or any(
            m.k_pad % chunk_rows or m.k_pad != m.n_chunks * chunk_rows
            for m in schedule):
        raise ValueError(f"chunk_rows={chunk_rows} must be a multiple of 32 "
                         "dividing every k_pad")
    rows, cols = x_in.shape
    if cols != d or rows % block.seq:
        raise ValueError(f"x_in {tuple(x_in.shape)} is not [batch * "
                         f"{block.seq}, {d}]")
    attn_floats = 3 * block.seq * block.head_dim + block.seq * block.seq
    if 4 * attn_floats > _SMEM_LIMIT:
        raise ValueError(f"seq {block.seq} x head_dim {block.head_dim} needs "
                         f"{4 * attn_floats} bytes of shared memory for the "
                         f"attention stage, over the {_SMEM_LIMIT} a block "
                         "has")


class BlockOperand(NamedTuple):
    """One block layer's weight operand for the split tile: ``form`` 0 is
    a store's int8 ``codes`` with its rank-1 gain tables (``block_ends``
    the cumulative ends of the column blocks that pick a row-gain vector),
    form 2 the same with ``chunk_gain``, a calibrated bake's per-(chunk,
    column) table, form 1 an fp32 ``w_eff``."""

    form: int
    w: torch.Tensor
    col_gain: Optional[torch.Tensor]
    row_gain: Optional[torch.Tensor]
    chunk_gain: Optional[torch.Tensor]
    block_ends: Tuple[int, ...]


def block_operand(weight, k_pad: int, n: int,
                  dev: torch.device) -> BlockOperand:
    """The operand a block layer's VMM stage reads, by the rule of
    ``exec/run.py``'s split branch: a
    :class:`~repro_torch.exec.plan.WeightStore` without a full gain map
    (``code_operand``) gives its int8 codes (:func:`int8_codes`) and gain
    tables (rank-1 and a
    measured ``chunk_gain``), a store with a gain map its ``w_eff``; a
    tensor is taken as the fp32 effective weights."""
    if getattr(weight, "codes", None) is not None:
        if weight.code_operand:
            codes = int8_codes(weight)
            ends = code_operand_ends(codes, weight.col_gain,
                                     weight.row_gain, weight.col_blocks,
                                     k_pad, dev, chunk_gain=weight.chunk_gain,
                                     chunk_rows=weight.chunk_rows)
            if codes.shape[1] != n:
                raise ValueError(f"store of {codes.shape[1]} columns "
                                 f"for a layer of {n}")
            return BlockOperand(0 if weight.chunk_gain is None else 2,
                                codes, weight.col_gain,
                                weight.row_gain, weight.chunk_gain, ends)
        weight = weight.w_eff
    _build.check_operand("weights", weight, dev, (k_pad, n))
    return BlockOperand(1, weight, None, None, None, (n,))


@functools.lru_cache(maxsize=None)
def _block_grid(index: int, mt: int, faithful: bool, forms: int, seq: int,
                head_dim: int) -> int:
    """The cooperative grid of one block-kernel geometry (SMs x resident
    CTAs), from the kernel's own occupancy query."""
    query = _build.function("analog_plan_block", "analog_plan_block_grid",
                            (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
    grid = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = query(mt, int(faithful), forms, seq, head_dim,
                   ctypes.addressof(grid))
    if rc != 0 or grid.value < 1:
        raise RuntimeError(f"analog_plan_block grid query failed: CUDA error "
                           f"{rc}, grid {grid.value}")
    return grid.value


def block_plans(rows: int, schedule, faithful: bool,
                grid: int) -> Tuple[SplitPlan, ...]:
    """How each VMM stage of a block cuts its work over a cooperative grid
    of ``grid`` CTAs: :func:`split_plan`'s rule with the grid as the
    resident slots (faithful mode cuts each column tile's chunks into
    ranges, fast mode walks them all in one item)."""
    return tuple(split_plan(rows, m.n, m.n_chunks, faithful, grid)
                 for m in schedule)


def analog_plan_block_cuda(
    x_in: torch.Tensor,                  # [B * seq, d_model] residual stream
    weights: Sequence,                   # 4 WeightStores or [k_pad, n] w_eff
    gain_all: torch.Tensor,              # [4, n_max]
    off_cat: torch.Tensor,               # [sum(n_chunks), n_max]
    *,
    schedule: Tuple[MegaLayerMeta, ...],
    block: BlockMeta,
    extras,                              # (deq, bias, enc, ln)
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
):
    """One transformer block in ONE cooperative launch.  Each layer's
    weights are its :class:`~repro_torch.exec.plan.WeightStore` (the int8
    codes and gain tables, or ``w_eff`` for a store with a full gain map:
    :func:`block_operand`) or an fp32 ``w_eff`` tensor.  Returns the block
    output ``[B * seq, d_model]``, the stage regions of the scratch (a
    dict of ``[rows, width]`` views, :data:`BLOCK_STAGES`, for checking
    each stage on its own) and the grid size the launch used."""
    dev = x_in.device
    if dev.type != "cuda":
        raise ValueError(f"analog_plan_block_cuda needs CUDA tensors, got "
                         f"{dev}")
    _check_block(schedule, block, x_in, chunk_rows)
    n_max = gain_all.shape[1]
    rows = x_in.shape[0]
    _build.check_operand("x_in", x_in, dev, tuple(x_in.shape))
    if len(weights) != 4:
        raise ValueError(f"a block takes 4 weight operands, got "
                         f"{len(weights)}")
    operands = [block_operand(w, m.k_pad, m.n, dev)
                for w, m in zip(weights, schedule)]
    _build.check_operand("gain_all", gain_all, dev, (4, n_max))
    _build.check_operand("off_cat", off_cat, dev,
                         (sum(m.n_chunks for m in schedule), n_max))
    deq, bias, enc, ln = _check_extras(extras, dev, 4, n_max, block=True)
    if max(m.n for m in schedule) > n_max:
        raise ValueError(f"n_max {n_max} is narrower than a layer")
    rope = rope_table(block.seq, block.head_dim, float(block.rope_theta), dev)
    mt = split_tile_rows(rows)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    forms = sum(1 << f for f in {op.form for op in operands})
    grid = _block_grid(index, mt, bool(faithful), forms, block.seq,
                       block.head_dim)
    plans = block_plans(rows, schedule, faithful, grid)
    # the stage regions back to back, each starting on a 16-byte boundary
    # (the VMM stages stage the code regions with 16-byte cp.async)
    widths = [getattr(schedule[li], kind) for _, li, kind in BLOCK_STAGES]
    sizes = [-(-rows * w // 4) * 4 for w in widths]
    scratch = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    stages = {name: t[:rows * w].view(rows, w) for (name, _, _), t, w in zip(
        BLOCK_STAGES, torch.split(scratch, sizes), widths)}
    work = torch.empty((max(p.n_splits * rows * m.n
                            for p, m in zip(plans, schedule)),),
                       dtype=torch.float32, device=dev)
    out = torch.empty((rows, schedule[0].k), dtype=torch.float32, device=dev)
    wptrs = (ctypes.c_void_p * 16)(*[
        _build.ptr(t) for op in operands
        for t in (op.w, op.col_gain, op.row_gain, op.chunk_gain)])
    regions = (ctypes.c_void_p * len(BLOCK_STAGES))(*[
        stages[name].data_ptr() for name, _, _ in BLOCK_STAGES])
    sched = []
    for m, op, p in zip(schedule, operands, plans):
        ends = tuple(op.block_ends) + (m.n,) * (4 - len(op.block_ends))
        vec = (all(t.data_ptr() % 16 == 0
                   for t in (op.w, op.row_gain, op.chunk_gain)
                   if t is not None)
               and (m.n * op.w.element_size()) % 16 == 0)
        sched += [m.c0, m.k, m.k_pad, m.n, m.n_chunks,
                  int(m.encode == "split"), op.form, len(op.block_ends),
                  *ends, p.chunks_per_cta, p.n_splits, int(vec)]
    sched = (ctypes.c_int * (_BLOCK_FIELDS * 4))(*sched)
    used = ctypes.c_int(0)
    _build.launch(
        "analog_plan_block", dev, x_in.data_ptr(),
        ctypes.cast(wptrs, ctypes.c_void_p), gain_all.data_ptr(),
        off_cat.data_ptr(), deq.data_ptr(), bias.data_ptr(), enc.data_ptr(),
        ln.data_ptr(), rope.data_ptr(), out.data_ptr(),
        ctypes.cast(regions, ctypes.c_void_p), work.data_ptr(),
        ctypes.cast(sched, ctypes.c_void_p), rows, n_max, chunk_rows,
        int(faithful), mt, block.n_heads, block.n_kv_heads, block.head_dim,
        block.seq, block.d_ff, float(block.eps),
        1.0 / math.sqrt(block.head_dim), ctypes.addressof(used),
    )
    return out, stages, used.value
