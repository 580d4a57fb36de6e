"""Compiled execution plans for stacks of analog layers (port of
``repro.exec.plan``).

The paper executes its network as a *pre-compiled schedule* of chunked
analog VMM passes on fixed synapse tiles (Fig. 4, §II-C): weights are
quantized, calibrated and placed ONCE, then inference replays the
schedule.  The plans are frozen dataclasses holding tensors:

- :class:`WeightStore` - the packed weight state of one lowered layer:
  int8 6-bit weight codes (padded to whole 128-row chunks), the
  per-column weight LSB, the calibrated gain and the fixed-pattern gain
  tables; the fp32 effective weights (:attr:`w_eff`) are derived from
  them at their first read.
- :class:`LayerPlan` - one lowered analog layer.
- :class:`GroupPlan` - one lowered fusion group (the attention QKV
  ``column_concat`` group: one dispatch over concatenated columns; the
  RWKV r/k/v/g ``batch_concat`` group: one dispatch over a member axis;
  an MoE ``expert_stack``: one dispatch over every expert of a stacked
  weight).
- :class:`PlanStack` - the per-member plans of a scan-stacked layer.
- :class:`MegakernelPack` - the kernel-ready packing of a whole chain or
  transformer block.
- :class:`BlockGlue` - the digital glue of a fused attention+MLP block.
- :class:`AnalogPlan` - an ordered stack of :class:`LayerPlan`.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.hw import BSS2

# Epilogue tags. "none": raw accumulated ADC codes leave the layer and are
# dequantized to float. "relu_shift": ADC-fused ReLU + right-shift
# requantization to 5-bit codes (paper §II-A).
EPILOGUE_NONE = "none"
EPILOGUE_RELU_SHIFT = "relu_shift"

# Input-domain tags, baked at lower time: "codes" skips activation
# quantization, "float" quantizes like any other float activation.
INPUT_CODES = "codes"
INPUT_FLOAT = "float"


# Fusion-group kinds.  "column_concat": layers with the same input and
# concatenated output columns (attention QKV) run as one [K, sum(N_i)]
# pass.  "batch_concat": G same-geometry layers with DIFFERENT inputs (the
# RWKV r/k/v/g projections), lowered into one plan with a leading member
# axis on every leaf, each member with its own tables and input scale,
# run as ONE dispatch.  "expert_stack": one stacked [E, K, N] MoE expert
# weight, lowered once into a per-expert plan (a leading expert axis on
# every leaf) that runs as ONE dispatch over all experts.
GROUP_COLUMN_CONCAT = "column_concat"
GROUP_BATCH_CONCAT = "batch_concat"
GROUP_EXPERT_STACK = "expert_stack"
GROUP_KINDS = (GROUP_COLUMN_CONCAT, GROUP_BATCH_CONCAT, GROUP_EXPERT_STACK)


def default_shift(n_chunks: int) -> int:
    """Right-shift mapping the accumulated non-negative ADC range
    ``[0, C * adc_max]`` onto the 5-bit activation range (paper §II-A:
    "applying bitwise right-shifts")."""
    full = n_chunks * BSS2.adc_max
    shift = 0
    while (full >> shift) > BSS2.a_max:
        shift += 1
    return shift


class _Rank1(torch.autograd.Function):
    """``(codes * col_gain) * row_gain`` of a one-block rank-1 store, as
    autograd computes it, without keeping the ``codes * col_gain``
    product for the backward (the row gain's gradient recomputes it): a
    full-size LM lowers every weight under autograd each training step,
    and that product would be one more fp32 copy of every weight."""

    @staticmethod
    def forward(ctx, codes, col_gain, row_gain):
        ctx.save_for_backward(codes, col_gain, row_gain)
        return (codes * col_gain[..., None, :]) * row_gain[..., 0, :, None]

    @staticmethod
    def backward(ctx, g):
        codes, col, row = ctx.saved_tensors
        c, r = col[..., None, :], row[..., 0, :, None]
        g_t1 = g * r
        d_codes = d_col = d_row = None
        if ctx.needs_input_grad[0]:
            d_codes = g_t1 * c
        if ctx.needs_input_grad[1]:
            d_col = (g_t1 * codes).sum(dim=-2)
        if ctx.needs_input_grad[2]:
            d_row = (g * (codes * c)).sum(dim=-1).unsqueeze(-2)
        return d_codes, d_col, d_row


@dataclasses.dataclass(frozen=True)
class WeightStore:
    """Packed weight state of one lowered analog layer.

      codes:      [K_pad, N] int8 6-bit weight codes, rows zero-padded to
                  a whole number of chunks; fp32 STE codes when they
                  require grad (hardware-in-the-loop training re-lowers
                  inside every step, and an int8 cast would cut the
                  straight-through gradient to the float masters).
      w_scale:    [1, N] per-column weight LSB.
      gain:       scalar calibrated analog gain (NOT folded into w_eff).
      col_gain:   optional [N] per-column fixed-pattern gain (rank-1).
      row_gain:   optional [G, K_pad] per-row fixed-pattern gain, one
                  row vector per column block (G = 1 for a solo layer, one
                  per member of a column_concat fusion, split by
                  ``col_blocks``); pad rows hold exact 1.0.
      chunk_gain: optional [C, N] measured per-(chunk, column) gain table
                  (the calibrated bake, :mod:`repro_torch.calib`).
      gain_map:   optional [K_pad, N] full per-synapse gain map; pad rows
                  hold exact 1.0.

    Static: ``chunk_rows`` and ``col_blocks`` (the member widths of a
    column_concat fusion, summing to N, or None for one block).

    Dequantization contract (:attr:`w_eff`): multiply the codes by
    col_gain, then the per-block row_gain, then the chunk-repeated
    chunk_gain, then gain_map - elementwise in exactly the reference's
    order, which reproduces its effective weights bit for bit (``x * 1.0``
    is exact).  Every table indexes from the right, so a store loaded
    with a leading member axis (a batch_concat or expert_stack group)
    derives its ``w_eff`` the same way.

    Derived views, kept beside the tables once derived (an eager replay
    would otherwise rebuild them on every call; the reference's jit folds
    that work into its compiled program, ``w_eff`` there being computed
    in-graph):

      w_eff:      [K_pad, N] fp32 effective weights, a differentiable view
                  of the codes and the gain tables, derived at its first
                  read and kept: the card's kernels read the int8 codes
                  and the tables, so a store served there never holds the
                  4 bytes per weight of the fp32 copy; the plain versions
                  on the CPU and the offset route derive it where they
                  read it.  A store built under autograd from tensors that
                  require grad (hardware-in-the-loop training lowers in
                  every step) derives it at construction instead: the
                  derivation is then recorded where the store is built,
                  not inside a checkpointed group whose recompute would
                  find it already kept.  The bits are the same whenever
                  it is derived.  Ask :meth:`records_grad` whether autograd
                  records a call on the store: that reads no ``w_eff``.
      gain_row:   [N] the gain broadcast over the columns, contiguous
                  (an expert stack's [E, N], each expert's gain; a
                  batch_concat store's [G, N], each member's).
    """

    codes: torch.Tensor
    w_scale: torch.Tensor
    gain: torch.Tensor
    col_gain: Optional[torch.Tensor] = None
    row_gain: Optional[torch.Tensor] = None
    chunk_gain: Optional[torch.Tensor] = None
    gain_map: Optional[torch.Tensor] = None
    chunk_rows: int = BSS2.signed_rows
    col_blocks: Optional[Tuple[int, ...]] = None
    gain_row: torch.Tensor = dataclasses.field(init=False, repr=False,
                                               compare=False)

    def __post_init__(self):
        object.__setattr__(self, "gain_row", self.derive_gain_row())
        # the grad mode a first read derives w_eff under: the one the
        # store was built in (a store built under no_grad keeps no graph)
        object.__setattr__(self, "_grad_mode", torch.is_grad_enabled())
        if self.records_grad():
            object.__setattr__(self, "_w_eff", self._derive_w_eff())

    def records_grad(self) -> bool:
        """Would autograd record a call on ``w_eff`` now, i.e. does the
        view read now require grad?  What a call asks instead of reading
        ``w_eff``, which would derive it."""
        if not torch.is_grad_enabled():
            return False
        w = self.__dict__.get("_w_eff")
        if w is not None:
            return w.requires_grad
        return self.__dict__.get("_grad_mode", True) and any(
            t is not None and t.requires_grad
            for t in (self.codes, self.col_gain, self.row_gain,
                      self.chunk_gain, self.gain_map))

    def derive_gain_row(self) -> torch.Tensor:
        """:attr:`gain_row` from the gain and the codes' shape."""
        gain = self.gain
        if self.codes.ndim == 2:
            gain = torch.broadcast_to(gain, (self.codes.shape[-1],))
        elif self.codes.ndim == 3 and gain.ndim == 1:
            # an expert stack: [E] -> [E, N]
            gain = torch.broadcast_to(gain.reshape(gain.shape[0], 1),
                                      (gain.shape[0], self.codes.shape[-1]))
        elif self.codes.ndim == 3:  # a batch_concat store's [G, N]
            gain = torch.broadcast_to(gain, (self.codes.shape[0],
                                             self.codes.shape[-1]))
        return gain.contiguous()

    @property
    def derived(self) -> bool:
        """Has this store derived (and kept) its fp32 ``w_eff``?"""
        return "_w_eff" in self.__dict__

    @property
    def w_eff(self) -> torch.Tensor:
        w = self.__dict__.get("_w_eff")
        if w is None:
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and self.__dict__.get("_grad_mode",
                                                              True)):
                w = self._derive_w_eff()
            object.__setattr__(self, "_w_eff", w)
        return w

    def _derive_w_eff(self, rows: Optional[int] = None) -> torch.Tensor:
        """``w_eff`` from the codes and the tables; ``rows``: its first
        rows alone (elementwise, so the same bits as the whole's)."""
        k = self.codes.shape[-2] if rows is None else rows
        w = self.codes[..., :k, :].to(torch.float32)
        col = self.col_gain
        row = None if self.row_gain is None else self.row_gain[..., :k]
        if (col is not None and row is not None and self.col_blocks is None
                and torch.is_grad_enabled()
                and any(t.requires_grad for t in (w, col, row))):
            w = _Rank1.apply(w, col, row)
        else:
            if col is not None:
                w = w * col[..., None, :]
            if row is not None and self.col_blocks is None:
                w = w * row[..., 0, :, None]
            elif row is not None:
                parts, c0 = [], 0
                for gi, nb in enumerate(self.col_blocks):
                    parts.append(w[..., c0:c0 + nb] * row[..., gi, :, None])
                    c0 += nb
                w = torch.cat(parts, dim=-1)
        if self.chunk_gain is not None:
            w = w * torch.repeat_interleave(self.chunk_gain, self.chunk_rows,
                                            dim=-2)[..., :k, :]
        if self.gain_map is not None:
            w = w * self.gain_map[..., :k, :]
        return w

    @property
    def code_operand(self) -> bool:
        """Can a kernel read this store as int8 codes plus its gain tables
        (``col_gain``, ``row_gain``, a measured ``chunk_gain``)?  Not with
        a full per-synapse gain map: such a store gives the kernels its
        fp32 ``w_eff``."""
        return self.gain_map is None

    @property
    def k_pad(self) -> int:
        return self.codes.shape[-2]


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One lowered analog layer.

    Tensors: ``store`` (the :class:`WeightStore`), ``a_scale`` (scalar
    static activation LSB), ``chunk_offset`` ([C, N] fixed-pattern ADC
    offsets or None), ``colsum`` ([N] column sums of ``w_eff``, the
    offset encoding's correction term; None until ``signed_input=
    "offset"`` is ported, kept so that plan stores match the
    reference's), ``bias`` ([N] or None), ``a_scale_in`` (the shared
    static input LSB of a snapshot-calibrated fusion group, or None:
    static encoding, and the matching dequantization, then use it
    instead of ``a_scale``).  Static attributes: ``k``
    (logical input width), ``n`` (output width), ``chunk_rows``,
    ``signed_input``, ``epilogue``, ``shift`` (relu_shift right shift) and
    ``flatten_out`` (merge the position axis into features before the
    next layer - the conv->fc1 im2col glue).
    """

    store: WeightStore
    a_scale: torch.Tensor
    chunk_offset: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    k: int
    n: int
    chunk_rows: int
    signed_input: str
    epilogue: str = EPILOGUE_NONE
    shift: int = 0
    flatten_out: bool = False
    colsum: Optional[torch.Tensor] = None
    a_scale_in: Optional[torch.Tensor] = None

    @property
    def in_scale(self) -> torch.Tensor:
        """The static LSB this layer encodes float inputs with (and
        dequantizes its output at): the group's shared ``a_scale_in``
        when calibrated together, else its own ``a_scale``."""
        return self.a_scale if self.a_scale_in is None else self.a_scale_in

    @property
    def w_eff(self) -> torch.Tensor:
        return self.store.w_eff

    @property
    def w_scale(self) -> torch.Tensor:
        return self.store.w_scale

    @property
    def gain(self) -> torch.Tensor:
        return self.store.gain

    @property
    def gain_row(self) -> torch.Tensor:
        return self.store.gain_row

    @property
    def k_pad(self) -> int:
        return self.store.codes.shape[-2]

    @property
    def n_chunks(self) -> int:
        return self.store.codes.shape[-2] // self.chunk_rows


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """One lowered fusion group: the fused dispatch plus the member layout
    that hands each member its own columns (or its own output).

      kind:         one of :data:`GROUP_KINDS`.
      fused:        a :class:`LayerPlan` over the concatenated output
                    columns ``[K_pad, sum(N_i)]``
                    (:func:`repro_torch.exec.lower.lower_fused`); a
                    batch_concat group's member-axis plan, every leaf
                    with a leading member axis: codes ``[G, K_pad, N]``,
                    ``w_scale [G, 1, N]``, ``gain [G, N]``, ``col_gain
                    [G, N]``, ``row_gain [G, 1, K_pad]``, ``chunk_offset``
                    and ``chunk_gain [G, C, N]``, ``a_scale [G]``
                    (:func:`repro_torch.exec.lower.lower_batch_concat`);
                    or an expert stack's per-expert plan, every leaf with
                    a leading expert axis: codes ``[E, K_pad, N]``,
                    ``w_scale [E, 1, N]``, ``gain [E]``
                    (:func:`repro_torch.exec.lower.lower_expert_stack`).
      member_names: the members' local names in the parent params node,
                    declaration order (e.g. ``("wq", "wk", "wv")``).
      member_ns:    each member's output width (the column split).
    """

    kind: str
    fused: LayerPlan
    member_names: Tuple[str, ...]
    member_ns: Tuple[int, ...]


def find_group(groups, kind: str, member_names: Tuple[str, ...]
               ) -> Optional[GroupPlan]:
    """Resolve a lowered :class:`GroupPlan` from a node's ``"_groups"``
    dict by (kind, exact member names), whatever the group's name: a
    group of another kind is never fed to the wrong replay."""
    for gp in (groups or {}).values():
        if gp.kind == kind and gp.member_names == tuple(member_names):
            return gp
    return None


class PlanStack(tuple):
    """The plans of a scan-stacked layer dict or fusion group (leading
    stack axis S of the parameters): member ``i`` is the plan of slice
    ``i``.  The reference vmaps its lowering into one plan with stacked
    leaves; the port lowers each slice on its own, so that every member
    owns its contiguous derived weights, and a model loop over the stack
    picks member ``i`` (:func:`repro_torch.models.transformer.stack_index`).
    """


@dataclasses.dataclass(frozen=True)
class MegakernelPack:
    """Kernel-ready packing of an AnalogPlan chain or transformer block for
    the whole-plan kernels (built once by
    :func:`repro_torch.exec.lower.pack_megakernel`).

      stores:   the per-layer :class:`WeightStore` records, shared with
                the plan's layers.  A chain also derives ``w_cat``
                ([sum(k_pad), n_max] effective weights, columns
                zero-padded to the common lane width, row-concatenated)
                once, at construction; a block does not (at phi4-mini
                width that copy would be 1.14 GB per block): its kernel
                reads each store in place, the int8 codes and gain tables
                (or ``w_eff`` for a store with a full gain map).
      gain:     [L, n_max] per-layer analog gains (broadcast + padded).
      off:      [sum(n_chunks), n_max] chunk offsets (zeros where a layer
                has none), chunk-concatenated.
      deq, bias, enc: float-domain hand-off rows ([L, n_max], [L, n_max],
                [L, 1]) or None for pure code chains.
      ln:       [2, n_max] a block's ln1/ln2 scales, else None.
      schedule: tuple of :class:`repro_torch.kernels.analog_plan.MegaLayerMeta`.
      n_max:    packed lane width (max layer width, 128-aligned).
      block:    a block's :class:`repro_torch.kernels.analog_plan.BlockMeta`.
    """

    stores: Tuple[WeightStore, ...]
    gain: torch.Tensor
    off: torch.Tensor
    schedule: tuple
    n_max: int
    chunk_rows: int
    deq: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    enc: Optional[torch.Tensor] = None
    ln: Optional[torch.Tensor] = None
    block: Optional[tuple] = None
    w_cat: Optional[torch.Tensor] = dataclasses.field(
        init=False, repr=False, compare=False)

    def with_off(self, off: torch.Tensor) -> "MegakernelPack":
        """This pack with another chunk-offset table (the drift hot-swap):
        the stores, ``w_cat`` and every other operand are shared, nothing
        is re-derived."""
        if tuple(off.shape) != tuple(self.off.shape):
            raise ValueError(f"offset table shape {tuple(off.shape)} != "
                             f"packed {tuple(self.off.shape)}")
        out = copy.copy(self)
        object.__setattr__(out, "off", off)
        return out

    def __post_init__(self):
        w_cat = None
        if self.block is None:
            w_cat = torch.cat([
                torch.nn.functional.pad(s.w_eff, (0, self.n_max - meta.n))
                for s, meta in zip(self.stores, self.schedule)
            ], dim=0)
        object.__setattr__(self, "w_cat", w_cat)

    @property
    def weights(self):
        """The effective weights of the whole-plan dispatch: a chain's
        ``w_cat`` (what its kernel reads), a block's per-layer ``w_eff``
        tuple (its plain version's operand; the block kernel reads
        :attr:`stores`)."""
        if self.w_cat is not None:
            return self.w_cat
        return tuple(s.w_eff for s in self.stores)

    @property
    def extras(self):
        """The float-glue operand tuple of the dispatch (None for a pure
        code-domain pack)."""
        if self.deq is None:
            return None
        return (self.deq, self.bias, self.enc, self.ln)


@dataclasses.dataclass(frozen=True)
class BlockGlue:
    """The digital glue of one fused attention+MLP transformer block,
    attached to an :class:`AnalogPlan` lowered by
    :func:`repro_torch.exec.lower.lower_block`: the two RMSNorm scales
    (``ln1`` before QKV, ``ln2`` before the MLP) and the attention/MLP
    geometry.  ``meta`` renders the geometry as the
    :class:`repro_torch.kernels.analog_plan.BlockMeta` of the kernel
    schedule."""

    ln1: torch.Tensor
    ln2: torch.Tensor
    n_heads: int
    n_kv_heads: int
    head_dim: int
    seq: int
    rope_theta: float
    d_ff: int
    eps: float = 1e-5

    @property
    def meta(self):
        from repro_torch.kernels.analog_plan import BlockMeta

        return BlockMeta(
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim, seq=self.seq,
            rope_theta=self.rope_theta, d_ff=self.d_ff, eps=self.eps,
        )


@dataclasses.dataclass(frozen=True)
class AnalogPlan:
    """A lowered stack of analog layers plus the execution config it was
    lowered for.  ``input_domain`` ("codes" | "float") states what the
    plan's INITIAL input is; ``mega`` is the optional whole-plan packing,
    present iff the chain is megakernel-eligible; ``block`` is the glue of
    a plan lowered by :func:`repro_torch.exec.lower.lower_block`."""

    layers: Tuple[LayerPlan, ...]
    cfg: AnalogConfig
    mega: Optional[MegakernelPack] = None
    input_domain: Optional[str] = None
    block: Optional[BlockGlue] = None

    @property
    def expects_codes(self) -> bool:
        """Does the plan's first layer consume 5-bit codes?"""
        return self.input_domain == INPUT_CODES

    @property
    def expected_dispatches(self) -> int:
        """Analog dispatches ONE layer-by-layer replay of this plan issues,
        from its static metadata alone (a block's canonical replay is its
        single whole-block dispatch; the megakernel route of a chain
        issues 1)."""
        if self.block is not None:
            return 1
        is_codes = self.expects_codes
        n = 0
        last = len(self.layers) - 1
        for i, lp in enumerate(self.layers):
            signed = "none" if is_codes else lp.signed_input
            n += 2 if (signed == "split" and not self.cfg.fused_split) else 1
            if lp.epilogue == EPILOGUE_NONE and i < last:
                is_codes = False
            else:
                is_codes = lp.epilogue == EPILOGUE_RELU_SHIFT
        return n


# The reference's pytree registration of each plan class: (data fields,
# static metadata fields).  The plan store writes these fields, and the
# verifier walks them (paths, structure); derived views (``w_eff``,
# ``gain_row``, ``w_cat``) are not fields of the artifact.
PYTREE_FIELDS = {
    WeightStore: (("codes", "w_scale", "gain", "col_gain", "row_gain",
                   "chunk_gain", "gain_map"), ("chunk_rows", "col_blocks")),
    LayerPlan: (("store", "a_scale", "chunk_offset", "colsum", "bias",
                 "a_scale_in"),
                ("k", "n", "chunk_rows", "signed_input", "epilogue",
                 "shift", "flatten_out")),
    GroupPlan: (("fused",), ("kind", "member_names", "member_ns")),
    MegakernelPack: (("stores", "gain", "off", "deq", "bias", "enc", "ln"),
                     ("schedule", "n_max", "chunk_rows", "block")),
    BlockGlue: (("ln1", "ln2"),
                ("n_heads", "n_kv_heads", "head_dim", "seq", "rope_theta",
                 "d_ff", "eps")),
    AnalogPlan: (("layers", "mega", "block"), ("cfg", "input_domain")),
}
