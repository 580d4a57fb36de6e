"""Whole-plan CUDA kernel: one launch per packed AnalogPlan chain.

The paper's headline figure - 276 us / 192 uJ per ECG sample (§IV) -
comes from the conv->fc1->fc2 CDNN running as ONE uninterrupted analog
program on the ASIC: inter-layer 5-bit activation codes never leave the
chip (§II-A).  ``csrc/analog_plan.cu`` replaces the TPU kernel
``repro/kernels/analog_plan.py::analog_plan_pallas`` for the code-domain
part of its schedule (stage a): layers that consume 5-bit codes, the
``"codes"`` hand-off (ReLU + right-shift requantization at the ADC, with
the ``flatten`` im2col merge of the ECG conv->fc1 step) and the final
``"raw"`` hand-off.  The float-domain encodes (``"unsigned"``,
``"split"``), the ``"relu"`` hand-off and the transformer-block glue are
not ported yet; the wrapper raises on them.

The grid runs over batch elements (each block owns ``per_block`` records
end to end) and the inter-layer codes stay in shared memory.  The packed
weights are read from global memory (L2-resident): the TPU kernel keeps
them resident in VMEM, but the ECG pack (512 x 256 fp32 = 512 KiB) does
not fit a Hopper block's 227 KB of shared memory.  The plain version is
:func:`repro_torch.kernels.ref.analog_plan_ref`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.hw import BSS2
from repro_torch.kernels import _build

MAX_LAYERS = 8
MAX_PER_BLOCK = 4
_SMEM_LIMIT = 227 * 1024
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
)


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
    # hand-off to the NEXT layer: "codes" | "relu" | ... (inter-layer),
    # "raw" | "res_out" (final)
    handoff: str = ""


def stage_a_reason(schedule: Tuple[MegaLayerMeta, ...]):
    """None when the CUDA kernel runs ``schedule`` (code-domain stage a),
    else the reason it cannot."""
    last = len(schedule) - 1
    for i, meta in enumerate(schedule):
        want = "raw" if i == last else "codes"
        if meta.encode != "codes" or meta.handoff != want:
            return (f"layer {i} encodes {meta.encode!r} and hands off "
                    f"{meta.handoff!r}: float-domain megakernel hand-offs "
                    "are not ported yet (ROADMAP queue 2)")
    return None


def default_per_block(batch: int, device: torch.device) -> int:
    """Records per block: enough blocks to cover every SM first, then up
    to :data:`MAX_PER_BLOCK` records each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(MAX_PER_BLOCK, batch // sms))


def analog_plan_cuda(
    x_in: torch.Tensor,          # [B * m_mult0, k0_pad] 5-bit codes
    w_cat: torch.Tensor,         # [sum(k_pad), n_max]
    gain_all: torch.Tensor,      # [L, n_max]
    off_cat: torch.Tensor,       # [sum(n_chunks), n_max]
    *,
    schedule: Tuple[MegaLayerMeta, ...],
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
) -> torch.Tensor:
    """Run a packed code-domain chain in one launch; returns the last
    layer's raw accumulated ADC codes ``[B * m_mult_last, n_last]``."""
    dev = x_in.device
    if dev.type != "cuda":
        raise ValueError(f"analog_plan_cuda needs CUDA tensors, got {dev}")
    if not 1 <= len(schedule) <= MAX_LAYERS:
        raise ValueError(f"schedule needs 1..{MAX_LAYERS} layers, got "
                         f"{len(schedule)}")
    reason = stage_a_reason(schedule)
    if reason is not None:
        raise ValueError(reason)
    for i, (meta, nxt) in enumerate(zip(schedule, schedule[1:])):
        if (meta.flatten * meta.n > nxt.k_pad
                or meta.m_mult != nxt.m_mult * meta.flatten):
            raise ValueError(f"layer {i} does not feed layer {i + 1}: "
                             f"{meta} -> {nxt}")
    m0, first, lastm = schedule[0].m_mult, schedule[0], schedule[-1]
    rows, cols = x_in.shape
    if rows % m0 or cols != first.k_pad:
        raise ValueError(f"x_in {tuple(x_in.shape)} does not match layer 0 "
                         f"(m_mult {m0}, k_pad {first.k_pad})")
    batch = rows // m0
    n_max = w_cat.shape[1]
    n_layers = len(schedule)
    for name, t, shape in (
            ("x_in", x_in, (rows, cols)),
            ("w_cat", w_cat, (sum(m.k_pad for m in schedule), n_max)),
            ("gain_all", gain_all, (n_layers, n_max)),
            ("off_cat", off_cat, (sum(m.n_chunks for m in schedule), n_max))):
        _build.check_operand(name, t, dev, shape)
    pb = default_per_block(batch, dev)
    buf = max((pb * m.m_mult * m.k_pad for m in schedule[1:]), default=1)
    if 2 * 4 * buf > _SMEM_LIMIT:
        raise ValueError(f"{pb} records per block need {8 * buf} bytes of "
                         f"shared memory, over the {_SMEM_LIMIT} a block has")
    sched = (ctypes.c_int * (8 * n_layers))(*[
        v for m in schedule for v in (m.row0, m.c0, m.k_pad, m.n, m.n_chunks,
                                      m.shift, m.flatten, m.m_mult)])
    out = torch.empty((batch * lastm.m_mult, lastm.n), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        _build.launch(
            "analog_plan", _ARGTYPES, _build.ptr(x_in), _build.ptr(w_cat),
            _build.ptr(gain_all), _build.ptr(off_cat), _build.ptr(out),
            batch, cols, n_max, ctypes.cast(sched, ctypes.c_void_p),
            n_layers, chunk_rows, int(faithful), pb,
            _build.current_stream(dev),
        )
    return out
