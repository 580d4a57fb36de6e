"""CUDA kernel for the BSS-2 analog VMM emulation: every analog-mapped
linear layer reduces to chunked saturating ``[M, K] x [K, N]`` matmuls.

``csrc/analog_mvm.cu`` replaces the TPU kernel
``repro/kernels/analog_mvm.py::analog_mvm_pallas``: per 128-row chunk a
dot, the analog gain and the fixed-pattern offset, an 8-bit ADC
round/clip (faithful) and the digital accumulation, with the optional
``relu_shift`` epilogue fused into the store.  The launch geometry comes
from the shapes (:func:`mvm_plan`): a column tile that fits N, rows per
CTA and chunks computed side by side so that one wave of CTAs fills the
card; each CTA stages its operands once with ``cp.async`` and sums the
chunks' readouts in ascending chunk order.  fp32 operands and
accumulation; M and N are masked, not padded.  The plain version is
:func:`repro_torch.kernels.ref.analog_mvm_ref` (+ ``adc_epilogue_ref``).

``csrc/analog_mvm_split.cu`` replaces ``analog_mvm_split_pallas``: the
signed-split pair ``mvm(a_pos) - mvm(a_neg)`` in one launch, on the
tensor cores (each fp32 weight cut exactly into three bf16 pieces), both
passes sharing every weight fragment, each pass rounded and clipped on
its own; faithful mode splits the chunks of each column tile over
several CTAs (:func:`split_plan`).  Two weight operands: the plan's int8
codes with their gain tables (:func:`analog_mvm_split_codes_cuda`, plain
version :func:`repro_torch.kernels.ref.analog_mvm_split_codes_ref`), or
an fp32 ``w_eff`` (:func:`analog_mvm_split_cuda`, plain version
:func:`repro_torch.kernels.ref.analog_mvm_split_ref`).  An expert axis
runs the E matrices of an MoE expert stack in one launch
(:func:`analog_mvm_split_experts_cuda`, plain version
:func:`repro_torch.kernels.ref.analog_mvm_split_experts_ref`); the same
axis with per-member tables runs the G members of an RWKV r/k/v/g
``batch_concat`` group in one launch
(:func:`analog_mvm_split_members_cuda`, plain version
:func:`repro_torch.kernels.ref.analog_mvm_split_members_ref`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.hw import BSS2
from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_build.declare("analog_mvm", (_P,) * 5 + (_I,) * 12)
_build.declare("analog_mvm_split", (
    _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I,
))


def _epilogue_shift(epilogue) -> int:
    """The kernels' ``shift`` argument: -1 for no epilogue."""
    if epilogue is None:
        return -1
    kind, shift = epilogue
    if kind != "relu_shift" or not 0 <= shift < 31:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return shift


def _chunk_offsets(chunk_offset, n_chunks, n, dev):
    if chunk_offset is None:
        return torch.zeros((n_chunks, n), dtype=torch.float32, device=dev)
    return chunk_offset


# the analog_mvm kernel's geometry (csrc/analog_mvm.cu)
MVM_THREADS = 256       # per CTA: one per (row, 4 columns, chunk)
MVM_MAX_TN = 128        # columns per CTA
MVM_MAX_STAGES = 4      # staging buffers (steps in flight)
MVM_SMEM_LIMIT = 227 * 1024


class MvmPlan(NamedTuple):
    """How one ``analog_mvm`` launch cuts its work: ``tm`` rows and ``tn``
    columns (a multiple of 4) per CTA, ``row_groups`` x ``col_tiles``
    CTAs; each step computes ``ways`` consecutive chunks side by side,
    ``stages`` steps staged at once; ``smem`` bytes of dynamic shared
    memory."""

    tm: int
    tn: int
    ways: int
    stages: int
    row_groups: int
    col_tiles: int
    smem: int


def mvm_smem_bytes(tm: int, tn: int, ways: int, stages: int,
                   chunk_rows: int) -> int:
    """The kernel's shared memory: the gain row, the per-chunk slots
    (``ways > 1``) and ``stages`` buffers, each holding, per chunk of a
    step, its offset row, the CTA's ``a`` rows (4 floats of padding per
    row) and its weight rows."""
    part = tn + tm * (chunk_rows + 4) + chunk_rows * tn
    return 4 * (tn + (ways * tm * tn if ways > 1 else 0)
                + stages * ways * part)


def mvm_geometry(m: int, n: int, tm: int, tn: int, ways: int, stages: int,
                 chunk_rows: int) -> MvmPlan:
    """The plan of ``tm`` x ``tn`` tiles with ``ways`` chunks side by side
    and ``stages`` buffers: its grid and shared memory."""
    return MvmPlan(tm, tn, ways, stages, -(-m // tm), -(-n // tn),
                   mvm_smem_bytes(tm, tn, ways, stages, chunk_rows))


@functools.lru_cache(maxsize=4096)
def mvm_plan(m: int, n: int, n_chunks: int, chunk_rows: int,
             sms: int) -> MvmPlan:
    """The launch geometry, fixed by the shapes and the card's SM count.

    For each column tile ``tn`` (4, 8, ... up to N rounded to 4, at most
    128) it takes the fewest rows per CTA that keep the CTAs within one
    wave of ``sms`` and as many chunks side by side as the CTA's threads
    allow (fewer buffers, then fewer chunks side by side, then fewer rows
    where the shared memory does not hold them), and keeps the candidate
    with the fewest waves, then the fewest steps (the chunks one thread
    walks in series), then the fewest bytes staged per CTA, then the
    fewest CTAs.  The mode does not enter: the slots are summed in chunk
    order in both modes."""
    best = key = None
    chunks = max(1, n_chunks)
    k = n_chunks * chunk_rows
    for tn in range(4, min(MVM_MAX_TN, -(-n // 4) * 4) + 1, 4):
        groups = tn // 4
        col_tiles = -(-n // tn)
        tm = min(MVM_THREADS // groups,
                 -(-m // max(1, sms // col_tiles)))
        ways = min(chunks, MVM_THREADS // (tm * groups))
        while True:  # shrink stages, then ways, then tm until it fits
            steps = -(-chunks // ways)
            stages = min(steps, MVM_MAX_STAGES)
            while stages > 1 and mvm_smem_bytes(
                    tm, tn, ways, stages, chunk_rows) > MVM_SMEM_LIMIT:
                stages -= 1
            plan = mvm_geometry(m, n, tm, tn, ways, stages, chunk_rows)
            if plan.smem <= MVM_SMEM_LIMIT:
                break
            if ways > 1:
                ways //= 2
            elif tm > 1:
                tm //= 2
                ways = min(chunks, MVM_THREADS // (tm * groups))
            else:
                break
        if plan.smem > MVM_SMEM_LIMIT:
            continue
        ctas = plan.row_groups * col_tiles
        cand = (-(-ctas // sms), steps, tm * k + k * tn, ctas)
        if key is None or cand < key:
            best, key = plan, cand
    if best is None:
        raise ValueError(f"chunk_rows={chunk_rows} is too long for one "
                         "chunk of the analog_mvm kernel's shared memory")
    return best


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def analog_mvm_cuda(
    a_code: torch.Tensor,                  # [M, K]
    w_eff: torch.Tensor,                   # [K, N]
    gain: torch.Tensor,                    # [N]
    chunk_offset: Optional[torch.Tensor],  # [C, N] or None
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
    epilogue=None,                         # None | ("relu_shift", shift)
) -> torch.Tensor:
    """Launch the chunked saturating analog VMM on the CUDA device, cut
    as :func:`mvm_plan` says."""
    return analog_mvm_cuda_with_plan(a_code, w_eff, gain, chunk_offset,
                                     None, chunk_rows=chunk_rows,
                                     faithful=faithful, epilogue=epilogue)


def analog_mvm_cuda_with_plan(a_code, w_eff, gain, chunk_offset,
                              plan: Optional[MvmPlan], *,
                              chunk_rows: int = BSS2.signed_rows,
                              faithful: bool = True, epilogue=None):
    """:func:`analog_mvm_cuda` cut by ``plan`` (None: :func:`mvm_plan`'s;
    the card checks pass others, from :func:`mvm_geometry`, to reach
    every tile width and staging branch)."""
    dev = a_code.device
    if dev.type != "cuda":
        raise ValueError(f"analog_mvm_cuda needs CUDA tensors, got {dev}")
    m, k = a_code.shape
    n = w_eff.shape[1]
    if k % chunk_rows or chunk_rows % 32:
        raise ValueError(f"K={k} must be a multiple of chunk_rows="
                         f"{chunk_rows}, itself a multiple of 32")
    n_chunks = k // chunk_rows
    chunk_offset = _chunk_offsets(chunk_offset, n_chunks, n, dev)
    shift = _epilogue_shift(epilogue)
    for name, t, shape in (("a_code", a_code, (m, k)),
                           ("w_eff", w_eff, (k, n)), ("gain", gain, (n,)),
                           ("chunk_offset", chunk_offset, (n_chunks, n))):
        _build.check_operand(name, t, dev, shape)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    if plan is None:
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        plan = mvm_plan(m, n, n_chunks, chunk_rows, _sms(index))
    vec_w = int(n % 4 == 0 and all(t.data_ptr() % 16 == 0
                                   for t in (w_eff, gain, chunk_offset)))
    _build.launch("analog_mvm", dev, a_code.data_ptr(), w_eff.data_ptr(),
                  gain.data_ptr(), chunk_offset.data_ptr(), out.data_ptr(),
                  m, k, n, chunk_rows, int(faithful), shift, plan.tm,
                  plan.tn, plan.ways, plan.stages,
                  int(a_code.data_ptr() % 16 == 0), vec_w)
    return out


# the split kernel's geometry (csrc/analog_mvm_split.cu)
SPLIT_BN = 128          # output columns per CTA
SPLIT_STAGE_ROWS = 32   # weight rows per pipeline stage
SPLIT_MAX_BLOCKS = 4    # column blocks with their own row-gain vector


class SplitPlan(NamedTuple):
    """How one split-kernel launch cuts its work: ``mt`` m16 tiles (8
    activation rows each) per CTA, ``row_groups`` of them over M,
    ``col_tiles`` of :data:`SPLIT_BN` columns, and the chunks cut into
    ``n_splits`` ranges of ``chunks_per_cta`` (the last may be shorter)."""

    mt: int
    row_groups: int
    col_tiles: int
    chunks_per_cta: int
    n_splits: int


def split_tile_rows(m: int) -> int:
    """m16 tiles per CTA for M rows: M <= 8 (decode) one (8 rows of both
    passes), M <= 16 two, M <= 24 three, larger M six (48 rows: a 4 x 12
    prefill in one row group, so each weight is rebuilt once)."""
    return 1 if m <= 8 else 2 if m <= 16 else 3 if m <= 24 else 6


@functools.lru_cache(maxsize=4096)
def split_plan(m: int, n: int, n_chunks: int, faithful: bool,
               slots: int, experts: int = 1) -> SplitPlan:
    """The launch geometry, fixed by the shapes, the mode and ``slots``
    (the CTAs the card holds at once: SMs x CTAs per SM of this tiling);
    ``experts`` matrices of an expert stack share one launch, each cut
    the same way.

    Faithful mode cuts each tile's chunks into as few ranges as keep one
    wave of CTAs on the card: the longest range per CTA that still fills
    the slots (a second, partial wave would leave SMs idle at its end).
    Fast mode walks all chunks in one CTA: its pre-round sums depend on
    the chunk order."""
    mt = split_tile_rows(m)
    row_groups = -(-m // (8 * mt))
    col_tiles = -(-n // SPLIT_BN)
    cps = n_chunks
    if faithful:
        per_tile = max(1, slots // (experts * row_groups * col_tiles))
        cps = -(-n_chunks // min(per_tile, n_chunks))
    return SplitPlan(mt, row_groups, col_tiles, cps, -(-n_chunks // cps))


def split_items(plan: SplitPlan, n_chunks: int):
    """The work items of a launch cut by ``plan``, in the order the
    block kernel's VMM stages walk them (item ``i`` on CTA ``i % grid``):
    ``(column tile, row group, first chunk, end chunk)``.  The split
    kernel launches the same items as its grid."""
    for item in range(plan.col_tiles * plan.n_splits * plan.row_groups):
        tile = item % plan.col_tiles
        split = item // plan.col_tiles % plan.n_splits
        group = item // (plan.col_tiles * plan.n_splits)
        c0 = split * plan.chunks_per_cta
        yield tile, group, c0, min(n_chunks, c0 + plan.chunks_per_cta)


@functools.lru_cache(maxsize=None)
def _slots(index: int, form: int, mt: int, faithful: bool) -> int:
    """SMs x resident CTAs per SM of one kernel instantiation."""
    query = _build.function("analog_mvm_split", "analog_mvm_split_occupancy",
                            (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p))
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = query(form, mt, int(faithful), ctypes.addressof(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"analog_mvm_split occupancy query failed: CUDA "
                           f"error {rc}, {blocks.value} CTAs per SM")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * blocks.value


@functools.lru_cache(maxsize=None)
def _block_ends(ends: tuple):
    """A C int array of the column-block ends (one per distinct layout)."""
    return (ctypes.c_int * SPLIT_MAX_BLOCKS)(*ends)


def _split_launch(form, a_pos, a_neg, w, col_gain, row_gain, chunk_gain,
                  block_ends, gain, chunk_offset, chunk_rows, faithful,
                  epilogue, post_gain=None, tables=False):
    """Check the operands shared by both forms, cut the work
    (:func:`split_plan`) and launch once.  ``a_pos`` / ``a_neg`` of
    ``[E, M, K]`` against ``w [E, K, N]`` run the E matrices of an expert
    stack in the same launch (the grid's expert axis; ``gain`` and
    ``post_gain`` are then ``[E, N]``), counted as
    ``analog_mvm_split_experts``; with ``tables`` each of them reads its
    own ``chunk_offset [E, C, N]`` and gain tables (the member axis of a
    batch_concat group), counted as ``analog_mvm_split_members``."""
    dev = a_pos.device
    experts = a_pos.shape[0] if a_pos.ndim == 3 else 1
    lead = (experts,) if a_pos.ndim == 3 else ()
    m, k = a_pos.shape[-2:]
    n = w.shape[-1]
    if tables and not lead:
        raise ValueError("per-member tables need [E, M, K] operands")
    if k % chunk_rows or chunk_rows % SPLIT_STAGE_ROWS or not k:
        raise ValueError(f"K={k} must be a nonzero multiple of chunk_rows="
                         f"{chunk_rows}, itself a multiple of "
                         f"{SPLIT_STAGE_ROWS}")
    if post_gain is not None and faithful:
        raise ValueError("post_gain scales the fast mode's totals only")
    n_chunks = k // chunk_rows
    off_lead = lead if tables else ()
    if chunk_offset is None:
        chunk_offset = torch.zeros(off_lead + (n_chunks, n),
                                   dtype=torch.float32, device=dev)
    shift = _epilogue_shift(epilogue)
    checks = [("a_pos", a_pos, lead + (m, k)), ("a_neg", a_neg, lead + (m, k)),
              ("gain", gain, lead + (n,)),
              ("chunk_offset", chunk_offset, off_lead + (n_chunks, n))]
    if post_gain is not None:
        checks.append(("post_gain", post_gain, lead + (n,)))
    for name, t, shape in checks:
        _build.check_operand(name, t, dev, shape)
    out = torch.empty(lead + (m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0 or experts == 0:
        return out
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    plan = split_plan(m, n, n_chunks, faithful,
                      _slots(index, form, split_tile_rows(m), faithful),
                      experts)
    part = counters = None
    if plan.n_splits > 1:
        # the split-K workspace: one set of slots and counters per expert,
        # from PyTorch's caching allocator (the per-device pool)
        part = torch.empty((experts, plan.n_splits, m, n),
                           dtype=torch.float32, device=dev)
        counters = torch.zeros((experts * plan.row_groups * plan.col_tiles,),
                               dtype=torch.int32, device=dev)
    staged = [a_pos, a_neg, w, chunk_offset] + [
        t for t in (row_gain, chunk_gain) if t is not None]
    vec = int(all(t.data_ptr() % 16 == 0 for t in staged)
              and (n * w.element_size()) % 16 == 0)
    _build.launch(
        "analog_mvm_split", dev, a_pos.data_ptr(), a_neg.data_ptr(),
        w.data_ptr(), form, _build.ptr(col_gain), _build.ptr(row_gain),
        _build.ptr(chunk_gain), len(block_ends), ctypes.addressof(_block_ends(block_ends)),
        gain.data_ptr(), chunk_offset.data_ptr(), out.data_ptr(),
        _build.ptr(part),
        _build.ptr(counters), m, k, n, chunk_rows, plan.chunks_per_cta,
        plan.n_splits, plan.mt, int(faithful), shift, vec, experts,
        _build.ptr(post_gain), int(tables),
        count_as=("analog_mvm_split_members" if tables
                  else "analog_mvm_split_experts" if lead else None))
    return out


def _on_card(name, a_pos):
    if a_pos.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {a_pos.device}")


def int8_codes(store) -> torch.Tensor:
    """A code-operand store's codes as the kernels read them: int8.  The
    fp32 STE codes of a store lowered under autograd hold the same 6-bit
    integers and are cast (a detached copy)."""
    codes = store.codes
    if codes.dtype != torch.int8:
        codes = codes.detach().to(torch.int8).contiguous()
    return codes


def code_operand_ends(codes, col_gain, row_gain, col_blocks, k: int,
                      dev: torch.device, chunk_gain=None,
                      chunk_rows: int = BSS2.signed_rows) -> tuple:
    """Check the int8 code operand of the split tile (``codes [K, N]``,
    ``col_gain [N]`` or None, ``row_gain [G, K]`` or None, ``col_blocks``
    the widths of a column_concat fusion's members, row ``b`` of
    ``row_gain`` serving block ``b``, ``chunk_gain [K / chunk_rows, N]``
    or None) and return the cumulative ends of its column blocks, each
    but the last a multiple of 4 columns."""
    if codes.dtype != torch.int8 or codes.device != dev or \
            not codes.is_contiguous() or codes.shape[0] != k:
        raise ValueError(f"codes must be contiguous int8 [K={k}, N] on "
                         f"{dev}, got {codes.dtype} {tuple(codes.shape)} on "
                         f"{codes.device}")
    n = codes.shape[1]
    if col_gain is not None:
        _build.check_operand("col_gain", col_gain, dev, (n,))
    if chunk_gain is not None:
        _build.check_operand("chunk_gain", chunk_gain, dev,
                             (k // chunk_rows, n))
    blocks = (n,)
    if row_gain is not None:
        if col_blocks is not None:
            blocks = tuple(col_blocks)
            if sum(blocks) != n or len(blocks) > SPLIT_MAX_BLOCKS or any(
                    b % 4 for b in blocks[:-1]):
                raise ValueError(
                    f"col_blocks {blocks} must sum to N={n}, hold at most "
                    f"{SPLIT_MAX_BLOCKS} blocks, and end each but the last "
                    "on a multiple of 4 columns")
        _build.check_operand("row_gain", row_gain, dev, (len(blocks), k))
    ends, acc = [], 0
    for b in blocks:
        acc += b
        ends.append(acc)
    return tuple(ends)


def analog_mvm_split_cuda(
    a_pos: torch.Tensor,                   # [M, K] codes of max(x, 0)
    a_neg: torch.Tensor,                   # [M, K] codes of max(-x, 0)
    w_eff: torch.Tensor,                   # [K, N]
    gain: torch.Tensor,                    # [N]
    chunk_offset: Optional[torch.Tensor],  # [C, N] or None
    *,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
    epilogue=None,                         # None | ("relu_shift", shift)
) -> torch.Tensor:
    """Launch the signed-split analog VMM ``mvm(a_pos) - mvm(a_neg)`` on
    the CUDA device, reading fp32 effective weights.  The activations are
    5-bit codes (integers 0..31)."""
    _on_card("analog_mvm_split_cuda", a_pos)
    _build.check_operand("w_eff", w_eff, a_pos.device,
                         (a_pos.shape[1], w_eff.shape[-1]))
    return _split_launch(1, a_pos, a_neg, w_eff, None, None, None,
                         (w_eff.shape[1],), gain, chunk_offset, chunk_rows,
                         faithful, epilogue)


def analog_mvm_split_codes_cuda(
    a_pos: torch.Tensor,                   # [M, K] codes of max(x, 0)
    a_neg: torch.Tensor,                   # [M, K] codes of max(-x, 0)
    codes: torch.Tensor,                   # [K, N] int8 weight codes
    col_gain: Optional[torch.Tensor],      # [N] or None
    row_gain: Optional[torch.Tensor],      # [G, K] or None
    gain: torch.Tensor,                    # [N]
    chunk_offset: Optional[torch.Tensor],  # [C, N] or None
    *,
    chunk_gain: Optional[torch.Tensor] = None,  # [C, N] or None
    col_blocks: Optional[Sequence[int]] = None,
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
    epilogue=None,                         # None | ("relu_shift", shift)
) -> torch.Tensor:
    """The same VMM reading a :class:`~repro_torch.exec.plan.WeightStore`'s
    int8 codes and gain tables: each weight is rebuilt in registers as
    ``((code * col_gain[n]) * row_gain[block(n), k]) * chunk_gain[c, n]``,
    the store's own ``w_eff``, bit for bit (``chunk_gain`` is the measured
    per-(chunk, column) table of a calibrated bake).  ``col_blocks`` are
    the widths of a column_concat fusion's members (row ``b`` of
    ``row_gain`` serves block ``b``); each block boundary is a multiple of
    4 columns."""
    _on_card("analog_mvm_split_codes_cuda", a_pos)
    ends = code_operand_ends(codes, col_gain, row_gain, col_blocks,
                             a_pos.shape[1], a_pos.device,
                             chunk_gain=chunk_gain, chunk_rows=chunk_rows)
    # form 2 multiplies the chunk_gain table in; form 0 has none to read
    return _split_launch(0 if chunk_gain is None else 2, a_pos, a_neg, codes,
                         col_gain, row_gain, chunk_gain, ends, gain,
                         chunk_offset, chunk_rows, faithful, epilogue)


def analog_mvm_split_experts_cuda(
    a_pos: torch.Tensor,                   # [E, M, K] codes of max(x, 0)
    a_neg: torch.Tensor,                   # [E, M, K] codes of max(-x, 0)
    codes: torch.Tensor,                   # [E, K, N] int8 weight codes
    gain: torch.Tensor,                    # [E, N]
    *,
    post_gain: Optional[torch.Tensor] = None,  # [E, N] or None (fast)
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
) -> torch.Tensor:
    """The split VMM of every matrix of an expert stack in ONE launch (the
    grid's expert axis): expert ``e`` multiplies ``a_pos[e]`` /
    ``a_neg[e]`` by its int8 codes ``codes[e]`` at gain ``gain[e]``, with
    no chunk offsets.  ``post_gain``
    (fast mode only) scales each pass's total before its one rounding;
    the expert products pass their gain there and 1.0 as ``gain``, which
    is the reference's fast product ``clip(rint((a @ w) * gain))``.
    Returns ``[E, M, N]``."""
    _on_card("analog_mvm_split_experts_cuda", a_pos)
    dev = a_pos.device
    if codes.dtype != torch.int8 or codes.device != dev or \
            not codes.is_contiguous() or codes.ndim != 3 or \
            a_pos.ndim != 3 or codes.shape[:2] != (a_pos.shape[0],
                                                   a_pos.shape[2]):
        raise ValueError(
            f"codes must be contiguous int8 [E, K, N] on {dev} matching "
            f"a_pos [E, M, K] {tuple(a_pos.shape)}, got {codes.dtype} "
            f"{tuple(codes.shape)} on {codes.device}")
    return _split_launch(0, a_pos, a_neg, codes, None, None, None,
                         (codes.shape[2],), gain, None, chunk_rows, faithful,
                         None, post_gain=post_gain)


def analog_mvm_split_members_cuda(
    a_pos: torch.Tensor,                   # [G, M, K] codes of max(x, 0)
    a_neg: torch.Tensor,                   # [G, M, K] codes of max(-x, 0)
    w: torch.Tensor,                       # [G, K, N] int8 codes or fp32
    col_gain: Optional[torch.Tensor],      # [G, N] or None
    row_gain: Optional[torch.Tensor],      # [G, 1, K] or None
    gain: torch.Tensor,                    # [G, N]
    chunk_offset: Optional[torch.Tensor],  # [G, C, N] or None
    *,
    chunk_gain: Optional[torch.Tensor] = None,  # [G, C, N] or None
    chunk_rows: int = BSS2.signed_rows,
    faithful: bool = True,
) -> torch.Tensor:
    """The split VMM of every member of a batch_concat group in ONE
    launch (the grid's member axis): member ``g`` multiplies ``a_pos[g]``
    / ``a_neg[g]`` by its own weights at its own gain, chunk offsets and
    gain tables - for int8 codes each weight rebuilt as ``((code *
    col_gain[g, n]) * row_gain[g, 0, k]) * chunk_gain[g, c, n]`` (form 0,
    form 2 with ``chunk_gain``), an fp32 ``w`` read as it is (form 1, a
    store with a full gain map).  Member ``g`` of the result is what the
    2-D launch on member ``g``'s operands gives, bit for bit.  Returns
    ``[G, M, N]``."""
    _on_card("analog_mvm_split_members_cuda", a_pos)
    dev = a_pos.device
    if w.ndim != 3 or a_pos.ndim != 3 or w.device != dev or \
            not w.is_contiguous() or w.shape[:2] != (a_pos.shape[0],
                                                      a_pos.shape[2]):
        raise ValueError(
            f"w must be contiguous [G, K, N] on {dev} matching a_pos "
            f"[G, M, K] {tuple(a_pos.shape)}, got {w.dtype} "
            f"{tuple(w.shape)} on {w.device}")
    g, k, n = w.shape
    if w.dtype == torch.float32:
        if any(t is not None for t in (col_gain, row_gain, chunk_gain)):
            raise ValueError("an fp32 member operand carries its gains in "
                             "w itself")
        form = 1
    elif w.dtype == torch.int8:
        form = 0 if chunk_gain is None else 2
    else:
        raise ValueError(f"member weights must be int8 codes or fp32, got "
                         f"{w.dtype}")
    for name, t, shape in (("col_gain", col_gain, (g, n)),
                           ("row_gain", row_gain, (g, 1, k)),
                           ("chunk_gain", chunk_gain,
                            (g, k // chunk_rows, n))):
        if t is not None:
            _build.check_operand(name, t, dev, shape)
    return _split_launch(form, a_pos, a_neg, w, col_gain, row_gain,
                         chunk_gain, (n,), gain, chunk_offset, chunk_rows,
                         faithful, None, tables=True)
