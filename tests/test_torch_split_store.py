"""The split kernel's redesigned arithmetic, shown on the CPU.

The CUDA kernel (``csrc/analog_mvm_split.cu``) runs only on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``).  What makes it exact is
checked here through the plain versions it mirrors:

- the int8 code operand: the weights rebuilt from a lowered
  ``WeightStore``'s codes and gain tables equal the store's ``w_eff`` bit
  for bit (no gain, column gains only, row gains only, both, and a
  three-member column_concat store with one row-gain vector per member),
  and the VMM on them equals the split's plain version on ``w_eff``;
- split-K: the faithful partial totals of the chunk ranges the launch
  geometry (``split_plan``) cuts, summed in a shuffled order, equal the
  chunk scan of the CPU route and the JAX package's Pallas split kernel in
  interpret mode, bit for bit (integer-valued partials);
- the tensor-core operand: the 3-piece bf16 cut of an fp32 weight sums
  back to it exactly, and each piece is a bf16 value.

Tolerance: bit-exact throughout, including rank-1 float gains (the
partial totals are sums of the same per-chunk ADC codes).
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.analog_mvm import analog_mvm_split_pallas  # noqa: E402

from repro_torch.core.analog import AnalogConfig, analog_linear_init  # noqa: E402
from repro_torch.core.noise import NoiseConfig  # noqa: E402
from repro_torch.exec.lower import lower_fused, lower_layer  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.analog_mvm import (  # noqa: E402
    SPLIT_BN, analog_mvm_split_codes_cuda, split_plan, split_tile_rows)

ACFG = AnalogConfig(mode="analog_faithful")


def _layer(seed, k, n, noise):
    return analog_linear_init(torch.Generator().manual_seed(seed), k, n,
                              noise=noise, device="cpu")


def _codes(seed, m, k):
    rng = np.random.default_rng(seed)
    a_pos = rng.integers(0, 32, (m, k)).astype(np.float32)
    a_neg = rng.integers(0, 32, (m, k)).astype(np.float32)
    a_neg[a_pos > 15] = 0.0
    return torch.from_numpy(a_pos), torch.from_numpy(a_neg)


def _drop(params, key):
    p = dict(params)
    p["fpn"] = {k: v for k, v in params["fpn"].items()  # verify: allow-fpn-access
                if k != key}
    return p


# (name, how the fixed pattern is cut down): no gain table, column gains
# only, row gains only, both (phi4-mini's rank-1 pattern)
STORE_KINDS = {
    "no_gain": lambda p: _drop(_drop(p, "row_gain"), "col_gain"),
    "col_gain": lambda p: _drop(p, "row_gain"),
    "row_gain": lambda p: _drop(p, "col_gain"),
    "both": lambda p: p,
}


@pytest.mark.parametrize("kind", list(STORE_KINDS))
@pytest.mark.parametrize("k,n", [(200, 70), (384, 130)])
def test_code_operand_rebuilds_w_eff(kind, k, n):
    lp = lower_layer(STORE_KINDS[kind](_layer(k + n, k, n, NoiseConfig())),
                     ACFG)
    st = lp.store
    assert st.gain_map is None
    assert (st.col_gain is None) == (kind in ("no_gain", "row_gain"))
    assert (st.row_gain is None) == (kind in ("no_gain", "col_gain"))
    w = ref.rebuild_w_eff_ref(st.codes, st.col_gain, st.row_gain,
                              st.col_blocks)
    assert torch.equal(w, st.w_eff)
    a_pos, a_neg = _codes(k, 5, lp.k_pad)
    for faithful in (True, False):
        got = ref.analog_mvm_split_codes_ref(
            a_pos, a_neg, st.codes, st.col_gain, st.row_gain, lp.gain_row,
            lp.chunk_offset, col_blocks=st.col_blocks, faithful=faithful)
        want = ref.analog_mvm_split_ref(a_pos, a_neg, st.w_eff, lp.gain_row,
                                        lp.chunk_offset, faithful=faithful)
        assert torch.equal(got, want)


def test_code_operand_rebuilds_fused_qkv_w_eff():
    """A column_concat store of three members (q, k, v of a GQA
    attention): one row-gain vector per member, split by col_blocks."""
    members = [_layer(i, 96, n, NoiseConfig()) for i, n in
               enumerate((96, 32, 32))]
    fused = lower_fused(members, ACFG)
    st = fused.store
    assert st.col_blocks == (96, 32, 32)
    assert tuple(st.row_gain.shape) == (3, fused.k_pad)
    w = ref.rebuild_w_eff_ref(st.codes, st.col_gain, st.row_gain,
                              st.col_blocks)
    assert torch.equal(w, st.w_eff)
    a_pos, a_neg = _codes(7, 6, fused.k_pad)
    got = ref.analog_mvm_split_codes_ref(
        a_pos, a_neg, st.codes, st.col_gain, st.row_gain, fused.gain_row,
        fused.chunk_offset, col_blocks=st.col_blocks)
    assert torch.equal(got, ref.analog_mvm_split_ref(
        a_pos, a_neg, st.w_eff, fused.gain_row, fused.chunk_offset))


def _split_args(m, k, n, seed):
    params = _layer(seed, k, n, NoiseConfig(gain_std=0.05))
    lp = lower_layer(params, ACFG)
    a_pos, a_neg = _codes(seed, m, lp.k_pad)
    return a_pos, a_neg, lp.w_eff, lp.gain_row, lp.chunk_offset


# (M, K, N, resident CTAs): the decode and prefill row tilings, chunk
# counts the split factor does not divide (5 = 3 + 2, 7 = 3 + 3 + 1,
# 8 = 3 + 3 + 2, 3 = 2 + 1), wide N
@pytest.mark.parametrize("m,k,n,slots", [(4, 640, 70, 2), (48, 896, 300, 9),
                                         (1, 1024, 3000, 72),
                                         (17, 384, 10, 2)])
def test_split_k_partials_combine_exactly(m, k, n, slots):
    args = _split_args(m, k, n, m + k + n)
    n_chunks = k // 128
    plan = split_plan(m, n, n_chunks, True, slots)
    ranges = [(s * plan.chunks_per_cta,
               min(n_chunks, (s + 1) * plan.chunks_per_cta))
              for s in range(plan.n_splits)]
    assert plan.n_splits > 1 and ranges[-1][1] == n_chunks
    assert n_chunks % plan.chunks_per_cta
    random.Random(m).shuffle(ranges)
    total = torch.zeros((m, n))
    for c0, c1 in ranges:
        total = total + ref.split_chunk_range_ref(*args, c0, c1)
    assert torch.equal(total, ref.split_chunk_scan_ref(*args,
                                                      chunk_rows=128))
    want = analog_mvm_split_pallas(*(jnp.asarray(t.numpy()) for t in args),
                                   faithful=True, interpret=True)
    np.testing.assert_array_equal(total.numpy(), np.asarray(want))


def test_split_plan_geometry():
    """Rows: 8 per m16 tile, every row covered; fast mode walks all
    chunks in one CTA; faithful ranges cover every chunk once, in as few
    ranges as keep one wave of CTAs on the card."""
    for m in (1, 4, 8, 9, 16, 17, 24, 25, 48, 49, 65):
        plan = split_plan(m, 3072, 64, True, 528)
        assert plan.mt == split_tile_rows(m)
        assert plan.row_groups * 8 * plan.mt >= m
        assert (plan.row_groups - 1) * 8 * plan.mt < m
        assert split_plan(m, 3072, 64, False, 528).n_splits == 1
    assert split_plan(48, 3072, 24, True, 264).row_groups == 1
    for n_chunks in (1, 2, 3, 5, 24, 64):
        for slots in (132, 528):
            plan = split_plan(4, 3072, n_chunks, True, slots)
            assert plan.col_tiles == -(-3072 // SPLIT_BN)
            assert (plan.n_splits - 1) * plan.chunks_per_cta < n_chunks
            assert plan.n_splits * plan.chunks_per_cta >= n_chunks
            assert plan.n_splits * plan.col_tiles <= max(slots,
                                                         plan.col_tiles)
    # phi4-mini decode at 4 CTAs per SM: down (24 tiles, 64 chunks) in 22
    # ranges of 3 chunks; the lm_head (1563 tiles) needs no split
    down = split_plan(4, 3072, 64, True, 528)
    assert (down.chunks_per_cta, down.n_splits) == (3, 22)
    assert split_plan(4, 200064, 24, True, 528).n_splits == 1


def test_bf16_three_piece_split_is_exact():
    g = torch.Generator().manual_seed(0)
    codes = torch.randint(-63, 64, (512, 300), generator=g).float()
    col = 1 + 0.014 * torch.randn((300,), generator=g)
    row = 1 + 0.014 * torch.randn((512, 1), generator=g)
    w = (codes * col) * row
    w[0, :4] = torch.tensor([0.0, -0.0, 63.0, -63.0])
    hi, mid, lo = ref.bf16_split3_ref(w)
    assert torch.equal(hi + mid + lo, w)
    assert torch.equal((hi + mid) + lo, w)
    for piece in (hi, mid, lo):
        assert torch.equal(piece.to(torch.bfloat16).to(torch.float32), piece)
    # integer weights are their own top piece
    hi, mid, lo = ref.bf16_split3_ref(codes)
    assert torch.equal(hi, codes)
    assert not mid.any() and not lo.any()
    # a 5-bit code times a piece is exact in fp32: 5 + 8 significant bits
    a = torch.arange(32, dtype=torch.float32)[:, None]
    for piece in ref.bf16_split3_ref(w[:8].reshape(1, -1)):
        prod = a * piece
        assert torch.equal(prod.double(), a.double() * piece.double())


def test_cpu_route_ignores_the_store():
    """On the CPU the dispatching wrapper runs the plain version on
    ``w_eff`` whatever store it is handed."""
    lp = lower_layer(_layer(3, 256, 40, NoiseConfig()), ACFG)
    a_pos, a_neg = _codes(3, 4, lp.k_pad)
    args = (a_pos, a_neg, lp.w_eff, lp.gain_row, lp.chunk_offset)
    for faithful in (True, False):
        assert torch.equal(
            ops.analog_mvm_split(*args, faithful=faithful, store=lp.store),
            ops.analog_mvm_split(*args, faithful=faithful))


def test_code_operand_wrapper_refuses_cpu_tensors():
    lp = lower_layer(_layer(4, 128, 8, NoiseConfig()), ACFG)
    a_pos, a_neg = _codes(4, 2, lp.k_pad)
    st = lp.store
    with pytest.raises(ValueError, match="CUDA"):
        analog_mvm_split_codes_cuda(a_pos, a_neg, st.codes, st.col_gain,
                                    st.row_gain, lp.gain_row, lp.chunk_offset)
