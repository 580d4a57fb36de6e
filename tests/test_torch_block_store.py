"""The redesigned whole-plan kernels' arithmetic, shown on the CPU.

The CUDA kernels (``csrc/analog_plan_block.cu``, ``csrc/analog_plan.cu``)
run only on the card (tests/test_torch_cuda.py, ``chip_smoke.py``).  What
makes them exact is checked here through the plain versions they mirror:

- the block kernel's weight operand: each layer's ``WeightStore`` (int8
  codes and rank-1 gain tables, a three-member fused QKV with one
  row-gain vector per member, ragged N), its codes rebuilt by
  ``rebuild_w_eff_ref``, feeds the block's plain version to the same
  output, bit for bit, as the ``w_eff`` tensors and the stores
  themselves; that output matches the JAX package's block (Pallas,
  interpret mode) as ``test_torch_block.py::test_block_ref_vs_pallas``
  does;
- the block's split-K plan: each VMM stage's work items cover every
  (column tile, chunk) exactly once, one range per tile in fast mode,
  and fill the cooperative grid once in faithful mode;
- the partial totals of each stage over the plan's chunk ranges, summed
  in a shuffled order, equal the stage's whole VMM (integer-valued
  partials);
- the chain kernel's encode-once: a layer's input block encoded once into
  chunk-padded codes, then the chunked dot (whole, or its chunks cut
  into ranges as at batch 1), equals ``plan_layer_ref`` bit for bit;
- an edited shared header (``csrc/*.cuh``) renames, and so rebuilds, the
  libraries.

Tolerances: bit-exact, except the port's block against the JAX block:
within 1e-5 * max|y| (RMSNorm, RoPE, softmax and SiLU round in another
order in XLA than in PyTorch).
"""
import collections
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import exec as JE  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.kernels.analog_plan import analog_plan_pallas  # noqa: E402
from repro.kernels.analog_plan import default_block_b  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig, analog_linear_init  # noqa: E402
from repro_torch.core.noise import NoiseConfig  # noqa: E402
from repro_torch.core.quant import quantize_act  # noqa: E402
from repro_torch.exec.lower import lower_block, lower_stack  # noqa: E402
from repro_torch.exec.plan import LayerPlan  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.analog_mvm import split_items  # noqa: E402
from repro_torch.kernels.analog_plan import (  # noqa: E402
    block_operand, block_plans)

MODES = ["analog_faithful", "analog_fast"]
# (d_model, heads, kv heads, head_dim, d_ff, batch, seq): the LM smoke
# config's block; ragged N (o and down 68 columns, up|gate 200); three
# chunks per VMM but o (ragged K: 260 and 300 of 384 rows)
GEOMS = {"smoke": (96, 6, 2, 16, 192, 3, 12),
         "ragged": (68, 4, 2, 16, 100, 2, 12),
         "deep": (260, 4, 2, 32, 300, 2, 6)}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jblock(geom, seed=0):
    """One block's parameters from the JAX package's own inits (rank-1
    fixed pattern), RMSNorm scales drawn with numpy."""
    d, h, kvh, hd, dff, _, _ = geom
    k0, k1 = jax.random.split(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return {
        "ln1": {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(d),
                                     jnp.float32)},
        "attn": JA.attention_init(k0, d, h, kvh, hd),
        "ln2": {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(d),
                                     jnp.float32)},
        "mlp": JL.mlp_init(k1, d, dff),
    }


def _plans(geom, mode):
    jp = _jblock(geom)
    d, h, kvh, hd, dff, _, seq = geom
    kw = dict(n_heads=h, n_kv_heads=kvh, head_dim=hd, seq=seq,
              rope_theta=1e4)
    jplan = JE.lower_block(jp, JAnalogConfig(mode=mode, act_calib="static",
                                             use_pallas=True), **kw)
    tplan = lower_block(
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        AnalogConfig(mode=mode, act_calib="static"), **kw)
    return jplan, tplan


def _x(geom, seed=1):
    d, b, seq = geom[0], geom[5], geom[6]
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        (b * seq, d)) * 0.5).astype(np.float32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("geom", list(GEOMS))
def test_block_ref_stores_vs_w_eff_and_pallas(geom, mode):
    jplan, tplan = _plans(GEOMS[geom], mode)
    tm, jm = tplan.mega, jplan.mega
    stores = tm.stores
    assert all(s.gain_map is None and s.col_gain is not None
               and s.row_gain is not None for s in stores)
    n_q = GEOMS[geom][1] * GEOMS[geom][3]
    n_kv = GEOMS[geom][2] * GEOMS[geom][3]
    assert stores[0].col_blocks == (n_q, n_kv, n_kv)
    rebuilt = [ref.rebuild_w_eff_ref(s.codes, s.col_gain, s.row_gain,
                                     s.col_blocks) for s in stores]
    for w, s in zip(rebuilt, stores):
        assert torch.equal(w, s.w_eff)
    faithful = mode == "analog_faithful"
    x = _x(GEOMS[geom])
    kw = dict(faithful=faithful, extras=tm.extras, block=tm.block)
    y_w = ref.analog_plan_ref(x, tm.weights, tm.gain, tm.off, tm.schedule,
                              **kw)
    for weights in (rebuilt, stores):
        assert torch.equal(ref.analog_plan_ref(x, weights, tm.gain, tm.off,
                                               tm.schedule, **kw), y_w)
    b, seq = GEOMS[geom][5], GEOMS[geom][6]
    want = np.asarray(analog_plan_pallas(
        jnp.asarray(x.numpy()), jm.w_cat, jm.gain, jm.off, jm.deq, jm.bias,
        jm.enc, jm.ln, schedule=jm.schedule, faithful=faithful,
        block_b=default_block_b(b, seq), interpret=True, block=jm.block))
    got = _np(y_w)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_block_operand_follows_the_store():
    """A store without a full gain map gives the int8 code operand (form
    0) with one block end per fused member; a store with one, or a
    tensor, gives fp32 w_eff (form 1)."""
    _, tplan = _plans(GEOMS["ragged"], "analog_faithful")
    st, meta = tplan.mega.stores[0], tplan.mega.schedule[0]
    op = block_operand(st, meta.k_pad, meta.n, torch.device("cpu"))
    assert op.form == 0 and op.w is st.codes
    assert op.block_ends == (64, 96, 128)
    op = block_operand(st.w_eff, meta.k_pad, meta.n, torch.device("cpu"))
    assert op.form == 1 and op.w is st.w_eff
    with pytest.raises(ValueError):
        block_operand(st, meta.k_pad + 128, meta.n, torch.device("cpu"))


Meta = collections.namedtuple("Meta", "n n_chunks")
# phi4-mini's four block layers (N, chunks): fused QKV, o, up|gate, down
PHI4 = (Meta(5120, 24), Meta(3072, 24), Meta(16384, 24), Meta(3072, 64))


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("grid", [7, 132, 264, 528])
@pytest.mark.parametrize("rows", [4, 15, 48, 84])
def test_block_split_plan_covers_each_chunk_once(faithful, grid, rows):
    for plan, meta in zip(block_plans(rows, PHI4, faithful, grid), PHI4):
        seen = collections.Counter()
        ranges = collections.defaultdict(int)
        items = list(split_items(plan, meta.n_chunks))
        for tile, group, c0, c1 in items:
            assert 0 <= c0 < c1 <= meta.n_chunks
            ranges[tile, group] += 1
            seen.update((tile, group, c) for c in range(c0, c1))
        assert set(ranges) == {(t, g) for t in range(plan.col_tiles)
                               for g in range(plan.row_groups)}
        assert plan.col_tiles * 128 >= meta.n > (plan.col_tiles - 1) * 128
        assert len(seen) == plan.col_tiles * plan.row_groups * meta.n_chunks
        assert set(seen.values()) == {1}
        if not faithful:
            assert set(ranges.values()) == {1}
        else:
            # one wave: no more items than the grid holds, unless the
            # tiles alone outnumber it
            assert len(items) <= max(grid, len(ranges))
    # at M = 48 on two CTAs per SM: QKV 6 ranges of 4 chunks, o 8 of 3,
    # up|gate 2 of 12, down 11 of 6
    plans = block_plans(48, PHI4, True, 264)
    assert [(p.n_splits, p.chunks_per_cta) for p in plans] == [
        (6, 4), (8, 3), (2, 12), (11, 6)]


@pytest.mark.parametrize("geom", ["smoke", "deep"])
@pytest.mark.parametrize("grid", [7, 132, 528])
def test_block_stage_partials_sum_to_whole(geom, grid):
    """Each VMM stage's partial totals over the plan's chunk ranges (what
    the kernel's work items write to their slots), summed in a shuffled
    order, equal the stage's whole faithful VMM."""
    _, tplan = _plans(GEOMS[geom], "analog_faithful")
    tm = tplan.mega
    x = _x(GEOMS[geom])
    trace = []
    ref.analog_plan_ref(x, tm.stores, tm.gain, tm.off, tm.schedule,
                        extras=tm.extras, block=tm.block, trace=trace)
    plans = block_plans(x.shape[0], tm.schedule, True, grid)
    split_any = False
    for li, (meta, plan) in enumerate(zip(tm.schedule, plans)):
        h, whole = trace[li]
        pad = (0, meta.k_pad - meta.k)
        scale = tm.enc[li, 0]
        a_pos = torch.nn.functional.pad(quantize_act(h[:, :meta.k], scale),
                                        pad)
        a_neg = torch.nn.functional.pad(quantize_act(-h[:, :meta.k], scale),
                                        pad)
        args = (a_pos, a_neg, tm.stores[li].w_eff, tm.gain[li, :meta.n],
                tm.off[meta.c0:meta.c0 + meta.n_chunks, :meta.n])
        ranges = sorted({(c0, c1) for _, _, c0, c1
                         in split_items(plan, meta.n_chunks)})
        split_any |= len(ranges) > 1
        random.Random(li).shuffle(ranges)
        total = torch.zeros_like(whole)
        for c0, c1 in ranges:
            part = ref.split_chunk_range_ref(*args, c0, c1)
            assert torch.equal(part, torch.round(part))
            total = total + part
        assert torch.equal(total, whole), li
    assert split_any


def _chain_layer_encode_once(h, w_l, gain, offs, meta, scale, valid, ways,
                             faithful):
    """The chain kernel's arithmetic for one layer: the input block's
    first ``valid`` columns encoded once (codes as they are for encode
    "codes"), the rest of the chunk-padded block code 0; then the chunked
    dot, whole or - faithful only - as ``ways`` chunk ranges whose
    integer partial totals are summed in order."""
    block = torch.zeros((h.shape[0], meta.k_pad))
    if meta.encode == "codes":
        block[:, :valid] = h[:, :valid]
        pos, neg = block, None
    else:
        pos = block.clone()
        pos[:, :valid] = quantize_act(h[:, :valid], scale)
        neg = block.clone()
        neg[:, :valid] = quantize_act(-h[:, :valid], scale)
        if meta.encode != "split":
            neg = None

    def dot(a, c0, c1):
        rows = slice(c0 * 128, c1 * 128)
        return ref._chunk_adc(a[:, rows], w_l[rows], gain, offs[c0:c1],
                              c1 - c0, 128, faithful)

    def pass_pair(c0, c1):
        y = dot(pos, c0, c1)
        return y - dot(neg, c0, c1) if neg is not None else y

    if ways == 1:
        return pass_pair(0, meta.n_chunks)
    cpw = -(-meta.n_chunks // ways)
    total = torch.zeros((h.shape[0], meta.n))
    for part in range(ways):
        c0, c1 = part * cpw, min(meta.n_chunks, (part + 1) * cpw)
        if c0 < c1:
            total = total + pass_pair(c0, c1)
    return total


@pytest.mark.parametrize("encode", ["codes", "unsigned", "split"])
@pytest.mark.parametrize("faithful", [True, False])
def test_chain_encode_once_equals_plan_layer_ref(encode, faithful):
    g = torch.Generator().manual_seed(11)
    layers = [analog_linear_init(g, k, n, noise=NoiseConfig(mode="full"),
                                 device="cpu") for k, n in ((300, 40),
                                                            (40, 8))]
    signed = "split" if encode == "split" else "none"
    plan = lower_stack(layers, AnalogConfig(act_calib="static",
                                            signed_input=signed),
                       input_domain="codes" if encode == "codes" else "float",
                       epilogues=["none", "none"])
    lp: LayerPlan = plan.layers[0]
    meta = plan.mega.schedule[0]
    assert meta.encode == encode and meta.n_chunks == 3
    rng = np.random.default_rng(3)
    if encode == "codes":
        h = torch.from_numpy(rng.integers(0, 32, (5, 384)).astype(
            np.float32))
        h[:, 300:] = 0.0
        valid = 384
    else:
        h = torch.from_numpy(rng.standard_normal((5, 300)).astype(
            np.float32))
        valid = 300
    scale = None if encode == "codes" else lp.a_scale
    want = ref.plan_layer_ref(h, lp.w_eff, lp.gain_row,
                              lp.chunk_offset, meta, scale,
                              faithful=faithful)
    for ways in ((1, 2, 3) if faithful else (1,)):
        got = _chain_layer_encode_once(h, lp.w_eff, lp.gain_row,
                                       lp.chunk_offset, meta, scale, valid,
                                       ways, faithful)
        assert torch.equal(got, want), ways


def test_edited_header_rebuilds(tmp_path, monkeypatch):
    """A library's name hashes its source and every shared header, so an
    edited ``csrc/*.cuh`` rebuilds the kernels that include it."""
    from repro_torch.kernels import _build

    (tmp_path / "analog_plan_block.cu").write_text('#include "tile.cuh"\n')
    header = tmp_path / "tile.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("analog_plan_block")
    assert _build.library_path("analog_plan_block") == before
    header.write_text("// two\n")
    assert _build.library_path("analog_plan_block") != before
