"""RWKV-6 in the port against the JAX package, on the CPU: the
recurrence, the time-mix and channel-mix blocks, the r/k/v/g
``batch_concat`` group (``lower_batch_concat`` + ``run_batch_concat``)
against its four solo dispatches and against the reference's group, the
compiled block, the rwkv6-7b SMOKE LM and ``ServeEngine``.

Parameters come from the reference's draw (``convert.params_from_numpy``);
activations are fp32.  Tolerances:

- ``_token_shift``: exact.  ``wkv_scan``: within 1e-5 x max|out| (the
  64-term contractions sum in another order).
- the group against the solo dispatches, in the port: bit-exact, under
  dynamic and static activation calibration, faithful and fast, on
  integer rank-1 tables with integer chunk offsets (integer ``w_eff``:
  every chunk sum exact) and on the float rank-1 fixed pattern; against
  the reference's group on integer tables: bit-exact.
- blocks against the reference: within 1e-4 x max|output| (the LoRA
  decay's tanh / exp and the group norm round differently in the two
  frameworks).
- LMs against the reference: digital mode within 1e-4 x max|logit|.  In
  analog mode the LayerNorm's mean and rsqrt differ by an ulp between
  XLA and PyTorch on the CPU (on a third of the elements), and where that
  ulp meets a rounding tie of a 5-bit activation code the code flips and
  moves the row's later logits by a few percent: within TIE_REL x
  max|logit| (0.1), equal greedy tokens; ``lm_loss`` within 1e-3
  relative (1e-5 in digital mode).
- a prefill then decode steps against the whole sequence, in the port:
  exact at static calibration (dynamic scales depend on the call's
  tokens).
- bf16 activations over an fp32 cache (digital): the cache leaves'
  dtypes equal the reference's, their values within 1e-2 x max and the
  logits within 2e-2 x max (bf16 keeps 8 significand bits).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.analog import analog_linear_init as janalog_linear_init  # noqa: E402
from repro.core.noise import NoiseConfig as JNoiseConfig  # noqa: E402
from repro.exec.plan import GroupPlan as JGroupPlan  # noqa: E402
from repro.exec.lower import lower_batch_concat as jlower_batch_concat  # noqa: E402
from repro.exec.run import run_batch_concat as jrun_batch_concat  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.obs.energy import energy_report as jenergy_report  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.serve_step import make_serve_steps as jmake_serve_steps  # noqa: E402

from repro_torch import api, calib, configs  # noqa: E402
from repro_torch.calib.snapshot import (CalibrationSnapshot,  # noqa: E402
                                        LayerCalibration)
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.exec.lower import lower_batch_concat, lower_layer  # noqa: E402
from repro_torch.exec.plan import GroupPlan, PlanStack  # noqa: E402
from repro_torch.exec.run import (dispatch_count, reset_dispatch_count,  # noqa: E402
                                  run_batch_concat, run_group, run_layer)
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs.energy import energy_report  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import make_serve_steps  # noqa: E402

ARCH = "rwkv6-7b"
NAMES = ("wr", "wk", "wv", "wg")
D, HEADS = 64, 4
B, S = 2, 6
REL = 1e-4
TIE_REL = 0.1


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _cfgs(mode="analog_faithful", act_calib="dynamic"):
    return (JAnalogConfig(mode=mode, act_calib=act_calib),
            AnalogConfig(mode=mode, act_calib=act_calib))


def _x(seed, shape=(B, S, D), scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


@functools.lru_cache(maxsize=None)
def _members(integer: bool):
    """Four same-geometry analog layers (the reference's draw, rank-1
    fixed pattern and chunk offsets); ``integer``: rank-1 tables of
    integers 1..2 and integer offsets, so every ``w_eff`` is an integer.
    Their static ``a_scale`` differ by member."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(4):
        p = jax.tree.map(np.asarray, janalog_linear_init(
            jax.random.PRNGKey(i), D, D, noise=JNoiseConfig()))
        p["a_scale"] = np.float32(p["a_scale"] * (1 + 0.5 * i))
        if integer:
            fpn = p["fpn"]
            fpn["col_gain"] = rng.integers(1, 3, D).astype(np.float32)
            fpn["row_gain"] = rng.integers(1, 3, D).astype(np.float32)
            fpn["chunk_offset"] = rng.integers(
                -2, 3, fpn["chunk_offset"].shape).astype(np.float32)
        out.append(p)
    return out


@functools.lru_cache(maxsize=None)
def _block():
    """One time-mix block and one channel mix, the reference's draw."""
    jp = JR.rwkv_init(jax.random.PRNGKey(3), D, HEADS)
    jc = JR.channel_mix_init(jax.random.PRNGKey(4), D, 2 * D)
    # a nonzero token-shift mix and current-token bonus exercise both
    jc = {**jc, "mu_k": jnp.full((D,), 0.3)}
    jp = {**jp, "u": jax.random.normal(jax.random.PRNGKey(5), (HEADS,
                                                               D // HEADS))}
    np_p = jax.tree.map(np.asarray, {"tmix": jp, "cmix": jc})
    return np_p, params_from_numpy(np_p, "cpu")


# ------------------------------------------------------------- recurrence
def test_token_shift_and_lerp():
    x, prev = _x(1), _x(2, (B, D))
    got = R._token_shift(torch.from_numpy(x), torch.from_numpy(prev))
    want = JR._token_shift(jnp.asarray(x), jnp.asarray(prev))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    mu = _x(3, (D,))
    np.testing.assert_array_equal(
        _np(R._lerp(torch.from_numpy(x), got, torch.from_numpy(mu))),
        np.asarray(JR._lerp(jnp.asarray(x), want, jnp.asarray(mu))))


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_scan(with_state):
    rng = np.random.default_rng(4)
    shape = (B, S, HEADS, D // HEADS)
    r, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.2, 0.99, shape).astype(np.float32)
    u = rng.standard_normal(shape[2:]).astype(np.float32)
    s0 = (rng.standard_normal((B, HEADS, D // HEADS, D // HEADS))
          .astype(np.float32) if with_state else
          np.zeros((B, HEADS, D // HEADS, D // HEADS), np.float32))
    jy, js = JR.wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    ty, ts = R.wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)))
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("mode", ["digital", "analog_faithful"])
def test_rwkv_apply_and_channel_mix(mode):
    np_p, tp = _block()
    jp = jax.tree.map(jnp.asarray, np_p)
    jacfg, acfg = _cfgs(mode)
    x = _x(6)
    jy, jc = JR.rwkv_apply(jp["tmix"], jnp.asarray(x), acfg=jacfg,
                           n_heads=HEADS)
    ty, tc = R.rwkv_apply(tp["tmix"], torch.from_numpy(x), acfg=acfg,
                          n_heads=HEADS)
    _close(ty, jy)
    _close(tc["state"], jc["state"])
    np.testing.assert_array_equal(_np(tc["x_prev"]), np.asarray(jc["x_prev"]))
    # the decode step from the prefill's cache
    x2 = _x(7, (B, 1, D))
    jy2, _ = JR.rwkv_apply(jp["tmix"], jnp.asarray(x2), acfg=jacfg,
                           n_heads=HEADS, cache=jc)
    ty2, _ = R.rwkv_apply(tp["tmix"], torch.from_numpy(x2), acfg=acfg,
                          n_heads=HEADS, cache=tc)
    _close(ty2, jy2)
    jy, jc = JR.channel_mix_apply(jp["cmix"], jnp.asarray(x), acfg=jacfg)
    ty, tc = R.channel_mix_apply(tp["cmix"], torch.from_numpy(x), acfg=acfg)
    _close(ty, jy)
    jy2, _ = JR.channel_mix_apply(jp["cmix"], jnp.asarray(x2), acfg=jacfg,
                                  cache=jc)
    ty2, _ = R.channel_mix_apply(tp["cmix"], torch.from_numpy(x2), acfg=acfg,
                                 cache=tc)
    _close(ty2, jy2)


@pytest.mark.parametrize("mode", ["digital", "analog_faithful"])
def test_prefill_then_decode_equals_the_whole_sequence(mode):
    """Static calibration (dynamic scales depend on the call's tokens):
    a 4-token prefill and two 1-token steps give the 6-token call's
    outputs, bit for bit, in both blocks."""
    _, tp = _block()
    acfg = AnalogConfig(mode=mode, act_calib="static")
    x = torch.from_numpy(_x(8))
    for fn, p, kw in ((R.rwkv_apply, tp["tmix"], {"n_heads": HEADS}),
                      (R.channel_mix_apply, tp["cmix"], {})):
        whole, _ = fn(p, x, acfg=acfg, **kw)
        parts, cache = [], None
        for sl in (slice(0, 4), slice(4, 5), slice(5, 6)):
            y, cache = fn(p, x[:, sl], acfg=acfg, cache=cache, **kw)
            parts.append(y)
        np.testing.assert_array_equal(_np(torch.cat(parts, 1)), _np(whole))


# ---------------------------------------------------------- batch_concat
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("mode", ["analog_faithful", "analog_fast"])
@pytest.mark.parametrize("act_calib", ["dynamic", "static"])
def test_group_bit_exact_vs_solo_dispatches(integer, mode, act_calib):
    """ONE batch_concat dispatch equals the four solo dispatches bit for
    bit (each member encodes at its own scale), and counts one."""
    _, acfg = _cfgs(mode, act_calib)
    ps = [params_from_numpy(p, "cpu") for p in _members(integer)]
    xs = [torch.from_numpy(_x(20 + i, scale=0.2 + 0.1 * i)) for i in range(4)]
    gp = GroupPlan("batch_concat", lower_batch_concat(ps, acfg), NAMES,
                   (D,) * 4)
    assert tuple(gp.fused.store.codes.shape) == (4, 128, D)
    assert tuple(gp.fused.chunk_offset.shape) == (4, 1, D)
    assert tuple(gp.fused.store.row_gain.shape) == (4, 1, 128)
    reset_dispatch_count()
    got = run_batch_concat(gp, xs, acfg)
    assert dispatch_count() == 1
    reset_dispatch_count()
    want = [run_layer(lower_layer(p, acfg), x, acfg) for p, x in zip(ps, xs)]
    assert dispatch_count() == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    # run_group dispatches the kind
    for g, w in zip(run_group(gp, xs, acfg), want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("act_calib", ["dynamic", "static"])
def test_group_bit_exact_vs_the_reference_group(act_calib):
    jacfg, acfg = _cfgs(act_calib=act_calib)
    jps, tps = zip(*(_both(p) for p in _members(True)))
    xs = [_x(30 + i, scale=0.2 + 0.1 * i) for i in range(4)]
    jgp = JGroupPlan("batch_concat", jlower_batch_concat(list(jps), jacfg),
                     NAMES, (D,) * 4)
    gp = GroupPlan("batch_concat", lower_batch_concat(list(tps), acfg),
                   NAMES, (D,) * 4)
    want = jrun_batch_concat(jgp, [jnp.asarray(x) for x in xs], jacfg)
    got = run_batch_concat(gp, [torch.from_numpy(x) for x in xs], acfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_noisy_group_replays_member_by_member_as_one_dispatch():
    """Readout noise: the members replay through run_layer in member
    order, one draw each from the same generator; one dispatch."""
    acfg = AnalogConfig(deterministic=False)
    ps = [params_from_numpy(p, "cpu") for p in _members(False)]
    xs = [torch.from_numpy(_x(40 + i)) for i in range(4)]
    gp = GroupPlan("batch_concat", lower_batch_concat(ps, acfg), NAMES,
                   (D,) * 4)
    reset_dispatch_count()
    got = run_batch_concat(gp, xs, acfg, noise=torch.Generator().manual_seed(1))
    assert dispatch_count() == 1
    gen = torch.Generator().manual_seed(1)
    for g, p, x in zip(got, ps, xs):
        np.testing.assert_array_equal(
            _np(g), _np(run_layer(lower_layer(p, acfg), x, acfg, noise=gen)))


def test_group_differentiates_as_its_solo_dispatches():
    """Under autograd the group is still ONE dispatch, and its HIL
    backward (the 2-D split pair's, batched over the members) gives the
    four solo dispatches' gradients: the inputs' and the masters'."""
    acfg = AnalogConfig()
    ps_np = _members(True)
    out = {}
    for fused in (True, False):
        ps = [{k: (v.clone().requires_grad_(True) if k == "w" else v)
               for k, v in params_from_numpy(p, "cpu").items()}
              for p in ps_np]
        xs = [torch.from_numpy(_x(50 + i)).requires_grad_()
              for i in range(4)]
        reset_dispatch_count()
        if fused:
            gp = GroupPlan("batch_concat", lower_batch_concat(ps, acfg),
                           NAMES, (D,) * 4)
            ys = run_batch_concat(gp, xs, acfg)
            assert dispatch_count() == 1
        else:
            ys = [run_layer(lower_layer(p, acfg), x, acfg)
                  for p, x in zip(ps, xs)]
        loss = sum((y * (i + 1)).sum() for i, y in enumerate(ys))
        out[fused] = torch.autograd.grad(loss, xs + [p["w"] for p in ps])
    for a, b in zip(out[True], out[False]):
        assert bool(b.abs().max() > 0)
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))


# ------------------------------------------------------- compiled blocks
def _tmix():
    np_p, tp = _block()
    return jax.tree.map(jnp.asarray, np_p["tmix"]), tp["tmix"]


def test_rwkv_replays_as_one_dispatch():
    """r/k/v/g 4 -> 1 through the module spec, bit-exact against the
    per-layer block, and within tolerance of the reference's compiled
    block."""
    jp, tp = _tmix()
    jacfg, acfg = _cfgs()
    x = _x(9)
    reset_dispatch_count()
    want, _ = R.rwkv_apply(tp, torch.from_numpy(x), acfg=acfg, n_heads=HEADS)
    n_solo = dispatch_count()
    model = api.compile(R.rwkv_module_spec(D, HEADS), tp, acfg, device="cpu")
    reset_dispatch_count()
    got, _ = model.apply(torch.from_numpy(x))
    assert (n_solo, dispatch_count()) == (5, 2)
    np.testing.assert_array_equal(_np(got), _np(want))
    jgot, _ = japi.compile(JR.rwkv_module_spec(D, HEADS), jp,
                           jacfg).apply(jnp.asarray(x))
    _close(got, jgot)


def test_group_calibrated_static_matches_solo():
    """share_group_input_scale over a batch_concat group: one shared
    input LSB, bit-exact against solo members lowered from the same
    snapshot."""
    _, tp = _tmix()
    static = AnalogConfig(act_calib="static")
    snap = calib.share_group_input_scale(
        CalibrationSnapshot(), list(NAMES),
        scales=[tp[n]["a_scale"] * (1 + i) for i, n in enumerate(NAMES)])
    x = torch.from_numpy(_x(10))
    model = api.compile(R.rwkv_module_spec(D, HEADS), tp, static,
                        calibration=snap, device="cpu")
    gp = model.group_plan("rkvg")
    assert gp.fused.a_scale_in is not None
    got, _ = model.apply(x)
    per_layer = {k: (dict(v, _plan=lower_layer(v, static,
                                                calib=snap.layer(k)))
                     if k in NAMES else v) for k, v in tp.items()}
    want, _ = R.rwkv_apply(per_layer, x, acfg=static, n_heads=HEADS)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_cfg_mismatch_falls_back_to_solo():
    _, tp = _tmix()
    acfg = AnalogConfig()
    lowered = api.compile(R.rwkv_module_spec(D, HEADS), tp, acfg,
                          device="cpu").lower()          # bakes "split"
    none = AnalogConfig(signed_input="none")
    x = torch.from_numpy(np.abs(_x(11)))
    got, _ = R.rwkv_apply(lowered, x, acfg=none, n_heads=HEADS)
    want, _ = R.rwkv_apply(tp, x, acfg=none, n_heads=HEADS)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("kind,fused", [("batch_concat", True),
                                        ("column_concat", False)])
def test_group_under_another_name(kind, fused):
    """Consumers resolve the group by kind and members: a batch_concat
    group under any name replays fused; a column_concat group over the
    same members is never fed to the batch_concat replay."""
    _, tp = _tmix()
    acfg = AnalogConfig()
    spec = R.rwkv_module_spec(D, HEADS)
    renamed = dataclasses.replace(
        spec, layers=tuple(dataclasses.replace(l, group=None)
                           for l in spec.layers),
        groups=(api.GroupSpec("projections", kind, NAMES),))
    x = torch.from_numpy(_x(12))
    model = api.compile(renamed, tp, acfg, device="cpu")
    reset_dispatch_count()
    got, _ = model.apply(x)
    assert dispatch_count() == (2 if fused else 5)
    want, _ = R.rwkv_apply(tp, x, acfg=acfg, n_heads=HEADS)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_spec_validates_batch_concat_geometry():
    with pytest.raises(ValueError, match="weight geometry"):
        api.ModuleSpec(
            "bad", kind="tree",
            layers=(api.LayerSpec("a", 64, 64), api.LayerSpec("b", 64, 32)),
            groups=(api.GroupSpec("g", "batch_concat", ("a", "b")),))


def test_drift_swap_covers_batch_concat_groups():
    """with_calibration stacks the members' offset tables member-wise
    into the group; only chunk_offset leaves change."""
    _, tp = _tmix()
    model = api.compile(R.rwkv_module_spec(D, HEADS), tp, AnalogConfig(),
                        device="cpu")
    gp = model.group_plan("rkvg")
    c = gp.fused.chunk_offset.shape[-2]
    rng = np.random.default_rng(13)
    tables = {n: rng.standard_normal((c, D)).astype(np.float32) * 0.1
              for n in NAMES}
    snap = CalibrationSnapshot()
    for n in NAMES:
        snap = snap.with_layer(n, LayerCalibration(
            chunk_offset=torch.from_numpy(tables[n])))
    sgp = model.with_calibration(snap).group_plan("rkvg")
    np.testing.assert_array_equal(
        _np(sgp.fused.chunk_offset), np.stack([tables[n] for n in NAMES]))
    assert sgp.fused.store is gp.fused.store
    for f in dataclasses.fields(gp.fused):
        if f.name not in ("chunk_offset", "store"):
            a, b = getattr(gp.fused, f.name), getattr(sgp.fused, f.name)
            assert a is b or a == b, f.name


# -------------------------------------------------------------------- LM
def _runs(mode="analog_faithful"):
    return (JRunConfig(analog=JAnalogConfig(mode=mode),
                       activation_dtype="float32"),
            RunConfig(analog=AnalogConfig(mode=mode),
                      activation_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _lm():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jp = JT.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jrun, run = _runs()
    jm = japi.compile(JT.lm_module_spec(jcfg, jp), jp, jrun)
    tm = api.compile(T.lm_module_spec(cfg, tp), tp, run, device="cpu")
    return jcfg, cfg, jp, tp, jm, tm


def _tokens(cfg, seed, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s))


def test_configs_copy_the_reference():
    for get, jget in ((configs.get_arch, jconfigs.get_arch),
                      (configs.get_smoke, jconfigs.get_smoke)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(
            jget(ARCH))
    full = configs.get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.d_ff,
            full.vocab_size, full.block) == (32, 4096, 64, 14336, 65536,
                                             "rwkv")


def test_params_carry_across():
    """``convert.params_from_numpy`` carries every leaf of the reference's
    RWKV LM tree (``tm.mu_*``, ``w0``, ``u``, ``w_lora_*``, the channel
    mix, the fixed pattern) across, and ``lm_init`` draws the same
    layout."""
    _, cfg, jp, tp, _, _ = _lm()
    ours = T.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(jax.tree.leaves(tp)) == len(
        jax.tree.leaves(ours))
    for path, leaf in jleaves:
        node_t, node_o = tp, ours
        for k in path:
            node_t, node_o = node_t[k.key], node_o[k.key]
        np.testing.assert_array_equal(_np(node_t), np.asarray(leaf))
        assert tuple(node_o.shape) == tuple(np.shape(leaf))
    tm = tp["layers"]["l0"]["rwkv"]
    np.testing.assert_array_equal(_np(tm["w0"]), -2.0)
    np.testing.assert_array_equal(_np(tm["u"]), 0.0)
    assert tuple(tm["w_lora_a"].shape[-1:]) == (R.LORA_RANK,)
    np.testing.assert_array_equal(_np(tp["layers"]["l0"]["cmix"]["mu_k"]),
                                  0.0)


def test_lm_tree_groups_through_the_stack():
    """The scan-stacked r/k/v/g lower into a PlanStack of member-axis
    group plans, the fused members without per-layer plans."""
    _, cfg, _, _, _, tm = _lm()
    node = tm.lower()["layers"]["l0"]["rwkv"]
    gp = node["_groups"]["rkvg"]
    assert isinstance(gp, PlanStack) and len(gp) == T.n_groups(cfg)
    assert gp[0].fused.store.codes.ndim == 3
    assert "_plan" not in node["wr"] and "_plan" in node["wo"]


@pytest.mark.parametrize("mode", ["analog_faithful", "digital"])
def test_lm_apply_logits(mode):
    jcfg, cfg, jp, tp, jm, tm = _lm()
    jrun, run = _runs(mode)
    toks = _tokens(cfg, 1)
    if mode == "digital":
        jl, _, _ = JT.lm_apply(jp, {"tokens": jnp.asarray(toks)}, jcfg, jrun)
        tl, _, _ = T.lm_apply(tp, {"tokens": torch.from_numpy(toks)}, cfg,
                              run)
    else:
        jl, _, _ = JT.lm_apply(jm.lower(), {"tokens": jnp.asarray(toks)},
                               jcfg, jrun)
        reset_dispatch_count()
        tl, _, _ = T.lm_apply(tm.lower(), {"tokens": torch.from_numpy(toks)},
                              cfg, run)
        # per layer: r/k/v/g, wo, the channel mix's two; then the lm_head
        assert dispatch_count() == 4 * cfg.n_layers + 1
    _close(tl, jl, REL if mode == "digital" else TIE_REL)
    np.testing.assert_array_equal(_np(tl).argmax(-1), np.asarray(jl).argmax(-1))


@pytest.mark.parametrize("mode", ["analog_faithful", "digital"])
def test_lm_loss(mode):
    jcfg, cfg, jp, tp, _, _ = _lm()
    jrun, run = _runs(mode)
    toks, labels = _tokens(cfg, 2), _tokens(cfg, 3)
    jloss, jmet = JT.lm_loss(jp, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)}, jcfg, jrun)
    with torch.no_grad():
        loss, met = T.lm_loss(tp, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)},
                              cfg, run)
    rtol = 1e-5 if mode == "digital" else 1e-3
    np.testing.assert_allclose(float(met["nll"]), float(jmet["nll"]),
                               rtol=rtol)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)


def test_serve_steps_with_a_cache():
    """A [2, 6] prefill and three greedy decode steps through both
    packages' make_serve_steps on the compiled trees (fp32 caches)."""
    jcfg, cfg, _, _, jm, tm = _lm()
    jrun, run = _runs()
    jpre, jdec = jmake_serve_steps(jcfg, jrun)
    tpre, tdec = make_serve_steps(cfg, run)
    jc = JT.init_lm_cache(jcfg, B, 16, dtype=jnp.float32)
    tc = T.init_lm_cache(cfg, B, 16, dtype=torch.float32, device="cpu")
    toks = _tokens(cfg, 4)
    jl, jc = jpre(jm.lower(), {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = tpre(tm.lower(), {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl, TIE_REL)
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1)
        np.testing.assert_array_equal(_np(tl).argmax(-1), nxt)
        jl, jc = jdec(jm.lower(), jnp.asarray(nxt[:, None]), jc)
        tl, tc = tdec(tm.lower(), torch.from_numpy(nxt[:, None]), tc)
        _close(tl, jl, TIE_REL)
    _close(tc["layers"]["l0"]["tmix"]["state"],
           jc["layers"]["l0"]["tmix"]["state"], TIE_REL)
    assert tc["step"] == int(jc["step"]) == S + 3


def test_prefill_then_decode_equals_the_whole_sequence_lm():
    """The recurrent states reach the stacked cache: a prefill and two
    decode steps give the whole sequence's logits (static calibration,
    fp32; the per-group states are written back in place)."""
    _, cfg, _, tp, _, _ = _lm()
    run = RunConfig(analog=AnalogConfig(act_calib="static"),
                    activation_dtype="float32")
    toks = torch.from_numpy(_tokens(cfg, 5))
    whole, _, _ = T.lm_apply(tp, {"tokens": toks}, cfg, run)
    cache = T.init_lm_cache(cfg, B, 16, dtype=torch.float32, device="cpu")
    parts = []
    for sl in (slice(0, 4), slice(4, 5), slice(5, 6)):
        lg, cache, _ = T.lm_apply(tp, {"tokens": toks[:, sl]}, cfg, run,
                                  cache=cache)
        parts.append(lg)
    np.testing.assert_array_equal(_np(torch.cat(parts, 1)), _np(whole))


def test_bf16_activations_keep_the_reference_cache_dtypes():
    """At bf16 activations over an fp32 cache (the engine's), the time
    mix's ``x_prev`` leaves the layer in bf16 and the WKV state in fp32,
    as the reference's cache does; the next call reads them so."""
    jcfg, cfg, jp, tp, _, _ = _lm()
    jrun = JRunConfig(analog=JAnalogConfig(mode="digital"))
    run = RunConfig(analog=AnalogConfig(mode="digital"))
    toks = _tokens(cfg, 6)
    jc = JT.init_lm_cache(jcfg, B, 16, dtype=jnp.float32)
    tc = T.init_lm_cache(cfg, B, 16, dtype=torch.float32, device="cpu")
    for sl in (slice(0, 4), slice(4, 5)):
        jl, jc, _ = JT.lm_apply(jp, {"tokens": jnp.asarray(toks[:, sl])},
                                jcfg, jrun, cache=jc)
        tl, tc, _ = T.lm_apply(tp, {"tokens": torch.from_numpy(toks[:, sl])},
                               cfg, run, cache=tc)
        for mix, key in (("tmix", "x_prev"), ("tmix", "state"),
                         ("cmix", "x_prev")):
            got = tc["layers"]["l0"][mix][key]
            want = jc["layers"]["l0"][mix][key]
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            _close(got.float(), np.asarray(want, np.float32), 1e-2)
        _close(tl.float(), np.asarray(jl, np.float32), 2e-2)


def test_serve_engine_tokens():
    jcfg, cfg, jp, tp, _, _ = _lm()
    jrun, run = _runs()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 9))
               for _ in range(2)]
    jout = JServeEngine(jcfg, jrun, jp, batch_size=2, max_len=32).serve(
        [JRequest(uid=i, prompt=p, max_new_tokens=3)
         for i, p in enumerate(prompts)])
    eng = ServeEngine(cfg, run, tp, batch_size=2, max_len=32, device="cpu")
    reset_dispatch_count()
    out = eng.serve([Request(uid=i, prompt=p, max_new_tokens=3)
                     for i, p in enumerate(prompts)])
    # one prefill and two decode calls, 4 dispatches per layer + lm_head
    assert dispatch_count() == 3 * (4 * cfg.n_layers + 1)
    for r, jr in zip(out, jout):
        assert r.output.tolist() == jr.output.tolist()


def test_energy_report_of_the_lm_tree():
    _, _, _, _, jm, tm = _lm()
    assert energy_report(tm) == pytest.approx(jenergy_report(jm), rel=1e-6)


def test_training_step_runs():
    """``make_train_step`` on the SMOKE config (analog faithful, fp32
    activations): one step, finite loss and parameters (the step against the
    reference's: ``test_torch_family_train_recurrent.py``)."""
    from repro_torch.train import train_step as TS

    cfg, run = configs.get_smoke(ARCH), _runs()[1]
    state = TS.init_state(torch.Generator().manual_seed(0), cfg, run,
                          device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S + 1)))
    state, metrics = TS.make_train_step(cfg, run)(
        state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert bool(torch.isfinite(metrics["loss"])) and \
        float(metrics["loss"]) > 0
    assert int(state["opt"]["step"]) == 1
    assert all(bool(torch.isfinite(p).all())
               for p in jax.tree.leaves(state["params"]))
