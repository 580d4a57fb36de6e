"""The port's plan store (``repro_torch.exec.store``, format
``repro-plan-v1``) against the JAX package's ``repro.exec.store``, on the
CPU: a plan saved by either package loads into the other and replays to
the other's outputs.

Cases: the ECG stack with its megakernel packing (code chain, and the
static float chain on a measured calibration snapshot), a tree with a
``column_concat`` group - plain and scan-stacked (the port's
``PlanStack`` against the reference's stacked leaves) - and a
transformer block plan; an ``expert_stack`` group round-trips as a live
group both ways, and so do ``batch_concat`` groups (the RWKV r/k/v/g
member axis), plain and scan-stacked (the reference's ``[S, G, ...]``
leaves against the port's ``PlanStack`` of member-axis plans).
Tolerances:

- every array leaf: bit for bit, dtypes kept (int8 codes int8 on disk).
- ECG logits, both routes, and the group replays: bit-exact (the same
  arithmetic on the same leaves as the reference-vs-port tests of
  ``test_torch_ecg.py`` / ``test_torch_calib.py``, measured bit-exact).
- the block: within 1e-5 * max|y| and equal argmax, the block tolerance
  of ``test_torch_block.py`` (glue reductions round in another order).
- a load performs no lowering: ``lowering_count()`` does not move.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import calib as jcalib  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.analog import analog_linear_init as jlinear_init  # noqa: E402
from repro.data.preprocess import preprocess_batch  # noqa: E402
from repro.exec import store as jstore  # noqa: E402
from repro.exec.lower import lower_expert_stack  # noqa: E402
from repro.exec.plan import GroupPlan as JGroupPlan  # noqa: E402
from repro.core.noise import NoiseConfig as JNoiseConfig  # noqa: E402
from repro.exec.run import run_batch_concat as jrun_batch_concat  # noqa: E402
from repro.exec.run import run_expert_stack as jrun_expert_stack  # noqa: E402
from repro.exec.run import run_group as jrun_group  # noqa: E402
from repro.models import ecg as JECG  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch import api, calib, configs  # noqa: E402
from repro_torch.api.compile import tree_spec  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.data.ecg_synth import ECGDatasetConfig, make_dataset  # noqa: E402
from repro_torch.data.preprocess import preprocess  # noqa: E402
from repro_torch.exec import run as trun  # noqa: E402
from repro_torch.exec import store  # noqa: E402
from repro_torch.exec.lower import lower_expert_stack as tlower_expert_stack  # noqa: E402
from repro_torch.exec.lower import lowering_count  # noqa: E402
from repro_torch.exec.plan import (AnalogPlan, GroupPlan, LayerPlan,  # noqa: E402
                                   PlanStack)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.ecg import ECGConfig, ecg_apply_plan, ecg_module_spec  # noqa: E402

ARCH = "phi4-mini-3.8b"
SEQ = 12
REL = 1e-5
_RAW = make_dataset(ECGDatasetConfig(n_test=8), "test")[0]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _drop_alias(tree):
    """A reference tree without its legacy ``"_qkv_plan"`` entries (an
    alias of the qkv group's fused plan, which the port does not make)."""
    if isinstance(tree, dict):
        return {k: _drop_alias(v) for k, v in tree.items()
                if k != "_qkv_plan"}
    return tree


def _leaves(obj):
    """Every array leaf of a lowered artifact, in a fixed walk order
    (a PlanStack member by member)."""
    out = []

    def walk(o):
        if o is None or isinstance(o, (bool, int, float, str)):
            return
        if isinstance(o, PlanStack):
            for m in o:
                walk(m)
        elif isinstance(o, dict):
            for k in sorted(o):
                walk(o[k])
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        elif hasattr(o, "__dataclass_fields__") and not isinstance(
                o, torch.Tensor):
            for f in o.__dataclass_fields__:
                if f not in ("mega", "w_eff", "gain_row"):
                    walk(getattr(o, f))
        else:
            out.append(_np(o))
    walk(obj)
    return out


def _same_leaves(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@functools.lru_cache(maxsize=None)
def _ecg(epilogue):
    """The reference's ECG model and the port's, compiled from the same
    parameters; the float chain on a measured snapshot (static
    activation scales fitted by the reference)."""
    jp = JECG.ecg_init(jax.random.PRNGKey(0), JECG.ECGConfig())
    kw, snap, jsnap = dict(fused_epilogue=True), None, None
    if epilogue == "none":
        kw["act_calib"] = "static"
        rng = np.random.default_rng(2)
        jsnap = jcalib.CalibrationSnapshot()
        for name, (c, n) in (("conv", (1, 8)), ("fc1", (2, 123)),
                             ("fc2", (1, 10))):
            jsnap = jsnap.with_layer(name, jcalib.LayerCalibration(
                gain_table=jnp.asarray(
                    1 + 0.02 * rng.standard_normal((c, n)), jnp.float32),
                chunk_offset=jnp.asarray(rng.standard_normal((c, n)),
                                         jnp.float32),
                a_scale=jnp.asarray(0.05 + 0.01 * rng.random(),
                                    jnp.float32)))
    jm = japi.compile(JECG.ecg_module_spec(JECG.ECGConfig(),
                                           epilogue=epilogue),
                      jp, JAnalogConfig(**kw), calibration=jsnap)
    if jsnap is not None:
        snap = calib.CalibrationSnapshot(layers={
            n: calib.LayerCalibration(**{
                f: torch.tensor(_np(getattr(r, f)))
                for f in ("gain_table", "chunk_offset", "a_scale")})
            for n, r in jsnap.layers.items()})
    tm = api.compile(ecg_module_spec(ECGConfig(), epilogue=epilogue),
                     _port(jp), AnalogConfig(**kw), calibration=snap,
                     device="cpu")
    return jm, tm


class TestStack:
    @pytest.mark.parametrize("epilogue", ["relu_shift", "none"])
    def test_reference_plan_loads_and_replays(self, epilogue, tmp_path):
        jm, tm = _ecg(epilogue)
        path = str(tmp_path / "jax_plan.npz")
        jstore.save_plan(path, jm.lower())
        before = lowering_count()
        plan = store.load_plan(path, device="cpu")
        assert lowering_count() == before
        assert isinstance(plan, AnalogPlan) and plan.mega is not None
        assert plan.layers[0].store.codes.dtype == torch.int8
        _same_leaves(plan, tm.lower())
        assert torch.equal(plan.mega.w_cat, tm.lower().mega.w_cat)
        x = preprocess(_RAW, device="cpu")
        want = _np(jm.apply(preprocess_batch(_RAW)))
        for mk in (True, False):
            trun.reset_dispatch_count()
            got = ecg_apply_plan(plan, x) if mk else trun.run(
                plan, _im2col(x), megakernel=False)
            if not mk:
                got = _pool(got)
            np.testing.assert_array_equal(_np(got), want)

    @pytest.mark.parametrize("epilogue", ["relu_shift", "none"])
    def test_port_plan_loads_into_reference(self, epilogue, tmp_path):
        jm, tm = _ecg(epilogue)
        path = str(tmp_path / "port_plan.npz")
        store.save_plan(path, tm.lower())
        with np.load(path) as z:
            assert str(z["__version__"]) == "repro-plan-v1"
            assert z["a0"].dtype == np.int8          # conv codes
        jplan = jstore.load_plan(path)
        assert jplan.mega is not None
        assert jplan.cfg.use_pallas and jplan.cfg.act_calib == \
            tm.acfg.act_calib
        for jl, tl in zip(jplan.layers, tm.lower().layers):
            np.testing.assert_array_equal(_np(jl.store.codes),
                                          _np(tl.store.codes))
            np.testing.assert_array_equal(_np(jl.w_eff), _np(tl.w_eff))
        got = JECG.ecg_apply_plan(jplan, preprocess_batch(_RAW),
                                  JECG.ECGConfig())
        np.testing.assert_array_equal(
            _np(got), _np(tm.apply(preprocess(_RAW, device="cpu"))))

    def test_version_is_checked(self, tmp_path):
        path = str(tmp_path / "bad.npz")
        np.savez(path, __version__=np.asarray("repro-plan-v0"),
                 __tree__=np.asarray("{}"))
        with pytest.raises(ValueError, match="repro-plan-v1"):
            store.load_plan(path, device="cpu")


def _im2col(x):
    from repro_torch.models.ecg import _im2col as im2col

    return im2col(x, ECGConfig().conv_taps, ECGConfig().conv_stride)


def _pool(out):
    from repro_torch.models.ecg import _pool_class_copies

    return _pool_class_copies(out, ECGConfig(), False)


@functools.lru_cache(maxsize=None)
def _tree():
    """A tree with one column_concat group at the root and one under a
    scan-stacked node (two slices), lowered by both packages."""
    ks = jax.random.split(jax.random.PRNGKey(12), 4)
    ns = (32, 16, 16)

    def attn(k):
        kk = jax.random.split(k, 3)
        return {m: jlinear_init(x, 48, n)
                for m, x, n in zip(("wq", "wk", "wv"), kk, ns)}

    jt = {"attn": attn(ks[0]),
          "layers": {"attn": jax.vmap(attn)(jax.random.split(ks[1], 2))},
          "o": jlinear_init(ks[2], 32, 48)}
    jacfg = JAnalogConfig(signed_input="none")
    acfg = AnalogConfig(signed_input="none")
    jm = japi.compile(japi.tree_spec("t", jt), jt, jacfg)
    tt = _port(jt)
    tm = api.compile(tree_spec("t", tt), tt, acfg, device="cpu")
    return jm, tm, jacfg, acfg


def _check_groups(got, jtree, acfg, jacfg):
    x = np.random.default_rng(4).standard_normal((3, 48)).astype(
        np.float32) * 0.5
    pairs = [(got["attn"]["_groups"]["qkv"], jtree["attn"]["_groups"]["qkv"])]
    stack = got["layers"]["attn"]["_groups"]["qkv"]
    assert isinstance(stack, PlanStack) and len(stack) == 2
    jst = jtree["layers"]["attn"]["_groups"]["qkv"]
    for i, gp in enumerate(stack):
        pairs.append((gp, jax.tree.map(lambda a, i=i: a[i], jst)))
    for gp, jgp in pairs:
        assert isinstance(gp, GroupPlan) and gp.kind == jgp.kind
        for a, b in zip(trun.run_group(gp, torch.from_numpy(x), acfg),
                        jrun_group(jgp, jnp.asarray(x), jacfg)):
            np.testing.assert_array_equal(_np(a), _np(b))


class TestTree:
    def test_reference_tree_loads_and_replays(self, tmp_path):
        jm, tm, jacfg, acfg = _tree()
        path = str(tmp_path / "jax_tree.npz")
        jstore.save_plan(path, jm.lower())
        before = lowering_count()
        tree = store.load_plan(path, device="cpu")
        assert lowering_count() == before
        assert isinstance(tree["o"]["_plan"], LayerPlan)
        _same_leaves(_drop_alias(tree), tm.lower())
        _check_groups(tree, jm.lower(), acfg, jacfg)

    def test_port_tree_loads_into_reference(self, tmp_path):
        jm, tm, jacfg, acfg = _tree()
        path = str(tmp_path / "port_tree.npz")
        store.save_plan(path, tm.lower())
        jtree = jstore.load_plan(path)
        want = _drop_alias(jm.lower())
        assert jax.tree.structure(jtree) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(want)):
            assert _np(a).dtype == _np(b).dtype
            np.testing.assert_array_equal(_np(a), _np(b))
        _check_groups(tm.lower(), jtree, acfg, jacfg)

    @pytest.mark.parametrize("mode", ["analog_faithful", "analog_fast"])
    def test_expert_stack_group_round_trips_live(self, tmp_path, mode):
        """An expert_stack group saved by either package loads into the
        other as a live group and replays to the other's outputs, bit for
        bit (the gains travel baked, so no reduction is redone), with no
        lowering on load; the stores' leaves agree bit for bit."""
        # integer-code weights (each column's max |code| 63, LSB 2^-6):
        # the statistical gain's mean is then exact in any order
        rng = np.random.default_rng(5)
        codes = rng.integers(-20, 21, (3, 200, 24))
        codes[:, 7] = 63
        w = jnp.asarray((codes * 2.0 ** -6).astype(np.float32))
        x = (np.random.default_rng(6).standard_normal((3, 5, 200))
             .astype(np.float32))
        jacfg, acfg = JAnalogConfig(mode=mode), AnalogConfig(mode=mode)
        jgp = JGroupPlan(kind="expert_stack",
                         fused=lower_expert_stack(w, jacfg),
                         member_names=("up",), member_ns=(24,))
        gp = GroupPlan(kind="expert_stack",
                       fused=tlower_expert_stack(_port(w), acfg),
                       member_names=("up",), member_ns=(24,))
        _same_leaves(gp, jgp)
        want = np.asarray(jrun_expert_stack(jgp, jnp.asarray(x), jacfg))
        for save, load in ((jstore.save_plan, store.load_plan),
                           (store.save_plan, jstore.load_plan)):
            path = str(tmp_path / f"experts-{save.__module__}.npz")
            save(path, {"moe": {"_groups": {"up": jgp if save is
                                            jstore.save_plan else gp}}})
            before = lowering_count()
            got = (load(path, device="cpu") if load is store.load_plan
                   else load(path))["moe"]["_groups"]["up"]
            assert got.kind == "expert_stack"
            if load is store.load_plan:
                assert lowering_count() == before
                assert got.fused.store.codes.dtype == torch.int8
                assert tuple(got.fused.store.codes.shape) == (3, 256, 24)
                y = trun.run_group(got, torch.from_numpy(x), acfg)
            else:
                y = jrun_expert_stack(got, jnp.asarray(x), jacfg)
            np.testing.assert_array_equal(_np(y), want)


_RKVG = ("wr", "wk", "wv", "wg")


@functools.lru_cache(maxsize=None)
def _rkvg_tree():
    """Two r/k/v/g quads - one plain, one scan-stacked over two slices -
    with integer rank-1 tables and integer chunk offsets (integer
    ``w_eff``: the split's chunk sums are exact in any order), lowered
    by both packages into batch_concat groups."""
    rng = np.random.default_rng(21)
    keys = jax.random.split(jax.random.PRNGKey(13), 12)

    def member(key):
        p = jax.tree.map(np.asarray,
                         jlinear_init(key, 64, 64, noise=JNoiseConfig()))
        fpn = p["fpn"]
        for name in ("col_gain", "row_gain"):
            fpn[name] = rng.integers(1, 3, fpn[name].shape).astype(
                np.float32)
        fpn["chunk_offset"] = rng.integers(
            -2, 3, fpn["chunk_offset"].shape).astype(np.float32)
        return p

    plain = {n: member(keys[i]) for i, n in enumerate(_RKVG)}
    stacked = {n: jax.tree.map(lambda *a: np.stack(a), member(keys[4 + 2 * i]),
                               member(keys[5 + 2 * i]))
               for i, n in enumerate(_RKVG)}
    jt = jax.tree.map(jnp.asarray, {"tmix": plain,
                                    "layers": {"tmix": stacked}})
    jacfg, acfg = JAnalogConfig(), AnalogConfig()
    jm = japi.compile(japi.tree_spec("r", jt), jt, jacfg)
    tt = _port(jt)
    tm = api.compile(tree_spec("r", tt), tt, acfg, device="cpu")
    return jm, tm, jacfg, acfg


def _check_rkvg(got, jtree, acfg, jacfg):
    xs = [np.random.default_rng(30 + i).standard_normal((2, 3, 64)).astype(
        np.float32) * (0.2 + 0.1 * i) for i in range(4)]
    pairs = [(got["tmix"]["_groups"]["rkvg"],
              jtree["tmix"]["_groups"]["rkvg"])]
    stack = got["layers"]["tmix"]["_groups"]["rkvg"]
    assert isinstance(stack, PlanStack) and len(stack) == 2
    jst = jtree["layers"]["tmix"]["_groups"]["rkvg"]
    for i, gp in enumerate(stack):
        pairs.append((gp, jax.tree.map(lambda a, i=i: a[i], jst)))
    for gp, jgp in pairs:
        assert isinstance(gp, GroupPlan) and gp.kind == "batch_concat"
        assert tuple(gp.fused.store.codes.shape) == (4, 128, 64)
        for a, b in zip(trun.run_group(gp, [torch.from_numpy(x) for x in xs],
                                       acfg),
                        jrun_batch_concat(jgp, [jnp.asarray(x) for x in xs],
                                          jacfg)):
            np.testing.assert_array_equal(_np(a), _np(b))


class TestBatchConcat:
    def test_reference_groups_load_and_replay(self, tmp_path):
        jm, tm, jacfg, acfg = _rkvg_tree()
        path = str(tmp_path / "jax_rkvg.npz")
        jstore.save_plan(path, jm.lower())
        before = lowering_count()
        tree = store.load_plan(path, device="cpu")
        assert lowering_count() == before
        _same_leaves(tree, tm.lower())
        _check_rkvg(tree, jm.lower(), acfg, jacfg)

    def test_port_groups_load_into_reference(self, tmp_path):
        jm, tm, jacfg, acfg = _rkvg_tree()
        path = str(tmp_path / "port_rkvg.npz")
        store.save_plan(path, tm.lower())
        jtree = jstore.load_plan(path)
        want = jm.lower()
        assert jax.tree.structure(jtree) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(want)):
            assert _np(a).dtype == _np(b).dtype
            np.testing.assert_array_equal(_np(a), _np(b))
        _check_rkvg(tm.lower(), jtree, acfg, jacfg)

    def test_rwkv_smoke_lm_round_trips(self, tmp_path):
        """The rwkv6-7b SMOKE LM's lowered tree (scan-stacked r/k/v/g
        groups, the [S, G, ...] leaves on disk) both ways: a reference
        file served by the port gives the port's own compiled logits bit
        for bit, and a port file served by the reference gives the
        reference's own."""
        from repro.configs.base import RunConfig as JRunConfig

        from repro_torch.configs.base import RunConfig

        jcfg, cfg = jconfigs.get_smoke("rwkv6-7b"), configs.get_smoke(
            "rwkv6-7b")
        jp = JT.lm_init(jax.random.PRNGKey(0), jcfg)
        tp = _port(jp)
        jrun = JRunConfig(analog=JAnalogConfig(), activation_dtype="float32")
        run = RunConfig(analog=AnalogConfig(), activation_dtype="float32")
        jm = japi.compile(JT.lm_module_spec(jcfg, jp), jp, jrun)
        tm = api.compile(T.lm_module_spec(cfg, tp), tp, run, device="cpu")
        toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 5))
        jpath, tpath = str(tmp_path / "jax_lm.npz"), str(tmp_path / "lm.npz")
        jstore.save_plan(jpath, jm.lower())
        store.save_plan(tpath, tm.lower())
        before = lowering_count()
        loaded = store.load_plan(jpath, device="cpu")
        assert lowering_count() == before
        gp = loaded["layers"]["l0"]["rwkv"]["_groups"]["rkvg"]
        assert isinstance(gp, PlanStack) and gp[0].kind == "batch_concat"
        _same_leaves(loaded, tm.lower())
        t_in = {"tokens": torch.from_numpy(toks)}
        np.testing.assert_array_equal(
            _np(T.lm_apply(loaded, t_in, cfg, run)[0]),
            _np(T.lm_apply(tm.lower(), t_in, cfg, run)[0]))
        j_in = {"tokens": jnp.asarray(toks)}
        np.testing.assert_array_equal(
            np.asarray(JT.lm_apply(jstore.load_plan(tpath), j_in, jcfg,
                                   jrun)[0]),
            np.asarray(JT.lm_apply(jm.lower(), j_in, jcfg, jrun)[0]))


@functools.lru_cache(maxsize=None)
def _block():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jp = JT._layer_init(jax.random.PRNGKey(0), "attn_mlp", jcfg)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.hd, seq=SEQ, rope_theta=cfg.rope_theta)
    jm = japi.compile_block(jp, JAnalogConfig(act_calib="static",
                                              use_pallas=True), **kw)
    tm = api.compile_block(_port(jp), AnalogConfig(act_calib="static"),
                           device="cpu", **kw)
    x = (np.random.default_rng(1).standard_normal(
        (2, SEQ, cfg.d_model)) * 0.5).astype(np.float32)
    return jm, tm, x


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.99


class TestBlock:
    def test_reference_block_loads_and_replays(self, tmp_path):
        jm, tm, x = _block()
        path = str(tmp_path / "jax_block.npz")
        jstore.save_plan(path, jm.lower())
        before = lowering_count()
        plan = store.load_plan(path, device="cpu")
        assert lowering_count() == before
        assert plan.block is not None and plan.mega is not None
        _same_leaves(plan, tm.lower())
        trun.reset_dispatch_count()
        got = trun.run(plan, torch.from_numpy(x))
        assert trun.dispatch_count() == 1
        _close(got, jm.apply(jnp.asarray(x)))
        assert torch.equal(got, tm.apply(torch.from_numpy(x)))

    def test_port_block_loads_into_reference(self, tmp_path):
        jm, tm, x = _block()
        path = str(tmp_path / "port_block.npz")
        store.save_plan(path, tm.lower())
        jplan = jstore.load_plan(path)
        assert jplan.block is not None and jplan.mega is not None
        from repro.exec.run import run as jrun

        _close(tm.apply(torch.from_numpy(x)), jrun(jplan, jnp.asarray(x)))
