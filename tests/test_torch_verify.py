"""The port's static plan verifier (``repro_torch.verify``) against the JAX
package's ``repro.verify``, on the CPU, mirroring ``tests/test_verify.py``
(``TestRegistry``, ``TestApiWiring``, ``TestDriftSwap``) and
``tests/test_fleet.py::TestVerifyFleetRules``.

Both packages lower the same parameters (the reference's init, carried
across by ``convert.params_from_numpy``); each corruption is applied to
the same leaf of both artifacts.  The check is exact: the same set of
``(rule, path)`` pairs in both packages, non-empty, and no diagnostic on
the pristine artifacts.  One mapping applies to paths: the port keeps a
scan-stacked plan as a ``PlanStack`` of members, where the reference
keeps one plan with a leading stack axis, so a member adds an index
step (``..._plan[1].store.codes``, ``..._groups.rkvg[0].member_ns``);
:func:`_unstack` drops it before the comparison.
"""
import copy
import dataclasses
import importlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import exec as JE  # noqa: E402
from repro.api.module import LayerSpec as JLayerSpec  # noqa: E402
from repro.api.module import ModuleSpec as JModuleSpec  # noqa: E402
from repro.calib.snapshot import CalibrationSnapshot as JSnapshot  # noqa: E402
from repro.calib.snapshot import LayerCalibration as JLayerCal  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.analog import analog_linear_init as jlinear_init  # noqa: E402
from repro.core.noise import NOISELESS as JNOISELESS  # noqa: E402
from repro.core.noise import NoiseConfig as JNoiseConfig  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.exec.lower import layer_with_offsets as jlayer_with_offsets  # noqa: E402
from repro.exec.lower import plan_with_offsets as jplan_with_offsets  # noqa: E402
from repro.fleet import calibrate_fleet as jcalibrate_fleet  # noqa: E402
from repro.fleet import ChipFleet as JChipFleet  # noqa: E402
from repro.fleet import model_layer_shapes as jmodel_layer_shapes  # noqa: E402
from repro.fleet import model_snapshot as jmodel_snapshot  # noqa: E402
from repro.fleet import place_model as jplace_model  # noqa: E402
from repro.models import ecg as JECG  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.verify import invariants as JI  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.calib.snapshot import (CalibrationSnapshot,  # noqa: E402
                                        LayerCalibration)
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NOISELESS, NoiseConfig  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.exec.lower import (layer_with_offsets,  # noqa: E402
                                    lower_stack, plan_with_offsets)
from repro_torch.exec.plan import PlanStack  # noqa: E402
from repro_torch.fleet import (ChipFleet, calibrate_fleet,  # noqa: E402
                               model_layer_shapes, model_snapshot,
                               place_model)
from repro_torch.models import ecg as ECG  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.verify import (RULES, VerifyError, check,  # noqa: E402
                                verify_model, verify_plan, verify_spec,
                                verify_swap)
from repro_torch.verify import invariants as TI  # noqa: E402

KEY = jax.random.PRNGKey(0)
CHEAP = {"chunk-alignment", "domain-chain", "pack-consistency",
         "dispatch-count", "group-layout", "calibration-compat",
         "placement-coverage", "fleet-calibration-compat"}
FULL = {"drift-swap", "sharding-specs", "packed-layout"}


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _unstack(path: str) -> str:
    """The reference's path of a port path: a PlanStack member's index
    step dropped."""
    return re.sub(r"(\._plan|\._groups\.\w+)\[\d+\]", r"\1", path)


def _pairs(diags, port=False):
    return {(d.rule, _unstack(d.path) if port else d.path) for d in diags}


def _same(jdiags, tdiags, *, nonempty=True):
    """Both packages report the same (rule, path) pairs."""
    want, got = _pairs(jdiags), _pairs(tdiags, port=True)
    assert got == want, (sorted(got), sorted(want))
    if nonempty:
        assert want
    return want


def _set(obj, **fields):
    """A port plan object with ``fields`` replaced as-is (no derived view
    is rebuilt: a corrupted leaf stays corrupted)."""
    out = copy.copy(obj)
    for k, v in fields.items():
        object.__setattr__(out, k, v)
    return out


def _jrep(obj, **fields):
    return dataclasses.replace(obj, **fields)


# --------------------------------------------------------------- artifacts
def _chain(epilogues=None, input_domain="codes", noise="noiseless",
           act_calib="static"):
    """The reference's test chain (32 -> 48 -> 40 -> 24) lowered by both
    packages from the same weights."""
    jnoise, tnoise = ((JNOISELESS, NOISELESS) if noise == "noiseless"
                      else (JNoiseConfig(), NoiseConfig()))
    dims = (32, 48, 40, 24)
    ks = jax.random.split(KEY, len(dims) - 1)
    layers = [jlinear_init(k, a, b, noise=jnoise)
              for k, a, b in zip(ks, dims[:-1], dims[1:])]
    if epilogues is None:
        epilogues = ["relu_shift"] * (len(dims) - 2) + ["none"]
    jacfg = JAnalogConfig(noise=jnoise, act_calib=act_calib)
    acfg = AnalogConfig(noise=tnoise, act_calib=act_calib)
    return (JE.lower_stack(layers, jacfg, epilogues=epilogues,
                           input_domain=input_domain),
            lower_stack([_port(p) for p in layers], acfg,
                        epilogues=epilogues, input_domain=input_domain))


def _ecg():
    jcfg = JECG.ECGConfig()
    jp = JECG.ecg_init(KEY, jcfg)
    jspec = JECG.ecg_module_spec(jcfg, epilogue="relu_shift")
    spec = ECG.ecg_module_spec(ECG.ECGConfig(), epilogue="relu_shift")
    return (japi.compile(jspec, jp, JAnalogConfig()),
            api.compile(spec, _port(jp), AnalogConfig(), device="cpu"))


def _rwkv():
    d, heads = 64, 4
    jp = JR.rwkv_init(KEY, d, heads)
    return (japi.compile(JR.rwkv_module_spec(d, heads), jp,
                         JAnalogConfig(noise=JNOISELESS)),
            api.compile(R.rwkv_module_spec(d, heads), _port(jp),
                        AnalogConfig(noise=NOISELESS), device="cpu"))


def _rwkv_lm():
    """A scan-stacked RWKV LM: the reference's [S, G, ...] group, the
    port's PlanStack of [G, ...] groups."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
              vocab_size=256, block="rwkv", remat=False)
    jcfg = JArchConfig("t-rwkv", "ssm", **kw)
    cfg = ArchConfig("t-rwkv", "ssm", **kw)
    jp = JT.lm_init(KEY, jcfg)
    return (japi.compile(JT.lm_module_spec(jcfg, jp), jp,
                         JAnalogConfig(noise=JNOISELESS)),
            api.compile(T.lm_module_spec(cfg, _port(jp)), _port(jp),
                        AnalogConfig(noise=NOISELESS), device="cpu"))


def _dense_lm():
    """A small scan-stacked dense LM tree lowered by both packages."""
    kw = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=96,
              vocab_size=64, remat=False)
    jcfg = JArchConfig("t-dense", "dense", **kw)
    cfg = ArchConfig("t-dense", "dense", **kw)
    jp = JT.lm_init(KEY, jcfg)
    return (japi.compile(JT.lm_module_spec(jcfg, jp), jp,
                         JAnalogConfig(noise=JNOISELESS)),
            api.compile(T.lm_module_spec(cfg, _port(jp)), _port(jp),
                        AnalogConfig(noise=NOISELESS), device="cpu"))


def _moe():
    jp = JM.moe_init(KEY, 64, 32, 4)
    return (japi.compile(JM.moe_module_spec(64, 32, 4, top_k=2), jp,
                         JAnalogConfig(noise=JNOISELESS)),
            api.compile(M.moe_module_spec(64, 32, 4, top_k=2), _port(jp),
                        AnalogConfig(noise=NOISELESS), device="cpu"))


def _block():
    kw = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=2,
              n_kv_heads=2, d_ff=96, vocab_size=64, remat=False)
    jarch, arch = JArchConfig(**kw), ArchConfig(**kw)
    jp = JT._layer_init(KEY, "attn_mlp", jarch)
    geom = dict(n_heads=arch.n_heads, n_kv_heads=arch.n_kv_heads,
                head_dim=arch.hd, seq=8, rope_theta=arch.rope_theta)
    return (japi.compile_block(jp, JAnalogConfig(act_calib="static",
                                                 noise=JNOISELESS), **geom),
            api.compile_block(_port(jp), AnalogConfig(act_calib="static",
                                                      noise=NOISELESS),
                              device="cpu", **geom))


def _jfleet():
    cfg = JECG.ECGConfig()
    params = JECG.ecg_init(KEY, cfg)
    spec = JECG.ecg_module_spec(cfg)
    pl = jplace_model(jmodel_layer_shapes(spec, params), n_chips=6,
                      spares=2)
    fleet = JChipFleet.for_placement(jax.random.PRNGKey(1), pl,
                                     noise=JNOISELESS)
    fsnap = jcalibrate_fleet(fleet, offset_repeats=4, gain_repeats=1)
    model = japi.compile(
        spec, params, JAnalogConfig(act_calib="static", signed_input="none",
                                    noise=JNOISELESS),
        calibration=jmodel_snapshot(pl, fsnap))
    return params, model, pl, fsnap


def _fleets():
    """The ECG net placed on a 6-chip fleet (2 spares) and fleet-calibrated
    in each package (the same placement; each package's own chips)."""
    jparams, jmodel, jpl, jfs = _jfleet()
    params = _port(jparams)
    spec = ECG.ecg_module_spec(ECG.ECGConfig())
    pl = place_model(model_layer_shapes(spec, params), n_chips=6, spares=2)
    assert [dataclasses.astuple(a) for a in pl.assignments] == [
        dataclasses.astuple(a) for a in jpl.assignments]
    fleet = ChipFleet.for_placement(torch.Generator().manual_seed(1), pl,
                                    noise=NOISELESS)
    fs = calibrate_fleet(fleet, offset_repeats=4, gain_repeats=1)
    model = api.compile(
        spec, params, AnalogConfig(act_calib="static", signed_input="none",
                                   noise=NOISELESS),
        calibration=model_snapshot(pl, fs), device="cpu")
    return (jmodel, jpl, jfs), (model, pl, fs)


# ---------------------------------------------------------------- registry
class TestRegistry:
    def test_rules_registered_with_docs_and_tiers(self):
        assert set(RULES) == CHEAP | FULL == set(JI.RULES)
        for r in RULES.values():
            assert r.doc, r.id
            assert r.cheap == (r.id in CHEAP) == JI.RULES[r.id].cheap

    def test_clean_plan_verifies_empty(self):
        jplan, tplan = _chain()
        assert JI.verify_plan(jplan) == () == verify_plan(tplan)

    def test_check_raises_with_diagnostics(self):
        _, tplan = _chain()
        diags = verify_plan(_set(tplan, mega=None))
        with pytest.raises(VerifyError, match="pack-consistency") as ei:
            check(diags)
        assert ei.value.diagnostics == diags
        check(())


class TestPristine:
    @pytest.mark.parametrize("which", ["ecg", "rwkv", "rwkv_lm", "moe",
                                       "block"])
    def test_compiled_models_verify_clean_in_both(self, which):
        jm, tm = {"ecg": _ecg, "rwkv": _rwkv, "rwkv_lm": _rwkv_lm,
                  "moe": _moe, "block": _block}[which]()
        assert JI.verify_model(jm) == ()
        assert verify_model(tm) == ()

    def test_scan_stacked_group_is_a_plan_stack(self):
        _, tm = _rwkv_lm()
        gp = tm.lowered["layers"]["l0"]["rwkv"]["_groups"]["rkvg"]
        assert isinstance(gp, PlanStack) and len(gp) == 2
        assert gp[0].fused.store.codes.ndim == 3      # [G, K_pad, N]


# -------------------------------------------------- per-rule (rule, path)
def _chunk_cases():
    def ragged(plan, port):
        lp = plan.layers[1]
        st = (_set if port else _jrep)(lp.store, codes=lp.store.codes[:-1])
        bad = (_set if port else _jrep)(lp, store=st)
        return (_set if port else _jrep)(
            plan, layers=(plan.layers[0], bad) + plan.layers[2:])

    def offset_grid(plan, port):
        z = torch.zeros((3, 7)) if port else jnp.zeros((3, 7))
        bad = (_set if port else _jrep)(plan.layers[0], chunk_offset=z)
        return (_set if port else _jrep)(plan, layers=(bad,)
                                         + plan.layers[1:])

    def bias(plan, port):
        z = torch.zeros((5,)) if port else jnp.zeros((5,))
        bad = (_set if port else _jrep)(plan.layers[2], bias=z)
        return (_set if port else _jrep)(plan, layers=plan.layers[:2]
                                         + (bad,))
    return [("chunk-alignment", f) for f in (ragged, offset_grid, bias)]


def _domain_cases():
    def epilogue(plan, port):
        bad = (_set if port else _jrep)(plan.layers[1], epilogue="softmax")
        return (_set if port else _jrep)(
            plan, layers=(plan.layers[0], bad) + plan.layers[2:])

    def width(plan, port):
        bad = (_set if port else _jrep)(plan.layers[1], k=17)
        return (_set if port else _jrep)(
            plan, layers=(plan.layers[0], bad) + plan.layers[2:])
    return [("domain-chain", f) for f in (epilogue, width)]


def _pack_cases():
    def unpacked(plan, port):
        return (_set if port else _jrep)(plan, mega=None)
    return [("pack-consistency", unpacked)]


def _dispatch_cases():
    def truncated(plan, port):
        mega = (_set if port else _jrep)(plan.mega,
                                         schedule=plan.mega.schedule[:-1])
        return (_set if port else _jrep)(plan, mega=mega)

    def shift(plan, port):
        sched = list(plan.mega.schedule)
        sched[1] = sched[1]._replace(shift=sched[1].shift + 3)
        mega = (_set if port else _jrep)(plan.mega, schedule=tuple(sched))
        return (_set if port else _jrep)(plan, mega=mega)

    def handoff(plan, port):
        sched = list(plan.mega.schedule)
        sched[0] = sched[0]._replace(handoff="relu")
        mega = (_set if port else _jrep)(plan.mega, schedule=tuple(sched))
        return (_set if port else _jrep)(plan, mega=mega)
    return [("dispatch-count", f) for f in (truncated, shift, handoff)]


def _packed_cases():
    def out_of_range(plan, port):
        lp = plan.layers[0]
        if port:
            codes = lp.store.codes.clone()
            codes[0, 0] = 100
        else:
            codes = lp.store.codes.at[0, 0].set(100)
        st = (_set if port else _jrep)(lp.store, codes=codes)
        bad = (_set if port else _jrep)(lp, store=st)
        return (_set if port else _jrep)(plan, layers=(bad,)
                                         + plan.layers[1:])
    return [("packed-layout", out_of_range)]


@pytest.mark.parametrize(
    "rule,corrupt",
    _chunk_cases() + _domain_cases() + _pack_cases() + _dispatch_cases()
    + _packed_cases(),
    ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_chain_corruption_same_pairs(rule, corrupt):
    jplan, tplan = _chain()
    assert JI.verify_plan(jplan, rules=(rule,)) == ()
    assert verify_plan(tplan, rules=(rule,)) == ()
    _same(JI.verify_plan(corrupt(jplan, False), rules=(rule,)),
          verify_plan(corrupt(tplan, True), rules=(rule,)))


def test_stale_pack_on_ineligible_chain_same_pairs():
    jplan, tplan = _chain(input_domain="float")
    assert jplan.mega is not None and tplan.mega is not None
    jbad = _jrep(jplan, cfg=jplan.cfg.replace(act_calib="dynamic"))
    tbad = _set(tplan, cfg=tplan.cfg.replace(act_calib="dynamic"))
    pairs = _same(JI.verify_plan(jbad, rules=("pack-consistency",)),
                  verify_plan(tbad, rules=("pack-consistency",)))
    assert pairs == {("pack-consistency", "plan.mega")}


def test_packed_layout_gain_table_shape_same_pairs():
    jplan, tplan = _chain(noise="rank1")
    assert tplan.layers[0].store.col_gain is not None
    rule = ("packed-layout",)
    assert JI.verify_plan(jplan, rules=rule) == () == verify_plan(
        tplan, rules=rule)
    jlp, tlp = jplan.layers[0], tplan.layers[0]
    jbad = _jrep(jplan, layers=(_jrep(jlp, store=_jrep(
        jlp.store, col_gain=jlp.store.col_gain[:-1])),) + jplan.layers[1:])
    tbad = _set(tplan, layers=(_set(tlp, store=_set(
        tlp.store, col_gain=tlp.store.col_gain[:-1])),) + tplan.layers[1:])
    assert _same(JI.verify_plan(jbad, rules=rule),
                 verify_plan(tbad, rules=rule)) == {
        ("packed-layout", "plan.layers[0].store.col_gain")}


def test_packed_layout_probe_catches_a_drifted_dequant():
    """The port keeps each store's derived ``w_eff``: a view that no
    longer matches codes x gain tables fails the one-chunk probe."""
    _, tplan = _chain(noise="rank1")
    lp = tplan.layers[1]
    st = _set(lp.store)
    object.__setattr__(st, "_w_eff", lp.store.w_eff * 1.5)
    bad = _set(tplan, layers=(tplan.layers[0], _set(lp, store=st))
               + tplan.layers[2:])
    assert _pairs(verify_plan(bad, rules=("packed-layout",))) == {
        ("packed-layout", "plan.layers[1].store.codes")}


def test_bad_stack_spec_same_pairs():
    jbad = JModuleSpec(name="bad", kind="stack", layers=(
        JLayerSpec("a", 8, 16), JLayerSpec("b", 32, 4)))
    tbad = api.ModuleSpec(name="bad", kind="stack", layers=(
        api.LayerSpec("a", 8, 16), api.LayerSpec("b", 32, 4)))
    _same(JI.verify_spec(jbad), verify_spec(tbad))
    assert verify_spec(api.ModuleSpec(name="ok", kind="stack", layers=(
        api.LayerSpec("a", 8, 16), api.LayerSpec("b", 16, 4)))) == ()


class TestGroupLayout:
    def test_member_width_mismatch_same_pairs(self):
        jm, tm = _rwkv()
        jgp = jm.lowered["_groups"]["rkvg"]
        tgp = tm.lowered["_groups"]["rkvg"]
        rule = ("group-layout",)
        pairs = _same(
            JI.verify_plan(_jrep(jgp, member_ns=jgp.member_ns[:-1] + (7,)),
                           rules=rule),
            verify_plan(_set(tgp, member_ns=tgp.member_ns[:-1] + (7,)),
                        rules=rule))
        assert any("member" in p for _, p in pairs)

    def test_batch_concat_needs_member_axis_same_pairs(self):
        jm, tm = _rwkv()
        jgp = jm.lowered["_groups"]["rkvg"]
        tgp = tm.lowered["_groups"]["rkvg"]
        jbad = _jrep(jgp, fused=_jrep(jgp.fused, store=_jrep(
            jgp.fused.store, codes=jgp.fused.store.codes[0])))
        tbad = _set(tgp, fused=_set(tgp.fused, store=_set(
            tgp.fused.store, codes=tgp.fused.store.codes[0])))
        pairs = _same(JI.verify_plan(jbad, rules=("group-layout",)),
                      verify_plan(tbad, rules=("group-layout",)))
        assert any(p.endswith(".fused.store.codes") for _, p in pairs)

    def test_scan_stacked_member_ns_same_pairs_through_the_stack(self):
        """A corruption of the stacked group: the reference's one stacked
        node, every member of the port's PlanStack."""
        jm, tm = _rwkv_lm()
        node = jm.lowered["layers"]["l0"]["rwkv"]
        jbad = {**node, "_groups": {"rkvg": _jrep(
            node["_groups"]["rkvg"], member_ns=(64, 64, 64, 7))}}
        tnode = tm.lowered["layers"]["l0"]["rwkv"]
        tbad = {**tnode, "_groups": {"rkvg": PlanStack(
            _set(g, member_ns=(64, 64, 64, 7))
            for g in tnode["_groups"]["rkvg"])}}
        jd = JI.verify_plan({"layers": {"l0": {"rwkv": jbad}}},
                            rules=("group-layout",))
        td = verify_plan({"layers": {"l0": {"rwkv": tbad}}},
                         rules=("group-layout",))
        assert len(td) == 2 * len(jd)           # one per stack member
        assert _same(jd, td) == {
            ("group-layout", "plan.layers.l0.rwkv._groups.rkvg.member_ns")}

    def test_expert_stack_clean_and_corrupted(self):
        jm, tm = _moe()
        rule = ("group-layout",)
        assert JI.verify_plan(jm.lowered, rules=rule) == ()
        assert verify_plan(tm.lowered, rules=rule) == ()
        jgp, tgp = jm.lowered["_groups"]["up"], tm.lowered["_groups"]["up"]
        _same(JI.verify_plan(_jrep(jgp, member_names=("up", "x")),
                             rules=rule),
              verify_plan(_set(tgp, member_names=("up", "x")), rules=rule))


class TestCalibrationCompat:
    def test_version_mismatch_same_pairs(self):
        jplan, tplan = _chain()
        rule = ("calibration-compat",)
        assert _same(
            JI.verify_plan(jplan, calibration=_jrep(
                JSnapshot(), version="repro-calib-v0"), rules=rule),
            verify_plan(tplan, calibration=_set(
                CalibrationSnapshot(), version="repro-calib-v0"),
                rules=rule)) == {("calibration-compat",
                                  "calibration.version")}

    def test_table_geometry_vs_plan_same_pairs(self):
        jm, tm = _ecg()
        name = tm.spec.layers[1].name
        jsnap = JSnapshot().with_layer(name, JLayerCal(
            gain_table=jnp.ones((2, 3))))
        tsnap = CalibrationSnapshot().with_layer(name, LayerCalibration(
            gain_table=torch.ones((2, 3))))
        rule = ("calibration-compat",)
        jd = JI.verify_plan(jm.lowered, spec=jm.spec, calibration=jsnap,
                            rules=rule)
        td = verify_plan(tm.lowered, spec=tm.spec, calibration=tsnap,
                         rules=rule)
        assert _same(jd, td) == {("calibration-compat",
                                  f"calibration[{name!r}].gain_table")}
        assert "chunk grid" in td[0].message

    def test_group_shared_scale_disagreement_same_pairs(self):
        d, heads = 64, 4
        jspec, tspec = JR.rwkv_module_spec(d, heads), R.rwkv_module_spec(
            d, heads)
        jsnap, tsnap = JSnapshot(), CalibrationSnapshot()
        for i, n in enumerate(tspec.groups[0].members):
            jsnap = jsnap.with_layer(n, JLayerCal(
                a_scale_in=jnp.float32(0.1 + i)))
            tsnap = tsnap.with_layer(n, LayerCalibration(
                a_scale_in=torch.tensor(0.1 + i)))
        rule = ("calibration-compat",)
        pairs = _same(JI.verify_plan({}, spec=jspec, calibration=jsnap,
                                     rules=rule),
                      verify_plan({}, spec=tspec, calibration=tsnap,
                                  rules=rule))
        assert pairs == {("calibration-compat",
                          "calibration['rkvg'].a_scale_in")}


class TestTreeNames:
    """On a tree, snapshot and placement names are dotted tree paths
    (``lm_head``), and the port finds the lowered layer below the
    artifact's root path (``plan.lm_head._plan``).  The reference keys
    its tree layers by the whole walker path (``plan.lm_head``), so its
    ``calibration-compat`` table-geometry check and its
    ``placement-coverage`` shape check find no tree layer: on these
    corruptions the reference reports nothing and the port reports the
    pair below (ROADMAP "Differences to know")."""

    def test_calibration_geometry_checked_on_a_tree(self):
        jm, tm = _dense_lm()
        n = tm.lowered["lm_head"]["_plan"].n
        rule = ("calibration-compat",)

        def snaps(cols):
            return (JSnapshot().with_layer("lm_head", JLayerCal(
                        chunk_offset=jnp.zeros((1, cols)))),
                    CalibrationSnapshot().with_layer("lm_head",
                        LayerCalibration(chunk_offset=torch.zeros(1, cols))))
        jgood, tgood = snaps(n)
        assert verify_plan(tm.lowered, spec=tm.spec, calibration=tgood,
                           rules=rule) == ()
        jbad, tbad = snaps(n - 1)
        td = verify_plan(tm.lowered, spec=tm.spec, calibration=tbad,
                         rules=rule)
        assert _pairs(td) == {("calibration-compat",
                               "calibration['lm_head'].chunk_offset")}
        assert "chunk grid" in td[0].message
        assert JI.verify_plan(jm.lowered, spec=jm.spec, calibration=jbad,
                              rules=rule) == ()

    def test_placement_shapes_checked_on_a_tree(self):
        jm, tm = _dense_lm()
        pl = place_model(model_layer_shapes(tm.spec, tm.params),
                         n_chips=64, spares=0)
        assert verify_plan(tm.lowered, spec=tm.spec, placement=pl) == ()

        def widened(p):
            return _jrep(p, shapes=tuple(
                (n, s[:-1] + (s[-1] + 1,)) if n == "lm_head" else (n, s)
                for n, s in p.shapes))
        td = verify_plan(tm.lowered, spec=tm.spec, placement=widened(pl))
        assert _pairs(td) == {("placement-coverage", "placement['lm_head']")}
        assert "columns" in td[0].message
        jpl = jplace_model(jmodel_layer_shapes(jm.spec, jm.params),
                           n_chips=64, spares=0)
        assert JI.verify_plan(jm.lowered, spec=jm.spec,
                              placement=widened(jpl)) == ()


class TestVerifyFleetRules:
    def test_rules_pass_on_placed_model(self):
        (jm, jpl, jfs), (tm, pl, fs) = _fleets()
        assert JI.verify_plan(jm.lowered, spec=jm.spec,
                              calibration=jm.calibration, placement=jpl,
                              fleet=jfs) == ()
        assert verify_plan(tm.lowered, spec=tm.spec,
                           calibration=tm.calibration, placement=pl,
                           fleet=fs) == ()

    def test_placement_coverage_fires_same_pairs(self):
        (jm, jpl, _), (tm, pl, _) = _fleets()
        # a dropped tile
        _same(JI.verify_plan(jm.lowered, spec=jm.spec, placement=_jrep(
                  jpl, assignments=jpl.assignments[:-1])),
              verify_plan(tm.lowered, spec=tm.spec, placement=_jrep(
                  pl, assignments=pl.assignments[:-1])))
        # a tile parked on a spare

        def parked(p):
            return _jrep(p, assignments=p.assignments[:-1] + (
                _jrep(p.assignments[-1], chip=p.spares[0]),))
        td = verify_plan(tm.lowered, placement=parked(pl))
        _same(JI.verify_plan(jm.lowered, placement=parked(jpl)), td)
        assert any("spare" in d.message for d in td
                   if d.rule == "placement-coverage")

    def test_fleet_calibration_compat_fires_same_pairs(self):
        (jm, jpl, jfs), (tm, pl, fs) = _fleets()
        _same(JI.verify_plan(jm.lowered, fleet=_jrep(
                  jfs, version="repro-fleet-v0")),
              verify_plan(tm.lowered, fleet=_jrep(
                  fs, version="repro-fleet-v0")))
        td = verify_plan(tm.lowered, placement=pl, fleet=_jrep(
            fs, gain_table=fs.gain_table[:2],
            chunk_offset=fs.chunk_offset[:2]))
        _same(JI.verify_plan(jm.lowered, placement=jpl, fleet=_jrep(
            jfs, gain_table=jfs.gain_table[:2],
            chunk_offset=jfs.chunk_offset[:2])), td)
        assert any("chips" in d.message for d in td
                   if d.rule == "fleet-calibration-compat")


# ------------------------------------------------------------- drift swap
class TestDriftSwap:
    def _offset_plans(self):
        return _chain(noise="rank1")

    def test_identity_swap_is_clean(self):
        jplan, tplan = self._offset_plans()
        assert tplan.layers[0].chunk_offset is not None
        assert JI.verify_plan(jplan, rules=("drift-swap",)) == ()
        assert verify_plan(tplan, rules=("drift-swap",)) == ()
        fresh = plan_with_offsets(
            tplan, [torch.zeros_like(lp.chunk_offset) for lp in tplan.layers])
        assert verify_swap(tplan, fresh) == ()

    def test_static_metadata_change_flagged_same_pairs(self):
        jplan, tplan = self._offset_plans()
        td = verify_swap(tplan, _set(tplan, cfg=tplan.cfg.replace(
            fused_split=not tplan.cfg.fused_split)))
        _same(JI.verify_swap(jplan, _jrep(jplan, cfg=jplan.cfg.replace(
            fused_split=not jplan.cfg.fused_split))), td)
        assert "static metadata" in td[0].message

    def test_leaf_shape_change_pinpointed_same_pairs(self):
        jplan, tplan = self._offset_plans()
        jbad = _jrep(jplan, layers=(_jrep(
            jplan.layers[0],
            chunk_offset=jplan.layers[0].chunk_offset[:, :-1]),)
            + jplan.layers[1:])
        tbad = _set(tplan, layers=(_set(
            tplan.layers[0],
            chunk_offset=tplan.layers[0].chunk_offset[:, :-1]),)
            + tplan.layers[1:])
        pairs = _same(JI.verify_swap(jplan, jbad), verify_swap(tplan, tbad))
        assert all("chunk_offset" in p for _, p in pairs)

    def test_device_change_flagged(self):
        _, tplan = self._offset_plans()
        lp = tplan.layers[0]
        moved = _set(tplan, layers=(_set(
            lp, chunk_offset=lp.chunk_offset.to("meta")),)
            + tplan.layers[1:])
        assert _pairs(verify_swap(tplan, moved)) == {
            ("drift-swap", "plan.layers[0].chunk_offset")}

    def test_plan_with_offsets_matches_reference(self):
        jplan, tplan = self._offset_plans()
        rng = np.random.default_rng(3)
        offs = [rng.standard_normal(tuple(lp.chunk_offset.shape))
                .astype(np.float32) for lp in tplan.layers]
        offs[1] = None
        jnew = jplan_with_offsets(
            jplan, [None if o is None else jnp.asarray(o) for o in offs])
        tnew = plan_with_offsets(
            tplan, [None if o is None else torch.from_numpy(o)
                    for o in offs])
        for jl, tl in zip(jnew.layers, tnew.layers):
            np.testing.assert_array_equal(np.asarray(jl.chunk_offset),
                                          tl.chunk_offset.numpy())
        np.testing.assert_array_equal(np.asarray(jnew.mega.off),
                                      tnew.mega.off.numpy())
        assert tnew.mega.schedule == tuple(jnew.mega.schedule)
        jl = jlayer_with_offsets(jplan.layers[2], jnp.asarray(offs[2]))
        tl = layer_with_offsets(tplan.layers[2], torch.from_numpy(offs[2]))
        np.testing.assert_array_equal(np.asarray(jl.chunk_offset),
                                      tl.chunk_offset.numpy())
        with pytest.raises(ValueError, match="offset tables"):
            plan_with_offsets(tplan, offs[:2])
        _, bare = _chain()
        with pytest.raises(ValueError, match="re-lower"):
            layer_with_offsets(bare.layers[0], torch.zeros((1, 48)))


def test_linear_spec_matches_reference():
    j = japi.linear_spec(256, 128, signed_input="split",
                         sharding=("embed", "mlp"))
    t = api.linear_spec(256, 128, signed_input="split",
                        sharding=("embed", "mlp"))
    assert (t.name, t.kind) == (j.name, j.kind)
    assert [dataclasses.asdict(l) for l in t.layers] == [
        {k: v for k, v in dataclasses.asdict(l).items()
         if k in {f.name for f in dataclasses.fields(api.LayerSpec)}}
        for l in j.layers]


# ----------------------------------------------------------- sharding specs
class TestShardingSpecs:
    def test_float_glue_pack_specs_complete(self):
        jplan, tplan = _chain(epilogues=["relu_shift", "none", "none"])
        assert tplan.mega is not None and tplan.mega.deq is not None
        assert JI.verify_plan(jplan, rules=("sharding-specs",)) == ()
        assert verify_plan(tplan, rules=("sharding-specs",)) == ()

    def test_incomplete_specs_same_pairs(self, monkeypatch):
        jplan, tplan = _chain()
        jorig, torig = jshd.analog_plan_specs, shd.analog_plan_specs

        def jstale(p, axes):     # gain left as a raw array
            specs = jorig(p, axes)
            return dataclasses.replace(specs, mega=dataclasses.replace(
                specs.mega, gain=p.mega.gain))

        def tstale(p, axes):
            specs = torig(p, axes)
            return _set(specs, mega=_set(specs.mega, gain=p.mega.gain))

        monkeypatch.setattr(jshd, "analog_plan_specs", jstale)
        monkeypatch.setattr(shd, "analog_plan_specs", tstale)
        pairs = _same(JI.verify_plan(jplan, rules=("sharding-specs",)),
                      verify_plan(tplan, rules=("sharding-specs",)))
        assert any(".gain" in p for _, p in pairs)

    def test_layer_plan_specs_match_reference(self):
        jplan, tplan = _chain(noise="rank1")
        axes = [("embed", "mlp"), ("mlp", "embed"), ("embed", None)]
        jspec = jshd.analog_plan_specs(jplan, axes)
        tspec = shd.analog_plan_specs(tplan, axes)
        want = dict(jax.tree_util.tree_flatten_with_path(
            jspec, is_leaf=jshd._SPEC_LEAF)[0])
        want = {jax.tree_util.keystr(k): v for k, v in want.items()}
        got = dict(TI.leaves_with_path(tspec, is_leaf=shd._SPEC_LEAF))
        assert got == want

    def test_stacked_tree_specs_cover_every_leaf(self):
        """A scan-stacked LM tree: each PlanStack member's spec is the
        member weight's spec without the stack prefix, and every leaf of
        the lowered tree has a spec."""
        _, tm = _rwkv_lm()
        specs = shd.plan_specs_like(tm.spec.param_axes, tm.lowered)
        wo = specs["layers"]["l0"]["rwkv"]["wo"]["_plan"]
        assert isinstance(wo, PlanStack) and len(wo) == 2
        assert wo[0].store.codes == ("heads", "embed")
        g = specs["layers"]["l0"]["rwkv"]["_groups"]["rkvg"][1]
        assert g.fused.store.codes == (None, "embed", "heads")
        got = {k for k, _ in TI.leaves_with_path(tm.lowered)}
        have = {k for k, _ in TI.leaves_with_path(
            specs, is_leaf=shd._SPEC_LEAF)}
        assert got == have
        assert verify_plan(tm.lowered, spec=tm.spec,
                           rules=("sharding-specs",)) == ()


# ---------------------------------------------------------------- api wiring
class TestApiWiring:
    def test_compile_verifies_by_default_and_model_verify_clean(self):
        _, tm = _ecg()
        assert tm.verify() == ()
        assert tm.verify(strict=True) == ()

    def test_compile_raises_by_default_and_skips_with_verify_false(
            self, monkeypatch):
        from repro_torch.obs import trace

        # the module (``api.compile`` is the function)
        compile_mod = importlib.import_module("repro_torch.api.compile")

        orig = compile_mod.lower_stack

        def unpacked(*a, **k):          # an eligible chain without its pack
            return dataclasses.replace(orig(*a, **k), mega=None)

        monkeypatch.setattr(compile_mod, "lower_stack", unpacked)
        cfg = ECG.ECGConfig()
        params = ECG.ecg_init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
        spec = ECG.ecg_module_spec(cfg, epilogue="relu_shift")
        with trace.collect() as tr:
            with pytest.raises(VerifyError, match="pack-consistency"):
                api.compile(spec, params, AnalogConfig(), device="cpu")
        events = tr.events_named("verify.diagnostic")
        assert [e["meta"]["rule"] for e in events] == ["pack-consistency"]
        assert tr.spans("api.compile")[0]["meta"]["diagnostics"] == 1
        m = api.compile(spec, params, AnalogConfig(), device="cpu",
                        verify=False)
        assert _pairs(m.verify()) == {("pack-consistency", "plan.mega")}

    def test_model_verify_strict_raises_on_corruption(self):
        _, tm = _ecg()
        bad = dataclasses.replace(tm, lowered=_set(tm.lowered, mega=None))
        assert any(d.rule == "pack-consistency" for d in bad.verify())
        with pytest.raises(VerifyError):
            bad.verify(strict=True)
        assert bad.verify(cheap_only=True) == tuple(
            d for d in bad.verify() if RULES[d.rule].cheap)

    def test_cheap_tier_reads_no_tensor_values(self, monkeypatch):
        """The compile-time tier reads shapes and metadata only: with
        every value read of a tensor made to raise, it still runs."""
        _, tm = _block()

        def no_read(*a, **k):
            raise AssertionError("the cheap tier read a tensor's values")

        for name in ("item", "tolist", "numpy", "__bool__", "__float__"):
            monkeypatch.setattr(torch.Tensor, name, no_read)
        assert verify_model(tm, cheap_only=True) == ()
