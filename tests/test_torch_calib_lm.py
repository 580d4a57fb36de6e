"""The LM half of the measured bake against the JAX package's, on the CPU:
per-stack-member calibration records (``[S, C, N]`` tables) baked into a
scan-stacked LM, swapped into it, stored and loaded; and a transformer
block compiled from a snapshot of its seven member devices
(``compile_block(calibration=)``) and refreshed by its four dispatch
names (``with_calibration``).

The tables are made with numpy from a seed (or measured by the
reference's chips and saved) and handed to both packages.  Tolerances:
every plan's ``w_eff``, gain table and offsets bit-exact against the
reference's (slice ``i`` of its stacked leaves for stack member ``i``);
LM logits within 1e-4 * max|logit| and block outputs within 1e-5 *
max|y| (the North-star contract with float effective weights, and the
block glue's reductions in another order: ``tests/test_torch_block.py``);
swaps and loads lower nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import calib as jcalib  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.noise import NoiseConfig as JNoiseConfig  # noqa: E402
from repro.exec.store import load_plan as jload_plan  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch import api, calib, configs  # noqa: E402
from repro_torch.configs.base import ArchConfig, RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.exec.lower import (lowering_count, stack_calibs,  # noqa: E402
                                    stacked_calib)
from repro_torch.exec.plan import PlanStack  # noqa: E402
from repro_torch.exec.store import load_plan, save_plan  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

KEY = jax.random.PRNGKey(0)
LM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
          vocab_size=256)
LOGIT_TOL = 1e-4
BLOCK_TOL = 1e-5
BLOCK_MEMBERS = ("wq", "wk", "wv", "wo", "up", "gate", "down")
DISPATCHES = ("qkv", "o", "up_gate", "down")
SEQ = 12


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lm():
    jcfg = JArchConfig("t-stack", "dense", **LM)
    cfg = ArchConfig("t-stack", "dense", **LM)
    jp = JT.lm_init(KEY, jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jrun = JRunConfig(analog=JAnalogConfig(mode="analog_faithful"),
                      activation_dtype="float32")
    run = RunConfig(analog=AnalogConfig(mode="analog_faithful"),
                    activation_dtype="float32")
    return jcfg, cfg, jp, tp, jrun, run


def _stacked_snapshot(jp, seed, scale=1.0):
    """A reference snapshot with a per-stack-member record ([S, C, N]
    gain and offset tables) for every scan-stacked layer and a plain
    [C, N] record for the lm_head, drawn with numpy."""
    rng = np.random.default_rng(seed)
    snap = jcalib.CalibrationSnapshot()
    for path, node in japi.iter_analog_layers(jp):
        shape = node["w"].shape
        lead = shape[:-2]
        c = -(-shape[-2] // 128)
        snap = snap.with_layer(path, jcalib.LayerCalibration(
            gain_table=jnp.asarray(
                (1 + 0.02 * scale * rng.standard_normal(lead + (c, shape[-1]))
                 ).astype(np.float32)),
            chunk_offset=jnp.asarray(
                (scale * rng.standard_normal(lead + (c, shape[-1]))
                 ).astype(np.float32))))
    return snap


def _port_snapshot(jsnap, tmp_path, name):
    path = tmp_path / f"{name}.npz"
    jsnap.save(path)
    return calib.CalibrationSnapshot.load(path, device="cpu")


def _plans(tree):
    """{path: (w_eff, chunk_gain, chunk_offset)} of every plan in a
    lowered LM tree; a port stack's members stacked on axis 0 (the
    reference's layout)."""
    out = {}

    def leaf(lp):
        return (_np(lp.store.w_eff), _np(lp.store.chunk_gain),
                _np(lp.chunk_offset))

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, PlanStack):
            parts = [leaf(m.fused if hasattr(m, "fused") else m)
                     for m in node]
            out[path] = tuple(np.stack(p) for p in zip(*parts))
        elif hasattr(node, "fused") or hasattr(node, "store"):
            out[path] = leaf(node.fused if hasattr(node, "fused") else node)

    walk(tree, "")
    return out


def _same_plans(tree, jtree):
    got, want = _plans(tree), _plans(jtree)
    assert len(got) >= 6 and set(got) <= set(want)
    for path, leaves in got.items():
        for g, w in zip(leaves, want[path]):
            np.testing.assert_array_equal(g, w, err_msg=path)


def _logits_close(tm, jm):
    toks = np.arange(5, dtype=np.int32)[None] * 7 % LM["vocab_size"]
    y = _np(tm.apply({"tokens": torch.as_tensor(toks, dtype=torch.long)})[0])
    y_ref = np.asarray(jm.apply({"tokens": jnp.asarray(toks)})[0])
    assert np.abs(y - y_ref).max() <= LOGIT_TOL * np.abs(y_ref).max()
    return y


class TestStackedRecords:
    def test_stacked_calib_and_members(self):
        rec = calib.LayerCalibration(gain_table=torch.ones((3, 2, 4)),
                                     chunk_offset=torch.zeros((3, 2, 4)))
        assert stacked_calib(rec, 3) and not stacked_calib(rec, 2)
        assert not stacked_calib(None, 3)
        assert not stacked_calib(rec.replace(a_scale=torch.tensor(0.5)), 3)
        members = stack_calibs(rec, 3)
        assert [tuple(m.gain_table.shape) for m in members] == [(2, 4)] * 3
        plain = calib.LayerCalibration(gain_table=torch.ones((2, 4)))
        assert stack_calibs(plain, 3) == [None] * 3

    def test_stacked_bake_matches_reference(self, tmp_path):
        """Fault: a per-stack-member record must bake member i of every
        scan-stacked layer and fused group (the reference's joint vmap),
        not be dropped."""
        jcfg, cfg, jp, tp, jrun, run = _lm()
        jsnap = _stacked_snapshot(jp, 1)
        snap = _port_snapshot(jsnap, tmp_path, "snap")
        jm = japi.compile(JT.lm_module_spec(jcfg, jp), jp, jrun,
                          calibration=jsnap)
        tm = api.compile(T.lm_module_spec(cfg, tp), tp, run,
                         calibration=snap, device="cpu")
        qkv = tm.lower()["layers"]["l0"]["attn"]["_groups"]["qkv"]
        assert isinstance(qkv, PlanStack)
        assert all(g.fused.store.chunk_gain is not None for g in qkv)
        _same_plans(tm.lower(), jm.lower())
        _logits_close(tm, jm)

    def test_stacked_swap_matches_reference(self, tmp_path):
        """``with_calibration`` swaps [S, C, N] tables into every member
        of a stack (the reference: 'per-stack-member tables DO swap'),
        lowering nothing, equal to a fresh compile."""
        jcfg, cfg, jp, tp, jrun, run = _lm()
        jsnap = _stacked_snapshot(jp, 1)
        jm = japi.compile(JT.lm_module_spec(jcfg, jp), jp, jrun,
                          calibration=jsnap)
        tm = api.compile(T.lm_module_spec(cfg, tp), tp, run,
                         calibration=_port_snapshot(jsnap, tmp_path, "a"),
                         device="cpu")
        jfresh = _stacked_snapshot(jp, 2, scale=1.5)
        fresh = _port_snapshot(jfresh, tmp_path, "b")
        before = lowering_count()
        tm2 = tm.with_calibration(fresh)
        assert lowering_count() == before
        jm2 = jm.with_calibration(jfresh)
        _same_plans(tm2.lower(), jm2.lower())
        y = _logits_close(tm2, jm2)
        full = api.compile(tm.spec, tp, run, calibration=fresh, device="cpu")
        toks = torch.as_tensor(np.arange(5)[None] * 7 % LM["vocab_size"])
        np.testing.assert_array_equal(
            y, _np(full.apply({"tokens": toks})[0]))
        # plain [C, N] tables do not fit a stack: it keeps its tables
        head = jfresh.layer("lm_head")
        plain = fresh.with_layer("layers.l0.mlp.up", calib.LayerCalibration(
            gain_table=torch.as_tensor(np.array(head.gain_table))[:, :128],
            chunk_offset=torch.zeros((1, 128))))
        kept = tm2.with_calibration(plain).lower()["layers"]["l0"]["mlp"]
        was = tm2.lower()["layers"]["l0"]["mlp"]
        assert all(a is b for a, b in zip(kept["up"]["_plan"],
                                          was["up"]["_plan"]))

    def test_stacked_plan_store_both_ways(self, tmp_path):
        """A calibrated scan-stacked tree through ``repro-plan-v1``: the
        stacks come back as stacks with their chunk_gain tables, no
        lowering; the reference loads the port's file to the same
        plans."""
        jcfg, cfg, jp, tp, jrun, run = _lm()
        jsnap = _stacked_snapshot(jp, 1)
        tm = api.compile(T.lm_module_spec(cfg, tp), tp, run,
                         calibration=_port_snapshot(jsnap, tmp_path, "s"),
                         device="cpu")
        path = str(tmp_path / "plan.npz")
        save_plan(path, tm.lower())
        before = lowering_count()
        back = load_plan(path, device="cpu")
        assert lowering_count() == before
        up = back["layers"]["l0"]["mlp"]["up"]["_plan"]
        assert isinstance(up, PlanStack) and up[1].store.chunk_gain is not None
        assert up[0].store.codes.dtype == torch.int8
        got = _plans(back)
        for p, leaves in _plans(tm.lower()).items():
            for a, b in zip(leaves, got[p]):
                np.testing.assert_array_equal(a, b, err_msg=p)
        jm = japi.compile(JT.lm_module_spec(jcfg, jp), jp, jrun,
                          calibration=jsnap)
        _same_plans(back, jload_plan(path))
        _same_plans(back, jm.lower())


# -------------------------------------------------------- calibrated block
def _block():
    jcfg = jconfigs.get_smoke("phi4-mini-3.8b")
    cfg = configs.get_smoke("phi4-mini-3.8b")
    jp = JT._layer_init(jax.random.PRNGKey(0), "attn_mlp", jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.hd, seq=SEQ, rope_theta=cfg.rope_theta)
    return jp, tp, kw


def _member_snapshot(jp):
    """The reference's blind calibration of the block's seven member
    devices (fixed pattern from the parameters, no readout noise)."""
    nodes = {"wq": jp["attn"]["wq"], "wk": jp["attn"]["wk"],
             "wv": jp["attn"]["wv"], "wo": jp["attn"]["wo"],
             "up": jp["mlp"]["up"], "gate": jp["mlp"]["gate"],
             "down": jp["mlp"]["down"]}
    snap = jcalib.CalibrationSnapshot()
    for i, name in enumerate(BLOCK_MEMBERS):
        chip = jcalib.VirtualChip.from_params(
            nodes[name], jax.random.fold_in(KEY, i),
            noise=JNoiseConfig(readout_std=0.0))
        snap = snap.with_layer(name, jcalib.calibrate_chip(
            chip, offset_repeats=4, gain_repeats=1))
    return snap


def _block_plans_equal(plan, jplan):
    for lp, jl in zip(plan.layers, jplan.layers):
        for a, b in ((lp.store.w_eff, jl.store.w_eff),
                     (lp.store.chunk_gain, jl.store.chunk_gain),
                     (lp.chunk_offset, jl.chunk_offset)):
            np.testing.assert_array_equal(_np(a), np.asarray(b))


def _block_close(y, y_ref):
    y, y_ref = _np(y), np.asarray(y_ref)
    assert y.shape == y_ref.shape and np.isfinite(y).all()
    assert np.abs(y - y_ref).max() <= BLOCK_TOL * np.abs(y_ref).max()


class TestCalibratedBlock:
    @pytest.mark.parametrize("mode", ["analog_faithful", "analog_fast"])
    def test_compile_block_calibration_matches_reference(self, mode,
                                                         tmp_path):
        jp, tp, kw = _block()
        jsnap = _member_snapshot(jp)
        snap = _port_snapshot(jsnap, tmp_path, "block")
        jacfg = JAnalogConfig(mode=mode, act_calib="static", use_pallas=True)
        acfg = AnalogConfig(mode=mode, act_calib="static")
        jm = japi.compile_block(jp, jacfg, calibration=jsnap, **kw)
        tm = api.compile_block(tp, acfg, calibration=snap, device="cpu", **kw)
        plan = tm.lower()
        assert plan.block is not None and plan.expected_dispatches == 1
        assert all(lp.store.chunk_gain is not None and lp.store.code_operand
                   for lp in plan.layers)
        _block_plans_equal(plan, jm.lower())
        x = np.random.default_rng(3).standard_normal(
            (2, SEQ, tp["attn"]["wq"]["w"].shape[0])).astype(np.float32)
        y = tm.apply(torch.from_numpy(x))
        _block_close(y, jm.apply(jnp.asarray(x)))
        # the block route equals its own per-layer replay on the CPU
        assert torch.equal(y, tm.apply(torch.from_numpy(x),
                                       megakernel=False))

    def test_block_with_calibration_by_dispatch_names(self, tmp_path):
        """A drift refresh keyed by the four dispatch names swaps the
        fused tables (offsets and gains) of the block plan, lowering
        nothing: equal to the reference's ``with_calibration``."""
        jp, tp, kw = _block()
        jsnap = _member_snapshot(jp)
        jacfg = JAnalogConfig(act_calib="static", use_pallas=True)
        acfg = AnalogConfig(act_calib="static")
        jm = japi.compile_block(jp, jacfg, calibration=jsnap, **kw)
        tm = api.compile_block(tp, acfg, calibration=_port_snapshot(
            jsnap, tmp_path, "m"), device="cpu", **kw)
        rng = np.random.default_rng(4)
        fresh = jcalib.CalibrationSnapshot()
        for name, jl in zip(DISPATCHES, jm.lower().layers):
            off = np.asarray(jl.chunk_offset)
            gain = np.asarray(jl.store.chunk_gain)
            fresh = fresh.with_layer(name, jcalib.LayerCalibration(
                chunk_offset=jnp.asarray(
                    (off + 2 * rng.standard_normal(off.shape)).astype(
                        np.float32)),
                gain_table=jnp.asarray(
                    (gain * (1 + 0.01 * rng.standard_normal(gain.shape))
                     ).astype(np.float32))))
        before = lowering_count()
        tm2 = tm.with_calibration(_port_snapshot(fresh, tmp_path, "d"))
        assert lowering_count() == before
        jm2 = jm.with_calibration(fresh)
        plan = tm2.lower()
        assert plan.mega is not None
        assert all(a.store.codes is b.store.codes
                   for a, b in zip(plan.layers, tm.lower().layers))
        _block_plans_equal(plan, jm2.lower())
        x = np.random.default_rng(5).standard_normal(
            (1, SEQ, tp["attn"]["wq"]["w"].shape[0])).astype(np.float32)
        y = tm2.apply(torch.from_numpy(x))
        _block_close(y, jm2.apply(jnp.asarray(x)))
        assert not torch.equal(y, tm.apply(torch.from_numpy(x)))
