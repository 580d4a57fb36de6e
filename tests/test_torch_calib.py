"""The port's calibration subsystem (``repro_torch.calib``) and the
measured bake against the JAX package's ``repro.calib``, on the CPU.

Randomness is passed in, never re-sampled: the chips wrap the reference's
fixed pattern (``from_params`` on carried-over parameters), a noisy
measurement takes the reference's own readout-noise draw, and the
calibrated bakes use a snapshot the JAX package measured and saved.
Tolerances:

- ``measure`` on a noiseless chip, per ADC readout: within 1 LSB, and a
  readout may differ only at a rounding tie (its exact float64 value
  within 1e-3 of a half-integer): fp32 sums in another order.  The same
  with the reference's readout-noise draw passed in.
- ``null_offsets`` on a noiseless chip: bit-exact (zero weights).
- ``fit_gain_table``, the oracle gain table and the fitted activation
  scales: within 1e-6 relative.
- Snapshot ``.npz`` both ways: every table bit for bit, dtypes kept.
- ``compile(calibration=)`` on the JAX snapshot: every layer's ``w_eff``,
  offsets and the megakernel's ``w_cat`` bit-identical; ECG logits of
  both chains and both routes against the reference's within the
  per-readout contract - on the CPU the two packages' ADC readouts agree
  here, so the code chain's logits are held bit-exact and the float
  chain's within 1e-6 relative.
- ``with_calibration`` equal to a fresh compile with the same snapshot,
  bit for bit, with ``lowering_count()`` unchanged.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import calib as jcalib  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.analog import analog_linear_init as jlinear_init  # noqa: E402
from repro.core.noise import NoiseConfig as JNoiseConfig  # noqa: E402
from repro.data.preprocess import preprocess_batch  # noqa: E402
from repro.models import ecg as JECG  # noqa: E402

from repro_torch import api, calib, obs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NoiseConfig  # noqa: E402
from repro_torch.data.ecg_synth import ECGDatasetConfig, make_dataset  # noqa: E402
from repro_torch.data.preprocess import preprocess  # noqa: E402
from repro_torch.exec.lower import lowering_count  # noqa: E402
from repro_torch.models.ecg import ECGConfig, _im2col, ecg_module_spec  # noqa: E402

KEY = jax.random.PRNGKey(3)
ECG_NAMES = ("conv", "fc1", "fc2")
TIE = 1e-3
REL = 1e-6
_RAW = make_dataset(ECGDatasetConfig(n_test=16), "test")[0]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _layer(mode, k=200, n=8, seed=1):
    """A layer's parameters from the reference's init, its fixed pattern
    in ``mode`` with no readout noise."""
    noise = JNoiseConfig(mode=mode, readout_std=0.0)
    jp = jlinear_init(jax.random.PRNGKey(seed), k, n, noise=noise)
    return jp, _port(jp)


def _chips(mode, readout_std=0.0):
    jp, tp = _layer(mode)
    jnoise = JNoiseConfig(mode=mode, readout_std=readout_std)
    noise = NoiseConfig(mode=mode, readout_std=readout_std)
    return (jcalib.VirtualChip.from_params(jp, KEY, noise=jnoise),
            calib.VirtualChip.from_params(tp, _gen(), noise=noise), jp)


def _probe(k=200, n=8):
    rng = np.random.default_rng(5)
    w = np.round(rng.standard_normal((k, n)) * 20).astype(np.float32)
    a = np.round(rng.uniform(size=(3, k)) * 31).astype(np.float32)
    return w, a


def _exact_readouts(jp, w, a, gain, chunk_rows=128):
    """The readouts' pre-rounding values in float64."""
    fpn = {k: np.asarray(v, np.float64) for k, v in jp["fpn"].items()}
    w = np.clip(w, -63, 63).astype(np.float64)
    if "gain" in fpn:
        w = w * fpn["gain"]
    else:
        w = w * fpn.get("col_gain", 1.0)[None, :] \
            * fpn.get("row_gain", np.ones(w.shape[0]))[:, None]
    k, n = w.shape
    c = -(-k // chunk_rows)
    w = np.pad(w, ((0, c * chunk_rows - k), (0, 0))).reshape(c, chunk_rows,
                                                             n)
    a = np.pad(a.astype(np.float64), ((0, 0), (0, c * chunk_rows - k)))
    v = np.einsum("bck,ckn->bcn", a.reshape(-1, c, chunk_rows), w) * gain
    return v + fpn.get("chunk_offset", 0.0)


def _hold_readouts(got, want, exact):
    """<= 1 LSB per readout, and only at a rounding tie."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    frac = np.abs(exact - np.floor(exact) - 0.5)
    assert (frac[diff > 0] < TIE).all()


class TestVirtualChip:
    @pytest.mark.parametrize("mode", ["full", "rank1"])
    def test_noiseless_measure_matches_reference(self, mode):
        jchip, chip, jp = _chips(mode)
        w, a = _probe()
        want = jchip.measure(jnp.asarray(w), jnp.asarray(a), gain=0.02)
        got = chip.measure(torch.from_numpy(w), torch.from_numpy(a),
                           gain=0.02)
        assert tuple(got.shape) == (3, chip.n_chunks, 8)
        assert chip.measurements == jchip.measurements == 1
        _hold_readouts(got, want, _exact_readouts(jp, w, a, 0.02))

    @pytest.mark.parametrize("mode", ["full", "rank1"])
    def test_noisy_measure_with_reference_draws(self, mode):
        jchip, chip, jp = _chips(mode, readout_std=0.7)
        w, a = _probe()
        # the draw the reference's next measurement makes
        shape = (3, jchip.n_chunks, 8)
        key = jax.random.fold_in(jchip._key, jchip.measurements + 1)
        draw = 0.7 * jax.random.normal(key, shape, jnp.float32)
        want = jchip.measure(jnp.asarray(w), jnp.asarray(a), gain=0.02)
        got = chip.measure(torch.from_numpy(w), torch.from_numpy(a),
                           gain=0.02, draws=torch.from_numpy(np.array(draw)))
        exact = _exact_readouts(jp, w, a, 0.02) + _np(draw)
        _hold_readouts(got, want, exact)
        # and the zero-input nulling measurement: offset + the draw
        key = jax.random.fold_in(jchip._key, jchip.measurements + 1)
        draw = 0.7 * jax.random.normal(key, (16, jchip.n_chunks, 8))
        want = jcalib.null_offsets(jchip, repeats=16)
        got = chip.measure(torch.zeros(200, 8), torch.zeros(16, 200),
                           draws=torch.from_numpy(np.array(draw))).mean(dim=0)
        np.testing.assert_array_equal(_np(got), _np(want))

    @pytest.mark.parametrize("mode", ["full", "rank1"])
    def test_null_offsets_and_gain_fit_match_reference(self, mode):
        jchip, chip, _ = _chips(mode)
        np.testing.assert_array_equal(
            _np(calib.null_offsets(chip, repeats=8)),
            _np(jcalib.null_offsets(jchip, repeats=8)))
        got = _np(calib.fit_gain_table(chip, repeats=2))
        want = _np(jcalib.fit_gain_table(jchip, repeats=2))
        np.testing.assert_allclose(got, want, rtol=REL, atol=0)
        np.testing.assert_allclose(
            _np(chip.oracle()["gain_table"]),
            _np(jchip.oracle()["gain_table"]), rtol=REL, atol=0)
        assert calib.probe_gain(128) == jcalib.probe_gain(128)
        assert calib.DEFAULT_RAMP == jcalib.routines.DEFAULT_RAMP

    @pytest.mark.parametrize("mode", ["full", "rank1"])
    def test_blind_recovery_is_sub_lsb(self, mode):
        """The port's own noisy chip (its fixed pattern sampled through
        core/noise.py): offset nulling + gain fit recover the hidden
        pattern below one LSB, as the reference's test holds its own."""
        chip = calib.VirtualChip(_gen(7), 200, 48,
                                 noise=NoiseConfig(mode=mode))
        rec = calib.calibrate_chip(chip)
        truth = chip.oracle()
        off_res = (rec.chunk_offset - truth["chunk_offset"]).abs()
        assert float(off_res.max()) < 0.5
        rel = ((rec.gain_table - truth["gain_table"])
               / truth["gain_table"]).abs()
        assert float(rel.max()) < 0.03
        assert chip.measurements == 1 + chip.n_chunks

    def test_kill_and_shape_checks(self):
        chip = calib.VirtualChip(_gen(), 130, 4)
        chip.kill()
        out = chip.measure(torch.zeros(130, 4), torch.ones(2, 130))
        assert chip.dead and bool((out == -128).all())
        assert tuple(out.shape) == (2, 2, 4)
        with pytest.raises(ValueError, match="chip grid"):
            chip.measure(torch.zeros(3, 4), torch.zeros(1, 3))


@functools.lru_cache(maxsize=None)
def _jecg():
    """The reference's ECG parameters and its blind calibration of the
    layers' chips (fewer repeats than the default: the numbers are
    compared, not the accuracy)."""
    jp = JECG.ecg_init(jax.random.PRNGKey(0), JECG.ECGConfig())
    jspec = JECG.ecg_module_spec(JECG.ECGConfig(), epilogue="relu_shift")
    jsnap = jcalib.calibrate_model(jspec, jp, jax.random.PRNGKey(2),
                                   offset_repeats=16, gain_repeats=2)
    return jp, jsnap


@functools.lru_cache(maxsize=None)
def _snap_path(tmp):
    path = f"{tmp}/jax_snapshot.npz"
    _jecg()[1].save(path)
    return path


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    return _snap_path(str(tmp_path_factory.mktemp("calib")))


class TestSnapshot:
    def test_jax_snapshot_loads_bit_for_bit(self, jax_snapshot):
        jsnap = _jecg()[1]
        snap = calib.CalibrationSnapshot.load(jax_snapshot, device="cpu")
        assert snap.version == "repro-calib-v1"
        assert set(snap.layers) == set(jsnap.layers) == set(ECG_NAMES)
        for name in ECG_NAMES:
            for f in ("gain_table", "chunk_offset"):
                t, j = getattr(snap.layer(name), f), getattr(
                    jsnap.layer(name), f)
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(_np(t), _np(j))
            assert snap.layer(name).a_scale is None

    def test_port_snapshot_loads_into_reference(self, tmp_path):
        rec = calib.LayerCalibration(
            gain_table=torch.rand(2, 5, generator=_gen(1)) + 0.5,
            chunk_offset=torch.randn(2, 5, generator=_gen(2)),
            a_scale=torch.tensor(0.125), a_scale_in=torch.tensor(0.25))
        snap = calib.CalibrationSnapshot(source="port").with_layer("l", rec)
        snap = calib.share_group_input_scale(
            snap.with_layer("m", calib.LayerCalibration(
                a_scale=torch.tensor(0.5))), ["l", "m"])
        path = str(tmp_path / "port.npz")
        snap.save(path)
        jsnap = jcalib.CalibrationSnapshot.load(path)
        assert jsnap.source == "port"
        for name in ("l", "m"):
            for f in ("gain_table", "chunk_offset", "a_scale", "a_scale_in"):
                t = getattr(snap.layer(name), f)
                j = getattr(jsnap.layer(name), f)
                assert (t is None) == (j is None)
                if t is not None:
                    assert _np(j).dtype == np.float32
                    np.testing.assert_array_equal(_np(t), _np(j))
        back = calib.CalibrationSnapshot.load(path, device="cpu")
        np.testing.assert_array_equal(_np(back.layer("m").a_scale_in), 0.5)

    def test_version_is_checked(self, tmp_path):
        path = str(tmp_path / "bad.npz")
        np.savez(path, __version__=np.asarray("other"),
                 __source__=np.asarray(""))
        with pytest.raises(ValueError, match="repro-calib-v1"):
            calib.CalibrationSnapshot.load(path, device="cpu")


@functools.lru_cache(maxsize=None)
def _models(epilogue, jax_snapshot):
    jp, jsnap = _jecg()
    kw = dict(fused_epilogue=True)
    if epilogue == "none":
        kw["act_calib"] = "static"
    jm = japi.compile(JECG.ecg_module_spec(JECG.ECGConfig(),
                                           epilogue=epilogue),
                      jp, JAnalogConfig(**kw), calibration=jsnap)
    snap = calib.CalibrationSnapshot.load(jax_snapshot, device="cpu")
    tm = api.compile(ecg_module_spec(ECGConfig(), epilogue=epilogue),
                     _port(jp), AnalogConfig(**kw), calibration=snap,
                     device="cpu")
    return jm, tm, snap


class TestCalibratedBake:
    @pytest.mark.parametrize("epilogue", ["relu_shift", "none"])
    def test_ecg_matches_reference(self, epilogue, jax_snapshot):
        jm, tm, _ = _models(epilogue, jax_snapshot)
        jplan, plan = jm.lower(), tm.lower()
        for jl, tl in zip(jplan.layers, plan.layers):
            assert tl.store.chunk_gain is not None and tl.store.gain_map is None
            # the split tile reads a measured chunk_gain in its int8 operand
            assert tl.store.code_operand
            np.testing.assert_array_equal(_np(tl.w_eff), _np(jl.w_eff))
            np.testing.assert_array_equal(_np(tl.chunk_offset),
                                          _np(jl.chunk_offset))
            assert tl.colsum is None and tl.a_scale_in is None
        np.testing.assert_array_equal(_np(plan.mega.w_cat),
                                      _np(jplan.mega.w_cat))
        x_j, x_t = preprocess_batch(_RAW), preprocess(_RAW, device="cpu")
        for mk in (True, False):
            want = _np(jm.apply(x_j, megakernel=mk))
            got = _np(tm.apply(x_t, megakernel=mk))
            if epilogue == "relu_shift":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=REL, atol=0)
            assert (got.argmax(-1) == want.argmax(-1)).all()

    def test_calibrated_bake_differs_from_oracle(self, jax_snapshot):
        _, tm, _ = _models("relu_shift", jax_snapshot)
        oracle = api.compile(tm.spec, tm.params, tm.run_cfg, device="cpu")
        assert not torch.equal(tm.lower().layers[1].w_eff,
                               oracle.lower().layers[1].w_eff)

    def test_shape_mismatch_raises_reference_message(self, jax_snapshot):
        _, tm, snap = _models("relu_shift", jax_snapshot)
        bad = snap.with_layer("fc1", snap.layer("fc1").replace(
            gain_table=torch.ones(3, 123)))
        with pytest.raises(ValueError, match=r"gain_table shape \(3, 123\) "
                           r"does not match the \(2, 123\) chunk grid"):
            api.compile(tm.spec, tm.params, tm.run_cfg, calibration=bad,
                        device="cpu")

    def test_with_calibration_equals_fresh_compile(self, jax_snapshot):
        _, tm, snap = _models("relu_shift", jax_snapshot)
        chips = calib.model_chips(tm.spec, tm.params, _gen(4))
        for i, chip in enumerate(chips.values()):
            chip.apply_drift(_gen(70 + i), 2.0)
        obs.reset_metrics()
        with obs.collect("drift") as tr:
            mon = calib.DriftMonitor(chips, snap, gain_sweep=True,
                                     gain_repeats=2)
            fresh = mon.maybe_refresh()
        assert fresh is not None and mon.refreshes == 1
        assert tr.events_named("drift.hot_swap") and tr.events_named(
            "drift.probe") and tr.events_named("drift.gain_probe")
        assert obs.registry().get("drift.lsb").count == 1
        assert obs.registry().get("drift.hot_swap").value == 1
        # only offsets and the swept gain row moved
        assert not torch.equal(fresh.layer("conv").gain_table,
                               snap.layer("conv").gain_table)
        assert torch.equal(fresh.layer("fc1").gain_table,
                           snap.layer("fc1").gain_table)
        before = lowering_count()
        swapped = tm.with_calibration(fresh)
        assert lowering_count() == before
        plan, old = swapped.lower(), tm.lower()
        assert plan.layers[1].store is old.layers[1].store
        assert plan.layers[0].store is not old.layers[0].store
        ref = api.compile(tm.spec, tm.params, tm.run_cfg, calibration=fresh,
                          device="cpu").lower()
        for a, b in zip(plan.layers, ref.layers):
            assert torch.equal(a.w_eff, b.w_eff)
            assert torch.equal(a.chunk_offset, b.chunk_offset)
        assert torch.equal(plan.mega.w_cat, ref.mega.w_cat)
        assert torch.equal(plan.mega.off, ref.mega.off)
        x = preprocess(_RAW, device="cpu")
        assert torch.equal(swapped.apply(x), api.CompiledModel(
            spec=tm.spec, params=tm.params, run_cfg=tm.run_cfg, lowered=ref,
            device=tm.device).apply(x))

    def test_offset_only_swap_shares_the_pack(self, jax_snapshot):
        _, tm, snap = _models("relu_shift", jax_snapshot)
        offs = {n: snap.layer(n).chunk_offset + 1.0 for n in ECG_NAMES}
        before = lowering_count()
        swapped = tm.with_calibration(snap.with_offsets(offs))
        assert lowering_count() == before
        plan, old = swapped.lower(), tm.lower()
        assert plan.mega.w_cat is old.mega.w_cat
        assert all(a.store is b.store
                   for a, b in zip(plan.layers, old.layers))
        ref = api.compile(tm.spec, tm.params, tm.run_cfg,
                          calibration=snap.with_offsets(offs),
                          device="cpu").lower()
        assert torch.equal(plan.mega.off, ref.mega.off)
        assert not torch.equal(plan.mega.off, old.mega.off)

    def test_activation_scales_match_reference(self):
        jp, jsnap = _jecg()
        jspec = JECG.ecg_module_spec(JECG.ECGConfig(), epilogue="none")
        spec = ecg_module_spec(ECGConfig(), epilogue="none")
        x = np.asarray(preprocess_batch(_RAW))
        cols_j = JECG._im2col(jnp.asarray(x), 16, 8)
        jout = jcalib.fit_activation_scales(jspec, jp, JAnalogConfig(),
                                            jsnap, cols_j)
        snap = calib.CalibrationSnapshot(layers={
            n: calib.LayerCalibration(
                gain_table=torch.tensor(_np(jsnap.layer(n).gain_table)),
                chunk_offset=torch.tensor(_np(jsnap.layer(n).chunk_offset)))
            for n in ECG_NAMES})
        cols = _im2col(torch.tensor(x), 16, 8)
        out = calib.fit_activation_scales(spec, _port(jp), AnalogConfig(),
                                          snap, cols)
        for n in ECG_NAMES:
            np.testing.assert_allclose(_np(out.layer(n).a_scale),
                                       _np(jout.layer(n).a_scale),
                                       rtol=REL, atol=0)


class TestTreeCalibration:
    def _tree(self):
        ks = jax.random.split(jax.random.PRNGKey(9), 4)
        jt = {"attn": {m: jlinear_init(k, 48, n)
                       for m, k, n in zip(("wq", "wk", "wv"), ks, (32, 16,
                                                                   16))},
              "o": jlinear_init(ks[3], 32, 48)}
        return jt, _port(jt)

    def test_group_fuses_under_static_calibration(self):
        from repro.api.compile import tree_spec as jtree_spec
        from repro.exec.run import run_group as jrun_group

        from repro_torch.api.compile import tree_spec
        from repro_torch.exec.run import run_group

        jt, tt = self._tree()
        # measured-looking tables made with numpy (the blind routines are
        # held against the reference above)
        rng = np.random.default_rng(6)
        jsnap = jcalib.CalibrationSnapshot()
        for path, node in japi.iter_analog_layers(jt):
            c, n = -(-node["w"].shape[0] // 128), node["w"].shape[1]
            jsnap = jsnap.with_layer(path, jcalib.LayerCalibration(
                gain_table=jnp.asarray(1.0 + 0.02 * rng.standard_normal(
                    (c, n)), jnp.float32),
                chunk_offset=jnp.asarray(rng.standard_normal((c, n)),
                                         jnp.float32)))
        jsnap = jcalib.share_group_input_scale(
            jsnap, ["attn.wq", "attn.wk", "attn.wv"],
            scales=[0.01, 0.02, 0.015])
        snap = calib.CalibrationSnapshot(layers={
            n: calib.LayerCalibration(**{
                f: None if getattr(r, f) is None
                else torch.from_numpy(np.array(_np(getattr(r, f))))
                for f in ("gain_table", "chunk_offset", "a_scale",
                          "a_scale_in")})
            for n, r in jsnap.layers.items()})
        jacfg = JAnalogConfig(act_calib="static", signed_input="none")
        acfg = AnalogConfig(act_calib="static", signed_input="none")
        jm = japi.compile(jtree_spec("t", jt), jt, jacfg, calibration=jsnap)
        tm = api.compile(tree_spec("t", tt), tt, acfg, calibration=snap,
                         device="cpu")
        jg = jm.group_plan("attn.qkv")
        tg = tm.group_plan("attn.qkv")
        assert tg is not None and jg is not None
        np.testing.assert_array_equal(_np(tg.fused.w_eff),
                                      _np(jg.fused.w_eff))
        assert float(tg.fused.a_scale_in) == float(jg.fused.a_scale_in)
        x = np.random.default_rng(3).standard_normal((4, 48)).astype(
            np.float32) * 0.3
        for a, b in zip(run_group(tg, torch.from_numpy(x), acfg),
                        jrun_group(jg, jnp.asarray(x), jacfg)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=REL, atol=0)
        # a refreshed snapshot swaps into the tree without lowering
        before = lowering_count()
        fresh = snap.with_offsets({n: snap.layer(n).chunk_offset + 0.5
                                   for n in snap.layers})
        swapped = tm.with_calibration(fresh)
        assert lowering_count() == before
        assert torch.equal(swapped.group_plan("attn.qkv").fused.chunk_offset,
                           tg.fused.chunk_offset + 0.5)
        assert torch.equal(swapped.lower()["o"]["_plan"].chunk_offset,
                           tm.lower()["o"]["_plan"].chunk_offset + 0.5)


def test_accuracy_loop_reports_the_calibrated_bake():
    from repro_torch.train import ecg_accuracy

    r = ecg_accuracy.run(n_train=256, n_test=64, epochs=1, batch=64,
                         verbose=False, device="cpu")
    for key in ("calibrated_detection_rate",
                "calibrated_false_positive_rate", "calibrated_accuracy"):
        assert 0.0 <= r[key] <= 1.0
    assert r["calibrate_s"] > 0.0
    rd = ecg_accuracy.run(n_train=256, n_test=64, epochs=1, batch=64,
                          verbose=False, mode="digital", device="cpu")
    assert "calibrated_accuracy" not in rd
