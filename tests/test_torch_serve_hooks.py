"""The port's ``ServeEngine`` deployment hooks (``calibration``,
``drift_monitor``, ``plan_cache``, ``fleet``, ``prelower``) and the
``--serve-smoke`` telemetry gate against the JAX package's, on the CPU
(a 2-layer LM, d_model 64, vocab 256, as the reference's own tests).

Randomness is passed in, never re-sampled: the port serves the
reference's parameters; its chips wrap the same fixed pattern with no
readout noise (so a re-nulling is exact in both packages), the
calibration is the reference's snapshot (saved and loaded), and a drift
episode adds the reference's own drift step to both packages' chips.
Tolerances: the greedy tokens of every request equal the reference's
(the North-star contract for the LM: the effective weights are floats, so
an ADC readout may round differently at a tie, which moves a logit by
far less than the greedy margin here); a hot swap and a plan-cache boot
lower nothing (``lowering_count()`` unchanged).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import calib as jcalib  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.core import noise as jnoise  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.noise import NoiseConfig as JNoiseConfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402

from repro_torch import calib, obs  # noqa: E402
from repro_torch.configs.base import ArchConfig, RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NoiseConfig  # noqa: E402
from repro_torch.exec.lower import lowering_count, reset_lowering_count  # noqa: E402
from repro_torch.fleet import FleetMonitor  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.__main__ import main as obs_main  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

KEY = jax.random.PRNGKey(0)
LM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
          vocab_size=256)
PROMPT = np.arange(6) % LM["vocab_size"]


def _lm(mode="analog_fast"):
    jcfg = JArchConfig("t-hooks", "dense", **LM)
    cfg = ArchConfig("t-hooks", "dense", **LM)
    jp = JT.lm_init(KEY, jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jrun = JRunConfig(analog=JAnalogConfig(mode=mode),
                      activation_dtype="float32")
    run = RunConfig(analog=AnalogConfig(mode=mode),
                    activation_dtype="float32")
    return jcfg, cfg, jp, tp, jrun, run


def _calibrated(tmp_path):
    """Both packages' engines' inputs for a calibrated, drift-monitored
    serve: the reference's snapshot of its chips (no readout noise), and
    the port's chips on the same fixed pattern with that snapshot."""
    jcfg, cfg, jp, tp, jrun, run = _lm()
    jspec, spec = JT.lm_module_spec(jcfg, jp), T.lm_module_spec(cfg, tp)
    jchips = jcalib.model_chips(jspec, jp, KEY,
                                noise=JNoiseConfig(readout_std=0.0))
    chips = calib.model_chips(spec, tp, torch.Generator().manual_seed(0),
                              noise=NoiseConfig(readout_std=0.0))
    assert list(chips) == list(jchips) == ["lm_head"]
    jsnap = jcalib.calibrate_model(jspec, jp, KEY, chips=jchips,
                                   offset_repeats=16, gain_repeats=2)
    jsnap.save(tmp_path / "snap.npz")
    snap = calib.CalibrationSnapshot.load(tmp_path / "snap.npz",
                                          device="cpu")
    return (jcfg, cfg, jp, tp, jrun, run), (jchips, chips), (jsnap, snap)


def _drift(jchips, chips):
    """The reference's drift step, on both packages' chips."""
    for i, name in enumerate(jchips):
        jc = jchips[name]
        step = jnoise.offset_drift(jax.random.fold_in(KEY, 70 + i),
                                   (jc.n_chunks, jc.n), 2.0)
        jc.apply_drift(jax.random.fold_in(KEY, 70 + i), 2.0)
        chips[name].apply_drift(torch.from_numpy(np.array(step)), 2.0)


class TestPrelower:
    def test_prelower_false_serves_raw_params(self):
        """``prelower=False``: no compiled model, every analog layer
        lowered per call; the tokens equal the reference's unbaked
        engine and the port's baked one."""
        jcfg, cfg, jp, tp, jrun, run = _lm()
        eng = ServeEngine(cfg, run, tp, batch_size=2, max_len=32,
                          prelower=False, device="cpu")
        assert eng.model is None and "_plan" not in eng.params["lm_head"]
        jeng = JServeEngine(jcfg, jrun, jp, batch_size=2, max_len=32,
                            prelower=False)
        before = lowering_count()
        out = eng.serve([Request(0, PROMPT, 4)])[0].output
        assert lowering_count() > before          # lowered per call
        want = jeng.serve([JRequest(0, PROMPT, 4)])[0].output
        np.testing.assert_array_equal(out, want)
        baked = ServeEngine(cfg, run, tp, batch_size=2, max_len=32,
                            device="cpu")
        np.testing.assert_array_equal(
            baked.serve([Request(1, PROMPT, 4)])[0].output, out)


class TestCalibratedServe:
    def test_serve_engine_recalibrates_between_batches(self, tmp_path):
        (jcfg, cfg, jp, tp, jrun, run), (jchips, chips), (jsnap, snap) = \
            _calibrated(tmp_path)
        jmon = jcalib.DriftMonitor(jchips, jsnap, threshold_lsb=0.5)
        mon = calib.DriftMonitor(chips, snap, threshold_lsb=0.5)
        jeng = JServeEngine(jcfg, jrun, jp, batch_size=2, max_len=32,
                            calibration=jsnap, drift_monitor=jmon)
        eng = ServeEngine(cfg, run, tp, batch_size=2, max_len=32,
                          calibration=snap, drift_monitor=mon, device="cpu")
        head = eng.params["lm_head"]["_plan"]
        assert head.store.chunk_gain is not None
        np.testing.assert_array_equal(
            head.store.w_eff.numpy(),
            np.asarray(jeng.params["lm_head"]["_plan"].store.w_eff))
        r1 = eng.serve([Request(0, PROMPT, 4)])[0]
        j1 = jeng.serve([JRequest(0, PROMPT, 4)])[0]
        assert mon.refreshes == jmon.refreshes == 0
        np.testing.assert_array_equal(r1.output, j1.output)
        _drift(jchips, chips)
        before = lowering_count()
        r2 = eng.serve([Request(1, PROMPT, 4)])[0]
        j2 = jeng.serve([JRequest(1, PROMPT, 4)])[0]
        assert mon.refreshes == jmon.refreshes == 1   # detected + swapped
        assert lowering_count() == before            # a swap, no lowering
        swapped = eng.params["lm_head"]["_plan"]
        assert swapped.store.codes is head.store.codes
        np.testing.assert_array_equal(
            swapped.chunk_offset.numpy(),
            np.asarray(jeng.params["lm_head"]["_plan"].chunk_offset))
        assert len(r2.output) == 4
        np.testing.assert_array_equal(r2.output, j2.output)


class TestServePlanCache:
    def test_cold_start_from_cache_lowers_nothing(self, tmp_path):
        jcfg, cfg, jp, tp, jrun, run = _lm()
        cache = str(tmp_path / "plan.npz")
        eng1 = ServeEngine(cfg, run, tp, batch_size=2, max_len=32,
                           plan_cache=cache, device="cpu")
        assert (tmp_path / "plan.npz").exists()   # miss: compiled + saved
        reset_lowering_count()
        eng2 = ServeEngine(cfg, run, tp, batch_size=2, max_len=32,
                           plan_cache=cache, device="cpu")
        assert lowering_count() == 0              # hit: no lowering at all
        r1 = eng1.serve([Request(0, PROMPT, 5)])[0]
        r2 = eng2.serve([Request(1, PROMPT, 5)])[0]
        np.testing.assert_array_equal(r1.output, r2.output)
        # the reference boots from the port's file to the same tokens
        jeng = JServeEngine(jcfg, jrun, jp, batch_size=2, max_len=32,
                            plan_cache=cache)
        np.testing.assert_array_equal(
            jeng.serve([JRequest(2, PROMPT, 5)])[0].output, r1.output)

    def test_calibrated_cache_keeps_the_measured_tables(self, tmp_path):
        (jcfg, cfg, jp, tp, jrun, run), _, (jsnap, snap) = \
            _calibrated(tmp_path)
        cache = str(tmp_path / "plan.npz")
        eng1 = ServeEngine(cfg, run, tp, batch_size=2, max_len=32,
                           calibration=snap, plan_cache=cache, device="cpu")
        reset_lowering_count()
        eng2 = ServeEngine(cfg, run, tp, batch_size=2, max_len=32,
                           calibration=snap, plan_cache=cache, device="cpu")
        assert lowering_count() == 0
        a = eng1.params["lm_head"]["_plan"].store
        b = eng2.params["lm_head"]["_plan"].store
        assert torch.equal(a.chunk_gain, b.chunk_gain)
        assert torch.equal(a.w_eff, b.w_eff) and b.codes.dtype == torch.int8
        r1 = eng1.serve([Request(0, PROMPT, 4)])[0]
        r2 = eng2.serve([Request(1, PROMPT, 4)])[0]
        np.testing.assert_array_equal(r1.output, r2.output)
        jeng = JServeEngine(jcfg, jrun, jp, batch_size=2, max_len=32,
                            calibration=jsnap)
        np.testing.assert_array_equal(
            jeng.serve([JRequest(2, PROMPT, 4)])[0].output, r1.output)


class TestServeTelemetry:
    def test_plan_cache_hit_miss_counters(self, tmp_path):
        _, cfg, _, tp, _, run = _lm()
        obs_metrics.reset_metrics()
        cache = str(tmp_path / "plan.npz")
        with obs_trace.collect() as tr:
            ServeEngine(cfg, run, tp, batch_size=2, max_len=32,
                        plan_cache=cache, device="cpu")      # miss: lowers
            ServeEngine(cfg, run, tp, batch_size=2, max_len=32,
                        plan_cache=cache, device="cpu")      # hit: loads
        reg = obs_metrics.registry()
        assert reg.get("serve.plan_cache.miss").value == 1
        assert reg.get("serve.plan_cache.hit").value == 1
        assert [e["meta"]["status"] for e in
                tr.events_named("serve.plan_cache")] == ["miss", "hit"]

    def test_forced_drift_emits_exactly_one_hot_swap(self, tmp_path):
        (_, cfg, _, tp, _, run), (jchips, chips), (_, snap) = \
            _calibrated(tmp_path)
        obs_metrics.reset_metrics()
        mon = calib.DriftMonitor(chips, snap, threshold_lsb=0.5)
        eng = ServeEngine(cfg, run, tp, batch_size=2, max_len=32,
                          calibration=snap, drift_monitor=mon, device="cpu")
        with obs_trace.collect() as tr:
            eng.serve([Request(0, PROMPT, 2)])        # stable: probe only
            _drift(jchips, chips)
            eng.serve([Request(1, PROMPT, 2)])        # drifted: + swap
        probes = tr.events_named("drift.probe")
        assert len(probes) == 2
        assert probes[0]["meta"]["lsb"] <= 0.5 < probes[1]["meta"]["lsb"]
        assert len(tr.events_named("drift.hot_swap")) == 1
        reg = obs_metrics.registry()
        assert reg.get("drift.hot_swap").value == 1
        assert reg.get("serve.hot_swap").value == 1
        assert reg.get("drift.lsb").summary()["count"] == 2
        assert "serve.hot_swap" in tr.span_paths()


class TestServeSmokeGate:
    def test_serve_smoke_passes_on_the_cpu(self, tmp_path, capsys):
        path = tmp_path / "smoke.jsonl"
        assert obs_main(["--serve-smoke", str(path), "--device", "cpu"]) == 0
        assert "contract: OK" in capsys.readouterr().out
        names = {r["name"] for r in obs.report.load(str(path))}
        assert {"fleet.remap", "drift.hot_swap", "serve.plan_cache"} <= names

    def test_serve_smoke_fails_without_a_required_record(self, tmp_path,
                                                         monkeypatch, capsys):
        # a fleet monitor that never remaps: no fleet.remap record
        monkeypatch.setattr(FleetMonitor, "maybe_remap",
                            lambda self, model: None)
        assert obs_main(["--serve-smoke", str(tmp_path / "x.jsonl"),
                         "--device", "cpu"]) == 1
        out = capsys.readouterr().out
        assert "MISSING" in out and "fleet.remap" in out
