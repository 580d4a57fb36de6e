"""The port's observability package (``repro_torch.obs``) and its energy
account against the JAX package's ``repro.obs``, on the CPU.

- ``energy_report`` of the ECG plan and of the ``phi4-mini-3.8b-smoke``
  tree: equal to the reference's dict, key for key (the same Python float
  arithmetic over the same plan structure); the ECG plan reads 276.0 us
  per sample.
- The JSONL run format: a run dumped by the port renders with the
  reference's ``report.render`` exactly as with the port's, and the
  reverse; metric records round-trip.
- The instrumentation: the ``exec.*`` counters, the ``api.compile``
  span's ``lowerings``, and the serving engine's span tree, events and
  histograms on the smoke LM.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.models import ecg as JECG  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch import api, configs, obs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.energy import SystemModel, calibrate_t_ctrl  # noqa: E402
from repro_torch.data.ecg_synth import ECGDatasetConfig, make_dataset  # noqa: E402
from repro_torch.data.preprocess import preprocess  # noqa: E402
from repro_torch.exec.lower import lowering_count  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.ecg import ECGConfig, ecg_module_spec  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCH = "phi4-mini-3.8b"


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@functools.lru_cache(maxsize=None)
def _ecg(epilogue):
    jp = JECG.ecg_init(jax.random.PRNGKey(0), JECG.ECGConfig())
    jacfg = JAnalogConfig(act_calib="static")
    jm = japi.compile(JECG.ecg_module_spec(JECG.ECGConfig(),
                                           epilogue=epilogue), jp, jacfg)
    tm = api.compile(ecg_module_spec(ECGConfig(), epilogue=epilogue),
                     _port(jp), AnalogConfig(act_calib="static"),
                     device="cpu")
    return jm, tm


@functools.lru_cache(maxsize=None)
def _lm():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jp = JT.lm_init(jax.random.PRNGKey(0), jcfg)
    jm = japi.compile(JT.lm_module_spec(jcfg, jp), jp,
                      JRunConfig(analog=JAnalogConfig(mode="analog_faithful")))
    tp = _port(jp)
    run = RunConfig(analog=AnalogConfig(mode="analog_faithful"))
    tm = api.compile(T.lm_module_spec(cfg, tp), tp, run, device="cpu")
    return jm, tm, tp, cfg, run


class TestEnergy:
    def test_core_energy_is_the_reference_copy(self):
        from repro.core import energy as jenergy

        works = obs.energy.layer_works(_ecg("relu_shift")[1])
        jworks = [jenergy.LayerWork(w.k, w.n, w.vectors, w.passes_per_vector)
                  for w in works]
        assert SystemModel().t_ctrl == 251.944e-6
        assert SystemModel().report(works) == jenergy.SystemModel().report(
            jworks)
        assert calibrate_t_ctrl(works) == jenergy.calibrate_t_ctrl(jworks)

    @pytest.mark.parametrize("epilogue", ["relu_shift", "none"])
    def test_ecg_plan_matches_reference(self, epilogue):
        jm, tm = _ecg(epilogue)
        rep = obs.energy_report(tm)
        assert rep == jobs.energy_report(jm)
        assert obs.energy_report(tm.lower()) == rep
        assert rep["us_per_sample"] == pytest.approx(276.0, abs=1e-9)
        assert round(rep["us_per_sample"], 1) == 276.0
        assert rep["paper_uj_per_sample"] == 192.0
        assert obs.energy.format_report(rep) == jobs.energy.format_report(
            jobs.energy_report(jm))

    def test_lm_smoke_tree_matches_reference(self):
        jm, tm, *_ = _lm()
        rep = obs.energy_report(tm)
        assert rep == jobs.energy_report(jm)
        assert rep["layers"] > 0

    def test_record_publishes_gauges_and_event(self):
        obs.reset_metrics()
        with obs.collect("energy") as tr:
            rep = obs.energy.record(_ecg("relu_shift")[1], prefix="e")
        assert obs.registry().get("e.us_per_sample").value == \
            rep["us_per_sample"]
        (ev,) = tr.events_named("e")
        assert ev["meta"]["us_per_sample"] == round(rep["us_per_sample"], 3)

    def test_digital_model_has_no_analog_work(self):
        tm = api.compile(ecg_module_spec(ECGConfig()), _ecg("none")[1].params,
                         AnalogConfig(mode="digital"), device="cpu")
        rep = obs.energy_report(tm)
        assert rep["layers"] == 0 and rep["us_per_sample"] == 0.0


def _run_records(pkg):
    """A small run recorded through ``pkg``'s own trace and metrics."""
    pkg.reset_metrics()
    with pkg.collect("interop") as tr:
        with pkg.span("outer", batch=2) as sp:
            with pkg.span("inner"):
                pkg.event("tick", n=1)
            sp.add(tokens=5)
        pkg.event("done")
    pkg.counter("c").inc(3)
    pkg.gauge("g").set(1.5)
    for v in (10.0, 250.0, 4000.0):
        pkg.histogram("h_us").record(v)
    pkg.histogram("occ").record(0.5)
    return pkg.report.records_of(tr, pkg.registry())


class TestRecordFormat:
    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_run_renders_with_both_packages(self, writer, tmp_path):
        pkg, other = (obs, jobs) if writer == "port" else (jobs, obs)
        recs = _run_records(pkg)
        path = str(tmp_path / "run.jsonl")
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        loaded = other.report.load(path)
        assert loaded == json.loads(json.dumps(recs))
        assert other.report.render(loaded) == pkg.report.render(recs)
        assert {r["rec"] for r in loaded} == {
            "trace", "span", "event", "counter", "gauge", "histogram"}
        assert [r["path"] for r in loaded if r["rec"] == "span"] == [
            "outer/inner", "outer"]
        reg = other.metrics.Registry()
        reg.load_records(loaded)
        assert reg.to_records() == pkg.registry().to_records()
        assert other.report.required_missing(
            loaded, span_paths=("outer/inner",), events=("tick",),
            counters=("c",), histograms=("h_us",)) == []

    def test_dump_run_and_cli(self, tmp_path, capsys):
        from repro_torch.obs.__main__ import main

        recs = _run_records(obs)
        path = str(tmp_path / "run.jsonl")
        tr = obs.trace.Trace("interop")
        tr.events = [r for r in recs if r["rec"] in ("span", "event")]
        obs.report.dump_run(path, tr, obs.registry())
        assert main([path]) == 0
        out = capsys.readouterr().out
        assert "outer/inner" in out and "h_us" in out
        # the serve gate runs on the card unless asked for the CPU
        # (tests/test_torch_serve_hooks.py runs it there)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                main(["--serve-smoke", str(tmp_path / "x.jsonl")])

    def test_timing_loops_on_the_cpu(self):
        x = torch.ones(4)
        us = obs.timeit(lambda: x * 2, iters=2, warmup=1, blocks=2,
                        label="mul")
        assert us > 0.0
        assert obs.time_block(lambda: {"y": [x + 1]}, iters=2) > 0.0


class TestInstrumentation:
    def test_exec_counters_and_compile_span(self):
        _, tm = _ecg("relu_shift")
        raw, _ = make_dataset(ECGDatasetConfig(n_test=2), "test")
        x = preprocess(raw, device="cpu")
        obs.reset_metrics()
        with obs.collect("ecg") as tr:
            before = lowering_count()
            api.compile(tm.spec, tm.params, tm.run_cfg, device="cpu")
            tm.apply(x, megakernel=True)
            tm.apply(x, megakernel=False)
        reg = obs.registry()
        # eager: every call counts (the reference counts at trace time)
        assert reg.get("exec.run.megakernel").value == 1
        assert reg.get("exec.run.per_layer").value == 1
        assert reg.get("exec.dispatches").value == 1 + 3
        (sp,) = tr.spans("api.compile")
        assert sp["meta"]["lowerings"] == lowering_count() - before == 3
        assert sp["meta"]["spec"] == "ecg_cdnn"

    def test_engine_span_tree_and_histograms(self):
        _, _, tp, cfg, run = _lm()
        obs.reset_metrics()
        prompt = np.arange(6) % cfg.vocab_size
        with obs.collect("serve") as tr:
            eng = ServeEngine(cfg, run, tp, batch_size=2, max_len=32,
                              device="cpu")
            done = eng.serve([Request(i, prompt, 3) for i in range(3)])
        assert all(len(r.output) == 3 for r in done)
        recs = obs.report.records_of(tr, obs.registry())
        spans = ("serve.compile", "serve.compile/api.compile",
                 "serve.batch", "serve.batch/serve.prefill",
                 "serve.batch/serve.decode")
        hists = ("serve.queue_us", "serve.prefill_us", "serve.decode_us",
                 "serve.request_us", "serve.batch_occupancy")
        missing = jobs.report.required_missing(
            recs, span_paths=spans, events=("serve.refill", "serve.energy"),
            counters=("exec.dispatches",),
            histograms=hists)
        assert missing == []
        assert len(tr.spans("serve.batch")) == 2
        assert len(tr.events_named("serve.refill")) == 2
        reg = obs.registry()
        assert reg.get("serve.request_us").count == 3
        assert reg.get("serve.batch_occupancy").samples == [1.0, 0.5]
        # 2 decode steps per batch for 3 new tokens
        assert reg.get("serve.decode_us").count == 4
        (energy,) = tr.events_named("serve.energy")
        assert energy["meta"]["layers"] == obs.energy_report(
            eng.model)["layers"]

    @pytest.mark.parametrize("hook", ["calibration", "drift_monitor",
                                      "plan_cache", "fleet"])
    def test_engine_hooks_still_raise(self, hook):
        # the hooks are ported: one given an object that is no hook
        # raises at construction or at the first batch, never ignored
        _, _, tp, cfg, run = _lm()
        with pytest.raises((AttributeError, TypeError)):
            eng = ServeEngine(cfg, run, tp, device="cpu", **{hook: object()})
            eng.serve([Request(0, np.arange(3), 1)])
