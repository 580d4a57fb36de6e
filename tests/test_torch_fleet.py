"""The port's chip fleet (``repro_torch.fleet``) against the JAX package's
``repro.fleet``, on the CPU, mirroring ``tests/test_fleet.py``.

Randomness is passed in, never re-sampled: where both packages compute,
the fleet's measured tables are the reference's (its ``FleetSnapshot``
saved and loaded), so placement, the gather into per-layer snapshots, the
per-stack-member bake and the remap hot-swap are held against the
reference on the same tables.  Tolerances:

- placements: the same assignments, spares and geometry as the
  reference's, element for element;
- the batched fleet measurement and calibration against the port's own
  chips measured one at a time: bit-exact (each chip's readout noise from
  its own generator, drawn in its own call order);
- snapshots ``.npz`` both ways: every table bit for bit;
- a scan-stacked LM baked from the reference's fleet tables: every stack
  member's ``w_eff`` and offsets bit-exact against the reference's slice,
  logits within 1e-4 * max|logit| (the North-star contract: the
  effective weights are floats, so an ADC readout may round differently
  at a tie); a remap hot-swap the same, and bit-exact against a fresh
  compile of the remapped snapshot in the port.

The reference's verify rules (``TestVerifyFleetRules``) are mirrored in
``tests/test_torch_verify.py``.  Not mirrored here: the fleet-health mesh
test (``TestFleetHealthRouting``, waiting for the port's mesh).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro import fleet as jfleet  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.noise import NoiseConfig as JNoiseConfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.calib import CalibrationSnapshot, LayerCalibration  # noqa: E402
from repro_torch.calib.device import VirtualChip  # noqa: E402
from repro_torch.calib.monitor import DriftMonitor  # noqa: E402
from repro_torch.calib.routines import (calibrate_chip, chip_generator,  # noqa: E402
                                        null_offsets)
from repro_torch.configs.base import ArchConfig, RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.hw import BSS2  # noqa: E402
from repro_torch.core.noise import NOISELESS, NoiseConfig  # noqa: E402
from repro_torch.exec.lower import lowering_count  # noqa: E402
from repro_torch.exec.plan import PlanStack  # noqa: E402
from repro_torch.fleet import (ChipFleet, FleetMonitor, FleetSnapshot,  # noqa: E402
                               calibrate_fleet, fleet_null_offsets,
                               model_layer_shapes, model_snapshot,
                               place_model)
from repro_torch.fleet import placement as placement_mod  # noqa: E402
from repro_torch.fleet.placement import _layer_sites  # noqa: E402
from repro_torch.models import ecg as ECG  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

SHAPES = [("a", (256, 40)), ("b", (2, 128, 16)), ("c", (100, 300))]
LOGIT_TOL = 1e-4
LM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
          vocab_size=256)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _fresh_fleet(seed=0, n=3, noise=None):
    return ChipFleet.build(_gen(seed), n, slots=2, chunk_rows=64, cols=32,
                           noise=NoiseConfig() if noise is None else noise)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _as_tuples(pl):
    return ([dataclasses.astuple(a) for a in pl.assignments],
            tuple(pl.shapes), pl.n_chips, pl.slots, pl.chunk_rows, pl.cols,
            tuple(pl.spares))


class TestPlacement:
    def test_deterministic(self):
        a = place_model(SHAPES, n_chips=8, spares=2, chunk_rows=64, cols=128)
        b = place_model(SHAPES, n_chips=8, spares=2, chunk_rows=64, cols=128)
        assert a == b
        assert a != place_model(SHAPES, n_chips=9, spares=2, chunk_rows=64,
                                cols=128)
        want = jfleet.place_model(SHAPES, n_chips=8, spares=2,
                                  chunk_rows=64, cols=128)
        assert _as_tuples(a) == _as_tuples(want)

    def test_exact_site_coverage_and_empty_spares(self):
        pl = place_model(SHAPES, n_chips=8, spares=2, chunk_rows=64, cols=128)
        want = {s for name, shape in SHAPES
                for s in _layer_sites(name, shape, chunk_rows=64, cols=128)}
        assert {a.site for a in pl.assignments} == want
        assert len(pl.assignments) == len(want)
        for s in pl.spares:
            assert not pl.assignments_on(s)
        booked = [(a.chip, a.slot) for a in pl.assignments]
        assert len(set(booked)) == len(booked)

    def test_capacity_errors(self):
        with pytest.raises(ValueError, match="capacity"):
            place_model(SHAPES, n_chips=3, spares=1, slots=1, chunk_rows=64,
                        cols=128)
        with pytest.raises(ValueError, match="serving"):
            place_model(SHAPES, n_chips=2, spares=2)

    def test_remap_moves_only_dead_chip(self):
        pl = place_model(SHAPES, n_chips=8, spares=2, chunk_rows=64, cols=128)
        dead = pl.assignments[0].chip
        new, moved = pl.remap(dead)
        assert {a.site for a in moved} == {
            a.site for a in pl.assignments_on(dead)}
        assert not new.assignments_on(dead)
        spare = moved[0].chip
        assert spare in pl.spares and spare not in new.spares
        untouched = {a.site: a for a in pl.assignments if a.chip != dead}
        for a in new.assignments:
            if a.site in untouched:
                assert a == untouched[a.site]
        with pytest.raises(ValueError, match="spare pool"):
            pl.remap(dead, spare=dead)
        jnew, jmoved = jfleet.place_model(
            SHAPES, n_chips=8, spares=2, chunk_rows=64, cols=128).remap(dead)
        assert _as_tuples(new) == _as_tuples(jnew)
        assert [dataclasses.astuple(a) for a in moved] == [
            dataclasses.astuple(a) for a in jmoved]

    def test_remap_exhausts_spares(self):
        pl = place_model(SHAPES, n_chips=7, spares=1, chunk_rows=64, cols=128)
        new, _ = pl.remap(pl.assignments[0].chip)
        assert new.spares == ()
        with pytest.raises(ValueError, match="no spare"):
            new.remap(new.assignments[0].chip)


class TestFleetMeasure:
    def test_batched_equals_sequential_bit_exact(self):
        fa, fb = _fresh_fleet(), _fresh_fleet()
        rng = np.random.default_rng(0)
        w = torch.from_numpy(rng.integers(-63, 64, (fa.k, fa.n)).astype(
            np.float32))
        a = torch.from_numpy(rng.integers(0, 31, (5, fa.k)).astype(
            np.float32))
        adc = fa.measure(w, a)
        seq = torch.stack([c.measure(w, a) for c in fb.chips])
        assert adc.shape == (3, 5, fa.n_chunks, fa.n)
        assert torch.equal(adc, seq)
        assert fa.measurements == fb.measurements == 3

    def test_blocks_of_chips_equal_one_pass(self, monkeypatch):
        fa, fb = _fresh_fleet(), _fresh_fleet()
        w = torch.ones((fa.k, fa.n))
        a = torch.full((4, fa.k), 7.0)
        whole = fa.measure(w, a, gain=0.01)
        monkeypatch.setattr(placement_mod, "FLEET_BLOCK_BYTES", 1)
        assert torch.equal(fb.measure(w, a, gain=0.01), whole)

    def test_distinct_hidden_patterns(self):
        off = fleet_null_offsets(_fresh_fleet(), repeats=16)
        assert not torch.allclose(off[0], off[1])

    def test_dead_chip_rails_to_adc_min(self):
        fleet = _fresh_fleet()
        fleet.kill(1)
        assert fleet.dead_mask == [False, True, False]
        adc = fleet.measure(torch.zeros((fleet.k, fleet.n)),
                            torch.zeros((2, fleet.k)))
        assert bool((adc[1] == BSS2.adc_min).all())
        assert not bool((adc[0] == BSS2.adc_min).all())
        # a dead chip draws no readout noise, as its own measure() does
        fb = _fresh_fleet()
        fb.kill(1)
        again = torch.stack([c.measure(torch.zeros((fb.k, fb.n)),
                                       torch.zeros((2, fb.k)))
                             for c in fb.chips])
        assert torch.equal(adc, again)


class TestFleetCalibration:
    def test_batched_equals_per_chip_bit_exact(self):
        fa, fb = _fresh_fleet(), _fresh_fleet()
        snap = calibrate_fleet(fa, offset_repeats=8, gain_repeats=2)
        for i, chip in enumerate(fb.chips):
            rec = calibrate_chip(chip, offset_repeats=8, gain_repeats=2)
            assert torch.equal(snap.chip(i).gain_table, rec.gain_table)
            assert torch.equal(snap.chip(i).chunk_offset, rec.chunk_offset)

    def test_blind_recovery_every_chip(self):
        fleet = ChipFleet.build(_gen(), 4, slots=2, chunk_rows=64, cols=32,
                                noise=NoiseConfig())
        snap = calibrate_fleet(fleet)
        for i, chip in enumerate(fleet.chips):
            truth = chip.oracle()
            off = (snap.chunk_offset[i] - truth["chunk_offset"]).abs()
            assert float(off.max()) < 0.5
            rel = ((snap.gain_table[i] - truth["gain_table"])
                   / truth["gain_table"]).abs()
            assert float(rel.max()) < 0.03


class TestFleetSnapshot:
    def _snap(self):
        return calibrate_fleet(_fresh_fleet(), offset_repeats=4,
                               gain_repeats=1, source="unit")

    def test_npz_round_trip_bit_exact(self, tmp_path):
        snap = self._snap()
        p = tmp_path / "fleet.npz"
        snap.save(p)
        back = FleetSnapshot.load(p, device="cpu")
        assert torch.equal(back.gain_table, snap.gain_table)
        assert torch.equal(back.chunk_offset, snap.chunk_offset)
        assert back.version == snap.version and back.source == "unit"
        # the reference reads the port's file, and the port the reference's
        ref = jfleet.FleetSnapshot.load(p)
        np.testing.assert_array_equal(np.asarray(ref.gain_table),
                                      _np(snap.gain_table))
        ref.save(tmp_path / "ref.npz")
        again = FleetSnapshot.load(tmp_path / "ref.npz", device="cpu")
        assert torch.equal(again.chunk_offset, snap.chunk_offset)

    def test_version_gate(self, tmp_path):
        p = tmp_path / "fleet.npz"
        self._snap().save(p)
        z = dict(np.load(p, allow_pickle=False))
        z["__version__"] = np.asarray("repro-fleet-v0")
        with open(p, "wb") as f:
            np.savez(f, **z)
        with pytest.raises(ValueError, match="format"):
            FleetSnapshot.load(p, device="cpu")

    def test_with_chip_touches_one_chip(self):
        snap = self._snap()
        rec = LayerCalibration(
            gain_table=torch.full_like(snap.gain_table[1], 2.0),
            chunk_offset=torch.zeros_like(snap.chunk_offset[1]))
        out = snap.with_chip(1, rec)
        assert bool((out.gain_table[1] == 2.0).all())
        assert torch.equal(out.gain_table[0], snap.gain_table[0])
        assert torch.equal(out.chunk_offset[2], snap.chunk_offset[2])
        assert not bool((snap.gain_table[1] == 2.0).all())


def _codes_of(tree):
    """Every plan's weight-code tensor in a lowered tree, by identity."""
    out = []

    def walk(node):
        if isinstance(node, PlanStack):
            for m in node:
                walk(m)
        elif hasattr(node, "fused"):
            walk(node.fused)
        elif hasattr(node, "store"):
            out.append(node.store.codes)
        elif hasattr(node, "layers") and hasattr(node, "cfg"):
            for lp in node.layers:
                walk(lp)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)

    walk(tree)
    return out


def _ecg_fleet(twin_spare=False):
    """The ECG CDNN placed on a 6-chip fleet (2 spares), fleet-calibrated
    (no readout noise: recalibration is deterministic)."""
    cfg = ECG.ECGConfig()
    params = ECG.ecg_init(_gen(0), cfg, device="cpu")
    spec = ECG.ecg_module_spec(cfg)
    pl = place_model(model_layer_shapes(spec, params), n_chips=6, spares=2)
    noise = NoiseConfig(readout_std=0.0)
    seeds = list(range(pl.n_chips))
    if twin_spare:
        seeds[4] = 0     # spare 4 carries the hidden pattern of chip 0
    chips = [VirtualChip(chip_generator(_gen(7), s, torch.device("cpu")),
                         pl.slots * pl.chunk_rows, pl.cols, noise=noise,
                         chunk_rows=pl.chunk_rows) for s in seeds]
    fleet = ChipFleet(chips)
    fsnap = calibrate_fleet(fleet, offset_repeats=8, gain_repeats=2)
    acfg = AnalogConfig(act_calib="static", signed_input="none",
                        noise=NOISELESS)
    model = api.compile(spec, params, acfg,
                        calibration=model_snapshot(pl, fsnap), device="cpu")
    return model, pl, fleet, fsnap


def _ecg_x():
    return torch.randn((2, 2, 126), generator=_gen(1))


class TestRemapHotSwap:
    def test_kill_remap_swaps_without_lowering(self):
        model, pl, fleet, fsnap = _ecg_fleet()
        x = _ecg_x()
        y0 = model.apply(x)
        dead = pl.assignments[0].chip
        fleet.kill(dead)
        mon = FleetMonitor(fleet, pl, fsnap, probe_repeats=4,
                           spare_offset_repeats=8, spare_gain_repeats=2)
        assert mon.dead_chips() == [dead]       # blind detection
        before = lowering_count()
        new_model = mon.maybe_remap(model)
        assert new_model is not None and mon.remaps == 1
        # the reference books the moved chunks as lowerings; the port
        # counts lower_layer calls, and a remap makes none: every weight
        # code tensor is the one the model had before
        assert lowering_count() == before
        assert all(a is b for a, b in zip(_codes_of(model.lower()),
                                          _codes_of(new_model.lower())))
        full = api.compile(model.spec, model.params, model.run_cfg,
                           calibration=new_model.calibration, device="cpu")
        assert torch.equal(new_model.apply(x), full.apply(x))
        assert new_model.apply(x).shape == y0.shape
        assert mon.placement.assignments_on(dead) == ()

    def test_twin_spare_restores_bit_exact_output(self):
        model, pl, fleet, fsnap = _ecg_fleet(twin_spare=True)
        x = _ecg_x()
        y0 = model.apply(x)
        assert pl.assignments_on(0)
        fleet.kill(0)
        mon = FleetMonitor(fleet, pl, fsnap, probe_repeats=4,
                           spare_offset_repeats=8, spare_gain_repeats=2)
        new_model = mon.remap(model, 0)
        assert torch.equal(new_model.apply(x), y0)

    def test_remap_requires_calibrated_model(self):
        model, pl, fleet, fsnap = _ecg_fleet()
        bare = dataclasses.replace(model, calibration=None)
        with pytest.raises(ValueError, match="calibration"):
            FleetMonitor(fleet, pl, fsnap).remap(bare, 0)


def _lm_pair():
    cfg = ArchConfig("fleet-t", "dense", **LM)
    jcfg = JArchConfig("fleet-t", "dense", **LM)
    jp = JT.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jcfg, jp, tp


def _w_effs(tree):
    """{path: w_eff} of every plan in a lowered LM tree, stack members
    stacked on axis 0 (the reference's layout)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
            return
        if isinstance(node, PlanStack):
            members = [m.fused if hasattr(m, "fused") else m for m in node]
            out[path] = (np.stack([_np(m.store.w_eff) for m in members]),
                         np.stack([_np(m.chunk_offset) for m in members]))
        elif hasattr(node, "fused") or hasattr(node, "store"):
            lp = node.fused if hasattr(node, "fused") else node
            out[path] = (np.asarray(lp.store.w_eff),
                         np.asarray(lp.chunk_offset))

    walk(tree, "")
    return out


def _logits(model, toks):
    y = model.apply({"tokens": toks})
    return _np(y[0])


class TestStackedFleetBake:
    def test_scan_stacked_tables_bake_and_swap(self, tmp_path):
        """A scan-stacked LM placed per physical device: the reference's
        [S, C, N] fleet tables bake every stack member (w_eff, offsets
        and logits against the reference's), and a remap hot-swap of the
        stacked tables equals the reference's and a fresh compile, with
        nothing lowered."""
        cfg, jcfg, jp, tp = _lm_pair()
        jrun = JRunConfig(analog=JAnalogConfig(mode="analog_faithful",
                                               chunk_rows=64),
                          activation_dtype="float32")
        run = RunConfig(analog=AnalogConfig(mode="analog_faithful",
                                            chunk_rows=64),
                        activation_dtype="float32")
        jspec, spec = JT.lm_module_spec(jcfg, jp), T.lm_module_spec(cfg, tp)
        kw = dict(n_chips=19, spares=2, chunk_rows=64, cols=256)
        jpl = jfleet.place_model(jfleet.model_layer_shapes(jspec, jp), **kw)
        pl = place_model(model_layer_shapes(spec, tp), **kw)
        assert _as_tuples(pl) == _as_tuples(jpl)
        assert any(a.stack >= 0 for a in pl.assignments)
        jchips = jfleet.ChipFleet.for_placement(
            jax.random.PRNGKey(3), jpl, noise=JNoiseConfig(readout_std=0.0))
        jfsnap = jfleet.calibrate_fleet(jchips, offset_repeats=4,
                                        gain_repeats=1)
        jfsnap.save(tmp_path / "fleet.npz")
        fsnap = FleetSnapshot.load(tmp_path / "fleet.npz", device="cpu")
        jm = japi.compile(jspec, jp, jrun,
                          calibration=jfleet.model_snapshot(jpl, jfsnap))
        tm = api.compile(spec, tp, run, calibration=model_snapshot(pl, fsnap),
                         device="cpu")
        stacked = tm.lower()["layers"]["l0"]["mlp"]["up"]["_plan"]
        assert isinstance(stacked, PlanStack)
        assert all(m.store.chunk_gain is not None and m.store.code_operand
                   for m in stacked)
        want = _w_effs(jm.lower())
        got = _w_effs(tm.lower())
        assert set(got) <= set(want) and len(got) >= 6
        for path, (w, off) in got.items():
            np.testing.assert_array_equal(w, want[path][0], err_msg=path)
            np.testing.assert_array_equal(off, want[path][1], err_msg=path)
        toks = np.arange(4, dtype=np.int32)[None] % cfg.vocab_size
        ttoks = torch.as_tensor(toks, dtype=torch.long)
        y_ref = np.asarray(jm.apply({"tokens": jax.numpy.asarray(toks)})[0])
        y = _logits(tm, ttoks)
        assert np.abs(y - y_ref).max() <= LOGIT_TOL * np.abs(y_ref).max()

        # kill a chip that holds stacked tiles; the reference remaps and
        # recalibrates its spare; the port swaps the same tables in
        victim = next(a.chip for a in pl.assignments if a.stack >= 0)
        jchips.kill(victim)
        jmon = jfleet.FleetMonitor(jchips, jpl, jfsnap, probe_repeats=4,
                                   spare_offset_repeats=4,
                                   spare_gain_repeats=1)
        jnew = jmon.maybe_remap(jm)
        assert jnew is not None
        jmon.snapshot.save(tmp_path / "fleet2.npz")
        fsnap2 = FleetSnapshot.load(tmp_path / "fleet2.npz", device="cpu")
        pl2, moved = pl.remap(victim)
        names = sorted({a.layer for a in moved})
        assert any(shape[0] for name, shape in pl.shapes
                   if name in names and len(shape) == 3)
        before = lowering_count()
        tnew = tm.with_calibration(model_snapshot(
            pl2, fsnap2, base=tm.calibration, layers=names))
        assert lowering_count() == before
        want = _w_effs(jnew.lower())
        for path, (w, off) in _w_effs(tnew.lower()).items():
            np.testing.assert_array_equal(w, want[path][0], err_msg=path)
            np.testing.assert_array_equal(off, want[path][1], err_msg=path)
        y_ref = np.asarray(jnew.apply({"tokens": jax.numpy.asarray(toks)})[0])
        y_hot = _logits(tnew, ttoks)
        assert np.abs(y_hot - y_ref).max() <= LOGIT_TOL * np.abs(y_ref).max()
        full = api.compile(spec, tp, run, calibration=tnew.calibration,
                           device="cpu")
        np.testing.assert_array_equal(y_hot, _logits(full, ttoks))


class TestServeEngineFleet:
    def test_engine_remaps_between_batches(self):
        cfg = ArchConfig("fleet-serve", "dense", **LM)
        run = RunConfig(analog=AnalogConfig(mode="analog", chunk_rows=64))
        params = T.lm_init(_gen(0), cfg, device="cpu")
        spec = T.lm_module_spec(cfg, params)
        pl = place_model(model_layer_shapes(spec, params), n_chips=19,
                         spares=2, chunk_rows=64, cols=256)
        fleet = ChipFleet.for_placement(_gen(5), pl, noise=NOISELESS)
        fsnap = calibrate_fleet(fleet, offset_repeats=4, gain_repeats=1)
        mon = FleetMonitor(fleet, pl, fsnap, probe_repeats=4,
                           spare_offset_repeats=4, spare_gain_repeats=1)
        eng = ServeEngine(cfg, run, params, batch_size=2, max_len=32,
                          calibration=model_snapshot(pl, fsnap), fleet=mon,
                          device="cpu")
        eng.serve([Request(uid=0, prompt=np.array([1, 2, 3]),
                           max_new_tokens=2)])
        assert mon.remaps == 0                 # healthy fleet: no remap
        fleet.kill(pl.assignments[0].chip)
        before = lowering_count()
        out = eng.serve([Request(uid=1, prompt=np.array([4, 5]),
                                 max_new_tokens=2)])
        assert mon.remaps == 1                 # the probe caught it
        assert lowering_count() == before
        assert out[0].output is not None and len(out[0].output) == 2


class TestDriftMonitorGainSweep:
    def _chip_and_snapshot(self):
        chip = VirtualChip(_gen(0), 256, 16,
                           noise=NoiseConfig(readout_std=0.0))
        snap = CalibrationSnapshot().with_layer("l", LayerCalibration(
            gain_table=torch.ones((chip.n_chunks, chip.n)),
            chunk_offset=null_offsets(chip, repeats=4)))
        return chip, snap

    def test_round_robin_covers_every_chunk(self):
        chip, snap = self._chip_and_snapshot()
        mon = DriftMonitor({"l": chip}, snap, gain_sweep=True,
                           gain_repeats=2)
        probed = [mon.sweep_gain_chunk() for _ in range(chip.n_chunks)]
        assert probed == [("l", 0), ("l", 1)]
        assert mon.sweep_gain_chunk() == ("l", 0)

    def test_refresh_folds_staged_gains(self):
        chip, snap = self._chip_and_snapshot()
        mon = DriftMonitor({"l": chip}, snap, gain_sweep=True,
                           gain_repeats=4)
        for _ in range(chip.n_chunks):
            mon.sweep_gain_chunk()
        rec = mon.refresh().layer("l")
        truth = chip.oracle()["gain_table"]
        assert float(((rec.gain_table - truth) / truth).abs().max()) < 0.03
        assert not mon._pending_gains

    def test_sweep_off_by_default(self):
        chip, snap = self._chip_and_snapshot()
        mon = DriftMonitor({"l": chip}, snap)
        assert mon.maybe_refresh() is None
        assert not mon._pending_gains
