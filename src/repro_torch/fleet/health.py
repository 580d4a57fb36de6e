"""Fleet health: probe heartbeats, dead-chip detection, remap hot-swap
(port of ``repro.fleet.health``).

:class:`FleetMonitor` is the fleet-scale sibling of
:class:`~repro_torch.calib.monitor.DriftMonitor`: between serving batches
it runs the same zero-input probe - fleet-wide, one batched measurement -
and compares each chip's readback against its calibrated offset tables.
A drifted chip moves the residual by fractions of an LSB; a dead chip
reads rail-pinned ``adc_min`` and blows the residual past any drift
threshold.  Detection is blind: the monitor sees only measurements,
never the chip's hidden ``dead`` flag.

``remap()`` is the failure path, built as a hot-swap, not a redeploy:
re-place only the dead chip's chunks onto a spare, freshly calibrate that
one spare, gather ONLY the affected layers' tables
(:func:`~repro_torch.fleet.calibrate.model_snapshot` with ``layers=``),
and push them through ``CompiledModel.with_calibration`` - the same
table swap a drift refresh uses.  Every other layer keeps its tables,
and nothing is lowered: the weight codes of every plan are shared with
the model before the swap.  (The reference books the moved chunks as
lowerings; :func:`~repro_torch.exec.lower.lowering_count` counts
``lower_layer`` calls, so a remap leaves it where it was.)

Telemetry: ``fleet.probe`` / ``fleet.remap`` events, a per-chip
``fleet.drift_lsb`` histogram, ``fleet.occupancy`` / ``fleet.spares``
gauges, a ``fleet.remap`` counter and span.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.calib.routines import DEFAULT_RAMP, calibrate_chip
from repro_torch.fleet.calibrate import (FleetSnapshot, fleet_null_offsets,
                                         model_snapshot)
from repro_torch.fleet.placement import ChipFleet, Placement
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


class FleetMonitor:
    """Serving-loop health checks for a placed, calibrated fleet.

    fleet:     the devices (measurement access only).
    placement: the live chunk -> chip assignment (updated by remap).
    snapshot:  the fleet's calibrated tables (spares recalibrated on
               promotion).
    dead_threshold_lsb: probe RMS above this marks a chip dead.  Drift
               moves the residual by ~0.1 LSB per step and the drift
               monitor refreshes around 0.5; a rail-pinned chip sits near
               |adc_min| = 128 LSB, so the default 16 separates the two.
    every:     probe cadence in ``maybe_remap`` calls (batches).
    """

    def __init__(self, fleet: ChipFleet, placement: Placement,
                 snapshot: FleetSnapshot, *,
                 dead_threshold_lsb: float = 16.0, probe_repeats: int = 16,
                 spare_offset_repeats: int = 64,
                 spare_gain_levels: Sequence[int] = DEFAULT_RAMP,
                 spare_gain_repeats: int = 8, every: int = 1):
        self.fleet = fleet
        self.placement = placement
        self.snapshot = snapshot
        self.dead_threshold_lsb = float(dead_threshold_lsb)
        self.probe_repeats = int(probe_repeats)
        self.spare_offset_repeats = int(spare_offset_repeats)
        self.spare_gain_levels = tuple(spare_gain_levels)
        self.spare_gain_repeats = int(spare_gain_repeats)
        self.every = int(every)
        self.remaps = 0
        self._calls = 0
        self._set_gauges()

    def _set_gauges(self) -> None:
        occ = self.placement.occupancy()
        _metrics.gauge("fleet.occupancy").set(
            sum(occ.values()) / max(len(occ), 1))
        _metrics.gauge("fleet.spares").set(len(self.placement.spares))

    def probe_lsb(self) -> torch.Tensor:
        """Per-chip probe residual [D]: RMS of a fresh zero-input fleet
        probe against the calibrated offset tables, in ADC LSB."""
        probe = fleet_null_offsets(self.fleet, repeats=self.probe_repeats)
        res = probe - self.snapshot.chunk_offset.to(probe.device)
        return torch.sqrt((res ** 2).mean(dim=(1, 2)))

    def dead_chips(self, lsb: Optional[torch.Tensor] = None) -> List[int]:
        """Chips past the dead threshold that hold serving assignments (a
        failed spare costs capacity but needs no remap)."""
        if lsb is None:
            lsb = self.probe_lsb()
        return [i for i, v in enumerate(lsb.tolist())
                if v > self.dead_threshold_lsb
                and self.placement.assignments_on(i)]

    def maybe_remap(self, model):
        """One health check: probe every chip, record telemetry, and if a
        serving chip is dead, remap it (one chip per cycle), returning the
        hot-swapped model; None when nothing changed."""
        self._calls += 1
        if self._calls % self.every:
            return None
        lsb = self.probe_lsb()
        values = lsb.tolist()          # one host read: the decision needs it
        hist = _metrics.histogram("fleet.drift_lsb")
        for v in values:
            hist.record(v)
        _trace.event("fleet.probe", max_lsb=round(max(values), 4),
                     threshold_lsb=self.dead_threshold_lsb)
        dead = self.dead_chips(lsb)
        if not dead:
            return None
        return self.remap(model, dead[0])

    def remap(self, model, dead: int, *, spare: Optional[int] = None):
        """Hot-swap recovery from one chip failure: re-place the dead
        chip's chunks onto a spare, blind-calibrate that spare, gather
        ONLY the affected layers' tables onto the model's current
        snapshot and swap them in; returns the new model and updates the
        monitor's live placement and snapshot."""
        if model.calibration is None:
            raise ValueError(
                "fleet remap hot-swaps calibration tables; compile the "
                "model with calibration= first")
        with _trace.span("fleet.remap", dead=dead):
            new_placement, moved = self.placement.remap(dead, spare=spare)
            if not moved:
                raise ValueError(f"chip {dead} holds no assignments")
            spare_id = moved[0].chip
            rec = calibrate_chip(
                self.fleet[spare_id],
                offset_repeats=self.spare_offset_repeats,
                gain_levels=self.spare_gain_levels,
                gain_repeats=self.spare_gain_repeats)
            self.snapshot = self.snapshot.with_chip(spare_id, rec)
            names = sorted({a.layer for a in moved})
            snap = model_snapshot(new_placement, self.snapshot,
                                  base=model.calibration, layers=names)
            new_model = model.with_calibration(snap)
        self.placement = new_placement
        self.remaps += 1
        self._set_gauges()
        _metrics.counter("fleet.remap").inc()
        _trace.event("fleet.remap", dead=dead, spare=spare_id,
                     chunks=len(moved), layers=len(names))
        return new_model
