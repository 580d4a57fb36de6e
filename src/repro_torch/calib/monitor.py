"""Offset-drift monitoring for serving deployments (port of
``repro.calib.monitor``).

The fixed-pattern gain of a chip is stable, but ADC offsets drift with
temperature on deployment timescales.  :class:`DriftMonitor` closes that
loop for a serving engine: a cheap zero-input probe between batches
detects drift of the measured offsets away from the active snapshot, and
when it exceeds the threshold the monitor re-nulls the offsets (full
repeat count) and hands back a refreshed
:class:`~repro_torch.calib.snapshot.CalibrationSnapshot`.

The refresh touches ONLY measured-value tables - activation scales are
kept - so a compiled model hot-swaps it into its lowered plans
(:meth:`repro_torch.api.program.CompiledModel.with_calibration`) without
lowering anything: an offset-only refresh replaces the offset tables and
shares every weight store.

``gain_sweep=True`` adds a slow background gain track on top of the
offset loop: each probe cycle re-fits ONE chunk's gain row (round-robin
over every layer's chunks), staging the rows until the next refresh
folds them into the snapshot alongside the re-nulled offsets - so a
full gain re-scan amortizes over many serving batches and still rides
the same value-only hot-swap.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.calib.device import VirtualChip
from repro_torch.calib.routines import fit_gain_chunk, null_offsets
from repro_torch.calib.snapshot import CalibrationSnapshot
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


class DriftMonitor:
    """Watches the devices behind a snapshot and refreshes it on drift.

    chips:           {layer name -> VirtualChip}, the serving devices.
    snapshot:        the currently-deployed calibration.
    threshold_lsb:   RMS offset deviation (ADC LSB) that triggers a
                     refresh; default 0.5 (half an LSB - beyond that the
                     baked offsets are wrong by more than the rounding
                     floor).
    probe_repeats:   averaging depth of the cheap detection probe.
    refresh_repeats: averaging depth of the re-nulling measurement.
    every:           check cadence in :meth:`maybe_refresh` calls (the
                     engine calls it once per served batch).
    gain_sweep:      re-fit one chunk's gain row per probe cycle
                     (round-robin); staged rows fold into the next
                     refresh's hot-swap.
    gain_repeats:    averaging depth of each background gain fit.
    """

    def __init__(
        self,
        chips: Dict[str, VirtualChip],
        snapshot: CalibrationSnapshot,
        *,
        threshold_lsb: float = 0.5,
        probe_repeats: int = 16,
        refresh_repeats: int = 64,
        every: int = 1,
        gain_sweep: bool = False,
        gain_repeats: int = 8,
    ):
        self.chips = dict(chips)
        self.snapshot = snapshot
        self.threshold_lsb = float(threshold_lsb)
        self.probe_repeats = int(probe_repeats)
        self.refresh_repeats = int(refresh_repeats)
        self.every = max(int(every), 1)
        self.gain_sweep = bool(gain_sweep)
        self.gain_repeats = int(gain_repeats)
        self.refreshes = 0
        self._calls = 0
        self._gain_cursor = 0
        self._pending_gains: Dict[str, Dict[int, torch.Tensor]] = {}

    # --------------------------------------------------------------- probes
    def drift_lsb(self) -> float:
        """Worst per-layer RMS deviation (ADC LSB) of freshly probed
        offsets from the active snapshot's tables (one host read per
        layer: the threshold decision needs the number)."""
        worst = 0.0
        for name, chip in self.chips.items():
            rec = self.snapshot.layer(name)
            if rec is None or rec.chunk_offset is None:
                continue
            probe = null_offsets(chip, repeats=self.probe_repeats)
            ref = rec.chunk_offset.to(probe.device)
            rms = float(torch.sqrt(torch.mean((probe - ref) ** 2)))
            worst = max(worst, rms)
        return worst

    # ----------------------------------------------------- background gains
    def _gain_sites(self) -> List[Tuple[str, int]]:
        """(layer, chunk) sites the background sweep cycles over: every
        chunk of every layer the snapshot holds a plain [chunks, N] gain
        table for."""
        sites: List[Tuple[str, int]] = []
        for name, chip in self.chips.items():
            rec = self.snapshot.layer(name)
            gt = None if rec is None else rec.gain_table
            if gt is None or getattr(gt, "ndim", 2) != 2:
                continue
            sites.extend((name, c) for c in range(chip.n_chunks))
        return sites

    def sweep_gain_chunk(self) -> Optional[Tuple[str, int]]:
        """Re-fit ONE chunk's gain row (round-robin over every layer's
        chunks) and stage it; the next :meth:`refresh` folds every staged
        row into the snapshot.  Returns the probed (layer, chunk), or
        None when no layer carries a gain table."""
        sites = self._gain_sites()
        if not sites:
            return None
        name, c = sites[self._gain_cursor % len(sites)]
        self._gain_cursor += 1
        row = fit_gain_chunk(
            self.chips[name], c, repeats=self.gain_repeats
        )
        self._pending_gains.setdefault(name, {})[c] = row
        _trace.event("drift.gain_probe", layer=name, chunk=c)
        return name, c

    def refresh(self) -> CalibrationSnapshot:
        """Re-null every layer's offsets (full averaging depth), fold in
        any background-swept gain rows, and return the refreshed snapshot
        (activation scales untouched).  The refreshed snapshot becomes
        the monitor's new reference."""
        with _trace.span("drift.refresh", layers=len(self.chips)):
            snap = self.snapshot.with_offsets({
                name: null_offsets(chip, repeats=self.refresh_repeats)
                for name, chip in self.chips.items()
            })
            for name, rows in self._pending_gains.items():
                rec = snap.layer(name)
                if rec is None or rec.gain_table is None:
                    continue
                gt = rec.gain_table.clone()
                for c, row in rows.items():
                    gt[c] = row.to(gt.device)
                snap = snap.with_layer(
                    name, rec.replace(gain_table=gt)
                )
            self._pending_gains = {}
            self.snapshot = snap
        self.refreshes += 1
        _metrics.counter("drift.hot_swap").inc()
        _trace.event("drift.hot_swap", refreshes=self.refreshes)
        return self.snapshot

    def maybe_refresh(self) -> Optional[CalibrationSnapshot]:
        """The serving hook: probe on the configured cadence and return a
        refreshed snapshot iff drift exceeded the threshold (None
        otherwise - the engine keeps its plans)."""
        self._calls += 1
        if self._calls % self.every:
            return None
        if self.gain_sweep:
            self.sweep_gain_chunk()
        lsb = self.drift_lsb()
        _metrics.histogram("drift.lsb").record(lsb)
        _trace.event("drift.probe", lsb=round(lsb, 4),
                     threshold_lsb=self.threshold_lsb)
        if lsb <= self.threshold_lsb:
            return None
        return self.refresh()
