"""Fleet calibration: every chip measured in one batched sweep (port of
``repro.fleet.calibrate``).

Each BSS-2 chip needs its own measured calibration; this module runs the
blind measure -> fit pipeline of :mod:`repro_torch.calib.routines`
against a whole :class:`~repro_torch.fleet.placement.ChipFleet` at once -
the per-chip ``[C, N]`` tables become fleet ``[D, C, N]`` tables in a
serializable :class:`FleetSnapshot` (``.npz``, the reference's format
``repro-fleet-v1``, so a snapshot saved by either package loads into the
other).

Every step is ONE fleet-wide measurement (:meth:`ChipFleet.measure`, the
chips' tables stacked on a device axis) instead of a loop over chips,
and the fits apply the reductions of :func:`~repro_torch.calib.routines.
null_offsets` / :func:`~repro_torch.calib.routines.fit_gain_chunk` over
the stacked axis, so ``calibrate_fleet(fleet).chip(i)`` equals
``calibrate_chip(fleet[i])`` on a fresh chip bit for bit, on the card
too (``scripts/fleet_order.py`` checks it on the card).

:func:`model_snapshot` gathers the fleet tables back through a
:class:`~repro_torch.fleet.placement.Placement` into the per-layer
snapshot ``api.compile(calibration=)`` consumes - ``[S, C, N]`` tables
for scan-stacked layers (S physical devices per stacked matrix), which
bake into the members of the layer's
:class:`~repro_torch.exec.plan.PlanStack`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.calib.routines import (DEFAULT_RAMP, _chunk_rows_real,
                                        probe_gain)
from repro_torch.calib.snapshot import CalibrationSnapshot, LayerCalibration
from repro_torch.core import quant
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.hw import BSS2
from repro_torch.core.partition import plan_tiles
from repro_torch.fleet.placement import ChipFleet, Placement
from repro_torch.obs import trace as _trace

FLEET_FORMAT_VERSION = "repro-fleet-v1"


@dataclasses.dataclass(frozen=True)
class FleetSnapshot:
    """One calibration run over a whole fleet: ``[D, C, N]`` tables
    (device, chunk-slot, column), versioned and serializable."""

    gain_table: torch.Tensor      # [D, C, N]
    chunk_offset: torch.Tensor    # [D, C, N]
    version: str = FLEET_FORMAT_VERSION
    source: str = ""

    @property
    def n_chips(self) -> int:
        return self.gain_table.shape[0]

    def chip(self, i: int) -> LayerCalibration:
        """One chip's record, in the per-layer snapshot vocabulary."""
        return LayerCalibration(gain_table=self.gain_table[i],
                                chunk_offset=self.chunk_offset[i])

    def with_chip(self, i: int, rec: LayerCalibration) -> "FleetSnapshot":
        """Replace ONE chip's tables (e.g. a freshly calibrated spare);
        every other chip's values are kept."""
        gain, off = self.gain_table.clone(), self.chunk_offset.clone()
        gain[i] = torch.as_tensor(rec.gain_table, dtype=torch.float32)
        off[i] = torch.as_tensor(rec.chunk_offset, dtype=torch.float32)
        return dataclasses.replace(self, gain_table=gain, chunk_offset=off)

    def save(self, path) -> None:
        """Serialize to one ``.npz`` (bit-exact round trip, no pickle)."""
        arrays = {
            "__version__": np.asarray(self.version),
            "__source__": np.asarray(self.source),
            "gain_table": self.gain_table.detach().cpu().numpy(),
            "chunk_offset": self.chunk_offset.detach().cpu().numpy(),
        }
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(cls, path, device: DeviceLike = None) -> "FleetSnapshot":
        """Load a fleet snapshot saved by either package, its tables on
        ``device`` (``None`` = the CUDA device)."""
        dev = resolve_device(device)
        with np.load(path, allow_pickle=False) as z:
            version = str(z["__version__"])
            if version != FLEET_FORMAT_VERSION:
                raise ValueError(
                    f"fleet snapshot format {version!r} is not "
                    f"{FLEET_FORMAT_VERSION!r}; re-measure or migrate")
            return cls(gain_table=torch.as_tensor(z["gain_table"],
                                                  device=dev),
                       chunk_offset=torch.as_tensor(z["chunk_offset"],
                                                    device=dev),
                       version=version, source=str(z["__source__"]))


def fleet_null_offsets(fleet: ChipFleet, *, repeats: int = 64
                       ) -> torch.Tensor:
    """Offset nulling for every chip at once: zero weights, zero events,
    ONE fleet measurement, average the repeats.  Returns [D, C, N]."""
    f32 = dict(dtype=torch.float32, device=fleet.device)
    adc = fleet.measure(torch.zeros((fleet.k, fleet.n), **f32),
                        torch.zeros((repeats, fleet.k), **f32))
    return adc.mean(dim=1)                          # [D, R, C, N] -> mean R


def fleet_fit_gain_table(fleet: ChipFleet, *,
                         levels: Sequence[int] = DEFAULT_RAMP,
                         repeats: int = 8) -> torch.Tensor:
    """Linearity-ramp gain fit for every chip at once: per chunk-slot,
    ONE fleet measurement of the ramp probe, least-squares slope per
    (device, column).  Returns [D, C, N] unitless multipliers - per chip
    exactly :func:`repro_torch.calib.routines.fit_gain_chunk` (the same
    probe, measurement order and reductions)."""
    f32 = dict(dtype=torch.float32, device=fleet.device)
    g = probe_gain(fleet.chunk_rows)
    alphas = torch.tensor(levels, **f32)
    da = alphas - alphas.mean()
    tables = []
    for c in range(fleet.n_chunks):
        lo = c * fleet.chunk_rows
        hi = min(fleet.k, (c + 1) * fleet.chunk_rows)
        w = torch.zeros((fleet.k, fleet.n), **f32)
        w[lo:hi] = 1.0
        a = torch.zeros((len(levels), repeats, fleet.k), **f32)
        a[:, :, lo:hi] = alphas[:, None, None]
        adc = fleet.measure(w, a, gain=g)[..., c, :]     # [D, L, R, N]
        y = adc.mean(dim=2)                               # [D, L, N]
        slope = (da[None, :, None] * (y - y.mean(dim=1)[:, None])).sum(1) \
            / (da ** 2).sum()
        tables.append(quant._div_exact(
            slope, g * _chunk_rows_real(fleet[0], c)))
    return torch.stack(tables, dim=1)                    # [D, C, N]


def calibrate_fleet(fleet: ChipFleet, *, offset_repeats: int = 64,
                    gain_levels: Sequence[int] = DEFAULT_RAMP,
                    gain_repeats: int = 8, source: str = ""
                    ) -> FleetSnapshot:
    """Full blind calibration of every chip in the fleet: gain fit, then
    offset nulling (the :func:`~repro_torch.calib.routines.calibrate_chip`
    order, so each chip's measurement sequence - and its readout-noise
    stream - matches a run of that chip alone)."""
    with _trace.span("fleet.calibrate", chips=len(fleet)):
        gain = fleet_fit_gain_table(fleet, levels=gain_levels,
                                    repeats=gain_repeats)
        offset = fleet_null_offsets(fleet, repeats=offset_repeats)
    return FleetSnapshot(gain_table=gain, chunk_offset=offset,
                         source=source)


def model_snapshot(placement: Placement, fleet_snapshot: FleetSnapshot, *,
                   base: Optional[CalibrationSnapshot] = None,
                   layers: Optional[Sequence[str]] = None,
                   source: Optional[str] = None) -> CalibrationSnapshot:
    """Gather fleet ``[D, C, N]`` tables into the per-layer snapshot that
    ``api.compile(calibration=)`` bakes into plans.

    Each placed layer gets a full-width ``[C, N_layer]`` gain/offset table
    (``[S, C, N_layer]`` for scan-stacked layers, one device set per
    stack member) assembled from its assignments' (chip, slot) tables;
    column tiles concatenate along N.  ``base`` supplies the records to
    extend (activation scales and any unplaced layer survive untouched);
    ``layers`` restricts the gather to the named layers - the remap
    hot-swap path, where every OTHER layer keeps its tables.  The tables
    are gathered on the host and land on the fleet snapshot's device."""
    if fleet_snapshot.n_chips < placement.n_chips:
        raise ValueError(f"fleet snapshot covers {fleet_snapshot.n_chips} "
                         f"chips, placement expects {placement.n_chips}")
    dev = fleet_snapshot.gain_table.device
    gain = fleet_snapshot.gain_table.detach().cpu().numpy()
    offset = fleet_snapshot.chunk_offset.detach().cpu().numpy()
    spec = dataclasses.replace(BSS2, signed_rows=placement.chunk_rows,
                               n_cols=placement.cols)
    by_layer = placement.by_layer()
    snap = base if base is not None else CalibrationSnapshot()
    if source is not None or base is None:
        snap = dataclasses.replace(
            snap, source=source if source is not None
            else fleet_snapshot.source)
    names = placement.layer_names() if layers is None else layers
    shapes = dict(placement.shapes)
    for name in names:
        shape = shapes[name]
        stacked = len(shape) == 3
        k, n = shape[-2], shape[-1]
        grid = plan_tiles(k, n, spec=spec)
        lead = (shape[0],) if stacked else ()
        g = np.ones(lead + (grid.row_chunks, n), np.float32)
        o = np.zeros(lead + (grid.row_chunks, n), np.float32)
        for a in by_layer.get(name, []):
            c0 = a.coltile * placement.cols
            w = min(n - c0, placement.cols)
            idx = ((a.stack,) if stacked else ()) + (a.chunk,
                                                     slice(c0, c0 + w))
            g[idx] = gain[a.chip, a.slot, :w]
            o[idx] = offset[a.chip, a.slot, :w]
        rec = snap.layer(name) or LayerCalibration()
        snap = snap.with_layer(name, rec.replace(
            gain_table=torch.as_tensor(g, device=dev),
            chunk_offset=torch.as_tensor(o, device=dev)))
    return snap
