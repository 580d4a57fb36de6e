"""Chip-fleet scale-out: placement, batched fleet calibration, failure
remap (port of ``repro.fleet``).

The paper serves ONE BSS-2 mobile chip; a model larger than one chip is
spread over many small analog arrays, each with its own measured
calibration.  This package makes the chip a placement target:

    shapes = fleet.model_layer_shapes(spec, params)
    pl     = fleet.place_model(shapes, n_chips=6, spares=2)  # deterministic
    chips  = fleet.ChipFleet.for_placement(generator, pl)   # the devices
    fsnap  = fleet.calibrate_fleet(chips)       # one batched measure/step
    snap   = fleet.model_snapshot(pl, fsnap)    # [D, C, N] -> per layer
                                                # [C, N] / [S, C, N]
    model  = api.compile(spec, params, run, calibration=snap)   # bake
    mon    = fleet.FleetMonitor(chips, pl, fsnap)                # serving
    engine = ServeEngine(..., calibration=snap, fleet=mon)

- :mod:`repro_torch.fleet.placement` - ``Placement``: every layer chunk
  (``core.partition.plan_tiles``) assigned to a (chip, slot) of a
  ``ChipFleet`` of :class:`~repro_torch.calib.device.VirtualChip`\\ s,
  with a spare pool and a deterministic first-fit packing.
- :mod:`repro_torch.fleet.calibrate` - fleet calibration into a
  ``FleetSnapshot`` (``[D, C, N]`` tables, ``.npz``), and the gather back
  to the per-layer ``CalibrationSnapshot`` (``[S, C, N]`` tables for
  scan-stacked layers).
- :mod:`repro_torch.fleet.health` - ``FleetMonitor``: per-chip probe
  heartbeats, dead-chip detection, and ``remap()`` onto a spare as a
  table hot-swap, exactly like a drift refresh.
"""
from repro_torch.fleet.calibrate import (  # noqa: F401
    FLEET_FORMAT_VERSION,
    FleetSnapshot,
    calibrate_fleet,
    fleet_fit_gain_table,
    fleet_null_offsets,
    model_snapshot,
)
from repro_torch.fleet.health import FleetMonitor  # noqa: F401
from repro_torch.fleet.placement import (  # noqa: F401
    ChipFleet,
    ChunkAssignment,
    Placement,
    model_layer_shapes,
    place_model,
)
