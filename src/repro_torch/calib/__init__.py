"""Measurement-driven calibration: the measure side of the HIL contract
(port of ``repro.calib``).

The execute side (``repro_torch.exec`` consuming baked constants) bakes
from the ground-truth fixed pattern unless told otherwise; this package
PRODUCES the constants the only way real hardware allows - by measuring
an opaque device (paper §III-B):

    gen   = torch.Generator(device="cuda").manual_seed(2)
    chips = calib.model_chips(spec, params, gen)        # the devices
    snap  = calib.calibrate_model(spec, params, gen,    # measure + fit
                                  chips=chips)
    snap.save("chip0.npz")
    snap = calib.CalibrationSnapshot.load("chip0.npz")  # on the card
    model = api.compile(spec, params, acfg, calibration=snap)   # apply

    mon = calib.DriftMonitor(chips, snap)               # serve-time loop
    fresh = mon.maybe_refresh()                         # None: no drift
    if fresh is not None:
        model = model.with_calibration(fresh)           # no re-lowering

- :mod:`repro_torch.calib.device`   - VirtualChip: hidden fixed pattern
  + readout noise behind an opaque ``measure(weights, inputs) -> codes``.
- :mod:`repro_torch.calib.routines` - offset nulling, linearity-ramp gain
  fits, static activation scaling, whole-model drive.
- :mod:`repro_torch.calib.snapshot` - the versioned, serializable
  CalibrationSnapshot that ``exec.lower`` / ``api.compile`` consume.
- :mod:`repro_torch.calib.monitor`  - DriftMonitor: detect ADC-offset
  drift, re-null, hand back a hot-swappable refreshed snapshot.
"""
from repro_torch.calib.device import VirtualChip  # noqa: F401
from repro_torch.calib.monitor import DriftMonitor  # noqa: F401
from repro_torch.calib.routines import (  # noqa: F401
    DEFAULT_RAMP,
    calibrate_chip,
    calibrate_model,
    fit_activation_scales,
    fit_gain_chunk,
    fit_gain_table,
    model_chips,
    null_offsets,
    probe_gain,
    share_group_input_scale,
)
from repro_torch.calib.snapshot import (  # noqa: F401
    CalibrationSnapshot,
    LayerCalibration,
)
