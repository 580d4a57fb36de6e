"""Versioned calibration state: what measurement produced, frozen (port
of ``repro.calib.snapshot``).

A :class:`CalibrationSnapshot` is the durable artifact of one calibration
run against one device.  It maps layer names (stack-spec layer names or
dotted tree paths) to :class:`LayerCalibration` records:

- ``gain_table``    [C, N]: per-(chunk, column) fixed-pattern gain
                    multipliers fitted from linearity ramp sweeps,
- ``chunk_offset``  [C, N]: per-(chunk, column) ADC offsets from
                    zero-input nulling,
- ``a_scale``       scalar: static activation LSB fitted from a
                    calibration batch,
- ``a_scale_in``    scalar: the SHARED input LSB of a fused dispatch
                    group (one physical input encoding per group).

The tables are fp32 tensors, each on the device it was measured on (or
the one :meth:`CalibrationSnapshot.load` was given); ``exec.lower``
moves them to the parameters' device.  ``save``/``load`` round-trip bit
for bit through one ``.npz`` file in the reference's format
``repro-calib-v1`` (no pickling), so a snapshot saved by either package
loads into the other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device

FORMAT_VERSION = "repro-calib-v1"

_FIELDS = ("gain_table", "chunk_offset", "a_scale", "a_scale_in")
_SEP = "::"


@dataclasses.dataclass(frozen=True)
class LayerCalibration:
    """Measured calibration record for ONE analog layer.  Every field is
    optional: absent quantities fall back to the layer's own parameters
    at lower time (see :func:`repro_torch.exec.lower.lower_layer`)."""

    gain_table: Optional[torch.Tensor] = None     # [C, N]
    chunk_offset: Optional[torch.Tensor] = None   # [C, N]
    a_scale: Optional[torch.Tensor] = None        # scalar
    a_scale_in: Optional[torch.Tensor] = None     # scalar (fused groups)

    def replace(self, **kw) -> "LayerCalibration":
        return dataclasses.replace(self, **kw)

    def to(self, device: DeviceLike) -> "LayerCalibration":
        """This record with every table on ``device``."""
        return LayerCalibration(**{
            f: None if getattr(self, f) is None
            else getattr(self, f).to(device) for f in _FIELDS})


@dataclasses.dataclass(frozen=True)
class CalibrationSnapshot:
    """One device's calibration state: {layer name -> LayerCalibration}.

    ``version`` tags the serialization format (load refuses unknown
    versions rather than misinterpreting tables); ``source`` is a free
    provenance string (chip id / measurement session).
    """

    layers: Dict[str, LayerCalibration] = dataclasses.field(
        default_factory=dict
    )
    version: str = FORMAT_VERSION
    source: str = ""

    def layer(self, name: str) -> Optional[LayerCalibration]:
        return self.layers.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self.layers

    def with_layer(self, name: str, calib: LayerCalibration
                   ) -> "CalibrationSnapshot":
        return dataclasses.replace(
            self, layers={**self.layers, name: calib}
        )

    def with_offsets(self, offsets: Dict[str, torch.Tensor]
                     ) -> "CalibrationSnapshot":
        """Refresh ONLY the offset tables of the named layers (the drift
        hot-swap: gains, activation scales and every other layer's record
        are kept)."""
        layers = dict(self.layers)
        for name, off in offsets.items():
            base = layers.get(name, LayerCalibration())
            layers[name] = base.replace(
                chunk_offset=torch.as_tensor(off, dtype=torch.float32)
            )
        return dataclasses.replace(self, layers=layers)

    def to(self, device: DeviceLike) -> "CalibrationSnapshot":
        """This snapshot with every table on ``device``."""
        return dataclasses.replace(self, layers={
            n: rec.to(device) for n, rec in self.layers.items()})

    # ------------------------------------------------------------- serialize
    def save(self, path) -> None:
        """Serialize to one ``.npz`` (bit-exact round-trip, no pickle)."""
        arrays = {
            "__version__": np.asarray(self.version),
            "__source__": np.asarray(self.source),
        }
        for name, rec in sorted(self.layers.items()):
            for field in _FIELDS:
                v = getattr(rec, field)
                if v is not None:
                    arrays[f"{name}{_SEP}{field}"] = v.detach().cpu().numpy()
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(cls, path, device: DeviceLike = None) -> "CalibrationSnapshot":
        """Load a snapshot saved by either package, its tables on
        ``device`` (``None`` = the CUDA device), dtypes kept."""
        dev = resolve_device(device)
        with np.load(path, allow_pickle=False) as z:
            version = str(z["__version__"])
            if version != FORMAT_VERSION:
                raise ValueError(
                    f"snapshot format {version!r} is not "
                    f"{FORMAT_VERSION!r}; re-measure or migrate"
                )
            source = str(z["__source__"])
            layers: Dict[str, dict] = {}
            for key in z.files:
                if key.startswith("__"):
                    continue
                name, field = key.rsplit(_SEP, 1)
                layers.setdefault(name, {})[field] = torch.as_tensor(
                    z[key], device=dev)
        return cls(
            layers={n: LayerCalibration(**kw) for n, kw in layers.items()},
            version=version,
            source=source,
        )
