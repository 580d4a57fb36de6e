"""Statistical models of the BSS-2 analog imperfections (the frozen
fixed pattern; see ``repro.core.noise`` for the physics and defaults).

1. **fixed-pattern synaptic gain** - per-synapse multiplicative deviation
   (``mode="full"``) or its per-row x per-column factorization
   (``mode="rank1"``), frozen per chip.
2. **fixed-pattern column offset** - per-(row-chunk, neuron) additive ADC
   offset, frozen per chip.

3. **temporal readout noise** - per-analog-pass additive noise on the
   digitized membrane voltage (:func:`readout_noise`), drawn in the
   hardware-in-the-loop training forward; the deterministic serve path
   runs without it.

Draws come from an explicit ``torch.Generator``; they cannot reproduce
``jax.random``, so parity tests carry the JAX draws across: the fixed
pattern with the parameters (:func:`repro_torch.convert.params_from_numpy`),
the readout noise as injected tensors (:func:`readout_noise`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Magnitudes of the analog imperfections (all in natural units)."""

    gain_std: float = 0.02          # relative synapse gain spread
    offset_std: float = 1.0         # ADC LSB, per (chunk, column)
    readout_std: float = 0.7        # ADC LSB, per analog pass (temporal)
    mode: str = "rank1"             # "none" | "rank1" | "full"

    def with_mode(self, mode: str) -> "NoiseConfig":
        return dataclasses.replace(self, mode=mode)


NOISELESS = NoiseConfig(gain_std=0.0, offset_std=0.0, readout_std=0.0,
                        mode="none")


def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    if torch.device(device).type == "meta":      # shapes only (the dry run)
        return torch.empty(shape, dtype=torch.float32, device="meta")
    # drawn on the generator's own device, then moved: the same seed gives
    # the same pattern whatever device the model lives on
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(device)


def init_fixed_pattern(
    generator: torch.Generator,
    k: int,
    n: int,
    n_chunks: int,
    cfg: NoiseConfig,
    *,
    device: torch.device,
) -> dict:
    """Sample the frozen fixed-pattern deviations for one logical (K, N)
    tile grid (generated from the logical shape, like the reference)."""
    if cfg.mode == "none" or (cfg.gain_std == 0.0 and cfg.offset_std == 0.0):
        return {}
    out = {}
    if cfg.gain_std > 0.0:
        if cfg.mode == "full":
            out["gain"] = 1.0 + cfg.gain_std * _normal(generator, (k, n),
                                                       device)
        elif cfg.mode == "rank1":
            # split the variance between row (input line) and column
            # (neuron transconductance) mismatch
            s = cfg.gain_std / math.sqrt(2.0)
            out["row_gain"] = 1.0 + s * _normal(generator, (k,), device)
            out["col_gain"] = 1.0 + s * _normal(generator, (n,), device)
        else:
            raise ValueError(f"unknown noise mode {cfg.mode!r}")
    if cfg.offset_std > 0.0:
        out["chunk_offset"] = cfg.offset_std * _normal(
            generator, (n_chunks, n), device)
    return out


def effective_weight(w_code: torch.Tensor, fpn: dict) -> torch.Tensor:
    """Apply the fixed-pattern gain to weight codes -> the effective
    analog weight (the reference's products, in its order)."""
    if "gain" in fpn:
        return w_code * fpn["gain"]
    w = w_code
    if "col_gain" in fpn:
        w = w * fpn["col_gain"][None, :]
    if "row_gain" in fpn:
        w = w * fpn["row_gain"][:, None]
    return w


def offset_drift(noise: Union[torch.Generator, torch.Tensor], shape: tuple,
                 std_lsb: float, *, device: torch.device) -> torch.Tensor:
    """One thermal-drift step of the per-(chunk, column) ADC offsets:
    ``std_lsb * N(0, 1)`` of ``shape``, drawn from the generator ``noise``
    on ``device``, or ``noise`` itself when it is a tensor - a step drawn
    elsewhere and injected (the reference's, in a parity test).  Offsets
    drift on deployment timescales; gains are stable."""
    if isinstance(noise, torch.Tensor):
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"injected drift step has shape "
                             f"{tuple(noise.shape)}, want {tuple(shape)}")
        return noise.to(device=device, dtype=torch.float32)
    return std_lsb * torch.randn(shape, generator=noise,
                                 dtype=torch.float32, device=device)


def chunk_offsets(fpn: dict, n_chunks: int,
                  n: int) -> Optional[torch.Tensor]:
    off = fpn.get("chunk_offset")
    if off is None:
        return None
    if tuple(off.shape) != (n_chunks, n):
        raise ValueError(
            f"chunk_offset shape {tuple(off.shape)} does not match the "
            f"({n_chunks}, {n}) chunk grid"
        )
    return off


class NoiseFeed:
    """Readout-noise draws handed out one analog pass at a time, in call
    order: a model's whole forward (an LM's every layer, both passes of a
    two-pass split) reads from one feed.  ``draws`` are injected tensors
    (the reference's, in a parity test); past their end a feed with a
    ``generator`` draws anew and records the draw, so the same feed
    rewound (:meth:`rewind`, or ``pos`` set back) replays the same noise -
    on another device too, or in a remat recompute.  A feed with neither
    left raises."""

    def __init__(self, draws=(), generator: Optional[torch.Generator] = None):
        self.draws = list(draws)
        self.generator = generator
        self.pos = 0

    def rewind(self) -> "NoiseFeed":
        self.pos = 0
        return self

    def draw(self, shape: tuple, cfg: "NoiseConfig",
             device: torch.device) -> torch.Tensor:
        if self.pos == len(self.draws):
            if self.generator is None:
                raise ValueError(
                    f"readout-noise feed exhausted after {self.pos} draws")
            self.draws.append(cfg.readout_std * torch.randn(
                shape, generator=self.generator, dtype=torch.float32,
                device=self.generator.device))
        d = self.draws[self.pos]
        self.pos += 1
        return _readout_noise(d, shape, cfg, device=device)


def readout_noise(
    noise: Union[None, torch.Generator, torch.Tensor, NoiseFeed],
    shape: tuple,
    cfg: NoiseConfig,
    *,
    device: torch.device,
) -> Optional[torch.Tensor]:
    """Temporal readout noise for one batch of analog passes:
    ``readout_std * N(0, 1)`` of ``shape``, drawn from the generator
    ``noise`` on ``device`` (the generator must live there), or ``noise``
    itself when it is a tensor - a draw made elsewhere and injected (the
    parity tests pass the reference's draws so).  None when there is no
    noise source (deterministic, standalone mode), when
    ``cfg.readout_std == 0`` or when ``cfg.mode == "none"``.

    Inside a sharded step whose batch is split over mesh ranks
    (:func:`repro_torch.distributed.sharding.batch_split`), ``shape`` is
    this rank's batch-major block: the draw (or the injected tensor) has
    the whole batch's shape, and the rank takes its rows, so the noise
    does not depend on the mesh."""
    if noise is None or cfg.readout_std == 0.0 or cfg.mode == "none":
        return None
    from repro_torch.distributed import sharding as shd

    if shd.batch_axes():
        whole, row0 = shd.batch_rows(tuple(shape))
        rn = _readout_noise(noise, whole, cfg, device=device)
        return rn.narrow(0, row0, shape[0])
    return _readout_noise(noise, shape, cfg, device=device)


def _readout_noise(noise, shape: tuple, cfg: NoiseConfig, *,
                   device: torch.device) -> torch.Tensor:
    if isinstance(noise, NoiseFeed):
        return noise.draw(shape, cfg, device)
    if isinstance(noise, torch.Tensor):
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(
                f"injected readout noise has shape {tuple(noise.shape)}, "
                f"the analog passes need {tuple(shape)}")
        return noise.to(device=device, dtype=torch.float32)
    return cfg.readout_std * torch.randn(shape, generator=noise,
                                         dtype=torch.float32, device=device)
