"""The measurement side of the HIL contract: an opaque analog device
(port of ``repro.calib.device``).

:class:`VirtualChip` wraps one fixed-pattern instance plus a temporal
readout-noise stream behind the only interface real BSS-2 hardware
exposes - *write weight codes, stream event codes, read back the
per-pass ADC results* (paper Fig. 4; each VMM pass integrates ONE
128-row chunk, and the SIMD CPU sees every pass's 8-bit readout before
digital accumulation).  Calibration routines
(:mod:`repro_torch.calib.routines`) close the loop blind: they call
:meth:`VirtualChip.measure` as often as they like but never see the
ground-truth deviations.

A chip built from a layer's params (:meth:`VirtualChip.from_params`)
wraps that layer's ``params["fpn"]``, so a plan baked from perfect
knowledge of the fixed pattern and a plan baked from measurements on the
chip model the same physical device.

Everything lives on the chip's device: the hidden state, the readout
arithmetic (plain tensor ops, as the reference computes it outside any
kernel) and the readout-noise stream, one ``torch.Generator`` on that
device drawn in call order (the reference folds its key with the call
count instead; its draws cannot be reproduced, so a parity test passes
them in through ``measure(draws=...)``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core import noise as noise_lib
from repro_torch.core.hw import BSS2
from repro_torch.core.noise import NoiseConfig


def measure_readout(
    w_code: torch.Tensor,
    a_code: torch.Tensor,
    *,
    gain: float,
    fpn: dict,
    drift: torch.Tensor,
    noise: NoiseConfig,
    k: int,
    n: int,
    chunk_rows: int,
    n_chunks: int,
    draws: Union[None, torch.Generator, torch.Tensor] = None,
) -> torch.Tensor:
    """The physics of one measurement pass: code clipping, hidden
    fixed-pattern weights, chunked accumulation, offsets + drift, readout
    noise, saturating ADC.  ``draws`` is the readout-noise source: a
    generator on the chip's device, or the noise itself, a tensor of the
    readout shape ``[..., C, N]`` drawn elsewhere
    (:func:`repro_torch.core.noise.readout_noise`); either is ignored
    when the noise config has no readout noise."""
    w_code = torch.clamp(torch.round(w_code.to(torch.float32)),
                         -float(BSS2.w_max), float(BSS2.w_max))
    a_code = torch.clamp(torch.round(a_code.to(torch.float32)),
                         0.0, float(BSS2.a_max))
    w_eff = noise_lib.effective_weight(w_code, fpn)
    pad = n_chunks * chunk_rows - k
    if pad:
        w_eff = torch.nn.functional.pad(w_eff, (0, 0, 0, pad))
        a_code = torch.nn.functional.pad(a_code, (0, pad))
    batch = tuple(a_code.shape[:-1])
    a_c = a_code.reshape(batch + (n_chunks, chunk_rows))
    w_c = w_eff.reshape(n_chunks, chunk_rows, n)
    v = torch.einsum("...ck,ckn->...cn", a_c, w_c) * gain
    off = fpn.get("chunk_offset")  # verify: allow-fpn-access
    v = v + (drift if off is None else off + drift)
    if draws is not None:
        rn = noise_lib.readout_noise(draws, tuple(v.shape), noise,
                                     device=v.device)
        if rn is not None:
            v = v + rn
    return torch.clamp(torch.round(v), float(BSS2.adc_min),
                       float(BSS2.adc_max))


class VirtualChip:
    """One analog device: hidden fixed pattern, noisy measurements only.

    ``generator`` (a ``torch.Generator`` on the chip's device) samples the
    fixed pattern when ``fpn`` is not given, then feeds the readout-noise
    stream: a calibration run is reproducible end to end given the
    generator's seed and the call order.
    """

    def __init__(
        self,
        generator: torch.Generator,
        k: int,
        n: int,
        *,
        noise: NoiseConfig = NoiseConfig(),
        chunk_rows: int = BSS2.signed_rows,
        fpn: Optional[dict] = None,
    ):
        self.k = int(k)
        self.n = int(n)
        self.chunk_rows = int(chunk_rows)
        self.n_chunks = -(-self.k // self.chunk_rows)
        self.noise = noise
        self.device = generator.device
        # hidden state: calibration routines must go through measure()
        self._fpn = (
            {name: t.to(self.device) for name, t in fpn.items()}
            if fpn is not None
            else noise_lib.init_fixed_pattern(
                generator, self.k, self.n, self.n_chunks, noise,
                device=self.device)
        )
        self._drift = torch.zeros((self.n_chunks, self.n),
                                  dtype=torch.float32, device=self.device)
        self._gen = generator
        self._measurements = 0
        self._dead = False

    @classmethod
    def from_params(
        cls,
        params: dict,
        generator: torch.Generator,
        *,
        noise: NoiseConfig = NoiseConfig(),
        chunk_rows: int = BSS2.signed_rows,
    ) -> "VirtualChip":
        """The chip a layer's parameters were initialized against: wraps
        ``params["fpn"]`` (the layer's frozen deviations) as the hidden
        state.  ``generator`` feeds only the temporal readout stream."""
        k, n = params["w"].shape
        fpn = params.get("fpn", {})  # verify: allow-fpn-access
        return cls(generator, k, n, noise=noise, chunk_rows=chunk_rows,
                   fpn=dict(fpn))

    # ------------------------------------------------------------- interface
    @property
    def measurements(self) -> int:
        """How many measure() calls this chip has served."""
        return self._measurements

    def measure(
        self,
        w_code: torch.Tensor,
        a_code: torch.Tensor,
        *,
        gain: float = 1.0,
        draws: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """One hardware measurement: write 6-bit weight codes, stream
        5-bit event codes, return the per-chunk 8-bit ADC readings.

        w_code: [K, N] synapse codes (clipped to +-``w_max``).
        a_code: [..., K] event codes (rounded + clipped to [0, a_max]).
        gain:   the requested analog amplification.
        draws:  optional [..., C, N] readout noise of this call
                (``readout_std * N(0, 1)``, drawn elsewhere - the
                reference's, in a parity test) instead of a draw from the
                chip's generator.

        Returns [..., C, N]: every chunk pass's saturating ADC readout,
        never their sum, including the hidden gain/offset deviations,
        any drift, and fresh readout noise for every pass of every batch
        row.  A killed chip (:meth:`kill`) reads back ``adc_min``.
        """
        w_code = torch.as_tensor(w_code, dtype=torch.float32,
                                 device=self.device)
        a_code = torch.as_tensor(a_code, dtype=torch.float32,
                                 device=self.device)
        if tuple(w_code.shape) != (self.k, self.n):
            raise ValueError(
                f"w_code shape {tuple(w_code.shape)} != chip grid "
                f"({self.k}, {self.n})"
            )
        if a_code.shape[-1] != self.k:
            raise ValueError(
                f"a_code feeds {a_code.shape[-1]} rows, chip has {self.k}"
            )
        self._measurements += 1
        if self._dead:
            shape = tuple(a_code.shape[:-1]) + (self.n_chunks, self.n)
            return torch.full(shape, float(BSS2.adc_min),
                              dtype=torch.float32, device=self.device)
        return measure_readout(
            w_code, a_code, gain=gain, fpn=self._fpn, drift=self._drift,
            noise=self.noise, k=self.k, n=self.n,
            chunk_rows=self.chunk_rows, n_chunks=self.n_chunks,
            draws=self._gen if draws is None else draws,
        )

    # ------------------------------------------------------------ simulation
    @property
    def dead(self) -> bool:
        return self._dead

    def kill(self) -> None:
        """Simulate a chip failure: every later measurement reads back
        rail-pinned ``adc_min`` codes."""
        self._dead = True

    def apply_drift(self, noise: Union[torch.Generator, torch.Tensor],
                    std_lsb: float) -> None:
        """Simulate thermal ADC-offset drift: perturb the hidden offsets
        by ``std_lsb`` (LSB) drawn from the generator ``noise``, or by
        ``noise`` itself when it is a drift step drawn elsewhere.  Gains
        are stable on this timescale."""
        self._drift = self._drift + noise_lib.offset_drift(
            noise, (self.n_chunks, self.n), std_lsb, device=self.device)

    def oracle(self) -> dict:
        """Ground truth, for TESTS AND VALIDATION ONLY - calibration
        routines must never call this.

        Returns the hidden per-(chunk, column) gain table (each chunk's
        row-mean of the per-synapse gain map over its *real* rows) and the
        current per-(chunk, column) offsets including drift.
        """
        f32 = dict(dtype=torch.float32, device=self.device)
        gmap = noise_lib.effective_weight(torch.ones((self.k, self.n),
                                                     **f32), self._fpn)
        pad = self.n_chunks * self.chunk_rows - self.k
        rows = torch.ones((self.k,), **f32)
        if pad:
            gmap = torch.nn.functional.pad(gmap, (0, 0, 0, pad))
            rows = torch.nn.functional.pad(rows, (0, pad))
        gmap = gmap.reshape(self.n_chunks, self.chunk_rows, self.n)
        counts = rows.reshape(self.n_chunks, self.chunk_rows).sum(-1)
        gain_table = gmap.sum(dim=1) / counts[:, None]
        off = self._fpn.get("chunk_offset")  # verify: allow-fpn-access
        off = self._drift if off is None else off + self._drift
        return {"gain_table": gain_table, "chunk_offset": off}
