"""Chip-fleet placement: every layer chunk assigned to a physical device
(port of ``repro.fleet.placement``).

``core.partition.plan_tiles`` tiles a weight matrix into (row-chunk,
column-tile) hardware tiles; this module assigns each tile a home - a
slot on one :class:`~repro_torch.calib.device.VirtualChip` in a
:class:`ChipFleet` - with a deterministic first-fit packing policy and a
spare pool for failure remap.  A :class:`Placement` is frozen and holds
no tensors (hashable), so plans and serving loops can carry it freely.

Geometry: a fleet chip hosts ``slots`` tiles of ``chunk_rows`` x ``cols``
synapses (one tile per ADC chunk pass), i.e. its logical grid is
``(slots * chunk_rows, cols)``.  A layer ``[K, N]`` needs
``ceil(K / chunk_rows) * ceil(N / cols)`` tiles; a scan-stacked layer
``[S, K, N]`` is S physical copies of that (one device set per stack
member).

:class:`ChipFleet` measures every chip in one batched pass: the chips'
hidden tables are stacked along a leading device axis and one readout is
computed for all of them with the arithmetic of
:func:`repro_torch.calib.device.measure_readout`, bit for bit what each
chip's own ``measure`` reads: the elementwise steps run over the stacked
axis, each chip's chunk products by its own product call, and each
chip's readout noise comes from its own generator, drawn in its own
call order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.calib.device import VirtualChip
from repro_torch.calib.routines import chip_generator
from repro_torch.core import noise as noise_lib
from repro_torch.core.hw import BSS2
from repro_torch.core.noise import NoiseConfig
from repro_torch.core.partition import plan_tiles

Shape = Tuple[int, ...]

# the most bytes of per-chip effective weights one batched readout
# materializes; a larger fleet is measured in blocks of chips
FLEET_BLOCK_BYTES = 2 << 30


@dataclasses.dataclass(frozen=True)
class ChunkAssignment:
    """One hardware tile of one layer, placed: layer row-chunk ``chunk``
    x column-tile ``coltile`` (of stack member ``stack``; -1 for a plain
    2-D layer) lives in chunk-slot ``slot`` of chip ``chip``."""

    layer: str
    chunk: int
    coltile: int
    chip: int
    slot: int
    stack: int = -1

    @property
    def site(self) -> Tuple[str, int, int, int]:
        """The logical tile this assignment places (placement-invariant)."""
        return (self.layer, self.stack, self.chunk, self.coltile)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Assignment of every model tile to a (chip, slot), plus the fleet
    geometry and the spare pool.  Two placements are equal iff they place
    identically."""

    assignments: Tuple[ChunkAssignment, ...]
    shapes: Tuple[Tuple[str, Shape], ...]
    n_chips: int
    slots: int
    chunk_rows: int
    cols: int
    spares: Tuple[int, ...] = ()

    def layer_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.shapes)

    def assignments_on(self, chip: int) -> Tuple[ChunkAssignment, ...]:
        return tuple(a for a in self.assignments if a.chip == chip)

    def by_layer(self) -> Dict[str, List[ChunkAssignment]]:
        out: Dict[str, List[ChunkAssignment]] = {}
        for a in self.assignments:
            out.setdefault(a.layer, []).append(a)
        return out

    def occupancy(self) -> Dict[int, float]:
        """Fraction of each chip's slots in use (every chip, spares at
        0.0 until a remap promotes them)."""
        used = {c: 0 for c in range(self.n_chips)}
        for a in self.assignments:
            used[a.chip] += 1
        return {c: used[c] / self.slots for c in range(self.n_chips)}

    def remap(self, dead: int, *, spare: Optional[int] = None
              ) -> Tuple["Placement", Tuple[ChunkAssignment, ...]]:
        """Reassign ONLY the dead chip's tiles onto a spare.

        Returns the new placement plus the moved assignments.  The
        promoted spare leaves the spare pool; the dead chip keeps no
        assignments and never rejoins.  Deterministic: tiles keep their
        relative order and fill the spare's slots from 0."""
        moved_from = self.assignments_on(dead)
        if spare is None:
            free = [s for s in self.spares
                    if s != dead and not self.assignments_on(s)]
            if not free:
                raise ValueError(
                    f"no spare chip available to remap chip {dead}")
            spare = free[0]
        if spare == dead or spare not in self.spares:
            raise ValueError(f"chip {spare} is not in the spare pool")
        if self.assignments_on(spare):
            raise ValueError(f"spare chip {spare} is already occupied")
        if len(moved_from) > self.slots:
            raise ValueError(
                f"chip {dead} holds {len(moved_from)} tiles > "
                f"{self.slots} slots on the spare")
        moved = tuple(dataclasses.replace(a, chip=spare, slot=i)
                      for i, a in enumerate(moved_from))
        by_site = {a.site: a for a in moved}
        assignments = tuple(by_site.get(a.site, a) for a in self.assignments)
        spares = tuple(s for s in self.spares if s != spare)
        return dataclasses.replace(self, assignments=assignments,
                                   spares=spares), moved


def _layer_sites(name: str, shape: Shape, *, chunk_rows: int,
                 cols: int) -> List[Tuple[str, int, int, int]]:
    """Deterministic tile enumeration of one layer: stack-major, then
    row-chunk, then column-tile (``core.partition.plan_tiles`` grid)."""
    if len(shape) == 3:
        stacks, (k, n) = range(shape[0]), shape[1:]
    elif len(shape) == 2:
        stacks, (k, n) = [-1], shape
    else:
        raise ValueError(f"layer {name!r}: shape {shape} is not a matmul")
    spec = dataclasses.replace(BSS2, signed_rows=chunk_rows, n_cols=cols)
    grid = plan_tiles(k, n, spec=spec)
    return [(name, s, c, t) for s in stacks
            for c in range(grid.row_chunks) for t in range(grid.col_tiles)]


def place_model(
    shapes: Union[Mapping[str, Shape], Sequence[Tuple[str, Shape]]],
    *,
    n_chips: int,
    spares: int = 0,
    slots: Optional[int] = None,
    chunk_rows: int = BSS2.signed_rows,
    cols: int = BSS2.n_cols,
) -> Placement:
    """Deterministic first-fit packing of every layer tile onto a fleet.

    ``shapes`` maps layer name -> weight shape ([K, N] or scan-stacked
    [S, K, N]) in model order; tiles fill chip 0 slot by slot, then chip
    1, ... across the ``n_chips - spares`` serving chips.  The last
    ``spares`` chip ids form the spare pool and receive nothing.
    ``slots`` defaults to the minimum that fits.  Same shapes and knobs
    give the identical Placement."""
    items = list(shapes.items()) if isinstance(shapes, Mapping) \
        else [(str(n), tuple(s)) for n, s in shapes]
    if n_chips <= spares:
        raise ValueError(
            f"{n_chips} chips with {spares} spares leaves no serving chip")
    sites = [site for name, shape in items
             for site in _layer_sites(name, shape, chunk_rows=chunk_rows,
                                      cols=cols)]
    serving = n_chips - spares
    if slots is None:
        slots = max(1, -(-len(sites) // serving))
    if len(sites) > serving * slots:
        raise ValueError(f"{len(sites)} tiles exceed fleet capacity "
                         f"{serving} chips x {slots} slots")
    assignments = tuple(
        ChunkAssignment(layer=name, stack=s, chunk=c, coltile=t,
                        chip=i // slots, slot=i % slots)
        for i, (name, s, c, t) in enumerate(sites))
    return Placement(
        assignments=assignments,
        shapes=tuple((n, tuple(s)) for n, s in items),
        n_chips=int(n_chips), slots=int(slots),
        chunk_rows=int(chunk_rows), cols=int(cols),
        spares=tuple(range(serving, n_chips)),
    )


def model_layer_shapes(spec, params) -> List[Tuple[str, Shape]]:
    """Ordered (name, weight shape) of every analog layer - the names the
    CalibrationSnapshot uses (spec layer names for stacks, dotted tree
    paths for trees), scan-stacked 3-D layers included."""
    from repro_torch.api.compile import iter_analog_layers
    from repro_torch.calib.routines import _stack_layer_params

    if spec.kind == "stack":
        return [(layer.name, tuple(p["w"].shape)) for layer, p in
                zip(spec.layers, _stack_layer_params(spec, params))]
    return [(path, tuple(node["w"].shape))
            for path, node in iter_analog_layers(params)]


class ChipFleet:
    """A pool of :class:`VirtualChip`\\ s with identical geometry and noise
    model but distinct hidden patterns, measured all at once by
    :meth:`measure` - bit-identical to measuring each chip in turn."""

    def __init__(self, chips: Sequence[VirtualChip]):
        chips = list(chips)
        if not chips:
            raise ValueError("a fleet needs at least one chip")
        c0 = chips[0]
        for i, c in enumerate(chips):
            if (c.k, c.n, c.chunk_rows) != (c0.k, c0.n, c0.chunk_rows):
                raise ValueError(
                    f"chip {i} grid ({c.k}, {c.n}) breaks the fleet's "
                    f"uniform geometry ({c0.k}, {c0.n})")
            if c.noise != c0.noise:
                raise ValueError(f"chip {i} has a different noise model")
            if sorted(c._fpn) != sorted(c0._fpn):
                raise ValueError(f"chip {i} fixed-pattern keys "
                                 f"{sorted(c._fpn)} != {sorted(c0._fpn)}")
            if c.device != c0.device:
                raise ValueError(f"chip {i} is on {c.device}, chip 0 on "
                                 f"{c0.device}")
        self.chips = chips

    @classmethod
    def build(cls, generator: torch.Generator, n_chips: int, *,
              slots: int = 1, chunk_rows: int = BSS2.signed_rows,
              cols: int = BSS2.n_cols,
              noise: NoiseConfig = NoiseConfig()) -> "ChipFleet":
        """``n_chips`` devices of ``slots`` chunk-slots each on the
        generator's device, chip ``i`` seeded from the generator's seed
        and ``i`` (:func:`repro_torch.calib.routines.chip_generator`):
        its own hidden pattern, then its own readout-noise stream."""
        dev = generator.device
        return cls([VirtualChip(chip_generator(generator, i, dev),
                                slots * chunk_rows, cols, noise=noise,
                                chunk_rows=chunk_rows)
                    for i in range(n_chips)])

    @classmethod
    def for_placement(cls, generator: torch.Generator, placement: Placement,
                      *, noise: NoiseConfig = NoiseConfig()) -> "ChipFleet":
        return cls.build(generator, placement.n_chips, slots=placement.slots,
                         chunk_rows=placement.chunk_rows,
                         cols=placement.cols, noise=noise)

    def __len__(self) -> int:
        return len(self.chips)

    def __getitem__(self, i: int) -> VirtualChip:
        return self.chips[i]

    def __iter__(self):
        return iter(self.chips)

    @property
    def k(self) -> int:
        return self.chips[0].k

    @property
    def n(self) -> int:
        return self.chips[0].n

    @property
    def chunk_rows(self) -> int:
        return self.chips[0].chunk_rows

    @property
    def n_chunks(self) -> int:
        return self.chips[0].n_chunks

    @property
    def noise(self) -> NoiseConfig:
        return self.chips[0].noise

    @property
    def device(self) -> torch.device:
        return self.chips[0].device

    @property
    def measurements(self) -> int:
        return sum(c.measurements for c in self.chips)

    def kill(self, i: int) -> None:
        self.chips[i].kill()

    @property
    def dead_mask(self) -> List[bool]:
        return [c.dead for c in self.chips]

    def hidden_bytes(self) -> int:
        """Device bytes of the fleet's hidden state (fixed patterns and
        drift), what a placement of this size holds on the card."""
        return sum(t.numel() * t.element_size() for c in self.chips
                   for t in list(c._fpn.values()) + [c._drift])

    def measure(self, w_code: torch.Tensor, a_code: torch.Tensor, *,
                gain: float = 1.0) -> torch.Tensor:
        """One fleet-wide measurement: the SAME weight/event codes on
        every chip, each answering through its own hidden pattern and
        readout-noise stream.  Returns ``[D, ..., C, N]``.

        The chips' tables are stacked along a leading device axis and the
        readout runs as one batched pass of tensor ops (in blocks of
        chips that keep the per-chip effective weights under
        :data:`FLEET_BLOCK_BYTES`; each chip's chunk products by the call
        its own ``measure`` makes).  Each chip's counter and noise stream
        advance exactly as its own ``measure`` would, so the result is
        bit-identical to ``[chip.measure(...) for chip in fleet]``; a dead
        chip reads ``adc_min`` and draws no noise, as its own ``measure``
        does."""
        dev = self.device
        w_code = torch.as_tensor(w_code, dtype=torch.float32, device=dev)
        a_code = torch.as_tensor(a_code, dtype=torch.float32, device=dev)
        if tuple(w_code.shape) != (self.k, self.n):
            raise ValueError(f"w_code shape {tuple(w_code.shape)} != fleet "
                             f"grid ({self.k}, {self.n})")
        if a_code.shape[-1] != self.k:
            raise ValueError(f"a_code feeds {a_code.shape[-1]} rows, fleet "
                             f"chips have {self.k}")
        for c in self.chips:
            c._measurements += 1
        batch = tuple(a_code.shape[:-1])
        out = torch.empty((len(self.chips),) + batch
                          + (self.n_chunks, self.n), dtype=torch.float32,
                          device=dev)
        per = max(1, FLEET_BLOCK_BYTES
                  // (self.n_chunks * self.chunk_rows * self.n * 4))
        for d0 in range(0, len(self.chips), per):
            block = self.chips[d0:d0 + per]
            out[d0:d0 + len(block)] = _fleet_readout(block, w_code, a_code,
                                                     gain)
        return out


def _chip_products(a_c: torch.Tensor, w_c: torch.Tensor) -> torch.Tensor:
    """``[D, ..., C, N]`` chunk products of the events ``a_c [..., C, R]``
    with each chip's effective weights ``w_c [D, C, R, N]``, each chip's
    by the very call its own ``measure`` makes, so each chip reads bit
    for bit what it reads alone.  One product batched over the device
    axis sums in another order on the card: a fleet calibrated so left
    1-5 of a chip's 32 768 gain entries unequal to its twin's own
    calibration (``scripts/fleet_order.py``, 130 chips on an H100)."""
    v = torch.empty((w_c.shape[0],) + tuple(a_c.shape[:-1])
                    + (w_c.shape[-1],), dtype=torch.float32,
                    device=a_c.device)
    for i in range(w_c.shape[0]):
        v[i] = torch.einsum("...ck,ckn->...cn", a_c, w_c[i])
    return v


def _fleet_readout(chips: Sequence[VirtualChip], w_code: torch.Tensor,
                   a_code: torch.Tensor, gain: float) -> torch.Tensor:
    """:func:`repro_torch.calib.device.measure_readout` for a block of
    chips at once: the same ops in the same order, every chip's hidden
    table stacked along a leading device axis."""
    c0 = chips[0]
    k, n, rows, n_chunks = c0.k, c0.n, c0.chunk_rows, c0.n_chunks
    lo, hi = float(BSS2.adc_min), float(BSS2.adc_max)
    w_code = torch.clamp(torch.round(w_code), -float(BSS2.w_max),
                         float(BSS2.w_max))
    a_code = torch.clamp(torch.round(a_code), 0.0, float(BSS2.a_max))
    fpn = {name: torch.stack([c._fpn[name] for c in chips])
           for name in c0._fpn}
    if "gain" in fpn:
        w_eff = w_code * fpn["gain"]
    else:
        w_eff = w_code[None].expand(len(chips), k, n)
        if "col_gain" in fpn:
            w_eff = w_eff * fpn["col_gain"][:, None, :]
        if "row_gain" in fpn:
            w_eff = w_eff * fpn["row_gain"][:, :, None]
    pad = n_chunks * rows - k
    if pad:
        w_eff = torch.nn.functional.pad(w_eff, (0, 0, 0, pad))
        a_code = torch.nn.functional.pad(a_code, (0, pad))
    batch = tuple(a_code.shape[:-1])
    a_c = a_code.reshape(batch + (n_chunks, rows))
    w_c = w_eff.reshape(len(chips), n_chunks, rows, n)
    v = _chip_products(a_c, w_c) * gain
    del w_eff, w_c
    lead = (len(chips),) + (1,) * len(batch) + (n_chunks, n)
    drift = torch.stack([c._drift for c in chips]).reshape(lead)
    off = fpn.get("chunk_offset")  # verify: allow-fpn-access
    v = v + (drift if off is None else off.reshape(lead) + drift)
    if c0.noise.readout_std != 0.0 and c0.noise.mode != "none":
        shape = batch + (n_chunks, n)
        for i, c in enumerate(chips):
            if not c.dead:
                v[i] += noise_lib.readout_noise(c._gen, shape, c.noise,
                                                device=v.device)
    adc = torch.clamp(torch.round(v), lo, hi)
    for i, c in enumerate(chips):
        if c.dead:
            adc[i] = lo
    return adc
