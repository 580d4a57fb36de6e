"""Tile partitioner: maps logical weight matrices onto BSS-2-sized analog
tiles (the hxtorch JIT partitioner of paper §II-D, made static).  A copy
of ``repro.core.partition``: the port keeps its own so that it never
imports the JAX package.

A logical ``[K, N]`` signed matmul decomposes into a grid of
``ceil(K / 128) x ceil(N / 512)`` chip passes: 128 signed logical rows per
pass (two hardware rows each) and 512 neuron columns.  Tiles can run in
parallel (across chips / across a device mesh axis) or serially
(time multiplexing one chip, paper §V).  The partitioner is pure metadata -
it feeds the energy/latency model and the sharding rules; the arithmetic
itself is carried out by :mod:`repro_torch.core.analog`.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hw import BSS2, BSS2Spec


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Decomposition of one logical matmul onto analog tiles."""

    k: int                      # logical signed input dim
    n: int                      # output dim
    row_chunks: int             # ceil(k / signed_rows)
    col_tiles: int              # ceil(n / n_cols)
    k_pad: int                  # k padded to a multiple of signed_rows
    n_pad: int                  # n padded to a multiple of n_cols

    @property
    def n_tiles(self) -> int:
        return self.row_chunks * self.col_tiles

    @property
    def synapses_used(self) -> int:
        return self.k * self.n * 2          # signed weights: 2 hw synapses

    @property
    def synapses_allocated(self) -> int:
        return self.k_pad * self.n_pad * 2

    @property
    def utilization(self) -> float:
        return self.synapses_used / max(self.synapses_allocated, 1)

    def passes_serial(self, chips: int = 1) -> int:
        """Analog VMM passes when ``chips`` tiles evaluate in parallel.

        Column tiles on distinct chips are independent; row chunks targeting
        the same output column can also run on distinct chips because the
        partial sums are combined digitally (paper Fig. 6: the split hidden
        layer halves run side by side).
        """
        return math.ceil(self.n_tiles / max(chips, 1))


def plan_tiles(k: int, n: int, spec: BSS2Spec = BSS2) -> TileGrid:
    row_chunks = max(1, math.ceil(k / spec.signed_rows))
    col_tiles = max(1, math.ceil(n / spec.n_cols))
    return TileGrid(
        k=k,
        n=n,
        row_chunks=row_chunks,
        col_tiles=col_tiles,
        k_pad=row_chunks * spec.signed_rows,
        n_pad=col_tiles * spec.n_cols,
    )


def plan_model(layer_shapes: list[tuple[int, int]], spec: BSS2Spec = BSS2) -> dict:
    """Aggregate tile statistics for a list of (K, N) analog layers."""
    grids = [plan_tiles(k, n, spec) for k, n in layer_shapes]
    total_tiles = sum(g.n_tiles for g in grids)
    total_macs = sum(g.k * g.n for g in grids)
    return {
        "grids": grids,
        "total_tiles": total_tiles,
        "total_macs": total_macs,
        "total_ops": 2 * total_macs,
        "mean_utilization": (
            sum(g.synapses_used for g in grids)
            / max(sum(g.synapses_allocated for g in grids), 1)
        ),
    }
