"""Pipeline parallelism over the ``pod`` mesh axis, GPipe schedule (port
of ``repro.distributed.pipeline``).

The layer stack splits into one stage per rank of the axis, and
microbatches stream through it: per schedule tick every stage runs its
stage function on its input, and the stage boundary activations move one
stage on with a permute over the axis - the only inter-stage
communication.  The bubble fraction is (S-1)/(M+S-1) for S stages and M
microbatches.

Every rank runs every tick (an inactive stage's output is masked to
zeros, as in the reference's SPMD program), so each rank's autograd graph
has the same collectives in the same order: the backward runs the
inverse permutes tick by tick.  The last stage's outputs are summed over
the axis - an exact broadcast, since only it records non-zeros.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.train.optimizer import tree_map


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   axis: str = "pod") -> torch.Tensor:
    """Run ``x [n_micro, mb, ...]`` through ``n_stages`` sequential stages,
    one per rank of ``axis``, with the GPipe schedule; returns the last
    stage's ``[n_micro, mb, ...]`` outputs on every rank.

    ``stage_fn(params, x [mb, ...]) -> [mb, ...]``; ``stage_params``: this
    rank's stage, a tree of tensors with a leading axis of 1 (its block
    of the ``[n_stages, ...]`` stack, :func:`split_stages` then
    ``shard_tree``).  ``x`` is the whole input on every rank (only stage
    0 reads it)."""
    sizes = shd.axis_sizes()
    if axis not in sizes:
        raise ValueError(f"pipeline_apply needs a mesh with a {axis!r} axis, "
                         f"the active one has {tuple(sizes)}")
    n_stages = sizes[axis]
    stage = shd.axis_index(axis)
    n_micro = x.shape[0]
    steps = n_micro + n_stages - 1
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    p = tree_map(lambda a: a[0], stage_params)
    dev = x.device
    first = torch.tensor(stage == 0, device=dev)
    boundary = torch.zeros_like(x[0])
    outputs = torch.zeros_like(x)
    for t in range(steps):
        # stage 0 injects microbatch t; the others take the permuted input
        h = torch.where(first, x[min(t, n_micro - 1)], boundary)
        active = torch.tensor(0 <= t - stage < n_micro, device=dev)
        y = torch.where(active, stage_fn(p, h), 0.0)
        # the last stage records its finished microbatch (t - S + 1)
        record = torch.tensor(stage == n_stages - 1 and t >= n_stages - 1,
                              device=dev)
        i = min(max(t - n_stages + 1, 0), n_micro - 1)
        outputs = torch.cat([outputs[:i], torch.where(record, y, outputs[i])
                             [None], outputs[i + 1:]])
        if t < steps - 1:           # the last tick's boundary is not read
            boundary = shd.permute_grad(y, axis, perm)
    return shd.sum_over(outputs, axis)


def split_stages(params_layers, n_stages: int):
    """Stacked layer params ``[n_groups, ...]`` -> ``[n_stages,
    n_groups / n_stages, ...]`` for :func:`pipeline_apply`."""
    def r(a):
        g = a.shape[0]
        if g % n_stages:
            raise ValueError(f"{g} groups do not split into {n_stages} "
                             "stages")
        return a.reshape(n_stages, g // n_stages, *a.shape[1:])

    return tree_map(r, params_layers)
