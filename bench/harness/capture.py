"""What the window keeps of the sampled groups for the check: at every
step (the prefill, each decode step) the residual stream that enters
each transformer layer and the one that leaves the last, read where the
model hands it from layer to layer (``models.transformer._group_apply``),
and the logits the step returns.

The check follows the program layer by layer from these (``harness/
check.py``).  Copies go into host buffers allocated in set-up, without a
wait on the device (pinned memory on the card), so the window's timing
and its device memory are left as they are.
"""
from __future__ import annotations

import contextlib

import torch


class Pool:
    """A flat host buffer handed out in order as tensors of given
    shapes."""

    def __init__(self, numel: int, dtype, pinned: bool):
        self.buf = torch.empty(numel, dtype=dtype, pin_memory=pinned)
        self.used = 0

    def keep(self, t: torch.Tensor) -> torch.Tensor:
        n = t.numel()
        if self.used + n > self.buf.numel():
            raise RuntimeError("capture pool exhausted")
        out = self.buf[self.used:self.used + n].view(t.shape)
        self.used += n
        out.copy_(t.detach(), non_blocking=True)
        return out


def group_numel(arch, traffic, group) -> int:
    """Elements of one group's capture: its layer states and logits."""
    b = len(group)
    s = max(len(r.prompt) for r in group)
    positions = b * (s + traffic.new_tokens - 1)
    return ((arch.n_layers + 1) * positions * arch.d_model
            + b * traffic.new_tokens * arch.vocab_size)


class Tap:
    """Records the layer states of the steps run while :attr:`on`: one list
    per step, ``[x_0, x_1, ..., x_L]``."""

    def __init__(self):
        self.on = False
        self.pool = None
        self.steps = []

    def begin_step(self) -> None:
        if self.on:
            self.steps.append([])

    @contextlib.contextmanager
    def installed(self):
        """Wrap the model's per-layer function while the block runs."""
        from repro_torch.models import transformer as T

        real = T._group_apply

        def tapped(gp, x, **kw):
            y, cache, aux = real(gp, x, **kw)
            if self.on:
                step = self.steps[-1]
                if not step:
                    step.append(self.pool.keep(x))
                step.append(self.pool.keep(y))
            return y, cache, aux

        T._group_apply = tapped
        try:
            yield self
        finally:
            T._group_apply = real
