"""The control of ``correct``: the reference itself, its products in
TF32 (the precision below the float32 with TF32 off that the
configuration states), put in the program's place.  Per seed the program
serves the cell's check sample (the same groups, captured the same way
as in a run), then the float32 reference and its TF32 twin follow each
group layer by layer on the program's streams (``harness/check.py``):

- ``sound``: the program's readings against the float32 reference (what
  a run reads);
- ``control``: the TF32 twin's stages and lm_head against the float32
  reference's on the same streams, and the gap of the token the TF32
  lm_head puts first;
- ``witness``: the same for the reference whose chunk sums run in
  float64, rounded once: another sound order of the same sums, which
  shows how far rounding alone parts two sound implementations.

A limit sits above the sound readings and below the control's.
"""
from __future__ import annotations

import gc
import time

import torch

from harness import capture
from harness import cell as cell_lib
from harness import check as check_lib
from harness.traffic import Traffic


def readings(cell, seed: int, device, arch=None,
             lows=("tf32", "fp64")) -> dict:
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    arch = arch or cell_lib.arch_of(cell.config)
    traffic = Traffic(cell.traffic, arch.vocab_size, seed)
    tap = capture.Tap()
    t0 = time.monotonic()
    engine, steps, serve = cell_lib.build(
        cell, arch, traffic, seed, dev, cell_lib.Tracer(None, lambda: 0), tap)
    sampled = check_lib.sample(cell.limits, seed,
                               check_lib.traced_groups(cell.traffic))
    pools = cell_lib.pools(arch, traffic, sampled, on_card)
    groups = {}
    with tap.installed():
        for gi in sampled:
            group = traffic.group(gi)
            tap.on, tap.pool, tap.steps = True, pools[gi], []
            steps.logits = []
            outs = [r.output for r in serve(group)]
            groups[gi] = (group, cell_lib.served_tokens(outs), tap.steps,
                          steps.logits)
    if on_card:
        torch.cuda.synchronize()
    t_serve = time.monotonic() - t0
    del engine, steps, serve
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    got = check_lib.check(arch, seed, groups, traffic.max_len, dev,
                          others=lows)
    return {"seed": seed, "sound": got["sound"], "control": got.get("tf32"),
            "witness": got.get("fp64"),
            "groups": len(groups), "serve_s": t_serve,
            "reference_s": time.monotonic() - t0}
