"""Batched serving with the analog backend of the PyTorch port: prefill +
decode engine (the twin of ``examples/serve_batch.py``).

    PYTHONPATH=src python examples_torch/serve_batch.py --arch stablelm-3b \
        --requests 12 --max-new 16 [--mode analog_fast] [--mesh] \
        [--device cpu]

Demonstrates the inference-engine substrate at smoke scale: request
batching, left-padded prefill, per-sequence stopping, greedy sampling -
with the model's parameter matmuls on emulated analog tiles if
requested.  The engine goes through the ``repro_torch.api`` front door:
the model is compiled ONCE (attention QKV fused into one dispatch group)
and every prefill and decode step replays the baked plans, on the CUDA
device through the hand-written kernels unless ``--device`` names
another - also under a ``(data, model)`` host mesh (``--mesh``: the
running process group's ranks along ``data``, or a group of one started
for the device), where the plan leaves shard by the same logical axes as
the weights they were baked from.
"""
import argparse
import contextlib

import numpy as np
import torch

from repro_torch import configs, obs
from repro_torch.configs.base import RunConfig
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--mode", default="digital",
                    choices=["digital", "analog_faithful", "analog_fast"])
    ap.add_argument("--mesh", action="store_true",
                    help="serve under a (data, model) host mesh with "
                         "sharded pre-lowered plans")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    a = ap.parse_args(argv)

    dev = resolve_device(a.device)
    cfg = configs.get_smoke(a.arch)
    if not cfg.embed_inputs:
        raise SystemExit(f"{a.arch} backbone takes frontend embeddings - "
                         "pick a token-input arch for this example")
    run = RunConfig(analog=AnalogConfig(mode=a.mode)) if a.mode != "digital" \
        else RunConfig()
    params = T.lm_init(torch.Generator().manual_seed(0), cfg, device=dev)
    mesh_ctx = contextlib.nullcontext()
    started = False
    if a.mesh:
        started = not torch.distributed.is_initialized()
        if started:
            mesh_lib.init_single(dev)
        n = torch.distributed.get_world_size()
        mesh_ctx = shd.use_mesh(mesh_lib.make_mesh((n, 1),
                                                   ("data", "model")))
    rng = np.random.default_rng(0)
    reqs = [
        Request(uid=i,
                prompt=rng.integers(0, cfg.vocab_size, rng.integers(4, 12)),
                max_new_tokens=a.max_new)
        for i in range(a.requests)
    ]
    obs.reset_metrics()
    try:
        with obs.collect("serve-batch") as tr, mesh_ctx:
            engine = ServeEngine(cfg, run, params, batch_size=a.batch,
                                 max_len=128, device=dev)
            with obs.span("serve.all") as sp:
                done = engine.serve(reqs)
            dt = sp.dur_us / 1e6
    finally:
        if started:
            mesh_lib.destroy()
    total_new = sum(len(r.output) for r in done)
    print(f"arch={a.arch} mode={a.mode}: served {len(done)} requests, "
          f"{total_new} tokens in {dt:.1f}s "
          f"({total_new / dt:.1f} tok/s on {_device_name(dev)})")
    for r in done[:4]:
        print(f"  req {r.uid}: prompt[:6]={r.prompt[:6].tolist()} -> "
              f"out[:8]={r.output[:8].tolist()}")
    print("\n=== end-of-run obs report ===")
    print(obs.report.render(
        obs.report.records_of(tr, obs.metrics.registry())
    ))


if __name__ == "__main__":
    main()
