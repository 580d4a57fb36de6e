"""Quickstart: the analog execution backend of the PyTorch port in five
minutes (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

1. declares + compiles one analog linear through the ``repro_torch.api``
   front door (spec -> compile -> apply) and shows the BSS-2 datapath
   (5-bit events, 6-bit weights, chunked saturating 8-bit ADC),
2. compiles a whole LM and swaps it between digital / analog_faithful /
   analog_fast - same CompiledModel contract at every scale,
3. prints what the inference would cost on the real BSS-2 mobile system
   (Table-1-calibrated energy model).

It runs on the CUDA device (the hand-written kernels) unless ``--device``
names another; random numbers come from seeded CPU generators, so every
device starts from the same draws.
"""
import argparse

import torch

from repro_torch import api
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.analog import AnalogConfig, analog_linear_init
from repro_torch.core.device import resolve_device
from repro_torch.core.energy import LayerWork, SystemModel
from repro_torch.core.hw import BSS2
from repro_torch.core.noise import NoiseConfig
from repro_torch.models import transformer as T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    # ------------------------------------------------- 1. one analog linear
    # declare once -> compile -> apply: the execution contract of the repo
    gen = torch.Generator().manual_seed(0)
    params = analog_linear_init(gen, 256, 128, noise=NoiseConfig(),
                                device=dev)
    x = (torch.randn((4, 256), generator=gen) * 0.3).to(dev)

    spec = api.linear_spec(256, 128)
    y_digital = api.compile(spec, params, AnalogConfig(mode="digital"),
                            device=dev).apply(x)
    y_analog = api.compile(spec, params, AnalogConfig(),
                           device=dev).apply(x)
    rel = float((y_analog - y_digital).abs().max()
                / y_digital.abs().max())
    print(f"[1] analog vs digital linear: rel err {rel:.3f} "
          f"(W{BSS2.w_bits}A{BSS2.a_bits} + fixed-pattern noise)")

    # --------------------------------------------- 2. a whole LM, one switch
    cfg = ArchConfig("demo", "dense", n_layers=2, d_model=128, n_heads=4,
                     n_kv_heads=2, d_ff=256, vocab_size=512)
    lm = T.lm_init(torch.Generator().manual_seed(1), cfg, device=dev)
    lm_spec = T.lm_module_spec(cfg, lm)
    batch = {"tokens": torch.randint(0, 512, (2, 32), generator=gen
                                     ).to(dev)}
    for mode in ("digital", "analog_faithful", "analog_fast"):
        run = RunConfig(analog=AnalogConfig(mode=mode)) \
            if mode != "digital" else RunConfig()
        # compile bakes every analog layer once (attention QKV fused into
        # one dispatch group); apply replays the plans
        model = api.compile(lm_spec, lm, run, device=dev)
        with torch.no_grad():
            logits, _, _ = model.apply(batch)
        print(f"[2] mode={mode:16s} logits[0,0,:3] = "
              f"{logits[0, 0, :3].float().tolist()}")

    # ------------------------------- 3. what would this cost on the real chip?
    shapes = [(128, 512)] * 8          # eight BSS-2-tile-sized matmuls
    m = SystemModel()
    r = m.report([LayerWork(k=k_, n=n_) for k_, n_ in shapes])
    print(f"[3] 8-tile inference on the BSS-2 mobile system: "
          f"{r['time_s']*1e6:.0f} us, {r['energy_total_j']*1e3:.2f} mJ "
          f"({r['ops_per_s']/1e6:.0f} MOp/s)")
    print("    (constants calibrated to paper Table 1; see "
          "repro_torch/core/energy.py)")


if __name__ == "__main__":
    main()
