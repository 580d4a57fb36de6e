"""Train an LM with every parameter matmul on emulated BSS-2 analog tiles,
in the PyTorch port (the twin of ``examples/lm_analog_train.py``): the
paper's §V claim ("arbitrarily large models by time-multiplexing analog
tiles") exercised end to end with HIL/QAT training.

    PYTHONPATH=src python examples_torch/lm_analog_train.py \
        --arch qwen3-moe-30b-a3b --steps 60 [--device cpu]

Uses the smoke-size variant of the chosen architecture.  Trains the same
model twice - digital and analog_faithful - and compares loss curves: the
analog run converges despite W6A5 quantization, saturating 8-bit ADCs and
fixed-pattern noise, which is the paper's §III-B result.

The train step goes through the ``repro_torch.api`` front door: every
step re-compiles the declared analog layers from the float masters inside
the gradient (``api.compile`` in ``train/train_step.py``), which IS the
hardware-in-the-loop scheme - the STE quantizers in the lowering carry
the gradients back.  It runs on the CUDA device unless ``--device``
names another.
"""
import argparse

import numpy as np

from repro_torch import configs
from repro_torch.launch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b", choices=configs.ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    a = ap.parse_args(argv)

    print(f"=== {a.arch} (smoke config), digital baseline ===")
    dig = train_loop(a.arch, smoke=True, steps=a.steps, batch=a.batch,
                     seq_len=a.seq_len, mode="digital",
                     log_every=max(a.steps // 5, 1), device=a.device)
    print(f"\n=== {a.arch} (smoke config), analog_faithful (HIL/QAT) ===")
    ana = train_loop(a.arch, smoke=True, steps=a.steps, batch=a.batch,
                     seq_len=a.seq_len, mode="analog_faithful",
                     log_every=max(a.steps // 5, 1), device=a.device)

    d0, d1 = np.mean(dig["losses"][:5]), np.mean(dig["losses"][-5:])
    a0, a1 = np.mean(ana["losses"][:5]), np.mean(ana["losses"][-5:])
    print("\n=== summary ===")
    print(f"digital: {d0:.3f} -> {d1:.3f}")
    print(f"analog:  {a0:.3f} -> {a1:.3f}")
    print("analog training converges through the quantized, noisy, "
          "saturating substrate (paper §III-B / Fig. 8)."
          if a1 < 0.9 * a0 else
          "WARNING: analog run did not converge - inspect noise config")


if __name__ == "__main__":
    main()
