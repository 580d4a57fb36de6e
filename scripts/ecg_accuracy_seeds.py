#!/usr/bin/env python3
"""Seed spread of the ECG hardware-in-the-loop accuracy loop.

The loop's test accuracy at the ``--fast`` preset (n_train=1000,
n_test=300, epochs=20, lr=3e-3) is one sample of a wide distribution:
early stopping with patience 6 on a 125-record validation set keeps the
parameters of whichever epoch first saturates it.  This script runs the
loop at several seeds and prints one line per (seed, chain) with the
detection rate, false-positive rate, test accuracy and epochs run:

    PYTHONPATH=src python3 scripts/ecg_accuracy_seeds.py --seeds 0 1 2 3
    PYTHONPATH=src:. JAX_PLATFORMS=cpu python3 scripts/ecg_accuracy_seeds.py \\
        --impl jax --seeds 0 1 2 3
    PYTHONPATH=src:. JAX_PLATFORMS=cpu python3 scripts/ecg_accuracy_seeds.py \\
        --impl streams --seeds 0 --chains digital

``--impl torch`` (default) runs the port's loop
(``repro_torch.train.ecg_accuracy.run``) on ``--device`` (default: the
CUDA device; ``cpu`` for the plain versions).  ``--impl jax`` runs the
JAX package's reference (``benchmarks.ecg_accuracy.run``; its analog runs
also calibrate a bake at the end, which this script does not print).
``--impl streams`` drives the port's train step and eval, on the CPU,
with the reference's own random numbers - its init, its shuffles and its
per-layer readout-noise draws (the keys split as its ``run`` splits
them) - through a whole ``--fast`` run with the reference's early
stopping, beside the reference's run: both per-epoch histories (loss,
detection, FP rate, test accuracy), then both final lines.  The two
loops agree while fp32 summation order has not yet moved a trajectory;
over many seeds, the final accuracies show whether the port's loop
itself trains as well as the reference's.
"""
from __future__ import annotations

import argparse

CHAINS = {"none": ("analog_faithful", "none"),
          "relu_shift": ("analog_faithful", "relu_shift"),
          "digital": ("digital", "none")}
FAST = dict(n_train=1000, n_test=300, epochs=20, lr=3e-3)


def _line(impl, chain, seed, det, fpr, acc, epochs):
    print(f"{impl:5s} {chain:10s} seed {seed:2d}: detection {det:.4f} "
          f"FP {fpr:.4f} accuracy {acc:.4f} epochs {epochs}", flush=True)


def spread(impl: str, seeds, chains, device) -> None:
    if impl == "torch":
        from repro_torch.train.ecg_accuracy import run
    else:
        from benchmarks.ecg_accuracy import run
    for seed in seeds:
        for chain in chains:
            mode, epilogue = CHAINS[chain]
            kw = dict(mode=mode, epilogue=epilogue, seed=seed,
                      verbose=False, **FAST)
            if impl == "torch":
                kw["device"] = device
            r = run(**kw)
            _line(impl, chain, seed, float(r["detection_rate"]),
                  float(r["false_positive_rate"]), float(r["accuracy"]),
                  len(r["history"]))


def streams(seed: int, chain: str, patience: int) -> None:
    import jax
    import numpy as np
    import torch

    from benchmarks.ecg_accuracy import run as ref_run
    from repro.core.noise import readout_noise
    from repro.models.ecg import ECGConfig as JECGConfig
    from repro.models.ecg import ecg_init as jecg_init
    from repro_torch import api
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.data.ecg_synth import ECGDatasetConfig, make_dataset
    from repro_torch.data.preprocess import preprocess
    from repro_torch.models.ecg import (ECGConfig, ecg_apply_plan,
                                        ecg_module_spec)
    from repro_torch.train import ecg_accuracy as T
    from repro_torch.train import optimizer as O

    mode, epilogue = CHAINS[chain]
    n_train, n_test, epochs = FAST["n_train"], FAST["n_test"], FAST["epochs"]
    batch = 64
    ref = ref_run(mode=mode, epilogue=epilogue, seed=seed, verbose=False,
                  patience=patience, **FAST)
    dcfg = ECGDatasetConfig(n_train=n_train, n_test=n_test, seed=1234)
    xtr_raw, ytr = make_dataset(dcfg, "train")
    xte_raw, yte = make_dataset(dcfg, "test")
    xtr = preprocess(xtr_raw, device="cpu")
    xte = preprocess(xte_raw, device="cpu")
    ytr, yte = torch.as_tensor(ytr), torch.as_tensor(yte)
    n_val = max(n_train // 8, 32)
    xval, yval = xtr[:n_val], ytr[:n_val]
    xtr, ytr = xtr[n_val:], ytr[n_val:]
    params = params_from_numpy(jax.tree.map(
        np.asarray, jecg_init(jax.random.PRNGKey(seed), JECGConfig())),
        "cpu")
    acfg = (AnalogConfig(mode=mode, deterministic=False)
            if mode != "digital" else AnalogConfig(mode="digital"))
    ocfg = O.AdamWConfig(lr=FAST["lr"], warmup_steps=20, weight_decay=0.01,
                         total_steps=epochs * (n_train // batch))
    opt = O.adamw_init(params, ocfg)
    spec = ecg_module_spec(ECGConfig(), epilogue=epilogue)

    def infer(params, xb):
        with torch.no_grad():
            model = api.compile(spec, params,
                                acfg.replace(deterministic=True),
                                device="cpu")
            return (model.apply(xb) if mode == "digital"
                    else ecg_apply_plan(model.lower(), xb, ECGConfig()))

    # the per-layer readout-noise shapes at batch 64: conv [64, 32]
    # positions x 1 chunk x 8, fc1 2 chunks x 123, fc2 1 chunk x 10
    shapes = [(batch, 32, 1, 8), (batch, 2, 123), (batch, 1, 10)]
    key = jax.random.PRNGKey(seed + 1)
    best, stale = (-1.0, params), 0
    for ep in range(epochs):
        key, kp = jax.random.split(key)
        perm = torch.as_tensor(np.asarray(
            jax.random.permutation(kp, len(xtr))))
        for i in range(len(xtr) // batch):
            idx = perm[i * batch:(i + 1) * batch]
            key, kn = jax.random.split(key)
            noise = None
            if mode != "digital":
                noise = [torch.tensor(np.asarray(readout_noise(
                    k, s, acfg.noise))) for k, s in zip(
                        jax.random.split(kn, 3), shapes)]
            params, opt, loss, _ = T.train_step(
                params, opt, xtr[idx], ytr[idx], acfg=acfg,
                mcfg=ECGConfig(), ocfg=ocfg, noise=noise,
                epilogue=epilogue)
        _, _, val_acc = T.detection_metrics(infer(params, xval), yval)
        det, fpr, acc = T.detection_metrics(infer(params, xte), yte)
        if ep < len(ref["history"]):
            r_loss, r_det, r_fpr, r_acc = ref["history"][ep]
            tail = (f"| reference loss {float(r_loss):.6g} det "
                    f"{float(r_det):.4f} FP {float(r_fpr):.4f} acc "
                    f"{float(r_acc):.4f}")
        else:
            tail = "| reference stopped"
        print(f"epoch {ep + 1:2d}  port loss {float(loss):.6g} det "
              f"{det:.4f} FP {fpr:.4f} acc {acc:.4f} {tail}", flush=True)
        if val_acc > best[0]:
            best, stale = (val_acc, params), 0
        else:
            stale += 1
        if stale >= patience:
            break
    det, fpr, acc = T.detection_metrics(infer(best[1], xte), yte)
    _line("port", chain, seed, det, fpr, acc, ep + 1)
    _line("ref", chain, seed, float(ref["detection_rate"]),
          float(ref["false_positive_rate"]), float(ref["accuracy"]),
          len(ref["history"]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("torch", "jax", "streams"),
                    default="torch")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--chains", nargs="+", choices=tuple(CHAINS),
                    default=list(CHAINS))
    ap.add_argument("--device", default=None,
                    help="torch device of --impl torch (default: CUDA)")
    ap.add_argument("--patience", type=int, default=6,
                    help="early-stopping patience of --impl streams (the "
                         "reference's; more than 20 runs every epoch)")
    args = ap.parse_args()
    if args.impl == "streams":
        for seed in args.seeds:
            for chain in args.chains:
                streams(seed, chain, args.patience)
    else:
        spread(args.impl, args.seeds, args.chains, args.device)


if __name__ == "__main__":
    main()
