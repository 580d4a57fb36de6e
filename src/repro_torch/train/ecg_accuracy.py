"""The paper's §IV accuracy loop (Fig. 8 training curve): the Fig.-6 CDNN
trained hardware-in-the-loop on the synthetic ECG records, on the card
(port of ``benchmarks/ecg_accuracy.py``).

Every training step compiles the net through the front door inside the
differentiated forward: the forward runs the noisy, saturating analog
model (fixed pattern + temporal readout noise, per-chunk ADC), the
backward its straight-through linearization, and AdamW updates the float
master weights only (paper §III-B).  After every epoch the eval lowers
once under ``torch.no_grad()`` with deterministic readout and replays the
plan (the megakernel route for the code chain, the per-layer
``analog_mvm`` route for the float chain) on the validation and test
sets; early stopping on the validation accuracy keeps the best
parameters.  Everything random - init, the shuffle, the readout noise -
comes from one ``torch.Generator`` on the card made from ``seed``; the
reference's ``jax.random`` draws cannot be reproduced, so the loop is
held to the reference's accuracy within a margin, not bit for bit.

After training, an analog run evaluates two bakes of the same weights on
the test set: the ideal (oracle) bake, which knows ``params["fpn"]``,
and the calibrated bake, which knows only what blind measurement of the
layers' chips recovered (:func:`repro_torch.calib.calibrate_model`, its
chips' readout noise seeded from ``seed + 2``).

    python -m repro_torch.train.ecg_accuracy --fast
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import api, calib
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.data.ecg_synth import ECGDatasetConfig, make_dataset
from repro_torch.data.preprocess import preprocess
from repro_torch.models.ecg import (
    ECGConfig,
    ecg_apply_plan,
    ecg_init,
    ecg_loss,
    ecg_module_spec,
)
from repro_torch.obs import trace as _trace
from repro_torch.train import optimizer as O

FAST = dict(n_train=1000, n_test=300, epochs=20, lr=3e-3)


def detection_metrics(logits: torch.Tensor, labels: torch.Tensor):
    """(detection rate, false-positive rate, accuracy) of the argmax
    predictions, class 1 = atrial fibrillation."""
    pred = logits.argmax(-1).cpu().numpy()
    labels = labels.cpu().numpy()
    tp = int(((pred == 1) & (labels == 1)).sum())
    fn = int(((pred == 0) & (labels == 1)).sum())
    fp = int(((pred == 1) & (labels == 0)).sum())
    tn = int(((pred == 0) & (labels == 0)).sum())
    det = tp / max(tp + fn, 1)
    fpr = fp / max(fp + tn, 1)
    acc = (tp + tn) / len(labels)
    return det, fpr, acc


def _clip_masters(params: dict) -> dict:
    """Clip master weights to the 6-bit representable range (the hardware
    cannot express anything beyond +-63 * w_scale; unclipped masters drift
    once the loss saturates and destabilize the quantized net)."""
    out = {}
    for name, layer in params.items():
        lim = 63.0 * layer["w_scale"]
        out[name] = dict(layer, w=torch.clamp(layer["w"], -lim, lim))
    return out


def loss_and_grads(params: dict, xb: torch.Tensor, yb: torch.Tensor,
                   acfg: AnalogConfig, mcfg: ECGConfig, *, noise=None,
                   epilogue: str = "none"):
    """The counterpart of ``jax.value_and_grad(ecg_loss, has_aux=True)``:
    ``(loss, aux, grads)`` with a gradient for EVERY leaf (the frozen
    calibration buffers included; zeros where the loss does not reach a
    leaf), detached."""
    leaves = O.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = ecg_loss(leaves, xb, yb, acfg, mcfg, noise,
                         epilogue=epilogue)
    flat = O.tree_leaves(leaves)
    gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    grads = O.tree_map(
        lambda p: torch.zeros_like(p) if (g := next(gs)) is None else g,
        leaves)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def train_step(params: dict, opt: dict, xb: torch.Tensor, yb: torch.Tensor,
               *, acfg: AnalogConfig, mcfg: ECGConfig,
               ocfg: O.AdamWConfig, noise=None, epilogue: str = "none"):
    """One HIL step: loss and gradients through the (re-lowered) analog
    forward, AdamW, then the master clip.  Returns ``(params, opt, loss,
    acc)``, all on the parameters' device (nothing read back)."""
    loss, aux, grads = loss_and_grads(params, xb, yb, acfg, mcfg,
                                      noise=noise, epilogue=epilogue)
    with torch.no_grad():
        params, opt, _ = O.adamw_update(params, grads, opt, ocfg)
        params = _clip_masters(params)
    return params, opt, loss, aux["acc"]


def run(n_train=1500, n_test=500, epochs=30, batch=64, lr=2e-3, seed=0,
        mode="analog_faithful", verbose=True, patience=6, epilogue="none",
        device: DeviceLike = None) -> dict:
    """Train the CDNN and report detection / false-positive rate and
    accuracy on the held-out test set (the reference's ``run``), on
    ``device`` (``None`` = the CUDA device).  An analog run also reports
    the calibrated bake's (``calibrated_*`` keys) and the seconds its
    blind calibration took (``calibrate_s``)."""
    dev = resolve_device(device)
    t0 = _trace.clock_us() * 1e-6
    dcfg = ECGDatasetConfig(n_train=n_train, n_test=n_test, seed=1234)
    xtr_raw, ytr = make_dataset(dcfg, "train")
    xte_raw, yte = make_dataset(dcfg, "test")
    xtr = preprocess(xtr_raw, device=dev)
    xte = preprocess(xte_raw, device=dev)
    ytr = torch.as_tensor(ytr, dtype=torch.int64, device=dev)
    yte = torch.as_tensor(yte, dtype=torch.int64, device=dev)
    # validation split for early stopping (paper §III-B)
    n_val = max(n_train // 8, 32)
    xval, yval = xtr[:n_val], ytr[:n_val]
    xtr, ytr = xtr[n_val:], ytr[n_val:]

    mcfg = ECGConfig()       # mock-mode noise on (full per-synapse map)
    acfg = (AnalogConfig(mode=mode, deterministic=False)
            if mode != "digital" else AnalogConfig(mode="digital"))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = ecg_init(gen, mcfg, device=dev)
    ocfg = O.AdamWConfig(lr=lr, warmup_steps=20, weight_decay=0.01,
                         total_steps=epochs * (n_train // batch))
    opt = O.adamw_init(params, ocfg)

    # standalone inference (deterministic readout, average pooling):
    # compile once per weight update, replay the plan for every eval batch
    spec = ecg_module_spec(mcfg, epilogue=epilogue)
    infer_acfg = acfg.replace(deterministic=True)

    def eval_batches(params, *xbs):
        with torch.no_grad():
            model = api.compile(spec, params, infer_acfg, device=dev)
            if mode == "digital":
                return [model.apply(xb) for xb in xbs]
            plan = model.lower()
            return [ecg_apply_plan(plan, xb, mcfg) for xb in xbs]

    n_batches = len(xtr) // batch
    history = []
    best = (-1.0, params)      # early stopping (paper §III-B)
    stale = 0
    epochs_run = 0
    for ep in range(epochs):
        perm = torch.randperm(len(xtr), generator=gen, device=dev)
        for i in range(n_batches):
            idx = perm[i * batch:(i + 1) * batch]
            params, opt, loss, _ = train_step(
                params, opt, xtr[idx], ytr[idx], acfg=acfg, mcfg=mcfg,
                ocfg=ocfg, noise=gen, epilogue=epilogue)
        epochs_run += 1
        val_logits, te_logits = eval_batches(params, xval, xte)
        _, _, val_acc = detection_metrics(val_logits, yval)
        det, fpr, acc = detection_metrics(te_logits, yte)
        history.append((float(loss), det, fpr, acc))
        if val_acc > best[0]:
            best = (val_acc, params)
            stale = 0
        else:
            stale += 1
        if verbose:
            _trace.log(f"epoch {ep + 1:3d}: loss={float(loss):.4f} "
                       f"val={val_acc*100:5.1f}% det={det*100:5.1f}% "
                       f"fp={fpr*100:5.1f}% acc={acc*100:5.1f}%")
        if stale >= patience:
            if verbose:
                _trace.log(f"early stop at epoch {ep + 1}")
            break
    params = best[1]
    (te_logits,) = eval_batches(params, xte)
    det, fpr, acc = detection_metrics(te_logits, yte)
    out = {
        "mode": mode,
        "epilogue": epilogue,
        "detection_rate": det,
        "false_positive_rate": fpr,
        "accuracy": acc,
        "train_s": _trace.clock_us() * 1e-6 - t0,
        "history": history,
        "params": params,
        "epochs_run": epochs_run,
        "steps": epochs_run * n_batches,
    }
    if mode != "digital":
        # ideal bake vs calibrated bake, same trained weights, same test
        # set: the calibrated plan only knows what blind measurement on
        # the layers' chips recovered
        t1 = _trace.clock_us() * 1e-6
        with torch.no_grad():
            snap = calib.calibrate_model(
                spec, params,
                torch.Generator(device=dev).manual_seed(seed + 2))
            plan_cal = api.compile(spec, params, infer_acfg,
                                   calibration=snap, device=dev).lower()
            logits_cal = ecg_apply_plan(plan_cal, xte, mcfg)
        det_c, fpr_c, acc_c = detection_metrics(logits_cal, yte)
        out.update(calibrated_detection_rate=det_c,
                   calibrated_false_positive_rate=fpr_c,
                   calibrated_accuracy=acc_c,
                   calibrate_s=_trace.clock_us() * 1e-6 - t1)
    return out


def main(fast: bool = False, device: DeviceLike = None) -> list:
    kw = dict(FAST) if fast else {}
    _trace.log("\n== ECG A-fib classification (paper §IV / Fig. 8) ==")
    _trace.log("HIL training through each inter-layer chain, eval on plans "
               "(ideal bake | calibrated-snapshot bake):")
    rows = []
    for epilogue, label in (("none", "float-glue"),
                            ("relu_shift", "code-domain")):
        r = run(mode="analog_faithful", verbose=False, epilogue=epilogue,
                device=device, **kw)
        rows.append(r)
        _trace.log(
            f"  {label:>12s}: detection {r['detection_rate']*100:5.1f}% "
            f"@ {r['false_positive_rate']*100:5.1f}% FP, accuracy "
            f"{r['accuracy']*100:5.1f}% | calibrated "
            f"{r['calibrated_detection_rate']*100:5.1f}% @ "
            f"{r['calibrated_false_positive_rate']*100:5.1f}% FP, "
            f"accuracy {r['calibrated_accuracy']*100:5.1f}%; "
            f"{r['epochs_run']} epochs, {r['train_s']:.1f} s")
    _trace.log("(paper: 93.7 +- 0.7 % @ 14.0 +- 1.0 %; synthetic data)")
    rd = run(mode="digital", verbose=False, device=device, **kw)
    _trace.log(
        f"digital baseline: detection {rd['detection_rate']*100:.1f}% @ "
        f"{rd['false_positive_rate']*100:.1f}% FP, accuracy "
        f"{rd['accuracy']*100:.1f}%")
    if resolve_device(device).type == "cuda":
        _trace.log(f"peak device memory "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return rows + [rd]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    main(args.fast, args.device)
