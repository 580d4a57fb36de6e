#!/usr/bin/env python3
"""A/B timing of ``CompiledModel.apply`` (or of LM serving steps) between
two checkouts of the port, on one CUDA device, in one call:

    python3 scripts/ab_apply.py BEFORE_ROOT AFTER_ROOT [--rounds 2]
    python3 scripts/ab_apply.py BEFORE_ROOT AFTER_ROOT --lm [--rounds 2]
    python3 scripts/ab_apply.py BEFORE_ROOT AFTER_ROOT --chain [--rounds 2]
    python3 scripts/ab_apply.py BEFORE_ROOT AFTER_ROOT --mvm [--rounds 2]

Each root is a checkout of the repository (``BEFORE_ROOT/src/repro_torch``
must exist).  The sides run in the order before, after, after, before per
round, each in a fresh Python process that imports ``repro_torch`` from
its own root, builds its own kernels there, compiles the ECG relu_shift
chain at the published width (``ECGConfig()``, seed 0, the records of
``make_dataset``) and times ``apply`` at batch 1 and 500 through both
routes: ``--calls`` synchronized calls each, after a warm-up, on the host
clock.  It also reads the device time and the device activities per
``apply`` from a ``torch.profiler`` trace of 20 calls (each activity's
mean time times its count per call) and keeps a checksum of the logits,
so the two sides can be seen to compute the same thing.

With ``--lm`` each process instead builds phi4-mini-3.8b at its published
width (random weights, seed 0), compiles a ``ServeEngine`` (batch 4,
faithful analog mode, as ``chip_smoke.py`` serves it) and times a 4 x 12
prefill (``--calls // 20`` calls) and decode steps on its cache
(``--calls // 10`` steps), each synchronized on the host clock, plus the
device time and activities of one decode step from a profiler trace, and
the host time per call of one small split layer (``run_layer`` on a
4 x 256 x 256 rank-1 layer, 400 calls back to back per sample), where
the device work is too small to hide the dispatch path.

With ``--chain`` each process instead times the chain kernel's wrapper
``analog_plan_cuda`` alone on the ECG megakernel packs (the relu_shift
code chain, stage a, and the static float chain, stage b; seed 0, the
``make_dataset`` records) at batch 1 and 500: ``--calls`` calls back to
back per sample, 7 samples, on the host clock, synchronized at the end
of each sample.

With ``--mvm`` each process instead reads the device time per launch of
the ``analog_mvm`` kernel (``analog_mvm_cuda``) at the six ECG layer
shapes (conv, fc1, fc2 at batch 1 and 500) from a profiler trace of 50
launches, on the relu_shift chain's own operands (its lowered weights,
gains and offsets, and each layer's input codes), with the layer's
epilogue; each shape's output is checksummed.

Prints one JSON line per process, then a summary line (each side's
median over its processes of the per-process median and quartiles, in µs
per call), and writes all of it to ``chiprun_out/ab_apply.json`` (with
``--lm``: ``chiprun_out/ab_serve.json``; with ``--chain``:
``chiprun_out/ab_chain.json``; with ``--mvm``: ``chiprun_out/ab_mvm.json``)
under the current directory.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

BATCHES = (1, 500)


def _quartiles(us):
    q = statistics.quantiles(us, n=4)
    return [q[0], q[1], q[2]]


def device_per_call(fn, iters=20):
    """(device µs, device activities) per call of ``fn`` from one
    ``torch.profiler`` trace of ``iters`` calls, after one traced warm-up
    call that is discarded: each activity's mean time times its count
    per call (a trace may drop its last records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    saved = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: saved.append(p.key_averages())
                 ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    us = acts = 0
    for e in saved[0] if saved else []:
        if getattr(e, "self_device_time_total", 0.0) <= 0:
            continue
        per = round(e.count / iters)
        us += e.self_device_time_total / e.count * per
        acts += per
    return (us if acts else None), acts


def one_side_mvm(model, raw) -> dict:
    """Device µs per analog_mvm launch at the ECG layer shapes."""
    import torch
    from repro_torch.data.preprocess import preprocess
    from repro_torch.kernels import ref
    from repro_torch.kernels.analog_mvm import analog_mvm_cuda
    from repro_torch.models.ecg import _im2col

    plan = model.lower()
    out = {}
    for b in BATCHES:
        h = _im2col(preprocess(raw[:b]), 64, 2)
        for name, lp in zip(("conv", "fc1", "fc2"), plan.layers):
            a = torch.nn.functional.pad(h.reshape(-1, h.shape[-1]),
                                        (0, lp.k_pad - h.shape[-1]))
            args = (a.contiguous(), lp.w_eff.contiguous(),
                    torch.broadcast_to(lp.gain, (lp.n,)).contiguous(),
                    lp.chunk_offset.contiguous())
            epi = ("relu_shift", lp.shift) \
                if lp.epilogue == "relu_shift" else None
            us, acts = device_per_call(
                lambda: analog_mvm_cuda(*args, epilogue=epi), iters=50)
            y = analog_mvm_cuda(*args, epilogue=epi)
            out[f"B={b} {name} {tuple(args[0].shape)}x{lp.n}"] = {
                "device_us": us, "device_activities": acts,
                "logits_sum": float(y.double().sum())}
            y = ref.adc_epilogue_ref(ref.analog_mvm_ref(*args), epi)
            h = y.reshape(b, -1) if lp.flatten_out else y
    return out


def one_side_lm(root: pathlib.Path, calls: int) -> dict:
    """Time LM serving steps of one checkout in this process."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.analog import AnalogConfig, analog_linear_init
    from repro_torch.exec.lower import lower_layer
    from repro_torch.exec.run import run_layer
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    cfg = configs.get_arch("phi4-mini-3.8b")
    params = T.lm_init(torch.Generator(device=dev).manual_seed(0), cfg)
    engine = ServeEngine(cfg, RunConfig(analog=AnalogConfig(
        mode="analog_faithful")), params, batch_size=4, max_len=128)
    del params
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 12)), device=dev)

    def prefill():
        cache = T.init_lm_cache(cfg, 4, 128, dtype=torch.float32,
                                device=dev)
        return engine.prefill(engine.params, {"tokens": toks}, cache)

    logits, cache = prefill()
    pre = []
    for _ in range(max(3, calls // 20)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill()
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e6)
    tok = torch.argmax(logits, dim=-1)[:, None]
    state = {"cache": cache}

    def decode():
        lg, state["cache"] = engine.decode(engine.params, tok,
                                           state["cache"])
        return lg

    decode()
    dec = []
    for _ in range(max(3, calls // 10)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = decode()
        torch.cuda.synchronize()
        dec.append((time.perf_counter() - t0) * 1e6)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0.0) > 0]
    acfg = AnalogConfig(mode="analog_faithful")
    lp = lower_layer(analog_linear_init(
        torch.Generator(device=dev).manual_seed(1), 256, 256), acfg)
    x = torch.randn((4, 256), device=dev)
    for _ in range(50):
        run_layer(lp, x, acfg)
    layer = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(400):
            run_layer(lp, x, acfg)
        torch.cuda.synchronize()
        layer.append((time.perf_counter() - t0) / 400 * 1e6)
    return {
        "LM layer call 4x256x256": {"us_q1_median_q3": _quartiles(layer)},
        "LM prefill 4x12": {"us_q1_median_q3": _quartiles(pre),
                            "logits_sum": float(logits.double().sum())},
        "LM decode step": {
            "us_q1_median_q3": _quartiles(dec),
            "device_us": sum(e.self_device_time_total for e in events),
            "device_activities": sum(e.count for e in events),
            "logits_sum": float(lg.double().sum())},
    }


def one_side_chain(calls: int, model, fmodel, raw) -> dict:
    """Time the chain wrapper alone, back to back, on both ECG packs."""
    import torch
    from repro_torch.data.preprocess import preprocess
    from repro_torch.kernels.analog_plan import analog_plan_cuda
    from repro_torch.models.ecg import _im2col

    out = {}
    for b in BATCHES:
        cols = _im2col(preprocess(raw[:b]), 64, 2).reshape(-1, 128)
        cols = cols.contiguous()
        for stage, m in (("a code chain", model), ("b float chain", fmodel)):
            mega = m.lower().mega

            def call(mega=mega):
                return analog_plan_cuda(cols, mega.w_cat, mega.gain,
                                        mega.off, schedule=mega.schedule,
                                        extras=mega.extras)

            for _ in range(50):
                y = call()
            torch.cuda.synchronize()
            us = []
            for _ in range(7):
                t0 = time.perf_counter()
                for _ in range(calls):
                    call()
                torch.cuda.synchronize()
                us.append((time.perf_counter() - t0) / calls * 1e6)
            out[f"B={b} stage {stage}"] = {
                "us_q1_median_q3": _quartiles(us),
                "logits_sum": float(y.double().sum())}
    return out


def one_side(root: pathlib.Path, calls: int, lm: bool = False,
             chain: bool = False, mvm: bool = False) -> dict:
    """Time one checkout in this process (the ``--one`` mode)."""
    sys.path.insert(0, str(root / "src"))
    import torch
    import repro_torch
    from repro_torch import api
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.data.ecg_synth import ECGDatasetConfig, make_dataset
    from repro_torch.data.preprocess import preprocess
    from repro_torch.models.ecg import ECGConfig, ecg_init, ecg_module_spec

    src = pathlib.Path(repro_torch.__file__).resolve()
    if not src.is_relative_to((root / "src").resolve()):
        raise RuntimeError(f"repro_torch imported from {src}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if lm:
        return {"root": str(root), **one_side_lm(root, calls)}
    raw, _ = make_dataset(ECGDatasetConfig(n_test=max(BATCHES)), "test")
    cfg = ECGConfig()
    model = api.compile(ecg_module_spec(cfg, epilogue="relu_shift"),
                        ecg_init(torch.Generator().manual_seed(0), cfg),
                        AnalogConfig(fused_epilogue=True))
    out = {"root": str(root)}
    if mvm:
        return {**out, **one_side_mvm(model, raw)}
    if chain:
        fmodel = api.compile(ecg_module_spec(cfg, epilogue="none"),
                             ecg_init(torch.Generator().manual_seed(0), cfg),
                             AnalogConfig(act_calib="static",
                                          fused_epilogue=True))
        return {**out, **one_side_chain(calls, model, fmodel, raw)}
    for b in BATCHES:
        x = preprocess(raw[:b])
        for mk in (True, False):
            for _ in range(5):
                y = model.apply(x, megakernel=mk)
            torch.cuda.synchronize()
            us = []
            for _ in range(calls):
                t0 = time.perf_counter()
                model.apply(x, megakernel=mk)
                torch.cuda.synchronize()
                us.append((time.perf_counter() - t0) * 1e6)
            dev_us, acts = device_per_call(
                lambda x=x, mk=mk: model.apply(x, megakernel=mk))
            route = "megakernel" if mk else "per_layer"
            out[f"B={b} {route}"] = {
                "us_q1_median_q3": _quartiles(us),
                "device_us": dev_us,
                "device_activities": acts,
                "logits_sum": float(y.double().sum()),
            }
    return out


def _summary(runs: list) -> dict:
    summary = {}
    for side in ("before", "after"):
        mine = [r for r in runs if r["side"] == side]
        for key in mine[0]:
            if not isinstance(mine[0][key], dict):
                continue
            meds = [r[key].get("us_q1_median_q3") for r in mine]
            host = {} if None in meds else {
                "median_of_medians_us":
                    statistics.median(m[1] for m in meds),
                "median_of_q1_us": statistics.median(m[0] for m in meds),
                "median_of_q3_us": statistics.median(m[2] for m in meds)}
            summary[f"{side} {key}"] = {
                **host,
                "device_activities": mine[0][key].get("device_activities"),
                "device_us": [r[key].get("device_us") for r in mine],
                "median_device_us": statistics.median(
                    [d for r in mine if (d := r[key].get("device_us"))
                     is not None] or [float("nan")]),
                "logits_sums": sorted({r[key].get("logits_sum")
                                       for r in mine} - {None}),
            }
    return summary


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=pathlib.Path)
    ap.add_argument("--one", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--lm", action="store_true",
                    help="time phi4-mini serving steps, not the ECG apply")
    ap.add_argument("--chain", action="store_true",
                    help="time the ECG chain kernel's wrapper alone")
    ap.add_argument("--mvm", action="store_true",
                    help="device time per analog_mvm launch at the ECG "
                         "shapes")
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(one_side(args.one.resolve(), args.calls, args.lm,
                                  args.chain, args.mvm)), flush=True)
        return
    if len(args.roots) != 2:
        ap.error("give two checkout roots: BEFORE_ROOT AFTER_ROOT")
    sides = dict(zip(("before", "after"),
                     (r.resolve() for r in args.roots)))
    for root in sides.values():
        if not (root / "src" / "repro_torch").is_dir():
            ap.error(f"{root} holds no src/repro_torch")
    runs = []
    for _ in range(args.rounds):
        for side in ("before", "after", "after", "before"):
            res = subprocess.run(
                [sys.executable, str(pathlib.Path(__file__).resolve()),
                 "--one", str(sides[side]), "--calls", str(args.calls)]
                + (["--lm"] if args.lm else [])
                + (["--chain"] if args.chain else [])
                + (["--mvm"] if args.mvm else []),
                capture_output=True, text=True, timeout=600,
                cwd=sides[side])
            if res.returncode != 0:
                sys.stderr.write(res.stdout + res.stderr)
                raise SystemExit(f"{side} side failed ({res.returncode})")
            run = json.loads(res.stdout.strip().splitlines()[-1])
            run["side"] = side
            runs.append(run)
            print(json.dumps(run), flush=True)
    summary = _summary(runs)
    print(json.dumps({"summary": summary}), flush=True)
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    name = ("ab_serve.json" if args.lm else "ab_chain.json" if args.chain
            else "ab_mvm.json" if args.mvm else "ab_apply.json")
    (out / name).write_text(
        json.dumps({"runs": runs, "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
