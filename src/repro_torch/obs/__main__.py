"""CLI: render obs JSONL runs, or produce one from a tiny serve loop (port
of ``python -m repro.obs``).

    python -m repro_torch.obs run.jsonl                  # render a run
    python -m repro_torch.obs --serve-smoke out.jsonl    # on the card
    python -m repro_torch.obs --serve-smoke out.jsonl --device cpu

``--serve-smoke`` is the observability gate of the deployment loop: it
boots a tiny analog LM through ``ServeEngine`` twice (plan-cache miss,
then hit), serves batches across a forced drift episode, serves a
fleet-placed copy of the LM through a forced chip failure, dumps the
combined trace + metrics JSONL, and exits 1 if any required span, event,
counter or histogram is missing from the run (0 when nothing is).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from . import report

# The telemetry contract of an instrumented serve run (the reference's).
REQUIRED_SPANS = (
    "serve.compile",
    "serve.compile/api.compile",
    "serve.batch",
    "serve.batch/serve.prefill",
    "serve.batch/serve.decode",
)
REQUIRED_EVENTS = (
    "serve.plan_cache",
    "serve.refill",
    "serve.energy",
    "drift.probe",
    "drift.hot_swap",
    "fleet.probe",
    "fleet.remap",
)
REQUIRED_COUNTERS = (
    "exec.dispatches",
    "serve.plan_cache.hit",
    "serve.plan_cache.miss",
    "serve.hot_swap",
    "drift.hot_swap",
    "fleet.remap",
)
REQUIRED_HISTOGRAMS = (
    "serve.queue_us",
    "serve.prefill_us",
    "serve.decode_us",
    "serve.batch_occupancy",
    "drift.lsb",
    "fleet.drift_lsb",
)


def serve_smoke(out_path: str, device=None) -> int:
    """Run the tiny instrumented serve loop on ``device`` (``None`` = the
    CUDA device) and gate on the contract."""
    import numpy as np
    import torch

    from repro_torch import calib, obs
    from repro_torch.configs.base import ArchConfig, RunConfig
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.device import resolve_device
    from repro_torch.core.noise import NOISELESS
    from repro_torch.fleet import (ChipFleet, FleetMonitor, calibrate_fleet,
                                   model_layer_shapes, model_snapshot,
                                   place_model)
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine

    dev = resolve_device(device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    cfg = ArchConfig("obs-smoke", "dense", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256)
    params = T.lm_init(gen(0), cfg, device=dev)
    run_cfg = RunConfig(analog=AnalogConfig(mode="analog_fast"))
    spec = T.lm_module_spec(cfg, params)
    chips = calib.model_chips(spec, params, gen(0))
    snap = calib.calibrate_model(spec, params, gen(0), chips=chips,
                                 offset_repeats=16, gain_repeats=2)
    mon = calib.DriftMonitor(chips, snap, threshold_lsb=0.5)

    obs.reset_metrics()
    prompt = np.arange(6) % cfg.vocab_size
    drift = gen(70)
    with tempfile.TemporaryDirectory() as td:
        cache = os.path.join(td, "plan.npz")
        with obs.collect("serve-smoke") as tr:
            eng = ServeEngine(cfg, run_cfg, params, batch_size=2,
                              max_len=32, calibration=snap,
                              drift_monitor=mon, plan_cache=cache,
                              device=dev)
            eng.serve([Request(i, prompt, 4) for i in range(3)])
            for c in chips.values():
                c.apply_drift(drift, 2.0)
            eng.serve([Request(3, prompt, 4)])
            # warm boot: the packed plan on disk is the executable
            ServeEngine(cfg, run_cfg, params, batch_size=2, max_len=32,
                        calibration=mon.snapshot, plan_cache=cache,
                        device=dev)
            # fleet-backed boot: the same LM placed across a chip fleet,
            # served, then ONE chip failure that the probe heartbeat
            # catches and hot-swaps onto a spare
            frun = RunConfig(analog=AnalogConfig(mode="analog",
                                                 chunk_rows=64))
            pl = place_model(model_layer_shapes(spec, params), n_chips=19,
                             spares=2, chunk_rows=64, cols=256)
            fleet = ChipFleet.for_placement(gen(5), pl, noise=NOISELESS)
            fsnap = calibrate_fleet(fleet, offset_repeats=4, gain_repeats=1)
            fmon = FleetMonitor(fleet, pl, fsnap, probe_repeats=4,
                                spare_offset_repeats=4, spare_gain_repeats=1)
            feng = ServeEngine(cfg, frun, params, batch_size=2, max_len=32,
                               calibration=model_snapshot(pl, fsnap),
                               fleet=fmon, device=dev)
            feng.serve([Request(4, prompt, 2)])
            fleet.kill(pl.assignments[0].chip)
            feng.serve([Request(5, prompt, 2)])

    records = report.records_of(tr, obs.registry())
    report.dump_run(out_path, tr, obs.registry())
    print(report.render(records))
    print(f"\nwrote {out_path} ({len(records)} records)")

    missing = report.required_missing(
        records, span_paths=REQUIRED_SPANS, events=REQUIRED_EVENTS,
        counters=REQUIRED_COUNTERS, histograms=REQUIRED_HISTOGRAMS)
    statuses = {r["meta"].get("status") for r in records
                if r.get("rec") == "event"
                and r["name"] == "serve.plan_cache"}
    for want in ("miss", "hit"):
        if want not in statuses:
            missing.append(f"event:serve.plan_cache[status={want}]")
    for name in ("drift.hot_swap", "fleet.remap"):
        got = [r for r in records
               if r.get("rec") == "event" and r["name"] == name]
        if len(got) != 1:
            missing.append(f"event:{name} (want exactly 1, got {len(got)})")
    if missing:
        print("MISSING telemetry:\n  " + "\n  ".join(missing))
        return 1
    print("serve-smoke telemetry contract: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="render obs JSONL runs / run the instrumented serve "
                    "smoke")
    ap.add_argument("jsonl", nargs="?", help="run file to render")
    ap.add_argument("--serve-smoke", metavar="OUT",
                    help="run a tiny instrumented serve loop, write its "
                         "JSONL to OUT and gate on required telemetry")
    ap.add_argument("--device", default=None,
                    help="device of the serve smoke (default: the CUDA "
                         "device; 'cpu' runs it on the host)")
    args = ap.parse_args(argv)
    if args.serve_smoke:
        return serve_smoke(args.serve_smoke, device=args.device)
    if not args.jsonl:
        ap.error("nothing to do: pass a JSONL file or --serve-smoke OUT")
    print(report.render(report.load(args.jsonl)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
