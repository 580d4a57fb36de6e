#!/usr/bin/env python3
"""A/B device time of the split tile (``analog_mvm_split`` and the
transformer-block kernel ``analog_plan_block``) between two checkouts of
the port, on one CUDA device, in one call:

    python3 scripts/ab_split.py BEFORE_ROOT AFTER_ROOT [--rounds 1]

Each root is a checkout of the repository (``ROOT/src/repro_torch`` must
exist).  The sides run in the order before, after, after, before per
round, each in a fresh Python process that imports ``repro_torch`` from
its own root and builds its own kernels there.  Each process reports:

* ``nvcc``'s register and spill report (``-Xptxas -v``) of every kernel
  entry of the two libraries;
* the split kernel at phi4-mini-3.8b's six layer shapes of one decode
  step (fused QKV, o, up, gate, down, lm_head; K padded to whole 128-row
  chunks) at M = 4 (decode) and M = 48 (prefill, 4 x 12), faithful mode,
  seed-0 rank-1 int8 codes: the device ms per launch of the code operand
  without a chunk_gain table and, where the checkout takes one
  (``chunk_gain=``), with a float one; summed over the 161 launches of
  one decode step and of one prefill (32 layers x 5 + the lm_head);
* the block kernel on one full-width phi4-mini block (seed-0 weights,
  ``api.compile_block``, 4 x 12 rows): device ms per launch, and where
  the checkout compiles a calibrated block (``calibration=``), the same
  block compiled from a blind calibration of its seven member chips.

Device times are read from a ``torch.profiler`` trace: the mean device
time of the kernel's own records (every record of the named kernel,
whatever other activity the trace holds), 20 launches per trace.  Prints
one JSON line per process, then a summary line (each side's median over
its processes), and writes all of it to ``chiprun_out/ab_split.json``
under the current directory.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import re
import statistics
import subprocess
import sys

SHAPES_M = {"decode": 4, "prefill": 48}
SEQ = 12


def ptxas_report(log: str) -> list:
    """(entry, registers, spill store bytes, spill load bytes) of every
    kernel entry in an ``nvcc -Xptxas -v`` log."""
    out, cur, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            out.append({"entry": cur, "registers": int(m.group(1)),
                        "spill_stores": spill[0], "spill_loads": spill[1]})
            cur, spill = None, (0, 0)
    return out


def kernel_ms(torch, fn, needle: str, iters: int = 20):
    """Mean device ms of the trace records whose name holds ``needle``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    recs = [e for e in prof.key_averages() if needle in e.key
            and getattr(e, "self_device_time_total", 0.0) > 0]
    n = sum(e.count for e in recs)
    if n == 0:
        return None
    return sum(e.self_device_time_total for e in recs) / n / 1e3


def one_side(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import api, calib, configs
    from repro_torch.calib.device import VirtualChip
    from repro_torch.calib.routines import chip_generator
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.analog_mvm import analog_mvm_split_codes_cuda
    from repro_torch.kernels.analog_plan import analog_plan_block_cuda
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L

    dev = torch.device("cuda")
    names = ("analog_mvm_split", "analog_plan_block")
    build_s = _build.build(names)
    ptxas = {}
    for name in names:
        lib = _build.library_path(name)
        ptxas[name] = ptxas_report(
            lib.with_name(lib.name + ".log").read_text())
    takes_cg = "chunk_gain" in inspect.signature(
        analog_mvm_split_codes_cuda).parameters
    cfg = configs.get_arch("phi4-mini-3.8b")
    pad = lambda k: -(-k // 128) * 128  # noqa: E731
    nq, nkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    d, f = pad(cfg.d_model), pad(cfg.d_ff)
    shapes = (("qkv", d, nq + 2 * nkv, (nq, nkv, nkv)),
              ("wo", pad(nq), cfg.d_model, None),
              ("up", d, cfg.d_ff, None), ("gate", d, cfg.d_ff, None),
              ("down", f, cfg.d_model, None),
              ("lm_head", d, cfg.vocab_size, None))
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, k, n, blocks in shapes:
        codes = torch.randint(-63, 64, (k, n), generator=g,
                              device=dev).to(torch.int8)
        col = 1 + 0.014 * torch.randn((n,), generator=g, device=dev)
        row = 1 + 0.014 * torch.randn((1 if blocks is None else len(blocks),
                                       k), generator=g, device=dev)
        cg = 1 + 0.01 * torch.randn((k // 128, n), generator=g, device=dev)
        gain = torch.full((n,), 2.0 ** -9, device=dev)
        off = torch.randn((k // 128, n), generator=g, device=dev)
        for phase, m in SHAPES_M.items():
            x = torch.randn((m, k), generator=g, device=dev)
            scale = x.abs().max() / 31.0
            a_pos = torch.clamp(torch.round(x / scale), 0.0, 31.0)
            a_neg = torch.clamp(torch.round(-x / scale), 0.0, 31.0)
            r = {"layer": name, "phase": phase, "m": m, "k": k, "n": n,
                 "rank1_ms": kernel_ms(torch, lambda: (
                     analog_mvm_split_codes_cuda(
                         a_pos, a_neg, codes, col, row, gain, off,
                         col_blocks=blocks)), "split_kernel")}
            if takes_cg:
                r["chunk_gain_ms"] = kernel_ms(torch, lambda: (
                    analog_mvm_split_codes_cuda(
                        a_pos, a_neg, codes, col, row, gain, off,
                        chunk_gain=cg, col_blocks=blocks)), "split_kernel")
            rows.append(r)
        del codes, cg

    def per_call(phase, key):
        sel = {r["layer"]: r.get(key) for r in rows if r["phase"] == phase}
        if any(v is None for v in sel.values()):
            return None
        return cfg.n_layers * sum(v for k, v in sel.items()
                                  if k != "lm_head") + sel["lm_head"]

    split = {f"{phase}_{key}_per_call": per_call(phase, key)
             for phase in SHAPES_M for key in ("rank1_ms", "chunk_gain_ms")}
    # one full-width block, 4 x 12 rows
    bg = torch.Generator(device=dev).manual_seed(0)
    block = {
        "ln1": {"scale": 1 + 0.1 * torch.randn((cfg.d_model,), generator=bg,
                                               device=dev)},
        "attn": A.attention_init(bg, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, device=dev),
        "ln2": {"scale": 1 + 0.1 * torch.randn((cfg.d_model,), generator=bg,
                                               device=dev)},
        "mlp": L.mlp_init(bg, cfg.d_model, cfg.d_ff, device=dev),
    }
    acfg = AnalogConfig(mode="analog_faithful", act_calib="static")
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.hd, seq=SEQ, rope_theta=cfg.rope_theta)
    x = torch.randn((4 * SEQ, cfg.d_model), generator=bg, device=dev)
    plans = {"uncalibrated": api.compile_block(block, acfg, **kw)}
    members = {"wq": block["attn"]["wq"], "wk": block["attn"]["wk"],
               "wv": block["attn"]["wv"], "wo": block["attn"]["wo"],
               "up": block["mlp"]["up"], "gate": block["mlp"]["gate"],
               "down": block["mlp"]["down"]}
    chips = {m: VirtualChip.from_params(node, chip_generator(bg, i, dev))
             for i, (m, node) in enumerate(members.items())}
    snap = calib.calibrate_model(None, None, bg, chips=chips)
    try:
        plans["calibrated"] = api.compile_block(block, acfg,
                                                calibration=snap, **kw)
    except NotImplementedError:  # a checkout without calibrated blocks
        pass
    blk = {}
    for label, model in plans.items():
        mp = model.lower().mega
        fn = lambda mp=mp: analog_plan_block_cuda(  # noqa: E731
            x, mp.stores, mp.gain, mp.off, schedule=mp.schedule,
            block=mp.block, extras=mp.extras)[0]
        blk[f"{label}_ms"] = kernel_ms(torch, fn, "analog_plan_block_kernel")
    return {"root": str(root), "build_s": build_s, "ptxas": ptxas,
            "split_rows": rows, "split": split, "block": blk,
            "device": torch.cuda.get_device_name(0)}


def _summary(runs: list) -> dict:
    out = {}
    for side in ("before", "after"):
        sel = [r for r in runs if r["side"] == side]
        vals = {}
        for part in ("split", "block"):
            for key in sel[0][part]:
                xs = [r[part][key] for r in sel if r[part].get(key)
                      is not None]
                vals[key] = statistics.median(xs) if xs else None
        out[side] = vals
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=pathlib.Path)
    ap.add_argument("--one", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(one_side(args.one.resolve())), flush=True)
        return
    if len(args.roots) != 2:
        ap.error("give BEFORE_ROOT and AFTER_ROOT")
    sides = dict(zip(("before", "after"), args.roots))
    runs = []
    for _ in range(args.rounds):
        for side in ("before", "after", "after", "before"):
            res = subprocess.run(
                [sys.executable, __file__, "--one", str(sides[side])],
                capture_output=True, text=True, timeout=1200)
            if res.returncode != 0:
                sys.exit(f"ab_split: the {side} side failed:\n"
                         f"{res.stderr[-4000:]}")
            run = json.loads(res.stdout.strip().splitlines()[-1])
            run["side"] = side
            print(json.dumps(run), flush=True)
            runs.append(run)
    summary = _summary(runs)
    print(json.dumps({"summary": summary}), flush=True)
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "ab_split.json").write_text(json.dumps(
        {"runs": runs, "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
