#!/usr/bin/env python3
"""Device time of the signed-split analog VMM kernel at phi4-mini-3.8b's
layer shapes, on one CUDA device:

    python3 scripts/bench_split.py [--arch phi4-mini-3.8b]

For each analog layer shape of one decode step (fused QKV, o, up, gate,
down, lm_head; K padded to whole 128-row chunks) at M = 4 (decode) and
M = 48 (prefill, 4 x 12), faithful mode, it makes rank-1 int8 codes from
a seed, checks the code operand against the plain version once (within
1 ADC LSB per chunk on <= 1 % of the elements) and reads the device time
per launch of both weight operands from a ``torch.profiler`` trace,
beside the bytes bound (each input once, each output once, at 3.35
TB/s).  Prints one JSON line per shape, then the sums over the 161
launches of one decode step and of one prefill (32 layers x 5 + the
lm_head), and writes them to ``chiprun_out/bench_split.json`` under the
current directory.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12


def device_ms(torch, fn, iters=20):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if getattr(e, "self_device_time_total", 0.0) > 0)
    return total / iters / 1e3 if total > 0 else None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_split: needs a CUDA device")
    from repro_torch import configs
    from repro_torch.kernels import ref
    from repro_torch.kernels.analog_mvm import (analog_mvm_split_codes_cuda,
                                                analog_mvm_split_cuda)

    dev = torch.device("cuda")
    cfg = configs.get_arch(args.arch)
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
        w = ref.rebuild_w_eff_ref(codes, col, row, blocks)
        gain = torch.full((n,), 2.0 ** -9, device=dev)
        off = torch.randn((k // 128, n), generator=g, device=dev)
        for phase, m in (("decode", 4), ("prefill", 48)):
            x = torch.randn((m, k), generator=g, device=dev)
            scale = x.abs().max() / 31.0
            a_pos = torch.clamp(torch.round(x / scale), 0.0, 31.0)
            a_neg = torch.clamp(torch.round(-x / scale), 0.0, 31.0)

            def codes_fn():
                return analog_mvm_split_codes_cuda(
                    a_pos, a_neg, codes, col, row, gain, off,
                    col_blocks=blocks)

            want = ref.analog_mvm_split_ref(a_pos, a_neg, w, gain, off)
            diff = (codes_fn() - want).abs()
            if float(diff.max()) > k // 128 or float(
                    (diff != 0).float().mean()) > 0.01:
                sys.exit(f"bench_split: {name} M={m}: max |diff| "
                         f"{float(diff.max())} against the plain version")
            nbytes = (4 * (2 * m * k + 2 * n + (k // 128) * n + m * n)
                      + k * n + 4 * row.numel())
            r = {"layer": name, "phase": phase, "m": m, "k": k, "n": n,
                 "device_ms": device_ms(torch, codes_fn),
                 "fp32_operand_device_ms": device_ms(
                     torch, lambda: analog_mvm_split_cuda(a_pos, a_neg, w,
                                                          gain, off)),
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
            print(json.dumps(r), flush=True)
            rows.append(r)
        del codes, w

    def per_call(phase, key):
        sel = {r["layer"]: r[key] for r in rows if r["phase"] == phase}
        if any(v is None for v in sel.values()):
            return None
        return cfg.n_layers * sum(v for k, v in sel.items()
                                  if k != "lm_head") + sel["lm_head"]

    summary = {f"{phase}_{key}_per_call": per_call(phase, key)
               for phase in ("decode", "prefill")
               for key in ("device_ms", "fp32_operand_device_ms", "bound_ms")}
    summary["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(summary), flush=True)
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "bench_split.json").write_text(json.dumps(
        {"rows": rows, "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
