#!/usr/bin/env python3
"""Fit the depth each LM family trains at, at its published widths, on
one GPU: one ``make_train_step`` step at 1 x the family's trained
sequence (``chip_smoke.py``'s phase 40 step, :func:`chip_smoke.
train_family`) on the model cut to two depths (one and two scan groups,
or the depths given), then a line through the two peaks and the two step
times: GiB and host seconds per layer, the rest fixed, and the most
layers whose peak stays under ``chip_smoke.PEAK_BUDGET_GIB``, with the
step time extrapolated to that depth.  The line holds only where one
phase of the step holds the peak at both depths (the backward's end at
small depth, the lowering at large): fit near the depth the line gives.
``chip_smoke.TRAINED_LAYERS`` is set from its output.

    python3 scripts/fit_train_depth.py [family[:depth,depth] ...]

Prints one JSON line per family and writes them all to
``chiprun_out/fit_train_depth.json``.  Needs the CUDA device.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
argv, sys.argv = sys.argv[1:], sys.argv[:1]

import chip_smoke as C  # noqa: E402


def fit(name: str, depths=None) -> dict:
    cfg = C.configs.get_arch(name)
    group = len(C.T.group_def(cfg))
    seq = C.TRAINED_SEQ.get(name, C.TRAIN_FAMILY_SEQ)
    points = []
    for n in depths or (group, 2 * group):
        rep, bad = C.train_family(name, n, seq, steps=1, profile=False)
        points.append((n, rep["peak_memory_gib"],
                       rep["steps"][0]["host_ms"] / 1e3, bad))
    (n1, p1, t1, _), (n2, p2, t2, _) = points
    per_layer = (p2 - p1) / (n2 - n1)
    fixed = p1 - per_layer * n1
    most = int((C.PEAK_BUDGET_GIB - fixed) / per_layer) // group * group
    most = max(group, min(most, cfg.n_layers))
    s_per_layer = (t2 - t1) / (n2 - n1)
    return {"arch": name, "seq": seq,
            "points": [{"layers": n, "peak_gib": p, "step_s": t,
                        "problems": bad} for n, p, t, bad in points],
            "gib_per_layer": per_layer, "gib_fixed": fixed,
            "budget_gib": C.PEAK_BUDGET_GIB, "most_layers": most,
            "predicted_peak_gib": fixed + per_layer * most,
            "step_s_per_layer": s_per_layer,
            "predicted_step_s": t1 + s_per_layer * (most - n1),
            "card": C.card_line()}


def main() -> None:
    out = []
    for arg in argv or list(C.TRAIN_FAMILIES):
        name, _, depths = arg.partition(":")
        r = fit(name, [int(n) for n in depths.split(",")] if depths
                else None)
        print(json.dumps(r), flush=True)
        out.append(r)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "fit_train_depth.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
