"""The result line of a run: metrics by name with their units, the
device, the trace's breakdown, and the numbers that decided ``correct``
beside their limits."""
from __future__ import annotations

from harness import manifest
from harness import window as window_lib


def assemble(cell, out: dict, trace: bool, kind: str) -> tuple:
    """(the result object, the check's lines for standard error)."""
    rec, readings = out["rec"], out["readings"]
    groups = rec["groups"]
    oks = [ok for g in groups for ok in g["ok"]]
    failed = oks.count(False)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = manifest.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = window_lib.end_to_end(groups, rec["window_s"])
        e2e["setup_s"] = rec["setup_s"]
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = {name: {"value": readings[name], "limit": limit}
              for name, limit in cell.limits["limits"].items()}
    correct = (failed == 0 and readings["tokens"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    device = {"platform": "gpu", "kind": kind,
              "count": cell.chips, "memory_peak_bytes": out["peak_bytes"]}
    line = {"correct": correct, "attempted": len(oks), "failed": failed,
            "metrics": metrics, "device": device}
    if trace:
        tr = rec["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["check"] = checks
    where = window_lib.split(groups, rec["window_s"])
    cap = window_lib.capture_s(groups)
    lines = [f"window {rec['window_s']!r} s: " + ", ".join(
        f"{k} {v!r}" for k, v in where.items())
        + f"; the check's capture {cap!r} s"]
    lines += [f"checked {readings['groups']} groups, {readings['tokens']} "
             f"served tokens; widest gap {readings['gap']!r}, tokens off "
             f"{readings['tokens_off']!r}, layers {readings['stages']}"]
    lines += [f"check {name} {c['value']!r} limit {c['limit']!r}"
              for name, c in checks.items()]
    return line, lines
