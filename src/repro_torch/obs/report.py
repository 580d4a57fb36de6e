"""Render an obs JSONL run (trace + metrics records) into tables.

A run file is newline-delimited JSON; every record carries a ``rec``
discriminator: ``trace`` (header), ``span``, ``event``, ``counter``,
``gauge``, ``histogram``.  ``python -m repro_torch.obs run.jsonl`` renders
it (port of ``repro.obs.report``: the same records and the same tables, so
either package renders a run the other dumped).
"""

from __future__ import annotations

import json
from typing import Iterable

from .metrics import Registry

__all__ = ["load", "render", "records_of", "dump_run", "required_missing"]


def load(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def records_of(tr, registry: Registry) -> list[dict]:
    """Combine one trace and one metrics registry into run records."""
    return list(tr.jsonl_records()) + registry.to_records()


def dump_run(path: str, tr, registry: Registry) -> None:
    with open(path, "w") as f:
        for rec in records_of(tr, registry):
            f.write(json.dumps(rec) + "\n")


def _fmt_us(v: float) -> str:
    if v >= 1e6:
        return f"{v / 1e6:.2f}s"
    if v >= 1e3:
        return f"{v / 1e3:.2f}ms"
    return f"{v:.1f}us"


def _table(rows: list[list[str]], header: list[str]) -> str:
    widths = [max(len(r[i]) for r in [header] + rows) for i in range(len(header))]
    line = lambda r: "  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
    return "\n".join([line(header), line(["-" * w for w in widths])] + [line(r) for r in rows])


def render(records: Iterable[dict]) -> str:
    records = list(records)
    out: list[str] = []

    heads = [r for r in records if r.get("rec") == "trace"]
    if heads:
        out.append(f"run: {heads[0].get('name', 'trace')}")

    # spans, aggregated by path
    spans: dict[str, list[float]] = {}
    for r in records:
        if r.get("rec") == "span":
            spans.setdefault(r["path"], []).append(r["dur_us"])
    if spans:
        rows = []
        for path in sorted(spans):
            durs = sorted(spans[path])
            n = len(durs)
            rows.append([
                path, str(n), _fmt_us(sum(durs) / n),
                _fmt_us(durs[n // 2]), _fmt_us(durs[-1]), _fmt_us(sum(durs)),
            ])
        out.append("\nspans (aggregated by path):")
        out.append(_table(rows, ["path", "count", "mean", "p50", "max", "total"]))

    events = [r for r in records if r.get("rec") == "event"]
    if events:
        rows = [[_fmt_us(r.get("t_us", 0.0)), r["name"],
                 json.dumps(r.get("meta", {}), sort_keys=True)[:100]]
                for r in events]
        out.append("\nevents:")
        out.append(_table(rows, ["t", "name", "meta"]))

    counters = [r for r in records if r.get("rec") == "counter"]
    if counters:
        rows = [[r["name"], str(r["value"])] for r in sorted(counters, key=lambda r: r["name"])]
        out.append("\ncounters:")
        out.append(_table(rows, ["name", "value"]))

    gauges = [r for r in records if r.get("rec") == "gauge"]
    if gauges:
        rows = [[r["name"], f"{r['value']:.3f}"] for r in sorted(gauges, key=lambda r: r["name"])]
        out.append("\ngauges:")
        out.append(_table(rows, ["name", "value"]))

    hists = [r for r in records if r.get("rec") == "histogram"]
    if hists:
        rows = []
        for r in sorted(hists, key=lambda r: r["name"]):
            s = r.get("summary", {})
            # _us-suffixed histograms hold microseconds; others are raw
            fmt = _fmt_us if r["name"].endswith("_us") else (lambda v: f"{v:.3f}")
            rows.append([
                r["name"], str(s.get("count", 0)),
                fmt(s.get("mean", 0.0)), fmt(s.get("p50", 0.0)),
                fmt(s.get("p95", 0.0)), fmt(s.get("p99", 0.0)),
                fmt(s.get("max", 0.0)),
            ])
        out.append("\nhistograms:")
        out.append(_table(rows, ["name", "count", "mean", "p50", "p95", "p99", "max"]))

    return "\n".join(out) if out else "(empty run)"


def required_missing(records: Iterable[dict], *, span_paths: Iterable[str] = (),
                     events: Iterable[str] = (), counters: Iterable[str] = (),
                     histograms: Iterable[str] = ()) -> list[str]:
    """Names required by a gate but absent from the run (empty = pass)."""
    records = list(records)
    have_spans = {r["path"] for r in records if r.get("rec") == "span"}
    have_events = {r["name"] for r in records if r.get("rec") == "event"}
    have_counters = {r["name"] for r in records if r.get("rec") == "counter"}
    have_hists = {r["name"] for r in records
                  if r.get("rec") == "histogram" and r.get("summary", {}).get("count", 0) > 0}
    missing = []
    missing += [f"span:{s}" for s in span_paths if s not in have_spans]
    missing += [f"event:{e}" for e in events if e not in have_events]
    missing += [f"counter:{c}" for c in counters if c not in have_counters]
    missing += [f"histogram:{h}" for h in histograms if h not in have_hists]
    return missing
