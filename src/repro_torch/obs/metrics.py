"""Process-local metrics: counters, gauges and histograms with JSONL export
(port of ``repro.obs.metrics``; the records are the reference's, field for
field, so a run dumped by either package loads into the other).

The registry is module-level state - like
``exec.run.dispatch_count`` it is a host-side observer that the device
work never reads.  Call sites must look instruments up per call
(``metrics.counter("x").inc()``), never cache the object: ``reset_metrics()``
replaces the registry contents and a cached handle would go stale.

Histograms keep raw samples (bounded) so percentiles are exact and JSONL
round-trips losslessly.
"""

from __future__ import annotations

import json
import math
from typing import Iterable, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "registry",
    "counter",
    "gauge",
    "histogram",
    "reset_metrics",
    "export_jsonl",
    "import_jsonl",
]

_MAX_SAMPLES = 65536


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str, value: int = 0) -> None:
        self.name = name
        self.value = value

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_record(self) -> dict:
        return {"rec": "counter", "name": self.name, "value": self.value}


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str, value: float = 0.0) -> None:
        self.name = name
        self.value = value

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_record(self) -> dict:
        return {"rec": "gauge", "name": self.name, "value": self.value}


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile on pre-sorted values."""
    if not sorted_vals:
        return 0.0
    n = len(sorted_vals)
    k = max(0, min(n - 1, math.ceil(q / 100.0 * n) - 1))
    return sorted_vals[k]


class Histogram:
    __slots__ = ("name", "samples", "dropped")

    def __init__(self, name: str, samples: Optional[Iterable[float]] = None) -> None:
        self.name = name
        self.samples: list[float] = list(samples) if samples is not None else []
        self.dropped = 0

    def record(self, v: float) -> None:
        if len(self.samples) < _MAX_SAMPLES:
            self.samples.append(float(v))
        else:
            self.dropped += 1

    @property
    def count(self) -> int:
        return len(self.samples) + self.dropped

    def summary(self) -> dict:
        s = sorted(self.samples)
        n = len(s)
        return {
            "count": self.count,
            "mean": (sum(s) / n) if n else 0.0,
            "min": s[0] if n else 0.0,
            "max": s[-1] if n else 0.0,
            "p50": _percentile(s, 50),
            "p95": _percentile(s, 95),
            "p99": _percentile(s, 99),
        }

    def to_record(self) -> dict:
        return {
            "rec": "histogram",
            "name": self.name,
            "samples": [round(v, 3) for v in self.samples],
            "summary": {k: round(v, 3) for k, v in self.summary().items()},
        }


class Registry:
    def __init__(self) -> None:
        self._instruments: dict[str, object] = {}

    def _get(self, name: str, cls: type) -> object:
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as {type(inst).__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)  # type: ignore[return-value]

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)  # type: ignore[return-value]

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)  # type: ignore[return-value]

    def names(self) -> list[str]:
        return sorted(self._instruments)

    def get(self, name: str) -> Optional[object]:
        return self._instruments.get(name)

    def reset(self) -> None:
        self._instruments.clear()

    def to_records(self) -> list[dict]:
        return [self._instruments[k].to_record() for k in sorted(self._instruments)]  # type: ignore[attr-defined]

    def load_records(self, records: Iterable[dict]) -> None:
        for rec in records:
            kind = rec.get("rec")
            if kind == "counter":
                self.counter(rec["name"]).value = int(rec["value"])
            elif kind == "gauge":
                self.gauge(rec["name"]).value = float(rec["value"])
            elif kind == "histogram":
                self._instruments[rec["name"]] = Histogram(rec["name"], rec.get("samples", []))


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return _REGISTRY.histogram(name)


def reset_metrics() -> None:
    _REGISTRY.reset()


def export_jsonl(path: str, extra_records: Optional[Iterable[dict]] = None) -> None:
    """Write metric records (and optionally trace records) as JSONL."""
    with open(path, "w") as f:
        if extra_records is not None:
            for rec in extra_records:
                f.write(json.dumps(rec) + "\n")
        for rec in _REGISTRY.to_records():
            f.write(json.dumps(rec) + "\n")


def import_jsonl(path: str) -> Registry:
    """Load metric records from a JSONL file into a fresh Registry."""
    reg = Registry()
    with open(path) as f:
        reg.load_records(json.loads(line) for line in f if line.strip())
    return reg
