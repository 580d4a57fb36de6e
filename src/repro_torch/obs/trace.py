"""Host-side tracing: nestable spans, point events and shared timing loops
(port of ``repro.obs.trace``; the JSONL records are the reference's).

- Spans and events measure *host* wall time around the device work:
  ``span``, ``event`` and ``clock_us`` read the host clock and never
  synchronize the device, so a span around an asynchronous launch times
  the launch, not the kernel.
- Recording is opt-in: ``span()`` / ``event()`` are no-ops (beyond two
  ``perf_counter`` calls) unless a collector opened by ``collect()`` is
  active, so instrumented library code costs ~nothing in normal runs.
- One timing implementation: ``timeit()`` is the best-of-blocks loop;
  it and ``time_block`` are the only functions here that wait for the
  device (every CUDA tensor of each call's result), exactly where the
  reference blocks until ready.

Span names compose into slash-separated paths ("serve.batch/serve.prefill")
reflecting nesting at record time.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

__all__ = [
    "Trace",
    "Span",
    "collect",
    "active_trace",
    "span",
    "event",
    "log",
    "clock_us",
    "timeit",
    "time_block",
]


def clock_us() -> float:
    """Monotonic clock in microseconds (host wall time)."""
    return time.perf_counter() * 1e6


@dataclass
class Span:
    """A single timed region.  ``dur_us`` is valid after the span closes."""

    name: str
    path: str
    t_us: float
    dur_us: float = 0.0
    meta: dict = field(default_factory=dict)

    def add(self, **meta: Any) -> "Span":
        """Attach metadata discovered while the span is open."""
        self.meta.update(meta)
        return self


class Trace:
    """An in-memory event log for one observed run."""

    def __init__(self, name: str = "trace") -> None:
        self.name = name
        self.t0_us = clock_us()
        self.events: list[dict] = []
        self._stack: list[str] = []

    # -- recording -----------------------------------------------------
    def record_span(self, sp: Span) -> None:
        self.events.append(
            {
                "rec": "span",
                "name": sp.name,
                "path": sp.path,
                "t_us": round(sp.t_us - self.t0_us, 3),
                "dur_us": round(sp.dur_us, 3),
                "meta": sp.meta,
            }
        )

    def record_event(self, name: str, meta: dict) -> None:
        path = "/".join(self._stack + [name]) if self._stack else name
        self.events.append(
            {
                "rec": "event",
                "name": name,
                "path": path,
                "t_us": round(clock_us() - self.t0_us, 3),
                "meta": meta,
            }
        )

    # -- queries (used by tests and report) ----------------------------
    def spans(self, name: Optional[str] = None) -> list[dict]:
        out = [e for e in self.events if e["rec"] == "span"]
        if name is not None:
            out = [e for e in out if e["name"] == name]
        return out

    def span_paths(self) -> set[str]:
        return {e["path"] for e in self.events if e["rec"] == "span"}

    def events_named(self, name: str) -> list[dict]:
        return [e for e in self.events if e["rec"] == "event" and e["name"] == name]

    # -- export --------------------------------------------------------
    def jsonl_records(self) -> list[dict]:
        head = {"rec": "trace", "name": self.name, "t0_us": round(self.t0_us, 3)}
        return [head] + list(self.events)

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.jsonl_records():
                f.write(json.dumps(rec) + "\n")


_ACTIVE: Optional[Trace] = None


def active_trace() -> Optional[Trace]:
    return _ACTIVE


@contextlib.contextmanager
def collect(name: str = "trace") -> Iterator[Trace]:
    """Open a collector: spans/events inside the block are recorded."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, Trace(name)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def begin(name: str = "trace") -> Trace:
    """Non-context-manager ``collect()`` for loops whose body
    cannot nest under a ``with`` (early ``sys.exit`` gates etc.); pair
    with :func:`end`."""
    global _ACTIVE
    tr = Trace(name)
    tr._prev = _ACTIVE
    _ACTIVE = tr
    return tr


def end(tr: Optional[Trace] = None) -> Optional[Trace]:
    """Close the collector opened by :func:`begin` and return it."""
    global _ACTIVE
    tr = tr or _ACTIVE
    if tr is None:
        return None
    _ACTIVE = getattr(tr, "_prev", None)
    return tr


@contextlib.contextmanager
def span(name: str, **meta: Any) -> Iterator[Span]:
    """Time a region.  Always yields a Span (so callers can read
    ``sp.dur_us`` or ``sp.add(...)``); records only when collecting."""
    tr = _ACTIVE
    if tr is not None:
        tr._stack.append(name)
        path = "/".join(tr._stack)
    else:
        path = name
    sp = Span(name=name, path=path, t_us=clock_us(), meta=dict(meta))
    try:
        yield sp
    finally:
        sp.dur_us = clock_us() - sp.t_us
        if tr is not None:
            tr._stack.pop()
            tr.record_span(sp)


def event(name: str, **meta: Any) -> None:
    """Record a point event (no duration) if a collector is active."""
    if _ACTIVE is not None:
        _ACTIVE.record_event(name, meta)


def log(msg: str, **meta: Any) -> None:
    """Print a progress line *and* record it as an event when collecting.

    The observability-sanctioned replacement for a bare ``print``.
    """
    print(msg, flush=True)  # verify: allow-bare-print
    if _ACTIVE is not None:
        _ACTIVE.record_event("log", {"msg": msg, **meta})


# ---------------------------------------------------------------------------
# Shared timing loops: the reference's shape (warmup, iters-per-block,
# best-of-blocks), so both packages time alike.
# ---------------------------------------------------------------------------


def _cuda_devices(x: Any, out: set) -> set:
    """The CUDA devices of every tensor in a nested result."""
    import torch

    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    return out


def _block_until_ready(x: Any) -> None:
    """Wait for the device work behind ``x``: synchronize the device of
    every CUDA tensor in it; nothing to wait for on the CPU."""
    import torch

    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)


def time_block(fn: Any, *args: Any, iters: int = 10, **kwargs: Any) -> float:
    """One timed block: mean µs/call over ``iters`` back-to-back calls,
    each blocked to completion (device-synchronous latency)."""
    t0 = time.perf_counter()  # verify: allow-raw-timer
    for _ in range(iters):
        _block_until_ready(fn(*args, **kwargs))
    t1 = time.perf_counter()  # verify: allow-raw-timer
    return (t1 - t0) / iters * 1e6


def timeit(
    fn: Any,
    *args: Any,
    iters: int = 10,
    warmup: int = 3,
    blocks: int = 4,
    label: Optional[str] = None,
    **kwargs: Any,
) -> float:
    """Best-of-blocks µs/call.  Warms up, then takes the fastest of
    ``blocks`` timed blocks of ``iters`` calls each — robust against
    scheduler noise, the canonical gate measurement.

    With ``label`` and an active collector, records a span named
    ``timeit:<label>`` whose metadata carries the measurement.
    """
    for _ in range(warmup):
        _block_until_ready(fn(*args, **kwargs))
    best = min(time_block(fn, *args, iters=iters, **kwargs) for _ in range(blocks))
    if label is not None and _ACTIVE is not None:
        _ACTIVE.record_event(
            "timeit", {"label": label, "us_per_call": round(best, 3), "iters": iters, "blocks": blocks}
        )
    return best
