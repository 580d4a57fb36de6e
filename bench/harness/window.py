"""The measured window and its end-to-end metrics.

The window is a closed loop: one group of requests is handed to the
engine as soon as the last has returned, and a new group starts only
while the time so far plus the mean group time so far stays within the
window's seconds; the window ends when the last group returns.  Each
group's record holds host-clock microseconds: ``handoff_us`` (handed to
the engine), ``prefill_end_us`` (the end of its ``serve.prefill`` span,
after the host read of the first sampled tokens), ``return_us``, and its
``prompt_lens`` and ``new_tokens`` (real tokens: no padding).
"""
from __future__ import annotations

import statistics
import time
from typing import Callable


def closed_loop(serve: Callable, seconds: float,
                clock: Callable = time.perf_counter) -> tuple:
    """Run ``serve(i)`` for groups ``i = 0, 1, ...`` under the window's
    rule; returns (records, window seconds)."""
    records = []
    t0 = clock()
    while True:
        records.append(serve(len(records)))
        elapsed = clock() - t0
        if elapsed + elapsed / len(records) > seconds:
            return records, elapsed


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (linear between order statistics)."""
    vals = sorted(values)
    if len(vals) == 1:
        return vals[0]
    return statistics.quantiles(vals, n=100, method="inclusive")[int(q) - 1]


def ttft_ms(groups) -> list:
    """Each request's time to first token: its group's hand-off to the
    end of the group's prefill span."""
    return [(g["prefill_end_us"] - g["handoff_us"]) / 1e3
            for g in groups for _ in g["prompt_lens"]]


def end_to_end(groups, window_s: float) -> dict:
    """Every end-to-end metric the harness knows, over all the window's
    groups and all its time."""
    prompt = sum(sum(g["prompt_lens"]) for g in groups)
    generated = sum(sum(g["new_tokens"]) for g in groups)
    return {
        "tokens_per_s": (prompt + generated) / window_s,
        "ttft_p90_ms": percentile(ttft_ms(groups), 90),
    }


def split(groups, window_s: float) -> dict:
    """Where the window's seconds went: the prefill spans, the rest of
    each group (its decode steps, host-paced at a small batch), and
    between groups (the harness)."""
    prefill = sum(g["prefill_us"] for g in groups) / 1e6
    served = sum(g["return_us"] - g["handoff_us"] for g in groups) / 1e6
    return {"prefill_s": prefill, "after_prefill_s": served - prefill,
            "between_s": window_s - served}


def capture_s(groups) -> float | None:
    """The window seconds that the check's capture cost: each sampled
    group's time less the median of the unsampled groups of its slot (the
    same prompt lengths), summed; None where a slot has no unsampled
    group."""
    def took(g):
        return (g["return_us"] - g["handoff_us"]) / 1e6

    total = 0.0
    for g in (g for g in groups if g["sampled"]):
        alike = [took(o) for o in groups
                 if o["slot"] == g["slot"] and not o["sampled"]
                 and not o["profiled"]]
        if not alike:
            return None
        total += took(g) - statistics.median(alike)
    return total
