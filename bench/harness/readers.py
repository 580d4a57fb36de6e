"""What the per-layer metrics read from a run's records (``rec``, built by
:func:`harness.cell.run`): the window's groups with their spans, the
traced stretch's reduction, the peak memory.  Each ``bench/metrics/
<metric>.py`` calls one of these; a reader that finds nothing to read
returns None and the metric is left out of the line.  Latencies leave out
the groups that ran under the profiler."""
from __future__ import annotations

import statistics

from harness import counts


def _unprofiled_prefills(rec):
    return [g for g in rec["groups"] if not g["profiled"]]


def compile_s(rec):
    return rec["compile_s"]


def prefill_ms(rec):
    us = [g["prefill_us"] for g in _unprofiled_prefills(rec)]
    return statistics.median(us) / 1e3 if us else None


def split_roofline(rec):
    """Percent: the split launches' summed bound over their summed device
    time in the traced stretch."""
    tr = rec["trace"]
    if tr is None or not tr["split_s"]:
        return None
    bound = sum(counts.split_bound_s(rec["arch"], m) for _, m in tr["calls"])
    return 100.0 * bound / tr["split_s"]


def mfu_prefill(rec):
    """Percent of the bf16 peak: model FLOPs of the window's prefills over
    their ``serve.prefill`` spans."""
    gs = _unprofiled_prefills(rec)
    if not gs:
        return None
    flops = sum(counts.prefill_flops(rec["arch"], g["prompt_lens"])
                for g in gs)
    seconds = sum(g["prefill_us"] for g in gs) / 1e6
    return 100.0 * flops / seconds / counts.BF16_OPS_PER_S


def idle_share(rec):
    tr = rec["trace"]
    if tr is None or not tr["window_s"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]


def peak_gib(rec):
    return rec["peak_window_bytes"] / 2**30 or None
