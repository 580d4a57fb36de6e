"""The traced run's device trace: ``torch.profiler`` over a fixed stretch
of the window, read from the raw trace records (summing durations, not
``key_averages()``, which takes tens of seconds over 10^5 records).

Only device activity is traced (recording every host operation as well
slowed a decode step by more than half).  The harness notes its own host
ranges instead (a group, a prefill step, a decode step) on the clock the
trace's records use (``time.time_ns``); an idle gap of the device is
named after the innermost range open where it starts, and the breakdown
gives each name's total idle time, then the longest single gaps.
"""
from __future__ import annotations

import time

import torch

SPLIT_KERNEL = "split_kernel"
TOP = 10
TAIL = 64        # tiny launches after a stretch, as the trace's last records


class DeviceTrace:
    """One profiled stretch: :meth:`start`, the work, :meth:`stop`."""

    def __init__(self):
        self.prof = None
        self.t0 = 0.0
        self.window_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> list:
        """End the stretch; returns its raw records.  A trace can lose a
        few records at its end, so a short tail of device work follows
        the stretch before the profiler stops; records that start after
        the stretch's end (``end_ns``) are left out when it is read."""
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.end_ns = time.time_ns()
        tail = torch.zeros(TAIL, device="cuda")
        for _ in range(TAIL):
            tail.add_(1.0)
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        events = list(self.prof.profiler.kineto_results.events())
        self.prof = None
        return events


def _device(events, end_ns: int):
    """``(start ns, end ns, name)`` of each device activity that starts
    before ``end_ns``: kernels, copies and fills."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        if e.device_type() == cuda and e.start_ns() < end_ns:
            yield e.start_ns(), e.start_ns() + e.duration_ns(), e.name()


def split_records(events, end_ns: int) -> int:
    """Records of the split kernel in a stretch's trace."""
    return sum(SPLIT_KERNEL in name for _, _, name in _device(events, end_ns))


def reduce(events, window_s: float, host: list, end_ns: int) -> dict:
    """Device time, activities, kernel sums and idle gaps, named by the
    ``host`` ranges ``(start ns, end ns, name)``, of one stretch that ended
    at ``end_ns``."""
    dev = sorted(_device(events, end_ns))
    kernels: dict = {}
    split_s, n_split = 0.0, 0
    busy_ns, gaps = 0, []
    cur_start = cur_end = None
    for s, t, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (t - s) / 1e9
        if SPLIT_KERNEL in name:
            split_s += (t - s) / 1e9
            n_split += 1
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy_ns += cur_end - cur_start
                gaps.append((cur_end, s))
            cur_start, cur_end = s, t
        else:
            cur_end = max(cur_end, t)
    if cur_end is not None:
        busy_ns += cur_end - cur_start
    named = sorted(((_what(host, g0), (g1 - g0) / 1e9) for g0, g1 in gaps),
                   key=lambda x: -x[1])
    totals: dict = {}
    for name, s in named:
        n, t = totals.get(name, (0, 0.0))
        totals[name] = (n + 1, t + s)
    idle = [[f"{name}: all {n} gaps", t] for name, (n, t) in
            sorted(totals.items(), key=lambda x: -x[1][1])]
    idle += [[f"{name}: one gap", s] for name, s in named[:TOP - len(idle)]]
    top_ops = sorted(kernels.items(), key=lambda x: -x[1])
    return {
        "window_s": window_s,
        "busy_s": busy_ns / 1e9,
        "activities": len(dev),
        "split_s": split_s,
        "split_records": n_split,
        "device_ops": [[n[:120], s] for n, s in top_ops[:TOP]],
        "idle_gaps": idle,
    }


def _what(host, t_ns: int) -> str:
    """The innermost harness range open at ``t_ns``."""
    best = None
    for s, t, name in host:
        if s <= t_ns < t and (best is None or s >= best[0]):
            best = (s, name)
    return "between groups" if best is None else best[1]
