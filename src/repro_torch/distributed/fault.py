"""Fault-tolerance and elasticity utilities for the training launcher (a
copy of ``repro.distributed.fault``: plain Python and numpy).

On a real multi-pod deployment these wrap the process groups; the
mechanisms themselves (heartbeats, bounded retry with rollback to the
last checkpoint, straggler detection, elastic re-mesh) are host-side
Python and fully testable on one process.

Components:
- ``Heartbeat``      - liveness file per worker + stale-peer detection
                       (training workers; CHIP liveness goes through the
                       probe path below)
- ``RetryPolicy``    - bounded exponential backoff, resume-from-checkpoint
- ``StragglerClock`` - per-step timing stats; flags workers/steps slower
                       than ``k x median`` (mitigation: skip-and-rebalance)
- ``elastic_mesh_shape`` - recompute the device mesh when the healthy
                       chip set changes; ALWAYS a 3-tuple
                       ``(pods, data_per_pod, model_parallel)``; batch is
                       re-sharded by the stateless data pipeline
                       (repro_torch.data.lm_data indexes by step).
- ``healthy_chips`` / ``fleet_mesh_shape`` - fleet-side liveness: chip
                       health is decided by the measurement-only probe of
                       :class:`repro_torch.fleet.FleetMonitor` (a dead chip
                       rails its readout; no file heartbeats on-chip),
                       then fed into the same elastic mesh math.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Callable, Optional

import numpy as np


class Heartbeat:
    def __init__(self, directory: str, worker: int, timeout_s: float = 60.0):
        self.dir = directory
        self.worker = worker
        self.timeout_s = timeout_s
        os.makedirs(directory, exist_ok=True)

    def _path(self, worker: int) -> str:
        return os.path.join(self.dir, f"hb-{worker:05d}.json")

    def beat(self, step: int) -> None:
        tmp = self._path(self.worker) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time()}, f)
        os.replace(tmp, self._path(self.worker))

    def alive_workers(self, now: Optional[float] = None) -> list[int]:
        now = time.time() if now is None else now
        out = []
        for name in os.listdir(self.dir):
            if not name.startswith("hb-"):
                continue
            try:
                with open(os.path.join(self.dir, name)) as f:
                    hb = json.load(f)
                if now - hb["time"] <= self.timeout_s:
                    out.append(int(name[3:8]))
            except (OSError, json.JSONDecodeError, ValueError):
                continue
        return sorted(out)


@dataclasses.dataclass
class RetryPolicy:
    max_retries: int = 3
    backoff_s: float = 1.0
    backoff_factor: float = 2.0

    def run(self, step_fn: Callable, on_failure: Callable = None):
        """Run ``step_fn`` with bounded retries; ``on_failure(attempt, exc)``
        is the rollback hook (restore checkpoint / rebuild state)."""
        delay = self.backoff_s
        last_exc = None
        for attempt in range(self.max_retries + 1):
            try:
                return step_fn()
            except Exception as exc:  # noqa: BLE001 - deliberate catch-all
                last_exc = exc
                if attempt == self.max_retries:
                    break
                if on_failure is not None:
                    on_failure(attempt, exc)
                time.sleep(min(delay, 0.05))  # fast in tests
                delay *= self.backoff_factor
        raise RuntimeError(
            f"step failed after {self.max_retries + 1} attempts"
        ) from last_exc


class StragglerClock:
    """Rolling per-step wall-time stats; flags stragglers at k x median."""

    def __init__(self, window: int = 50, threshold: float = 3.0):
        self.times: deque = deque(maxlen=window)
        self.threshold = threshold

    def record(self, seconds: float) -> bool:
        """Record a step time; True if this step was a straggler."""
        is_straggler = False
        if len(self.times) >= 5:
            med = float(np.median(self.times))
            is_straggler = seconds > self.threshold * med
        self.times.append(seconds)
        return is_straggler

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


def elastic_mesh_shape(n_healthy_chips: int, model_parallel: int = 16,
                       pod_size: int = 256) -> tuple[int, int, int]:
    """Largest mesh that fits the healthy chip set while preserving the
    model-parallel degree (params resharding is free along pure-DP axes;
    the data pipeline is stateless in step, so scaling the data axis only
    changes per-shard batch slices).

    ONE shape contract: always ``(pods, data_per_pod, model_parallel)``.
    A fleet too small (or too ragged) to split across pods collapses to
    ``pods == 1`` with every data replica in it - callers squeeze the pod
    axis themselves if their mesh is flat."""
    chips = (n_healthy_chips // model_parallel) * model_parallel
    if chips == 0:
        raise ValueError("not enough healthy chips for one model replica")
    data = chips // model_parallel
    pods = max(1, chips // pod_size)
    if pods > 1 and data % pods == 0:
        return (pods, data // pods, model_parallel)
    return (1, data, model_parallel)


def healthy_chips(monitor) -> list[int]:
    """Live chip ids of a fleet, decided by the probe path: one vmapped
    zero-input measurement (``FleetMonitor.probe_lsb``) against the
    calibrated offsets, chips under the dead threshold are healthy.  File
    heartbeats stay for training WORKERS; chips have no filesystem, so
    their liveness is measurement-only."""
    lsb = monitor.probe_lsb()
    return [
        i for i, v in enumerate(lsb)
        if float(v) <= monitor.dead_threshold_lsb
    ]


def fleet_mesh_shape(monitor, *, model_parallel: int = 16,
                     pod_size: int = 256) -> tuple[int, int, int]:
    """Probe a fleet and return the elastic mesh over its healthy chips:
    ``elastic_mesh_shape(len(healthy_chips(monitor)), ...)``."""
    return elastic_mesh_shape(
        len(healthy_chips(monitor)),
        model_parallel=model_parallel, pod_size=pod_size,
    )
