"""The trace's reduction on synthetic records: device busy time as the
union of activities, the split kernel's time and records, the top
kernels, and idle gaps named by the host range open where they start."""
import pathlib
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import profile  # noqa: E402

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, start, dur, dev=CUDA):
        self._n, self._s, self._d, self._dev = name, start, dur, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


EVENTS = [Event("void split_kernel<0, 6>(Params)", 1000, 400),
          Event("elementwise", 1300, 300),          # overlaps the first
          Event("void split_kernel<0, 1>(Params)", 2000, 100),
          Event("Memcpy DtoH", 5000, 50),
          Event("cudaLaunchKernel", 900, 5, CPU)]
END = 10**5      # the stretch's end: later records are the tail
HOST = [(800, 2050, "prefill step"), (600, 5020, "engine between steps")]


def test_busy_split_and_kernels():
    got = profile.reduce(EVENTS, 1e-5, HOST, END)
    assert got["busy_s"] == pytest.approx((600 + 100 + 50) / 1e9)
    assert got["activities"] == 4
    assert got["split_s"] == pytest.approx(500 / 1e9)
    assert got["split_records"] == profile.split_records(EVENTS, END) == 2
    assert got["device_ops"][0] == ["void split_kernel<0, 6>(Params)",
                                    pytest.approx(400 / 1e9)]


def test_gaps_named_by_the_innermost_host_range():
    got = profile.reduce(EVENTS, 1e-5, HOST, END)
    assert got["idle_gaps"] == [
        ["engine between steps: all 1 gaps", pytest.approx(2900 / 1e9)],
        ["prefill step: all 1 gaps", pytest.approx(400 / 1e9)],
        ["engine between steps: one gap", pytest.approx(2900 / 1e9)],
        ["prefill step: one gap", pytest.approx(400 / 1e9)]]
    far = profile.reduce(EVENTS + [Event("late", 9000, 10),
                                   Event("tail", 10**6, 10)], 1e-5, HOST, END)
    assert ["between groups: all 1 gaps",
            pytest.approx(3950 / 1e9)] in far["idle_gaps"]
    assert len(far["idle_gaps"]) <= 10
