"""The window's arithmetic on synthetic records: the closed loop's rule,
rates over the whole window, the 90th percentile over all requests."""
import pathlib
import statistics
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import window  # noqa: E402


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("group_s,seconds,groups", [
    (1.0, 10.0, 10), (3.0, 10.0, 3), (14.0, 10.0, 1), (0.5, 10.0, 20)])
def test_closed_loop_stops_before_overrunning(group_s, seconds, groups):
    clock = Clock()

    def serve(i):
        clock.t += group_s
        return i

    recs, elapsed = window.closed_loop(serve, seconds, clock)
    assert recs == list(range(groups))
    assert elapsed == pytest.approx(groups * group_s)


def _group(handoff, ttft_ms, lens, new):
    return {"handoff_us": handoff, "prefill_end_us": handoff + ttft_ms * 1e3,
            "prompt_lens": lens, "new_tokens": new}


def test_rates_over_the_whole_window():
    groups = [_group(0, 100, [300, 500], [4, 4]),
              _group(2e5, 300, [1000, 200], [4, 3])]
    got = window.end_to_end(groups, window_s=2.0)
    assert got["tokens_per_s"] == pytest.approx((2000 + 15) / 2.0)


def test_p90_over_all_requests():
    groups = [_group(i * 1e6, 10.0 * (i + 1), [100] * 4, [4] * 4)
              for i in range(25)]
    ttft = window.ttft_ms(groups)
    assert len(ttft) == 100
    want = statistics.quantiles(ttft, n=100, method="inclusive")[89]
    assert window.end_to_end(groups, 1.0)["ttft_p90_ms"] == pytest.approx(
        want)
    assert 220.0 <= want <= 230.0
    assert window.percentile([5.0], 90) == 5.0


def test_where_the_window_went_and_the_capture_cost():
    def g(handoff_s, prefill_s, took_s, slot, sampled):
        return {"handoff_us": handoff_s * 1e6, "prefill_us": prefill_s * 1e6,
                "return_us": (handoff_s + took_s) * 1e6, "slot": slot,
                "sampled": sampled, "profiled": False}
    groups = [g(0.0, 0.8, 1.3, 0, True), g(1.3, 0.5, 0.9, 1, False),
              g(2.2, 0.8, 1.1, 0, False), g(3.3, 0.5, 0.8, 1, True),
              g(4.1, 0.8, 1.2, 0, False)]
    got = window.split(groups, 5.5)
    assert got["prefill_s"] == pytest.approx(3.4)
    assert got["after_prefill_s"] == pytest.approx(5.3 - 3.4)
    assert got["between_s"] == pytest.approx(0.2)
    # group 0 against the median of slot 0's others (1.15), group 3
    # against slot 1's one other (0.9)
    assert window.capture_s(groups) == pytest.approx(0.15 - 0.1)
    assert window.capture_s(groups[:2]) is None
