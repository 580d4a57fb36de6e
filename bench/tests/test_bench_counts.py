"""The split kernel's and the model's work at phi4-mini's shapes against
counts by hand."""
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import counts  # noqa: E402

PHI4 = {"n_layers": 32, "d_model": 3072, "n_heads": 24, "n_kv_heads": 8,
        "hd": 128, "d_ff": 8192, "vocab": 200064}


def test_split_launches_of_one_call():
    got = counts.split_launches(PHI4, 4)
    assert len(got) == 5 * 32 + 1
    assert got[0] == (4, 3072, 3072 + 2 * 1024, 4 * (5120 + 3 * 3072))
    assert got[4] == (4, 8192, 3072, 4 * (3072 + 8192))
    assert got[-1] == (4, 3072, 200064, 4 * (200064 + 3072))


@pytest.mark.parametrize("m", [4, 128, 3200])
def test_split_work_of_the_lm_head(m):
    k, n = 3072, 200064
    nbytes, ops = counts.split_work(m, k, n, 4 * (n + k))
    hand = (4 * 2 * m * k + 4 * n + 4 * 24 * n + 4 * m * n + k * n
            + 4 * (n + k))
    assert nbytes == hand and ops == 4 * m * k * n
    bound = counts.bound_s(nbytes, ops)
    assert bound == max(hand / 3.35e12, 4 * m * k * n / 989e12)


def test_prefill_flops_by_hand():
    n = 700
    layer = 2 * (3072 * 5120 + 3072 * 3072 + 3 * 3072 * 8192)
    attn = 4 * 3072 * n * (n + 1) // 2
    want = 32 * (n * layer + attn) + 2 * 3072 * 200064
    assert counts.prefill_flops(PHI4, [n]) == want
    assert counts.prefill_flops(PHI4, [n, n]) == 2 * want

