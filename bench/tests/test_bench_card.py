"""On the card, at each cell's own size: the program's readings within
the cell's limits and the TF32 control's beyond one of them
(``bench/control.py`` reads more seeds).  Skips without a CUDA device."""
import pathlib
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from harness import control, manifest  # noqa: E402

CELLS = [w["name"] for w in manifest.load_manifest(ROOT)["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run only on the card")


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(card, name):
    cell = manifest.load_cell(name, ROOT)
    got = control.readings(cell, 2**31 + 7, "cuda")
    limits = cell.limits["limits"]
    assert all(got["sound"][k] <= v for k, v in limits.items()), got
    assert any(got["control"][k] > v for k, v in limits.items()), got
