"""BENCHMARK.json against the rules of its format (keys, names, units,
bounds, what each cell reports), and every file it names present under
``bench/``."""
import json
import pathlib
import re
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from harness import manifest  # noqa: E402

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"]
    assert MAN["command"] == ["python3", "bench/run.py"]


def test_names_and_units():
    names = [c["name"] for c in MAN["configs"]] + CELLS + [
        m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_entries_have_just_their_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for cell in CELLS:
        mine = [m for m in e2e.values() if manifest.reports(m, cell, CELLS)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(manifest.reports(m, cell, CELLS) for m in MAN["per_layer"])
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert manifest.reports(e2e[m["moves"]], cell, CELLS), (m, cell)


def test_files_found_by_name():
    for c in MAN["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("bench/configs/")
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
    for cell in CELLS:
        loaded = manifest.load_cell(cell, ROOT)
        assert loaded.limits["limits"] and loaded.traffic["batch"] > 0
    for m in MAN["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = MAN["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**33 + 1])
@pytest.mark.parametrize("name", CELLS)
def test_the_check_samples_no_traced_group(name, seed):
    from harness import check

    cell = manifest.load_cell(name, ROOT)
    traced = check.traced_groups(cell.traffic)
    got = check.sample(cell.limits, seed, traced)
    assert got[0] == 0 and len(set(got)) == cell.limits["check_groups"]
    assert not set(got) & set(traced)
    assert max(got) < cell.limits["among_first"]
    assert got == check.sample(cell.limits, seed, traced)
