"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs[].file``), its traffic mix
(``bench/traffic/<traffic>.json``), its correctness limits
(``bench/limits/<cell>.json``) and the reader of each per-layer metric
(``bench/metrics/<metric>.py``, a function ``read(rec)``)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the manifest's metric entries this cell reports
    per_layer: list


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str, cells: list) -> bool:
    """Does ``cell`` report ``metric`` (its ``workloads``, else every
    cell)?"""
    return cell in metric.get("workloads", cells)


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    names = list(cells)
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in man["end_to_end"]
                    if reports(m, name, names)],
        per_layer=[m for m in man["per_layer"] if reports(m, name, names)],
    )


def reader(metric: str):
    """The ``read(rec)`` function of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
