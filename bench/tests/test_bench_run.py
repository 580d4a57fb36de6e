"""The command's refusals: no CUDA device, and a directory that holds
only BENCHMARK.json and ``bench/`` (no program)."""
import pathlib
import shutil
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
ARGS = ["--workload", "phi4-mini-3.8b.long_prompt", "--seed", "3",
        "--seconds", "1", "--trace", "0"]


def _run(root: pathlib.Path):
    return subprocess.run([sys.executable, str(root / "bench" / "run.py"),
                           *ARGS], capture_output=True, text=True,
                          timeout=300, cwd=root,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "No module named 'repro_torch'" in out.stderr
