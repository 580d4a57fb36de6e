"""The import guard: nothing under ``bench/`` imports JAX, the JAX package
``repro`` or ``benchmarks/``; the reference imports nothing of the
program or the harness; a run's modules pull in none of them either."""
import ast
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
REFERENCE_MAY = {"__future__", "contextlib", "dataclasses", "math", "typing",
                 "torch"}


def imported(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not imported(f) & BANNED, f


def test_the_reference_imports_torch_alone():
    for f in sorted((BENCH / "reference").glob("*.py")):
        assert imported(f) <= REFERENCE_MAY, (f, imported(f))


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness.cell, harness.control, harness.result\n"
        "import repro_torch.serve.engine, repro_torch.kernels._build\n"
        "import harness.readers, reference.lm\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
    ) % (str(BENCH), str(ROOT / "src"), BANNED)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
