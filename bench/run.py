"""Benchmark of ``repro_torch``'s ``ServeEngine`` on one NVIDIA H100.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` once, from the root of a checkout,
and prints one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``check``: each
number that decided ``correct`` beside its limit (also the last lines of
standard error).  Exits non-zero, printing no result, when there is no
CUDA device, when a file of the benchmark or the program is missing, or
when the process holds JAX or the JAX package once the window has
closed.  The kernels are built into ``build/kernels/`` of the checkout
by the first run there.
"""
import time

T_START = time.monotonic()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _fail(msg: str) -> int:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    args = _args(argv)
    # every cache of the program at a fixed path inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    from harness import manifest

    cell = manifest.load_cell(args.workload, ROOT)
    import repro_torch
    import torch

    where = pathlib.Path(repro_torch.__file__).resolve()
    if ROOT / "src" not in where.parents:
        return _fail(f"repro_torch imported from {where}, not the checkout")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{cell.name} needs {cell.chips} CUDA devices, "
                     f"{torch.cuda.device_count()} found")
    torch.set_num_threads(4)
    from harness import cell as cell_lib
    from harness import result

    out = cell_lib.run(cell, args.seed, args.seconds, bool(args.trace),
                       device="cuda", t_start=T_START)
    line, lines = result.assemble(cell, out, bool(args.trace),
                                  torch.cuda.get_device_name(0))
    found = cell_lib.banned_modules()
    if found:
        return _fail(f"the process holds {', '.join(found)}")
    for text in lines:
        print(text, file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
