"""Read the control of ``correct`` on the card at a cell's own size:

    python3 bench/control.py --workload <cell> --seeds 11,12,13 [--out f.jsonl]

For each seed, the program's readings and the TF32 control's
(``harness/control.py``), one JSON line each."""
import argparse
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    ap.add_argument("--lows", default="tf32,fp64",
                    help="the reference's lower precisions to read: tf32 "
                         "(the control), fp64 (the witness)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from harness import control, manifest

    cell = manifest.load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        got = control.readings(cell, seed, "cuda",
                               lows=tuple(args.lows.split(",")))
        got["workload"] = cell.name
        text = json.dumps(got)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
