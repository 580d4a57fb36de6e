"""CLI: render obs JSONL runs (port of ``python -m repro.obs``).

    python -m repro_torch.obs run.jsonl      # render a recorded run

The reference's ``--serve-smoke`` gate serves through the engine's
calibration, drift-monitor, plan-cache and fleet hooks; the port's
``ServeEngine`` does not have them yet (ROADMAP.md, queue 1), so the flag
exits non-zero with that message instead of reporting a contract it did
not check.
"""

from __future__ import annotations

import argparse
import sys

from . import report

SERVE_SMOKE_MISSING = (
    "--serve-smoke needs ServeEngine's calibration, drift_monitor, "
    "plan_cache and fleet hooks, which the port does not have yet "
    "(ROADMAP.md, queue 1); no telemetry contract was checked")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="render obs JSONL runs")
    ap.add_argument("jsonl", nargs="?", help="run file to render")
    ap.add_argument("--serve-smoke", metavar="OUT",
                    help="the instrumented serve gate (not ported yet)")
    args = ap.parse_args(argv)
    if args.serve_smoke:
        print(SERVE_SMOKE_MISSING, file=sys.stderr)
        return 2
    if not args.jsonl:
        ap.error("nothing to do: pass a JSONL file")
    print(report.render(report.load(args.jsonl)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
