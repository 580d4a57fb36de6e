"""``python -m repro_torch.verify``: the port's static verification gate.

Runs the AST lint over ``src/repro_torch`` and ``examples_torch`` and
the invariant sweep (every
SMOKE spec, the representative compiled plans, a placed fleet), printing
each finding as ``file:line: [rule] message`` / ``[rule] path: message``
and exiting 1 if anything fired.  The sweep compiles its plans on
``--device``: the CUDA device by default, ``--device cpu`` on a machine
without one.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="static plan/spec verifier + AST lint",
    )
    ap.add_argument("--root", default=".", help="repo root to lint")
    ap.add_argument("--lint-only", action="store_true",
                    help="skip the (slower) invariant sweep")
    ap.add_argument("--sweep-only", action="store_true",
                    help="skip the AST lint")
    ap.add_argument("--device", default=None,
                    help="device the sweep compiles its plans on "
                         "(default: the CUDA device)")
    args = ap.parse_args(argv)

    failed = False
    if not args.sweep_only:
        from repro_torch.verify.lint import run_lint

        findings = run_lint(args.root)
        for f in findings:
            print(f)
        print(f"lint: {len(findings)} finding(s)")
        failed |= bool(findings)
    if not args.lint_only:
        from repro_torch.verify.sweep import sweep

        diags = sweep(log=lambda m: print(f"  {m}"), device=args.device)
        for d in diags:
            print(d)
        print(f"invariant sweep: {len(diags)} diagnostic(s)")
        failed |= bool(diags)
    print("verify: FAIL" if failed else "verify: OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
