"""The port's verify tools on the CPU: the AST lint's seven rules on
fixtures and over the port's tree, the lower-once detector
(``assert_no_retrace``), the captured-tensor detector
(``captured_constants``), the invariant sweep and the ``python -m
repro_torch.verify`` gate (mirroring ``TestRetrace`` and ``TestLint`` of
``tests/test_verify.py``).  Exact checks: findings are counted and named.
"""
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.analog import AnalogConfig, analog_linear_init  # noqa: E402
from repro_torch.core.noise import NOISELESS  # noqa: E402
from repro_torch.exec.lower import lower_stack  # noqa: E402
from repro_torch.exec.run import run  # noqa: E402
from repro_torch.verify import (VerifyError, assert_no_retrace,  # noqa: E402
                                captured_constants, run_lint)
from repro_torch.verify.__main__ import main as verify_main  # noqa: E402
from repro_torch.verify.lint import lint_source  # noqa: E402
from repro_torch.verify.sweep import (sweep, sweep_fleet,  # noqa: E402
                                      sweep_plans, sweep_specs)

REPO = pathlib.Path(__file__).resolve().parents[1]
ACFG = AnalogConfig(noise=NOISELESS, act_calib="static")
LIB = "src/repro_torch/models/foo.py"


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _layers():
    return [analog_linear_init(_gen(0), 32, 48, noise=NOISELESS,
                               device="cpu"),
            analog_linear_init(_gen(1), 48, 24, noise=NOISELESS,
                               device="cpu")]


def _rules(findings):
    return [f.rule for f in findings]


# ------------------------------------------------------------------- lint
class TestLint:
    def test_fpn_read_forbidden_outside_lower_and_calib(self):
        src = "def f(params):\n    return params['fpn']\n"
        assert _rules(lint_source(src, LIB)) == ["fpn-access"]
        assert lint_source(src, "src/repro_torch/exec/lower.py") == []
        assert lint_source(src, "src/repro_torch/calib/device.py") == []
        assert lint_source("def f(params, t):\n    params['fpn'] = t\n",
                           LIB) == []

    def test_fpn_get_and_suppression(self):
        src = "def f(params):\n    return params.get('fpn', {})\n"
        assert _rules(lint_source(src, LIB)) == ["fpn-access"]
        ok = ("def f(params):\n    return params.get('fpn', {})"
              "  # verify: allow-fpn-access\n")
        assert lint_source(ok, LIB) == []

    def test_deprecated_shim_call(self):
        src = "y = analog_linear_apply(p, x, cfg)\n"
        hits = lint_source(src, "src/repro_torch/serve/foo.py")
        assert _rules(hits) == ["deprecated-shim"]
        assert "apply_linear" in hits[0].message

    def test_numpy_in_triton_kernel_body(self):
        src = ("import numpy as np\n"
               "import triton\n"
               "import triton.language as tl\n"
               "@triton.jit\n"
               "def k(x_ptr, o_ptr):\n"
               "    tl.store(o_ptr, np.maximum(tl.load(x_ptr), 0))\n")
        hits = lint_source(src, "src/repro_torch/kernels/foo.py")
        assert _rules(hits) == ["numpy-in-kernel"]
        ok = src.replace("np.maximum(tl.load(x_ptr), 0)",
                         "tl.maximum(tl.load(x_ptr), 0)")
        assert lint_source(ok, "src/repro_torch/kernels/foo.py") == []
        bare = src.replace("import triton\n", "from triton import jit\n") \
            .replace("@triton.jit", "@jit")
        assert _rules(lint_source(bare, "src/repro_torch/kernels/foo.py")
                      ) == ["numpy-in-kernel"]
        host = "import numpy as np\ndef h(x):\n    return np.maximum(x, 0)\n"
        assert lint_source(host, "src/repro_torch/kernels/foo.py") == []

    def test_frozen_plan_dataclass(self):
        src = "import dataclasses\n@dataclasses.dataclass\nclass P:\n" \
              "    x: int\n"
        hits = lint_source(src, "src/repro_torch/exec/foo.py")
        assert _rules(hits) == ["frozen-plan-dataclass"]
        ok = src.replace("@dataclasses.dataclass",
                         "@dataclasses.dataclass(frozen=True)")
        assert lint_source(ok, "src/repro_torch/exec/foo.py") == []
        assert lint_source(src, LIB) == []       # not a plan module

    def test_packed_weights_rule(self):
        build = "s = WeightStore(codes=c, w_scale=w, gain=g)\n"
        assert _rules(lint_source(build, LIB)) == ["packed-weights"]
        for home in ("src/repro_torch/exec/lower.py",
                     "src/repro_torch/exec/plan.py",
                     "src/repro_torch/exec/store.py"):
            assert lint_source(build, home) == []
        hits = lint_source("lp = LayerPlan(w_eff=w, a_scale=a)\n", LIB)
        assert _rules(hits) == ["packed-weights"]
        assert "derived view" in hits[0].message
        assert lint_source("y = x @ lp.store.w_eff\n", LIB) == []

    def test_bare_print_and_raw_timer(self):
        src = "import time\nprint('x')\nt = time.perf_counter()\n"
        assert _rules(lint_source(src, LIB)) == ["bare-print", "raw-timer"]
        assert lint_source(src, "src/repro_torch/obs/report.py") == []
        assert _rules(lint_source(src, "src/repro_torch/verify/__main__.py")
                      ) == ["raw-timer"]
        assert lint_source(src, "scripts/foo.py") == []
        ok = "print('x')  # verify: allow-bare-print (the CLI's report)\n"
        assert lint_source(ok, LIB) == []

    def test_port_is_lint_clean(self):
        assert run_lint(REPO) == []

    def test_examples_are_linted(self):
        """``examples_torch/`` is a lint root: its files are walked and
        held to the rules, but an example may print."""
        from repro_torch.verify.lint import DEFAULT_ROOTS, _iter_files
        assert "examples_torch" in DEFAULT_ROOTS
        walked = {p.name for p in _iter_files(pathlib.Path(REPO),
                                              DEFAULT_ROOTS)
                  if p.parent.name == "examples_torch"}
        assert walked == {"quickstart.py", "serve_batch.py",
                          "lm_analog_train.py", "ecg_train.py"}
        ex = "examples_torch/foo.py"
        assert lint_source("print('x')\n", ex) == []
        assert _rules(lint_source("def f(p):\n    return p['fpn']\n", ex)
                      ) == ["fpn-access"]


# ---------------------------------------------------------------- retrace
class TestRetrace:
    def test_cached_replay_is_clean(self):
        plan = lower_stack(_layers(), ACFG)
        x = torch.abs(torch.randn((4, 32), generator=_gen(2)))
        assert assert_no_retrace(lambda x: run(plan, x), x,
                                 label="stack-replay") == ()

    def test_per_call_lowering_flagged(self):
        layers = _layers()
        x = torch.abs(torch.randn((4, 32), generator=_gen(2)))

        def bad(x):
            return run(lower_stack(layers, ACFG), x)

        diags = assert_no_retrace(bad, x, label="relower-per-call")
        assert len(diags) == 1 and "re-lowering" in diags[0].message
        assert diags[0].path == "relower-per-call"
        with pytest.raises(VerifyError):
            assert_no_retrace(bad, x, strict=True)

    def test_launch_pattern_change_flagged(self, monkeypatch):
        from repro_torch.kernels import _build

        calls = {"n": 0}

        def drifting(x):          # every other replay launches once more
            calls["n"] += 1
            if calls["n"] % 2:
                _build._LAUNCHES["maxmin_pool"] += 1
            return x

        monkeypatch.setattr(_build, "_LAUNCHES", dict(_build._LAUNCHES))
        diags = assert_no_retrace(drifting, torch.zeros(2), label="drift")
        assert len(diags) == 1 and "launches differ" in diags[0].message

    def test_captured_constant_flagged(self):
        big = torch.ones((256, 256))          # 256 KiB closure capture

        def leaky(x):
            return x @ big

        diags = captured_constants(leaky, torch.ones((4, 256)))
        assert len(diags) == 1 and diags[0].rule == "captured-constant"
        assert diags[0].path == "fn.big"
        assert captured_constants(lambda x, w: x @ w, torch.ones((4, 256)),
                                  big) == ()
        small = torch.ones((8, 8))
        assert captured_constants(lambda x: x @ small,
                                  torch.ones((4, 8))) == ()

    def test_captured_plan_flagged_inside_a_held_function(self):
        plan = lower_stack([analog_linear_init(_gen(0), 256, 256,
                                               noise=NOISELESS,
                                               device="cpu")] * 2, ACFG)

        def inner(x):
            return run(plan, x)

        def outer(x):
            return inner(x)

        diags = captured_constants(outer, torch.zeros((1, 256)))
        paths = {d.path for d in diags}
        # each layer's 256 x 256 int8 codes: 64 KiB, the default threshold
        assert paths == {"fn.inner.plan.layers[0].store.codes",
                         "fn.inner.plan.layers[1].store.codes"}
        assert captured_constants(lambda x, p: run(p, x),
                                  torch.zeros((1, 256)), plan) == ()


# ------------------------------------------------------------ sweep + CLI
class TestSweep:
    def test_sweep_parts_are_clean(self):
        logs = []
        assert sweep_specs(logs.append) == ()
        assert sweep_plans(logs.append, device="cpu") == ()
        assert sweep_fleet(logs.append, device="cpu") == ()
        assert len(logs) == 10 + 2 + 6 + 1
        assert all(line.endswith(": 0 diagnostic(s)") for line in logs)

    def test_cli_exits_zero_on_the_tree(self, capsys):
        assert verify_main(["--device", "cpu"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[-1] == "verify: OK"
        assert "lint: 0 finding(s)" in out
        assert "invariant sweep: 0 diagnostic(s)" in out

    def test_cli_exits_one_on_a_planted_finding(self, tmp_path, capsys):
        pkg = tmp_path / "src" / "repro_torch"
        pkg.mkdir(parents=True)
        (pkg / "bad.py").write_text("def f(p):\n    return p['fpn']\n")
        assert verify_main(["--lint-only", "--root", str(tmp_path)]) == 1
        out = capsys.readouterr().out
        assert "src/repro_torch/bad.py:2: [fpn-access]" in out
        assert out.rstrip().endswith("verify: FAIL")

    def test_cli_sweep_failure_exits_one(self, monkeypatch, capsys):
        from repro_torch.verify import sweep as sweep_mod
        from repro_torch.verify.invariants import Diagnostic

        monkeypatch.setattr(sweep_mod, "sweep", lambda log, device: (
            Diagnostic("domain-chain", "plan.layers[0]", "planted"),))
        assert verify_main(["--sweep-only", "--device", "cpu"]) == 1
        assert "[domain-chain] plan.layers[0]: planted" in \
            capsys.readouterr().out

    def test_module_entry_point(self):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.verify", "--lint-only"],
            cwd=REPO, capture_output=True, text=True,
            env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
            timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
        assert r.stdout.splitlines()[-1] == "verify: OK"


def test_sweep_is_the_three_parts():
    logs = []
    assert sweep(logs.append, device="cpu") == ()
    assert len(logs) == 19
