"""Custom AST lint over the port's own tree (port of
``repro.verify.lint``): keep the lower-once / HIL contract honest at the
SOURCE level.

The plan rules in :mod:`repro_torch.verify.invariants` check artifacts
after lowering; this module checks the code that produces them.  Seven
rules:

``fpn-access``
    ``params["fpn"]`` / ``params.get("fpn")`` may be READ only by
    ``repro_torch/exec/lower.py`` and ``repro_torch/calib/``: the fixed
    pattern is measured hardware state that exactly one consumer folds
    into the baked tables.  (Writes are fine.)

``deprecated-shim``
    The reference's pre-API entry points (``analog_linear_apply``,
    ``linear_lower``, ``ecg_lower``, ``prelower_tree``) have no place in
    the port: call the front door instead.

``numpy-in-kernel``
    A Triton kernel body (a function decorated ``@triton.jit``) must not
    call host ``numpy``: the call either fails on Triton values or folds
    into a constant at compile time.

``frozen-plan-dataclass``
    Every dataclass of the plan modules (``repro_torch/exec/``) must be
    ``@dataclasses.dataclass(frozen=True)``: a plan is shared between
    replays, hot-swaps and the plan store, and is replaced, never
    mutated.

``packed-weights``
    Plan weights are packed int8 codes + gain tables
    (:class:`repro_torch.exec.plan.WeightStore`); ``w_eff`` is a DERIVED
    view.  Constructing a ``WeightStore`` - or passing a materialized
    ``w_eff=`` keyword - outside the lowering (``exec/lower.py``), the
    plan definitions (``exec/plan.py``) and the plan store
    (``exec/store.py``) would reintroduce a baked fp32 weight copy that
    drift hot-swaps and the plan store cannot see.

``bare-print``
    ``print(`` in ``src/repro_torch`` outside ``repro_torch/obs/``:
    library code reports through :func:`repro_torch.obs.trace.log`.
    ``__main__.py`` CLI entry points are exempt.

``raw-timer``
    ``time.perf_counter(`` in ``src/repro_torch`` outside
    ``repro_torch/obs/``: timing goes through ``obs.trace``
    (``span`` / ``clock_us``).

Suppress a finding with a trailing ``# verify: allow-<rule>`` comment on
the offending line, with the reason beside it.  Tests are exempt.  Run
over the tree with ``python -m repro_torch.verify --lint-only``.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, Iterable, List, Sequence, Set

DEPRECATED_SHIMS: Dict[str, str] = {
    "analog_linear_apply": "repro_torch.api.apply_linear",
    "linear_lower": "api.compile (or exec.lower.lower_layer)",
    "ecg_lower": "api.compile(ecg_module_spec(...), params, acfg)",
    "prelower_tree": "api.compile",
}

_FPN_READERS = ("repro_torch/exec/lower.py",)
_FPN_READER_DIRS = ("repro_torch/calib/",)
# files allowed to build WeightStores / pass w_eff= (packing is the
# lowering's job; plan.py defines the store, store.py deserializes it)
_STORE_HOMES = (
    "repro_torch/exec/lower.py",
    "repro_torch/exec/plan.py",
    "repro_torch/exec/store.py",
)
_PLAN_DIR = "repro_torch/exec/"
# the port's library tree and its examples (bare-print / raw-timer stay
# scoped to the library: an example may print)
DEFAULT_ROOTS = ("src/repro_torch", "examples_torch")
# the observability surface: the one place prints and raw timers live
_OBS_DIR = "repro_torch/obs/"


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One lint hit: rule id, file, 1-based line, human message."""

    rule: str
    file: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


def _terminal_name(func: ast.AST) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _const_str(node: ast.AST):
    return node.value if isinstance(node, ast.Constant) else None


def _is_triton_jit(dec: ast.AST) -> bool:
    """``@triton.jit``, ``@triton.jit(...)`` or a bare ``@jit`` imported
    from triton."""
    if isinstance(dec, ast.Call):
        dec = dec.func
    return (isinstance(dec, ast.Attribute) and dec.attr == "jit"
            and isinstance(dec.value, ast.Name) and dec.value.id == "triton")


class _FileLint(ast.NodeVisitor):
    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.lines = source.splitlines()
        self.findings: List[LintFinding] = []
        self.np_aliases: Set[str] = set()
        self.jit_names: Set[str] = set()
        self._kernel_depth = 0
        self.fpn_reader = self.relpath.endswith(_FPN_READERS) or any(
            d in self.relpath for d in _FPN_READER_DIRS
        )
        self.store_home = self.relpath.endswith(_STORE_HOMES)
        self.plan_module = _PLAN_DIR in self.relpath
        # bare-print / raw-timer apply to library code in src/repro_torch
        # only, never inside the observability surface itself
        in_port = ("src/repro_torch/" in self.relpath
                   or self.relpath.startswith("repro_torch/"))
        self.obs_scoped = in_port and _OBS_DIR not in self.relpath
        self.cli_main = self.relpath.endswith("__main__.py")

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        src = self.lines[line - 1] if line - 1 < len(self.lines) else ""
        if f"verify: allow-{rule}" in src:
            return
        self.findings.append(LintFinding(rule, self.relpath, line, message))

    # ---- numpy aliases, `from triton import jit` --------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.name == "numpy":
                self.np_aliases.add(a.asname or "numpy")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "triton":
            for a in node.names:
                if a.name == "jit":
                    self.jit_names.add(a.asname or "jit")
        self.generic_visit(node)

    # ---- fpn-access -----------------------------------------------------
    def visit_Subscript(self, node: ast.Subscript) -> None:
        if (
            _const_str(node.slice) == "fpn"
            and isinstance(node.ctx, ast.Load)
            and not self.fpn_reader
        ):
            self._emit(
                "fpn-access", node,
                'params["fpn"] read outside exec.lower/calib: '
                "fixed-pattern noise is folded into the baked tables by "
                "exactly one consumer",
            )
        self.generic_visit(node)

    # ---- calls ----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _terminal_name(node.func)
        if (
            name == "get"
            and node.args
            and _const_str(node.args[0]) == "fpn"
            and not self.fpn_reader
        ):
            self._emit(
                "fpn-access", node,
                'params.get("fpn") outside exec.lower/calib',
            )
        if name in DEPRECATED_SHIMS:
            self._emit(
                "deprecated-shim", node,
                f"call to deprecated shim {name}(); use "
                f"{DEPRECATED_SHIMS[name]}",
            )
        if self.obs_scoped:
            if (name == "print" and isinstance(node.func, ast.Name)
                    and not self.cli_main):
                self._emit(
                    "bare-print", node,
                    "bare print() in src/repro_torch: report through "
                    "repro_torch.obs.trace.log() so the line is also "
                    "recorded as a trace event",
                )
            if name == "perf_counter":
                self._emit(
                    "raw-timer", node,
                    "raw time.perf_counter() in src/repro_torch: time "
                    "through repro_torch.obs.trace (span/clock_us) so all "
                    "measurements share one implementation",
                )
        if not self.store_home:
            if name == "WeightStore":
                self._emit(
                    "packed-weights", node,
                    "WeightStore() built outside exec.lower/plan/store: "
                    "packing weight codes is the lowering's job",
                )
            for kw in node.keywords:
                if kw.arg == "w_eff":
                    self._emit(
                        "packed-weights", node,
                        "materialized w_eff= passed outside "
                        "exec.lower/plan/store: w_eff is a derived view "
                        "of the packed WeightStore, not a constructor "
                        "argument",
                    )
        if (
            self._kernel_depth
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in self.np_aliases
        ):
            self._emit(
                "numpy-in-kernel", node,
                f"host numpy call {node.func.value.id}."
                f"{node.func.attr}() inside a Triton kernel body "
                "(@triton.jit); use tl.* operations",
            )
        self.generic_visit(node)

    # ---- kernel bodies --------------------------------------------------
    def _visit_fn(self, node) -> None:
        is_kernel = any(
            _is_triton_jit(d) or (isinstance(d, ast.Name)
                                  and d.id in self.jit_names)
            for d in node.decorator_list)
        if is_kernel:
            self._kernel_depth += 1
        self.generic_visit(node)
        if is_kernel:
            self._kernel_depth -= 1

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    # ---- frozen-plan-dataclass ------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if self.plan_module:
            decs = [d for d in node.decorator_list if _terminal_name(
                d.func if isinstance(d, ast.Call) else d) == "dataclass"]
            if decs and not any(self._is_frozen(d) for d in decs):
                self._emit(
                    "frozen-plan-dataclass", node,
                    f"plan class {node.name} is a dataclass but not "
                    "@dataclass(frozen=True); plans are shared between "
                    "replays and hot-swaps and must be immutable",
                )
        self.generic_visit(node)

    @staticmethod
    def _is_frozen(dec: ast.AST) -> bool:
        return isinstance(dec, ast.Call) and any(
            kw.arg == "frozen" and _const_str(kw.value) is True
            for kw in dec.keywords)


def lint_source(source: str, relpath: str) -> List[LintFinding]:
    """Lint one file's source text (exposed for tests)."""
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as e:
        return [LintFinding("parse", relpath, e.lineno or 1, str(e.msg))]
    v = _FileLint(relpath, source)
    v.visit(tree)
    return v.findings


def _iter_files(root: pathlib.Path,
                roots: Sequence[str]) -> Iterable[pathlib.Path]:
    for r in roots:
        base = root / r
        if not base.exists():
            continue
        for p in sorted(base.rglob("*.py")):
            rel = p.relative_to(root).as_posix()
            if "/tests/" in f"/{rel}" or p.name.startswith("test_"):
                continue
            yield p


def run_lint(root=".", roots: Sequence[str] = DEFAULT_ROOTS
             ) -> List[LintFinding]:
    """Lint every non-test ``.py`` file under ``roots`` (relative to the
    repo ``root``) and return all findings, stably ordered."""
    root = pathlib.Path(root)
    findings: List[LintFinding] = []
    for p in _iter_files(root, roots):
        rel = p.relative_to(root).as_posix()
        findings.extend(lint_source(p.read_text(), rel))
    return findings
