"""Lower-once / build-once detection: prove a replay path does no
per-call lowering or kernel building (port of ``repro.verify.retrace``).

The executor's contract is that ``lower()`` happens once and every later
call replays the baked plans: no re-lowering
(:func:`repro_torch.exec.lower.lowering_count`), no kernel library built
or loaded after the first call, and the same kernel launches on every
replay.  The port runs eagerly and keeps no compile cache, so these
three counters stand in for the reference's jit-cache size.
:func:`captured_constants` is the eager form of the reference's
jaxpr-constant check: large tensors a function holds through its closure
cells or module globals instead of taking them as arguments (a baked
plan held that way is invisible to a hot-swap and to the caller's
device placement).

Both return the same :class:`~repro_torch.verify.invariants.Diagnostic`
records as the plan rules.
"""
from __future__ import annotations

import types
from typing import Tuple

import torch

from repro_torch.verify.invariants import Diagnostic, check, leaves_with_path


def _libraries() -> int:
    """Kernel libraries built or loaded in this process."""
    from repro_torch.kernels import _build

    return len(_build._LIBS)


def _launches() -> dict:
    from repro_torch.kernels import _build

    return dict(_build.launch_counts())


def assert_no_retrace(fn, *args, replays: int = 3, label: str = "fn",
                      strict: bool = False, **kwargs
                      ) -> Tuple[Diagnostic, ...]:
    """Call ``fn(*args, **kwargs)`` once to warm every cache, then
    ``replays`` more times asserting ZERO lowering work, ZERO kernel
    libraries built or loaded, and the same kernel launches on every
    replay.  Returns diagnostics (empty = the path is lower-once);
    ``strict=True`` raises
    :class:`~repro_torch.verify.invariants.VerifyError` instead."""
    from repro_torch.exec.lower import lowering_count

    out = []
    fn(*args, **kwargs)                               # warm
    base_lower, base_libs = lowering_count(), _libraries()
    per_replay = []
    for _ in range(replays):
        before = _launches()
        fn(*args, **kwargs)
        after = _launches()
        per_replay.append({k: after[k] - before.get(k, 0) for k in after
                           if after[k] != before.get(k, 0)})
    d_lower = lowering_count() - base_lower
    if d_lower:
        out.append(Diagnostic(
            "retrace", label,
            f"{d_lower} re-lowering(s) across {replays} warm replays "
            "(the baked plan is not being replayed)",
            "bake the plan once (api.compile / lower_stack) and pass it "
            "through the call, or fix the static-attribute mismatch that "
            "forces the per-call fallback",
        ))
    d_libs = _libraries() - base_libs
    if d_libs:
        out.append(Diagnostic(
            "retrace", label,
            f"{d_libs} kernel librar(ies) built or loaded across "
            f"{replays} warm replays",
            "a replay reaches a kernel the warm call did not; route every "
            "call through the same kernels",
        ))
    if any(r != per_replay[0] for r in per_replay[1:]):
        out.append(Diagnostic(
            "retrace", label,
            f"kernel launches differ between warm replays: {per_replay}",
            "a replay takes another route than the one before it; pin "
            "the route (megakernel=, static shapes)",
        ))
    if strict:
        check(out)
    return tuple(out)


def _held(fn):
    """(name, value) of everything ``fn`` holds besides its arguments: its
    closure cells and the module globals its code names (nested code
    objects included)."""
    code = fn.__code__
    for name, cell in zip(code.co_freevars, fn.__closure__ or ()):
        try:
            yield name, cell.cell_contents
        except ValueError:          # an empty cell
            continue
    names, stack = set(), [code]
    while stack:
        c = stack.pop()
        names.update(c.co_names)
        stack.extend(k for k in c.co_consts if isinstance(k, types.CodeType))
    g = getattr(fn, "__globals__", {})
    for name in sorted(names):
        if name in g:
            yield name, g[name]


def captured_constants(fn, *args, min_bytes: int = 1 << 16,
                       label: str = "fn", **kwargs
                       ) -> Tuple[Diagnostic, ...]:
    """Flag tensors of at least ``min_bytes`` that ``fn`` holds through
    closure cells or module globals rather than taking them as arguments
    (a weight table or plan captured this way defeats hot-swaps and the
    caller's placement).  Looks into containers and plan dataclasses,
    and into the closures of functions ``fn`` holds."""
    passed = {id(t) for _, t in leaves_with_path((args, kwargs))
              if isinstance(t, torch.Tensor)}
    seen, out = set(), []

    def visit(f, where):
        if id(f) in seen:
            return
        seen.add(id(f))
        for name, value in _held(f):
            if isinstance(value, types.ModuleType) or isinstance(value, type):
                continue
            if isinstance(value, types.FunctionType):
                visit(value, f"{where}.{name}")
                continue
            for key, t in leaves_with_path(value):
                if not isinstance(t, torch.Tensor) or id(t) in passed \
                        or id(t) in seen:
                    continue
                nbytes = t.numel() * t.element_size()
                if nbytes < min_bytes:
                    continue
                seen.add(id(t))
                out.append(Diagnostic(
                    "captured-constant", f"{where}.{name}{key}",
                    f"{tuple(t.shape)} {t.dtype} tensor ({nbytes} bytes) "
                    "is held by the function instead of passed in",
                    "pass the tensor (or the plan carrying it) as a "
                    "function argument so it stays a runtime input",
                ))

    visit(fn, label)
    return tuple(out)
