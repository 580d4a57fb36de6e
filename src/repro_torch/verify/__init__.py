"""``repro_torch.verify``: static analysis for the lower-once executor
(port of ``repro.verify``).

- :mod:`repro_torch.verify.domains` - THE domain-transition table
  (consumed by ``exec.lower`` packing/eligibility and by the rules here);
- :mod:`repro_torch.verify.invariants` - the plan/spec rule registry
  (structured :class:`Diagnostic` records, ``verify_plan`` /
  ``verify_spec`` / ``verify_model`` / ``verify_swap``);
- :mod:`repro_torch.verify.retrace` - per-call lowering / kernel build /
  captured-tensor detection for replay paths;
- :mod:`repro_torch.verify.lint` - the custom AST lint;
- :mod:`repro_torch.verify.sweep` - the sweep behind ``python -m
  repro_torch.verify`` (imported lazily: it pulls in the models).

``exec.lower`` imports :mod:`repro_torch.verify.domains` from inside its
functions (this package depends on ``repro_torch.exec.plan`` only at
import time, never on ``repro_torch.exec.lower``).
"""
from repro_torch.verify import domains  # noqa: F401
from repro_torch.verify.invariants import (  # noqa: F401
    RULES,
    Diagnostic,
    Rule,
    VerifyError,
    check,
    verify_model,
    verify_plan,
    verify_spec,
    verify_swap,
)
from repro_torch.verify.lint import (  # noqa: F401
    DEPRECATED_SHIMS,
    LintFinding,
    run_lint,
)
from repro_torch.verify.retrace import (  # noqa: F401
    assert_no_retrace,
    captured_constants,
)

__all__ = [
    "domains",
    "Diagnostic",
    "Rule",
    "RULES",
    "VerifyError",
    "check",
    "verify_plan",
    "verify_spec",
    "verify_model",
    "verify_swap",
    "assert_no_retrace",
    "captured_constants",
    "LintFinding",
    "DEPRECATED_SHIMS",
    "run_lint",
]
