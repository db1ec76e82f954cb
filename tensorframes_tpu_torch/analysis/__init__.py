"""tfguard: pre-execution static diagnostics over captured Programs.

The reference package's ``analysis/``. :mod:`tensorframes_tpu_torch.validation`
answers "will it run"; this package answers "will it run *well*" —
statically, from the program's aten graph (``make_fx`` under
``FakeTensorMode``) and its specs, before the first dispatch.

Surfaces:

* :func:`lint_program` / ``Program.lint()`` — lint one program;
* :func:`analyze_frame` — lint fetches against a frame, normalized
  exactly as the verbs would run them;
* :func:`lint_plan` — lint a frame's logical plan chain and the serving
  evidence (TFG107, TFG109–TFG111, TFG113, TFG114);
* ``python -m tensorframes_tpu_torch.analysis`` — lint ``save_program``
  artifacts (CLI), or ``selfcheck`` the package's own sources;
* ``strict=True`` on the verbs — raise
  :class:`~tensorframes_tpu_torch.validation.StaticAnalysisError` on any
  error-severity diagnostic before dispatch.
"""

from .analyzer import analyze_frame, lint_plan, lint_program  # noqa: F401
from .diagnostics import (  # noqa: F401
    CODES,
    Diagnostic,
    DiagnosticReport,
    save_jsonl,
)

__all__ = [
    "CODES",
    "Diagnostic",
    "DiagnosticReport",
    "analyze_frame",
    "lint_plan",
    "lint_program",
    "save_jsonl",
]
