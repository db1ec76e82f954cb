"""Structured diagnostics: the value objects of the static analyzer.

The reference package's ``analysis/diagnostics.py``, with its catalog
copied row for row (codes are API). A :class:`Diagnostic` is one finding
of the pre-execution pass (:mod:`tensorframes_tpu_torch.analysis.analyzer`):
a **stable code** (``TFG###`` — dashboards and suppressions key on
them), a severity (``error`` | ``warn`` | ``info``), a one-line message
bound to a concrete subject (an input name, a graph node), and an
``explain()`` that adds the fix suggestion and the rule-catalog pointer.

Every diagnostic increments a **pre-registered** counter in
:mod:`tensorframes_tpu_torch.observability.metrics`, labeled by code — the
whole family is registered at import (one series per known code), so a
Prometheus exposition always carries the full catalog: a fleet whose
programs never tripped ``TFG102`` reads 0 for it, the series does not
vanish. A bounded in-process log keeps the most recent diagnostics for
the CI artifact (``save_jsonl``), mirroring the metrics/trace exports.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from collections import deque
from typing import Deque, Dict, Iterable, List, Tuple

from ..observability.metrics import counter as _counter

__all__ = [
    "CODES",
    "SEVERITIES",
    "Diagnostic",
    "DiagnosticReport",
    "DIAGNOSTIC_LOG",
    "save_jsonl",
]

#: Severity names, most severe first (ordering is part of the contract:
#: ``strict=`` raises on ``error`` only).
SEVERITIES: Tuple[str, ...] = ("error", "warn", "info")

#: The rule catalog: code → (title, default severity). Codes are stable
#: API — never renumber; retire by removing the rule but keeping the row.
CODES: Dict[str, Tuple[str, str]] = {
    "TFG101": ("recompile-storm", "warn"),
    "TFG102": ("f64-leak", "warn"),
    "TFG103": ("unused-input", "info"),
    "TFG104": ("donation-alias", "error"),
    "TFG105": ("nan-hazard", "warn"),
    "TFG106": ("hbm-budget", "warn"),
    "TFG107": ("fusion-barrier", "warn"),
    "TFG108": ("cache-fingerprint-unstable", "warn"),
    "TFG109": ("unfused-aggregate", "warn"),
    "TFG110": ("missed-aggregate-pushdown", "warn"),
    "TFG111": ("larger-than-budget-materialization", "warn"),
    # liftable-callback / lift-declined pair: info when a captured numpy
    # UDF lifted (verified bit-exact, barrier cleared), warn when it
    # stayed a callback — the message carries the taxonomy reason and
    # names the offending AST node.
    "TFG112": ("liftable-callback", "warn"),
    # prefix-cache ineligible: serving evidence that decode prefill
    # work could not be shared (repeated prefixes on an engine with the
    # cache off, prompts below one page, replay-resumed joins) — the
    # fix names the DecodeConfig/page-size change that would enable it.
    "TFG113": ("prefix-cache-ineligible", "warn"),
    # registered-query degradation: serving evidence that a pipeline
    # served via Server.register_query cannot ride the result cache or
    # refresh incrementally (host callback, non-algebraic fetch,
    # computed key, float accumulation, …) — the fix names the plan
    # change that restores O(new data) refreshes.
    "TFG114": ("query-not-incremental", "warn"),
    # TFL: the repo self-lint family (python -m
    # tensorframes_tpu_torch.analysis selfcheck — policy rules over the
    # package's own sources, not user programs). Registered here so one
    # catalog covers every code a CI log can print.
    "TFL001": ("bare-jax-jit", "error"),
    "TFL002": ("unguarded-module-state", "error"),
    "TFL003": ("unregistered-runtime-metric", "error"),
}

# Pre-register the full counter family at import: one series per code,
# so expositions carry every code from process start (the convention of
# the executor and resilience instruments).
_DIAG_COUNTERS = {
    code: _counter(
        "tftpu_analysis_diagnostics_total",
        "Static diagnostics emitted by the static analyzer, by code",
        labels={"code": code},
    )
    for code in CODES
}

#: Bounded log of recent diagnostics (:func:`save_jsonl` exports it).
#: Lints may run from verb worker threads; ``_LOG_LOCK`` serializes append vs the
#: export's snapshot iteration.
DIAGNOSTIC_LOG: Deque["Diagnostic"] = deque(maxlen=4096)
_LOG_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One static finding. Immutable; ordering key is severity rank."""

    code: str
    severity: str
    message: str
    subject: str = ""  # input/output name or graph node the finding binds to
    fix: str = ""  # one actionable suggestion

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def title(self) -> str:
        return CODES[self.code][0]

    def oneline(self) -> str:
        subj = f" [{self.subject}]" if self.subject else ""
        return f"{self.code} {self.severity}{subj}: {self.message}"

    def explain(self) -> str:
        """Message + fix suggestion + rule-catalog pointer."""
        lines = [self.oneline()]
        if self.fix:
            lines.append(f"  fix: {self.fix}")
        lines.append(
            f"  rule: {self.title} — docs/analysis.md#{self.code.lower()}"
        )
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _severity_rank(sev: str) -> int:
    return SEVERITIES.index(sev)


class DiagnosticReport:
    """The ordered findings of one lint run (most severe first).

    Construction is the single emission point: counters increment and
    the bounded log appends here, so every surface (API, CLI, strict
    verbs) feeds the same telemetry.
    """

    def __init__(self, diagnostics: Iterable[Diagnostic], subject: str = ""):
        self.diagnostics: List[Diagnostic] = sorted(
            diagnostics, key=lambda d: (_severity_rank(d.severity), d.code)
        )
        self.subject = subject
        with _LOG_LOCK:
            for d in self.diagnostics:
                _DIAG_COUNTERS[d.code].inc()
                DIAGNOSTIC_LOG.append(d)

    # -- access -------------------------------------------------------------
    def __iter__(self):
        return iter(self.diagnostics)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warn"]

    @property
    def infos(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "info"]

    def counts_by_severity(self) -> Dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for d in self.diagnostics:
            out[d.severity] += 1
        return out

    # -- rendering ----------------------------------------------------------
    def pretty(self, explain: bool = False) -> str:
        head = self.subject or "program"
        if not self.diagnostics:
            return f"{head}: clean (0 diagnostics)"
        c = self.counts_by_severity()
        lines = [
            f"{head}: {len(self)} diagnostic(s) "
            f"(error={c['error']} warn={c['warn']} info={c['info']})"
        ]
        for d in self.diagnostics:
            lines.append(d.explain() if explain else d.oneline())
        return "\n".join(lines)

    def to_jsonl(self) -> str:
        rows = [
            json.dumps({"subject": self.subject, **d.to_dict()}, sort_keys=True)
            for d in self.diagnostics
        ]
        return "\n".join(rows) + ("\n" if rows else "")

    # -- strict mode --------------------------------------------------------
    def raise_on_errors(self) -> "DiagnosticReport":
        """Raise :class:`~tensorframes_tpu_torch.validation.StaticAnalysisError`
        when any error-severity diagnostic is present (the ``strict=``
        contract on the verbs); returns self otherwise so calls chain."""
        errs = self.errors
        if errs:
            from ..observability import flight as _flight
            from ..validation import StaticAnalysisError

            err = StaticAnalysisError(
                "static analysis found "
                f"{len(errs)} error-severity diagnostic(s):\n"
                + "\n".join(d.explain() for d in errs),
                diagnostics=errs,
            )
            # strict-mode rejection is a flight-recorder dump trigger:
            # the black box shows what dispatched before the program
            # that failed the gate, even when the caller catches this
            _flight.record(
                "static_analysis.error", subject=self.subject,
                codes=",".join(sorted({d.code for d in errs})),
                count=len(errs),
            )
            _flight.dump(reason="static-analysis", exc=err)
            raise err
        return self


def save_jsonl(path: str, clear: bool = False) -> int:
    """Write the bounded diagnostic log as JSONL (one object per line);
    returns the number of rows written."""
    with _LOG_LOCK:
        rows = [json.dumps(d.to_dict(), sort_keys=True) for d in DIAGNOSTIC_LOG]
        if clear:
            DIAGNOSTIC_LOG.clear()
    with open(path, "w") as f:
        f.write("\n".join(rows) + ("\n" if rows else ""))
    return len(rows)
