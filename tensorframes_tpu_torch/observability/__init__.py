"""Observability: the process-wide metrics registry (counters keep the
reference package's names, so snapshots compare series by series), the
run identity stamped on every artifact (:mod:`.context`), the structured
event timeline (:mod:`.events`, Chrome trace JSON), the crash flight
recorder (:mod:`.flight`), per-step training telemetry
(:mod:`.steps`, :class:`StepTelemetry`) and the plan-profile reader
behind EXPLAIN ANALYZE (:mod:`.profile`)."""

from .metrics import REGISTRY, counter, histogram  # noqa: F401
from . import context  # noqa: F401
from . import events  # noqa: F401
from . import flight  # noqa: F401
from .flight import RECORDER, FlightRecorder  # noqa: F401
from .steps import StepTelemetry  # noqa: F401
