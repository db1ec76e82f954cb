"""Observability: the process-wide metrics registry (counters keep the
reference package's names, so snapshots compare series by series), the
run identity stamped on every artifact (:mod:`.context`), the structured
event timeline (:mod:`.events`, Chrome trace JSON), the crash flight
recorder (:mod:`.flight`), per-step training telemetry
(:mod:`.steps`, :class:`StepTelemetry`), the plan-profile reader
behind EXPLAIN ANALYZE (:mod:`.profile`), the cross-process trace merge
(:mod:`.merge`), bench snapshots and their diff (:mod:`.snapshot`), a
metrics scrape server (:func:`~.metrics.metrics_server`) and the
command line over them (``python -m tensorframes_tpu_torch.observability
report|merge|diff``)."""

from .metrics import REGISTRY, counter, histogram, metrics_server  # noqa: F401
from . import context  # noqa: F401
from . import events  # noqa: F401
from . import flight  # noqa: F401
from . import merge  # noqa: F401
from . import snapshot  # noqa: F401
from .flight import RECORDER, FlightRecorder  # noqa: F401
from .steps import StepTelemetry  # noqa: F401
