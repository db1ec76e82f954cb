"""Process-wide metrics registry: counters, gauges and fixed-bucket
histograms.

The numbers side of the observability subsystem: every instrumented layer
(the executor's dispatch cache, the kernels' launch counts) registers its
instruments here at import time, so a snapshot always carries the full
catalog — a counter that never fired reads 0, it does not vanish. Metric
names are the reference package's, so one dashboard reads both.

All instruments are thread-safe (one registry-wide lock; updates are a
few dict/float ops, far cheaper than the host-side work they count).
``reset()`` zeroes values but keeps registrations — instrumented modules
hold direct references to their instruments, so tests can zero the world
without orphaning them.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "DEFAULT_BUCKETS",
    "counter",
    "gauge",
    "histogram",
]

#: Default histogram bucket upper bounds, in seconds: from sub-millisecond
#: dispatches to multi-minute kernel builds.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

LabelPairs = Tuple[Tuple[str, str], ...]


def _label_pairs(labels: Optional[Mapping[str, str]]) -> LabelPairs:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared identity: name + static label set + help text. Subclasses
    hold the value(s); all mutation goes through the registry lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: LabelPairs, lock):
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = lock

    def _zero(self) -> None:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count (decreasing is a bug)."""

    kind = "counter"

    def __init__(self, name, help, labels, lock):
        super().__init__(name, help, labels, lock)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _zero(self) -> None:
        self._value = 0.0

    def _json_value(self):
        return {"value": self._value}


class Gauge(_Metric):
    """Point-in-time level (queue depth, free KV pages, running slots)."""

    kind = "gauge"

    def __init__(self, name, help, labels, lock):
        super().__init__(name, help, labels, lock)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _zero(self) -> None:
        self._value = 0.0

    def _json_value(self):
        return {"value": self._value}


class Histogram(_Metric):
    """Fixed-bucket histogram: per-bucket counts + sum + count. Bucket
    bounds are upper-inclusive; values above the last bound land in the
    implicit ``+Inf`` bucket."""

    kind = "histogram"

    def __init__(self, name, help, labels, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels, lock)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name}: buckets must be non-empty")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)  # + the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = 0
            for i, b in enumerate(self.buckets):  # noqa: B007 — short lists
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count)], ending with (+Inf, count)."""
        with self._lock:
            out, running = [], 0
            for b, c in zip(self.buckets, self._counts):
                running += c
                out.append((b, running))
            out.append((float("inf"), self._count))
            return out

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (0 < q < 1) by linear interpolation
        inside the bucket that holds it (Prometheus's
        ``histogram_quantile``); the +Inf bucket clamps to the largest
        finite bound. None when empty."""
        if not (0.0 < q < 1.0):
            raise ValueError(f"quantile q must be in (0, 1), got {q}")
        cum = self.cumulative()
        total = cum[-1][1]
        if total == 0:
            return None
        rank = q * total
        lo_bound, lo_count = 0.0, 0
        for bound, count in cum:
            if count >= rank:
                if bound == float("inf"):
                    return lo_bound
                if count == lo_count:
                    return bound
                return lo_bound + (bound - lo_bound) * ((rank - lo_count) / (count - lo_count))
            lo_bound, lo_count = bound, count
        return lo_bound

    def quantiles(self, qs: Sequence[float] = (0.5, 0.95, 0.99)) -> Dict[str, Optional[float]]:
        """``{"p50": ..., "p95": ..., "p99": ...}`` via :meth:`quantile`."""
        return {f"p{int(q * 100)}": self.quantile(q) for q in qs}

    def _zero(self) -> None:
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def _json_value(self):
        return {
            "buckets": {str(le): c for le, c in self.cumulative()},
            "sum": self.sum,
            "count": self.count,
        }


class MetricsRegistry:
    """Get-or-create store of named instruments, keyed by
    (name, sorted label pairs). Same name across label sets must keep
    one kind."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelPairs], _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Optional[Mapping[str, str]], **kwargs):
        key = (name, _label_pairs(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"requested {cls.kind}"
                    )
                return m
            for (other, _), existing in self._metrics.items():
                if other == name and existing.kind != cls.kind:
                    raise ValueError(
                        f"metric family {name!r} is {existing.kind}; cannot "
                        f"add a {cls.kind} series to it"
                    )
            m = cls(name, help, _label_pairs(labels), self._lock, **kwargs)
            self._metrics[key] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Mapping[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Mapping[str, str]] = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labels, buckets=buckets
        )

    def collect(self) -> List[_Metric]:
        """Every registered instrument."""
        with self._lock:
            return list(self._metrics.values())

    def reset(self) -> None:
        """Zero every instrument, keep registrations (instrumented modules
        hold references; removing them would orphan live instruments)."""
        with self._lock:
            for m in self._metrics.values():
                m._zero()

    def snapshot(self) -> List[dict]:
        """One plain dict per metric: name, kind, labels and values."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = []
        for m in metrics:
            d = {"name": m.name, "kind": m.kind, "labels": dict(m.labels)}
            d.update(m._json_value())
            out.append(d)
        return sorted(out, key=lambda d: (d["name"], sorted(d["labels"].items())))


#: The process-wide default registry every instrumented module uses.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "",
            labels: Optional[Mapping[str, str]] = None) -> Counter:
    """Get-or-create a counter on the default registry."""
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "",
          labels: Optional[Mapping[str, str]] = None) -> Gauge:
    """Get-or-create a gauge on the default registry."""
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "",
              labels: Optional[Mapping[str, str]] = None,
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    """Get-or-create a histogram on the default registry."""
    return REGISTRY.histogram(name, help, labels, buckets=buckets)
