"""Process-wide metrics registry: counters, gauges and fixed-bucket
histograms.

The numbers side of the observability subsystem: every instrumented layer
(the executor's dispatch cache, the kernels' launch counts) registers its
instruments here at import time, so a snapshot always carries the full
catalog — a counter that never fired reads 0, it does not vanish. Metric
names are the reference package's, so one dashboard reads both.

Exporters, as the reference package's:

* ``REGISTRY.to_prometheus()`` — Prometheus text exposition (0.0.4),
  histograms as cumulative ``_bucket{le=...}`` series plus
  ``_sum``/``_count``;
* ``REGISTRY.to_jsonl()`` / ``write_jsonl(path)`` — one JSON object per
  metric per line, stamped with the run identity, for offline diffing
  (:mod:`.snapshot` reads it back);
* :func:`metrics_server` — a daemon-thread HTTP server exposing
  ``/metrics`` (Prometheus) and ``/metrics.json`` (JSONL) for scraping.

All instruments are thread-safe (one registry-wide lock; updates are a
few dict/float ops, far cheaper than the host-side work they count).
``reset()`` zeroes values but keeps registrations — instrumented modules
hold direct references to their instruments, so tests can zero the world
without orphaning them.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "DEFAULT_BUCKETS",
    "quantile_from_cumulative",
    "counter",
    "gauge",
    "histogram",
    "metrics_server",
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


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats via repr."""
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class _Metric:
    """Shared identity: name + static label set + help text. Subclasses
    hold the value(s); all mutation goes through the registry lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: LabelPairs, lock):
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = lock

    @property
    def label_str(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in self.labels)
        return "{" + inner + "}"

    def _zero(self) -> None:
        raise NotImplementedError

    def _samples(self):
        return [(self.name, self.label_str, self._value)]


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
        return quantile_from_cumulative(cum, cum[-1][1], q)

    def quantiles(self, qs: Sequence[float] = (0.5, 0.95, 0.99)) -> Dict[str, Optional[float]]:
        """``{"p50": ..., "p95": ..., "p99": ...}`` via :meth:`quantile`."""
        return {f"p{int(q * 100)}": self.quantile(q) for q in qs}

    def _zero(self) -> None:
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def _samples(self):
        with self._lock:  # one consistent read of buckets, sum and count
            cum, running = [], 0
            for b, c in zip(self.buckets, self._counts):
                running += c
                cum.append((b, running))
            cum.append((float("inf"), self._count))
            total_sum, total_count = self._sum, self._count
        out = []
        for le, c in cum:
            ls = self.label_str
            le_pair = f'le="{_fmt(le)}"'
            merged = ls[:-1] + "," + le_pair + "}" if ls else "{" + le_pair + "}"
            out.append((self.name + "_bucket", merged, c))
        out.append((self.name + "_sum", self.label_str, total_sum))
        out.append((self.name + "_count", self.label_str, total_count))
        return out

    def _json_value(self):
        return {
            "buckets": {_fmt(le): c for le, c in self.cumulative()},
            "sum": self.sum,
            "count": self.count,
        }


def quantile_from_cumulative(
    cum: Sequence[Tuple[float, int]], count: int, q: float
) -> Optional[float]:
    """The one bucket-interpolation quantile estimate: ``cum`` is
    ``[(upper_bound, cumulative_count), ...]`` sorted ascending (a
    trailing +Inf entry is allowed and ignored — overflow clamps to the
    largest finite bound). Shared by :meth:`Histogram.quantile` and the
    offline registry-JSONL reader (:mod:`.snapshot`), so the live and the
    exported estimates never diverge."""
    if count <= 0:
        return None
    finite = [(b, c) for b, c in cum if b != float("inf")]
    if not finite:
        return None
    rank = q * count
    prev_bound, prev_cum = 0.0, 0
    for bound, c in finite:
        if c >= rank:
            in_bucket = c - prev_cum
            if in_bucket <= 0:  # pragma: no cover - defensive
                return bound
            frac = (rank - prev_cum) / in_bucket
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_cum = bound, c
    return finite[-1][0]


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

    def to_jsonl(self) -> str:
        """One JSON object per metric per line, each stamped with the run
        identity and the time, so a fleet's per-process exports join
        offline the way trace shards do."""
        from . import context as _context

        ts = time.time()
        stamp = _context.snapshot()
        return "\n".join(
            json.dumps({**d, **stamp, "ts": round(ts, 3)}, sort_keys=True)
            for d in self.snapshot()
        ) + ("\n" if self._metrics else "")

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4): families grouped,
        one HELP/TYPE header per name, samples sorted for stable diffs."""
        families: Dict[str, List[_Metric]] = {}
        for m in self.collect():
            families.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name in sorted(families):
            members = families[name]
            help_text = next((m.help for m in members if m.help), "")
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {members[0].kind}")
            for m in sorted(members, key=lambda m: m.labels):
                for sample_name, label_str, v in m._samples():
                    lines.append(f"{sample_name}{label_str} {_fmt(v)}")
        return "\n".join(lines) + ("\n" if lines else "")


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


def metrics_server(port: int = 9464, registry: Optional[MetricsRegistry] = None,
                   addr: str = "127.0.0.1"):
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json`` (JSONL)
    from a daemon thread. ``port=0`` binds an ephemeral port — read it
    back from ``server.server_address[1]``. Returns the
    ``ThreadingHTTPServer``; call ``.shutdown()`` to stop."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry if registry is not None else REGISTRY

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server API
            if self.path.split("?")[0] in ("/metrics.json", "/metrics.jsonl"):
                body = reg.to_jsonl().encode()
                ctype = "application/x-ndjson"
            elif self.path.split("?")[0] in ("/", "/metrics"):
                body = reg.to_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapers must not spam stderr
            pass

    server = ThreadingHTTPServer((addr, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="tfs-metrics-server").start()
    return server
