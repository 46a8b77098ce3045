"""Process-wide metrics registry: counters, gauges, histograms with labels
(the port's own copy of the JAX package's `repro.obs.metrics`; the same
semantics and the same Prometheus text for the same series).

The registry is the single home for every numeric fact the port reports:
`StreamIngest`'s counters (`wire_ingest_*`), the bandwidth ledger's
`wire_bytes_total`, the tuner's series and the kernel hooks' timings.
Instruments are get-or-create keyed on (name, sorted label items), so two
call sites asking for the same series share one value.

Always on: recording is a dict lookup and an add, cheap enough to leave
unconditional (the `obs.configure(enabled=...)` switch covers only the
expensive telemetry: trace emission and the kernel hooks' synchronizes,
`obs/trace.py` and `obs/hooks.py`).

Export: `snapshot()` for structured consumers, `prometheus_text()` for a
Prometheus-exposition-style text dump (histograms rendered as summaries
with fixed quantiles).
"""
from __future__ import annotations

import threading

# summary quantiles rendered by prometheus_text()
_QUANTILES = (0.5, 0.9, 0.99)
# raw-sample cap per histogram: percentile queries stay exact until a
# series sees this many observations, then new samples keep count/sum
# exact but stop extending the reservoir (documented overhead bound)
HIST_MAX_SAMPLES = 65536


class Counter:
    """Monotonically increasing integer/float series."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self.value += n


class Gauge:
    """Point-in-time value; `set_max` supports peak/high-watermark use."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def add(self, d) -> None:
        self.value += d

    def set_max(self, v) -> None:
        """Raise the gauge to v if v exceeds the current value (peaks)."""
        if v > self.value:
            self.value = v


class Histogram:
    """Distribution of observations with exact percentiles.

    Keeps the raw samples (capped at HIST_MAX_SAMPLES) so `percentile`
    answers from the data instead of fixed buckets — right for the
    per-op kernel timings this registry exists to make trustworthy.
    """

    __slots__ = ("name", "labels", "count", "sum", "_samples")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self._samples: list[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if len(self._samples) < HIST_MAX_SAMPLES:
            self._samples.append(v)

    def percentile(self, p: float) -> float:
        """Exact percentile (linear interpolation) over recorded samples.
        p in [0, 100].  Raises ValueError on an empty series."""
        if not self._samples:
            raise ValueError(f"histogram {self.name} has no observations")
        xs = sorted(self._samples)
        if len(xs) == 1:
            return xs[0]
        rank = (p / 100.0) * (len(xs) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(xs) - 1)
        frac = rank - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Get-or-create home for every (name, labels) instrument."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1])
                self._metrics[key] = m
            elif type(m) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def get(self, name: str, **labels):
        """Existing instrument or None — read-only query, never creates."""
        return self._metrics.get((name, tuple(sorted(labels.items()))))

    def series(self, name: str) -> list:
        """Every instrument registered under `name`, across label sets."""
        return [m for (n, _), m in sorted(self._metrics.items())
                if n == name]

    def total(self, name: str):
        """Sum of values across every label set of a counter/gauge name."""
        return sum(m.value for m in self.series(name))

    def snapshot(self) -> dict:
        """{name: [{"labels": {...}, ...values...}]} for every instrument:
        the structured export."""
        out: dict[str, list] = {}
        for (name, labels), m in sorted(self._metrics.items()):
            row: dict = {"labels": dict(labels)}
            if isinstance(m, Histogram):
                row.update(count=m.count, sum=m.sum, mean=m.mean)
                if m.count:
                    row.update({f"p{int(q * 100)}": m.percentile(q * 100)
                                for q in _QUANTILES})
            else:
                row["value"] = m.value
            out.setdefault(name, []).append(row)
        return out

    def prometheus_text(self) -> str:
        """Prometheus-exposition-style text dump of every instrument."""
        lines = []
        seen_type: set[str] = set()
        for (name, labels), m in sorted(self._metrics.items()):
            kind = {"Counter": "counter", "Gauge": "gauge",
                    "Histogram": "summary"}[type(m).__name__]
            if name not in seen_type:
                lines.append(f"# TYPE {name} {kind}")
                seen_type.add(name)
            lab = _fmt_labels(dict(labels))
            if isinstance(m, Histogram):
                for q in _QUANTILES:
                    ql = _fmt_labels(dict(labels) | {"quantile": str(q)})
                    v = m.percentile(q * 100) if m.count else 0.0
                    lines.append(f"{name}{ql} {v:.9g}")
                lines.append(f"{name}_sum{lab} {m.sum:.9g}")
                lines.append(f"{name}_count{lab} {m.count}")
            else:
                lines.append(f"{name}{lab} {_fmt_val(m.value)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every instrument (tests only: counters are append-only for
        the life of the process)."""
        with self._lock:
            self._metrics.clear()


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_val(v) -> str:
    return f"{v:.9g}" if isinstance(v, float) else str(v)


#: the process-wide registry every module of the port records into
REGISTRY = MetricsRegistry()
