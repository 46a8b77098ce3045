"""repro_torch.obs: telemetry of the port (the JAX package's `repro.obs`):
metrics registry, trace spans, kernel timing hooks, exporters.

  * **metrics** (`obs/metrics.py`): process-wide registry of counters,
    gauges and histograms with labels.  Always on: `StreamIngest`'s
    counters, the bandwidth ledger's bytes and the tuner's sweeps record
    here.
  * **trace spans** (`obs/trace.py`): nestable `span()` context managers
    emitting Chrome-trace-event JSONL loadable in Perfetto and
    `tools/round_report.py`, each also a `torch.profiler.record_function`
    (and an NVTX range on a CUDA build).  `span(name, device=...)` also
    times the span on a CUDA stream with an event pair, without
    synchronizing: `collect()` returns the events with each such span's
    `device_ms` filled in.
  * **kernel hooks** (`obs/hooks.py`): per-op wall time of every kernel op
    in `kernels/ops.py`, synchronized before and after, and
    `kernel_launch` spans around compound dispatches.

Spans and instant events record while obs is enabled
(`configure(enabled=True)`) or while a `torch.profiler` session runs in the
process, so profiling the program collects its stages with no switch.  The
kernel hooks, which synchronize, stay on `configure(enabled=True)` alone.
The trace stays in memory until `configure(trace_path=...)`.  An event's
`ts` counts perf_counter microseconds from the tracer's creation;
`to_profiler_ns(ts)` puts it on torch.profiler's wall-clock timestamps.
No environment variable switches anything (the JAX package reads REPRO_OBS
and REPRO_OBS_TRACE).  Exporters: the trace JSONL sink, `collect()`,
`prometheus_text()` / `dump_metrics()`, and `provenance()`.
"""
from __future__ import annotations

import torch

from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import (NULL_SPAN, OBS_VERSION, Span, Tracer,
                                   collect, configure, enabled, event, flush,
                                   get_tracer, recording, span,
                                   to_profiler_ns, trace_path)
from repro_torch.obs.hooks import (kernel_hooks_enabled, kernel_launch,
                                   maybe_block, timed_kernel)

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_SPAN", "OBS_VERSION", "Span", "Tracer",
    "collect", "configure", "enabled", "event", "flush", "get_tracer",
    "recording", "span", "to_profiler_ns", "trace_path",
    "kernel_hooks_enabled", "kernel_launch", "maybe_block", "timed_kernel",
    "counter", "gauge", "histogram", "prometheus_text", "dump_metrics",
    "provenance",
]


def counter(name: str, **labels) -> Counter:
    """Get-or-create a counter in the process registry."""
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    """Get-or-create a gauge in the process registry."""
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    """Get-or-create a histogram in the process registry."""
    return REGISTRY.histogram(name, **labels)


def prometheus_text() -> str:
    """Prometheus-style text dump of the process registry."""
    return REGISTRY.prometheus_text()


def dump_metrics(path: str) -> None:
    """Write the Prometheus-style registry dump to `path`."""
    with open(path, "w") as f:
        f.write(REGISTRY.prometheus_text())


def provenance() -> dict:
    """What a measurement ran on: obs schema version, device identity and
    the tuner's state.  The port has no backend registry, so the JAX
    package's `backend` / `backend_token` have no counterpart."""
    from repro_torch.kernels import tune

    n = torch.cuda.device_count()
    return {
        "obs_version": OBS_VERSION,
        "platform": "gpu" if n else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if n else "cpu",
        "device_count": n if n else 1,
        "tune": tune.provenance(),
    }
