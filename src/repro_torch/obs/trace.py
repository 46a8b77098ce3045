"""Nestable trace spans emitting Chrome-trace-event JSONL (the JAX package's
`repro.obs.trace`, the same event format).

`span("round", round=3)` is a context manager that records one Chrome
trace "complete" event (`ph: "X"`) with microsecond `ts`/`dur` on exit.
Spans nest by wall-time containment on the emitting thread, the model
Perfetto and chrome://tracing render, so they need no parent ids.

File format: one JSON event per line.  The first line is ``[`` and every
event line ends with ``,``: the Chrome trace-event array format with the
optional closing bracket omitted, which Perfetto and chrome://tracing
load directly and `tools/round_report.py` parses line by line.  Events are
appended as they close, so a crash mid-run loses at most the open spans.

An enabled span also opens `torch.profiler.record_function(name)`, so a
`torch.profiler` trace carries the span names, and with a CUDA device an
NVTX range of the same name for `nsys` timelines.

Gating: `enabled()` is False until `configure(enabled=True)`, and a
disabled `span()` returns a shared no-op: a caller pays one truthiness
check per span and nothing else.  Unlike the JAX package, which reads
REPRO_OBS and REPRO_OBS_TRACE, the port reads no environment variable: the
tracer holds its events in memory until `configure(trace_path=...)` names a
file, which is opened on the first event.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time

import torch

#: schema version stamped into trace metadata and provenance
OBS_VERSION = 1

_enabled = False
_tracer: "Tracer | None" = None
_lock = threading.Lock()


def enabled() -> bool:
    """True when span/trace recording is on (configure(enabled=True))."""
    return _enabled


def configure(enabled: bool | None = None, trace_path: str | None = "KEEP",
              reset: bool = False) -> None:
    """Switch telemetry on or off and choose its sink.

    Args:
        enabled: turn span and kernel-hook recording on or off (None: keep).
        trace_path: file sink for a fresh tracer; None = in-memory only,
            "KEEP" (default) = leave the current sink alone.
        reset: drop the current tracer (and its buffered events) so the
            next event starts a fresh trace.
    """
    global _enabled, _tracer
    with _lock:
        if reset and _tracer is not None:
            _tracer.close()
            _tracer = None
        if enabled is not None:
            _enabled = bool(enabled)
        if trace_path != "KEEP":
            if _tracer is not None:
                _tracer.close()
            _tracer = Tracer(path=trace_path)


def get_tracer() -> "Tracer":
    """The process tracer (created in memory on first use)."""
    global _tracer
    with _lock:
        if _tracer is None:
            _tracer = Tracer(path=None)
        return _tracer


class Tracer:
    """Event buffer + optional JSONL file sink, one per process."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.events: list[dict] = []
        self._fh = None
        self._flock = threading.Lock()
        self._t0_ns = time.perf_counter_ns()
        self._local = threading.local()

    # -- time / stack --------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since tracer start (perf_counter clock: durations,
        never wall-clock timestamps)."""
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def depth(self) -> int:
        """Current span nesting depth on this thread."""
        return len(self._stack())

    def current_span(self) -> "Span | None":
        st = self._stack()
        return st[-1] if st else None

    # -- emission ------------------------------------------------------------

    def emit(self, ev: dict) -> None:
        with self._flock:
            self.events.append(ev)
            if self.path:
                if self._fh is None:
                    self._fh = open(self.path, "w")
                    self._fh.write("[\n")
                    self._fh.write(json.dumps(self._meta_event(),
                                              separators=(",", ":")) + ",\n")
                self._fh.write(json.dumps(ev, separators=(",", ":")) + ",\n")

    def _meta_event(self) -> dict:
        return {"name": "process_name", "ph": "M", "pid": os.getpid(),
                "tid": threading.get_native_id(),
                "args": {"name": "repro_torch", "obs_version": OBS_VERSION,
                         "wall_time": time.time()}}

    def emit_complete(self, name: str, ts_us: float, dur_us: float,
                      cat: str = "phase", args: dict | None = None) -> None:
        """One Chrome 'X' complete event (ts/dur in microseconds)."""
        self.emit({"name": name, "cat": cat, "ph": "X",
                   "ts": round(ts_us, 3), "dur": round(dur_us, 3),
                   "pid": os.getpid(), "tid": threading.get_native_id(),
                   "args": args or {}})

    def emit_instant(self, name: str, cat: str = "event",
                     args: dict | None = None) -> None:
        """One Chrome 'i' instant event at the current time."""
        self.emit({"name": name, "cat": cat, "ph": "i",
                   "ts": round(self.now_us(), 3), "s": "t",
                   "pid": os.getpid(), "tid": threading.get_native_id(),
                   "args": args or {}})

    def flush(self) -> None:
        with self._flock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._flock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None


class annotate:
    """`torch.profiler.record_function(name)`, and with a CUDA device an
    NVTX range of the same name, around a block."""

    __slots__ = ("name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "annotate":
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        # NVTX needs a CUDA build: an annotation guard, not a compute path
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(exc_type, exc, tb)


class Span:
    """One nestable trace span; records a complete event on __exit__."""

    __slots__ = ("tracer", "name", "cat", "args", "_ts0", "_ann")

    def __init__(self, tracer: Tracer, name: str, cat: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._ts0 = 0.0
        self._ann = annotate(name)

    def set(self, **kw) -> None:
        """Attach/overwrite args after the span opened (e.g. byte counts
        known only at the end of the phase)."""
        self.args.update(kw)

    def __enter__(self) -> "Span":
        self.tracer._stack().append(self)
        self._ann.__enter__()
        self._ts0 = self.tracer.now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = self.tracer.now_us() - self._ts0
        self._ann.__exit__(exc_type, exc, tb)
        st = self.tracer._stack()
        if st and st[-1] is self:
            st.pop()
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self.tracer.emit_complete(self.name, self._ts0, dur, cat=self.cat,
                                  args=self.args)


class _NullSpan:
    """Shared no-op span: the entire disabled-path cost of obs.span()."""

    __slots__ = ()

    def set(self, **kw) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NULL_SPAN = _NullSpan()


def span(name: str, cat: str = "phase", **args):
    """Open a nestable trace span (no-op unless obs is enabled).

    Usage::

        with obs.span("round", round=rnd) as sp:
            ...
            sp.set(bytes_up=ledger.total(UPLINK, rnd))
    """
    if not _enabled:
        return NULL_SPAN
    return Span(get_tracer(), name, cat, dict(args))


def event(name: str, cat: str = "event", **args) -> None:
    """Record an instant event (no-op unless obs is enabled)."""
    if _enabled:
        get_tracer().emit_instant(name, cat=cat, args=dict(args))


def flush() -> None:
    """Flush the trace sink (atexit does this too; call before reading the
    file in-process)."""
    if _tracer is not None:
        _tracer.flush()


def trace_path() -> str | None:
    """The active trace file path, or None (disabled / in-memory)."""
    if not _enabled:
        return None
    return get_tracer().path


@atexit.register
def _atexit_flush() -> None:  # pragma: no cover - exit path
    if _tracer is not None:
        _tracer.close()
