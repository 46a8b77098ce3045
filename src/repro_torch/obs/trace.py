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
appended as they close, so a crash mid-run loses at most the open spans and
the device spans whose time is not yet read.

A recording span also opens `torch.profiler.record_function(name)`, so a
`torch.profiler` trace carries the span names, and with a CUDA device an
NVTX range of the same name for `nsys` timelines.

Gating: spans and events record while `enabled()` (`configure(enabled=True)`)
or while a `torch.profiler` session runs in the process (torch's own
"profiler enabled" flag, read once per span).  Otherwise `span()` returns a
shared no-op: a caller pays one flag check per span and nothing else.  The
kernel hooks (`obs/hooks.py`) stay on `configure(enabled=True)` alone, so a
profiler session never makes the program synchronize.  Unlike the JAX
package, which reads REPRO_OBS and REPRO_OBS_TRACE, the port reads no
environment variable: the tracer holds its events in memory until
`configure(trace_path=...)` names a file, which is opened on the first
event.

Device time: `span(name, device=...)` with a CUDA device (or True: the
current one) also records a CUDA event on that device's current stream at
enter and at exit, without synchronizing.  The span's `device_ms` arg, the
stream's time between those two enqueue points, is filled in when the trace
is read (`collect()`) or flushed; on a saturated stream it is the device
time of the work the span launched, on an idle one it also holds the host's
gaps.  A CPU device gives no `device_ms`.  Such a span reaches a file sink
only once its time is known, so the file may list it after later events.

Clock: `ts` is microseconds on `perf_counter` since the tracer's creation,
which also sampled the wall clock (`epoch_wall_ns`, in the file's metadata
event).  `to_profiler_ns(ts)` maps a `ts` onto `torch.profiler`'s event
timestamps, which are wall-clock nanoseconds.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _profiler

#: schema version stamped into trace metadata and provenance
OBS_VERSION = 1

_enabled = False
_tracer: "Tracer | None" = None
_lock = threading.Lock()


def enabled() -> bool:
    """True when obs is switched on (configure(enabled=True)): spans and
    the kernel hooks record."""
    return _enabled


def recording() -> bool:
    """True while spans and events record: obs is enabled, or a
    torch.profiler session is running in the process.  torch's own flag is
    the process-wide one its `profile` sets (its C++ check answers for the
    calling thread only, and the service folds on a worker thread)."""
    return _enabled or _profiler._is_profiler_enabled


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
        # one epoch on both clocks: ts on perf_counter, profiler on wall
        self._t0_ns = time.perf_counter_ns()
        self.epoch_wall_ns = time.time_ns()
        self._local = threading.local()
        # (event, start, end) of device spans whose device_ms is not read
        self._pending: list = []

    # -- time / stack --------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since tracer start (perf_counter clock)."""
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

    def emit(self, ev: dict, device_events=None) -> None:
        """Record one event; `device_events` (start, end CUDA events) hold
        it back from the file until its device_ms is read."""
        with self._flock:
            self.events.append(ev)
            if device_events is not None:
                self._pending.append((ev, *device_events))
            else:
                self._write(ev)

    def _write(self, ev: dict) -> None:
        if self.path:
            if self._fh is None:
                self._fh = open(self.path, "w")
                self._fh.write("[\n")
                self._fh.write(json.dumps(self._meta_event(),
                                          separators=(",", ":")) + ",\n")
            self._fh.write(json.dumps(ev, separators=(",", ":")) + ",\n")

    def _resolve(self) -> None:
        """Wait for every pending device span's end event and fill in its
        device_ms (caller holds _flock)."""
        for ev, start, end in self._pending:
            end.synchronize()
            ev["args"]["device_ms"] = start.elapsed_time(end)
            self._write(ev)
        self._pending = []

    def collect(self) -> list[dict]:
        """The recorded events, every device span's device_ms filled in."""
        with self._flock:
            self._resolve()
            return list(self.events)

    def _meta_event(self) -> dict:
        return {"name": "process_name", "ph": "M", "pid": os.getpid(),
                "tid": threading.get_native_id(),
                "args": {"name": "repro_torch", "obs_version": OBS_VERSION,
                         "wall_time": time.time(),
                         "epoch_wall_ns": self.epoch_wall_ns}}

    def emit_complete(self, name: str, ts_us: float, dur_us: float,
                      cat: str = "phase", args: dict | None = None,
                      device_events=None) -> None:
        """One Chrome 'X' complete event (ts/dur in microseconds)."""
        self.emit({"name": name, "cat": cat, "ph": "X",
                   "ts": round(ts_us, 3), "dur": round(dur_us, 3),
                   "pid": os.getpid(), "tid": threading.get_native_id(),
                   "args": args or {}}, device_events)

    def emit_instant(self, name: str, cat: str = "event",
                     args: dict | None = None) -> None:
        """One Chrome 'i' instant event at the current time."""
        self.emit({"name": name, "cat": cat, "ph": "i",
                   "ts": round(self.now_us(), 3), "s": "t",
                   "pid": os.getpid(), "tid": threading.get_native_id(),
                   "args": args or {}})

    def flush(self) -> None:
        with self._flock:
            self._resolve()
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._flock:
            self._resolve()
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


def _timing_device(device):
    """The CUDA device a span times on, or None: `device` is None, True
    (the current CUDA device, once CUDA is in use) or a device."""
    if device is True:
        return (torch.device("cuda", torch.cuda.current_device())
                if torch.cuda.is_initialized() else None)
    if device is None:
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


class Span:
    """One nestable trace span; records a complete event on __exit__."""

    __slots__ = ("tracer", "name", "cat", "args", "_ts0", "_ann", "_dev",
                 "_ev0")

    def __init__(self, tracer: Tracer, name: str, cat: str, args: dict,
                 device=None):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._ts0 = 0.0
        self._ann = annotate(name)
        self._dev = device
        self._ev0 = None

    def _device_event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._dev))
        return ev

    def set(self, **kw) -> None:
        """Attach/overwrite args after the span opened (e.g. byte counts
        known only at the end of the phase)."""
        self.args.update(kw)

    def __enter__(self) -> "Span":
        self.tracer._stack().append(self)
        self._ann.__enter__()
        if self._dev is not None:
            self._ev0 = self._device_event()
        self._ts0 = self.tracer.now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = self.tracer.now_us() - self._ts0
        pair = (self._ev0, self._device_event()) if self._dev is not None \
            else None
        self._ann.__exit__(exc_type, exc, tb)
        st = self.tracer._stack()
        if st and st[-1] is self:
            st.pop()
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self.tracer.emit_complete(self.name, self._ts0, dur, cat=self.cat,
                                  args=self.args, device_events=pair)


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


def span(name: str, cat: str = "phase", device=None, **args):
    """Open a nestable trace span (no-op unless `recording()`).  `device`
    (a CUDA device, or True for the current one) also times the span on
    that device's stream (module docstring).

    Usage::

        with obs.span("round", round=rnd) as sp:
            ...
            sp.set(bytes_up=ledger.total(UPLINK, rnd))
    """
    if not recording():
        return NULL_SPAN
    return Span(get_tracer(), name, cat, dict(args), _timing_device(device))


def event(name: str, cat: str = "event", **args) -> None:
    """Record an instant event (no-op unless `recording()`)."""
    if recording():
        get_tracer().emit_instant(name, cat=cat, args=dict(args))


def collect() -> list[dict]:
    """The process tracer's events, each device span's `device_ms` filled
    in (waits for their end events)."""
    return _tracer.collect() if _tracer is not None else []


def to_profiler_ns(ts_us: float) -> int:
    """An event's `ts` (microseconds) as a torch.profiler timestamp in
    wall-clock nanoseconds."""
    return get_tracer().epoch_wall_ns + round(ts_us * 1e3)


def flush() -> None:
    """Flush the trace sink, device spans included (atexit does this too;
    call before reading the file in-process)."""
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
