"""The benchmark's run machinery: loading a cell's files by name, spans,
the traced window, the device's numbers, the check against the reference,
and the result line.

A cell is an entry of BENCHMARK.json's `workloads`.  Its configuration is
`configs/<config>.json`, its traffic `traffic/<traffic>.json`, whose `kind`
names the driver in `kinds/<kind>.py`, the limits of its `correct`
`limits/<cell>.json`, and each per-layer metric the reader
`metrics/<metric>.py`.  The harness finds all of them by those names.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
LIMITS = HERE / "limits"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the harness's spans and the program's obs spans; the profiler also puts
# each on the device timeline, where it is no device work
SPAN_PREFIXES = ("bench.", "wire.", "serve.", "he.", "sharded.")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic) of the named cell."""
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            cfg = load_json(HERE / "configs" / f"{w['config']}.json")
            traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
            return w, cfg, traffic
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def limits(name: str) -> dict:
    """The named cell's own limits, one for each number its check
    compares: set for that cell alone, never shared with another."""
    path = LIMITS / f"{name}.json"
    if not path.is_file():
        raise LookupError(f"cell {name!r} has no limits of its own "
                          f"({path.name} under {LIMITS.name}/)")
    return load_json(path)


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(traffic: dict):
    return importlib.import_module(f"kinds.{traffic['kind']}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "chipbench_metric_" + name.replace(".", "_"))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def quantile(values, q: float) -> float:
    """The q quantile by linear interpolation between order statistics."""
    vals = sorted(values)
    if len(vals) == 1:
        return float(vals[0])
    return float(statistics.quantiles(vals, n=100,
                                      method="inclusive")[round(q * 100) - 1])


class Run:
    """One run of one cell: its seed, device, spans and window."""

    def __init__(self, seed: int, seconds: float, trace: bool, device):
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.spans: list[tuple[str, float]] = []
        # (name, start, end) on the host's perf_counter clock: the harness's
        # spans and the program's obs spans, naming the device's idle gaps
        self.host_spans: list[tuple[str, float, float]] = []
        self.t0 = None                     # the window's start, same clock
        self.wall0_ns = None               # the window's start, wall clock
        self.counters: dict = {}
        self.geometry: dict = {}
        self.units: list[float] = []       # seconds of each round or turn
        self.window_s = None
        self.record = None                 # what a traced window's readers read
        # seconds of the profiler's stop, its events' listing and reading
        self.trace_s = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """A harness span, recorded in the traced window only: set-up's
        warm-up, which may build the kernels, stays out of the per-layer
        spans.  With `sync` it ends once the device work it launched has
        finished."""
        if not self.trace or self.t0 is None:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            if sync:
                self.sync()
        t1 = time.perf_counter()
        self.spans.append((name, t1 - t0))
        self.host_spans.append((name, t0, t1))

    def window(self, body):
        """Run `body(run)` as the measured window, under the profiler in a
        traced run; body appends each round's or turn's seconds to
        self.units.  Returns the trace summary (None untraced)."""
        self.sync()
        if not self.trace:
            t0 = time.perf_counter()
            body(self)
            self.sync()
            self.window_s = time.perf_counter() - t0
            return None
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        # the device's activity alone, with no links from host operators to
        # kernels: the host's operators, a few for each kernel, would take
        # the profiler's stop and the reading of its events several times
        # as long, and no reader reads them
        if self.device.type == "cuda":
            acts = [ProfilerActivity.CUDA]
            extra = _ExperimentalConfig(disable_external_correlation=True)
        else:
            acts, extra = [ProfilerActivity.CPU], None
        with profile(activities=acts, experimental_config=extra) as prof:
            self.wall0_ns = time.time_ns()
            self.t0 = time.perf_counter()
            body(self)
            self.sync()
            self.window_s = time.perf_counter() - self.t0
        t = time.perf_counter()
        events = prof.profiler.kineto_results.events()
        t1 = time.perf_counter()
        summary = summarize_trace(events, self)
        self.trace_s = (t - self.t0 - self.window_s, t1 - t,
                        time.perf_counter() - t1)
        return summary


def _union(starts, ends, lo, hi) -> tuple[float, list]:
    """(covered length, gaps [(start, end)]) of the intervals [starts[i],
    ends[i]] within [lo, hi]."""
    a = np.clip(np.asarray(starts, dtype=np.float64), lo, hi)
    b = np.clip(np.asarray(ends, dtype=np.float64), lo, hi)
    keep = b > a
    order = np.argsort(a[keep], kind="stable")
    a, b = a[keep][order], b[keep][order]
    if not len(a):
        return 0.0, [(lo, hi)] if hi > lo else []
    # the end of all that came before each interval
    before = np.concatenate(([lo], np.maximum.accumulate(b)[:-1]))
    busy = float(np.sum(b - np.maximum(a, before).clip(max=b)))
    gap = a > before
    gaps = list(zip(before[gap].tolist(), a[gap].tolist()))
    end = float(np.max(b))
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def summarize_trace(events, run: Run) -> dict:
    """Device time by kernel name, the device's busy time within the
    window (the union of its events' intervals), and the idle gaps named by
    the innermost harness or program span the host was in at their middle.
    The profiler's timestamps are on the wall clock (nanoseconds since the
    epoch), so the window is where `time.time_ns()` put its start.

    It reads the profiler's raw events (`kineto_results.events()`), the
    device's hundreds of thousands of a training window one call each, a
    name judged once: building its FunctionEvents from them would take
    minutes."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    starts, durs, names, skip = [], [], [], {}
    for e in events:
        if e.device_type() != cuda:
            continue
        name = e.name()
        out = skip.get(name)
        if out is None:     # a span's range on the device timeline, or hidden
            out = skip[name] = (name.startswith(SPAN_PREFIXES)
                                or e.is_user_annotation()
                                or e.is_hidden_event())
        if not out:
            starts.append(e.start_ns())
            durs.append(e.duration_ns())
            names.append(name)
    a = (np.asarray(starts, dtype=np.int64) - run.wall0_ns) / 1e3
    d = np.asarray(durs, dtype=np.float64) / 1e3
    kernels: dict = {}
    for name, us in zip(names, d.tolist()):
        n, sec = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, sec + us / 1e6)
    window = (0.0, run.window_s * 1e6)
    if len(a) and not np.any((a < window[1]) & (a + d > 0)):
        raise RuntimeError("no device event lies in the window: the "
                           "profiler's clock is not the wall clock")
    busy_us, gaps = _union(a, a + d, *window)
    host = sorted((((t0 - run.t0) * 1e6, (t1 - run.t0) * 1e6, n)
                   for n, t0, t1 in run.host_spans),
                  key=lambda h: h[1] - h[0])       # innermost first
    idle: dict = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        label = next((n for h0, h1, n in host if h0 <= mid <= h1),
                     "bench.window")
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    return {"busy_s": busy_us / 1e6, "kernels": kernels,
            "idle": idle, "n_device_events": len(a)}


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def device_block(run: Run, trace: dict | None) -> dict:
    dev = run.device
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                   dev))}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if trace is not None:
        out["busy_s"] = trace["busy_s"]
        out["window_s"] = run.window_s
    return out


def record_of(run: Run, trace: dict | None) -> dict:
    """What the per-layer readers read: the run's spans, counters,
    geometry, round or turn times, window and trace summary, and of a
    traced window the program's own events (its tracer's spans and instant
    events, device times resolved: `obs.collect()`)."""
    events = None
    if trace is not None:
        from repro_torch import obs

        events = obs.collect()
    return {"spans": run.spans, "counters": run.counters,
            "geometry": run.geometry, "units": run.units,
            "window_s": run.window_s, "trace": trace,
            "device": str(run.device), "events": events}


def per_layer(record: dict, names) -> dict:
    """Each named reader's value on the record; a reader that finds
    nothing returns None and its metric is left out."""
    out = {}
    for name in names:
        reader = metric_reader(name)
        val = reader.read(record)
        if val is not None:
            if not math.isfinite(val):
                raise RuntimeError(f"metric {name} read {val}")
            out[name] = {"value": float(val), "unit": reader.UNIT}
    return out
