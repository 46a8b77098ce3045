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
        self.counters: dict = {}
        self.geometry: dict = {}
        self.units: list[float] = []       # seconds of each round or turn
        self.window_s = None

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
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function("bench.window"):
                self.t0 = time.perf_counter()
                body(self)
                self.sync()
                self.window_s = time.perf_counter() - self.t0
        return summarize_trace(prof, self)


def _union(intervals, lo, hi) -> tuple[float, list]:
    """(covered length, gaps [(start, end)]) of intervals within [lo, hi]."""
    busy, gaps, end = 0.0, [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def summarize_trace(prof, run: Run) -> dict:
    """Device time by kernel name, the device's busy time within the
    window (the union of its events' intervals), and the idle gaps named by
    the innermost harness or program span the host was in at their middle.
    The profiler's `bench.window` range ties its clock to the host's.

    It reads the profiler's raw events: building its FunctionEvents from
    them takes a minute for a sim window, reading them a few seconds."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    start_ns = res.trace_start_ns()
    dev_iv, kernels, window = [], {}, None
    for e in res.events():
        if e.is_hidden_event():
            continue
        name = e.name()
        a = (e.start_ns() - start_ns) / 1e3
        b = a + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(SPAN_PREFIXES):
                continue        # a span's range on the device timeline
            dev_iv.append((a, b))
            n, s = kernels.get(name, (0, 0.0))
            kernels[name] = (n + 1, s + (b - a) / 1e6)
        elif name == "bench.window":
            window = (a, b)
    if window is None:
        raise RuntimeError("the profiler lost the window's range")
    busy_us, gaps = _union(dev_iv, *window)
    to_us = lambda t: window[0] + (t - run.t0) * 1e6  # noqa: E731
    host = sorted(((to_us(a), to_us(b), n) for n, a, b in run.host_spans),
                  key=lambda h: h[1] - h[0])       # innermost first
    idle: dict = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label = next((n for s, e, n in host if s <= mid <= e),
                     "bench.window")
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return {"busy_s": busy_us / 1e6, "kernels": kernels,
            "idle": idle, "n_device_events": len(dev_iv)}


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
    geometry, round or turn times, window and trace summary."""
    return {"spans": run.spans, "counters": run.counters,
            "geometry": run.geometry, "units": run.units,
            "window_s": run.window_s, "trace": trace,
            "device": str(run.device)}


def per_layer(run: Run, names, trace: dict) -> dict:
    """Each named reader's value; a reader that finds nothing returns None
    and its metric is left out."""
    record = record_of(run, trace)
    out = {}
    for name in names:
        reader = metric_reader(name)
        val = reader.read(record)
        if val is not None:
            if not math.isfinite(val):
                raise RuntimeError(f"metric {name} read {val}")
            out[name] = {"value": float(val), "unit": reader.UNIT}
    return out
