"""What the per-layer metric readers in `metrics/` share.  A reader takes
the run's record (spans, counters, geometry, units, window_s, trace) and
returns a number, or None where the record has nothing for it."""
from __future__ import annotations

import re


def _mean_ms(durations):
    return 1e3 * sum(durations) / len(durations) if durations else None


def mean_span_ms(record: dict, name: str):
    """Mean duration in ms of the harness's spans called `name`."""
    return _mean_ms([d for n, d in record["spans"] if n == name])


def mean_obs_span_ms(record: dict, name: str):
    """Mean duration in ms of the program's obs spans called `name`."""
    return _mean_ms([d for n, d in record["counters"].get("obs_spans", [])
                     if n == name])


def device_idle_pct(record: dict):
    """Share of the window in which no operation ran on the device."""
    tr = record.get("trace")
    if not tr or not tr.get("n_device_events") or not record["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / record["window_s"])


def kernel_roofline_pct(record: dict, op: str, kernel: str, least):
    """The op's least time at the window's shape over the device time of
    its kernel: launches (the program's counter over the window) x the
    least time of one launch, over the summed time of the profiler's
    events whose name holds `kernel`."""
    tr, g = record.get("trace"), record["geometry"]
    calls = record["counters"].get("launches", {}).get(op, 0)
    if not tr or not calls or "card" not in g:
        return None
    pat = re.compile(rf"\b{re.escape(kernel)}\b")
    spent = sum(s for name, (_, s) in tr["kernels"].items()
                if pat.search(name))
    if spent <= 0:
        return None
    one = least(g["rows"], g["n_limbs"], g["n_poly"], g["card"])
    return 100.0 * calls * one / spent


def whole_share_pct(record: dict, least_of_one):
    """The least time of each round or turn over the measured one: the
    window's rounds x the least time of one, over the window."""
    g = record["geometry"]
    if not record.get("trace") or "card" not in g or not record["units"]:
        return None
    return 100.0 * len(record["units"]) * least_of_one(g, g["card"]) \
        / record["window_s"]
