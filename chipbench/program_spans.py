"""What the readers of the program's own stage spans share.  They read the
program's tracer (`repro_torch.obs`) of a traced window: its spans and
instant events record while torch.profiler runs, so every cell's traced
window holds them, and the run's record keeps them (`harness.record_of`).
A record of an untraced run, or a program whose tracer has no `collect` or
none of the stage's spans, gives None."""
from __future__ import annotations

# ts and dur are rounded to 1e-3 us
_EPS_US = 1e-2


def events(record):
    """The program's events of the traced window, device times resolved:
    the record's own where it keeps them, else the tracer's now; None for
    an untraced record or a program without `obs.collect`."""
    if record.get("trace") is None:
        return None
    if record.get("events") is not None:
        return record["events"]
    from repro_torch import obs

    collect = getattr(obs, "collect", None)
    return collect() if collect is not None else None


def _spans(evs, name: str) -> list[dict]:
    return [e for e in evs if e.get("ph") == "X" and e["name"] == name]


def _inside(child: dict, parent: dict) -> bool:
    return (child["tid"] == parent["tid"]
            and child["ts"] >= parent["ts"] - _EPS_US
            and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"] + _EPS_US)


def children(record, child: str, parent: str):
    """(the `child` spans inside some `parent` span, the number of `parent`
    spans), or None where either is missing."""
    evs = events(record)
    if not evs:
        return None
    parents = _spans(evs, parent)
    kids = [k for k in _spans(evs, child)
            if any(_inside(k, p) for p in parents)]
    if not parents or not kids:
        return None
    return kids, len(parents)


def host_ms_per_parent(record, child: str, parent: str):
    """Summed host ms of the `child` spans inside `parent` spans, over the
    number of `parent` spans."""
    got = children(record, child, parent)
    if got is None:
        return None
    kids, n = got
    return sum(k["dur"] for k in kids) / 1e3 / n


def device_ms_per_parent(record, child: str, parent: str):
    """Summed device ms of the `child` spans inside `parent` spans, over
    the number of `parent` spans."""
    got = children(record, child, parent)
    if got is None:
        return None
    kids, n = got
    times = [k["args"]["device_ms"] for k in kids
             if "device_ms" in k["args"]]
    return sum(times) / n if times else None


def device_ms_per_unit(record, names):
    """Summed device ms of the spans called one of `names`, over the
    window's rounds or turns."""
    evs = events(record)
    if not evs or not record["units"]:
        return None
    times = [e["args"]["device_ms"] for e in evs
             if e.get("ph") == "X" and e["name"] in names
             and "device_ms" in e["args"]]
    return sum(times) / len(record["units"]) if times else None


def mean_ms(record, name: str, arg: str | None = None, **match):
    """Mean ms of the events called `name` whose args hold `match`: their
    durations, or `arg` (seconds) of each."""
    evs = events(record)
    if not evs:
        return None
    vals = [e["args"][arg] * 1e3 if arg else e["dur"] / 1e3
            for e in evs if e["name"] == name
            and all(e["args"].get(k) == v for k, v in match.items())]
    return sum(vals) / len(vals) if vals else None
