"""The readers of the program's stage spans (`program_spans.py` and the
metrics that use it) on a tracer filled with events of the recorded shape:
each reader's value, and None where the tracer, the record or the program
has nothing for it."""
import math
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent / "src"))
sys.path.insert(0, str(HERE.parent))

import harness  # noqa: E402
import program_spans  # noqa: E402

from repro_torch import obs  # noqa: E402

RECORD = {"spans": [], "counters": {}, "geometry": {}, "units": [0.5, 0.5],
          "window_s": 1.0, "trace": {"busy_s": 0.5, "kernels": {},
                                     "idle": {}, "n_device_events": 1},
          "device": "cuda"}


@pytest.fixture
def tracer():
    obs.configure(enabled=False, trace_path=None, reset=True)
    yield obs.get_tracer()
    obs.configure(enabled=False, trace_path=None, reset=True)


def span(tr, name, ts, dur, **args):
    tr.emit_complete(name, ts, dur, args=args)


def fill(tr):
    """Two ingests, a round's downlink, two packs and parses, two rounds'
    sim stages, and one of each stage outside its parent (not counted)."""
    for t0, frames, h2d, a_ms in ((0, 1500, 300, 40.0),
                                  (10_000, 1300, 500, 60.0)):
        span(tr, "wire.ingest", t0, 3_000)
        span(tr, "wire.frames", t0 + 10, frames)
        span(tr, "wire.h2d", t0 + 1600, 100, plain=True)
        span(tr, "wire.h2d", t0 + 1700, h2d - 100, rows=4)
        span(tr, "he.expand_a", t0 + 1800, 50, device_ms=a_ms)
    span(tr, "wire.serialize", 20_000, 5_000)
    span(tr, "wire.d2h", 20_000, 800)
    span(tr, "wire.d2h", 21_000, 200)
    for t0 in (30_000, 40_000):
        span(tr, "wire.pack", t0, 5_000)
        span(tr, "wire.d2h", t0, 600)
        span(tr, "wire.frames", t0 + 600, 2_000)
        span(tr, "wire.d2h", t0 + 2_600, 100)
        span(tr, "wire.codec", t0 + 2_700, 300, codec="f16")
        span(tr, "wire.frames", t0 + 3_000, 1_000)
        span(tr, "wire.deserialize", t0 + 5_000, 1_000)
        span(tr, "wire.frames", t0 + 5_000, 400)
        span(tr, "wire.h2d", t0 + 5_500, 450)
    for t0 in (50_000, 60_000):
        span(tr, "he.split", t0, 10, device_ms=3.0)
        span(tr, "he.encode", t0 + 20, 10, device_ms=2.0)
        span(tr, "he.merge", t0 + 40, 10, device_ms=1.0)
    span(tr, "wire.frames", 70_000, 9_999)       # outside any parent
    span(tr, "wire.d2h", 70_000, 9_999)
    span(tr, "wire.h2d", 70_000, 9_999)
    span(tr, "he.expand_a", 70_000, 10, device_ms=999.0)
    for caller, dur in (("submit", 4_000), ("submit", 2_000),
                        ("step", 9_000)):
        span(tr, "serve.lock_wait", 80_000, dur, caller=caller)
    for wait in (0.25, 0.75, 0.5):
        tr.emit_instant("serve.queue_wait", args={"wait_s": wait})


WANT = {
    "ingest_frames_ms.service": (1.5 + 1.3) / 2,
    "ingest_h2d_ms.service": (0.3 + 0.5) / 2,
    "expand_a_ms.service": (40.0 + 60.0) / 2,
    "downlink_d2h_ms.service": 1.0,
    "queue_wait_ms.service": 500.0,
    "lock_wait_ms.service": 3.0,
    "pack_frames_ms.client": 3.0,
    "pack_d2h_ms.client": 0.7,
    "pack_codec_ms.client": 0.3,
    "parse_h2d_ms.client": 0.45,
    "mask_ms.sim": (2 * 3.0 + 2 * 1.0) / 2,
    "encode_ms.sim": 2.0,
}
METRICS = [m for m in harness.benchmark()["per_layer"]
           if m["source"] == "program_span" and m["name"] in WANT]


def read(name, record=RECORD):
    return harness.metric_reader(name).read(record)


def test_every_stage_metric_is_declared():
    assert sorted(m["name"] for m in METRICS) == sorted(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_value(tracer, name):
    fill(tracer)
    got = read(name)
    assert math.isclose(got, WANT[name], rel_tol=1e-9), (name, got)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing(tracer, name, monkeypatch):
    assert read(name) is None                      # an empty tracer
    span(tracer, "wire.ingest", 0, 10)
    span(tracer, "wire.pack", 0, 10)
    span(tracer, "wire.serialize", 0, 10)
    span(tracer, "wire.deserialize", 0, 10)
    assert read(name) is None                      # parents, no stages
    fill(tracer)
    assert read(name, dict(RECORD, trace=None)) is None     # untraced
    monkeypatch.delattr(obs, "collect")            # a program without it
    assert read(name) is None


def test_device_readers_skip_spans_without_device_time(tracer):
    span(tracer, "wire.ingest", 0, 100)
    span(tracer, "he.expand_a", 10, 10)
    span(tracer, "he.split", 200, 10)
    assert read("expand_a_ms.service") is None
    assert read("mask_ms.sim") is None
    assert program_spans.device_ms_per_unit(
        dict(RECORD, units=[]), ("he.split",)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_record_keeps_the_events_it_was_read_from(tracer, name):
    """A traced run's record holds the tracer's events (`record_of`); the
    readers read the record's, and the live tracer only where a record has
    none: both give one value."""
    fill(tracer)
    live = read(name)
    run = harness.Run(1, 0.0, True, "cpu")
    run.window(lambda r: r.units.append(0.5))
    kept = harness.record_of(run, RECORD["trace"])
    assert kept["events"] == obs.collect()
    rec = dict(RECORD, events=kept["events"])
    obs.configure(enabled=False, trace_path=None, reset=True)
    assert read(name) is None                      # the tracer is empty
    assert read(name, rec) == live
    assert harness.record_of(run, None)["events"] is None
