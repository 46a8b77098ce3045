"""Each per-layer metric reader on a record of a traced run on the H100
(`calibrate.py --record`, one short window of each cell family), and on a
record with nothing to read."""
import math
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import harness  # noqa: E402
import readers  # noqa: E402

METRICS = harness.benchmark()["per_layer"]


def record(family: str) -> dict:
    return harness.load_json(HERE / "fixtures" / f"record.{family}.json")


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_reader_on_a_recorded_trace(m):
    family = m["name"].rsplit(".", 1)[1]
    rec = record(family)
    val = harness.metric_reader(m["name"]).read(rec)
    assert val is not None and math.isfinite(val), m["name"]
    if m["unit"] == "%":
        assert 0 <= val <= 100, (m["name"], val)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert val > 0
    else:
        assert val > 0


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_reader_finds_nothing_in_an_untraced_record(m):
    family = m["name"].rsplit(".", 1)[1]
    rec = dict(record(family), trace=None, spans=[], counters={})
    assert harness.metric_reader(m["name"]).read(rec) is None


def test_idle_and_span_arithmetic():
    rec = record("sim")
    want = 100 * (1 - rec["trace"]["busy_s"] / rec["window_s"])
    assert readers.device_idle_pct(rec) == want
    durs = [d for n, d in rec["spans"] if n == "bench.protect"]
    assert readers.mean_span_ms(rec, "bench.protect") == \
        1e3 * sum(durs) / len(durs)
    assert readers.mean_span_ms(rec, "bench.nothing") is None


def test_spans_are_recorded_in_the_traced_window_only():
    run = harness.Run(1, 0.0, True, "cpu")
    with run.span("bench.protect"):
        pass                               # set-up's warm-up

    def body(r):
        with r.span("bench.protect"):
            pass
        r.units.append(0.0)

    run.window(body)
    assert [n for n, _ in run.spans] == ["bench.protect"]
    assert [n for n, _, _ in run.host_spans] == ["bench.protect"]
