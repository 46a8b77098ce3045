"""The reader of the Mamba-2 SSD's spans (`metrics/ssd_ms.fl.py`) on a
tracer filled as `test_chipbench_stages.fill` fills it, with the model's
`model.ssd_fwd` / `model.ssd_bwd` spans beside the HE stages: their
device time over the window's rounds, and None where the tracer, the record
or the program has nothing for it."""
import math
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent / "src"))
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import harness  # noqa: E402
from test_chipbench_stages import RECORD, fill, span  # noqa: E402

from repro_torch import obs  # noqa: E402

NAME = "ssd_ms.fl"


@pytest.fixture
def tracer():
    obs.configure(enabled=False, trace_path=None, reset=True)
    yield obs.get_tracer()
    obs.configure(enabled=False, trace_path=None, reset=True)


def fill_ssd(tr):
    """Two rounds' worth of one local step: each block's two forwards (the
    remat) and its backward, the forwards' spans nested in a step span."""
    span(tr, "local_train", 90_000, 9_000)
    for t0 in (90_100, 94_000):
        span(tr, "model.ssd_fwd", t0, 100, device_ms=3.0)
        span(tr, "model.ssd_fwd", t0 + 200, 100, device_ms=3.5)
        span(tr, "model.ssd_bwd", t0 + 400, 300, device_ms=8.5)


def read(record=RECORD):
    return harness.metric_reader(NAME).read(record)


def test_the_metric_is_declared_for_the_fl_cell():
    m = next(m for m in harness.benchmark()["per_layer"]
             if m["name"] == NAME)
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == \
        ("ms", "lower", "program_span", "model", "round_s")
    assert m["workloads"] == ["mamba2-370m.fl_train"]


def test_reader_value(tracer):
    fill(tracer)
    fill_ssd(tracer)
    # (3.0 + 3.5 + 8.5) twice over RECORD's two rounds
    assert math.isclose(read(), 2 * 15.0 / 2, rel_tol=1e-9)


def test_reader_finds_nothing(tracer, monkeypatch):
    assert read() is None                      # an empty tracer
    fill(tracer)
    assert read() is None                      # HE stages, no SSD spans
    span(tracer, "model.ssd_fwd", 0, 10)       # a span without device time
    assert read() is None
    fill_ssd(tracer)
    assert read(dict(RECORD, trace=None)) is None     # untraced
    assert read(dict(RECORD, units=[])) is None       # no rounds
    monkeypatch.delattr(obs, "collect")        # a program without it
    assert read() is None
