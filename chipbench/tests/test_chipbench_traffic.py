"""Each traffic mix driven at a smoke size on the CPU through the kernels'
plain versions: the whole run but the look for a card, its check passing;
then with the timed path broken underneath, and with each lower-precision
control of its kind, the check failing.  A cell's smoke configuration,
traffic and limits are found by its names (`smoke_cells.py`)."""
import pathlib
import sys

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent / "src"))
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import calibrate  # noqa: E402
import faults  # noqa: E402
import harness  # noqa: E402
import run as runner  # noqa: E402
import smoke_cells  # noqa: E402

SEED = 2 ** 33 + 5
# every traffic mix of the benchmark, with the cell that runs it
CELLS = {w["traffic"]: w for w in harness.benchmark()["workloads"]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_run(traffic_name, trace=False, seconds=0.3, **control):
    cell = CELLS[traffic_name]
    run = harness.Run(SEED, seconds, trace, "cpu")
    out = runner.execute(cell, smoke_cells.config(cell),
                         smoke_cells.traffic(traffic_name), run, control)
    correct, checks = runner.judge(out.pop("numbers"),
                                   smoke_cells.limits(cell["name"]))
    return correct, checks, out


@pytest.mark.parametrize("traffic_name", sorted(CELLS))
def test_traffic_runs_and_checks_correct(traffic_name):
    correct, checks, out = smoke_run(traffic_name)
    assert correct, checks
    assert set(checks) == set(harness.limits(CELLS[traffic_name]["name"]))
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("traffic_name", sorted(CELLS))
def test_traced_run_reads_its_spans(traffic_name):
    correct, _, out = smoke_run(traffic_name, trace=True)
    assert correct
    assert "breakdown" in out and out["device"]["window_s"] > 0
    spans = [k for k in out["metrics"] if k.endswith("_ms." + traffic_name
                                                      .split("_")[0])]
    assert spans, out["metrics"]


# each traffic mix with each control and planted fault of its kind, as
# calibrate.py names them: (traffic, name, Cell arguments, planter)
CONTROLS = [(t, name, kw, plant) for t in sorted(CELLS)
            for name, (kw, plant) in
            calibrate.controls(smoke_cells.kind_of(CELLS[t])).items()
            if name != "none"]


def test_the_controls_of_the_first_benchmark_stay():
    pairs = {(t, name) for t, name, _, _ in CONTROLS}
    assert {("sim_k3", "delta20"), ("sim_k3", "bf16"), ("sim_k8", "delta20"),
            ("service", "delta20"), ("service", "i8"), ("client", "delta20"),
            ("client", "i8"), ("client", "bf16")} <= pairs
    assert dict((n, kw) for t, n, kw, _ in CONTROLS if t == "client") == {
        "delta20": {"delta_bits": 20}, "i8": {"plain_codec": "i8"},
        "bf16": {"substitute": "bfloat16"}}


@pytest.mark.parametrize("traffic_name,name,control,plant", CONTROLS,
                         ids=[f"{t}-{n}" for t, n, _, _ in CONTROLS])
def test_lower_precision_control_is_not_correct(traffic_name, name, control,
                                                plant):
    with plant():
        correct, checks, _ = smoke_run(traffic_name, **control)
    assert not correct, checks


def _aggregate_fault(kind):
    from repro_torch.core import secure_agg

    real = secure_agg.SelectiveHEAggregator.server_aggregate

    def unchanged(self, updates, weights, sharded=None):
        return updates[0]

    def half(self, updates, weights, sharded=None):
        h = max(1, len(updates) // 2)
        w = [x / sum(weights[:h]) for x in weights[:h]]
        return real(self, updates[:h], w)

    return {"unchanged": unchanged, "half": half}[kind]


@pytest.mark.parametrize("traffic_name", ["sim_k3", "sim_k8"])
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_sim_fault_is_caught(monkeypatch, traffic_name, fault):
    from repro_torch.core import secure_agg

    monkeypatch.setattr(secure_agg.SelectiveHEAggregator, "server_aggregate",
                        _aggregate_fault(fault))
    correct, checks, _ = smoke_run(traffic_name)
    assert not correct, checks


def test_altered_answer_is_caught(monkeypatch):
    from repro_torch.core import secure_agg

    real = secure_agg.SelectiveHEAggregator.client_recover

    def altered(self, agg, sk, sharded=None):
        out = real(self, agg, sk)
        out[len(out) // 2] += 0.01
        return out

    monkeypatch.setattr(secure_agg.SelectiveHEAggregator, "client_recover",
                        altered)
    for name in ("sim_k3", "client", "fl_k3"):
        correct, checks, _ = smoke_run(name)
        assert not correct, (name, checks)


def test_service_fault_is_caught(monkeypatch):
    """Half of each round's uploads left out of the fold, the rest
    weighted double (the mean over the rest)."""
    from repro_torch.wire import stream

    real = stream.StreamIngest.ingest

    def half(self, blob, weight):
        self._calls = getattr(self, "_calls", 0) + 1
        if self._calls % 2 == 0:
            return stream.peek_update_meta(blob)
        return real(self, blob, 2 * weight)

    monkeypatch.setattr(stream.StreamIngest, "ingest", half)
    correct, checks, _ = smoke_run("service")
    assert not correct, checks


@pytest.mark.parametrize("where", ["downlink", "uplink"])
def test_altered_blob_is_caught(monkeypatch, where):
    """One ciphertext word altered where the blob is produced."""
    from repro_torch.wire import format as wf
    from repro_torch.wire import stream

    def alter(blob):
        b = bytearray(blob)
        b[len(b) // 3] ^= 0x40
        return bytes(b)

    if where == "downlink":
        real = wf.serialize_update
        monkeypatch.setattr(wf, "serialize_update",
                            lambda *a, **k: alter(real(*a, **k)))
        name = "service"
    else:
        real = stream.pack_update_frames
        monkeypatch.setattr(stream, "pack_update_frames",
                            lambda *a, **k: alter(real(*a, **k)))
        name = "client"
    correct, checks, _ = smoke_run(name)
    assert not correct, checks


def test_a_minted_blob_equals_the_programs_rewrite():
    """The fleet's one-copy header rewrite gives the bytes of the port's
    serve.sim.rewrite_begin, which the benchmark's copy replaces."""
    import struct

    from repro_torch.serve import sim

    import fleet

    blob = (b"RPWR" + bytes([2, 6, 0, 0]) + struct.pack("<Q", 17)
            + struct.pack("<IIIIB", 1, 2, 3, 4, 1) + b"payload" * 5)
    assert fleet.rewrite_begin(blob, 9, 33, 5) == sim.rewrite_begin(
        blob, cid=9, n_samples=33, rnd=5)
    f = fleet.Fleet([blob, blob[:-1]], [10, 20, 30])
    assert f.blob(1, 4) == sim.rewrite_begin(blob[:-1], cid=1, n_samples=20,
                                             rnd=4)


@pytest.mark.parametrize("fault", ["unchanged_state",
                                   "recovered_unchanged"])
def test_fl_fault_is_caught(fault):
    """The training round's faults that the kind's FAULTS do not hold
    (those run with its controls above): a local step that returns its
    state unchanged; the recovered model returned unchanged."""
    with getattr(faults, fault)():
        correct, checks, _ = smoke_run("fl_k3")
    assert not correct, checks


PLANTERS = ["one_step", "half_batch", "one_left_out", "grad_flip",
            "unchanged_state", "recovered_unchanged"]


@pytest.mark.parametrize("fault", PLANTERS)
def test_a_planted_fault_is_undone(fault):
    """Each planter puts back what it patched, also when the run inside it
    raises."""
    from repro_torch.core import secure_agg
    from repro_torch.fl import client

    owners = [(client, "adamw_update"), (client.FLClient, "local_train"),
              (client.FLClient, "_next_batch"),
              (secure_agg.SelectiveHEAggregator, "server_aggregate"),
              (secure_agg.SelectiveHEAggregator, "client_recover_params")]
    before = [getattr(o, n) for o, n in owners]
    with pytest.raises(RuntimeError):
        with getattr(faults, fault)():
            assert [getattr(o, n) for o, n in owners] != before
            raise RuntimeError("inside")
    assert [getattr(o, n) for o, n in owners] == before
