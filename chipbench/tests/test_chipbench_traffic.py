"""Each traffic mix driven at a smoke size on the CPU through the kernels'
plain versions: the whole run but the look for a card, its check passing;
then with the timed path broken underneath, and with each lower-precision
control, the check failing."""
import pathlib
import sys

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent / "src"))
sys.path.insert(0, str(HERE.parent))

import harness  # noqa: E402
import run as runner  # noqa: E402

SEED = 2 ** 33 + 5
SMOKE = harness.load_json(HERE / "fixtures" / "smoke.json")
# limits at the smoke size, set from readings there as the cells' are
SMOKE_LIMITS = harness.load_json(HERE / "fixtures" / "smoke_limits.json")
# every traffic mix of the benchmark, with the cell that runs it
CELLS = {w["traffic"]: w for w in harness.benchmark()["workloads"]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_run(traffic_name, trace=False, seconds=0.3, **control):
    traffic = harness.load_json(HERE.parent / "traffic"
                                / f"{traffic_name}.json")
    cell = CELLS[traffic_name]
    run = harness.Run(SEED, seconds, trace, "cpu")
    substitute = control.pop("substitute", None)
    out, _ = runner.execute(cell, SMOKE, traffic, run, control, substitute)
    correct, checks = runner.judge(out.pop("numbers"),
                                   SMOKE_LIMITS[cell["name"]])
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


CONTROLS = [("sim_k3", {"delta_bits": 20}), ("sim_k3",
                                             {"substitute": torch.bfloat16}),
            ("sim_k8", {"delta_bits": 20}),
            ("service", {"delta_bits": 20}), ("service",
                                              {"plain_codec": "i8"}),
            ("client", {"delta_bits": 20}), ("client",
                                             {"plain_codec": "i8"}),
            ("client", {"substitute": torch.bfloat16})]


@pytest.mark.parametrize("traffic_name,control", CONTROLS)
def test_lower_precision_control_is_not_correct(traffic_name, control):
    correct, checks, _ = smoke_run(traffic_name, **dict(control))
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
    for name in ("sim_k3", "client"):
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
