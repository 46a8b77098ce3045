"""BENCHMARK.json resolves to its files; the benchmark's modules import
neither JAX nor the JAX package (the reference not even the program); the
roofline counts equal the shapes' arithmetic at the main path's sizes."""
import ast
import math
import pathlib
import re
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(BENCH))

import harness  # noqa: E402
import inputs  # noqa: E402
from roofline import (mul_add, ntt_fwd, peaks, rounds,  # noqa: E402
                      train, weighted_accum_chunks)

B = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the numbers of the first benchmark's kinds, pinned: a kind declares its
# own (`NUMBERS`), and these may not lose one
KIND_NUMBERS = {
    "sim": {"leaves_wrong", "rec_enc_err", "rec_plain_err", "enc_err"},
    "service": {"downlink_len_err", "downlink_layout_err", "folded_err",
                "plain_err", "enc_err"},
    "client": {"leaves_wrong", "rec_enc_err", "rec_plain_err",
               "uplink_len_err", "uplink_layout_err", "uplink_plain_err",
               "uplink_enc_err"},
}


def test_keys_and_names():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["chipbench"]
    assert B["command"] == ["python3", "chipbench/run.py"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("cfg", B["configs"], ids=lambda c: c["name"])
def test_config_file_resolves(cfg):
    path = ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("chipbench/")
    c = harness.load_json(path)
    assert c["name"] == cfg["name"] and c["source"] == cfg["source"]
    assert c["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert key in c and not key.endswith(("_dim", "_rank"))
    assert inputs.n_params(c) == c["n_params"]
    assert c["ckks"] == {"n_poly": 8192, "n_limbs": 2, "delta_bits": 26,
                         "max_prime_bits": 30, "error_sigma": 3.2}
    paths = [lf["path"] for lf in c["leaves"]]
    assert paths == sorted(paths, key=lambda p: p.split("/"))


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    assert w["chips"] == 1
    assert (BENCH / "configs" / f"{w['config']}.json").is_file()
    traffic = harness.load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    kind = harness.kind(traffic)
    assert "limits" not in traffic
    assert set(harness.limits(w["name"])) == set(kind.NUMBERS)
    assert kind.CONTROLS and all(isinstance(kw, dict)
                                 for kw in kind.CONTROLS.values())
    e2e = {m["name"] for m in B["end_to_end"]
           if w["name"] in m.get("workloads", [w["name"]])}
    assert "setup_s" in e2e and set(kind.METRICS) <= e2e
    assert len(e2e) >= 2
    layers = [m for m in B["per_layer"]
              if w["name"] in m.get("workloads", [w["name"]])]
    assert layers
    for m in layers:
        assert m["moves"] in e2e
    assert len(w["why"]) <= 200


@pytest.mark.parametrize("name", sorted(KIND_NUMBERS))
def test_the_first_kinds_numbers_are_pinned(name):
    kind = harness.kind({"kind": name})
    assert set(kind.NUMBERS) == KIND_NUMBERS[name]
    assert len(kind.NUMBERS) == len(set(kind.NUMBERS))


def _kind_of(w):
    return harness.kind(harness.load_json(BENCH / "traffic"
                                          / f"{w['traffic']}.json"))


MODEL_CELLS = [w for w in B["workloads"]
               if hasattr(_kind_of(w), "port_config")]


@pytest.mark.parametrize("w", MODEL_CELLS, ids=lambda w: w["name"])
def test_a_model_cells_configuration_is_the_ports_tree(w):
    """A kind that builds the port's model checks at set-up that its tree
    has the configuration's leaves; here on the meta device."""
    kind = _kind_of(w)
    from repro_torch import models

    cfg = harness.load_json(BENCH / "configs" / f"{w['config']}.json")
    tree = models.build_model(kind.port_config(cfg),
                              device="cpu").init_abstract()
    assert kind.tree_shapes(tree) == [(p, s) for p, s, _, _ in
                                      inputs.leaves(cfg)]


def test_limits_are_each_cells_own():
    files = {p.stem for p in harness.LIMITS.glob("*.json")}
    assert files == {w["name"] for w in B["workloads"]}


def test_a_cell_without_limits_of_its_own_is_refused(monkeypatch, tmp_path,
                                                     capsys):
    import run as runner

    monkeypatch.setattr(harness, "LIMITS", tmp_path)
    name = B["workloads"][0]["name"]
    with pytest.raises(LookupError, match="no limits of its own"):
        harness.limits(name)
    rc = runner.main(["--workload", name, "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 5 and out.out == "" and "no limits" in out.err


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_resolves(m):
    reader = harness.metric_reader(m["name"])
    assert reader.UNIT == m["unit"]
    assert reader.read({"spans": [], "counters": {}, "geometry": {},
                        "units": [], "window_s": 1.0, "trace": None,
                        "device": "cpu"}) is None
    for name in m["workloads"]:
        assert name in {w["name"] for w in B["workloads"]}


def test_end_to_end_bounds():
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    assert 1 <= B["run_seconds"] <= 51


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = _imports(path)
    assert not found & FORBIDDEN, found
    if path.parent.name == "reference":
        assert "repro_torch" not in found, found
        assert not found & {"harness", "kinds", "run", "calibrate"}, found


def test_the_import_check_compares_whole_top_level_names():
    assert "repro_torch" not in FORBIDDEN
    assert harness.FORBIDDEN == tuple(sorted(FORBIDDEN, key=(
        "jax", "jaxlib", "flax", "repro").index))


CARD = {"sms": 132, "max_sm_mhz": 1980.0}
ROWS, L, N = 11_328, 2, 8192


def test_kernel_counts_equal_the_shapes_arithmetic():
    elems = ROWS * L * N
    bf = (N // 2) * 13 * ROWS * L
    rate = 132 * 64 * 1980e6
    assert ntt_fwd.least_seconds(ROWS, L, N, CARD) == max(
        4 * (2 * elems + L * N + 2 * L) / 3.35e12, 3 * bf / rate,
        5 * bf / rate)
    assert mul_add.least_seconds(ROWS, L, N, CARD) == max(
        4 * (3 * elems + L * N + 2 * L) / 3.35e12, 3 * elems / rate,
        3 * elems / rate)
    acc = 2 * elems
    assert weighted_accum_chunks.least_seconds(ROWS, L, N, CARD) == max(
        4 * (3 * acc + ROWS * L + 2 * L) / 3.35e12, 3 * acc / rate,
        3 * acc / rate)
    # the main path's bounds as the kernel table of PERF.md gives them
    assert math.isclose(ntt_fwd.least_seconds(ROWS, L, N, CARD) * 1e3,
                        0.443, rel_tol=2e-3)
    assert math.isclose(mul_add.least_seconds(ROWS, L, N, CARD) * 1e3,
                        0.665, rel_tol=2e-3)
    assert math.isclose(
        weighted_accum_chunks.least_seconds(ROWS, L, N, CARD) * 1e3, 1.330,
        rel_tol=2e-3)


def test_round_counts_are_bounded_by_their_bytes():
    g = {"rows": 8991, "n_limbs": 2, "n_poly": 8192, "n_plain": 331_427_174,
         "n_params": 368_252_416, "clients": 8}
    ct = 8991 * 2 * 2 * 8192 * 4
    pl, vec = 4 * g["n_plain"], 4 * g["n_params"]
    want = (8 * (vec + ct + pl) + 8 * (ct + pl) + (ct + pl) + (ct + pl + vec))
    assert rounds.sim_round(g, CARD) >= want / peaks.HBM_BYTES_PER_S
    assert rounds.service_round(g, CARD) > 0
    assert rounds.client_turn(g, CARD) > 0


def test_training_flops_are_the_shapes_arithmetic():
    """mamba2-370m at 32 x 2,048 tokens: 6 x (48 layers' projections + the
    tied unembedding) x tokens, and the SSD's four matmuls x 3."""
    cfg = harness.load_json(BENCH / "configs" / "mamba2-370m.json")
    g = {"leaves": [[lf["path"], lf["shape"]] for lf in cfg["leaves"]],
         "rows": 32, "seq": 2048, "ssm_chunk": 256, "family": "ssm"}
    d, din, n, h, p, q = 1024, 2048, 128, 32, 64, 256
    dense = 48 * (d * (2 * din + 2 * n + h) + din * d) + 50_304 * d
    ssd = 48 * (2 * q * n + 2 * q * h * p + 4 * n * h * p)
    tokens = 32 * 2048
    assert train.step_flops(g) == 6.0 * dense * tokens + 3.0 * ssd * tokens
    assert math.isclose(train.step_flops(g) / 1e12, 164.98, rel_tol=1e-4)
    assert peaks.BF16_DENSE_FLOPS == 989.4e12
    one_step_s = train.step_flops(g) / peaks.BF16_DENSE_FLOPS
    assert math.isclose(train.mfu_pct(g, 3, 30 * one_step_s), 10.0)
