"""The port's telemetry (`repro_torch.obs`): the JAX package's
`tests/test_obs.py` cases that do not rest on JAX-only features (jit
retraces, backend tokens, the orchestrator), plus the port's wiring:
registry-backed `StreamIngest` counters behind read-only properties,
`wire_bytes_total`, the tuner's series, `ShardedHe` kernel_launch spans,
the kernel hooks on every op, a disabled path that synchronizes nothing and
leaves outputs and `launch_counts()` untouched, a port trace that loads in
`tools/round_report.py`, and Prometheus text byte-identical with the JAX
package's for the same series.

The registry is process-global and test files share workers, so every test
here works on series it made after the `registry` fixture reset it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.obs.metrics import MetricsRegistry as JaxRegistry

from repro_torch import obs
from repro_torch.core.ckks import cipher, params
from repro_torch.core.ckks.sharded import ShardedHe
from repro_torch.core.secure_agg import (AggregatorConfig,
                                         SelectiveHEAggregator)
from repro_torch.kernels import ops, tune
from repro_torch.launch.mesh import make_he_mesh
from repro_torch.obs import hooks
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.wire import budget, compress as wc, stream as ws

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import round_report  # noqa: E402  (tools/ has no package)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CTX = params.make_test_context(n_poly=256, n_limbs=2, delta_bits=20,
                               device="cpu")
SK, PK = cipher.keygen(CTX, torch.Generator().manual_seed(0))
KERNEL_OPS = ("ntt_fwd", "ntt_inv", "mul_add", "weighted_sum",
              "weighted_accum", "weighted_accum_chunks", "mod_lift")


@pytest.fixture
def registry():
    """A fresh process registry, obs disabled before and after."""
    obs.configure(enabled=False, trace_path=None, reset=True)
    obs.REGISTRY.reset()
    yield obs.REGISTRY
    obs.configure(enabled=False, trace_path=None, reset=True)


@pytest.fixture
def obs_memory(registry):
    """Obs enabled with an in-memory tracer."""
    obs.configure(enabled=True, trace_path=None, reset=True)
    yield obs.get_tracer()


def small_model(seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"w1": torch.randn(40, 10, generator=g),
            "b1": torch.randn(50, generator=g)}


def make_agg(p=0.4, seed=3):
    m = small_model()
    sens = torch.rand(450, generator=torch.Generator().manual_seed(seed))
    return SelectiveHEAggregator.build(CTX, m, sens,
                                       AggregatorConfig(p_ratio=p)), m


def seeded_blobs(agg, m, n, ledger=None):
    blobs = []
    for i in range(n):
        c = {k: v + 0.05 * i for k, v in m.items()}
        upd = agg.client_protect_seeded(
            c, SK, torch.Generator().manual_seed(30 + i), a_seed=700 + i)
        blobs.append(ws.pack_update_frames(
            upd, cid=i, n_samples=2, rnd=0,
            seeded=wc.seed_compress(upd.ct, 700 + i)))
        if ledger is not None:
            ledger.record_blob(blobs[-1], rnd=0, cid=i,
                               direction=budget.UPLINK)
    return blobs


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_counter_gauge_semantics():
    reg = MetricsRegistry()
    c = reg.counter("reqs", route="a")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    assert reg.counter("reqs", route="b") is not c
    assert reg.counter("reqs", route="a") is c
    assert reg.total("reqs") == 5
    g = reg.gauge("resident")
    g.set(3)
    g.add(2)
    g.set_max(4)
    assert g.value == 5
    g.set_max(9)
    assert g.value == 9
    with pytest.raises(TypeError):
        reg.gauge("reqs", route="a")
    assert reg.get("nope") is None


def test_histogram_percentiles_exact():
    reg = MetricsRegistry()
    h = reg.histogram("lat")
    with pytest.raises(ValueError):
        h.percentile(50)
    for v in range(1, 101):
        h.observe(float(v))
    assert h.count == 100
    assert h.mean == pytest.approx(50.5)
    assert h.percentile(0) == 1.0
    assert h.percentile(100) == 100.0
    assert h.percentile(50) == pytest.approx(
        np.percentile(np.arange(1, 101), 50))
    assert h.percentile(99) == pytest.approx(
        np.percentile(np.arange(1, 101), 99))


def test_prometheus_text_and_snapshot():
    reg = MetricsRegistry()
    reg.counter("ops_total", op="ntt", backend="ref").inc(7)
    reg.histogram("secs", op="ntt").observe(0.5)
    text = reg.prometheus_text()
    assert "# TYPE ops_total counter" in text
    assert 'ops_total{backend="ref",op="ntt"} 7' in text
    assert 'secs{op="ntt",quantile="0.5"}' in text
    assert 'secs_count{op="ntt"} 1' in text
    snap = reg.snapshot()
    assert snap["ops_total"][0]["value"] == 7
    assert snap["secs"][0]["count"] == 1


def test_prometheus_text_and_snapshot_equal_jax():
    """The same series in both registries give byte-identical text."""
    regs = (MetricsRegistry(), JaxRegistry())
    r = np.random.RandomState(0)
    samples = r.rand(300) * 1e-3
    for reg in regs:
        reg.counter("wire_bytes_total", direction="up",
                    kind="ciphertext").inc(123456789)
        reg.counter("wire_bytes_total", direction="down", kind="plain").inc(7)
        reg.counter("fractional_total").inc(0.1)
        reg.gauge("wire_ingest_peak_chunk_buffers", ingest="3").set_max(11)
        reg.gauge("ratio").set(1 / 3)
        reg.histogram("empty_seconds", op="x")
        h = reg.histogram("kernel_op_seconds", op="ntt_fwd", backend="cuda")
        for v in samples:
            h.observe(v)
    assert regs[0].prometheus_text() == regs[1].prometheus_text()
    assert regs[0].snapshot() == regs[1].snapshot()


# ---------------------------------------------------------------------------
# trace spans
# ---------------------------------------------------------------------------


def test_span_nesting_and_ordering(obs_memory):
    tr = obs_memory
    with obs.span("round", round=0) as r:
        with obs.span("client", cid=1):
            assert tr.depth() == 2
        with obs.span("aggregate"):
            pass
        r.set(bytes_up=7)
    assert tr.depth() == 0
    names = [e["name"] for e in tr.events]
    assert names == ["client", "aggregate", "round"]
    rd = tr.events[-1]
    assert rd["ph"] == "X" and rd["args"]["bytes_up"] == 7
    for child in tr.events[:2]:
        assert rd["ts"] <= child["ts"]
        assert child["ts"] + child["dur"] <= rd["ts"] + rd["dur"] + 1e-3
    c0, c1 = tr.events[0], tr.events[1]
    assert c0["ts"] + c0["dur"] <= c1["ts"] + 1e-3


def test_span_records_exception(obs_memory):
    tr = obs_memory
    with pytest.raises(RuntimeError):
        with obs.span("boom"):
            raise RuntimeError("x")
    assert tr.events[-1]["args"]["error"] == "RuntimeError"
    assert tr.depth() == 0


def test_span_is_a_profiler_range(obs_memory):
    """An enabled span is a torch.profiler.record_function of its name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("wire.ingest"):
            torch.ones(3).sum()
    assert "wire.ingest" in {e.name for e in prof.events()}


def test_disabled_span_is_shared_noop(registry):
    sp = obs.span("anything", k=1)
    assert sp is obs.NULL_SPAN
    with sp as s:
        s.set(ignored=True)
    obs.event("nothing")
    assert obs.trace_path() is None
    assert not obs.get_tracer().events


# ---------------------------------------------------------------------------
# trace file -> round_report round trip
# ---------------------------------------------------------------------------


def _synthetic_round(tr):
    """A 1000 us round covered by client (400) + aggregate (600), with one
    kernel launch inside aggregate that nests a second kernel event."""
    tr.emit_complete("local_train", 10, 380, cat="phase", args={"cid": 0})
    tr.emit_complete("client", 0, 400, cat="phase", args={"cid": 0})
    tr.emit_complete("he.weighted_accum_chunks", 460, 50, cat="kernel",
                     args={"op": "weighted_accum_chunks", "token": "ref"})
    tr.emit_complete("he.weighted_accum_chunks", 450, 100, cat="kernel",
                     args={"op": "weighted_accum_chunks", "token": "ref"})
    tr.emit_complete("aggregate", 400, 600, cat="phase", args={})
    tr.emit_complete("round", 0, 1000, cat="phase",
                     args={"round": 3, "bytes_up": 111, "bytes_down": 222,
                           "launches": 1})


def _report(path, *flags):
    return subprocess.run(
        [sys.executable, os.path.join("tools", "round_report.py"), path,
         *flags], cwd=ROOT, capture_output=True, text=True, timeout=120)


def test_round_report_roundtrip(tmp_path, registry):
    path = str(tmp_path / "trace.jsonl")
    obs.configure(enabled=True, trace_path=path, reset=True)
    _synthetic_round(obs.get_tracer())
    obs.get_tracer().close()
    with open(path) as f:
        raw = f.read()
    assert raw.startswith("[\n")
    json.loads(raw.rstrip().rstrip(",") + "]")
    proc = _report(path, "--json", "--min-coverage", "0.9")
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout)
    (rnd,) = rep["rounds"]
    assert rnd["round"] == 3
    assert rnd["wall_ms"] == pytest.approx(1.0)
    assert rnd["client"] == pytest.approx(0.4)
    assert rnd["aggregate"] == pytest.approx(0.6)
    assert rnd["bytes_up"] == 111 and rnd["bytes_down"] == 222
    assert rnd["launches"] == 1
    assert rnd["coverage"] == pytest.approx(1.0)
    (k,) = rep["kernels"]
    assert k["op"] == "weighted_accum_chunks" and k["count"] == 1
    assert k["total_ms"] == pytest.approx(0.1)


def test_round_report_rejects_low_coverage(tmp_path, registry):
    path = str(tmp_path / "trace.jsonl")
    obs.configure(enabled=True, trace_path=path, reset=True)
    tr = obs.get_tracer()
    tr.emit_complete("client", 0, 100, cat="phase", args={})
    tr.emit_complete("round", 0, 1000, cat="phase", args={"round": 0})
    tr.close()
    proc = _report(path, "--min-coverage", "0.9")
    assert proc.returncode == 1
    assert "below coverage" in proc.stderr


def test_round_report_empty_trace_fails(tmp_path):
    path = tmp_path / "empty.jsonl"
    path.write_text("[\n")
    assert _report(str(path)).returncode == 1


def test_port_round_trace_loads_in_round_report(tmp_path, registry):
    """A real round of the port (protect, ingest, recover) traced to a
    file: parse_trace and build_tree rebuild it, with one he.<op> kernel
    span per hooked op launch and the ingest spans in the round."""
    path = str(tmp_path / "round.jsonl")
    obs.configure(enabled=True, trace_path=path, reset=True)
    agg, m = make_agg()
    with obs.span("round", round=0):
        with obs.span("client"):
            blobs = seeded_blobs(agg, m, 2)
        with obs.span("aggregate"):
            ing = ws.StreamIngest(CTX)
            for b in blobs:
                ing.ingest(b, 0.5)
            glob = ing.finalize()
        with obs.span("recover"):
            agg.client_recover(glob, SK)
    obs.flush()
    events = round_report.parse_trace(path)
    roots = round_report.build_tree(events)
    (row,) = round_report.round_rows(roots)
    assert row["coverage"] > 0.9
    hooked = [e for e in events if e.get("cat") == "kernel"
              and e["args"].get("backend") == "ref"]
    total = sum(c.value for c in
                obs.REGISTRY.series("kernel_op_launches_total"))
    assert len(hooked) == total > 0
    assert {e["name"] for e in hooked} >= {"he.ntt_fwd", "he.mul_add",
                                           "he.ntt_inv"}
    assert sum(e["name"] == "wire.ingest" for e in events) == 2
    flushes = [e for e in events
               if e["name"] == "he.sharded.weighted_accum_chunks"]
    assert len(flushes) == 2 and all(e["parent"] is not None
                                     for e in flushes)
    ntt = [e for e in hooked if e["name"] == "he.ntt_fwd"]
    assert all(e["args"]["config"]["ntt4_split"] is None for e in ntt)


# ---------------------------------------------------------------------------
# registry-backed counters of the wire layer and the tuner
# ---------------------------------------------------------------------------


def test_stream_counters_are_registry_backed(registry):
    agg, m = make_agg()
    n = 3
    blobs = seeded_blobs(agg, m, n)
    ing = ws.StreamIngest(CTX)
    for b in blobs:
        ing.ingest(b, 1.0 / n)
    with pytest.raises(Exception):
        ing.ingest(blobs[0][:-5], 0.1)          # rejected, rolled back
    ing.finalize()
    assert ing.clients_ingested == n
    assert ing.accum_launches == n
    assert ing.peak_chunk_buffers == agg.part.n_chunks
    assert ing.bytes_ingested == sum(len(b) for b in blobs)
    assert ing.rejected_updates == 1
    lab = {"ingest": ing.ingest_id}
    for series, prop in (("wire_ingest_accum_launches", "accum_launches"),
                         ("wire_ingest_clients", "clients_ingested"),
                         ("wire_ingest_bytes", "bytes_ingested"),
                         ("wire_ingest_peak_chunk_buffers",
                          "peak_chunk_buffers"),
                         ("wire_ingest_rejected_updates",
                          "rejected_updates")):
        assert obs.REGISTRY.get(series, **lab).value == getattr(ing, prop)
        with pytest.raises(AttributeError):
            setattr(ing, prop, 0)
    assert obs.REGISTRY.get("wire_ingest_resident_chunks", **lab).value == 0
    # a restored ingest resumes its own series at the checkpoint's counts
    other = ws.StreamIngest(CTX)
    assert other.ingest_id != ing.ingest_id
    other.restore_state(*ing.export_state())
    olab = {"ingest": other.ingest_id}
    assert obs.REGISTRY.get("wire_ingest_clients", **olab).value == n
    assert obs.REGISTRY.get("wire_ingest_rejected_updates",
                            **olab).value == 1
    assert obs.REGISTRY.total("wire_ingest_clients") == 2 * n


def test_wire_bytes_total_follows_the_ledger(registry):
    agg, m = make_agg()
    ledger = budget.BandwidthLedger()
    seeded_blobs(agg, m, 2, ledger)
    ledger.record(rnd=0, cid=0, direction=budget.DOWNLINK,
                  kind=budget.K_CIPHERTEXT, nbytes=1000)
    for s in obs.REGISTRY.series("wire_bytes_total"):
        lab = dict(s.labels)
        assert s.value == ledger.total(direction=lab["direction"],
                                       kind=lab["kind"])
    assert obs.REGISTRY.total("wire_bytes_total") == ledger.total()


def test_tuner_series(registry, tmp_path):
    res = tune.sweep_op("ntt_fwd", CTX, 1, torch.Generator().manual_seed(0),
                        reps=1)
    try:
        assert obs.REGISTRY.get("tune_sweeps_total", op="ntt_fwd").value == 1
        measured = sum(h.count for h in
                       obs.REGISTRY.series("tune_candidate_seconds"))
        assert measured == res.n_candidates - res.n_pruned
        bad = tmp_path / "cache.json"
        bad.write_text("{not json")
        with pytest.warns(RuntimeWarning):
            assert tune.load_cache(str(bad)) == 0
        assert obs.REGISTRY.get("tune_cache_load_errors_total").value == 1
    finally:
        tune.clear_cache()


def test_sharded_dispatches_are_kernel_launches(obs_memory):
    mesh = make_he_mesh(CTX.n_limbs, devices=[torch.device("cpu")] * 4)
    eng = ShardedHe(CTX, mesh)
    sk, pk = eng.keygen(torch.Generator().manual_seed(1))
    vals = torch.randn(3, CTX.slots, generator=torch.Generator())
    ct = eng.encrypt_values(pk, vals, torch.Generator().manual_seed(2))
    agg = eng.weighted_sum(cipher.Ciphertext(
        torch.stack([ct.data.assemble("cpu")] * 2), ct.scale), [0.5, 0.5])
    eng.weighted_accum(agg, agg, 1.0)
    eng.decrypt_to_coeffs(sk, agg)
    eng.encrypt_values_seeded(sk, vals, torch.Generator(), a_seed=5)
    names = [e["name"] for e in obs_memory.events
             if e.get("cat") == "kernel" and "backend" not in e["args"]]
    assert names == ["he.sharded.keygen", "he.sharded.encrypt_values",
                     "he.sharded.weighted_sum", "he.sharded.weighted_accum",
                     "he.sharded.decrypt",
                     "he.sharded.encrypt_values_seeded"]
    rows = [e["args"].get("rows") for e in obs_memory.events
            if e["name"] == "he.sharded.encrypt_values"]
    assert rows == [3]
    assert obs.REGISTRY.get("kernel_launches_total", op="sharded.keygen",
                            backend="").value == 1


# ---------------------------------------------------------------------------
# the ops hook: do no harm disabled, record enabled
# ---------------------------------------------------------------------------


def _every_op(seed=0):
    """One call of each kernel op on small CPU inputs -> outputs."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: cipher.sample_uniform(g, s, CTX)  # noqa: E731
    x, z = u(2, CTX.n_poly), u(2, CTX.n_poly)
    w = torch.from_numpy(np.asarray([[3, 5], [7, 11]], np.int32))
    cts = u(2, 2, CTX.n_poly)
    words = torch.randint(-2 ** 31, 2 ** 31, (2, CTX.n_poly), generator=g,
                          dtype=torch.int32)
    return [ops.ntt_fwd(x, CTX), ops.ntt_inv(x, CTX),
            ops.mul_add(x, z[:1], z, CTX),
            ops.weighted_sum(cts, w, CTX),
            ops.weighted_accum(z, x, w[0], CTX),
            ops.weighted_accum_chunks(cts[0], cts[1], w, CTX),
            ops.mod_lift(words, 2, CTX)]


def test_disabled_obs_leaves_dispatch_untouched(registry, monkeypatch):
    syncs = []
    monkeypatch.setattr(hooks, "_synchronize", syncs.append)
    ops.reset_launch_counts()
    want = _every_op()
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    with obs.span("s"), obs.kernel_launch("k") as kl:
        kl.done(want)
        obs.maybe_block(want)
    assert not syncs
    assert not [k for k in obs.REGISTRY.snapshot() if k.startswith("kernel")]
    assert not obs.get_tracer().events
    # the same ops with obs enabled give the same bits
    obs.configure(enabled=True)
    got = _every_op()
    assert syncs
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_enabled_dispatch_records(obs_memory):
    _every_op()
    for op in KERNEL_OPS:
        c = obs.REGISTRY.get("kernel_op_launches_total", op=op,
                             backend="ref")
        assert c is not None and c.value == 1, op
        h = obs.REGISTRY.get("kernel_op_seconds", op=op, backend="ref")
        assert h is not None and h.count == 1
    evs = [e for e in obs_memory.events if e.get("cat") == "kernel"]
    assert [e["args"]["op"] for e in evs] == list(KERNEL_OPS)
    assert all(e["args"]["backend"] == "ref" for e in evs)
    assert evs[0]["args"]["config"] == tune.default_config(
        "ntt_fwd").to_json()
    assert "config" not in evs[2]["args"]


def test_kernel_launch_context_manager(obs_memory):
    with obs.kernel_launch("fake_op", rows=3) as kl:
        out = kl.done(torch.ones(2, 2))
    assert float(out.sum()) == 4.0
    ev = [e for e in obs_memory.events if e.get("cat") == "kernel"][-1]
    assert ev["args"] == {"op": "fake_op", "rows": 3}
    h = obs.REGISTRY.get("kernel_launch_seconds", op="fake_op", backend="")
    assert h is not None and h.count == 1


def test_maybe_block_synchronizes_only_cuda_tensors(obs_memory,
                                                    monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    x = torch.ones(3)
    assert obs.maybe_block({"a": [x, (x,)]}) is not None
    assert seen == []
    assert hooks._cuda_devices(cipher.Ciphertext(x), set()) == set()


def test_provenance_and_dump(tmp_path, registry):
    p = obs.provenance()
    assert p["obs_version"] == obs.OBS_VERSION
    assert p["platform"] == ("gpu" if torch.cuda.device_count() else "cpu")
    assert p["device_count"] >= 1 and isinstance(p["device_kind"], str)
    assert set(p["tune"]) == {"generation", "cache_path", "entries"}
    obs.counter("x_total", a="1").inc(2)
    path = tmp_path / "metrics.prom"
    obs.dump_metrics(str(path))
    assert path.read_text() == obs.prometheus_text()
    assert 'x_total{a="1"} 2' in obs.prometheus_text()
