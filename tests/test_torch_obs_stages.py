"""The port's stage spans and wait timers (`repro_torch.obs`): spans record
under any torch.profiler session with obs disabled, without the kernel
hooks and without a synchronize; their `ts` maps onto the profiler's clock;
the wire, serve and HE client paths emit their stages, nested by
containment, one span per stage and not per chunk; the service times the
wait for its lock and each blob's wait for its fold; and a device span
carries `device_ms` only on a CUDA stream.

Imports no JAX: the stages are the port's own.
"""
import collections
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.ckpt import store as ckpt_store
from repro_torch.core import packing
from repro_torch.core.ckks import cipher, encoding, params
from repro_torch.core.secure_agg import (AggregatorConfig,
                                         SelectiveHEAggregator)
from repro_torch.kernels import ops
from repro_torch.obs import hooks
from repro_torch.serve import quorum as qr
from repro_torch.serve import service as svc_mod
from repro_torch.wire import compress as wc
from repro_torch.wire import format as wf
from repro_torch.wire import stream as ws

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CTX = params.make_test_context(n_poly=256, n_limbs=2, delta_bits=20,
                               device="cpu")
SK, PK = cipher.keygen(CTX, torch.Generator().manual_seed(0))
N_PARAMS = 450
# 128 slots a ciphertext: p = 0.4 encrypts 180 values in 2 chunks, 0.9
# encrypts 405 in 4
P_TWO, P_FOUR = 0.4, 0.9


@pytest.fixture(autouse=True)
def fresh_obs():
    """Obs disabled with a fresh in-memory tracer and registry."""
    obs.configure(enabled=False, trace_path=None, reset=True)
    obs.REGISTRY.reset()
    yield
    obs.configure(enabled=False, trace_path=None, reset=True)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def make_agg(p):
    g = torch.Generator().manual_seed(1)
    m = {"w1": torch.randn(40, 10, generator=g),
         "b1": torch.randn(50, generator=g)}
    sens = torch.rand(N_PARAMS, generator=torch.Generator().manual_seed(3))
    return SelectiveHEAggregator.build(CTX, m, sens,
                                       AggregatorConfig(p_ratio=p)), m


def seeded_upload(agg, m, i=0, codec="f16"):
    c = {k: v + 0.05 * i for k, v in m.items()}
    upd = agg.client_protect_seeded(
        c, SK, torch.Generator().manual_seed(30 + i), a_seed=700 + i)
    return upd, wc.seed_compress(upd.ct, 700 + i), codec


def events_of(body):
    """(body's result, the X and instant events it recorded) under a
    profiler session with obs disabled."""
    obs.configure(reset=True)
    with cpu_profile():
        out = body()
    return out, [e for e in obs.collect() if e["ph"] in ("X", "i")]


def inside(child, parent) -> bool:
    eps = 1e-2       # ts and dur are rounded to 1e-3 us
    return (child["tid"] == parent["tid"] and child is not parent
            and child["ts"] >= parent["ts"] - eps
            and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"] + eps)


def names(evs) -> collections.Counter:
    return collections.Counter(e["name"] for e in evs)


# ---------------------------------------------------------------------------
# (a) the profiler gate, without hooks or synchronizes
# ---------------------------------------------------------------------------


def test_spans_record_under_the_profiler_without_hooks(monkeypatch):
    syncs = []
    monkeypatch.setattr(hooks, "_synchronize", syncs.append)
    x = torch.stack([torch.randint(0, q, (2, CTX.n_poly))
                     for q in CTX.primes], dim=-2).to(torch.int32)
    assert obs.span("outside") is obs.NULL_SPAN
    assert not obs.recording()
    with cpu_profile():
        assert obs.recording() and not obs.enabled()
        with obs.span("wire.stage", k=1) as sp:
            sp.set(done=True)
            ops.ntt_fwd(x, CTX)
            with obs.kernel_launch("fake_op") as kl:
                kl.done(x)
            obs.maybe_block(x)
        obs.event("serve.tick", n=2)
    assert obs.span("outside") is obs.NULL_SPAN
    assert not obs.recording()
    evs = obs.collect()
    assert [(e["name"], e["ph"]) for e in evs] == [("wire.stage", "X"),
                                                    ("serve.tick", "i")]
    assert evs[0]["args"] == {"k": 1, "done": True}
    assert evs[1]["args"] == {"n": 2}
    assert not syncs
    assert not [k for k in obs.REGISTRY.snapshot()
                if k.startswith("kernel")]


def test_worker_thread_spans_record_under_the_profiler():
    """torch's flag is process-wide: a span on another thread records."""
    import threading

    def work():
        with obs.span("serve.worker"):
            pass

    with cpu_profile():
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert [e["name"] for e in obs.collect()] == ["serve.worker"]


# ---------------------------------------------------------------------------
# (b) one clock with the profiler
# ---------------------------------------------------------------------------


def test_to_profiler_ns_lands_on_the_profilers_range():
    with cpu_profile() as prof:
        for _ in range(3):
            torch.ones(8).sum()
        with obs.span("wire.clock"):
            torch.ones(64).sum()
    (ev,) = obs.collect()
    res = prof.profiler.kineto_results
    (rng,) = [e for e in res.events() if e.name() == "wire.clock"]
    assert abs(obs.to_profiler_ns(ev["ts"]) - rng.start_ns()) < 1e6
    assert obs.to_profiler_ns(0.0) == obs.get_tracer().epoch_wall_ns


def test_file_meta_carries_the_wall_epoch(tmp_path):
    import json
    path = tmp_path / "t.jsonl"
    obs.configure(enabled=True, trace_path=str(path))
    with obs.span("s"):
        pass
    obs.flush()
    meta = json.loads(path.read_text().splitlines()[1].rstrip(","))
    assert meta["ph"] == "M"
    assert meta["args"]["epoch_wall_ns"] == obs.get_tracer().epoch_wall_ns


# ---------------------------------------------------------------------------
# (c) the wire's stages: nested, one span per stage at any chunk count
# ---------------------------------------------------------------------------


def pack_events(p):
    agg, m = make_agg(p)
    upd, sct, codec = seeded_upload(agg, m)
    blob, evs = events_of(lambda: ws.pack_update_frames(
        upd, cid=0, n_samples=2, rnd=0, seeded=sct, plain_codec=codec))
    return agg, m, blob, evs


def ingest_events(p):
    agg, m, blob, _ = pack_events(p)
    ing = ws.StreamIngest(CTX)
    _, evs = events_of(lambda: ing.ingest(blob, 1.0))
    return evs


def serialize_events(p):
    agg, m = make_agg(p)
    upd, _, _ = seeded_upload(agg, m)
    return events_of(lambda: wf.serialize_update(upd, plain_codec="f16"))


def deserialize_events(p):
    blob, _ = serialize_events(p)
    return events_of(lambda: wf.deserialize(blob, CTX))


STAGES = {
    "wire.pack": (pack_events, {"wire.d2h": 2, "wire.frames": 2,
                                "wire.codec": 1}),
    "wire.ingest": (ingest_events, {"wire.frames": 1, "wire.h2d": 2,
                                    "wire.flush": 1, "he.expand_a": 1}),
    "wire.serialize": (serialize_events, {"wire.d2h": 2, "wire.frames": 1,
                                          "wire.codec": 1}),
    "wire.deserialize": (deserialize_events, {"wire.frames": 1,
                                              "wire.codec": 1,
                                              "wire.h2d": 1}),
}


def _evs(parent, p):
    got = STAGES[parent][0](p)
    return got[-1] if isinstance(got, tuple) else got


@pytest.mark.parametrize("parent", list(STAGES))
def test_wire_stages_nest_inside_their_parent(parent):
    evs = _evs(parent, P_TWO)
    (top,) = [e for e in evs if e["name"] == parent]
    kids = [e for e in evs if e is not top]
    assert all(inside(e, top) for e in kids)
    assert names(kids) == collections.Counter(STAGES[parent][1])


@pytest.mark.parametrize("parent", list(STAGES))
def test_wire_spans_do_not_grow_with_the_chunk_count(parent):
    assert make_agg(P_TWO)[0].part.n_chunks == 2
    assert make_agg(P_FOUR)[0].part.n_chunks == 4
    assert names(_evs(parent, P_TWO)) == names(_evs(parent, P_FOUR))


def test_spanned_wire_round_trip_keeps_its_bytes():
    """The spans change no byte: pack, serialize and parse give what they
    give with nothing recording."""
    agg, m = make_agg(P_TWO)
    upd, sct, codec = seeded_upload(agg, m)
    kw = dict(cid=0, n_samples=2, rnd=0, seeded=sct, plain_codec=codec)
    plain = ws.pack_update_frames(upd, **kw)
    with cpu_profile():
        spanned = ws.pack_update_frames(upd, **kw)
        down = wf.serialize_update(upd, seeded=sct)
        back, _ = wf.deserialize(down, CTX)
    assert spanned == plain
    assert down == wf.serialize_update(upd, seeded=sct)
    assert torch.equal(back.ct.data, upd.ct.data)
    assert torch.equal(back.plain, upd.plain)


def test_sim_stages_split_encode_merge():
    agg, m = make_agg(P_TWO)
    _, evs = events_of(lambda: agg.client_recover(
        agg.client_protect(m, PK, torch.Generator().manual_seed(5)), SK))
    assert names(evs) == {"he.split": 1, "he.encode": 1, "he.merge": 1}


# ---------------------------------------------------------------------------
# (d) the service's lock and queue waits
# ---------------------------------------------------------------------------


def _service_round(tmp_path, n=3):
    agg, m = make_agg(P_TWO)
    blobs = []
    for i in range(n):
        upd, sct, codec = seeded_upload(agg, m, i)
        blobs.append(ws.pack_update_frames(upd, cid=i, n_samples=2 + i,
                                           rnd=0, seeded=sct,
                                           plain_codec=codec))
    svc = svc_mod.AggregationService(
        CTX, qr.QuorumPolicy(min_clients=n, target_clients=n),
        ckpt_dir=str(tmp_path))
    svc.start(0.001)
    try:
        with cpu_profile():
            rnd = svc.open_round()
            acks = [svc.submit(b) for b in blobs]
            while svc.status(rnd) not in (svc_mod.ST_DONE,
                                          svc_mod.ST_FAILED):
                time.sleep(0.005)
    finally:
        svc.stop()
    assert svc.worker_error is None and all(a.accepted for a in acks)
    assert svc.status(rnd) == svc_mod.ST_DONE
    return svc, n


def test_service_times_lock_and_queue_waits(tmp_path):
    svc, n = _service_round(tmp_path)
    evs = obs.collect()
    waits = [e for e in evs if e["name"] == "serve.queue_wait"]
    assert len(waits) == n == svc.round_info(0)["folded"]
    assert all(e["ph"] == "i" and e["args"]["wait_s"] >= 0 for e in waits)
    locks = [e for e in evs if e["name"] == "serve.lock_wait"]
    assert sum(e["args"]["caller"] == "submit" for e in locks) == n
    assert all(e["args"]["caller"] in ("submit", "step") for e in locks)
    sid = svc.service_id
    h = obs.REGISTRY.get("serve_queue_wait_seconds", service=sid)
    assert h.count == n
    h = obs.REGISTRY.get("serve_lock_wait_seconds", caller="submit",
                         service=sid)
    assert h.count == n
    assert "serve_lock_wait_seconds" in obs.prometheus_text()


def test_service_checkpoint_keeps_its_extra_keys(tmp_path):
    _service_round(tmp_path)
    sx = ckpt_store.read_manifest(str(tmp_path))["extra"]["serve"]
    assert set(sx) == {"label", "next_round", "open_rnd", "rounds",
                       "ledger"}
    rx = sx["rounds"]["0"]
    assert rx["has_result"]
    assert set(rx) == {"status", "sealed_reason", "accepted", "rejected",
                       "bad", "weights", "cursor", "pass_dirty", "refolds",
                       "deadline_remaining", "has_result", "result_scale"}
    assert all(set(r) == {"cid", "n_samples", "nbytes", "path"}
               for r in rx["accepted"])


# ---------------------------------------------------------------------------
# (e) device time
# ---------------------------------------------------------------------------


def test_device_spans_carry_no_device_ms_on_cpu():
    vec = torch.randn(N_PARAMS)
    part = make_agg(P_TWO)[0].part
    with cpu_profile():
        for dev in (True, torch.device("cpu"), "cpu"):
            with obs.span("he.cpu", device=dev):
                vec.sum()
        enc, plain = packing.split_by_mask(vec, part)
        encoding.encode(enc, CTX)
        packing.merge_by_mask(enc, plain, part)
    evs = obs.collect()
    assert [e["name"] for e in evs] == ["he.cpu"] * 3 + [
        "he.split", "he.encode", "he.merge"]
    assert not [e for e in evs if "device_ms" in e["args"]]


@pytest.mark.cuda
def test_device_ms_is_filled_and_finite_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (device spans time CUDA streams)")
    import json
    import math
    dev = torch.device("cuda")
    path = tmp_path / "t.jsonl"
    obs.configure(trace_path=str(path))
    x = torch.randn(1 << 22, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with obs.span("he.card", device=dev):
            for _ in range(8):
                x = torch.sin(x)
        with obs.span("he.current", device=True):
            x.mul_(2)
        with obs.span("he.host", device=torch.device("cpu")):
            x.add_(1)
    evs = {e["name"]: e for e in obs.collect()}
    for name in ("he.card", "he.current"):
        ms = evs[name]["args"]["device_ms"]
        assert math.isfinite(ms) and ms > 0, name
    assert "device_ms" not in evs["he.host"]["args"]
    obs.flush()
    lines = [json.loads(s.rstrip(",")) for s in
             path.read_text().splitlines()[2:]]
    assert {e["name"] for e in lines} == set(evs)
    assert all("device_ms" in e["args"] for e in lines
               if e["name"] != "he.host")
