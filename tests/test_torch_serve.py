"""The port's aggregation service (serve.faults, serve.sim, serve.service)
against the JAX package's, on the CPU at N = 256 (delta 2^20), on the
same JAX-encrypted template blobs as tests/test_serve.py.

  * the 22 tests of tests/test_serve.py, on the port: the clean round,
    every door reject, every fault mode, reorder, deadline and below
    quorum, overlap, the worker thread, each crash point plus mid-fold with
    faults, resume without a checkpoint, the quorum properties and
    FLServer's shared staleness law.  "Bit-identical" there means the
    port's service against the port's synchronous StreamIngest;
  * against JAX live: corrupt_blob's bytes for every mode and two seeds,
    the Fleet's blobs, the service's aggregate under every fault mode
    (residues, plain sum and scale bit for bit, through interop), and a
    checkpoint crashed at after_fold_step by one package and finished by
    the other, in both directions, equal to the uninterrupted run;
  * the worker's bounded stop, and the checkpoint's JSON fields.
"""
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hyp import given, settings, st

from repro import serve as jserve
from repro.core.ckks import cipher as jcipher
from repro.core.ckks import params as jparams
from repro.core.secure_agg import ProtectedUpdate as JUpdate
from repro.serve import faults as jfaults
from repro.serve import sim as jsim
from repro.wire import budget as jwb
from repro.wire import stream as jws

from repro_torch import interop, obs, serve
from repro_torch.core.ckks import params as tparams
from repro_torch.core.secure_agg import (AggregatorConfig,
                                         SelectiveHEAggregator)
from repro_torch.fl.server import FLServer, ReceivedUpdate
from repro_torch.serve import faults as tfaults
from repro_torch.serve import quorum as qr
from repro_torch.serve import service as tservice
from repro_torch.serve import sim as ssim
from repro_torch.wire import budget as wb

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

JCTX = jparams.make_test_context(n_poly=256, n_limbs=2, delta_bits=20)
JSK, JPK = jcipher.keygen(JCTX, jax.random.PRNGKey(0))
CTX = tparams.make_test_context(n_poly=256, n_limbs=2, delta_bits=20,
                                device="cpu")
interop.check_context(CTX, JCTX.primes, 256, 20)
PK = interop.keys_from_np({k: np.asarray(v) for k, v in JPK.items()}, "cpu")
N_CLIENTS = 6


def _template(seed, n_chunks=2):
    """tests/test_serve.py's template blob, encrypted by the JAX package."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n_chunks, JCTX.slots).astype(np.float32)
    ct = jcipher.encrypt_values(JCTX, JPK, jnp.asarray(v),
                                jax.random.PRNGKey(seed + 1))
    return jws.pack_update_frames(
        JUpdate(ct=ct, plain=jnp.asarray(rng.randn(9).astype(np.float32))),
        cid=0, n_samples=1, rnd=0)


TEMPLATES = [_template(s) for s in range(3)]
FLEET = ssim.Fleet(TEMPLATES, N_CLIENTS, seed=42)


def reference(rnd=0, exclude=()):
    return ssim.reference_aggregate(
        CTX, [FLEET.blob(c, rnd) for c in range(N_CLIENTS)
              if c not in exclude])


def assert_bitexact(a, b):
    assert torch.equal(a.ct.data, b.ct.data)
    assert torch.equal(a.plain.view(torch.int32), b.plain.view(torch.int32))
    assert a.ct.scale == b.ct.scale


def assert_same_as_jax(t, j):
    data, scale, plain = interop.protected_update_to_np(t)
    np.testing.assert_array_equal(data, np.asarray(j.ct.data,
                                                   dtype=np.uint32))
    np.testing.assert_array_equal(plain.view(np.uint32),
                                  np.asarray(j.plain).view(np.uint32))
    assert scale == j.ct.scale


def make_service(min_clients=2, target=N_CLIENTS, **kw):
    pol = qr.QuorumPolicy(min_clients=min_clients, target_clients=target,
                          deadline_s=kw.pop("deadline_s", None))
    return serve.AggregationService(CTX, pol, **kw)


def _rejected_ingest_total():
    rows = obs.REGISTRY.snapshot().get("wire_ingest_rejected_updates", [])
    return sum(r["value"] for r in rows)


# ---------------------------------------------------------------------------
# clean path + state machine edges
# ---------------------------------------------------------------------------


def test_clean_round_bit_identical_to_sync_reference():
    svc = make_service()
    rnd = svc.open_round()
    assert svc.status(rnd) == serve.ST_OPEN
    for cid, blob in FLEET.blobs(rnd):
        assert svc.submit(blob).accepted
    assert svc.status(rnd) == serve.ST_SEALED      # sealed at target
    # the sealed round no longer accepts: no round is open
    late = svc.submit(FLEET.blob(0, rnd))
    assert not late.accepted and late.reason == "no_open_round"
    svc.drain()
    assert svc.status(rnd) == serve.ST_DONE
    assert_bitexact(svc.result(rnd), reference(rnd))
    info = svc.round_info(rnd)
    assert info["folded"] == N_CLIENTS and info["refolds"] == 0


def test_open_while_open_raises():
    svc = make_service(target=None)
    svc.open_round()
    with pytest.raises(RuntimeError, match="still open"):
        svc.open_round()


def test_result_before_done_raises():
    svc = make_service(target=None)
    rnd = svc.open_round()
    with pytest.raises(RuntimeError, match="not done"):
        svc.result(rnd)


def test_explicit_seal_below_quorum_raises():
    svc = make_service(min_clients=3, target=None)
    rnd = svc.open_round()
    svc.submit(FLEET.blob(0, rnd))
    with pytest.raises(RuntimeError, match="below the quorum floor"):
        svc.seal()


def test_duplicate_cid_rejected():
    svc = make_service(target=None)
    rnd = svc.open_round()
    assert svc.submit(FLEET.blob(1, rnd)).accepted
    dup = svc.submit(FLEET.blob(1, rnd))
    assert not dup.accepted and dup.reason == "duplicate_cid"
    assert svc.round_info(rnd)["rejected"] == {"duplicate_cid": 1}


def test_bad_header_rejected_at_door():
    svc = make_service(target=None)
    rnd = svc.open_round()
    res = svc.submit(b"this is not a wire frame stream")
    assert not res.accepted and res.reason == "bad_header"
    assert svc.round_info(rnd)["accepted"] == 0


# ---------------------------------------------------------------------------
# fault injection: every faults.py mode against a live round
# ---------------------------------------------------------------------------

REJECT_MODES = ("drop", "duplicate", "truncate", "garbage")


@pytest.mark.parametrize("mode", REJECT_MODES)
def test_fault_rejected_and_aggregate_bit_identical(mode):
    bad_cid = 3
    inj = serve.FaultInjector(seed=11, blob_faults={bad_cid: mode})
    svc = make_service()
    before = _rejected_ingest_total()
    rnd = svc.open_round()
    door_rejects = 0
    for cid, blob in FLEET.blobs(rnd):
        res = svc.submit(inj.corrupt(cid, blob))
        door_rejects += not res.accepted
    if door_rejects:
        # the fault truncated inside the header: rejected at submit()
        assert mode == "truncate" and door_rejects == 1
        svc.seal()
    svc.drain()
    assert svc.status(rnd) == serve.ST_DONE
    assert_bitexact(svc.result(rnd), reference(rnd, exclude={bad_cid}))
    info = svc.round_info(rnd)
    if door_rejects:
        assert info["bad_after_accept"] == 0
    else:
        # rejected at fold time, atomically, then one refold renormalized
        # the survivors' weights
        assert info["bad_after_accept"] == 1 and info["refolds"] == 1
        assert _rejected_ingest_total() == before + 1
        assert obs.counter("serve_fold_rejects",
                           service=svc.service_id).value == 1


def test_reorder_accepted_bit_identically():
    """Chunk-frame order is NOT part of the wire contract: a reordered
    stream folds to the same bits as the canonical one."""
    inj = serve.FaultInjector(seed=5, blob_faults={2: "reorder"})
    svc = make_service()
    rnd = svc.open_round()
    for cid, blob in FLEET.blobs(rnd):
        assert svc.submit(inj.corrupt(cid, blob)).accepted
    svc.drain()
    assert_bitexact(svc.result(rnd), reference(rnd))
    assert svc.round_info(rnd)["refolds"] == 0


def test_delay_rejected_late_and_round_seals_at_deadline():
    now = [0.0]
    svc = make_service(min_clients=2, target=None, deadline_s=10.0,
                       clock=lambda: now[0])
    inj = serve.FaultInjector(seed=0, blob_faults={5: "delay"})
    rnd = svc.open_round()
    for cid, blob in FLEET.blobs(rnd, cids=range(5)):
        assert svc.submit(inj.corrupt(cid, blob)).accepted
    now[0] = 10.5                               # past the deadline
    late = svc.submit(inj.corrupt(5, FLEET.blob(5, rnd)))
    assert not late.accepted and late.reason == "late"
    assert svc.status(rnd) == serve.ST_SEALED   # late submit sealed it
    assert svc.round_info(rnd)["sealed_reason"] == "deadline"
    svc.drain()
    assert_bitexact(svc.result(rnd), reference(rnd, exclude={5}))
    assert svc.round_info(rnd)["rejected"] == {"late": 1}


def test_below_quorum_at_deadline_fails():
    now = [0.0]
    svc = make_service(min_clients=4, target=None, deadline_s=5.0,
                       clock=lambda: now[0])
    rnd = svc.open_round()
    for cid, blob in FLEET.blobs(rnd, cids=range(2)):
        svc.submit(blob)
    now[0] = 6.0
    assert svc.maybe_seal() == qr.FAIL_DEADLINE
    assert svc.status(rnd) == serve.ST_FAILED
    with pytest.raises(RuntimeError, match="deadline_below_quorum"):
        svc.result(rnd)


def test_below_quorum_after_fold_rejects_fails():
    """Quorum is re-checked AFTER fold-time rejects: a round that sealed
    at quorum but lost a corrupt update below it must fail, never publish
    a below-quorum aggregate."""
    inj = serve.FaultInjector(seed=3, blob_faults={0: "drop"})
    svc = make_service(min_clients=N_CLIENTS)
    rnd = svc.open_round()
    for cid, blob in FLEET.blobs(rnd):
        assert svc.submit(inj.corrupt(cid, blob)).accepted
    svc.drain()
    assert svc.status(rnd) == serve.ST_FAILED
    assert svc.round_info(rnd)["sealed_reason"] == \
        "below_quorum_after_rejects"


def test_multiple_faulty_clients_one_round():
    inj = serve.FaultInjector(
        seed=13, blob_faults={1: "drop", 4: "garbage", 2: "reorder"})
    svc = make_service()
    rnd = svc.open_round()
    for cid, blob in FLEET.blobs(rnd):
        svc.submit(inj.corrupt(cid, blob))
    svc.drain()
    assert_bitexact(svc.result(rnd), reference(rnd, exclude={1, 4}))
    assert svc.round_info(rnd)["bad_after_accept"] == 2


# ---------------------------------------------------------------------------
# async overlap: round r+1 accepts while round r still owes folds
# ---------------------------------------------------------------------------


def test_overlap_next_round_accepts_while_previous_folds():
    svc = make_service(fold_batch=2)
    r0 = svc.open_round()
    for cid, blob in FLEET.blobs(r0):
        svc.submit(blob)
    assert svc.status(r0) == serve.ST_SEALED
    svc.step()                                   # partially folded
    assert svc.status(r0) == serve.ST_FOLDING
    r1 = svc.open_round()                        # overlap: r0 not done
    for cid, blob in FLEET.blobs(r1):
        assert svc.submit(blob).accepted
    assert svc.status(r0) in (serve.ST_FOLDING, serve.ST_SEALED)
    svc.drain()
    assert_bitexact(svc.result(r0), reference(r0))
    assert_bitexact(svc.result(r1), reference(r1))


def test_worker_thread_round_matches_reference():
    svc = make_service()
    svc.start(poll_s=0.0005)
    try:
        rnd = svc.open_round()
        for cid, blob in FLEET.blobs(rnd):
            svc.submit(blob)
        for _ in range(2000):
            if not svc.unfinished():
                break
            time.sleep(0.002)
    finally:
        svc.stop()
    assert svc.worker_error is None
    assert_bitexact(svc.result(rnd), reference(rnd))


def test_stop_raises_when_the_worker_does_not_end(monkeypatch):
    """A worker stuck in a step makes stop() fail after its bounded wait,
    never hang; once the step returns, stop() joins it."""
    svc = make_service()
    entered, release = threading.Event(), threading.Event()

    def stuck_step():
        entered.set()
        release.wait(30)
        return False

    svc.step = stuck_step
    svc.start()
    try:
        assert entered.wait(30)
        with monkeypatch.context() as m, \
                pytest.raises(RuntimeError, match="did not stop"):
            m.setattr(tservice, "STOP_TIMEOUT_S", 0.05)
            svc.stop()
    finally:
        release.set()
    svc.stop()
    assert svc.worker_error is None


def test_worker_error_parks_and_the_round_resumes(tmp_path):
    """A crash in the worker parks in worker_error (the driver re-raises
    it after stop()); the checkpoint resumes to the reference."""
    pol = qr.QuorumPolicy(min_clients=2, target_clients=N_CLIENTS)
    svc = serve.AggregationService(
        CTX, pol, ckpt_dir=str(tmp_path), fold_batch=2,
        faults=serve.FaultInjector(crash_at=["after_fold_step"]))
    svc.start(poll_s=0.0005)
    try:
        rnd = svc.open_round()
        for cid, blob in FLEET.blobs(rnd):
            svc.submit(blob)
        for _ in range(2000):
            if svc.worker_error is not None:
                break
            time.sleep(0.002)
    finally:
        svc.stop()
    assert isinstance(svc.worker_error, serve.SimulatedCrash)
    svc2 = serve.AggregationService.resume(str(tmp_path), CTX, pol,
                                           fold_batch=2)
    svc2.drain()
    assert_bitexact(svc2.result(rnd), reference(rnd))


# ---------------------------------------------------------------------------
# crash-restart: bit-exact resume from every checkpoint boundary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point", serve.CRASH_POINTS)
def test_crash_restart_bit_exact(tmp_path, point):
    pol = qr.QuorumPolicy(min_clients=2, target_clients=N_CLIENTS)
    inj = serve.FaultInjector(crash_at=[point])
    led = wb.BandwidthLedger()
    svc = serve.AggregationService(
        CTX, pol, ckpt_dir=str(tmp_path), faults=inj, ledger=led,
        fold_batch=2, ckpt_every_accepts=1)
    with pytest.raises(serve.SimulatedCrash):
        svc.open_round()
        for cid, blob in FLEET.blobs(0):
            svc.submit(blob)
        svc.drain()
    assert inj.fired == [point]

    # restart: fresh process state, resume from the durable checkpoint
    led2 = wb.BandwidthLedger()
    svc2 = serve.AggregationService.resume(str(tmp_path), CTX, pol,
                                           ledger=led2, fold_batch=2)
    # at-least-once delivery: clients whose ack was lost resubmit; the
    # service dedups anything the checkpoint already accepted
    if svc2.open_round_id is not None:
        for cid, blob in FLEET.blobs(0):
            svc2.submit(blob)
    svc2.drain()
    assert svc2.status(0) == serve.ST_DONE
    assert_bitexact(svc2.result(0), reference(0))
    # the budget ledger lost no bytes: every accepted blob is accounted
    # exactly once across the crash
    total = sum(len(FLEET.blob(c, 0)) for c in range(N_CLIENTS))
    assert led2.total(wb.UPLINK) == total


def test_crash_restart_mid_fold_with_faults(tmp_path):
    """Crash during folding of a round that ALSO has a corrupt update:
    resume must replay the refold logic to the same survivor bits."""
    pol = qr.QuorumPolicy(min_clients=2, target_clients=N_CLIENTS)
    inj = serve.FaultInjector(seed=9, crash_at=["after_fold_step"],
                              blob_faults={4: "garbage"})
    svc = serve.AggregationService(CTX, pol, ckpt_dir=str(tmp_path),
                                   faults=inj, fold_batch=2)
    with pytest.raises(serve.SimulatedCrash):
        svc.open_round()
        for cid, blob in FLEET.blobs(0):
            svc.submit(inj.corrupt(cid, blob))
        svc.drain()
    svc2 = serve.AggregationService.resume(str(tmp_path), CTX, pol,
                                           fold_batch=2)
    svc2.drain()
    assert svc2.status(0) == serve.ST_DONE
    assert_bitexact(svc2.result(0), reference(0, exclude={4}))


def test_resume_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        serve.AggregationService.resume(str(tmp_path / "empty"), CTX,
                                        qr.QuorumPolicy())


# ---------------------------------------------------------------------------
# quorum properties (deterministic sweeps always run; hypothesis widens)
# ---------------------------------------------------------------------------


def test_any_subset_at_or_above_quorum_finalizes_below_never():
    MIN = 3
    for size in range(1, N_CLIENTS + 1):
        svc = make_service(min_clients=MIN, target=None)
        rnd = svc.open_round()
        for cid, blob in FLEET.blobs(rnd, cids=range(size)):
            assert svc.submit(blob).accepted
        if size < MIN:
            with pytest.raises(RuntimeError, match="quorum"):
                svc.seal()
            assert svc.status(rnd) == serve.ST_OPEN
        else:
            svc.seal()
            svc.drain()
            assert svc.status(rnd) == serve.ST_DONE
            # weights renormalized over exactly this subset
            assert_bitexact(
                svc.result(rnd),
                ssim.reference_aggregate(
                    CTX, [FLEET.blob(c, rnd) for c in range(size)]))


@settings(max_examples=200, deadline=None)
@given(st.integers(min_value=1, max_value=50),
       st.integers(min_value=0, max_value=100),
       st.floats(min_value=0.0, max_value=1e4,
                 allow_nan=False, allow_infinity=False))
def test_quorum_policy_floor_property(min_clients, n_accepted, elapsed):
    pol = qr.QuorumPolicy(min_clients=min_clients, deadline_s=10.0)
    verdict = pol.should_seal(n_accepted, elapsed)
    if n_accepted < min_clients:
        # below the floor a round can NEVER seal, only fail
        assert verdict in (None, qr.FAIL_DEADLINE)
    if verdict in (qr.SEAL_TARGET, qr.SEAL_DEADLINE):
        assert pol.met(n_accepted)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=10_000),
                min_size=1, max_size=64))
def test_weights_renormalize_property(n_samples):
    w = qr.normalized_weights(n_samples)
    assert len(w) == len(n_samples)
    assert abs(sum(w) - 1.0) < 1e-9
    # proportionality: w_i / w_j == n_i / n_j (float64 math)
    tot = float(np.asarray(n_samples, dtype=np.float64).sum())
    for wi, ni in zip(w, n_samples):
        assert wi == pytest.approx(ni / tot, rel=1e-12)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(st.integers(min_value=1, max_value=1000),
                          st.integers(min_value=0, max_value=20)),
                min_size=1, max_size=16),
       st.integers(min_value=0, max_value=20),
       st.floats(min_value=0.5, max_value=16.0, allow_nan=False))
def test_staleness_weights_property(buf, current_round, half_life):
    ns = [n for n, _ in buf]
    sent = [s for _, s in buf]
    w = qr.staleness_weights(ns, sent, current_round, half_life)
    assert abs(sum(w) - 1.0) < 1e-9
    # staler updates never outweigh fresher ones with equal n_samples
    for i in range(len(buf)):
        for j in range(len(buf)):
            if ns[i] == ns[j] and sent[i] <= sent[j]:
                assert w[i] <= w[j] + 1e-12


# ---------------------------------------------------------------------------
# FLServer.submit_async folds through the shared weight law
# ---------------------------------------------------------------------------


def test_flserver_submit_async_uses_shared_staleness_law():
    rng = np.random.RandomState(0)
    model = {"w": torch.from_numpy(rng.randn(40, 10).astype(np.float32))}
    sens = torch.from_numpy(np.abs(rng.randn(400)))
    agg = SelectiveHEAggregator.build(CTX, model, sens,
                                      AggregatorConfig(p_ratio=0.3))
    ups = []
    for i in range(3):
        local = {"w": model["w"] + 0.01 * (i + 1)}
        ups.append(ReceivedUpdate(
            cid=i, n_samples=4 * (i + 1), round_sent=i,
            update=agg.client_protect(local, PK,
                                      torch.Generator().manual_seed(i))))

    server = FLServer(agg, buffer_size=3, staleness_half_life=2.0)
    assert server.submit_async(ups[0], current_round=4) is None
    assert server.submit_async(ups[1], current_round=4) is None
    out = server.submit_async(ups[2], current_round=4)
    assert out is not None

    expect_w = qr.staleness_weights([4, 8, 12], [0, 1, 2],
                                    current_round=4, half_life=2.0)
    expect = agg.server_aggregate([u.update for u in ups], expect_w)
    assert_bitexact(out, expect)
    assert server._buffer == []                 # buffer flushed


# ---------------------------------------------------------------------------
# against the JAX package, live
# ---------------------------------------------------------------------------

J_FLEET = jsim.Fleet(TEMPLATES, N_CLIENTS, seed=42)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("mode", serve.FAULT_MODES)
def test_corrupt_blob_bytes_match_jax(mode, seed):
    for blob in (TEMPLATES[1], FLEET.blob(4, 2)):
        got = tfaults.corrupt_blob(blob, mode, np.random.RandomState(seed))
        want = jfaults.corrupt_blob(blob, mode, np.random.RandomState(seed))
        assert type(got) is bytes and got == want
    # an injector draws the same sequence over several clients
    faults = {1: mode, 3: mode, 4: "reorder"}
    ti = tfaults.FaultInjector(seed=seed, blob_faults=faults)
    ji = jfaults.FaultInjector(seed=seed, blob_faults=faults)
    for cid in range(N_CLIENTS):
        assert ti.corrupt(cid, FLEET.blob(cid, 0)) == \
            ji.corrupt(cid, FLEET.blob(cid, 0))
    assert tfaults.split_frames(TEMPLATES[0]) == \
        jfaults.split_frames(TEMPLATES[0])


def test_fleet_blobs_match_jax():
    np.testing.assert_array_equal(FLEET.n_samples, J_FLEET.n_samples)
    for rnd in (0, 3):
        for (tc, tb), (jc, jb) in zip(FLEET.blobs(rnd), J_FLEET.blobs(rnd)):
            assert tc == jc and tb == jb
    assert ssim.rewrite_begin(TEMPLATES[0], n_samples=9) == \
        jsim.rewrite_begin(TEMPLATES[0], n_samples=9)
    with pytest.raises(tfaults.wf.WireError):
        ssim.rewrite_begin(TEMPLATES[0][16:])


def _run_round(pkg_serve, ctx, fleet, faults):
    """One round of `pkg_serve`'s service over the fleet with the given
    {cid: mode} faults (a delayed blob goes in after the deadline)."""
    now = [0.0]
    pol = pkg_serve.QuorumPolicy(min_clients=2, deadline_s=10.0)
    svc = pkg_serve.AggregationService(ctx, pol, clock=lambda: now[0],
                                       fold_batch=4)
    inj = pkg_serve.FaultInjector(seed=21, blob_faults=faults)
    rnd = svc.open_round()
    delayed = [c for c, m in faults.items() if m == "delay"]
    for cid, blob in fleet.blobs(rnd):
        if cid not in delayed:
            svc.submit(inj.corrupt(cid, blob))
    now[0] = 10.5
    for cid in delayed:
        assert not svc.submit(inj.corrupt(cid, fleet.blob(cid, rnd))).accepted
    svc.maybe_seal()
    svc.drain()
    return svc.result(rnd), svc.round_info(rnd)


@pytest.mark.parametrize("mode", serve.FAULT_MODES)
def test_service_aggregate_matches_jax_under_fault(mode):
    faults = {2: mode, 5: "drop"}
    tres, tinfo = _run_round(serve, CTX, FLEET, faults)
    jres, jinfo = _run_round(jserve, JCTX, J_FLEET, faults)
    assert tinfo == jinfo
    assert_same_as_jax(tres, jres)


def _crash_after_fold_step(pkg_serve, ctx, fleet, d, ledger):
    """Run one round with a garbage blob into a crash at after_fold_step
    under checkpoint dir `d`."""
    pol = pkg_serve.QuorumPolicy(min_clients=2, target_clients=N_CLIENTS)
    inj = pkg_serve.FaultInjector(seed=9, crash_at=["after_fold_step"],
                                  blob_faults={4: "garbage"})
    svc = pkg_serve.AggregationService(ctx, pol, ckpt_dir=d, faults=inj,
                                       fold_batch=2, ledger=ledger)
    with pytest.raises(pkg_serve.SimulatedCrash):
        svc.open_round()
        for cid, blob in fleet.blobs(0):
            svc.submit(inj.corrupt(cid, blob))
        svc.drain()
    return pol


def _serve_extra(d):
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    with open(os.path.join(d, steps[-1], "manifest.json")) as f:
        manifest = json.load(f)
    return manifest["names"], manifest["extra"]["serve"]


def _json_types(x):
    if isinstance(x, dict):
        return {k: _json_types(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_json_types(v) for v in x]
    return type(x).__name__


@pytest.mark.parametrize("crashed_by", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, crashed_by):
    """A round crashed at after_fold_step by one package is resumed and
    finished by the other; both equal the uninterrupted round over the
    survivors, and both packages write the same checkpoint fields."""
    d_t, d_j = str(tmp_path / "port"), str(tmp_path / "jax")
    pol_t = _crash_after_fold_step(serve, CTX, FLEET, d_t,
                                   wb.BandwidthLedger())
    pol_j = _crash_after_fold_step(jserve, JCTX, J_FLEET, d_j,
                                   jwb.BandwidthLedger())
    (tn, tx), (jn, jx) = _serve_extra(d_t), _serve_extra(d_j)
    assert tn == jn
    tx["rounds"]["0"]["accepted"] = [
        {k: v for k, v in r.items() if k != "path"}
        for r in tx["rounds"]["0"]["accepted"]]
    jx["rounds"]["0"]["accepted"] = [
        {k: v for k, v in r.items() if k != "path"}
        for r in jx["rounds"]["0"]["accepted"]]
    assert tx == jx and _json_types(tx) == _json_types(jx)

    want = reference(0, exclude={4})
    if crashed_by == "jax":
        led = wb.BandwidthLedger()
        svc = serve.AggregationService.resume(d_j, CTX, pol_t, fold_batch=2,
                                              ledger=led)
        svc.drain()
        assert_bitexact(svc.result(0), want)
        # and the port's own resume gives the same bits
        svc_t = serve.AggregationService.resume(d_t, CTX, pol_t,
                                                fold_batch=2)
        svc_t.drain()
        assert_bitexact(svc_t.result(0), want)
    else:
        led = jwb.BandwidthLedger()
        svc = jserve.AggregationService.resume(d_t, JCTX, pol_j,
                                               fold_batch=2, ledger=led)
        svc.drain()
        assert_same_as_jax(want, svc.result(0))
    assert led.total("up") == sum(
        len(b) for _, b in FLEET.blobs(0))
    # the finished round's checkpoint (result_0) crosses back too
    back = (jserve if crashed_by == "jax" else serve).AggregationService
    ctx = JCTX if crashed_by == "jax" else CTX
    pol = pol_j if crashed_by == "jax" else pol_t
    done = back.resume(d_j if crashed_by == "jax" else d_t, ctx, pol)
    res = done.result(0)
    if crashed_by == "jax":
        assert_same_as_jax(want, res)
    else:
        assert_bitexact(res, want)
