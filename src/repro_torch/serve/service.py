"""Async encrypted aggregation service: the round state machine (the JAX
package's `repro.serve.service`).

One `AggregationService` owns a sequence of FL rounds, each a small state
machine (DESIGN.md §14.1):

    OPEN ──seal──▶ SEALED ──▶ FOLDING ──▶ DONE
      │                          │
      └──deadline below quorum───┴──rejects below quorum──▶ FAILED

* **OPEN** — `submit()` accepts client update blobs: late (past the
  quorum deadline), duplicate-cid, and headerless submissions are
  rejected at the door; everything else is spooled (to disk when
  checkpointing is on) and acknowledged.  At most one round is OPEN at a
  time, but an OPEN round r+1 coexists with a FOLDING round r — that is
  the async overlap: accepting the next round's traffic never waits for
  the previous round's HE folds.
* **SEALED** — the quorum policy froze the accepted set (target reached
  or deadline passed with quorum met) and the FedAvg weights were
  normalized over it.
* **FOLDING** — `step()` drives the accepted blobs through ONE
  `wire.stream.StreamIngest` in arrival order, `fold_batch` updates per
  call.  A blob that fails wire validation here is dropped ATOMICALLY
  (StreamIngest's per-update rollback — nothing of it reaches the
  accumulator) and marked bad; when the pass ends with new bad blobs the
  round REFOLDS once from scratch with the weights renormalized over the
  survivors, so the final aggregate is bit-identical to a clean
  synchronous run over exactly the surviving clients.
* **DONE / FAILED** — `result()` returns the aggregated ProtectedUpdate;
  a round whose survivors dropped below `min_clients` fails instead of
  finalizing a below-quorum aggregate.

Crash consistency (DESIGN.md §14.3): every transition checkpoints the
FULL service state — accumulators (exact u32 residues + literal f32
plain partial sums), budget ledger, and round bookkeeping — through
`ckpt/store.py`'s atomic rename, and only THEN crosses the fault
injector's crash point.  `AggregationService.resume()` rebuilds the
service from the latest checkpoint and continues bit-exactly; a client
whose ack was lost in the crash simply resubmits and is deduplicated.
The checkpoint is the JAX package's: the same tree, the same `extra`
keys and JSON types, the result's residues as u32 in the reference's
axis order (`interop`), so either package resumes the other's.

Telemetry: the wait for the service's lock goes to the
`serve_lock_wait_seconds{caller}` histogram and a `serve.lock_wait` span
(every submit; a step only when it had to wait), and each blob's time from
its accept to the start of its first fold to `serve_queue_wait_seconds`
and a `serve.queue_wait` instant event (`wait_s`).  The spans and events
record while obs is enabled or a torch.profiler session runs.

On the card: the background worker (`start`) runs the state machine in
a thread pinned to the context's device, and a round's device work is
synchronized before it becomes DONE, so `result()` from another thread
never sees an accumulator a kernel is still writing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from collections import Counter as _Counter

import torch

from repro_torch import interop, obs
from repro_torch.ckpt import store as ckpt_store
from repro_torch.core.ckks.params import CkksContext
from repro_torch.core.secure_agg import ProtectedUpdate
from repro_torch.serve import quorum as qr
from repro_torch.serve.faults import FaultInjector
from repro_torch.wire import budget as wire_budget
from repro_torch.wire import format as wf
from repro_torch.wire import stream as wire_stream

ST_OPEN = "open"
ST_SEALED = "sealed"
ST_FOLDING = "folding"
ST_DONE = "done"
ST_FAILED = "failed"

# submit() rejection reasons (SubmitResult.reason; "accepted" on success)
REJ_NO_ROUND = "no_open_round"
REJ_LATE = "late"
REJ_DUP = "duplicate_cid"
REJ_BAD_HEADER = "bad_header"

# stop() waits this long for the worker to finish its current step.  A
# step folds at most fold_batch updates and writes one checkpoint; on an
# H100 (chip_smoke.py's phase 10) a Qwen1.5-0.5B-sized update of 1.58 GB
# folds in about 2 s and its 3.16 GB checkpoint saves in about 2.5 s, so
# a step at the default fold_batch of 32 takes about a minute.
STOP_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class SubmitResult:
    """Ack for one submit(): accepted flag, reason, and the round it was
    judged against (None when no round was open)."""
    accepted: bool
    reason: str
    round: int | None = None


class RoundState:
    """Bookkeeping for one round of the state machine (service-internal;
    exposed read-only through AggregationService.round_info)."""

    def __init__(self, rnd: int, opened_at: float):
        self.rnd = rnd
        self.status = ST_OPEN
        self.opened_at = opened_at
        self.sealed_reason: str | None = None
        # accepted updates, in arrival order; each is a dict with keys
        # cid / n_samples / nbytes / blob (bytes) / path (spool file|None)
        self.accepted: list[dict] = []
        # perf_counter time of each accept, by index into `accepted`, until
        # the blob's first fold reads it: telemetry, never checkpointed (a
        # resumed round has none)
        self.accepted_at: dict[int, float] = {}
        self.seen_cids: set[int] = set()
        self.rejected: _Counter = _Counter()
        # fold progress: indices into `accepted` that failed wire
        # validation, FedAvg weights over the current survivor set, and
        # the cursor into the survivor order
        self.bad: set[int] = set()
        self.weights: list[float] | None = None
        self.cursor = 0
        self.pass_dirty = False        # new bad blobs found this pass
        self.refolds = 0
        self.result: ProtectedUpdate | None = None

    def good_order(self) -> list[int]:
        """Arrival-order indices of the accepted blobs still considered
        good — the fold order, and the set weights normalize over."""
        return [i for i in range(len(self.accepted)) if i not in self.bad]

    def elapsed(self, now: float) -> float:
        return now - self.opened_at


def _synchronize(upd: ProtectedUpdate) -> None:
    """Wait for the device work that writes `upd`'s tensors."""
    for t in (upd.ct.data, upd.plain):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


class AggregationService:
    """The encrypted aggregation service (module docstring for the state
    machine; DESIGN.md §14 for the full design).

    Args:
        ctx: CkksContext of the arriving ciphertext updates; folds run on
            its device.
        quorum: the QuorumPolicy every round seals under.
        sharded: optional core.ckks.sharded.ShardedHe; folds then run
            sharded over its mesh, bit-identical (wire/stream contract).
        ckpt_dir: enable crash-safe checkpointing + blob spooling under
            this directory (None = in-memory only, no resume).
        ckpt_keep: checkpoints retained by rotation.
        ckpt_every_accepts: additionally checkpoint every N accepted
            updates while a round is OPEN (0 = only at transitions).
        fold_batch: updates folded per step() call — the granularity of
            both checkpointing and submit-latency while folding.
        clock: monotonic-seconds callable (injectable for deterministic
            deadline tests); default time.monotonic.
        faults: optional FaultInjector whose crash points this service
            honors (wire faults are applied by the network/driver, not
            here).
        ledger: optional wire.budget.BandwidthLedger; accepted uplink
            blobs are recorded per artifact class, and the records ride
            every checkpoint (a resume loses no accounted bytes).
        transcipher_materials: optional {(cid, round):
            transcipher.ServerMaterials} registry handed to every round's
            StreamIngest — required before any thin-client (transcipher)
            update can fold; unprovisioned masked updates are rejected at
            fold time like any bad blob (DESIGN.md §15).  Mutable: the
            provisioning path may add_transcipher_materials() while the
            service runs.
    """

    _ids = itertools.count()

    def __init__(self, ctx: CkksContext, quorum: qr.QuorumPolicy, *,
                 sharded=None, ckpt_dir: str | None = None,
                 ckpt_keep: int = 3, ckpt_every_accepts: int = 0,
                 fold_batch: int = 32, clock=None,
                 faults: FaultInjector | None = None,
                 ledger: wire_budget.BandwidthLedger | None = None,
                 transcipher_materials: dict | None = None):
        self.ctx = ctx
        self.quorum = quorum
        self.sharded = sharded
        self.transcipher_materials = dict(transcipher_materials or {})
        self.fold_batch = int(fold_batch)
        if self.fold_batch < 1:
            raise ValueError("fold_batch must be >= 1")
        self.ckpt_every_accepts = int(ckpt_every_accepts)
        self._clock = clock if clock is not None else time.monotonic
        self.faults = faults
        self.ledger = ledger
        self.ckpt_dir = ckpt_dir
        self._ckpt = (ckpt_store.CheckpointManager(ckpt_dir, keep=ckpt_keep)
                      if ckpt_dir else None)
        self._ckpt_step = 0
        self._accepts_since_ckpt = 0
        self._rounds: dict[int, RoundState] = {}
        self._ingests: dict[int, wire_stream.StreamIngest] = {}
        self._open_rnd: int | None = None
        self._next_round = 0
        self._lock = threading.RLock()
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()
        self.worker_error: BaseException | None = None
        sid = str(next(self._ids))
        self.service_id = sid
        lab = {"service": sid}
        self._m_accepted = obs.counter("serve_submits", result="accepted",
                                       **lab)
        self._m_rejected = {
            r: obs.counter("serve_submits", result=r, **lab)
            for r in (REJ_NO_ROUND, REJ_LATE, REJ_DUP, REJ_BAD_HEADER)}
        self._m_folded = obs.counter("serve_updates_folded", **lab)
        self._m_fold_rejects = obs.counter("serve_fold_rejects", **lab)
        self._m_refolds = obs.counter("serve_refolds", **lab)
        self._m_done = obs.counter("serve_rounds", status=ST_DONE, **lab)
        self._m_failed = obs.counter("serve_rounds", status=ST_FAILED, **lab)
        self._m_ckpts = obs.counter("serve_checkpoints", **lab)
        self._m_lock_wait = {
            c: obs.histogram("serve_lock_wait_seconds", caller=c, **lab)
            for c in ("submit", "step")}
        self._m_queue_wait = obs.histogram("serve_queue_wait_seconds", **lab)

    def add_transcipher_materials(self, cid: int, rnd: int,
                                  materials) -> None:
        """Register one (cid, round)'s transcipher.ServerMaterials before
        that client's masked update folds.  Also propagated into every
        round ingest already in flight (each StreamIngest keeps its own
        copy of the registry)."""
        with self._lock:
            self.transcipher_materials[(int(cid), int(rnd))] = materials
            for ingest in self._ingests.values():
                ingest.add_transcipher_materials(cid, rnd, materials)

    # -- introspection -------------------------------------------------------

    def status(self, rnd: int) -> str:
        """State-machine status of round `rnd` (KeyError if unknown)."""
        with self._lock:
            return self._rounds[rnd].status

    def round_info(self, rnd: int) -> dict:
        """Read-only snapshot of one round's bookkeeping."""
        with self._lock:
            rs = self._rounds[rnd]
            return {
                "round": rs.rnd, "status": rs.status,
                "sealed_reason": rs.sealed_reason,
                "accepted": len(rs.accepted),
                "folded": len(rs.good_order()) if rs.status in
                          (ST_DONE,) else rs.cursor,
                "rejected": dict(rs.rejected),
                "bad_after_accept": len(rs.bad),
                "refolds": rs.refolds,
            }

    @property
    def open_round_id(self) -> int | None:
        return self._open_rnd

    def unfinished(self) -> list[int]:
        """Rounds still owing work (SEALED or FOLDING), oldest first."""
        with self._lock:
            return sorted(r for r, rs in self._rounds.items()
                          if rs.status in (ST_SEALED, ST_FOLDING))

    # -- transitions ---------------------------------------------------------

    def open_round(self) -> int:
        """OPEN the next round.  Allowed while earlier rounds are still
        SEALED/FOLDING (the ingest-vs-finalization overlap); refused while
        another round is OPEN — one accepting round at a time keeps
        submit() routing unambiguous."""
        with self._lock:
            if self._open_rnd is not None:
                raise RuntimeError(
                    f"round {self._open_rnd} is still open; seal it before "
                    "opening the next")
            rnd = self._next_round
            self._next_round += 1
            self._rounds[rnd] = RoundState(rnd, self._clock())
            self._open_rnd = rnd
            with obs.span("serve.open", round=rnd):
                self._checkpoint("open")
            self._crash("after_open")
            return rnd

    def submit(self, blob: bytes) -> SubmitResult:
        """Offer one client's serialized update to the OPEN round.

        Rejection here is cheap and final: past-deadline (``late``),
        duplicate client id, unparseable header, or no round open.
        Acceptance only promises the blob made the accepted set — deep
        wire validation happens at fold time, where a corrupt blob is
        dropped atomically and the round renormalizes without it.
        """
        with self._locked("submit"):
            rnd = self._open_rnd
            if rnd is None:
                self._m_rejected[REJ_NO_ROUND].inc()
                return SubmitResult(False, REJ_NO_ROUND, None)
            rs = self._rounds[rnd]
            now = self._clock()
            if self.quorum.late(rs.elapsed(now)):
                rs.rejected[REJ_LATE] += 1
                self._m_rejected[REJ_LATE].inc()
                self.maybe_seal()      # the deadline has passed: seal/fail
                return SubmitResult(False, REJ_LATE, rnd)
            try:
                meta = wire_stream.peek_update_meta(blob)
            except wf.WireError:
                rs.rejected[REJ_BAD_HEADER] += 1
                self._m_rejected[REJ_BAD_HEADER].inc()
                return SubmitResult(False, REJ_BAD_HEADER, rnd)
            if meta.cid in rs.seen_cids:
                rs.rejected[REJ_DUP] += 1
                self._m_rejected[REJ_DUP].inc()
                return SubmitResult(False, REJ_DUP, rnd)
            rec = {"cid": int(meta.cid), "n_samples": int(meta.n_samples),
                   "nbytes": len(blob), "blob": bytes(blob), "path": None}
            if self._ckpt is not None:
                rec["path"] = self._spool(rnd, rec)
            rs.accepted.append(rec)
            rs.accepted_at[len(rs.accepted) - 1] = time.perf_counter()
            rs.seen_cids.add(int(meta.cid))
            self._m_accepted.inc()
            if self.ledger is not None:
                n_before = len(self.ledger.records)
                try:
                    self.ledger.record_blob(blob, rnd=rnd, cid=meta.cid,
                                            direction=wire_budget.UPLINK)
                except wf.WireError:
                    # the stream is corrupt past its header (it will be
                    # rejected at fold time) but its bytes DID cross the
                    # wire: drop the partial per-class split and account
                    # the raw blob in one record
                    del self.ledger.records[n_before:]
                    self.ledger.record(rnd=rnd, cid=meta.cid,
                                       direction=wire_budget.UPLINK,
                                       kind=wire_budget.K_META,
                                       nbytes=len(blob))
            self._accepts_since_ckpt += 1
            if self.ckpt_every_accepts \
                    and self._accepts_since_ckpt >= self.ckpt_every_accepts:
                self._checkpoint("accept")
            self._crash("after_accept")
            self.maybe_seal()          # target may be reached
            return SubmitResult(True, "accepted", rnd)

    def maybe_seal(self) -> str | None:
        """Poll the quorum policy for the OPEN round; seal or fail it when
        the policy says so.  Returns the seal/fail reason or None."""
        with self._lock:
            rnd = self._open_rnd
            if rnd is None:
                return None
            rs = self._rounds[rnd]
            reason = self.quorum.should_seal(len(rs.accepted),
                                             rs.elapsed(self._clock()))
            if reason is None:
                return None
            if reason == qr.FAIL_DEADLINE:
                self._fail(rs, reason)
            else:
                self._seal(rs, reason)
            return reason

    def seal(self) -> int:
        """Explicitly seal the OPEN round (drivers without a deadline).
        Raises if the quorum floor is not met — below `min_clients` a
        round may never seal, only fail."""
        with self._lock:
            rnd = self._open_rnd
            if rnd is None:
                raise RuntimeError("no round is open")
            rs = self._rounds[rnd]
            if not self.quorum.met(len(rs.accepted)):
                raise RuntimeError(
                    f"round {rnd} has {len(rs.accepted)} accepted updates, "
                    f"below the quorum floor {self.quorum.min_clients}")
            self._seal(rs, "explicit")
            return rnd

    def _seal(self, rs: RoundState, reason: str) -> None:
        rs.status = ST_SEALED
        rs.sealed_reason = reason
        self._open_rnd = None
        with obs.span("serve.seal", round=rs.rnd, reason=reason,
                      accepted=len(rs.accepted)):
            self._checkpoint("seal")
        self._crash("after_seal")

    def _fail(self, rs: RoundState, reason: str) -> None:
        rs.status = ST_FAILED
        rs.sealed_reason = reason
        if self._open_rnd == rs.rnd:
            self._open_rnd = None
        self._m_failed.inc()
        with obs.span("serve.fail", round=rs.rnd, reason=reason):
            self._checkpoint("fail")

    # -- folding -------------------------------------------------------------

    def step(self) -> bool:
        """Advance the oldest SEALED/FOLDING round by up to `fold_batch`
        updates.  Returns True iff any progress was made.  Never blocks on
        the network: this is the half of the service a worker thread (or
        the driver loop) pumps while submit() keeps accepting the next
        round's traffic."""
        with self._locked("step"):
            pending = self.unfinished()
            if not pending:
                return False
            rs = self._rounds[pending[0]]
            if rs.status == ST_SEALED:
                self._begin_fold(rs)
            self._fold_some(rs)
            return True

    def drain(self) -> None:
        """step() until no round owes work (submissions stay possible to
        whatever round is OPEN throughout)."""
        while self.step():
            pass

    def _begin_fold(self, rs: RoundState) -> None:
        rs.status = ST_FOLDING
        rs.cursor = 0
        rs.pass_dirty = False
        good = rs.good_order()
        rs.weights = qr.normalized_weights(
            [rs.accepted[i]["n_samples"] for i in good])
        self._ingests[rs.rnd] = wire_stream.StreamIngest(
            self.ctx, sharded=self.sharded,
            transcipher_materials=self.transcipher_materials)

    def _fold_some(self, rs: RoundState) -> None:
        ingest = self._ingests[rs.rnd]
        good = rs.good_order()
        with obs.span("serve.fold", round=rs.rnd, cursor=rs.cursor,
                      of=len(good)):
            for _ in range(self.fold_batch):
                if rs.cursor >= len(good):
                    break
                i = good[rs.cursor]
                rec = rs.accepted[i]
                accepted_at = rs.accepted_at.pop(i, None)
                if accepted_at is not None:
                    wait = time.perf_counter() - accepted_at
                    self._m_queue_wait.observe(wait)
                    obs.event("serve.queue_wait", round=rs.rnd,
                              cid=rec["cid"], wait_s=wait)
                try:
                    ingest.ingest(self._blob(rs.rnd, rec),
                                  rs.weights[rs.cursor])
                    self._m_folded.inc()
                except wf.WireError as e:
                    # atomically rolled back by StreamIngest: nothing of
                    # this blob reached the accumulator.  Mark it bad; the
                    # pass completes (to discover every bad blob in one
                    # sweep) and then refolds the survivors with weights
                    # renormalized over them.
                    rs.bad.add(i)
                    rs.pass_dirty = True
                    rs.rejected[f"wire:{type(e).__name__}"] += 1
                    self._m_fold_rejects.inc()
                rs.cursor += 1
        if rs.cursor >= len(good):
            self._end_pass(rs)
            return
        self._checkpoint("fold")
        self._crash("after_fold_step")

    def _end_pass(self, rs: RoundState) -> None:
        if rs.pass_dirty:
            # rejects changed the survivor set: refold from scratch so the
            # weights (and therefore the bits) match a clean run over
            # exactly the surviving clients
            rs.refolds += 1
            self._m_refolds.inc()
            good = rs.good_order()
            if not self.quorum.met(len(good)):
                del self._ingests[rs.rnd]
                self._fail(rs, "below_quorum_after_rejects")
                return
            self._begin_fold(rs)
            self._checkpoint("refold")
            self._crash("after_fold_step")
            return
        ingest = self._ingests.pop(rs.rnd)
        good = rs.good_order()
        if not self.quorum.met(len(good)):
            self._fail(rs, "below_quorum_after_rejects")
            return
        with obs.span("serve.finalize", round=rs.rnd, folded=len(good),
                      launches=ingest.accum_launches):
            rs.result = ingest.finalize()
            _synchronize(rs.result)
        rs.status = ST_DONE
        self._m_done.inc()
        self._checkpoint("finalize")
        self._crash("after_finalize")

    def result(self, rnd: int) -> ProtectedUpdate:
        """Aggregated ProtectedUpdate of a DONE round (raises otherwise)."""
        with self._lock:
            rs = self._rounds[rnd]
            if rs.status != ST_DONE:
                raise RuntimeError(
                    f"round {rnd} is {rs.status}, not {ST_DONE}"
                    + (f" ({rs.sealed_reason})"
                       if rs.status == ST_FAILED else ""))
            return rs.result

    def forget_round(self, rnd: int) -> None:
        """Drop a DONE/FAILED round's state (and its spool files) once the
        driver has consumed the result — the long-running service's GC."""
        with self._lock:
            rs = self._rounds[rnd]
            if rs.status not in (ST_DONE, ST_FAILED):
                raise RuntimeError(f"round {rnd} is still {rs.status}")
            for rec in rs.accepted:
                if rec["path"]:
                    try:
                        os.unlink(rec["path"])
                    except OSError:
                        pass
            del self._rounds[rnd]

    # -- background worker ---------------------------------------------------

    @contextlib.contextmanager
    def _locked(self, caller: str):
        """Hold the service lock, timing the wait for it into the
        `serve_lock_wait_seconds{caller}` histogram and a `serve.lock_wait`
        span: every submit's, and a step's only when the lock was taken
        (an idle worker polls step() every `poll_s`)."""
        if caller == "submit" or not self._lock.acquire(blocking=False):
            t0 = time.perf_counter()
            with obs.span("serve.lock_wait", caller=caller):
                self._lock.acquire()
            self._m_lock_wait[caller].observe(time.perf_counter() - t0)
        try:
            yield
        finally:
            self._lock.release()

    def _device_guard(self):
        """The worker thread's device context: the context's card (a new
        thread starts on the current device 0), or nothing on the CPU."""
        dev = self.ctx.device
        if dev.type != "cuda":
            return contextlib.nullcontext()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return torch.cuda.device(dev)

    def start(self, poll_s: float = 0.001) -> None:
        """Run seal/fold in a background thread: submit() then overlaps
        with folding in wall-clock time too (the state machine already
        allows it logically).  The thread launches on the context's
        device.  An exception in the worker (SimulatedCrash included)
        parks in `worker_error` — drivers re-raise it after stop()."""
        if self._worker is not None:
            raise RuntimeError("worker already running")
        self._stop.clear()
        self.worker_error = None
        guard = self._device_guard()

        def _loop():
            with guard:
                while not self._stop.is_set():
                    try:
                        self.maybe_seal()
                        progressed = self.step()
                    except BaseException as e:  # SimulatedCrash included
                        self.worker_error = e
                        return
                    if not progressed:
                        self._stop.wait(poll_s)

        self._worker = threading.Thread(target=_loop, name="serve-fold",
                                        daemon=True)
        self._worker.start()

    def stop(self) -> None:
        """Stop and join the background worker (idempotent).  The worker
        finishes the step it is in; raises RuntimeError if it has not
        ended within STOP_TIMEOUT_S seconds."""
        if self._worker is None:
            return
        self._stop.set()
        self._worker.join(STOP_TIMEOUT_S)
        if self._worker.is_alive():
            raise RuntimeError(f"the serve worker did not stop within "
                               f"{STOP_TIMEOUT_S} s")
        self._worker = None

    # -- crash + checkpoint plumbing ----------------------------------------

    def _crash(self, point: str) -> None:
        if self.faults is not None:
            self.faults.crash_point(point)

    def _spool(self, rnd: int, rec: dict) -> str:
        """Persist one accepted blob under the checkpoint dir (atomic
        rename, like the checkpoints themselves)."""
        d = os.path.join(self.ckpt_dir, "spool", f"r{rnd:06d}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"u{rec['cid']:08d}.bin")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(rec["blob"])
        os.replace(tmp, path)
        return path

    def _blob(self, rnd: int, rec: dict) -> bytes:
        if rec["blob"] is None:
            with open(rec["path"], "rb") as f:
                rec["blob"] = f.read()
        return rec["blob"]

    def _checkpoint(self, label: str) -> None:
        if self._ckpt is None:
            return
        now = self._clock()
        tree: dict = {}
        rounds_extra: dict = {}
        for rnd, rs in self._rounds.items():
            rx = {
                "status": rs.status,
                "sealed_reason": rs.sealed_reason,
                "accepted": [{k: rec[k] for k in
                              ("cid", "n_samples", "nbytes", "path")}
                             for rec in rs.accepted],
                "rejected": dict(rs.rejected),
                "bad": sorted(rs.bad),
                "weights": rs.weights,
                "cursor": rs.cursor,
                "pass_dirty": rs.pass_dirty,
                "refolds": rs.refolds,
                "deadline_remaining": (
                    self.quorum.deadline_s - rs.elapsed(now)
                    if rs.status == ST_OPEN
                    and self.quorum.deadline_s is not None else None),
                "has_result": rs.result is not None,
            }
            if rnd in self._ingests:
                arrays, meta = self._ingests[rnd].export_state()
                tree[f"ingest_{rnd}"] = arrays
                rx["ingest_meta"] = meta
            if rs.result is not None:
                data, scale, plain = interop.protected_update_to_np(
                    rs.result)
                tree[f"result_{rnd}"] = {"ct_data": data, "plain": plain}
                rx["result_scale"] = scale
            rounds_extra[str(rnd)] = rx
        extra = {
            "serve": {
                "label": label,
                "next_round": self._next_round,
                "open_rnd": self._open_rnd,
                "rounds": rounds_extra,
                "ledger": ([list(dataclasses.astuple(r))
                            for r in self.ledger.records]
                           if self.ledger is not None else None),
            },
        }
        self._ckpt_step += 1
        with obs.span("serve.checkpoint", step=self._ckpt_step,
                      label=label):
            self._ckpt.save(self._ckpt_step, tree, extra)
        self._m_ckpts.inc()
        self._accepts_since_ckpt = 0

    @classmethod
    def resume(cls, ckpt_dir: str, ctx: CkksContext,
               quorum: qr.QuorumPolicy, **kwargs) -> "AggregationService":
        """Rebuild a service from the latest checkpoint under `ckpt_dir`
        (this package's or the JAX package's).

        Accumulators restore as the exact u32 residues / f32 partial sums
        they were checkpointed as, spooled blobs reload from disk, the
        budget ledger replays its records, and deadlines re-anchor to the
        remaining time at checkpoint — continuing the run reproduces the
        uninterrupted run's bits.  Raises FileNotFoundError when no
        checkpoint exists.
        """
        manifest = ckpt_store.read_manifest(ckpt_dir)
        if manifest is None:
            raise FileNotFoundError(
                f"no checkpoint to resume under {ckpt_dir!r}")
        sx = manifest["extra"]["serve"]
        tree_like = {}
        for rnd_s, rx in sx["rounds"].items():
            if "ingest_meta" in rx:
                tree_like[f"ingest_{rnd_s}"] = {
                    "chunk_idx": 0, "acc_ct": 0, "acc_plain": 0}
            if rx.get("has_result"):
                tree_like[f"result_{rnd_s}"] = {"ct_data": 0, "plain": 0}
        tree, step, _ = ckpt_store.restore_checkpoint(ckpt_dir, tree_like)
        svc = cls(ctx, quorum, ckpt_dir=ckpt_dir, **kwargs)
        svc._ckpt_step = step
        svc._next_round = int(sx["next_round"])
        svc._open_rnd = (int(sx["open_rnd"])
                         if sx["open_rnd"] is not None else None)
        now = svc._clock()
        for rnd_s, rx in sx["rounds"].items():
            rnd = int(rnd_s)
            rs = RoundState(rnd, now)
            rs.status = rx["status"]
            rs.sealed_reason = rx["sealed_reason"]
            if rx["deadline_remaining"] is not None:
                # re-anchor: the round keeps the deadline budget it had
                # left when the checkpoint was written
                rs.opened_at = now - (quorum.deadline_s
                                      - rx["deadline_remaining"])
            for rec in rx["accepted"]:
                path = rec["path"]
                blob = None
                if path is not None and os.path.exists(path):
                    with open(path, "rb") as f:
                        blob = f.read()
                rs.accepted.append({"cid": rec["cid"],
                                    "n_samples": rec["n_samples"],
                                    "nbytes": rec["nbytes"],
                                    "blob": blob, "path": path})
                rs.seen_cids.add(int(rec["cid"]))
            rs.rejected = _Counter(rx["rejected"])
            rs.bad = set(rx["bad"])
            rs.weights = rx["weights"]
            rs.cursor = int(rx["cursor"])
            rs.pass_dirty = bool(rx["pass_dirty"])
            rs.refolds = int(rx["refolds"])
            if "ingest_meta" in rx:
                ingest = wire_stream.StreamIngest(
                    ctx, sharded=kwargs.get("sharded"),
                    transcipher_materials=svc.transcipher_materials)
                ingest.restore_state(tree[f"ingest_{rnd_s}"],
                                     rx["ingest_meta"])
                svc._ingests[rnd] = ingest
            if rx.get("has_result"):
                rt = tree[f"result_{rnd_s}"]
                rs.result = interop.protected_update_from_np(
                    rt["ct_data"], rx["result_scale"], rt["plain"],
                    ctx.device)
            svc._rounds[rnd] = rs
        if sx["ledger"] is not None and svc.ledger is not None:
            # replay records directly (no obs re-mirroring: this process's
            # registry starts fresh, the LEDGER must not lose a byte)
            for rec in sx["ledger"]:
                svc.ledger.records.append(wire_budget.WireRecord(*rec))
        return svc
