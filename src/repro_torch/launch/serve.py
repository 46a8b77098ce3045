"""Aggregation-service driver: run FL rounds through repro_torch.serve (the
JAX package's `repro.launch.serve`: the same flags and output lines).

Simulates a client fleet against a live `AggregationService` — partial
quorum, async overlap (round r+1 accepts while round r folds in the
worker thread), optional crash-safe checkpointing and fault injection —
and prints per-round state-machine outcomes plus the bandwidth ledger.
It runs on the card unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --clients 64 \
      --rounds 2 --target 48 --min-clients 16
  PYTHONPATH=src python -m repro_torch.launch.serve --clients 32 \
      --rounds 1 --fault 3:truncate --fault 5:garbage   # wire faults
  PYTHONPATH=src python -m repro_torch.launch.serve --ckpt-dir ckpt \
      --crash-at after_seal                   # then rerun with --resume

The keys come from `torch.Generator(device).manual_seed(0)` and template
s's encryption from a generator seeded with s, where the reference uses
`PRNGKey(0)` and `PRNGKey(s)`.  After a simulated crash, in the worker
or in a transition the driver makes (the reference lets the latter end
in a traceback), it prints where the checkpoint is and exits 1.
DESIGN.md §14 documents the state machine this drives.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import serve
from repro_torch.core.ckks import cipher
from repro_torch.core.ckks import params as ckks_params
from repro_torch.core.secure_agg import ProtectedUpdate
from repro_torch.serve import sim as ssim
from repro_torch.wire import budget as wire_budget
from repro_torch.wire import stream as wire_stream


def _parse_fault(s: str) -> tuple[int, str]:
    cid, _, mode = s.partition(":")
    if mode not in serve.FAULT_MODES:
        raise argparse.ArgumentTypeError(
            f"fault mode {mode!r} not in {serve.FAULT_MODES}")
    return int(cid), mode


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Drive repro_torch.serve.AggregationService with a "
                    "simulated client fleet (DESIGN.md §14).")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--min-clients", type=int, default=4)
    ap.add_argument("--target", type=int, default=None,
                    help="seal as soon as this many updates accepted "
                         "(default: the full fleet)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="round deadline; late submissions are rejected")
    ap.add_argument("--n-poly", type=int, default=256)
    ap.add_argument("--n-chunks", type=int, default=2)
    ap.add_argument("--fold-batch", type=int, default=32)
    ap.add_argument("--fault", action="append", type=_parse_fault,
                    default=[], metavar="CID:MODE",
                    help="inject a wire fault into one client's blob "
                         f"(modes: {', '.join(serve.FAULT_MODES)})")
    ap.add_argument("--crash-at", choices=serve.CRASH_POINTS, default=None,
                    help="simulate kill -9 after this transition "
                         "(needs --ckpt-dir; rerun with --resume)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint every transition under this dir")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the context (cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.crash_at and not args.ckpt_dir:
        ap.error("--crash-at needs --ckpt-dir (the crash leaves only the "
                 "checkpoint behind)")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")

    ctx = ckks_params.make_test_context(n_poly=args.n_poly, n_limbs=2,
                                        delta_bits=20, device=args.device)
    dev = ctx.device
    sk, pk = cipher.keygen(ctx, torch.Generator(dev).manual_seed(0))
    rng = np.random.RandomState(args.seed)

    def template(seed: int) -> bytes:
        v = rng.randn(args.n_chunks, ctx.slots).astype(np.float32)
        ct = cipher.encrypt_values(ctx, pk, torch.from_numpy(v).to(dev),
                                   torch.Generator(dev).manual_seed(seed))
        upd = ProtectedUpdate(ct=ct, plain=torch.from_numpy(
            rng.randn(16).astype(np.float32)).to(dev))
        return wire_stream.pack_update_frames(upd, cid=0, n_samples=1,
                                              rnd=0)

    fleet = ssim.Fleet([template(s) for s in range(4)], args.clients,
                       seed=args.seed)
    pol = serve.QuorumPolicy(min_clients=args.min_clients,
                             target_clients=args.target,
                             deadline_s=args.deadline_s)
    faults = serve.FaultInjector(seed=args.seed,
                                 crash_at=[args.crash_at]
                                 if args.crash_at else (),
                                 blob_faults=dict(args.fault))
    ledger = wire_budget.BandwidthLedger()

    if args.resume:
        svc = serve.AggregationService.resume(
            args.ckpt_dir, ctx, pol, fold_batch=args.fold_batch,
            faults=faults, ledger=ledger)
        print(f"resumed from {args.ckpt_dir}: rounds "
              f"{sorted(svc._rounds)}, open={svc.open_round_id}, "
              f"unfinished={svc.unfinished()}")
    else:
        svc = serve.AggregationService(
            ctx, pol, ckpt_dir=args.ckpt_dir, fold_batch=args.fold_batch,
            faults=faults, ledger=ledger)

    t0 = time.perf_counter()
    crash = None
    try:
        svc.start()
        try:
            for _ in range(args.rounds):
                if svc.open_round_id is not None:
                    rnd = svc.open_round_id       # resumed mid-round
                else:
                    rnd = svc.open_round()
                accepted = rejected = 0
                for cid, blob in fleet.blobs(rnd):
                    res = svc.submit(faults.corrupt(cid, blob))
                    accepted += res.accepted
                    rejected += not res.accepted
                if svc.open_round_id == rnd:  # no target/deadline seal yet
                    svc.seal()
                print(f"round {rnd}: submitted {args.clients}, accepted "
                      f"{accepted}, rejected-at-door {rejected}")
        except serve.SimulatedCrash as e:
            # a transition this thread drove (open, accept, seal) crashed
            crash = e
        while crash is None and svc.unfinished() \
                and svc.worker_error is None:
            time.sleep(0.005)
    finally:
        svc.stop()
    if crash is None and isinstance(svc.worker_error, serve.SimulatedCrash):
        crash = svc.worker_error
    if crash is not None:
        print(f"simulated crash: {crash} — checkpoint is in "
              f"{args.ckpt_dir}; rerun with --resume")
        raise SystemExit(1)
    if svc.worker_error is not None:
        raise svc.worker_error

    wall = time.perf_counter() - t0
    for rnd in sorted(svc._rounds):
        info = svc.round_info(rnd)
        line = (f"round {rnd}: {info['status']} "
                f"(seal={info['sealed_reason']}, accepted="
                f"{info['accepted']}, folded={info['folded']}, "
                f"fold-rejects={info['bad_after_accept']}, "
                f"refolds={info['refolds']})")
        if info["status"] == serve.ST_DONE:
            agg = svc.result(rnd)
            vals = cipher.decrypt_values(ctx, sk, agg.ct)
            line += (f"  |decrypt|max={float(vals.abs().max()):.4f} "
                     f"scale={agg.ct.scale:.3g}")
        print(line)
    up = ledger.total(wire_budget.UPLINK)
    print(f"ledger: {up} uplink bytes over {len(ledger.rounds())} rounds; "
          f"{wall:.2f}s wall")


if __name__ == "__main__":
    main()
