"""End-to-end training driver on one device (the JAX package's
`repro.launch.train`: the same flags and printed lines, plus --device).

It runs the reduced (--smoke, the default) configs or, with --no-smoke,
the full ones.  Checkpoint/restart fault tolerance: kill the process
mid-run and re-launch it on the same --ckpt-dir; it resumes from the last
checkpoint of {"p": params, "o": AdamW state}, in the JAX package's
format (either package resumes the other's).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 50 --batch 8 --seq 32 --ckpt-dir run1 --device cpu

Three faults of the reference are not copied.  Its `--smoke` is
`store_true` with default True, so the full config can never be chosen;
here `--no-smoke` chooses it.  Its resumed run draws the data stream from
the start again, so steps after a restart see other batches than the
uninterrupted run's; here the stream skips the batches of the steps the
checkpoint holds, and a resumed run reaches the uninterrupted run's
parameters.  It saves the last step a second time when the loop has just
saved it (--steps a multiple of --ckpt-every); here it is saved once.

Like the reference, the loop reads the device only on log steps.  With
obs enabled (`obs.configure(enabled=True)`), each step runs in a
`train.step` span that waits for its device work, each save in a
`train.checkpoint` span and the resume in `train.restore`; they are off
by default.  `main` returns the run's state and its losses to an
in-process caller.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, interop, obs
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.ckks.params import resolve_device
from repro_torch.data import SyntheticLM, dirichlet_partition
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init


def restore(mgr: CheckpointManager, params, opt_state, device):
    """-> (params, opt_state, step) of mgr's latest checkpoint on `device`,
    or the given trees and None when there is none."""
    tree, s, _ = mgr.restore({"p": params, "o": opt_state})
    if tree is None:
        return params, opt_state, None
    return (interop.params_from_np(tree["p"], device),
            interop.params_from_np(tree["o"], device), s)


def main(argv=None) -> dict:
    """Run the driver; -> {"params", "opt", "start", "losses"}: the final
    state, the first step this run took, and each step's loss, a 0-d
    tensor on the device, by step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the reduced config (default); --no-smoke runs "
                         "the full one")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    opt_state = adamw_init(params)
    step_fn = steps.make_train_step(model, AdamWConfig(lr=args.lr),
                                    warmup=10, total_steps=args.steps)

    start, saved = 0, -1        # saved: the step the directory holds last
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr:
        with obs.span("train.restore"):
            params, opt_state, s = obs.maybe_block(
                restore(mgr, params, opt_state, dev))
        if s is not None:
            start, saved = s + 1, s
            print(f"resumed from step {s}")

    prior = dirichlet_partition(1, cfg.vocab, alpha=100.0)[0]
    stream = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                         batch_size=args.batch, client_prior=prior)
    for _ in range(start):       # the batches the checkpoint has seen
        stream.next_batch()
    losses = {}
    t0 = time.time()
    for step in range(start, args.steps):
        with obs.span("train.step", step=step):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     stream.next_batch().items()}
            params, opt_state, metrics = obs.maybe_block(
                step_fn(params, opt_state, batch))
        losses[step] = metrics["loss"]
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq * (step - start + 1) \
                / max(1e-9, time.time() - t0)
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} tok/s={tok_s:.0f}")
        if mgr and (step + 1) % args.ckpt_every == 0:
            with obs.span("train.checkpoint", step=step):
                mgr.save(step, {"p": params, "o": opt_state})
            saved = step
    if mgr and saved != args.steps - 1:
        with obs.span("train.checkpoint", step=args.steps - 1):
            mgr.save(args.steps - 1, {"p": params, "o": opt_state})
    print("done")
    return {"params": params, "opt": opt_state, "start": start,
            "losses": losses}


if __name__ == "__main__":
    main()
