"""The 4-step NTT kernels with and without their twist, beside the flat
kernels, on one NVIDIA GPU.

    python3 tools/ntt4_ablation.py [--reps 20]

Times, with CUDA events at `[11328, 2, 8192]` (the in-memory round's
ciphertext rows at make_context()'s parameters): the flat kernels; the
4-step kernels at every `ntt4_split_candidates(8192)` split; and the same
4-step kernels built from a copy of `csrc/` in a temporary directory whose
`ntt4.cu` never runs the twist (`Ntt4Twiddles::twists_after` returns
false), then the real 4-step kernels again.  The twist-free kernels' output
is wrong and is not used: they do the 4-step's register passes, the copy of
psi1 / psi2 into shared memory and its index arithmetic, without the corr
products.  So twist-free minus flat is what reading twiddles from the
block's small shared tables costs or saves against the flat kernel's N-word
table read through L1, and real minus twist-free is the twist's cost.
Prints one JSON line per variant and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import torch  # noqa: E402

from repro_torch.core.ckks import cipher, params  # noqa: E402
from repro_torch.kernels import build, ntt, ops, tune  # noqa: E402

ROWS = 11328
NO_TWIST = ("return log_n1 == kLogN - (kInv ? 1 : 0) - bit;", "return false;")


def time_ms(fn, reps):
    """Mean device time of fn() over reps launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_ntt4(ctx, x, reps):
    """{"<op> <n1>x<n2>": ms} of both 4-step kernels at every split."""
    out = {}
    for n1, n2 in params.ntt4_split_candidates(ctx.n_poly):
        tables = ctx.split_device_tables((n1, n2))
        cfg = tune.KernelConfig(block_b=1, ntt4_split=(n1, n2))
        for op in tune.OPS:
            out[f"{op} {n1}x{n2}"] = time_ms(
                lambda: ops.run_config(op, "ntt4", cfg, tables, x), reps)
    return out


def no_twist_build(tmp: pathlib.Path) -> None:
    """Point build at a copy of csrc/ whose ntt4.cu skips the twist."""
    csrc = tmp / "csrc"
    shutil.copytree(build.CSRC, csrc)
    path = csrc / "ntt4.cu"
    text = path.read_text()
    if NO_TWIST[0] not in text:
        raise RuntimeError("ntt4.cu's twists_after changed: update NO_TWIST")
    path.write_text(text.replace(*NO_TWIST))
    build.CSRC, build.BUILD_DIR = csrc, tmp / "_build"
    build._LIBS.pop("ntt4", None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ntt4_ablation: no CUDA device", file=sys.stderr)
        return 1
    ctx = params.make_context()
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    x = cipher.sample_uniform(gen, (ROWS, ctx.n_poly), ctx)
    t = ctx.device_tables
    rows = {"flat": {
        "ntt_fwd": time_ms(lambda: ntt.ntt_fwd_fused(
            x, t.psi_rev_mont, t.qs, t.qinv_negs), args.reps),
        "ntt_inv": time_ms(lambda: ntt.ntt_inv_fused(
            x, t.psi_inv_rev_mont, t.n_inv_monts, t.qs, t.qinv_negs),
            args.reps)}}
    rows["ntt4"] = time_ntt4(ctx, x, args.reps)
    csrc, build_dir = build.CSRC, build.BUILD_DIR
    try:
        with tempfile.TemporaryDirectory() as d:
            no_twist_build(pathlib.Path(d))
            rows["ntt4 without the twist"] = time_ntt4(ctx, x, args.reps)
    finally:
        build.CSRC, build.BUILD_DIR = csrc, build_dir
        build._LIBS.pop("ntt4", None)
    rows["ntt4 again"] = time_ntt4(ctx, x, args.reps)
    for name, times in rows.items():
        print(json.dumps({"variant": name, "ms": times}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
