#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Three phases; any failure exits non-zero, and without CUDA the script exits
non-zero before doing anything:

1. build: nvcc builds every kernel under src/repro_torch/kernels/csrc/ for
   sm_90a (one nvcc per source, started together);
2. kernels: each kernel's wrapper runs on the card at the main path's shapes
   and is held against its plain PyTorch version on the same inputs with
   exact integer equality, timed with CUDA events; a small encrypt/decrypt
   on the card is held bit for bit against the same draws on the CPU;
3. main path: the paper's Algorithm 1 round at full width -- make_context()
   (N=8192, L=2, delta=2^26), keygen, three clients' Qwen1.5-0.5B-sized
   updates (463,987,712 float32 parameters, top 10% encrypted in 11,328
   ciphertexts each) through client_protect, server_aggregate and
   client_recover_params -- with the launch counters set to 0 just before
   it and read just after.  The recovered average must be within 1e-2 of
   the plaintext FedAvg (the quickstart's bound).  torch.profiler traces
   the round and the script prints the device's busy share and its time
   by kernel.

The last lines are the card's name and power limit (nvidia-smi), one JSON
line with every kernel's numbers, and the JSON result line.
"""
import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.ckks import cipher, encoding, params  # noqa: E402
from repro_torch.core.secure_agg import (  # noqa: E402
    AggregatorConfig, SelectiveHEAggregator)
from repro_torch.kernels import (  # noqa: E402
    build, he_agg, ntt, ops, pointwise, ref)

# Qwen1.5-0.5B (src/repro/configs/qwen1_5_0_5b.py: 24 layers, d_model 1024,
# d_ff 2816, vocab 151936, QKV bias, tied embeddings): the 14 parameter
# leaves of the JAX package's transformer.init_abstract, 463,987,712 values.
D, F, NL, V = 1024, 2816, 24, 151936
QWEN_LEAVES = {
    "embed": (V, D),
    "layers": {
        "bk": (NL, D), "bq": (NL, D), "bv": (NL, D),
        "ln1": (NL, D), "ln2": (NL, D),
        "w_down": (NL, F, D), "w_gate": (NL, D, F), "w_up": (NL, D, F),
        "wk": (NL, D, D), "wo": (NL, D, D), "wq": (NL, D, D),
        "wv": (NL, D, D),
    },
    "ln_f": (D,),
}
N_PARAMS = 463_987_712
N_CLIENTS = 3
P_RATIO = 0.1
EXPECTED_LAUNCHES = {"ntt_fwd": 14, "ntt_inv": 1, "mul_add": 7,
                     "weighted_sum": 1}
MAX_ERR = 1e-2

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 3.35 TB/s; 67 TFLOP/s
# float32 outside the tensor cores, the rate the integer multiplies are
# counted against (Hopper issues 32-bit integer multiplies at no more than
# that rate, so the operations bound is a lower bound).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
MULS_PER_MONT = 3          # a*b, lo(t)*(-q^-1), m*q

KERNELS = {
    # name: (CUDA source, the TPU kernel it replaces)
    "ntt_fwd": ("src/repro_torch/kernels/csrc/ntt.cu",
                "src/repro/kernels/ntt.py:46"),
    "ntt_inv": ("src/repro_torch/kernels/csrc/ntt.cu",
                "src/repro/kernels/ntt.py:66"),
    "mul_add": ("src/repro_torch/kernels/csrc/pointwise.cu",
                "src/repro/kernels/pointwise.py:26"),
    "weighted_sum": ("src/repro_torch/kernels/csrc/he_agg.cu",
                     "src/repro/kernels/he_agg.py:32"),
}


def log(msg):
    print(msg, flush=True)


def leaves(tree, out=None):
    """Leaves of a nested dict in sorted-key order."""
    out = [] if out is None else out
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            leaves(tree[k], out)
        else:
            out.append(tree[k])
    return out


def map_tree(fn, tree):
    return {k: map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def n_ciphertexts(slots):
    n_enc = int(round(N_PARAMS * P_RATIO))
    return -(-n_enc // slots)


def time_ms(fn, reps):
    """Mean device time of fn() over reps launches, by CUDA events."""
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


def bound(nbytes, nops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------


def check_kernels(ctx, gen, n_rows):
    """Returns {name: row of the kernels JSON line} (launches filled later)."""
    dev = ctx.device
    t = ctx.device_tables
    l, n = ctx.n_limbs, ctx.n_poly
    log_n = n.bit_length() - 1

    def uniform(shape):
        return cipher.sample_uniform(gen, shape, ctx)

    x = uniform((n_rows, n))                                    # [B, L, N]
    z = uniform((n_rows, n))
    y = uniform((1, n))                                         # pk, bcast
    cts = torch.stack([uniform((n_rows, 2, n)).movedim(-2, -3).contiguous()
                       for _ in range(N_CLIENTS)])              # [C,B,L,2,N]
    w = torch.from_numpy(encoding.encode_weights_mont(
        [1.0 / N_CLIENTS] * N_CLIENTS, ctx).view(np.int32).copy()).to(dev)
    elems = x.numel()
    ntt_muls = MULS_PER_MONT * (n // 2) * log_n * (elems // n)
    cases = {
        "ntt_fwd": (
            lambda: ntt.ntt_fwd_fused(x, t.psi_rev_mont, t.qs, t.qinv_negs),
            lambda: ref.ntt_fwd_fused(x, t.psi_rev_mont, t.qs, t.qinv_negs),
            x.shape, 4 * (2 * elems + l * n + 2 * l), ntt_muls),
        "ntt_inv": (
            lambda: ntt.ntt_inv_fused(x, t.psi_inv_rev_mont, t.n_inv_monts,
                                      t.qs, t.qinv_negs),
            lambda: ref.ntt_inv_fused(x, t.psi_inv_rev_mont, t.n_inv_monts,
                                      t.qs, t.qinv_negs),
            x.shape, 4 * (2 * elems + l * n + 3 * l),
            ntt_muls + MULS_PER_MONT * elems),
        "mul_add": (
            lambda: pointwise.mul_add_fused(x, y, z, t.qs, t.qinv_negs),
            lambda: ref.mul_add_fused(x, y, z, t.qs, t.qinv_negs),
            x.shape, 4 * (3 * elems + l * n + 2 * l), MULS_PER_MONT * elems),
        "weighted_sum": (
            lambda: he_agg.he_weighted_sum_fused(cts, w, t.qs, t.qinv_negs,
                                                 limb_axis=-3),
            lambda: ref.he_weighted_sum_fused(cts, w, t.qs, t.qinv_negs,
                                              limb_axis=-3),
            cts.shape,
            4 * ((N_CLIENTS + 1) * cts[0].numel() + N_CLIENTS * l + 2 * l),
            MULS_PER_MONT * N_CLIENTS * cts[0].numel()),
    }
    rows = {}
    for name, (kern, plain, shape, nbytes, nops) in cases.items():
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: kernel gives {got.shape} "
                                 f"{got.dtype}, plain {want.shape} "
                                 f"{want.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max |diff| {err})")
        del got, want
        ms = time_ms(kern, 10)
        plain_ms = time_ms(plain, 2)
        bound_ms, bound_by = bound(nbytes, nops)
        source, replaces = KERNELS[name]
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": None,
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": None}
        log(f"kernel {name}: exact at {tuple(shape)}  ms={ms:.4f}  "
            f"plain_ms={plain_ms:.4f}  bound_ms={bound_ms:.4f} ({bound_by}, "
            f"{nbytes / 1e9:.3f} GB, {nops / 1e9:.3f} G int mul)  "
            f"library call: none")
    log("kernels: " + ", ".join(rows))
    return rows


def check_small_round_against_cpu(ctx, seed):
    """Encrypt and decrypt a few ciphertexts with the same draws on the card
    (kernels) and on the CPU (plain versions): bit-identical."""
    cpu_ctx = params.make_context(n_poly=ctx.n_poly, n_limbs=ctx.n_limbs,
                                  delta_bits=ctx.delta_bits, device="cpu")
    rng = np.random.RandomState(seed)
    n, b = ctx.n_poly, 4
    draws = {"s": rng.randint(-1, 2, n), "e": np.rint(3.2 * rng.randn(n)),
             "u": rng.randint(-1, 2, (b, n)),
             "e0": np.rint(3.2 * rng.randn(b, n)),
             "e1": np.rint(3.2 * rng.randn(b, n))}
    a = np.stack([rng.randint(0, q, n) for q in ctx.primes])
    vals = rng.randn(b, ctx.slots).astype(np.float32)
    out = {}
    for c in (ctx, cpu_ctx):
        d = {k: torch.from_numpy(v.astype(np.int32)).to(c.device)
             for k, v in draws.items()}
        sk, pk = cipher.keygen_from_samples(
            c, d["s"], torch.from_numpy(a.astype(np.int32)).to(c.device),
            d["e"])
        m = encoding.encode_np(vals, c).view(np.int32)
        ct = cipher.encrypt_coeffs_from_samples(
            c, pk, torch.from_numpy(m.copy()).to(c.device), d["u"], d["e0"],
            d["e1"])
        agg = cipher.weighted_sum(c, cipher.Ciphertext(
            torch.stack([ct.data, ct.data]), ct.scale), [0.25, 0.75])
        out[c.device.type] = (ct.data.cpu(), agg.data.cpu(),
                              cipher.decrypt_to_coeffs(c, sk, agg).cpu())
    for got, want, what in zip(out["cuda"], out["cpu"],
                               ("ciphertexts", "aggregate", "decryption")):
        if not torch.equal(got, want):
            raise AssertionError(f"small round: {what} on the card differ "
                                 "from the CPU's")
    dec = cipher.decrypt_values_np(
        cpu_ctx, sk, cipher.Ciphertext(out["cpu"][1], ctx.delta ** 2))
    err = float(np.abs(dec - vals).max())
    if not err < MAX_ERR:
        raise AssertionError(f"small round: decode error {err}")
    log(f"small round ({b} ciphertexts, N={n}): card == CPU bit for bit, "
        f"decode error {err:.3e}")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def traced():
    """torch.profiler over the main path: prints the device time by kernel
    name and the device's busy share of the host clock (the union of the
    device-side events' intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    if not spans:
        raise AssertionError("the profiler recorded no device events")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    log(f"profile: device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
        f"host clock (idle share {1 - busy / wall_us:.4f}), "
        f"{len(spans)} device events")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"profile: {us / 1e3:10.3f} ms  {name[:100]}")


def main_path(seed):
    """The Algorithm 1 round at Qwen1.5-0.5B width; returns launch counts."""
    sync = torch.cuda.synchronize
    times = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()

    ctx = params.make_context()
    gen = torch.Generator(device=ctx.device).manual_seed(seed)
    sk, pk = cipher.keygen(ctx, gen)
    sync()
    times["keygen"] = time.perf_counter() - t0

    t = time.perf_counter()
    model = map_tree(lambda s: torch.randn(s, generator=gen,
                                           device=ctx.device), QWEN_LEAVES)
    sens = torch.randn(N_PARAMS, generator=gen, device=ctx.device).abs_()
    agg = SelectiveHEAggregator.build(
        ctx, model, sens, AggregatorConfig(p_ratio=P_RATIO, strategy="top_p"))
    del sens
    sync()
    times["build (top-p mask)"] = time.perf_counter() - t
    rep = agg.overhead_report()
    if rep["n_total"] != N_PARAMS or rep["n_ciphertexts"] != \
            n_ciphertexts(ctx.slots):
        raise AssertionError(f"unexpected partition: {rep}")
    log(f"main path: {rep['n_enc']}/{rep['n_total']} parameters encrypted "
        f"in {rep['n_ciphertexts']} ciphertexts per client")

    updates, expect = [], 0
    for i in range(N_CLIENTS):
        client = map_tree(lambda p: p + 0.1 * i, model)
        t = time.perf_counter()
        updates.append(agg.client_protect(
            client, pk, torch.Generator(device=ctx.device).manual_seed(
                seed + 10 + i)))
        sync()
        times[f"client_protect[{i}]"] = time.perf_counter() - t
        expect = expect + torch.cat([p.reshape(-1) for p in leaves(client)])
        del client
    for u in updates:
        if tuple(u.ct.data.shape) != (rep["n_ciphertexts"], 2, 2,
                                      ctx.n_poly):
            raise AssertionError(f"ciphertext shape {u.ct.data.shape}")

    t = time.perf_counter()
    glob = agg.server_aggregate(updates, [1 / N_CLIENTS] * N_CLIENTS)
    sync()
    times["server_aggregate"] = time.perf_counter() - t
    del updates

    t = time.perf_counter()
    recovered = agg.client_recover_params(glob, sk)
    sync()
    times["client_recover_params"] = time.perf_counter() - t
    total_s = time.perf_counter() - t0
    counts = ops.launch_counts()

    expect = expect / N_CLIENTS           # plaintext FedAvg, flat
    got_leaves = leaves(recovered)
    if [tuple(p.shape) for p in got_leaves] != leaves(QWEN_LEAVES):
        raise AssertionError("recovered leaves have the wrong shapes")
    got = torch.cat([p.reshape(-1) for p in got_leaves])
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("recovered parameters are not finite")
    err = float((got - expect).abs().max())
    for name, s in times.items():
        log(f"main path time {name}: {s:.3f} s")
    log(f"main path total: {total_s:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"main path max |recovered - plaintext FedAvg| = {err:.3e} "
        f"(bound {MAX_ERR})")
    if not err < MAX_ERR:
        raise AssertionError(f"FedAvg error {err} >= {MAX_ERR}")
    log(f"main path launches: {json.dumps(counts)}")
    if counts != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {counts} != "
                             f"{EXPECTED_LAUNCHES}")
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if sum(math.prod(s) for s in leaves(QWEN_LEAVES)) != N_PARAMS:
        raise AssertionError("Qwen1.5-0.5B leaf shapes do not add up")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    build.load_all()
    log(f"phase 1 build: {time.perf_counter() - t:.1f} s "
        f"({', '.join(build.SOURCES)} for sm_90a)")

    ctx = params.make_context()
    gen = torch.Generator(device=ctx.device).manual_seed(args.seed)
    rows = check_kernels(ctx, gen, n_ciphertexts(ctx.slots))
    check_small_round_against_cpu(ctx, args.seed)
    del ctx, gen
    torch.cuda.empty_cache()

    with traced():
        counts = main_path(args.seed)
    for name, row in rows.items():
        row["launches"] = counts[name]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
