"""What every kind of cell shares: the program's context, keys, global
model and mask, made from the seed, and the window's loop."""
from __future__ import annotations

import time

import inputs

from repro_torch.core.ckks import cipher, params
from repro_torch.core.secure_agg import AggregatorConfig, SelectiveHEAggregator


def ckks_params(cfg: dict, delta_bits=None) -> dict:
    """The configuration's CKKS parameters; `delta_bits` lowers the scale
    (the lower-precision control)."""
    ck = dict(cfg["ckks"])
    if delta_bits is not None:
        ck["delta_bits"] = int(delta_bits)
    return ck


def build(cfg: dict, ck: dict, p: float, run):
    """(ctx, sk, pk, base vector, SelectiveHEAggregator) of the seed: keys
    from seeded samples, the mask the top-p of a seeded sensitivity map."""
    dev = run.device
    ctx = params.make_context(
        n_poly=ck["n_poly"], n_limbs=ck["n_limbs"],
        delta_bits=ck["delta_bits"], max_prime_bits=ck["max_prime_bits"],
        device=dev)
    s, a, e = inputs.key_samples(ctx.n_poly, ctx.primes, ck["error_sigma"],
                                 run.seed, dev)
    sk, pk = cipher.keygen_from_samples(ctx, s, a, e)
    base = inputs.base_vector(cfg, run.seed, dev)
    sens = inputs.sensitivity(cfg, run.seed, dev)
    agg = SelectiveHEAggregator.build(
        ctx, inputs.tree(cfg, base), sens,
        AggregatorConfig(p_ratio=p, strategy="top_p"))
    del sens
    part = agg.part
    run.geometry.update(n_params=part.n_total, n_enc=part.n_enc,
                        n_plain=part.n_plain, rows=part.n_chunks,
                        n_limbs=ctx.n_limbs, n_poly=ctx.n_poly)
    return ctx, sk, pk, base, agg


def loop(run, step) -> None:
    """Call step(0), step(1), ... while the window's clock is under
    `--seconds`, each to the end of its device work, keeping its seconds
    in run.units: the window ends with its last whole round or turn."""
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        t = time.perf_counter()
        step(n)
        run.sync()
        run.units.append(time.perf_counter() - t)
        n += 1
    run.counters.update(attempted=n, failed=0)
