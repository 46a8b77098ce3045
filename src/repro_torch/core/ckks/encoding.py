"""CKKS canonical-embedding encode/decode.

Slots z in C^{N/2} (real payloads here) are the evaluations of the message
polynomial at the 2N-th roots zeta^{idx_j}, idx_j = 5^j mod 2N, so both
directions run as one length-2N FFT:

  encode:  c_k = (2/N) * Re( FFT(scatter(z, idx))[k] ),   k < N
  decode:  z_j = (2N * IFFT(pad(c, 2N)))[idx_j]

Two paths, as in the JAX package:
  * numpy/float64 host path (`encode_np`, `decode_np`), the reference's
    arithmetic unchanged (`encode_centered` runs its rows in blocks on a
    thread pool, with the same bits);
  * torch/complex64 device path (`encode`, `decode`), the counterpart of
    `encode_jnp`/`decode_jnp`.  Its FFT is `torch.fft` (the JAX package
    runs this FFT outside any Pallas kernel too).  Rounding a complex64 FFT
    is not exact across FFT libraries: a coefficient may land one off from
    JAX's, never more (tests/test_torch_encoding.py measures the rate).
"""
from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.ckks.params import CkksContext
from repro_torch.kernels import ref as _ref

_ENCODE_ROWS = 256   # rows per FFT block of encode_centered (64 MiB at N=8192)


@functools.lru_cache(maxsize=32)
def _root_indices(n_poly: int) -> np.ndarray:
    """idx_j = 5^j mod 2N for j = 0..N/2-1."""
    idx = np.empty(n_poly // 2, dtype=np.int64)
    cur = 1
    for j in range(n_poly // 2):
        idx[j] = cur
        cur = cur * 5 % (2 * n_poly)
    return idx


# ---------------------------------------------------------------------------
# numpy / float64 host path
# ---------------------------------------------------------------------------


def encode_centered(values: np.ndarray, ctx: CkksContext,
                    delta: float | None = None) -> np.ndarray:
    """Real values [B, slots] -> centered integer coefficients i64[B, N].

    The rows go through the FFT in blocks of _ENCODE_ROWS on a thread pool
    (numpy's FFT releases the GIL): each row's FFT is computed alone, so
    the bits are the reference's, and the complex128 buffer is one block's,
    not [B, 2N] (2.97 GB at 11,328 rows of N=8192)."""
    if values.ndim == 1:
        values = values[None]
    b = values.shape[0]
    n = ctx.n_poly
    if values.shape[1] != ctx.slots:
        raise ValueError(f"values {values.shape} do not fill {ctx.slots} "
                         "slots")
    delta = float(delta if delta is not None else ctx.delta)
    idx = _root_indices(n)
    out = np.empty((b, n), dtype=np.int64)

    def block(r):
        buf = np.zeros((min(_ENCODE_ROWS, b - r), 2 * n),
                       dtype=np.complex128)
        buf[:, idx] = values[r:r + _ENCODE_ROWS].astype(np.float64)
        c = (2.0 / n) * np.real(np.fft.fft(buf, axis=-1))[:, :n]
        out[r:r + _ENCODE_ROWS] = np.rint(c * delta).astype(np.int64)

    starts = range(0, b, _ENCODE_ROWS)
    if len(starts) == 1:
        block(0)
    else:
        with ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as ex:
            list(ex.map(block, starts))
    return out  # [B, N]


def encode_np(values: np.ndarray, ctx: CkksContext,
              delta: float | None = None) -> np.ndarray:
    """Real values [B, slots] -> coefficient-domain residues u32[B, L, N]."""
    c_int = encode_centered(values, ctx, delta)
    qs = np.asarray(ctx.primes, dtype=np.int64)[None, :, None]
    return (c_int[:, None, :] % qs).astype(np.uint32)  # [B, L, N]


def decode_np(residues: np.ndarray, ctx: CkksContext,
              scale: float) -> np.ndarray:
    """Coefficient-domain residues u32[B, L, N] -> real values [B, slots].

    Garner CRT reconstruction (exact per-step u64), centered, then f64 FFT.
    """
    b, n_limbs, n = residues.shape
    if n != ctx.n_poly:
        raise ValueError(f"residues have N={n}, context N={ctx.n_poly}")
    primes = ctx.primes[:n_limbs]
    x = residues.astype(np.uint64)
    ts = [x[:, 0, :]]
    for i in range(1, n_limbs):
        qi = primes[i]
        acc = ts[0] % qi
        mod_prod = 1
        for k in range(1, i):
            mod_prod = mod_prod * primes[k - 1] % qi
            acc = (acc + ts[k] % qi * (mod_prod % qi)) % qi
        full = 1
        for k in range(i):
            full = full * primes[k] % qi
        inv = pow(full, -1, qi)
        ts.append((x[:, i, :] + qi - acc) % qi * inv % qi)
    # exact big-int accumulation: f64 would round above 2**53
    value = np.zeros((b, n), dtype=object)
    prod = 1
    for i, t in enumerate(ts):
        value += t.astype(object) * prod
        prod *= int(primes[i])
    big_q = 1
    for p in primes:
        big_q *= int(p)
    value = np.where(value > big_q // 2, value - big_q, value)
    c = (value / float(scale)).astype(np.float64)
    z = 2 * n * np.fft.ifft(np.pad(c, ((0, 0), (0, n))), axis=-1)
    return np.real(z[:, _root_indices(n)])


def encode_scalar_residues(w: float, ctx: CkksContext,
                           delta: float | None = None,
                           mont: bool = True) -> np.ndarray:
    """Scalar plaintext (constant poly) per-limb residues, optionally in
    Montgomery form.  Returns u32[L]."""
    return encode_weights_mont([w], ctx, delta=delta, mont=mont)[0]


def encode_weights_mont(weights, ctx: CkksContext, delta: float | None = None,
                        mont: bool = True) -> np.ndarray:
    """Batch of scalar weights -> stacked per-limb residues u32[C, L]
    (exact: w*delta < 2**31 and q < 2**30, so r * 2**32 < 2**62)."""
    delta = float(delta if delta is not None else ctx.delta)
    w_int = np.asarray([int(round(float(w) * delta)) for w in weights],
                       dtype=np.int64)[:, None]                  # [C, 1]
    qs = np.asarray(ctx.primes, dtype=np.int64)[None, :]         # [1, L]
    r = w_int % qs
    if mont:
        r = (r << 32) % qs
    return r.astype(np.uint32)


# ---------------------------------------------------------------------------
# torch / complex64 device path
# ---------------------------------------------------------------------------


def _root_index_tensor(ctx: CkksContext, device) -> torch.Tensor:
    return torch.from_numpy(_root_indices(ctx.n_poly)).to(device)


def encode(values, ctx: CkksContext, delta: float | None = None):
    """Real values float32[B, slots] -> coefficient residues
    int32[B, L, N] on the values' device (the `encode_jnp` counterpart),
    under an `he.encode` span timed on that device."""
    n = ctx.n_poly
    delta = float(delta if delta is not None else ctx.delta)
    dev = values.device
    b = values.shape[0]
    with obs.span("he.encode", device=dev, rows=b):
        buf = torch.zeros((b, 2 * n), dtype=torch.complex64, device=dev)
        buf[:, _root_index_tensor(ctx, dev)] = values.to(torch.complex64)
        c = (2.0 / n) * torch.fft.fft(buf, dim=-1).real[:, :n]
        del buf
        c_int = torch.round(c * delta).to(torch.int32)
        qs = ctx.device_tables.qs.to(dev)[:, None]
        return _ref.mod_reduce_centered(c_int[:, None, :], qs)  # [B, L, N]


def decode(residues, ctx: CkksContext, scale: float):
    """int32[B, 2, N] coefficient residues -> float32[B, slots] (the
    `decode_jnp` counterpart).

    Two-limb Garner in int64: t1 = (x1 - x0) q0^{-1} mod q1 and
    v = x0 + q0*t1 < 2**60 are exact, then v is centered mod Q = q0*q1.
    The magnitude goes to float32 as hi * 2**32 + lo, the same rounding as
    `decode_jnp`'s (hi, lo) pair, so only the FFT differs from JAX's.
    """
    if residues.shape[1] != 2:
        raise ValueError("the torch decode path supports 2 limbs")
    n = ctx.n_poly
    q0, q1 = ctx.primes[0], ctx.primes[1]
    x0 = residues[:, 0, :].to(torch.int64)
    x1 = residues[:, 1, :].to(torch.int64)
    t1 = (x1 - x0 % q1) % q1 * pow(q0, -1, q1) % q1
    v = x0 + q0 * t1
    del x0, x1, t1
    big_q = q0 * q1
    neg = v > big_q // 2
    mag = torch.where(neg, big_q - v, v)
    del v
    mag = ((mag >> 32).to(torch.float32) * 4294967296.0
           + (mag & 0xFFFFFFFF).to(torch.float32))
    c = torch.where(neg, -mag, mag) / torch.tensor(float(scale),
                                                   dtype=torch.float32)
    del mag, neg
    buf = torch.zeros((c.shape[0], 2 * n), dtype=torch.complex64,
                      device=c.device)
    buf[:, :n] = c
    z = (2 * n) * torch.fft.ifft(buf, dim=-1)
    del buf
    return z[:, _root_index_tensor(ctx, c.device)].real.to(torch.float32)
