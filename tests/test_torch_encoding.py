"""The port's CKKS encode/decode against the JAX package.

The numpy host path is a copy and must agree exactly.  The device path
rounds a complex64 FFT from another library than JAX's, so a coefficient of
`encode` may land off from `encode_jnp`'s.  Where the FFT's float32 error
stays below one unit of delta (delta=2^20), a coefficient is at most one
off, at a measured rate bounded by ENCODE_FLIP_RATE.  At the paper's
delta=2^26 the float32 mantissa is coarser than a unit, both FFTs are a few
units from the exact value, and the two differ by at most ENCODE_MAX_DIFF_26
(measured 3 at N=256), well inside the encryption noise's own spread.
`decode` agrees with `decode_jnp` to float32 FFT rounding (DECODE_ATOL).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.ckks import encoding as jenc
from repro.core.ckks import params as jparams

from repro_torch import interop
from repro_torch.core.ckks import encoding as tenc
from repro_torch.core.ckks import params as tparams
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

NS = (256, 1024)
# measured on these inputs at delta=2^20: 0.49% (N=256) and 0.26%
# (N=1024) of coefficients one off; bounded with margin
ENCODE_FLIP_RATE = 0.02
# measured at delta=2^26: max |diff| 3 (N=256), 2 (N=1024)
ENCODE_MAX_DIFF_26 = 4
# |decode - decode_jnp| for values ~N(0,1): float32 FFT rounding of length
# 2N, measured 4.8e-7
DECODE_ATOL = 1e-5


# one compiled graph instead of op-by-op dispatch (the JAX package jits
# both inside its encrypt/decrypt graphs too)
_decode_jnp = jax.jit(jenc.decode_jnp, static_argnums=(1, 2))


def _ctxs(n, delta_bits=26):
    return (jparams.make_context(n_poly=n, n_limbs=2, delta_bits=delta_bits),
            tparams.make_context(n_poly=n, n_limbs=2, delta_bits=delta_bits,
                                 device="cpu"))


def _values(n, rows=4, seed=0):
    return np.random.RandomState(seed + n).randn(rows, n // 2).astype(
        np.float32)


@pytest.mark.parametrize("n", NS)
def test_host_path_is_exact_copy(n):
    jctx, tctx = _ctxs(n)
    v = _values(n)
    np.testing.assert_array_equal(tenc.encode_np(v, tctx),
                                  jenc.encode_np(v, jctx))
    np.testing.assert_array_equal(tenc.encode_centered(v, tctx),
                                  jenc.encode_centered(v, jctx))
    res = jenc.encode_np(v, jctx)
    np.testing.assert_array_equal(tenc.decode_np(res, tctx, jctx.delta),
                                  jenc.decode_np(res, jctx, jctx.delta))
    w = [0.25, 1 / 3, 0.75]
    np.testing.assert_array_equal(tenc.encode_weights_mont(w, tctx),
                                  jenc.encode_weights_mont(w, jctx))
    np.testing.assert_array_equal(tenc.encode_scalar_residues(0.5, tctx),
                                  jenc.encode_scalar_residues(0.5, jctx))


def _encode_diff(n, delta_bits):
    """Centered coefficient difference encode - encode_jnp, [B, N]."""
    jctx, tctx = _ctxs(n, delta_bits)
    v = _values(n, rows=8)
    got = interop.residues_to_np(tenc.encode(torch.from_numpy(v), tctx))
    want = np.asarray(jax.jit(jenc.encode_jnp, static_argnums=1)(
        jnp.asarray(v), jctx))
    q = np.asarray(jctx.primes, dtype=np.int64)[None, :, None]
    d = (got.astype(np.int64) - want.astype(np.int64)) % q
    d = np.where(d > q // 2, d - q, d)
    # one rounding decision per coefficient, shared by both limbs
    np.testing.assert_array_equal(d[:, 0], d[:, 1])
    return d[:, 0]


@pytest.mark.parametrize("n", NS)
def test_device_encode_matches_encode_jnp_up_to_one(n):
    d = _encode_diff(n, delta_bits=20)
    assert np.abs(d).max() <= 1
    assert np.mean(d != 0) <= ENCODE_FLIP_RATE


@pytest.mark.parametrize("n", NS)
def test_device_encode_at_paper_delta(n):
    assert np.abs(_encode_diff(n, delta_bits=26)).max() <= ENCODE_MAX_DIFF_26


@pytest.mark.parametrize("n", NS)
def test_device_decode_matches_decode_jnp(n):
    jctx, tctx = _ctxs(n)
    res = jenc.encode_np(_values(n, seed=1), jctx)
    scale = jctx.delta
    got = tenc.decode(interop.residues_from_np(res, "cpu"), tctx,
                      scale).numpy()
    want = np.asarray(_decode_jnp(jnp.asarray(res), jctx, scale))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=DECODE_ATOL)
    # and both recover the values
    np.testing.assert_allclose(got, _values(n, seed=1), rtol=0, atol=1e-4)


def test_decode_handles_negative_and_wide_coefficients():
    """Centering mod Q = q0*q1 at the depth-1 scale delta**2."""
    jctx, tctx = _ctxs(256, delta_bits=20)
    v = 8 * _values(256, seed=2)
    res = jenc.encode_np(v, jctx, delta=jctx.delta ** 2)
    got = tenc.decode(interop.residues_from_np(res, "cpu"), tctx,
                      jctx.delta ** 2).numpy()
    want = np.asarray(_decode_jnp(jnp.asarray(res), jctx, jctx.delta ** 2))
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * DECODE_ATOL)
