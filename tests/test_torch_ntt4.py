"""The port's 4-step NTT against the JAX package.

The 4-step tables (`ntt4_split`, `ntt4_split_candidates`, the six `ntt4_*`
fields and `retable_ntt4` at every candidate split) must equal JAX's bit for
bit; the plain `ntt4_fwd_fused` / `ntt4_inv_fused` must equal JAX's
interpret-mode Pallas kernels for 3 splits x radix {2, 4}, and the port's
plain flat NTT at N in {256, 1024, 8192}.  The CUDA source's block bodies
are compiled with g++ (one thread a block, the stages in order) and held
against the plain version at every split, radix and block_b, a ragged last
block included.  The kernels themselves run in tests/test_torch_cuda.py.
"""
import ctypes
import dataclasses
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.ckks import params as jparams
from repro.kernels import ntt as jntt

from repro_torch import interop
from repro_torch.core.ckks import params as tparams
from repro_torch.kernels import build, ntt, ops, ref

CSRC = pathlib.Path(build.__file__).parent / "csrc"


@pytest.fixture(scope="module")
def ctxs():
    """(JAX, port) contexts by (N, L)."""
    out = {}
    for n, l in ((256, 2), (256, 3), (1024, 2)):
        out[(n, l)] = (jparams.make_context(n_poly=n, n_limbs=l,
                                            delta_bits=12),
                       tparams.make_context(n_poly=n, n_limbs=l,
                                            delta_bits=12, device="cpu"))
    out[(8192, 2)] = (jparams.make_context(),
                      tparams.make_context(device="cpu"))
    return out


def _rand(rng, primes, b, n):
    return np.stack([rng.randint(0, q, (b, n)) for q in primes],
                    axis=-2).astype(np.uint32)


def _t(a):
    return interop.residues_from_np(np.asarray(a), "cpu")


def _np(t):
    return interop.residues_to_np(t)


def _fwd(x, t, radix=2):
    return ref.ntt4_fwd_fused(x, t.ntt4_psi1_mont, t.ntt4_psi2_mont,
                              t.ntt4_corr_mont, t.qs, t.qinv_negs, radix)


def _inv(x, t, radix=2):
    return ref.ntt4_inv_fused(x, t.ntt4_psi1_inv_mont, t.ntt4_psi2_inv_mont,
                              t.ntt4_corr_inv_mont, t.n_inv_monts, t.qs,
                              t.qinv_negs, radix)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [4, 64, 256, 1024, 4096, 8192, 16384])
def test_splits_equal_reference(n):
    assert tparams.ntt4_split(n) == jparams.ntt4_split(n)
    assert tparams.ntt4_split_candidates(n) == \
        jparams.ntt4_split_candidates(n)


@pytest.mark.parametrize("key", [(256, 2), (256, 3), (1024, 2)])
def test_tables_at_every_split_equal_reference(ctxs, key):
    """The default fields on host and device, and retable_ntt4 (host
    tables) and split_device_tables at every candidate split, at L in
    {1, .., L} through take."""
    jctx, tctx = ctxs[key]
    for f in tparams.NTT4_FIELDS:
        np.testing.assert_array_equal(getattr(tctx.tables, f),
                                      getattr(jctx.tables, f), err_msg=f)
        np.testing.assert_array_equal(
            _np(getattr(tctx.device_tables, f)), getattr(jctx.tables, f))
    for split in tparams.ntt4_split_candidates(key[0]):
        want = jparams.retable_ntt4(jctx.tables, *split)
        host = tparams.retable_ntt4(tctx.tables, *split)
        cached = tctx.split_device_tables(split)
        assert tctx.split_device_tables(split) is cached   # built once
        for l in range(1, key[1] + 1):
            for f in tparams.NTT4_FIELDS:
                w = getattr(want.take(l), f)
                np.testing.assert_array_equal(getattr(host.take(l), f), w)
                np.testing.assert_array_equal(
                    _np(getattr(cached.take(l), f)), w)


def test_default_tables_at_full_width_equal_reference(ctxs):
    jctx, tctx = ctxs[(8192, 2)]
    assert tctx.tables.ntt4_psi1_mont.shape == (2, 64)
    for f in dataclasses.fields(tparams.LimbTables):
        np.testing.assert_array_equal(getattr(tctx.tables, f.name),
                                      getattr(jctx.tables, f.name))
    assert tctx.split_device_tables((64, 128)) is tctx.device_tables
    assert tctx.split_device_tables(None) is tctx.device_tables


def test_limb_range_contexts_carry_their_tables(ctxs):
    """A sharded block's context (limb_range) has the sliced default
    tables and builds its own variant split from its primes."""
    _, tctx = ctxs[(256, 3)]
    sub = tctx.limb_range(1, 3)
    for f in tparams.NTT4_FIELDS:
        np.testing.assert_array_equal(getattr(sub.tables, f),
                                      getattr(tctx.tables, f)[1:3])
        np.testing.assert_array_equal(
            _np(getattr(sub.split_device_tables((32, 8)), f)),
            _np(getattr(tctx.split_device_tables((32, 8)), f))[1:3])


def test_bad_split_raises():
    with pytest.raises(ValueError, match="split"):
        tparams.ntt4_variant_tables((7681,), 256, 16, 8)


# ---------------------------------------------------------------------------
# plain 4-step == JAX's Pallas kernels (interpret) == the flat NTT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("split", [(8, 32), (16, 16), (32, 8)])
def test_plain_matches_jax_interpret(ctxs, split, radix):
    """N=256, L=2, B=3, both directions, bit for bit."""
    jctx, tctx = ctxs[(256, 2)]
    jt = jparams.retable_ntt4(jctx.tables, *split)
    t = tctx.split_device_tables(split)
    x = _rand(np.random.RandomState(split[0] + radix), jctx.primes, 3, 256)
    got = _fwd(_t(x), t, radix)
    np.testing.assert_array_equal(_np(got), np.asarray(jntt.ntt4_fwd_fused(
        jnp.asarray(x), jt.ntt4_psi1_mont, jt.ntt4_psi2_mont,
        jt.ntt4_corr_mont, jt.qs, jt.qinv_negs, radix=radix,
        interpret=True)))
    np.testing.assert_array_equal(_np(_inv(_t(x), t, radix)),
                                  np.asarray(jntt.ntt4_inv_fused(
                                      jnp.asarray(x), jt.ntt4_psi1_inv_mont,
                                      jt.ntt4_psi2_inv_mont,
                                      jt.ntt4_corr_inv_mont, jt.n_inv_monts,
                                      jt.qs, jt.qinv_negs, radix=radix,
                                      interpret=True)))


@pytest.mark.parametrize("key", [(256, 3), (1024, 2), (8192, 2)])
def test_plain_equals_flat_and_round_trips(ctxs, key):
    """Every candidate split and radix equals the plain flat NTT, on the
    full tables and limb-dropped ones; the inverse gives x back."""
    _, tctx = ctxs[key]
    n, l = key
    b = 2 if n == 8192 else 3
    x = _t(_rand(np.random.RandomState(n + l), tctx.primes, b, n))
    splits = tparams.ntt4_split_candidates(n) if n < 8192 else \
        [tparams.ntt4_split(n)]
    for keep in range(1, l + 1):
        xl = x[:, :keep].contiguous()
        tf = tctx.device_tables.take(keep)
        flat = ref.ntt_fwd_fused(xl, tf.psi_rev_mont, tf.qs, tf.qinv_negs)
        for split in splits:
            t = tctx.split_device_tables(split).take(keep)
            for radix in (2, 4):
                got = _fwd(xl, t, radix)
                assert torch.equal(got, flat), (split, radix, keep)
                assert torch.equal(_inv(got, t, radix), xl)


# ---------------------------------------------------------------------------
# the CUDA source's block bodies, compiled for the host
# ---------------------------------------------------------------------------

_HOST_SHIM = r"""
#include <vector>
#include "ntt4.cu"
extern "C" int host_ntt4(int inverse, uint32_t* out, const uint32_t* x,
                         const uint32_t* psi1, const uint32_t* psi2,
                         const uint32_t* corr, const uint32_t* qs,
                         const uint32_t* qinv, const uint32_t* n_inv,
                         long long rows, int n_limbs, int log_n, int log_n1,
                         int block_b, int radix) {
  if (bad_args(rows, log_n, log_n1, block_b, radix)) return 1;
  std::vector<uint32_t> s((size_t)block_b << log_n);
  Rows rw;
  for (blockIdx.x = 0; blockIdx.x < (rows + block_b - 1) / block_b;
       ++blockIdx.x) {
    if (inverse)
      ntt4_inv_block(s.data(), rw, out, x, psi1, psi2, corr, qs, qinv,
                     n_inv, rows, n_limbs, log_n, log_n1, block_b, radix);
    else
      ntt4_fwd_block(s.data(), rw, out, x, psi1, psi2, corr, qs, qinv,
                     rows, n_limbs, log_n, log_n1, block_b, radix);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def ntt4_host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available")
    d = tmp_path_factory.mktemp("ntt4")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    so = d / "libntt4_host.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "shim.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.host_ntt4.argtypes = (i,) + (p,) * 8 + (ll, i, i, i, i, i)
    lib.host_ntt4.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("key", [(256, 3), (1024, 2)])
def test_cuda_block_bodies_match_plain(ntt4_host_lib, ctxs, key):
    """ntt4.cu's index arithmetic at every split x radix x block_b,
    B*L = 15 or 10 pairs (block_b 2 and 4 leave a ragged last block)."""
    _, tctx = ctxs[key]
    n, l = key
    b = 5
    x = _t(_rand(np.random.RandomState(n), tctx.primes, b, n))
    tf = tctx.device_tables
    flat = ref.ntt_fwd_fused(x, tf.psi_rev_mont, tf.qs, tf.qinv_negs)
    log_n = n.bit_length() - 1
    for split in tparams.ntt4_split_candidates(n):
        t = tctx.split_device_tables(split)
        for radix in (2, 4):
            for block_b in (1, 2, 4):
                geo = (b * l, l, log_n, split[0].bit_length() - 1, block_b,
                       radix)
                fwd = torch.zeros_like(x)
                assert ntt4_host_lib.host_ntt4(
                    0, fwd.data_ptr(), x.data_ptr(),
                    t.ntt4_psi1_mont.data_ptr(), t.ntt4_psi2_mont.data_ptr(),
                    t.ntt4_corr_mont.data_ptr(), t.qs.data_ptr(),
                    t.qinv_negs.data_ptr(), None, *geo) == 0
                assert torch.equal(fwd, flat), (split, radix, block_b)
                inv = torch.zeros_like(x)
                assert ntt4_host_lib.host_ntt4(
                    1, inv.data_ptr(), fwd.data_ptr(),
                    t.ntt4_psi1_inv_mont.data_ptr(),
                    t.ntt4_psi2_inv_mont.data_ptr(),
                    t.ntt4_corr_inv_mont.data_ptr(), t.qs.data_ptr(),
                    t.qinv_negs.data_ptr(), t.n_inv_monts.data_ptr(),
                    *geo) == 0
                assert torch.equal(inv, x), (split, radix, block_b)


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------


def test_wrappers_run_the_plain_version_on_cpu_without_launching(ctxs):
    _, tctx = ctxs[(256, 2)]
    t = tctx.split_device_tables((32, 8))
    x = _t(_rand(np.random.RandomState(2), tctx.primes, 2, 256))
    ops.reset_launch_counts()
    got = ntt.ntt4_fwd_fused(x, t.ntt4_psi1_mont, t.ntt4_psi2_mont,
                             t.ntt4_corr_mont, t.qs, t.qinv_negs, radix=4,
                             block_b=2)
    assert torch.equal(got, _fwd(x, t, 4))
    assert torch.equal(ntt.ntt4_inv_fused(
        got, t.ntt4_psi1_inv_mont, t.ntt4_psi2_inv_mont,
        t.ntt4_corr_inv_mont, t.n_inv_monts, t.qs, t.qinv_negs), x)
    assert ops.launch_counts()["ntt4_fwd"] == 0
    assert ops.launch_counts()["ntt4_inv"] == 0


@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_wrappers_refuse_tensors_neither_cpu_nor_cuda(ctxs, direction):
    """A non-CPU tensor goes to the kernel or raises (`meta` stands in for
    a device without a kernel)."""
    _, tctx = ctxs[(256, 2)]
    t = tctx.device_tables
    x = torch.empty(2, 2, 256, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        if direction == "fwd":
            ntt.ntt4_fwd_fused(x, t.ntt4_psi1_mont, t.ntt4_psi2_mont,
                               t.ntt4_corr_mont, t.qs, t.qinv_negs)
        else:
            ntt.ntt4_inv_fused(x, t.ntt4_psi1_inv_mont, t.ntt4_psi2_inv_mont,
                               t.ntt4_corr_inv_mont, t.n_inv_monts, t.qs,
                               t.qinv_negs)
