"""The port's 4-step NTT against the JAX package.

The 4-step tables (`ntt4_split`, `ntt4_split_candidates`, the six `ntt4_*`
fields and `retable_ntt4` at every candidate split) must equal JAX's bit for
bit; the plain `ntt4_fwd_fused` / `ntt4_inv_fused` must equal JAX's
interpret-mode Pallas kernels for 3 splits x radix {2, 4}, and the port's
plain flat NTT at N in {256, 1024, 8192}.  The CUDA source's block bodies
are compiled with g++ beside the flat kernel's (one thread a block, the
logical threads of each register pass in order, through the shared
`ntt_pass.cuh`) and held against the plain versions at every split of N
from 4 to 16384, with the twist inside each pass and on a pass edge, on
rows and tables off the 16-byte grid; the flat bodies still match through
the shared header.  The kernels themselves run in
tests/test_torch_cuda.py.
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

from _flat_tables import FlatTables
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
# the CUDA sources' block bodies, compiled for the host
# ---------------------------------------------------------------------------

# ntt4.cu and ntt.cu in one unit: both run ntt_pass.cuh's register passes
_HOST_SHIM = r"""
#include <vector>
#include "ntt.cu"
#include "ntt4.cu"
extern "C" int host_ntt4(int inverse, uint32_t* out, const uint32_t* x,
                         const uint32_t* psi1, const uint32_t* psi2,
                         const uint32_t* corr, const uint32_t* qs,
                         const uint32_t* qinv, const uint32_t* n_inv,
                         long long rows, int n_limbs, int log_n,
                         int log_n1) {
  if (bad_args(rows, n_limbs, log_n, log_n1)) return 1;
  std::vector<uint32_t> s(smem_words(log_n) + table_words(log_n, log_n1));
  for (blockIdx.x = 0; blockIdx.x < rows; ++blockIdx.x)
    if (!ntt4_host_block(inverse != 0, log_n, s.data(), out, x, psi1, psi2,
                         corr, qs, qinv, n_inv, n_limbs, log_n1))
      return 1;
  return 0;
}
extern "C" int host_ntt(int inverse, uint32_t* out, const uint32_t* x,
                        const uint32_t* w, const uint32_t* qs,
                        const uint32_t* qinv, const uint32_t* n_inv,
                        long long rows, int n_limbs, int log_n) {
  if (bad_args(rows, n_limbs, log_n)) return 1;
  std::vector<uint32_t> s(smem_words(log_n) + 1);
  for (blockIdx.x = 0; blockIdx.x < rows; ++blockIdx.x)
    if (!ntt_host_block(inverse != 0, log_n, s.data(), out, x, w, qs, qinv,
                        n_inv, n_limbs))
      return 1;
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
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "shim.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.host_ntt4.argtypes = (i,) + (p,) * 8 + (ll, i, i, i)
    lib.host_ntt4.restype = ctypes.c_int
    lib.host_ntt.argtypes = (i,) + (p,) * 6 + (ll, i, i)
    lib.host_ntt.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host_ctxs():
    """Port contexts by (N, L) for the host-build tests (no JAX)."""
    cache = {}

    def get(n, l):
        if (n, l) not in cache:
            cache[(n, l)] = tparams.make_test_context(n_poly=n, n_limbs=l,
                                                      device="cpu")
        return cache[(n, l)]

    return get


def _host4(lib, inverse, x, t, out=None, corr=None):
    """ntt4.cu's host bodies on x with the split tables t (corr: another
    copy of t's twist table, e.g. one off the 16-byte grid)."""
    n, l = x.shape[-1], x.shape[-2]
    out = torch.zeros_like(x) if out is None else out
    if inverse:
        tabs = (t.ntt4_psi1_inv_mont, t.ntt4_psi2_inv_mont,
                t.ntt4_corr_inv_mont if corr is None else corr)
    else:
        tabs = (t.ntt4_psi1_mont, t.ntt4_psi2_mont,
                t.ntt4_corr_mont if corr is None else corr)
    assert lib.host_ntt4(
        int(inverse), out.data_ptr(), x.data_ptr(),
        *(a.data_ptr() for a in tabs), t.qs.data_ptr(),
        t.qinv_negs.data_ptr(),
        t.n_inv_monts.data_ptr() if inverse else None, x.numel() // n, l,
        n.bit_length() - 1, t.ntt4_psi1_mont.shape[-1].bit_length() - 1) == 0
    return out


def _all_splits(n):
    return [(1 << k, n >> k) for k in range(1, n.bit_length() - 1)]


@pytest.mark.parametrize("l", [2, 3])
@pytest.mark.parametrize("n", [4, 32, 256, 1024, 8192, 16384])
def test_cuda_block_bodies_match_plain(ntt4_host_lib, host_ctxs, n, l):
    """ntt4.cu's index arithmetic at every split of N (the twist at every
    stage a split can put it after), B = 3 rows of L limbs: the forward
    equals the plain 4-step version and the flat output, the inverse the
    plain inverse, and it undoes the forward."""
    ctx = host_ctxs(n, l)
    x = _t(_rand(np.random.RandomState(n + l), ctx.primes, 3, n))
    tf = ctx.device_tables
    flat = ref.ntt_fwd_fused(x, tf.psi_rev_mont, tf.qs, tf.qinv_negs)
    for split in _all_splits(n):
        t = ctx.split_device_tables(split)
        fwd = _host4(ntt4_host_lib, False, x, t)
        assert torch.equal(fwd, flat), split
        assert torch.equal(fwd, _fwd(x, t)), split
        assert torch.equal(_host4(ntt4_host_lib, True, x, t), _inv(x, t)), \
            split
        assert torch.equal(_host4(ntt4_host_lib, True, fwd, t), x), split


# the pass of N = 8192's plan (bits [8, 13), [3, 8), [0, 3)) that holds the
# forward twist, after the stage at bit log2 n2
TWIST_AT_8192 = {"pass 0": (2, 4096), "edge of passes 0 and 1": (32, 256),
                 "pass 1": (64, 128), "pass 2": (4096, 2)}


@pytest.mark.parametrize("where", sorted(TWIST_AT_8192))
def test_twist_in_each_pass(ntt4_host_lib, host_ctxs, where):
    """A split whose boundary falls inside each of the three register
    passes and on a pass edge, on make_context()'s primes (L = 2):
    keygen's one row and four ciphertext rows."""
    split = TWIST_AT_8192[where]
    ctx = host_ctxs(8192, 2)
    t = ctx.split_device_tables(split)
    tf = ctx.device_tables
    for b in (1, 4):
        x = _t(_rand(np.random.RandomState(b), ctx.primes, b, 8192))
        fwd = _host4(ntt4_host_lib, False, x, t)
        assert torch.equal(fwd, ref.ntt_fwd_fused(x, tf.psi_rev_mont, tf.qs,
                                                  tf.qinv_negs))
        assert torch.equal(_host4(ntt4_host_lib, True, x, t),
                           ref.ntt_inv_fused(x, tf.psi_inv_rev_mont,
                                             tf.n_inv_monts, tf.qs,
                                             tf.qinv_negs))


@pytest.mark.parametrize("split", [(64, 128), (4096, 2), (2, 4096)])
def test_rows_and_tables_off_the_16_byte_grid(ntt4_host_lib, host_ctxs,
                                              split):
    """x, out and the twist table one word past a 16-byte boundary: x and
    out take the scalar loads and stores, the twist reads any alignment
    (at 4096 x 2 it falls in pass 2, the 16-byte pass); the bits are the
    same."""
    ctx = host_ctxs(8192, 2)
    t = ctx.split_device_tables(split)
    x = _t(_rand(np.random.RandomState(7), ctx.primes, 2, 8192))

    def off(a):
        buf = torch.zeros(a.numel() + 1, dtype=torch.int32)
        view = buf[1:].view(a.shape)
        view.copy_(a)
        assert view.data_ptr() % 16
        return view

    for inverse, plain in ((False, _fwd), (True, _inv)):
        corr = t.ntt4_corr_inv_mont if inverse else t.ntt4_corr_mont
        out = off(torch.zeros_like(x))
        _host4(ntt4_host_lib, inverse, off(x), t, out=out, corr=off(corr))
        assert torch.equal(out, plain(x, t)), inverse


@pytest.mark.parametrize("n", [2, 32, 1024, 16384])
def test_flat_host_bodies_through_the_shared_header(ntt4_host_lib,
                                                    host_ctxs, n):
    """ntt.cu's host bodies, built beside ntt4.cu from the one pass header,
    still equal the plain flat NTT (tests/test_torch_ntt_flat.py holds
    them everywhere), and at N >= 4 the 4-step bodies' default split."""
    t = FlatTables(n, 2)
    x = _t(_rand(np.random.RandomState(n), t.primes, 3, n))
    for inverse in (False, True):
        out = torch.zeros_like(x)
        assert ntt4_host_lib.host_ntt(
            int(inverse), out.data_ptr(), x.data_ptr(),
            (t.psi_inv_rev_mont if inverse else t.psi_rev_mont).data_ptr(),
            t.qs.data_ptr(), t.qinv_negs.data_ptr(),
            t.n_inv_monts.data_ptr() if inverse else None, 6, 2,
            n.bit_length() - 1) == 0
        want = (ref.ntt_inv_fused(x, t.psi_inv_rev_mont, t.n_inv_monts, t.qs,
                                  t.qinv_negs) if inverse else
                ref.ntt_fwd_fused(x, t.psi_rev_mont, t.qs, t.qinv_negs))
        assert torch.equal(out, want), inverse
        if n >= 4:
            s = host_ctxs(n, 2).device_tables
            assert [int(q) for q in s.qs] == [int(q) for q in t.qs]
            assert torch.equal(_host4(ntt4_host_lib, inverse, x, s), out)


def test_ablation_tool_finds_the_twist():
    """tools/ntt4_ablation.py builds ntt4.cu without its twist by replacing
    twists_after's one return statement; that statement must be there
    once, and the patched source is the same kernel with the twist off."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "ntt4_ablation.py"
    spec = importlib.util.spec_from_file_location("ntt4_ablation", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = (CSRC / "ntt4.cu").read_text()
    assert text.count(tool.NO_TWIST[0]) == 1
    patched = text.replace(*tool.NO_TWIST)
    assert "twists_after" in patched and tool.NO_TWIST[0] not in patched


@pytest.mark.parametrize("geometry", [(6, 2, 13, 0), (6, 2, 13, 13),
                                      (6, 2, 1, 1), (6, 2, 15, 7),
                                      (0, 2, 13, 6), (6, 0, 13, 6)])
def test_bad_geometry_is_refused(ntt4_host_lib, geometry):
    """rows, L, log2 N and log2 n1 the 4-step kernels do not take (n1 or
    n2 below 2, N beyond 2**14) return non-zero before anything runs."""
    rows, l, log_n, log_n1 = geometry
    x = torch.zeros(8, dtype=torch.int32)
    assert ntt4_host_lib.host_ntt4(0, *(x.data_ptr(),) * 7, None, rows, l,
                                   log_n, log_n1) == 1


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
