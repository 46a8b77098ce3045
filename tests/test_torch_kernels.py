"""The port's kernels and their plain versions against the JAX package.

For each kernel of the port (ntt_fwd, ntt_inv, mul_add, weighted_sum, the
sharded fold weighted_accum, the streaming flush weighted_accum_chunks and
the transcipher's mod_lift) the port's plain PyTorch version must equal,
bit for bit, both the JAX package's `ref` op and its Pallas kernel run in
interpret mode, on the same numpy-seeded inputs at N in {256, 1024}, L=2
(weighted_accum: N=256, L in {1, 2, 3}).  The NTT
gold vectors that do not depend on the JAX PRNG are reproduced too, and the
CUDA kernels' arithmetic header is compiled with g++ and held against the
JAX package's 16-bit-split Montgomery product.  The CUDA kernels themselves
are tested in tests/test_torch_cuda.py.
"""
import ctypes
import functools
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax

from repro.core.ckks import params as jparams
from repro.kernels import he_agg as jhe_agg
from repro.kernels import lift as jlift
from repro.kernels import ntt as jntt
from repro.kernels import ops as jops
from repro.kernels import pointwise as jpointwise
from repro.kernels import ref as jref

from repro_torch import interop
from repro_torch.core.ckks import params as tparams
from repro_torch.core import packing
from repro_torch.kernels import (build, he_agg, lift, mask, ntt, ops,
                                 pointwise, ref)

import gold
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

NS = (256, 1024)
CSRC = pathlib.Path(build.__file__).parent / "csrc"


def _ctxs(n, l=2):
    return (jparams.make_test_context(n_poly=n, n_limbs=l),
            tparams.make_test_context(n_poly=n, n_limbs=l, device="cpu"))


def _t(a):
    return interop.residues_from_np(np.asarray(a), "cpu")


def _np(t):
    return interop.residues_to_np(t)


def _jref(fn, *args, **static):
    """A JAX ref op as one compiled graph (op-by-op dispatch of its
    unrolled stages costs seconds on the CPU)."""
    return jax.jit(functools.partial(fn, **static))(*args)


def _assert_same(port, *jax_outs):
    got = _np(port)
    for want in jax_outs:
        np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# plain versions == JAX ref == JAX Pallas (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", NS)
def test_ntt_fwd_matches_jax(n):
    jctx, tctx = _ctxs(n)
    jt, tt = jctx.tables, tctx.device_tables
    x = jref.rand_limbed_np(np.random.RandomState(n), jctx, (3,))
    port = ref.ntt_fwd_fused(_t(x), tt.psi_rev_mont, tt.qs, tt.qinv_negs)
    _assert_same(
        port,
        _jref(jref.ntt_fwd_fused, x, jt.psi_rev_mont, jt.qs, jt.qinv_negs),
        jntt.ntt_fwd_fused(x, jt.psi_rev_mont, jt.qs, jt.qinv_negs,
                           interpret=True))
    assert torch.equal(ops.ntt_fwd(_t(x), tctx), port)


@pytest.mark.parametrize("n", NS)
def test_ntt_inv_matches_jax(n):
    jctx, tctx = _ctxs(n)
    jt, tt = jctx.tables, tctx.device_tables
    x = jref.rand_limbed_np(np.random.RandomState(n + 1), jctx, (3,))
    port = ref.ntt_inv_fused(_t(x), tt.psi_inv_rev_mont, tt.n_inv_monts,
                             tt.qs, tt.qinv_negs)
    _assert_same(
        port,
        _jref(jref.ntt_inv_fused, x, jt.psi_inv_rev_mont, jt.n_inv_monts,
              jt.qs, jt.qinv_negs),
        jntt.ntt_inv_fused(x, jt.psi_inv_rev_mont, jt.n_inv_monts, jt.qs,
                           jt.qinv_negs, interpret=True))
    assert torch.equal(ops.ntt_inv(_t(x), tctx), port)
    # and the pair inverts
    assert torch.equal(ops.ntt_inv(ops.ntt_fwd(_t(x), tctx), tctx), _t(x))


@pytest.mark.parametrize("n", NS)
def test_mul_add_matches_jax(n):
    jctx, tctx = _ctxs(n)
    jt, tt = jctx.tables, tctx.device_tables
    rng = np.random.RandomState(n + 2)
    x = jref.rand_limbed_np(rng, jctx, (3,))
    y = jref.rand_limbed_np(rng, jctx, (1,))        # broadcast like pk
    z = jref.rand_limbed_np(rng, jctx, (3,))
    port = ref.mul_add_fused(_t(x), _t(y), _t(z), tt.qs, tt.qinv_negs)
    _assert_same(
        port,
        _jref(jref.mul_add_fused, x, np.broadcast_to(y, x.shape), z, jt.qs,
              jt.qinv_negs),
        jpointwise.mul_add_fused(x, y, z, jt.qs, jt.qinv_negs,
                                 interpret=True))
    assert torch.equal(ops.mul_add(_t(x), _t(y), _t(z), tctx), port)


@pytest.mark.parametrize("n", NS)
def test_mul_add_reads_interleaved_ciphertext_views(n):
    """Decrypt's operands: c1 and c0 are strided views of [B, L, 2, N]."""
    jctx, tctx = _ctxs(n)
    jt, tt = jctx.tables, tctx.device_tables
    rng = np.random.RandomState(n + 3)
    data = jref.rand_limbed_np(rng, jctx, (3, 2)).transpose(0, 2, 1, 3)
    s = jref.rand_limbed_np(rng, jctx, ())
    td = _t(np.ascontiguousarray(data))
    port = ops.mul_add(td[..., 1, :], _t(s)[None], td[..., 0, :], tctx)
    _assert_same(port, jpointwise.mul_add_fused(
        np.ascontiguousarray(data[..., 1, :]), s[None],
        np.ascontiguousarray(data[..., 0, :]), jt.qs, jt.qinv_negs,
        interpret=True))


@pytest.mark.parametrize("n", NS)
def test_weighted_sum_matches_jax(n):
    jctx, tctx = _ctxs(n)
    jt, tt = jctx.tables, tctx.device_tables
    rng = np.random.RandomState(n + 4)
    cts = jref.rand_limbed_np(rng, jctx, (3, 4))               # [C, B, L, N]
    w = np.stack([rng.randint(0, q, 3) for q in jctx.primes],
                 axis=1).astype(np.uint32)                     # [C, L]
    port = ref.he_weighted_sum_fused(_t(cts), _t(w), tt.qs, tt.qinv_negs)
    _assert_same(
        port,
        _jref(jref.he_weighted_sum_fused, cts, w, jt.qs, jt.qinv_negs),
        jhe_agg.he_weighted_sum_fused(cts, w, jt.qs, jt.qinv_negs,
                                      interpret=True))
    assert torch.equal(ops.weighted_sum(_t(cts), _t(w), tctx), port)


@pytest.mark.parametrize("n", NS)
def test_weighted_sum_in_ciphertext_layout(n):
    """limb_axis=-3 reads [C, B, L, 2, N] in place; the JAX package moves
    the limb axis to -2 first.  Same bits."""
    jctx, tctx = _ctxs(n)
    jt = jctx.tables
    rng = np.random.RandomState(n + 5)
    data = np.ascontiguousarray(
        jref.rand_limbed_np(rng, jctx, (3, 2, 2)).transpose(0, 1, 3, 2, 4))
    w = np.stack([rng.randint(0, q, 3) for q in jctx.primes],
                 axis=1).astype(np.uint32)
    port = ops.weighted_sum(_t(data), _t(w), tctx, limb_axis=-3)
    want = jhe_agg.he_weighted_sum_fused(
        np.moveaxis(data, -3, -2), w, jt.qs, jt.qinv_negs, interpret=True)
    _assert_same(port, np.moveaxis(np.asarray(want), -2, -3))


@pytest.mark.parametrize("n", NS)
def test_weighted_accum_chunks_matches_jax(n):
    """The flush acc[k] + w[k] (*) ct[k] with per-row weights over K=5 rows
    (not a power of two) of [2, L, N]: the port's plain version equals the
    JAX package's Pallas kernel (interpret), its ref, and folding the rows
    one at a time with mul_add."""
    jctx, tctx = _ctxs(n)
    jt, tt = jctx.tables, tctx.device_tables
    rng = np.random.RandomState(n + 7)
    acc = jref.rand_limbed_np(rng, jctx, (5, 2))               # [K, 2, L, N]
    cts = jref.rand_limbed_np(rng, jctx, (5, 2))
    w = np.stack([rng.randint(0, q, 5) for q in jctx.primes],
                 axis=1).astype(np.uint32)                     # [K, L]
    port = ref.he_weighted_accum_chunks_fused(_t(acc), _t(cts), _t(w),
                                              tt.qs, tt.qinv_negs)
    _assert_same(
        port,
        _jref(jref.he_weighted_accum_chunks_fused, acc, cts, w, jt.qs,
              jt.qinv_negs),
        jhe_agg.he_weighted_accum_chunks_fused(acc, cts, w, jt.qs,
                                               jt.qinv_negs, interpret=True))
    rows = [ref.mul_add_fused(_t(cts[k]), _t(w[k])[:, None], _t(acc[k]),
                              tt.qs, tt.qinv_negs) for k in range(5)]
    assert torch.equal(torch.stack(rows), port)
    assert torch.equal(ops.weighted_accum_chunks(_t(acc), _t(cts), _t(w),
                                                 tctx), port)


@pytest.mark.parametrize("n", NS)
def test_weighted_accum_chunks_in_ciphertext_layout(n):
    """limb_axis=-3 reads the ingest's [K, L, 2, N] rows in place, and
    out=acc updates the accumulator in place; same bits as the JAX kernel
    on the ops layout."""
    jctx, tctx = _ctxs(n)
    jt = jctx.tables
    rng = np.random.RandomState(n + 8)
    acc = jref.rand_limbed_np(rng, jctx, (3, 2))
    cts = jref.rand_limbed_np(rng, jctx, (3, 2))
    w = np.stack([rng.randint(0, q, 3) for q in jctx.primes],
                 axis=1).astype(np.uint32)
    want = jhe_agg.he_weighted_accum_chunks_fused(acc, cts, w, jt.qs,
                                                  jt.qinv_negs,
                                                  interpret=True)
    tacc = _t(np.ascontiguousarray(np.moveaxis(acc, -2, -3)))
    out = ops.weighted_accum_chunks(
        tacc, _t(np.ascontiguousarray(np.moveaxis(cts, -2, -3))), _t(w),
        tctx, limb_axis=-3, out=tacc)
    assert out is tacc
    _assert_same(tacc, np.moveaxis(np.asarray(want), -2, -3))


@pytest.mark.parametrize("l", [1, 2, 3])
def test_weighted_accum_matches_jax(l):
    """The fold acc + w (*) ct with one weight per limb over 5 rows of
    [2, L, N]: the plain version equals the JAX package's Pallas kernel
    (interpret) and its ops.weighted_accum on the ref backend, with acc of
    ct's shape and broadcast (one row, with and without its leading 1); in
    the ciphertext layout (limb_axis=-3) and folded in place (out=acc)."""
    n = 256
    jctx = jparams.make_test_context(n_poly=n, n_limbs=l,
                                     delta_bits=12 if l == 1 else 20)
    tctx = tparams.make_test_context(n_poly=n, n_limbs=l,
                                     delta_bits=12 if l == 1 else 20,
                                     device="cpu")
    jt, tt = jctx.tables, tctx.device_tables
    rng = np.random.RandomState(40 + l)
    acc = jref.rand_limbed_np(rng, jctx, (5, 2))               # [B, 2, L, N]
    ct = jref.rand_limbed_np(rng, jctx, (5, 2))
    w = np.asarray([rng.randint(0, q) for q in jctx.primes], np.uint32)
    for a in (acc, acc[:1], acc[0]):
        port = ref.he_weighted_accum_fused(_t(a), _t(ct), _t(w), tt.qs,
                                           tt.qinv_negs)
        _assert_same(port,
                     jhe_agg.he_weighted_accum_fused(a, ct, w, jt.qs,
                                                     jt.qinv_negs,
                                                     interpret=True),
                     jops.weighted_accum(a, ct, w, jctx))
        assert torch.equal(ops.weighted_accum(_t(a), _t(ct), _t(w), tctx),
                           port)
    want = jops.weighted_accum(acc, ct, w, jctx)
    tacc = _t(np.ascontiguousarray(np.moveaxis(acc, -2, -3)))
    out = ops.weighted_accum(
        tacc, _t(np.ascontiguousarray(np.moveaxis(ct, -2, -3))), _t(w), tctx,
        limb_axis=-3, out=tacc)
    assert out is tacc
    _assert_same(tacc, np.moveaxis(np.asarray(want), -2, -3))


@pytest.mark.parametrize("l", [2, 3])
@pytest.mark.parametrize("n", NS)
def test_mod_lift_matches_jax(n, l):
    """Full-range words, the edges 0, 2**31 - 1, 2**31, 2**32 - 2 and
    2**32 - 1 among them (every word >= 2**31 is a negative int32 in the
    port): the plain version equals the JAX package's ref and its Pallas
    kernel (interpret), and ops.mod_lift on the CPU runs it."""
    jctx, tctx = _ctxs(n, l)
    rng = np.random.RandomState(n + l)
    x = rng.randint(0, 1 << 32, size=(5, n), dtype=np.uint64).astype(
        np.uint32)
    x[0, :5] = [0, (1 << 31) - 1, 1 << 31, (1 << 32) - 2, (1 << 32) - 1]
    qs = jctx.tables.qs
    port = ref.mod_lift_fused(_t(x), tctx.device_tables.qs)
    _assert_same(port, _jref(jref.mod_lift_fused, x, qs),
                 jlift.mod_lift_fused(x, qs, interpret=True))
    _assert_same(port, (x.astype(np.uint64)[:, None, :]
                        % np.asarray(jctx.primes, np.uint64)[:, None]))
    assert torch.equal(ops.mod_lift(_t(x), l, tctx), port)


@pytest.mark.parametrize("name", sorted(gold.KAT_CONTEXTS))
def test_ntt_gold_vectors(name):
    """The NTT known-answer vectors (which no PRNG touches) bit for bit."""
    kats = gold.load_kats()
    spec = gold.KAT_CONTEXTS[name]
    jctx = jparams.make_context(**spec)
    tctx = tparams.make_context(**spec, device="cpu")
    x = jref.rand_limbed_np(np.random.RandomState(12345), jctx, (2,))
    np.testing.assert_array_equal(_np(ops.ntt_fwd(_t(x), tctx)),
                                  kats[f"{name}/ntt_fwd"])
    np.testing.assert_array_equal(_np(ops.ntt_inv(_t(x), tctx)),
                                  kats[f"{name}/ntt_inv"])


# ---------------------------------------------------------------------------
# wrappers: the device decides, launches are counted only on the card
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_without_launching():
    _, tctx = _ctxs(256)
    x = _t(jref.rand_limbed_np(np.random.RandomState(6), _ctxs(256)[0], (2,)))
    ops.reset_launch_counts()
    ops.mul_add(ops.ntt_inv(ops.ntt_fwd(x, tctx), tctx), x, x, tctx)
    ops.weighted_sum(torch.stack([x, x]), torch.ones(2, 2, dtype=torch.int32),
                     tctx)
    ops.weighted_accum(x, x, torch.ones(2, dtype=torch.int32), tctx)
    ops.weighted_accum_chunks(x, x, torch.ones(2, 2, dtype=torch.int32),
                              tctx)
    ops.mod_lift(x[:, 0], 2, tctx)
    part = packing.make_partition(torch.arange(300) % 3 == 0, 128)
    mask.mask_merge(*mask.mask_split(torch.randn(300), part), part)
    assert ops.launch_counts() == {"ntt_fwd": 0, "ntt_inv": 0,
                                   "ntt4_fwd": 0, "ntt4_inv": 0,
                                   "mul_add": 0, "weighted_sum": 0,
                                   "weighted_accum": 0,
                                   "weighted_accum_chunks": 0,
                                   "mod_lift": 0, "mask_split": 0,
                                   "mask_merge": 0}


@pytest.mark.parametrize("op", ["ntt_fwd", "ntt_inv", "mul_add",
                                "weighted_sum", "weighted_accum",
                                "weighted_accum_chunks", "mod_lift"])
def test_wrappers_refuse_tensors_neither_cpu_nor_cuda(op):
    """A non-CPU tensor goes to the kernel or raises; it never runs the
    plain version.  (`meta` stands in for a device without a kernel.)"""
    _, tctx = _ctxs(256)
    t = tctx.device_tables
    x = torch.empty(2, 2, 256, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        if op == "ntt_fwd":
            ntt.ntt_fwd_fused(x, t.psi_rev_mont, t.qs, t.qinv_negs)
        elif op == "ntt_inv":
            ntt.ntt_inv_fused(x, t.psi_inv_rev_mont, t.n_inv_monts, t.qs,
                              t.qinv_negs)
        elif op == "mul_add":
            pointwise.mul_add_fused(x, x, x, t.qs, t.qinv_negs)
        elif op == "weighted_accum":
            he_agg.he_weighted_accum_fused(x, x, t.qs, t.qs, t.qinv_negs)
        elif op == "weighted_accum_chunks":
            he_agg.he_weighted_accum_chunks_fused(x, x, x[:, :, 0], t.qs,
                                                  t.qinv_negs)
        elif op == "mod_lift":
            lift.mod_lift_fused(x[:, 0], t.qs)
        else:
            he_agg.he_weighted_sum_fused(x[None], x[0, :, :2], t.qs,
                                         t.qinv_negs)


def test_build_cache_key_follows_the_sources(tmp_path, monkeypatch):
    """Library names hash every header, the source and the flags, so an
    edit rebuilds instead of loading a stale library.  Edits go to a copy
    of csrc/."""
    paths = {n: build._lib_path(n) for n in build.SOURCES}
    assert len(set(paths.values())) == len(build.SOURCES)
    assert all(p.parent == build.BUILD_DIR for p in paths.values())
    assert set(build.SIGNATURES) == set(build.SOURCES)
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    assert {n: build._lib_path(n) for n in build.SOURCES} == paths
    for edit in ("mont.cuh", "added.cuh", "ntt.cu"):
        before = {n: build._lib_path(n) for n in build.SOURCES}
        with open(copy / edit, "a") as f:
            f.write("// edited\n")
        after = {n: build._lib_path(n) for n in build.SOURCES}
        changed = {n for n in build.SOURCES if after[n] != before[n]}
        # a header may be included by any source; a source only by itself
        assert changed == ({"ntt"} if edit == "ntt.cu"
                           else set(build.SOURCES)), edit


# ---------------------------------------------------------------------------
# the kernels' arithmetic core, compiled for the host
# ---------------------------------------------------------------------------

_HOST_SHIM = r"""
#include "mont.cuh"
extern "C" void host_mont_mul(const uint32_t* a, const uint32_t* b,
                              uint32_t* out, long long n, uint32_t q,
                              uint32_t qinv) {
  for (long long i = 0; i < n; ++i) out[i] = mont_mul(a[i], b[i], q, qinv);
}
extern "C" void host_mod_add(const uint32_t* a, const uint32_t* b,
                             uint32_t* out, long long n, uint32_t q) {
  for (long long i = 0; i < n; ++i) out[i] = mod_add(a[i], b[i], q);
}
extern "C" void host_mod_sub(const uint32_t* a, const uint32_t* b,
                             uint32_t* out, long long n, uint32_t q) {
  for (long long i = 0; i < n; ++i) out[i] = mod_sub(a[i], b[i], q);
}
"""


@pytest.fixture(scope="module")
def mont_host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available")
    d = tmp_path_factory.mktemp("mont")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    so = d / "libmont_host.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", f"-I{CSRC}", "-o",
                    str(so), str(d / "shim.cpp")], check=True,
                   capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    p, ll, u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32
    lib.host_mont_mul.argtypes = (p, p, p, ll, u32, u32)
    lib.host_mod_add.argtypes = (p, p, p, ll, u32)
    lib.host_mod_sub.argtypes = (p, p, p, ll, u32)
    for f in (lib.host_mont_mul, lib.host_mod_add, lib.host_mod_sub):
        f.restype = None
    return lib


@pytest.mark.parametrize("limb", [0, 1])
def test_mont_header_matches_jax_ref(mont_host_lib, limb):
    """csrc/mont.cuh's 64-bit REDC == the JAX 16-bit-split mont_mul, on
    10k random pairs per prime of the paper's N=8192 context."""
    lc = jparams.make_context().limbs[limb]
    rng = np.random.RandomState(limb)
    a = rng.randint(0, lc.q, 10_000).astype(np.uint32)
    b = rng.randint(0, lc.q, 10_000).astype(np.uint32)
    a[:3], b[:3] = [0, lc.q - 1, lc.q - 1], [lc.q - 1, lc.q - 1, 0]
    out = np.empty_like(a)

    def call(fn, *extra):
        fn(a.ctypes.data, b.ctypes.data, out.ctypes.data, a.size, lc.q,
           *extra)
        return out.copy()

    np.testing.assert_array_equal(
        call(mont_host_lib.host_mont_mul, lc.qinv_neg),
        np.asarray(jref.mont_mul(a, b, np.uint32(lc.q),
                                 np.uint32(lc.qinv_neg))))
    np.testing.assert_array_equal(
        call(mont_host_lib.host_mod_add),
        np.asarray(jref.mod_add(a, b, np.uint32(lc.q))))
    np.testing.assert_array_equal(
        call(mont_host_lib.host_mod_sub),
        np.asarray(jref.mod_sub(a, b, np.uint32(lc.q))))
    # the port's plain int64 REDC gives the same bits
    tt = tparams.make_context(device="cpu").device_tables
    np.testing.assert_array_equal(
        _np(ref.mont_mul(_t(a), _t(b), tt.qs[limb], tt.qinv_negs[limb])),
        call(mont_host_lib.host_mont_mul, lc.qinv_neg))
