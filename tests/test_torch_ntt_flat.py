"""The flat NTT kernels' CUDA source (`csrc/ntt.cu`) on the CPU.

g++ compiles the source's block bodies (one thread a block: the logical
threads of each register pass in order, `__syncthreads()` a no-op), which
are held bit for bit against the plain `ref.ntt_fwd_fused` /
`ref.ntt_inv_fused` at N from 2 to 16384 with L in {2, 3}, on the paper's
N = 8192 tables, with rows that are not 16-byte aligned (the scalar path
beside the 16-byte loads and stores), and against the JAX package's
reference NTT.  The kernels themselves run in tests/test_torch_cuda.py.
"""
import ctypes
import pathlib
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from repro.core.ckks import params as jparams
from repro.kernels import ref as jref

from repro_torch import interop
from repro_torch.core.ckks import params as tparams
from repro_torch.kernels import build, ref

from _flat_tables import FlatTables
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = pathlib.Path(build.__file__).parent / "csrc"
NS = (2, 4, 32, 256, 1024, 8192, 16384)

_HOST_SHIM = r"""
#include <vector>
#include "ntt.cu"
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
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available")
    d = tmp_path_factory.mktemp("ntt_flat")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    so = d / "libntt_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "shim.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.host_ntt.argtypes = (i,) + (p,) * 6 + (ll, i, i)
    lib.host_ntt.restype = ctypes.c_int
    return lib


def _rand(seed, primes, b, n):
    rng = np.random.RandomState(seed)
    x = np.stack([rng.randint(0, q, (b, n)) for q in primes], axis=-2)
    return interop.residues_from_np(x.astype(np.uint32), "cpu")


def _run(lib, inverse, x, t, *, out=None):
    n, l = x.shape[-1], x.shape[-2]
    out = torch.zeros_like(x) if out is None else out
    rc = lib.host_ntt(int(inverse), out.data_ptr(), x.data_ptr(),
                      (t.psi_inv_rev_mont if inverse else
                       t.psi_rev_mont).data_ptr(), t.qs.data_ptr(),
                      t.qinv_negs.data_ptr(),
                      t.n_inv_monts.data_ptr() if inverse else None,
                      x.numel() // n, l, n.bit_length() - 1)
    assert rc == 0
    return out


def _plain_fwd(x, t):
    return ref.ntt_fwd_fused(x, t.psi_rev_mont, t.qs, t.qinv_negs)


def _plain_inv(x, t):
    return ref.ntt_inv_fused(x, t.psi_inv_rev_mont, t.n_inv_monts, t.qs,
                             t.qinv_negs)


@pytest.mark.parametrize("n", [4, 32])
def test_table_helper_equals_the_contexts(n):
    tt = tparams.make_test_context(n_poly=n, n_limbs=3,
                                   device="cpu").device_tables
    t = FlatTables(n, 3)
    for f in ("psi_rev_mont", "psi_inv_rev_mont", "qs", "qinv_negs",
              "n_inv_monts"):
        assert torch.equal(getattr(t, f), getattr(tt, f)), f


@pytest.mark.parametrize("l", [2, 3])
@pytest.mark.parametrize("n", NS)
def test_block_bodies_match_plain(host_lib, n, l):
    """B = 3 rows of L limbs: forward and inverse exact, and the inverse
    undoes the forward."""
    t = FlatTables(n, l)
    x = _rand(n + l, t.primes, 3, n)
    fwd = _run(host_lib, False, x, t)
    assert torch.equal(fwd, _plain_fwd(x, t))
    assert torch.equal(_run(host_lib, True, x, t), _plain_inv(x, t))
    assert torch.equal(_run(host_lib, True, fwd, t), x)


def test_block_bodies_on_the_paper_tables(host_lib):
    """make_context()'s N = 8192, L = 2 tables, keygen's one row and four
    ciphertext rows."""
    t = tparams.make_context(device="cpu").device_tables
    primes = [int(q) for q in t.qs]
    for b in (1, 4):
        x = _rand(b, primes, b, 8192)
        fwd = _run(host_lib, False, x, t)
        assert torch.equal(fwd, _plain_fwd(x, t))
        assert torch.equal(_run(host_lib, True, x, t), _plain_inv(x, t))
        assert torch.equal(_run(host_lib, True, fwd, t), x)


@pytest.mark.parametrize("n", [1024, 8192])
def test_rows_off_the_16_byte_grid(host_lib, n):
    """Input and output one word past a 16-byte boundary take the scalar
    loads and stores; the bits are the same."""
    t = FlatTables(n, 2)
    x = _rand(n, t.primes, 2, n)
    buf_in = torch.zeros(x.numel() + 1, dtype=torch.int32)
    buf_out = torch.zeros(x.numel() + 1, dtype=torch.int32)
    x_off = buf_in[1:].view(x.shape)
    x_off.copy_(x)
    out_off = buf_out[1:].view(x.shape)
    assert x_off.data_ptr() % 16 and out_off.data_ptr() % 16
    for inverse, plain in ((False, _plain_fwd), (True, _plain_inv)):
        _run(host_lib, inverse, x_off, t, out=out_off)
        assert torch.equal(out_off, plain(x, t)), inverse


@pytest.mark.parametrize("geometry", [(6, 2, 0), (6, 2, 15), (0, 2, 13),
                                      (6, 0, 13)])
def test_bad_geometry_is_refused(host_lib, geometry):
    """rows, L and log2 N the kernels do not take return non-zero before
    anything runs."""
    rows, l, log_n = geometry
    x = torch.zeros(8, dtype=torch.int32)
    assert host_lib.host_ntt(0, x.data_ptr(), x.data_ptr(), x.data_ptr(),
                             x.data_ptr(), x.data_ptr(), None, rows, l,
                             log_n) == 1


@pytest.mark.parametrize("n", [256, 1024])
def test_block_bodies_match_jax(host_lib, n):
    """The host build against the JAX package's reference NTT (jitted), on
    the JAX context's tables."""
    jctx = jparams.make_test_context(n_poly=n, n_limbs=2)
    jt = jctx.tables
    t = tparams.make_test_context(n_poly=n, n_limbs=2,
                                  device="cpu").device_tables
    x = _rand(n + 7, jctx.primes, 3, n)
    xn = interop.residues_to_np(x)
    want_fwd = jax.jit(jref.ntt_fwd_fused)(xn, jt.psi_rev_mont, jt.qs,
                                           jt.qinv_negs)
    want_inv = jax.jit(jref.ntt_inv_fused)(xn, jt.psi_inv_rev_mont,
                                           jt.n_inv_monts, jt.qs,
                                           jt.qinv_negs)
    np.testing.assert_array_equal(
        interop.residues_to_np(_run(host_lib, False, x, t)),
        np.asarray(want_fwd))
    np.testing.assert_array_equal(
        interop.residues_to_np(_run(host_lib, True, x, t)),
        np.asarray(want_inv))
