// Negacyclic NTT / inverse NTT for Hopper (sm_90a), all RNS limbs in one
// launch.
//
// Replaces: src/repro/kernels/ntt.py `_ntt_fwd_body` / `ntt_fwd_fused` and
// `_ntt_inv_body` / `ntt_inv_fused` (the flat limb-grid Pallas kernels).
//
// Layout: x is a contiguous u32[B, L, N]; one block per (row, limb) pair,
// limb = blockIdx.x % L.  The block copies its row into shared memory
// (4N bytes: 32 KiB at N=8192), runs all log2 N butterfly stages there with
// a __syncthreads() between stages, and writes the row back.  The butterfly
// and twiddle indexing copy the JAX reference recurrence exactly (forward:
// Cooley-Tukey, twiddle psi_rev[m + i] for group i of stage m; inverse:
// Gentleman-Sande, psi_inv_rev[h + i], then the N^{-1} R scale), so the
// bit-reversed output matches bit for bit.
//
// Bound: device memory.  Each row is read once and written once (8 bytes per
// element), while the log2 N stages of 64-bit Montgomery products run out of
// shared memory: 3 integer multiplies per butterfly, N/2 * log2 N
// butterflies per row, well under the card's integer rate.  The design keeps
// every stage in shared memory so the row makes one trip through HBM; the
// twiddle row (4N bytes per limb) is read through L1/L2.  A faster version
// would hold several elements per thread in registers across stages and
// pad shared memory against bank conflicts in the late stages; that is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mont.cuh"

namespace {

__global__ void ntt_fwd_kernel(uint32_t* __restrict__ out,
                               const uint32_t* __restrict__ x,
                               const uint32_t* __restrict__ psi,
                               const uint32_t* __restrict__ qs,
                               const uint32_t* __restrict__ qinv, int n_limbs,
                               int log_n) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const int limb = blockIdx.x % n_limbs;
  const size_t row = (size_t)blockIdx.x * n;
  const uint32_t q = qs[limb];
  const uint32_t qi = qinv[limb];
  const uint32_t* w = psi + (size_t)limb * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = x[row + i];
  __syncthreads();

  // stage m (m = 1, 2, ..., N/2): t = N / (2m); butterfly j pairs
  // (i*2t + k, i*2t + k + t) with i = j / t, k = j % t
  int log_t = log_n;
  for (int m = 1; m < n; m <<= 1) {
    --log_t;
    const int t = 1 << log_t;
    for (int j = threadIdx.x; j < (n >> 1); j += blockDim.x) {
      const int i = j >> log_t;
      const int k = j & (t - 1);
      const int a = (i << (log_t + 1)) + k;
      const uint32_t u = s[a];
      const uint32_t v = mont_mul(s[a + t], w[m + i], q, qi);
      s[a] = mod_add(u, v, q);
      s[a + t] = mod_sub(u, v, q);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) out[row + i] = s[i];
}

__global__ void ntt_inv_kernel(uint32_t* __restrict__ out,
                               const uint32_t* __restrict__ x,
                               const uint32_t* __restrict__ psi_inv,
                               const uint32_t* __restrict__ qs,
                               const uint32_t* __restrict__ qinv,
                               const uint32_t* __restrict__ n_inv,
                               int n_limbs, int log_n) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const int limb = blockIdx.x % n_limbs;
  const size_t row = (size_t)blockIdx.x * n;
  const uint32_t q = qs[limb];
  const uint32_t qi = qinv[limb];
  const uint32_t* w = psi_inv + (size_t)limb * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = x[row + i];
  __syncthreads();

  // stage h (h = N/2, ..., 1): t = N / (2h); butterfly j pairs
  // (i*2t + k, i*2t + k + t) with i = j / t, k = j % t
  int log_t = 0;
  for (int h = n >> 1; h >= 1; h >>= 1) {
    const int t = 1 << log_t;
    for (int j = threadIdx.x; j < (n >> 1); j += blockDim.x) {
      const int i = j >> log_t;
      const int k = j & (t - 1);
      const int a = (i << (log_t + 1)) + k;
      const uint32_t u = s[a];
      const uint32_t v = s[a + t];
      s[a] = mod_add(u, v, q);
      s[a + t] = mont_mul(mod_sub(u, v, q), w[h + i], q, qi);
    }
    ++log_t;
    __syncthreads();
  }

  const uint32_t ninv = n_inv[limb];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[row + i] = mont_mul(s[i], ninv, q, qi);
}

// Shared memory above the 48 KiB default must be opted into per kernel.
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

int threads_for(int log_n) {
  const int half = 1 << (log_n - 1);
  return half < 512 ? half : 512;
}

}  // namespace

// rows = B * L; x and out are contiguous u32[B, L, N] with N = 2^log_n.
extern "C" int ntt_fwd_launch(uint32_t* out, const uint32_t* x,
                              const uint32_t* psi, const uint32_t* qs,
                              const uint32_t* qinv, long long rows,
                              int n_limbs, int log_n, void* stream) {
  const size_t smem = sizeof(uint32_t) << log_n;
  cudaError_t err = set_smem(ntt_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ntt_fwd_kernel<<<(unsigned)rows, threads_for(log_n), smem,
                   (cudaStream_t)stream>>>(out, x, psi, qs, qinv, n_limbs,
                                           log_n);
  return (int)cudaGetLastError();
}

extern "C" int ntt_inv_launch(uint32_t* out, const uint32_t* x,
                              const uint32_t* psi_inv, const uint32_t* qs,
                              const uint32_t* qinv, const uint32_t* n_inv,
                              long long rows, int n_limbs, int log_n,
                              void* stream) {
  const size_t smem = sizeof(uint32_t) << log_n;
  cudaError_t err = set_smem(ntt_inv_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ntt_inv_kernel<<<(unsigned)rows, threads_for(log_n), smem,
                   (cudaStream_t)stream>>>(out, x, psi_inv, qs, qinv, n_inv,
                                           n_limbs, log_n);
  return (int)cudaGetLastError();
}
