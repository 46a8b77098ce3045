// 4-step negacyclic NTT / inverse NTT for Hopper (sm_90a), all RNS limbs in
// one launch, bit-identical to the flat kernels of ntt.cu.
//
// Replaces: src/repro/kernels/ntt.py `_ntt4_fwd_body` (with `_ln_fwd_axis1`,
// `ntt4_fwd_fused`) and `_ntt4_inv_body` (with `_ln_inv_axis1`,
// `ntt4_inv_fused`), the 4-step transpose Pallas kernels.
//
// Layout: x is a contiguous u32[B, L, N]; one block transforms block_b
// consecutive (row, limb) pairs (limb = pair % L, so the rows of one block
// may belong to different limbs) and holds them in shared memory, 4N bytes
// each (32 KiB at N=8192; block_b = 1, 2, 4 take 32, 64, 128 KiB, opted into
// above 48 KiB).  A ragged last block runs only its valid rows.
//
// Each row is viewed as a [n1][n2] matrix, j = j2 + n2*j1.  Forward:
//   1. n2 length-n1 LN transforms down the columns (twiddle psi1[m + i]);
//      consecutive threads take consecutive columns, so the shared-memory
//      accesses of every stage fall in distinct banks;
//   2. an elementwise product with corr[limb][r*n2 + c];
//   3. n1 length-n2 LN transforms along the rows (twiddle psi2[m + i]);
//   4. the row is written back as it stands: element [p1][p2] is the flat
//      NTT's output slot p1*n2 + p2, because bitrev(k1 + n1*k2) =
//      bitrev(k1)*n2 + bitrev(k2).
// The JAX kernel's transposes are index arithmetic here (a transform "along
// the rows" reads stride 1, one "down the columns" reads stride n2): the row
// never moves in shared memory, so no transpose pass or padding is needed.
// The row transforms' last stages pair near neighbours and see the same
// two-way bank conflicts as the flat kernel's.  Inverse, as
// `_ntt4_inv_body` orders it: Gentleman-Sande transforms along the rows
// (psi2_inv), the product with corr_inv, transforms down the columns
// (psi1_inv), and one N^{-1} R scale on the way out.
//
// radix 4 fuses each pair of consecutive stages into one pass (one thread
// loads four elements, runs both stages' butterflies on them, and stores
// four) with one __syncthreads() per pair; a trailing radix-2 stage remains
// when log2 of the length is odd.  It performs the same mont_mul / mod_add /
// mod_sub on the same values as the two stages it replaces, and every value
// is canonical in [0, q), so every split, radix and block_b gives the flat
// kernel's bits.
//
// Bound: device memory, as for the flat kernel: each row is read once and
// written once, 8 bytes an element, 0.443 ms at [11328, 2, 8192] on the
// H100's 3.35 TB/s.  The corr table adds 4N bytes per limb, read through L2;
// the stages run out of shared memory.  Holding a 64- or 128-point
// sub-transform in one warp's registers and exchanging by shuffles, with no
// __syncthreads() per stage, is later work.
//
// Built with a host compiler (the CPU test of this source), the block
// bodies run as one thread a block, the stages in order: the same index
// arithmetic, with __syncthreads() a no-op and the kernels and launchers
// left out.
#include <stddef.h>
#include <stdint.h>

#include "mont.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define NTT4_DEV __device__ __forceinline__
#else
#define NTT4_DEV static inline
#define __syncthreads() ((void)0)
struct HostDim { unsigned x; };
static HostDim threadIdx = {0}, blockDim = {1}, blockIdx = {0};
#endif

namespace {

constexpr int kMaxBlockB = 8;

// Per-block row constants: the limb, q and -q^{-1} of each row of the block.
struct Rows {
  int limb[kMaxBlockB];
  uint32_t q[kMaxBlockB];
  uint32_t qi[kMaxBlockB];
};

// Element offsets of butterfly group `rest` of one row, for R-point groups
// along an axis of length 2^log_len.  kRows: the transform runs along the
// rows (stride 1, n_lines = N / len rows); else down the columns (stride
// N / len, consecutive `rest` on consecutive columns).
template <bool kRows, int R>
NTT4_DEV void locate(int rest, int log_n, int log_len,
                     int& base, int& jb, int& log_stride) {
  if (kRows) {
    const int log_per = log_len - (R == 4 ? 2 : 1);
    base = (rest >> log_per) << log_len;
    jb = rest & ((1 << log_per) - 1);
    log_stride = 0;
  } else {
    log_stride = log_n - log_len;
    base = rest & ((1 << log_stride) - 1);
    jb = rest >> log_stride;
  }
}

// Forward radix-2 stage m (half-distance t = 2^log_t): groups i of the LN
// recurrence pair (i*2t + k, i*2t + k + t) with twiddle psi[m + i].
template <bool kRows>
NTT4_DEV void fwd_stage2(uint32_t* s, const Rows& rw, int nvalid,
                         int log_n, int log_len, int m, int log_t,
                         const uint32_t* __restrict__ psi) {
  const int log_items = log_n - 1;
  const int items = nvalid << log_items;
  const int t = 1 << log_t;
  for (int w = threadIdx.x; w < items; w += blockDim.x) {
    const int r = w >> log_items;
    int base, jb, ls;
    locate<kRows, 2>(w & ((1 << log_items) - 1), log_n, log_len, base, jb,
                     ls);
    const int i = jb >> log_t;
    const int a = (i << (log_t + 1)) + (jb & (t - 1));
    uint32_t* row = s + (r << log_n);
    const uint32_t q = rw.q[r], qi = rw.qi[r];
    const int eu = base + (a << ls), ev = base + ((a + t) << ls);
    const uint32_t u = row[eu];
    const uint32_t v =
        mont_mul(row[ev], psi[(rw.limb[r] << log_len) + m + i], q, qi);
    row[eu] = mod_add(u, v, q);
    row[ev] = mod_sub(u, v, q);
  }
  __syncthreads();
}

// Forward stages m and 2m fused (t = 2^log_t is the second stage's
// half-distance): x0..x3 at i*4t + k + {0, t, 2t, 3t}.
template <bool kRows>
NTT4_DEV void fwd_stage4(uint32_t* s, const Rows& rw, int nvalid,
                         int log_n, int log_len, int m, int log_t,
                         const uint32_t* __restrict__ psi) {
  const int log_items = log_n - 2;
  const int items = nvalid << log_items;
  const int t = 1 << log_t;
  for (int w = threadIdx.x; w < items; w += blockDim.x) {
    const int r = w >> log_items;
    int base, jb, ls;
    locate<kRows, 4>(w & ((1 << log_items) - 1), log_n, log_len, base, jb,
                     ls);
    const int i = jb >> log_t;
    const int a = (i << (log_t + 2)) + (jb & (t - 1));
    uint32_t* row = s + (r << log_n);
    const uint32_t q = rw.q[r], qi = rw.qi[r];
    const uint32_t* p = psi + (rw.limb[r] << log_len);
    const int e0 = base + (a << ls), e1 = base + ((a + t) << ls);
    const int e2 = base + ((a + 2 * t) << ls);
    const int e3 = base + ((a + 3 * t) << ls);
    const uint32_t w1 = p[m + i];
    const uint32_t x0 = row[e0], x1 = row[e1];
    const uint32_t va = mont_mul(row[e2], w1, q, qi);
    const uint32_t vb = mont_mul(row[e3], w1, q, qi);
    const uint32_t y00 = mod_add(x0, va, q), y10 = mod_sub(x0, va, q);
    const uint32_t y01 = mod_add(x1, vb, q), y11 = mod_sub(x1, vb, q);
    const uint32_t v0 = mont_mul(y01, p[2 * m + 2 * i], q, qi);
    const uint32_t v1 = mont_mul(y11, p[2 * m + 2 * i + 1], q, qi);
    row[e0] = mod_add(y00, v0, q);
    row[e1] = mod_sub(y00, v0, q);
    row[e2] = mod_add(y10, v1, q);
    row[e3] = mod_sub(y10, v1, q);
  }
  __syncthreads();
}

// Inverse radix-2 stage h (half-distance t = 2^log_t): lo = u + v,
// hi = (u - v) * psi_inv[h + i].
template <bool kRows>
NTT4_DEV void inv_stage2(uint32_t* s, const Rows& rw, int nvalid,
                         int log_n, int log_len, int h, int log_t,
                         const uint32_t* __restrict__ psi_inv) {
  const int log_items = log_n - 1;
  const int items = nvalid << log_items;
  const int t = 1 << log_t;
  for (int w = threadIdx.x; w < items; w += blockDim.x) {
    const int r = w >> log_items;
    int base, jb, ls;
    locate<kRows, 2>(w & ((1 << log_items) - 1), log_n, log_len, base, jb,
                     ls);
    const int i = jb >> log_t;
    const int a = (i << (log_t + 1)) + (jb & (t - 1));
    uint32_t* row = s + (r << log_n);
    const uint32_t q = rw.q[r], qi = rw.qi[r];
    const int eu = base + (a << ls), ev = base + ((a + t) << ls);
    const uint32_t u = row[eu], v = row[ev];
    row[eu] = mod_add(u, v, q);
    row[ev] = mont_mul(mod_sub(u, v, q),
                       psi_inv[(rw.limb[r] << log_len) + h + i], q, qi);
  }
  __syncthreads();
}

// Inverse stages h = m/2 and m/4 fused (t = 2^log_t is the first stage's
// half-distance): x0..x3 at g*4t + k + {0, t, 2t, 3t}.
template <bool kRows>
NTT4_DEV void inv_stage4(uint32_t* s, const Rows& rw, int nvalid,
                         int log_n, int log_len, int m, int log_t,
                         const uint32_t* __restrict__ psi_inv) {
  const int log_items = log_n - 2;
  const int items = nvalid << log_items;
  const int t = 1 << log_t;
  for (int w = threadIdx.x; w < items; w += blockDim.x) {
    const int r = w >> log_items;
    int base, jb, ls;
    locate<kRows, 4>(w & ((1 << log_items) - 1), log_n, log_len, base, jb,
                     ls);
    const int g = jb >> log_t;
    const int a = (g << (log_t + 2)) + (jb & (t - 1));
    uint32_t* row = s + (r << log_n);
    const uint32_t q = rw.q[r], qi = rw.qi[r];
    const uint32_t* p = psi_inv + (rw.limb[r] << log_len);
    const int e0 = base + (a << ls), e1 = base + ((a + t) << ls);
    const int e2 = base + ((a + 2 * t) << ls);
    const int e3 = base + ((a + 3 * t) << ls);
    const uint32_t x0 = row[e0], x1 = row[e1], x2 = row[e2], x3 = row[e3];
    const uint32_t lo0 = mod_add(x0, x1, q);
    const uint32_t hi0 = mont_mul(mod_sub(x0, x1, q), p[m / 2 + 2 * g], q, qi);
    const uint32_t lo1 = mod_add(x2, x3, q);
    const uint32_t hi1 =
        mont_mul(mod_sub(x2, x3, q), p[m / 2 + 2 * g + 1], q, qi);
    const uint32_t wb = p[m / 4 + g];
    row[e0] = mod_add(lo0, lo1, q);
    row[e1] = mod_add(hi0, hi1, q);
    row[e2] = mont_mul(mod_sub(lo0, lo1, q), wb, q, qi);
    row[e3] = mont_mul(mod_sub(hi0, hi1, q), wb, q, qi);
  }
  __syncthreads();
}

// All forward stages of one axis: radix-4 pairs first, then the remaining
// radix-2 stage(s), as `_ln_fwd_axis1` orders them.
template <bool kRows>
NTT4_DEV void ln_fwd(uint32_t* s, const Rows& rw, int nvalid, int log_n,
                     int log_len, int radix, const uint32_t* psi) {
  const int len = 1 << log_len;
  int m = 1, log_t = log_len;
  if (radix == 4) {
    for (; (m << 2) <= len; m <<= 2) {
      log_t -= 2;
      fwd_stage4<kRows>(s, rw, nvalid, log_n, log_len, m, log_t, psi);
    }
  }
  for (; m < len; m <<= 1) {
    log_t -= 1;
    fwd_stage2<kRows>(s, rw, nvalid, log_n, log_len, m, log_t, psi);
  }
}

// All inverse stages of one axis, as `_ln_inv_axis1` orders them.
template <bool kRows>
NTT4_DEV void ln_inv(uint32_t* s, const Rows& rw, int nvalid, int log_n,
                     int log_len, int radix, const uint32_t* psi_inv) {
  int m = 1 << log_len, log_t = 0;
  while (m > 1) {
    if (radix == 4 && (m & 3) == 0) {
      inv_stage4<kRows>(s, rw, nvalid, log_n, log_len, m, log_t, psi_inv);
      log_t += 2;
      m >>= 2;
    } else {
      inv_stage2<kRows>(s, rw, nvalid, log_n, log_len, m >> 1, log_t,
                        psi_inv);
      log_t += 1;
      m >>= 1;
    }
  }
}

// Loads the block's rows into shared memory and its row constants into rw;
// returns the number of valid rows.
NTT4_DEV int load_rows(uint32_t* s, Rows& rw, const uint32_t* x,
                       const uint32_t* qs, const uint32_t* qinv,
                       long long rows, int n_limbs, int log_n,
                       int block_b) {
  const long long first = (long long)blockIdx.x * block_b;
  const int nvalid = (int)(rows - first < block_b ? rows - first : block_b);
  for (int r = threadIdx.x; r < nvalid; r += blockDim.x) {
    const int limb = (int)((first + r) % n_limbs);
    rw.limb[r] = limb;
    rw.q[r] = qs[limb];
    rw.qi[r] = qinv[limb];
  }
  const uint32_t* src = x + ((size_t)first << log_n);
  const int total = nvalid << log_n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) s[e] = src[e];
  __syncthreads();
  return nvalid;
}

// s[e] = s[e] * table[limb][e mod N] for every element of the valid rows.
NTT4_DEV void twist(uint32_t* s, const Rows& rw, int nvalid, int log_n,
                    const uint32_t* __restrict__ table) {
  const int total = nvalid << log_n;
  const int mask = (1 << log_n) - 1;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e >> log_n;
    s[e] = mont_mul(s[e], table[((size_t)rw.limb[r] << log_n) + (e & mask)],
                    rw.q[r], rw.qi[r]);
  }
  __syncthreads();
}

// One block's rows through the forward transform; s holds block_b rows.
NTT4_DEV void ntt4_fwd_block(uint32_t* s, Rows& rw, uint32_t* out,
                             const uint32_t* x, const uint32_t* psi1,
                             const uint32_t* psi2, const uint32_t* corr,
                             const uint32_t* qs, const uint32_t* qinv,
                             long long rows, int n_limbs, int log_n,
                             int log_n1, int block_b, int radix) {
  const int nvalid =
      load_rows(s, rw, x, qs, qinv, rows, n_limbs, log_n, block_b);
  ln_fwd<false>(s, rw, nvalid, log_n, log_n1, radix, psi1);
  twist(s, rw, nvalid, log_n, corr);
  ln_fwd<true>(s, rw, nvalid, log_n, log_n - log_n1, radix, psi2);
  uint32_t* dst = out + (((size_t)blockIdx.x * block_b) << log_n);
  const int total = nvalid << log_n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) dst[e] = s[e];
}

NTT4_DEV void ntt4_inv_block(uint32_t* s, Rows& rw, uint32_t* out,
                             const uint32_t* x, const uint32_t* psi1_inv,
                             const uint32_t* psi2_inv,
                             const uint32_t* corr_inv, const uint32_t* qs,
                             const uint32_t* qinv, const uint32_t* n_inv,
                             long long rows, int n_limbs, int log_n,
                             int log_n1, int block_b, int radix) {
  const int nvalid =
      load_rows(s, rw, x, qs, qinv, rows, n_limbs, log_n, block_b);
  ln_inv<true>(s, rw, nvalid, log_n, log_n - log_n1, radix, psi2_inv);
  twist(s, rw, nvalid, log_n, corr_inv);
  ln_inv<false>(s, rw, nvalid, log_n, log_n1, radix, psi1_inv);
  uint32_t* dst = out + (((size_t)blockIdx.x * block_b) << log_n);
  const int total = nvalid << log_n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e >> log_n;
    dst[e] = mont_mul(s[e], n_inv[rw.limb[r]], rw.q[r], rw.qi[r]);
  }
}

bool bad_args(long long rows, int log_n, int log_n1, int block_b, int radix) {
  return rows <= 0 || log_n1 < 1 || log_n1 > log_n - 1 || block_b < 1 ||
         block_b > kMaxBlockB || (radix != 2 && radix != 4);
}

}  // namespace

#if defined(__CUDACC__)

namespace {

__global__ void ntt4_fwd_kernel(uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ x,
                                const uint32_t* __restrict__ psi1,
                                const uint32_t* __restrict__ psi2,
                                const uint32_t* __restrict__ corr,
                                const uint32_t* __restrict__ qs,
                                const uint32_t* __restrict__ qinv,
                                long long rows, int n_limbs, int log_n,
                                int log_n1, int block_b, int radix) {
  extern __shared__ uint32_t s[];
  __shared__ Rows rw;
  ntt4_fwd_block(s, rw, out, x, psi1, psi2, corr, qs, qinv, rows, n_limbs,
                 log_n, log_n1, block_b, radix);
}

__global__ void ntt4_inv_kernel(uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ x,
                                const uint32_t* __restrict__ psi1_inv,
                                const uint32_t* __restrict__ psi2_inv,
                                const uint32_t* __restrict__ corr_inv,
                                const uint32_t* __restrict__ qs,
                                const uint32_t* __restrict__ qinv,
                                const uint32_t* __restrict__ n_inv,
                                long long rows, int n_limbs, int log_n,
                                int log_n1, int block_b, int radix) {
  extern __shared__ uint32_t s[];
  __shared__ Rows rw;
  ntt4_inv_block(s, rw, out, x, psi1_inv, psi2_inv, corr_inv, qs, qinv,
                 n_inv, rows, n_limbs, log_n, log_n1, block_b, radix);
}

// Shared memory above the 48 KiB default must be opted into per kernel.
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// One thread a butterfly of one row, at most 512 threads for one row and
// 1024 for several.
int threads_for(int log_n, int block_b) {
  const long long half = (long long)block_b << (log_n - 1);
  const int cap = block_b >= 2 ? 1024 : 512;
  return half < cap ? (int)half : cap;
}

}  // namespace

// rows = B * L; x and out are contiguous u32[B, L, N] with N = 2^log_n and
// n1 = 2^log_n1; psi1 u32[L, n1], psi2 u32[L, n2], corr u32[L, N].
extern "C" int ntt4_fwd_launch(uint32_t* out, const uint32_t* x,
                               const uint32_t* psi1, const uint32_t* psi2,
                               const uint32_t* corr, const uint32_t* qs,
                               const uint32_t* qinv, long long rows,
                               int n_limbs, int log_n, int log_n1,
                               int block_b, int radix, void* stream) {
  if (bad_args(rows, log_n, log_n1, block_b, radix))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)block_b * (sizeof(uint32_t) << log_n);
  cudaError_t err = set_smem(ntt4_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((rows + block_b - 1) / block_b);
  ntt4_fwd_kernel<<<grid, threads_for(log_n, block_b), smem,
                    (cudaStream_t)stream>>>(out, x, psi1, psi2, corr, qs,
                                            qinv, rows, n_limbs, log_n,
                                            log_n1, block_b, radix);
  return (int)cudaGetLastError();
}

extern "C" int ntt4_inv_launch(uint32_t* out, const uint32_t* x,
                               const uint32_t* psi1_inv,
                               const uint32_t* psi2_inv,
                               const uint32_t* corr_inv, const uint32_t* qs,
                               const uint32_t* qinv, const uint32_t* n_inv,
                               long long rows, int n_limbs, int log_n,
                               int log_n1, int block_b, int radix,
                               void* stream) {
  if (bad_args(rows, log_n, log_n1, block_b, radix))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)block_b * (sizeof(uint32_t) << log_n);
  cudaError_t err = set_smem(ntt4_inv_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((rows + block_b - 1) / block_b);
  ntt4_inv_kernel<<<grid, threads_for(log_n, block_b), smem,
                    (cudaStream_t)stream>>>(out, x, psi1_inv, psi2_inv,
                                            corr_inv, qs, qinv, n_inv, rows,
                                            n_limbs, log_n, log_n1, block_b,
                                            radix);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
