// Negacyclic NTT / inverse NTT for Hopper (sm_90a), all RNS limbs in one
// launch, with the butterflies in registers.
//
// Replaces: src/repro/kernels/ntt.py `_ntt_fwd_body` / `ntt_fwd_fused` and
// `_ntt_inv_body` / `ntt_inv_fused` (the flat limb-grid Pallas kernels).
//
// Layout: x is a contiguous u32[B, L, N]; one block per (row, limb) pair,
// limb = blockIdx.x % L.  The butterflies and twiddles are the JAX
// reference recurrence's (forward: Cooley-Tukey, stage m pairs (a, a + t)
// with t = N / 2m and twiddle psi_rev[m + i] for group i = a / 2t;
// inverse: Gentleman-Sande with psi_inv_rev[h + i], then the N^{-1} R
// scale).  Every value stays canonical in [0, q), so any schedule of the
// same butterflies gives the same bits.
//
// Design.  A thread holds 32 residues in registers (kLogElems).  The log2 N
// stages are cut into passes over bit ranges of the element index, the top
// bits first: each pass covers at most 5 bits [lo, lo + bits), and one
// logical thread of a pass holds 32 / 2^bits sets of 2^bits residues that
// differ only in those bits, so the pass's stages run entirely in
// registers.  At N = 8192 (256 threads) that is three passes instead of
// thirteen stages over shared memory:
//   pass 0, t = 4096 .. 256: thread j loads x[j + 256k], k < 32, straight
//     from device memory (a warp reads 128 consecutive bytes per k); the
//     twiddles psi[1 .. 31] are the same for every thread of the block;
//   pass 1, t = 128 .. 8: 32 residues at stride 8 inside one 256-element
//     segment (thread j: segment j / 8, offset j % 8), 31 twiddles a thread;
//   pass 2, t = 4, 2, 1: four 8-element groups, j + 256r, r < 4, written
//     back with 16-byte stores, 7 twiddles a group.
// The inverse runs the same passes in the opposite order, loads pass 2's
// groups with 16-byte loads and folds the N^{-1} R scale into pass 0's
// stores.  Between passes the row goes through shared memory once; a
// thread writes back only the slots it read, so each exchange needs one
// __syncthreads(): two a launch at N = 8192.
//
// Shared memory: element e lives at slot e + e/32 (one pad word after every
// 32; 33,788 bytes at N = 8192).  Conflict degree of each access at
// N = 8192, per warp instruction: pass 0's writes (32 consecutive e)
// conflict-free; pass 1's reads and writes (bank r + 8*seg + 8k + k/4 over
// the warp's 8 offsets r and 4 segments) conflict-free, 4-way without the
// pad; pass 2's reads (bank 8*(j%4) + j/4 + c + const) conflict-free, 8-way
// without the pad.  Slot arithmetic is compile-time: slot(base + (k << lo))
// = slot(base) + slot(k << lo) because the two terms share no bit.
//
// Each kernel is instantiated per log2 N (1 .. 14), so every register index
// is a compile-time constant after unrolling and the arrays stay in
// registers.  N = 16384 runs three passes too (5 + 5 + 4 bits) with 256
// threads looping over its 512 logical threads; N < 32 is one pass with no
// shared memory.
//
// Bound: device memory, once the selects are cheap.  Each row is read once
// and written once (8 bytes an element, 0.443 ms at [11328, 2, 8192] on the
// H100's 3.35 TB/s); N/2 * log2 N butterflies a row each need 3 multiplies
// and 5 ALU instructions (a modular add, subtract or final reduction is an
// add and one VIADDMNMX, Hopper's fused add and unsigned min), 0.22 and
// 0.36 ms of the two integer pipes at 64 lanes an SM.  Written as
// mont.cuh's `x >= q ? x - q : x`, each select compiles to a compare and a
// select instead (8 ALU a butterfly, 0.58 ms), so the butterfly steps below
// take the unsigned min, and nvcc folds it with the add before it.  The
// block is capped at 64 registers (__launch_bounds__(256, 4): four blocks,
// 32 warps an SM, no spills) for latency hiding; on the card both beat
// compare-and-select at 80 registers and three blocks an SM (PERF.md).
// The twiddle rows (4N bytes per limb) are read through L1 / L2.
//
// Built with a host compiler (the CPU test of this source), the block
// bodies run as one thread a block, the logical threads of each pass in
// order: the same index arithmetic, with __syncthreads() a no-op and the
// kernels and launchers left out.
#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define NTT_DEV __device__ __forceinline__
#define NTT_HD __host__ __device__
#else
#define NTT_DEV static inline
#define NTT_HD
#define __syncthreads() ((void)0)
struct HostDim { unsigned x; };
static HostDim threadIdx = {0}, blockDim = {1}, blockIdx = {0};
#endif

namespace {

constexpr int kLogElems = 5;     // a thread holds 2^5 residues
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 4;    // blocks an SM: at most 64 registers
constexpr int kMaxLogN = 14;

// The pass plan at N = 2^kLogN: pass p covers index bits
// [lo(p), lo(p) + bits(p)), the top bits first.
template <int kLogN>
struct Plan {
  static constexpr int kLogE = kLogN < kLogElems ? kLogN : kLogElems;
  static constexpr int kPasses = (kLogN + kLogElems - 1) / kLogElems;
  static constexpr int kThreads = 1 << (kLogN - kLogE);   // logical threads
  NTT_HD static constexpr int bits(int p) {
    return kLogN - kLogElems * p < kLogElems ? kLogN - kLogElems * p
                                             : kLogElems;
  }
  NTT_HD static constexpr int lo(int p) {
    return kLogN - kLogElems * p - bits(p);
  }
  static_assert(kPasses >= 1 && kPasses <= 3, "1 <= log2 N <= 15");
};

// Shared-memory slot of element e: a pad word after every 32.
NTT_HD constexpr int slot(int e) { return e + (e >> 5); }

NTT_HD constexpr int smem_words(int log_n) {
  return log_n <= kLogElems ? 0 : slot((1 << log_n) - 1) + 1;
}

NTT_HD constexpr int block_threads(int log_n) {
  return log_n <= kLogElems ? 1
         : (1 << (log_n - kLogElems)) < kMaxThreads
             ? 1 << (log_n - kLogElems)
             : kMaxThreads;
}

// The butterflies' modular steps: mont.cuh's mont_mul, mod_add and mod_sub
// (same arguments, same canonical results; mont.cuh states the ranges) with
// the final select written as an unsigned min, which nvcc issues as one
// instruction where `x >= q ? x - q : x` takes a compare and a select:
//   r < 2q:      r mod q     = min(r, r - q)   (r - q wraps when r < q)
//   a, b < q:    a + b mod q = min(s, s - q),  s = a + b < 2q
//                a - b mod q = min(d, d + q),  d = a - b (wraps when a < b)
NTT_DEV uint32_t umin(uint32_t a, uint32_t b) {
#if defined(__CUDACC__)
  return min(a, b);
#else
  return a < b ? a : b;
#endif
}

NTT_DEV uint32_t bf_mont_mul(uint32_t a, uint32_t b, uint32_t q,
                             uint32_t qinv_neg) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * qinv_neg;
  const uint32_t r = (uint32_t)((t + (uint64_t)m * q) >> 32);
  return umin(r, r - q);
}

NTT_DEV uint32_t bf_add(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;
  return umin(s, s - q);
}

NTT_DEV uint32_t bf_sub(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t d = a - b;
  return umin(d, d + q);
}

NTT_DEV bool aligned16(const uint32_t* p) {
  return ((uintptr_t)p & 15) == 0;
}

NTT_DEV void load4(const uint32_t* p, uint32_t& a, uint32_t& b, uint32_t& c,
                   uint32_t& d) {
#if defined(__CUDACC__)
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  a = t.x, b = t.y, c = t.z, d = t.w;
#else
  a = p[0], b = p[1], c = p[2], d = p[3];
#endif
}

NTT_DEV void store4(uint32_t* p, uint32_t a, uint32_t b, uint32_t c,
                    uint32_t d) {
#if defined(__CUDACC__)
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
#else
  p[0] = a, p[1] = b, p[2] = c, p[3] = d;
#endif
}

// Forward stages of one pass, local bit kB = kBits-1 down to 0: pairs
// (k, k + 2^kB) of each set, twiddle psi[m + i] with m = N / 2t,
// t = 2^(kLo + kB), and group i = (hi << (kBits-1-kB)) + k >> (kB+1).
template <int kLogN, int kLo, int kBits, int kSets, int kB>
NTT_DEV void fwd_stages(uint32_t* v, const int* hi,
                        const uint32_t* __restrict__ w, uint32_t q,
                        uint32_t qi) {
  if constexpr (kB >= 0) {
    constexpr int kT = 1 << kB;
    constexpr int kGroups = 1 << (kBits - 1 - kB);
    constexpr int kM = 1 << (kLogN - kLo - kB - 1);
#pragma unroll
    for (int s = 0; s < kSets; ++s) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const uint32_t tw = w[kM + (hi[s] << (kBits - 1 - kB)) + g];
#pragma unroll
        for (int k0 = 0; k0 < kT; ++k0) {
          const int a = (s << kBits) + g * 2 * kT + k0;
          const uint32_t u = v[a];
          const uint32_t t = bf_mont_mul(v[a + kT], tw, q, qi);
          v[a] = bf_add(u, t, q);
          v[a + kT] = bf_sub(u, t, q);
        }
      }
    }
    fwd_stages<kLogN, kLo, kBits, kSets, kB - 1>(v, hi, w, q, qi);
  }
}

// Inverse stages of one pass, local bit kB = 0 up to kBits-1: lo = u + v,
// hi = (u - v) * psi_inv[h + i] with h = N / 2t.
template <int kLogN, int kLo, int kBits, int kSets, int kB>
NTT_DEV void inv_stages(uint32_t* v, const int* hi,
                        const uint32_t* __restrict__ w, uint32_t q,
                        uint32_t qi) {
  if constexpr (kB < kBits) {
    constexpr int kT = 1 << kB;
    constexpr int kGroups = 1 << (kBits - 1 - kB);
    constexpr int kH = 1 << (kLogN - kLo - kB - 1);
#pragma unroll
    for (int s = 0; s < kSets; ++s) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const uint32_t tw = w[kH + (hi[s] << (kBits - 1 - kB)) + g];
#pragma unroll
        for (int k0 = 0; k0 < kT; ++k0) {
          const int a = (s << kBits) + g * 2 * kT + k0;
          const uint32_t x0 = v[a], x1 = v[a + kT];
          v[a] = bf_add(x0, x1, q);
          v[a + kT] = bf_mont_mul(bf_sub(x0, x1, q), tw, q, qi);
        }
      }
    }
    inv_stages<kLogN, kLo, kBits, kSets, kB + 1>(v, hi, w, q, qi);
  }
}

// One pass of one row: src and dst are the row in device memory
// (kFromGlobal / kToGlobal) or the block's shared copy (slot layout).
// Logical thread lt holds the sets r = lt + s * kThreads, s < kSets; set r
// is the 2^kBits elements base(r) + (k << kLo).  The inverse's last pass
// (kInv and kToGlobal) applies the N^{-1} R scale before its stores.
template <bool kInv, int kLogN, int kPass, bool kFromGlobal, bool kToGlobal>
NTT_DEV void ntt_pass(const uint32_t* src, uint32_t* dst,
                      const uint32_t* __restrict__ w, uint32_t q,
                      uint32_t qi, uint32_t n_inv) {
  using P = Plan<kLogN>;
  constexpr int kBits = P::bits(kPass), kLo = P::lo(kPass);
  constexpr int kSet = 1 << kBits;
  constexpr int kSets = (1 << P::kLogE) >> kBits;
  constexpr int kT = P::kThreads;
  // a set of 4+ consecutive elements moves as 16-byte words when the row
  // in device memory is 16-byte aligned
  constexpr bool kVec = kLo == 0 && kSet >= 4;
  const bool vec_in = kFromGlobal && aligned16(src);
  const bool vec_out = kToGlobal && aligned16(dst);
  for (int lt = threadIdx.x; lt < kT; lt += blockDim.x) {
    uint32_t v[kSets * kSet];
    int hi[kSets], base[kSets];
#pragma unroll
    for (int s = 0; s < kSets; ++s) {
      const int r = lt + s * kT;
      hi[s] = r >> kLo;
      base[s] = (hi[s] << (kLo + kBits)) | (r & ((1 << kLo) - 1));
      uint32_t* vs = v + s * kSet;
      if constexpr (!kFromGlobal) {
        const uint32_t* row = src + slot(base[s]);
#pragma unroll
        for (int k = 0; k < kSet; ++k) vs[k] = row[slot(k << kLo)];
      } else if constexpr (kVec) {
        if (vec_in) {
#pragma unroll
          for (int k = 0; k < kSet; k += 4)
            load4(src + base[s] + k, vs[k], vs[k + 1], vs[k + 2], vs[k + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < kSet; ++k) vs[k] = src[base[s] + k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < kSet; ++k) vs[k] = src[base[s] + (k << kLo)];
      }
    }
    if constexpr (kInv)
      inv_stages<kLogN, kLo, kBits, kSets, 0>(v, hi, w, q, qi);
    else
      fwd_stages<kLogN, kLo, kBits, kSets, kBits - 1>(v, hi, w, q, qi);
    if constexpr (kInv && kToGlobal) {
#pragma unroll
      for (int k = 0; k < kSets * kSet; ++k)
        v[k] = bf_mont_mul(v[k], n_inv, q, qi);
    }
#pragma unroll
    for (int s = 0; s < kSets; ++s) {
      const uint32_t* vs = v + s * kSet;
      if constexpr (!kToGlobal) {
        uint32_t* row = dst + slot(base[s]);
#pragma unroll
        for (int k = 0; k < kSet; ++k) row[slot(k << kLo)] = vs[k];
      } else if constexpr (kVec) {
        if (vec_out) {
#pragma unroll
          for (int k = 0; k < kSet; k += 4)
            store4(dst + base[s] + k, vs[k], vs[k + 1], vs[k + 2], vs[k + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < kSet; ++k) dst[base[s] + k] = vs[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < kSet; ++k) dst[base[s] + (k << kLo)] = vs[k];
      }
    }
  }
}

// One block's (row, limb) pair through every pass; s is the block's shared
// row (smem_words(kLogN) words), n_inv null for the forward transform.
template <bool kInv, int kLogN>
NTT_DEV void ntt_block(uint32_t* s, uint32_t* out, const uint32_t* x,
                       const uint32_t* w, const uint32_t* qs,
                       const uint32_t* qinv, const uint32_t* n_inv,
                       int n_limbs) {
  using P = Plan<kLogN>;
  const int limb = (int)(blockIdx.x % (unsigned)n_limbs);
  const size_t row = (size_t)blockIdx.x << kLogN;
  x += row;
  out += row;
  w += (size_t)limb << kLogN;
  const uint32_t q = qs[limb], qi = qinv[limb];
  const uint32_t ninv = kInv ? n_inv[limb] : 0;
  constexpr int kFirst = kInv ? P::kPasses - 1 : 0;
  constexpr int kLast = kInv ? 0 : P::kPasses - 1;
  if constexpr (P::kPasses == 1) {
    ntt_pass<kInv, kLogN, 0, true, true>(x, out, w, q, qi, ninv);
  } else {
    ntt_pass<kInv, kLogN, kFirst, true, false>(x, s, w, q, qi, ninv);
    __syncthreads();
    if constexpr (P::kPasses == 3) {
      ntt_pass<kInv, kLogN, 1, false, false>(s, s, w, q, qi, ninv);
      __syncthreads();
    }
    ntt_pass<kInv, kLogN, kLast, false, true>(s, out, w, q, qi, ninv);
  }
}

bool bad_args(long long rows, int n_limbs, int log_n) {
  return rows <= 0 || n_limbs < 1 || log_n < 1 || log_n > kMaxLogN;
}

}  // namespace

// Applies X to every supported log2 N.
#define NTT_FOR_EACH_LOG_N(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14)

#if defined(__CUDACC__)

namespace {

template <int kLogN>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    ntt_fwd_kernel(uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ psi,
                   const uint32_t* __restrict__ qs,
                   const uint32_t* __restrict__ qinv, int n_limbs) {
  extern __shared__ uint32_t s[];
  ntt_block<false, kLogN>(s, out, x, psi, qs, qinv, nullptr, n_limbs);
}

template <int kLogN>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    ntt_inv_kernel(uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ psi_inv,
                   const uint32_t* __restrict__ qs,
                   const uint32_t* __restrict__ qinv,
                   const uint32_t* __restrict__ n_inv, int n_limbs) {
  extern __shared__ uint32_t s[];
  ntt_block<true, kLogN>(s, out, x, psi_inv, qs, qinv, n_inv, n_limbs);
}

// One launch of kernel at log2 N = log_n: shared memory above the 48 KiB
// default is opted into first (N = 16384 takes 66 KiB).
template <typename K, typename... Args>
cudaError_t launch(K kernel, long long rows, int log_n, void* stream,
                   Args... args) {
  const size_t smem = sizeof(uint32_t) * smem_words(log_n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)rows, block_threads(log_n), smem,
           (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// rows = B * L; x and out are contiguous u32[B, L, N] with N = 2^log_n.
extern "C" int ntt_fwd_launch(uint32_t* out, const uint32_t* x,
                              const uint32_t* psi, const uint32_t* qs,
                              const uint32_t* qinv, long long rows,
                              int n_limbs, int log_n, void* stream) {
  if (bad_args(rows, n_limbs, log_n)) return (int)cudaErrorInvalidValue;
  switch (log_n) {
#define NTT_FWD_CASE(L)                                                     \
  case L:                                                                   \
    return (int)launch(ntt_fwd_kernel<L>, rows, log_n, stream, out, x, psi, \
                       qs, qinv, n_limbs);
    NTT_FOR_EACH_LOG_N(NTT_FWD_CASE)
#undef NTT_FWD_CASE
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int ntt_inv_launch(uint32_t* out, const uint32_t* x,
                              const uint32_t* psi_inv, const uint32_t* qs,
                              const uint32_t* qinv, const uint32_t* n_inv,
                              long long rows, int n_limbs, int log_n,
                              void* stream) {
  if (bad_args(rows, n_limbs, log_n)) return (int)cudaErrorInvalidValue;
  switch (log_n) {
#define NTT_INV_CASE(L)                                                     \
  case L:                                                                   \
    return (int)launch(ntt_inv_kernel<L>, rows, log_n, stream, out, x,      \
                       psi_inv, qs, qinv, n_inv, n_limbs);
    NTT_FOR_EACH_LOG_N(NTT_INV_CASE)
#undef NTT_INV_CASE
  }
  return (int)cudaErrorInvalidValue;
}

#else  // the host build: one block at a time, for the CPU test

// Block blockIdx.x of a launch at log2 N = log_n; s holds smem_words(log_n)
// words (at least one).  Returns false for an unsupported log_n.
static bool ntt_host_block(bool inverse, int log_n, uint32_t* s,
                           uint32_t* out, const uint32_t* x,
                           const uint32_t* w, const uint32_t* qs,
                           const uint32_t* qinv, const uint32_t* n_inv,
                           int n_limbs) {
  switch (log_n) {
#define NTT_HOST_CASE(L)                                                  \
  case L:                                                                 \
    if (inverse)                                                          \
      ntt_block<true, L>(s, out, x, w, qs, qinv, n_inv, n_limbs);         \
    else                                                                  \
      ntt_block<false, L>(s, out, x, w, qs, qinv, nullptr, n_limbs);      \
    return true;
    NTT_FOR_EACH_LOG_N(NTT_HOST_CASE)
#undef NTT_HOST_CASE
  }
  return false;
}

#endif  // __CUDACC__
