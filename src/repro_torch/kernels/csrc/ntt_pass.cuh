// Register-pass machinery shared by the port's NTT kernels: the flat NTT of
// ntt.cu and the 4-step NTT of ntt4.cu (each file's header note gives its
// design and its measurements).
//
// One block transforms one (row, limb) pair of N = 2^kLogN residues.  A
// thread holds 32 residues in registers (kLogElems).  The log2 N stages are
// cut into passes over bit ranges of the element index, the top bits first:
// pass p covers bits [lo, lo + bits) with bits <= 5, and one logical thread
// of a pass holds 32 / 2^bits sets of 2^bits residues that differ only in
// those bits, so the pass's stages run entirely in registers.  Between
// passes the row goes through shared memory once (element e at slot
// e + e/32); a thread writes back only the slots it read, so each exchange
// needs one __syncthreads().  The forward transform runs the passes top
// bits first, the inverse bottom bits first, and the inverse's last pass
// applies the N^{-1} R scale before its stores.
//
// What differs between the two NTTs is a twiddle policy (`Tw`), a template
// parameter of every function below, with two register-pressure choices:
// whether a pass strides its logical threads by blockDim.x or by
// kStaticStride (Tw::kStaticStride), and how many of a logical thread's
// sets run together (Tw::kSetBatch; the sets of a pass are independent):
//   Tw::stage<m, G>(bit)  the twiddles of the stage at index bit `bit`
//                      (half-distance t = 2^bit, flat twiddle row
//                      m = N / 2t), whose sets hold G consecutive groups
//                      i0 + g each: stage.set(i0) is a callable giving
//                      group i0 + g's twiddle for g < G;
//   Tw::kTwist         whether an elementwise Montgomery product by the
//                      table tw.corr_row() follows the stage at the bit
//                      for which tw.twists_after(bit) holds (a runtime
//                      choice: every possible position is compiled, one
//                      branch a stage decides).
// FlatTwiddles (ntt.cu) reads psi[m + i] and never twists; ntt4.cu's
// policy reads psi1 / psi2 and twists by corr.
//
// Built with a host compiler (the CPU tests of both sources), the block
// bodies run as one thread a block, the logical threads of each pass in
// order: the same index arithmetic, with __syncthreads() a no-op and the
// kernels and launchers left out.
#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define NTT_DEV __device__ __forceinline__
#define NTT_MEMBER __device__ __forceinline__
#define NTT_HD __host__ __device__
#else
#define NTT_DEV static inline
#define NTT_MEMBER inline
#define NTT_HD
#define __syncthreads() ((void)0)
#define __syncwarp() ((void)0)
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

// The stride of a pass's loop over logical threads when a policy asks for
// a compile-time trip count (Tw::kStaticStride): every launch runs
// block_threads() = min(logical threads, kMaxThreads) threads, so the loop
// runs once below N = 16384 and twice at it, unrolled either way.  The
// host build runs one thread a block.
#if defined(__CUDACC__)
constexpr int kStaticStride = kMaxThreads;
#else
constexpr int kStaticStride = 1;
#endif

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

// The flat NTT's twiddles: psi[m + i] of one limb's N-word table, read
// through L1 with m + g folded into the load's immediate offset.
struct FlatTwiddles {
  static constexpr bool kTwist = false;
  static constexpr bool kStaticStride = false;
  static constexpr int kSetBatch = 1 << kLogElems;   // all of them
  template <int kM>
  struct Set {
    const uint32_t* __restrict__ w;
    int i0;
    NTT_MEMBER uint32_t operator()(int g) const { return w[kM + i0 + g]; }
  };
  template <int kM>
  struct Stage {
    const uint32_t* __restrict__ w;
    NTT_MEMBER Set<kM> set(int i0) const { return {w, i0}; }
  };
  const uint32_t* __restrict__ w;
  template <int kM, int kG>
  NTT_MEMBER Stage<kM> stage(int /*bit*/) const { return {w}; }
};

// The twist of one pass's registers (Tw::kTwist): v[s * 2^kBits + k] of
// element base[s] + (k << kLo) times c[that element], each word read from
// device memory right before its product, in chunks of kTwistChunk words
// with a __syncwarp() after each chunk: ptxas otherwise issues all of the
// twist's loads ahead of their products, and the words in flight beside
// the 32 residues spilled (in one pass or another at most log2 N).  No
// 16-byte path: the twist reaches the one pass with consecutive elements
// (lo = 0) only at n2 <= 8, and a second copy of every twist position
// costs registers in every kernel.
constexpr int kTwistChunk = 8;

template <int kLo, int kBits, int kSets>
NTT_DEV void twist(uint32_t* v, const int* base,
                   const uint32_t* __restrict__ c, uint32_t q, uint32_t qi) {
  constexpr int kSet = 1 << kBits;
#pragma unroll
  for (int e = 0; e < kSets * kSet; ++e) {
    const int s = e / kSet, k = e % kSet;
    v[e] = bf_mont_mul(v[e], c[base[s] + (k << kLo)], q, qi);
    if (e % kTwistChunk == kTwistChunk - 1) __syncwarp();
  }
}

// Forward stages of one pass, local bit kB = kBits-1 down to 0: pairs
// (k, k + 2^kB) of each set, twiddle of group i = (hi << (kBits-1-kB)) +
// k >> (kB+1) from Tw::stage<N / 2t, groups>(kLo + kB), t = 2^(kLo + kB).
template <int kLogN, int kLo, int kBits, int kSets, int kB, class Tw>
NTT_DEV void fwd_stages(uint32_t* v, const int* hi, const int* base,
                        const Tw tw, uint32_t q, uint32_t qi) {
  if constexpr (kB >= 0) {
    constexpr int kT = 1 << kB;
    constexpr int kGroups = 1 << (kBits - 1 - kB);
    constexpr int kM = 1 << (kLogN - kLo - kB - 1);
    const auto w = tw.template stage<kM, kGroups>(kLo + kB);
#pragma unroll
    for (int s = 0; s < kSets; ++s) {
      const auto ws = w.set(hi[s] << (kBits - 1 - kB));
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const uint32_t t = ws(g);
#pragma unroll
        for (int k0 = 0; k0 < kT; ++k0) {
          const int a = (s << kBits) + g * 2 * kT + k0;
          const uint32_t u = v[a];
          const uint32_t x = bf_mont_mul(v[a + kT], t, q, qi);
          v[a] = bf_add(u, x, q);
          v[a + kT] = bf_sub(u, x, q);
        }
      }
    }
    if constexpr (Tw::kTwist) {
      if (tw.twists_after(kLo + kB))
        twist<kLo, kBits, kSets>(v, base, tw.corr_row(), q, qi);
    }
    fwd_stages<kLogN, kLo, kBits, kSets, kB - 1>(v, hi, base, tw, q, qi);
  }
}

// Inverse stages of one pass, local bit kB = 0 up to kBits-1: lo = u + v,
// hi = (u - v) * twiddle, from Tw::stage<N / 2t, groups>(kLo + kB).
template <int kLogN, int kLo, int kBits, int kSets, int kB, class Tw>
NTT_DEV void inv_stages(uint32_t* v, const int* hi, const int* base,
                        const Tw tw, uint32_t q, uint32_t qi) {
  if constexpr (kB < kBits) {
    constexpr int kT = 1 << kB;
    constexpr int kGroups = 1 << (kBits - 1 - kB);
    constexpr int kH = 1 << (kLogN - kLo - kB - 1);
    const auto w = tw.template stage<kH, kGroups>(kLo + kB);
#pragma unroll
    for (int s = 0; s < kSets; ++s) {
      const auto ws = w.set(hi[s] << (kBits - 1 - kB));
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const uint32_t t = ws(g);
#pragma unroll
        for (int k0 = 0; k0 < kT; ++k0) {
          const int a = (s << kBits) + g * 2 * kT + k0;
          const uint32_t x0 = v[a], x1 = v[a + kT];
          v[a] = bf_add(x0, x1, q);
          v[a + kT] = bf_mont_mul(bf_sub(x0, x1, q), t, q, qi);
        }
      }
    }
    if constexpr (Tw::kTwist) {
      if (tw.twists_after(kLo + kB))
        twist<kLo, kBits, kSets>(v, base, tw.corr_row(), q, qi);
    }
    inv_stages<kLogN, kLo, kBits, kSets, kB + 1>(v, hi, base, tw, q, qi);
  }
}

// One pass of one row: src and dst are the row in device memory
// (kFromGlobal / kToGlobal) or the block's shared copy (slot layout).
// Logical thread lt holds the sets r = lt + s * kThreads, s < kSets; set r
// is the 2^kBits elements base(r) + (k << kLo).  The inverse's last pass
// (kInv and kToGlobal) applies the N^{-1} R scale before its stores.
template <bool kInv, int kLogN, int kPass, bool kFromGlobal, bool kToGlobal,
          class Tw>
NTT_DEV void ntt_pass(const uint32_t* src, uint32_t* dst, const Tw tw,
                      uint32_t q, uint32_t qi, uint32_t n_inv) {
  using P = Plan<kLogN>;
  constexpr int kBits = P::bits(kPass), kLo = P::lo(kPass);
  constexpr int kSet = 1 << kBits;
  constexpr int kSets = (1 << P::kLogE) >> kBits;
  constexpr int kT = P::kThreads;
  // the sets a logical thread runs together (Tw::kSetBatch at most)
  constexpr int kBatch = kSets < Tw::kSetBatch ? kSets : Tw::kSetBatch;
  // a set of 4+ consecutive elements moves as 16-byte words when the row
  // in device memory is 16-byte aligned
  constexpr bool kVec = kLo == 0 && kSet >= 4;
  const bool vec_in = kFromGlobal && aligned16(src);
  const bool vec_out = kToGlobal && aligned16(dst);
  // sets s0 .. s0 + kBatch - 1 of logical thread lt
  const auto sets = [&](int lt, int s0) {
    uint32_t v[kBatch * kSet];
    int hi[kBatch], base[kBatch];
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      const int r = lt + (s0 + s) * kT;
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
      inv_stages<kLogN, kLo, kBits, kBatch, 0>(v, hi, base, tw, q, qi);
    else
      fwd_stages<kLogN, kLo, kBits, kBatch, kBits - 1>(v, hi, base, tw, q,
                                                      qi);
    if constexpr (kInv && kToGlobal) {
#pragma unroll
      for (int k = 0; k < kBatch * kSet; ++k)
        v[k] = bf_mont_mul(v[k], n_inv, q, qi);
    }
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
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
  };
  const auto all_sets = [&](int lt) {
#pragma unroll
    for (int s0 = 0; s0 < kSets; s0 += kBatch) sets(lt, s0);
  };
  if constexpr (Tw::kStaticStride) {
#pragma unroll
    for (int lt0 = 0; lt0 < kT; lt0 += kStaticStride)
      if ((int)threadIdx.x + lt0 < kT) all_sets((int)threadIdx.x + lt0);
  } else {
    for (int lt = threadIdx.x; lt < kT; lt += blockDim.x) all_sets(lt);
  }
}

// One row (x and out offset to it) through every pass; s is the block's
// shared row (smem_words(kLogN) words), n_inv unused by the forward
// transform.
template <bool kInv, int kLogN, class Tw>
NTT_DEV void ntt_row(uint32_t* s, uint32_t* out, const uint32_t* x,
                     const Tw tw, uint32_t q, uint32_t qi, uint32_t n_inv) {
  using P = Plan<kLogN>;
  constexpr int kFirst = kInv ? P::kPasses - 1 : 0;
  constexpr int kLast = kInv ? 0 : P::kPasses - 1;
  if constexpr (P::kPasses == 1) {
    ntt_pass<kInv, kLogN, 0, true, true>(x, out, tw, q, qi, n_inv);
  } else {
    ntt_pass<kInv, kLogN, kFirst, true, false>(x, s, tw, q, qi, n_inv);
    __syncthreads();
    if constexpr (P::kPasses == 3) {
      ntt_pass<kInv, kLogN, 1, false, false>(s, s, tw, q, qi, n_inv);
      __syncthreads();
    }
    ntt_pass<kInv, kLogN, kLast, false, true>(s, out, tw, q, qi, n_inv);
  }
}

}  // namespace

#if defined(__CUDACC__)

namespace {

// One launch of kernel at log2 N = log_n, one block a (row, limb) pair
// with `words` words of shared memory: above the 48 KiB default it is
// opted into first (N = 16384 takes 66 KiB).
template <typename K, typename... Args>
cudaError_t launch_rows(K kernel, long long rows, int log_n, int words,
                        void* stream, Args... args) {
  const size_t smem = sizeof(uint32_t) * words;
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

#endif  // __CUDACC__
