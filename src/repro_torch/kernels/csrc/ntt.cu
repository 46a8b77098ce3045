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
// Design (the pass machinery is ntt_pass.cuh's, shared with ntt4.cu; this
// file reads the twiddles as FlatTwiddles, psi[m + i] of the limb's N-word
// table).  A thread holds 32 residues in registers (kLogElems).  The log2 N
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
// bodies run as one thread a block (ntt_pass.cuh).
#include "ntt_pass.cuh"

namespace {

// One block's (row, limb) pair through every pass; s is the block's shared
// row (smem_words(kLogN) words), n_inv null for the forward transform.
template <bool kInv, int kLogN>
NTT_DEV void ntt_block(uint32_t* s, uint32_t* out, const uint32_t* x,
                       const uint32_t* w, const uint32_t* qs,
                       const uint32_t* qinv, const uint32_t* n_inv,
                       int n_limbs) {
  const int limb = (int)(blockIdx.x % (unsigned)n_limbs);
  const size_t row = (size_t)blockIdx.x << kLogN;
  const FlatTwiddles tw{w + ((size_t)limb << kLogN)};
  ntt_row<kInv, kLogN>(s, out + row, x + row, tw, qs[limb], qinv[limb],
                       kInv ? n_inv[limb] : 0);
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
    return (int)launch_rows(ntt_fwd_kernel<L>, rows, log_n,              \
                            smem_words(log_n), stream, out, x, psi, qs,    \
                            qinv, n_limbs);
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
    return (int)launch_rows(ntt_inv_kernel<L>, rows, log_n,              \
                            smem_words(log_n), stream, out, x, psi_inv,    \
                            qs, qinv, n_inv, n_limbs);
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
