// 4-step negacyclic NTT / inverse NTT for Hopper (sm_90a), all RNS limbs in
// one launch, bit-identical to the flat kernels of ntt.cu.
//
// Replaces: src/repro/kernels/ntt.py `_ntt4_fwd_body` (with `_ln_fwd_axis1`,
// `ntt4_fwd_fused`) and `_ntt4_inv_body` (with `_ln_inv_axis1`,
// `ntt4_inv_fused`), the 4-step transpose Pallas kernels.
//
// Layout: x is a contiguous u32[B, L, N]; one block per (row, limb) pair,
// limb = blockIdx.x % L, as in ntt.cu.  Each row is viewed in place as a
// [n1][n2] matrix, j = j2 + n2*j1.  Forward: n2 length-n1 LN transforms
// down the columns (twiddles psi1), a product with corr[limb][j], n1
// length-n2 LN transforms along the rows (twiddles psi2); element [p1][p2]
// of the result is the flat NTT's output slot p1*n2 + p2, because
// bitrev(k1 + n1*k2) = bitrev(k1)*n2 + bitrev(k2), so the row is stored as
// it stands.  Inverse, as `_ntt4_inv_body` orders it: Gentleman-Sande along
// the rows (psi2_inv), the product with corr_inv, down the columns
// (psi1_inv), and the N^{-1} R scale.
//
// Design: the flat kernel's register passes (ntt_pass.cuh), with the
// 4-step's twiddles and the twist as its policy.  A column stage is a
// stage on an index bit >= log2 n2 and a row stage one on a bit below, so:
//   * the column stages are the flat NTT's first log2 n1 stages, butterfly
//     for butterfly, because psi1 = psi_rev[:n1]: group i of the stage at
//     bit b takes psi1[m + i], m = N / 2^(b+1) < n1;
//   * a row stage takes psi2[m2 + (i mod m2)], m2 = m / n1: its group
//     within the row transform of length n2 (the mask and the table's
//     offset are chosen once a stage);
//   * the twist is elementwise, so it runs in registers right after the
//     stage at bit log2 n2 (forward; the inverse: after bit log2 n2 - 1),
//     inside whichever pass holds that stage.  Earlier passes did every
//     higher bit, so each register then holds an element done with its
//     column (inverse: row) transform, and the element's own index e =
//     base + (k << lo) addresses corr with the same coalescing as x.
// Every split therefore runs the flat plan: 5 | 5 | 3 bits at N = 8192,
// three passes and two exchanges, whichever of 32x256, 64x128 or 128x64;
// the twist falls on the edge of passes 0 and 1 at 32x256 (after pass 0's
// last stage) and inside pass 1 at 64x128 and 128x64.  log2 n1 is a
// runtime argument: a stage's column-or-row choice and the twist's
// position are uniform across the block (one compare a stage), so one
// instantiation per log2 N (2 .. 14) serves every split, and every
// possible twist position is compiled into the unrolled stages, one of
// them taken.  Every value stays canonical in [0, q), so this schedule of
// the 4-step's butterflies gives the reference's bits.
//
// Choices.  `radix` left the kernel: a register pass runs up to five
// stages between exchanges whatever the radix, and the radix-4 butterfly
// is two radix-2 stages' arithmetic, so it would only be a second name for
// the same launch.  `block_b` left it too: one block a (row, limb) pair at
// four blocks an SM is the flat kernel's occupancy; the wrappers still
// take and check both for the plain version and for caches that name
// them.  The block first copies its limb's psi1 and psi2 (n1 + n2 words,
// 288 at 32x256) into shared memory behind the row, one barrier, and every
// stage reads its twiddles there: 32-bit shared addresses, where reading
// two device tables through a per-stage choice of pointer took generic
// loads and spilled (a first version, on the card).  The flat kernel reads
// its N-word table through L1 instead; the two side by side answer
// whether twiddle loads hold a register pass back (PERF.md).
//
// Registers, each choice checked on an H100 (PERF.md): the 64-register cap
// of ntt.cu, with three changes to how a pass runs (policy traits in
// ntt_pass.cuh, the flat kernel unchanged): the loop over logical threads
// has a compile-time trip count, since a loop the compiler could not bound
// kept every stage's table offsets live across the pass; the four sets of
// pass 2 run two at a time (one at a time was slower, four spilled); and
// the twist reads corr in chunks of 8 words with a __syncwarp() after each,
// because ptxas otherwise issues all 32 loads ahead of their products.
// Unchunked, or in chunks of 16, some instantiations spilled a few words;
// with chunks of 8 none does, and the twist's latency shows (PERF.md).
//
// Shared memory and conflicts: the row is ntt.cu's (element e at slot
// e + e/32, 33,788 bytes at N = 8192), its exchanges conflict-free at
// every split since the split moves no element; the tables follow it,
// psi1[j] at slot(j) and psi2[j] at slot(p2 + j), p2 = n1 rounded up to
// 32 (1,184 bytes at 32x256).  Per warp instruction at N = 8192, every
// split: psi1 and psi2 reads are one word (pass 0) or at most four
// distinct words in distinct banks (pass 1: one a 256-element segment,
// 2^sh apart, sh < 5), so broadcasts; in pass 2 the lanes read
// (lane << sh) + g masked to m2 words, stride 1, 2 or 4, which the pad
// word after every 32 spreads over distinct banks (conflict-free; 2- and
// 4-way without it).  corr is read from device memory (L2), as x is in
// the same pass: 32 consecutive words (pass 0, 32x256) or four runs of 8
// (pass 1, 64x128 and 128x64) per instruction.
//
// Bound: device memory, as for the flat kernel: each row is read once and
// written once (8 bytes an element, 0.443 ms at [11328, 2, 8192] on the
// H100's 3.35 TB/s); corr adds 4N bytes a limb, and its reads, one a
// element, come from L2.  The twist adds one Montgomery product an element
// to the flat kernel's N/2 log2 N butterflies.  Registers: 64 at most
// (__launch_bounds__(256, 4)), every register index compile-time.
//
// Built with a host compiler (the CPU test of this source), the block
// bodies run as one thread a block (ntt_pass.cuh).
#include "ntt_pass.cuh"

// The block's dynamic shared memory, read by word offset so that every
// table read is a shared-memory load (a pointer kept in the policy was
// read through generic loads).
#if defined(__CUDACC__)
extern __shared__ uint32_t ntt4_smem[];
#else
static uint32_t* ntt4_smem;   // the host build's block buffer
#endif

namespace {

// The block's twiddle tables in shared memory, after the row: psi1[j] at
// slot(j), psi2[j] at slot(p2 + j) with p2 = n1 rounded up to 32 words, so
// the padding of slot() falls alike in both.
NTT_HD constexpr int psi2_base(int log_n1) {
  return ((1 << log_n1) + 31) & ~31;
}

NTT_HD constexpr int table_words(int log_n, int log_n1) {
  return slot(psi2_base(log_n1) + (1 << (log_n - log_n1)) - 1) + 1;
}

// The 4-step's twiddles of one limb: psi1 and psi2 from the block's shared
// copy (after the kLogN row), corr [L, N] from device memory.  It keeps
// only log2 n1 and the limb: the column test, the twist's position and the
// corr row are compares with compile-time constants or computed where
// used, so that nothing more stays live across the passes (64 registers).
template <bool kInv, int kLogN>
struct Ntt4Twiddles {
  static constexpr bool kTwist = true;
  // a loop the compiler cannot bound kept each stage's table offsets live
  // across the pass, and four sets of a pass at once left no registers
  // for the twist's state: both spilled
  static constexpr bool kStaticStride = true;
  static constexpr int kSetBatch = 2;
  static constexpr int kTable = smem_words(kLogN);
  // groups i0 + g of one set: the set's first table slot once, then g as
  // an offset (the set's kG words never cross a pad word: they start at
  // a multiple of kG <= 16 within a 32-word block)
  struct Set {
    int base, gmask;
    NTT_MEMBER uint32_t operator()(int g) const {
      return ntt4_smem[base + (g & gmask)];
    }
  };
  struct Stage {
    int off, mask, gmask;
    NTT_MEMBER Set set(int i0) const {
      return {kTable + slot(off + (i0 & mask)), gmask};
    }
  };
  const uint32_t* __restrict__ corr;
  int limb, log_n1;
  // column stage (bit >= log2 n2 = kLogN - log2 n1): psi1[m + i],
  // i < m < n1; row stage: psi2[m2 + (i mod m2)], m2 = m / n1, which for
  // m2 < kG wraps within the set's groups
  template <int kM, int kG>
  NTT_MEMBER Stage stage(int bit) const {
    if (log_n1 >= kLogN - bit) return {kM, -1, kG - 1};
    const int m2 = kM >> log_n1;
    return {psi2_base(log_n1) + m2, m2 - 1, (m2 < kG ? m2 : kG) - 1};
  }
  // forward: after the last column stage, bit log2 n2; inverse: after the
  // last row stage, bit log2 n2 - 1
  NTT_MEMBER bool twists_after(int bit) const {
    return log_n1 == kLogN - (kInv ? 1 : 0) - bit;
  }
  NTT_MEMBER const uint32_t* corr_row() const {
    return corr + ((size_t)limb << kLogN);
  }
};

// One block's (row, limb) pair: s is the block's shared memory
// (smem_words(kLogN) words of row, then table_words(kLogN, log_n1) of
// twiddles), n_inv null for the forward transform.
template <bool kInv, int kLogN>
NTT_DEV void ntt4_block(uint32_t* s, uint32_t* out, const uint32_t* x,
                        const uint32_t* psi1, const uint32_t* psi2,
                        const uint32_t* corr, const uint32_t* qs,
                        const uint32_t* qinv, const uint32_t* n_inv,
                        int n_limbs, int log_n1) {
#if !defined(__CUDACC__)
  ntt4_smem = s;
#endif
  using Tw = Ntt4Twiddles<kInv, kLogN>;
  const int limb = (int)(blockIdx.x % (unsigned)n_limbs);
  const size_t row = (size_t)blockIdx.x << kLogN;
  const int log_n2 = kLogN - log_n1;
  const int n1 = 1 << log_n1, n2 = 1 << log_n2;
  psi1 += limb << log_n1;
  psi2 += limb << log_n2;
  for (int j = threadIdx.x; j < n1 + n2; j += blockDim.x)
    ntt4_smem[Tw::kTable + slot(j < n1 ? j : psi2_base(log_n1) + j - n1)] =
        j < n1 ? psi1[j] : psi2[j - n1];
  __syncthreads();
  const Tw tw{corr, limb, log_n1};
  ntt_row<kInv, kLogN>(s, out + row, x + row, tw, qs[limb], qinv[limb],
                       kInv ? n_inv[limb] : 0);
}

bool bad_args(long long rows, int n_limbs, int log_n, int log_n1) {
  return rows <= 0 || n_limbs < 1 || log_n < 2 || log_n > kMaxLogN ||
         log_n1 < 1 || log_n1 > log_n - 1;
}

}  // namespace

// Applies X to every supported log2 N (n1, n2 >= 2).
#define NTT4_FOR_EACH_LOG_N(X) \
  X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14)

#if defined(__CUDACC__)

namespace {

template <int kLogN>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    ntt4_fwd_kernel(uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ x,
                    const uint32_t* __restrict__ psi1,
                    const uint32_t* __restrict__ psi2,
                    const uint32_t* __restrict__ corr,
                    const uint32_t* __restrict__ qs,
                    const uint32_t* __restrict__ qinv, int n_limbs,
                    int log_n1) {
  ntt4_block<false, kLogN>(ntt4_smem, out, x, psi1, psi2, corr, qs, qinv,
                           nullptr, n_limbs, log_n1);
}

template <int kLogN>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    ntt4_inv_kernel(uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ x,
                    const uint32_t* __restrict__ psi1_inv,
                    const uint32_t* __restrict__ psi2_inv,
                    const uint32_t* __restrict__ corr_inv,
                    const uint32_t* __restrict__ qs,
                    const uint32_t* __restrict__ qinv,
                    const uint32_t* __restrict__ n_inv, int n_limbs,
                    int log_n1) {
  ntt4_block<true, kLogN>(ntt4_smem, out, x, psi1_inv, psi2_inv, corr_inv,
                          qs, qinv, n_inv, n_limbs, log_n1);
}

}  // namespace

// rows = B * L; x and out are contiguous u32[B, L, N] with N = 2^log_n and
// n1 = 2^log_n1; psi1 u32[L, n1], psi2 u32[L, n2], corr u32[L, N].
extern "C" int ntt4_fwd_launch(uint32_t* out, const uint32_t* x,
                               const uint32_t* psi1, const uint32_t* psi2,
                               const uint32_t* corr, const uint32_t* qs,
                               const uint32_t* qinv, long long rows,
                               int n_limbs, int log_n, int log_n1,
                               void* stream) {
  if (bad_args(rows, n_limbs, log_n, log_n1))
    return (int)cudaErrorInvalidValue;
  switch (log_n) {
#define NTT4_FWD_CASE(L)                                                   \
  case L:                                                                  \
    return (int)launch_rows(ntt4_fwd_kernel<L>, rows, log_n,             \
                            smem_words(log_n) + table_words(log_n, log_n1), \
                            stream, out, x, psi1, psi2, corr, qs, qinv,    \
                            n_limbs, log_n1);
    NTT4_FOR_EACH_LOG_N(NTT4_FWD_CASE)
#undef NTT4_FWD_CASE
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int ntt4_inv_launch(uint32_t* out, const uint32_t* x,
                               const uint32_t* psi1_inv,
                               const uint32_t* psi2_inv,
                               const uint32_t* corr_inv, const uint32_t* qs,
                               const uint32_t* qinv, const uint32_t* n_inv,
                               long long rows, int n_limbs, int log_n,
                               int log_n1, void* stream) {
  if (bad_args(rows, n_limbs, log_n, log_n1))
    return (int)cudaErrorInvalidValue;
  switch (log_n) {
#define NTT4_INV_CASE(L)                                                   \
  case L:                                                                  \
    return (int)launch_rows(ntt4_inv_kernel<L>, rows, log_n,             \
                            smem_words(log_n) + table_words(log_n, log_n1), \
                            stream, out, x, psi1_inv, psi2_inv, corr_inv,  \
                            qs, qinv, n_inv, n_limbs, log_n1);
    NTT4_FOR_EACH_LOG_N(NTT4_INV_CASE)
#undef NTT4_INV_CASE
  }
  return (int)cudaErrorInvalidValue;
}

#else  // the host build: one block at a time, for the CPU test

// Block blockIdx.x of a launch at log2 N = log_n; s holds smem_words(log_n)
// + table_words(log_n, log_n1) words.  Returns false for an unsupported
// log_n.
static bool ntt4_host_block(bool inverse, int log_n, uint32_t* s,
                            uint32_t* out, const uint32_t* x,
                            const uint32_t* psi1, const uint32_t* psi2,
                            const uint32_t* corr, const uint32_t* qs,
                            const uint32_t* qinv, const uint32_t* n_inv,
                            int n_limbs, int log_n1) {
  switch (log_n) {
#define NTT4_HOST_CASE(L)                                                  \
  case L:                                                                  \
    if (inverse)                                                           \
      ntt4_block<true, L>(s, out, x, psi1, psi2, corr, qs, qinv, n_inv,    \
                          n_limbs, log_n1);                                \
    else                                                                   \
      ntt4_block<false, L>(s, out, x, psi1, psi2, corr, qs, qinv, nullptr, \
                           n_limbs, log_n1);                               \
    return true;
    NTT4_FOR_EACH_LOG_N(NTT4_HOST_CASE)
#undef NTT4_HOST_CASE
  }
  return false;
}

#endif  // __CUDACC__
