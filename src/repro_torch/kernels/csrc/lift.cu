// Per-limb modular lift of full-range u32 words for Hopper (sm_90a):
//
//   out[b, l, n] = x[b, n] mod q_l
//
// Replaces src/repro/kernels/lift.py `_mod_lift_body` / `mod_lift_fused`,
// the first step of the transcipher server's unmask: masked coefficients
// arrive as full-range u32 words with no limb axis and become per-limb
// residues for the forward NTT.
//
// Layout: x is a contiguous u32[B, N], out a contiguous u32[B, L, N], N a
// power of two >= 4.  One thread reads one 16-byte vector of 4 words once
// and writes its 4 residues for every limb, each as one 16-byte store;
// neighbouring threads take neighbouring vectors, so every load and store of
// a warp is one coalesced 512-byte run.  The Pallas grid (L, B / block)
// re-reads its input tile once per limb; this kernel reads it once.
//
// Bound: device memory.  Per word: 4 bytes read and 4L written.  The L
// remainders are exact u32 % u32 (the compiler's division sequence, about
// 20 integer instructions each), which at L = 2 stays under the time the
// bytes take.  No Montgomery arithmetic is needed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void mod_lift_kernel(uint4* __restrict__ out,
                                const uint4* __restrict__ x,
                                const uint32_t* __restrict__ qs,
                                long long groups, int n_limbs, int log_g) {
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long col_mask = (1LL << log_g) - 1;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += step) {
    const uint4 v = x[g];
    const long long row = g >> log_g;
    uint4* o = out + ((row * n_limbs) << log_g) + (g & col_mask);
    for (int l = 0; l < n_limbs; ++l) {
      const uint32_t q = qs[l];
      o[(long long)l << log_g] =
          make_uint4(v.x % q, v.y % q, v.z % q, v.w % q);
    }
  }
}

}  // namespace

// out: u32[rows, L, 2^log_n]; x: u32[rows, 2^log_n]; both contiguous and
// 16-byte aligned, log_n >= 2.  qs: u32[L].
extern "C" int mod_lift_launch(uint32_t* out, const uint32_t* x,
                               const uint32_t* qs, long long rows,
                               int n_limbs, int log_n, void* stream) {
  const int log_g = log_n - 2;  // 4-word vectors per row, as a power of two
  const long long groups = rows << log_g;
  const int threads = 256;
  long long blocks = (groups + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  mod_lift_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<uint4*>(out), reinterpret_cast<const uint4*>(x), qs,
      groups, n_limbs, log_g);
  return (int)cudaGetLastError();
}
