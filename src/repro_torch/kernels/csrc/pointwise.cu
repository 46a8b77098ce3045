// Fused x (*) y_mont + z mod q_l for Hopper (sm_90a), all RNS limbs in one
// launch.
//
// Replaces: src/repro/kernels/pointwise.py `_mul_add_body` / `mul_add_fused`
// (encrypt's c0/c1 and decrypt's phase).
//
// Layout: one thread per output element of a contiguous u32[B, L, N]; the
// element's limb is (idx / N) % L.  Each operand comes with its own batch and
// limb strides (the last axis is unit-stride), so the broadcast operands
// never exist in memory: the public key (or the secret key) is one u32[L, N]
// table read with batch stride 0, and decrypt reads c0 and c1 straight out
// of the interleaved ciphertext u32[B, L, 2, N] with batch stride 2LN.
//
// Bound: device memory.  Per element: x and z read once, out written once
// (12 bytes), against one 64-bit Montgomery product and a modular add.  The
// broadcast operand is 4LN bytes in all and stays in L2.  The design does
// the one pass that the bytes require and nothing else; wider loads (4
// elements a thread) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mont.cuh"

namespace {

struct Operand {
  const uint32_t* p;
  long long batch_stride;
  long long limb_stride;
};

__global__ void mul_add_kernel(uint32_t* __restrict__ out, Operand x,
                               Operand y, Operand z,
                               const uint32_t* __restrict__ qs,
                               const uint32_t* __restrict__ qinv,
                               long long total, int n_limbs, int log_n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += step) {
    const long long col = idx & ((1LL << log_n) - 1);
    const unsigned row = (unsigned)(idx >> log_n);  // b * L + l
    const unsigned limb = row % (unsigned)n_limbs;
    const long long b = row / (unsigned)n_limbs;
    const uint32_t q = qs[limb];
    const uint32_t xv = x.p[b * x.batch_stride + limb * x.limb_stride + col];
    const uint32_t yv = y.p[b * y.batch_stride + limb * y.limb_stride + col];
    const uint32_t zv = z.p[b * z.batch_stride + limb * z.limb_stride + col];
    out[idx] = mod_add(mont_mul(xv, yv, q, qinv[limb]), zv, q);
  }
}

}  // namespace

// out: contiguous u32[B, L, N], total = B*L*N, N = 2^log_n.  Each operand is
// a pointer with its batch and limb strides in elements (0 = broadcast).
extern "C" int mul_add_launch(uint32_t* out, const uint32_t* x, long long xsb,
                              long long xsl, const uint32_t* y, long long ysb,
                              long long ysl, const uint32_t* z, long long zsb,
                              long long zsl, const uint32_t* qs,
                              const uint32_t* qinv, long long total,
                              int n_limbs, int log_n, void* stream) {
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  mul_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      out, Operand{x, xsb, xsl}, Operand{y, ysb, ysl}, Operand{z, zsb, zsl},
      qs, qinv, total, n_limbs, log_n);
  return (int)cudaGetLastError();
}
