// Encrypted FedAvg kernels for Hopper (sm_90a), all RNS limbs in one launch:
//
// weighted_sum: sum_c w_c (*) ct_c mod q_l over the client axis.
//   Replaces src/repro/kernels/he_agg.py `_agg_body` /
//   `he_weighted_sum_fused` (the server's in-memory aggregation).
// weighted_accum: acc + w (*) ct mod q_l with one weight per limb, acc
//   broadcast to ct's shape.  Replaces src/repro/kernels/he_agg.py
//   `_accum_body` / `he_weighted_accum_fused` (the sharded engine's
//   streaming fold, ShardedHe.weighted_accum).
// weighted_accum_chunks: acc[k] + w[k] (*) ct[k] mod q_l for every row k.
//   Replaces src/repro/kernels/he_agg.py `_accum_chunks_body` /
//   `he_weighted_accum_chunks_fused` (the streaming ingest's flush).
//
// Layout: cts is a contiguous u32[C, E] stack of C client tensors of E
// elements each; out is u32[E].  The element's limb is
// (idx >> log_inner) % L, where inner is the number of elements per limb
// step: N for the ops layout [..., L, N], 2N for ciphertexts [..., L, 2, N].
// So the kernel reads ciphertexts in their own layout and no relayout copy
// of the limb axis is ever made.  w is u32[C, L] Montgomery weights.
//
// Bound: device memory.  One thread per output element loops over the C
// clients, reading each ciphertext element once and writing the sum once:
// (C + 1) * 4 bytes per element against C Montgomery products.  Modular sums
// are exact, so the client order changes no bit.
//
// weighted_accum_chunks reads acc and ct and writes out (12 bytes per
// element against one Montgomery product), so it is bound by device memory
// too.  One thread per element, grid-stride; the row is
// (idx >> log_inner) / row_steps and the limb (idx >> log_inner) % L, so it
// reads the ciphertext layout [K, L, 2, N] (or the ops layout
// [K, ..., L, N]) in place.  out may alias acc: each element is read and
// written by the same thread, which is how the ingest updates its dense
// accumulator in place.
//
// weighted_accum is the same elementwise fold with one u32[L] weight, bound
// by device memory the same way (12 bytes per element with a full acc, 8
// with a broadcast one).  Its acc broadcasts to ct's shape the way JAX's broadcast_to does: acc's
// elements are ct's trailing acc_elems elements, repeated reps times.  The
// grid's x axis covers the acc elements, one a thread, and its y axis the
// repeats, so acc is indexed without a division and a broadcast acc is
// never materialised: a full acc has reps = 1, a one-row acc [L, 2, N]
// against ct [B, L, 2, N] has reps = B and is read once a thread.  out may
// alias a full acc (a fold in place).  No grid-stride loop over acc: a
// version with one (nested in the repeats' loop) needed 48 registers and ran
// slower (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mont.cuh"

namespace {

__global__ void weighted_sum_kernel(uint32_t* __restrict__ out,
                                    const uint32_t* __restrict__ cts,
                                    const uint32_t* __restrict__ w,
                                    const uint32_t* __restrict__ qs,
                                    const uint32_t* __restrict__ qinv,
                                    long long per_client, int n_clients,
                                    int n_limbs, int log_inner) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < per_client; idx += step) {
    const unsigned limb =
        (unsigned)(idx >> log_inner) % (unsigned)n_limbs;
    const uint32_t q = qs[limb];
    const uint32_t qi = qinv[limb];
    uint32_t acc = mont_mul(cts[idx], w[limb], q, qi);
    for (int c = 1; c < n_clients; ++c)
      acc = mod_add(acc,
                    mont_mul(cts[c * per_client + idx], w[c * n_limbs + limb],
                             q, qi),
                    q);
    out[idx] = acc;
  }
}

// out[idx] = acc[idx] + w[row, limb] (*) ct[idx]; out may alias acc, so
// neither carries __restrict__.
__global__ void weighted_accum_chunks_kernel(
    uint32_t* out, const uint32_t* acc, const uint32_t* __restrict__ ct,
    const uint32_t* __restrict__ w, const uint32_t* __restrict__ qs,
    const uint32_t* __restrict__ qinv, long long total, int n_limbs,
    int log_inner, int row_steps) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += step) {
    const unsigned r = (unsigned)(idx >> log_inner);
    const unsigned limb = r % (unsigned)n_limbs;
    const unsigned row = r / (unsigned)row_steps;
    const uint32_t q = qs[limb];
    out[idx] = mod_add(acc[idx],
                       mont_mul(ct[idx], w[row * n_limbs + limb], q,
                                qinv[limb]),
                       q);
  }
}

// out[r * acc_elems + j] = acc[j] + w[limb] (*) ct[r * acc_elems + j]: one
// acc element a thread (acc_elems < 2^32), loaded once for all its repeats.
// out may alias acc (reps = 1), so neither carries __restrict__.
__global__ void weighted_accum_kernel(
    uint32_t* out, const uint32_t* acc, const uint32_t* __restrict__ ct,
    const uint32_t* __restrict__ w, const uint32_t* __restrict__ qs,
    const uint32_t* __restrict__ qinv, long long acc_elems, long long reps,
    int n_limbs, int log_inner) {
  const unsigned j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= acc_elems) return;
  const uint32_t a = acc[j];
  for (long long r = blockIdx.y; r < reps; r += gridDim.y) {
    const long long idx = r * acc_elems + j;
    const unsigned limb = (unsigned)(idx >> log_inner) % (unsigned)n_limbs;
    const uint32_t q = qs[limb];
    out[idx] = mod_add(a, mont_mul(ct[idx], w[limb], q, qinv[limb]), q);
  }
}

}  // namespace

// cts: contiguous u32[C, per_client]; w: contiguous u32[C, L]; out:
// u32[per_client].  limb = (idx >> log_inner) % L.
extern "C" int weighted_sum_launch(uint32_t* out, const uint32_t* cts,
                                   const uint32_t* w, const uint32_t* qs,
                                   const uint32_t* qinv, long long per_client,
                                   int n_clients, int n_limbs, int log_inner,
                                   void* stream) {
  const int threads = 256;
  long long blocks = (per_client + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  weighted_sum_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(out, cts, w, qs, qinv,
                                                per_client, n_clients, n_limbs,
                                                log_inner);
  return (int)cudaGetLastError();
}

// acc, ct, out: contiguous u32[total] views of [K, ...] rows; w: contiguous
// u32[K, L].  row_steps = limb steps (runs of 2^log_inner elements) per row;
// limb = (idx >> log_inner) % L.
extern "C" int weighted_accum_chunks_launch(uint32_t* out, const uint32_t* acc,
                                            const uint32_t* ct,
                                            const uint32_t* w,
                                            const uint32_t* qs,
                                            const uint32_t* qinv,
                                            long long total, int n_limbs,
                                            int log_inner, int row_steps,
                                            void* stream) {
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  weighted_accum_chunks_kernel<<<(unsigned)blocks, threads, 0,
                                 (cudaStream_t)stream>>>(
      out, acc, ct, w, qs, qinv, total, n_limbs, log_inner, row_steps);
  return (int)cudaGetLastError();
}

// ct, out: contiguous u32[reps * acc_elems]; acc: contiguous u32[acc_elems]
// with acc_elems < 2^32; w: u32[L].  limb = (idx >> log_inner) % L.
extern "C" int weighted_accum_launch(uint32_t* out, const uint32_t* acc,
                                     const uint32_t* ct, const uint32_t* w,
                                     const uint32_t* qs, const uint32_t* qinv,
                                     long long acc_elems, long long reps,
                                     int n_limbs, int log_inner,
                                     void* stream) {
  const int threads = 256;
  const long long bx = (acc_elems + threads - 1) / threads;
  const long long by = reps < 65535 ? reps : 65535;
  weighted_accum_kernel<<<dim3((unsigned)bx, (unsigned)by), threads, 0,
                          (cudaStream_t)stream>>>(
      out, acc, ct, w, qs, qinv, acc_elems, reps, n_limbs, log_inner);
  return (int)cudaGetLastError();
}
