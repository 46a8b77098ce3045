// Mamba-2's chunked SSD scan (state-space duality, arXiv:2405.21060 §6),
// forward and backward, for Hopper (sm_90a), every product and sum in
// float32 FFMA:
//
//   forward:  x[B,S,H,P], dt[B,S,H], a[H], B[B,S,N], C[B,S,N], h0[B,H,P,N]
//             -> y[B,S,H,P], h_final[B,H,P,N]
//   backward: dy, dh_final -> dx, ddt, da, dB, dC, dh0
//
// the function of models/mamba2.py `ssd_chunked_plain` (one group: B and C
// are shared by the H heads), chunks of Q <= 256 steps, (P, N) one of
// (64, 128), (64, 64), (16, 16), decays at most 1 (a <= 0, dt >= 0, as
// Mamba-2's a = -exp(A_log) and softplus dt are).
//
// Replaces no TPU kernel: the JAX package computes the SSD with einsums
// under XLA (src/repro/models/mamba2.py `ssd_chunked`).  Added because the
// port's plain version builds its decays and intra-chunk products as
// [B, n, Q, Q, H] float32 tensors (1.07 GB each a layer at 16 x 2,048
// tokens), permutes them for its einsums and keeps them for autograd: at
// that size it moved about 3.5 TB a training step and ran most of the
// model's time.
//
// Bound: float32 FFMA.  Per (batch, chunk, head) the forward needs
// Q P N products for the chunk state, Q N P for the inter-chunk output and
// Q (Q + 1) / 2 P for the causal intra-chunk output, and per (batch, chunk)
// Q (Q + 1) / 2 N for C B^T; the backward about twice that.  Its bytes (x,
// B, C, dt, y and the chunk states, 134 MB a layer at that size) are a few
// hundred MB a layer, so the 67 TFLOP/s of the FFMA pipes, not the 3.35 TB/s
// of device memory, set the least time.  The design keeps every Q x Q
// intermediate in registers or shared memory:
//
//   state   one block per (chunk, head, batch): the chunk's cumulative
//           dt a by a block scan (written, [B,H,n,Q], 4 MB), then
//           S = sum_s exp(cum_end - cum_s) dt_s x_s (x) B_s as a [P x N]
//           tile product over 64-step slices.  The backward runs the same
//           body for G = sum_q exp(cum_q) dy_q (x) C_q.
//   pass    the recurrence H_c = exp(cum_end,c) H_{c-1} + S_c over the
//           chunks, one element a thread, 8 chunks' loads at once, in
//           place: the buffer then holds the state before each chunk (kept
//           for the backward).  The backward runs it in reverse, leaving
//           dH_{c+1} in G's place, with per-block partial sums of
//           dH_{c+1} . H_c.
//   cb      C B^T of each chunk, [B,n,Q,Q] (rows padded to 16 bytes), the
//           causal 64 x 64 tiles only:
//           the one Q x Q tensor written, once a call (268 MB at that size).
//   scan    one block per (64-row tile of the chunk, chunk, batch and head
//           group): per head y = exp(cum_q) C H^T + (CB o exp(cum_q -
//           cum_s) o causal) (dt x), the tiles above the diagonal skipped.
//           CB's tiles below the diagonal are read once a block; their
//           decay splits into exp(cum_q - cum_q0) on the rows of the sum
//           and exp(cum_q0 - cum_s) dt_s on the rows of x, so a head's
//           products read them as they are.
//   bwd_s   per 64-row tile of source steps s and all heads: dx, dB and the
//           d cum sums of the state decay and of the intra products'
//           columns; the heads' dCB = sum_h dM o L is summed in shared
//           memory.
//   bwd_q   per 64-row tile of target steps q and all heads: dC and the
//           d cum sums of the inter products and of the intra rows.
//   fin     d cum -> d(dt a) -> ddt, and da's partials, summed in a last
//           pass (da).
//
// What the time goes to, and what the design does about it:
//   - products: the tile products and their shared-memory reads hold about
//     55 % of scan, bwd_s and bwd_q and 70 % of state (at 16 x 2,048
//     tokens on an H100, against a build with them taken out).  They stay
//     FFMA: 3xTF32 mma.sync with the tiles' layout kept (a warp forms its
//     8 rows as C^T in m16n8k8 products and hands them to their threads
//     through shared memory) ran 1.4-1.5x slower in every kernel, at 1.3-2x
//     FFMA's distance from float64.  The tensor cores would need tiles laid
//     out for their fragments, the sums after the products too;
//   - loads: a thread moves 16-byte chunks and holds the next tile's in
//     registers (Fetch) while the block multiplies the present one;
//   - exponentials: a tile below the diagonal takes exp(cum_q - cum_s) as
//     exp(cum_q - cum_q0) exp(cum_q0 - cum_s), 128 exponentials for 4,096
//     (both factors at most 1 where the decays are);
//   - syncs and tails: a head's sums share one reduction phase, the scan's
//     heads are cut into groups until its grid holds MIN_BLOCKS blocks, and
//     the tiles with the most work launch first;
//   - the intra terms' d cum: d(dt a) at step r sums d cum over the steps
//     at and after r, and dseg's row sums (bwd_q) and column sums (bwd_s)
//     cancel where they share terms, so both kernels form each dM dt L the
//     same way, bit for bit; the state decay's part is summed forward over
//     the steps before r, where it does not cancel.
//
// No float atomics: every cross-block sum is a partial written by its block
// and summed in a fixed order by a later kernel, so a seed gives the same
// bits run to run.  A tile product: 256 threads, each holding rows
// t / TX + TY i and quads of 4 consecutive columns (Geo); the B operand is
// read as 16-byte quads from shared rows padded to 4 floats more than their
// width, the A operand as broadcasts.
//
// Under nvcc the bodies are __device__ functions behind __global__
// wrappers.  Under a host compiler they are plain functions, and
// ssd_fwd_host / ssd_bwd_host run each block's 256 threads as host threads
// between std::barrier waits, through the same bodies and the same launch
// sequence (the CPU test of this file).
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#define SSD_DEV __device__ __forceinline__
#define SSD_MEMBER __device__ __forceinline__
#define SSD_SYNC() __syncthreads()
typedef __nv_bfloat16 bf16_t;
#else
#include <barrier>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>
#define SSD_DEV static inline
#define SSD_MEMBER inline
namespace {
thread_local std::barrier<>* tl_block = nullptr;
}
#define SSD_SYNC() tl_block->arrive_and_wait()
struct bf16_t {
  uint16_t bits;
};
#endif

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;        // steps of a chunk a tile takes
constexpr int LDT = TILE + 4;   // row stride of a [.. x 64] tile
constexpr int MAX_Q = 256;      // the longest chunk: one step a thread
constexpr int MAX_QT = MAX_Q / TILE;
constexpr int MIN_BLOCKS = 16 * 132;  // the scan's grid: 16 blocks an H100 SM
constexpr int BATCH = 8;        // chunks a pass thread loads at once

#if defined(__CUDACC__)
typedef float4 f4;
typedef uint4 u4;
SSD_DEV f4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
template <class T>
SSD_DEV u4 ld16(const T* p) { return *reinterpret_cast<const uint4*>(p); }
SSD_DEV float f32_of(uint32_t u) { return __uint_as_float(u); }
SSD_DEV float to_f(float v) { return v; }
SSD_DEV float to_f(bf16_t v) { return __bfloat162float(v); }
template <class T> SSD_DEV T from_f(float v);
template <> SSD_DEV float from_f<float>(float v) { return v; }
template <> SSD_DEV bf16_t from_f<bf16_t>(float v) {
  return __float2bfloat16_rn(v);
}
SSD_DEV float ssd_exp(float v) { return expf(v); }
#else
struct f4 {
  float x, y, z, w;
};
struct u4 {
  uint32_t x, y, z, w;
};
SSD_DEV f4 ld4(const float* p) { return f4{p[0], p[1], p[2], p[3]}; }
template <class T>
SSD_DEV u4 ld16(const T* p) {
  u4 v;
  std::memcpy(&v, p, 16);
  return v;
}
SSD_DEV float f32_of(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
SSD_DEV float to_f(float v) { return v; }
SSD_DEV float to_f(bf16_t v) {
  uint32_t u = (uint32_t)v.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
template <class T> SSD_DEV T from_f(float v);
template <> inline float from_f<float>(float v) { return v; }
template <> inline bf16_t from_f<bf16_t>(float v) {
  // round to nearest even, as __float2bfloat16_rn and torch
  uint32_t u;
  std::memcpy(&u, &v, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return bf16_t{(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return bf16_t{(uint16_t)(u >> 16)};
}
SSD_DEV float ssd_exp(float v) { return std::exp(v); }
#endif

// a 16-byte chunk's values as float32: 4 float32, or 8 bfloat16 (a
// bfloat16 is the high half of its float32)
SSD_DEV void widen(const u4& v, float (&x)[4]) {
  x[0] = f32_of(v.x);
  x[1] = f32_of(v.y);
  x[2] = f32_of(v.z);
  x[3] = f32_of(v.w);
}
SSD_DEV void widen(const u4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = f32_of(w[i] << 16);
    x[2 * i + 1] = f32_of(w[i] & 0xffff0000u);
  }
}

// Everything a launch reads and writes.  Shapes: x, dy, y, dx [B,S,H,P];
// dt, ddt, ddtx [B,S,H]; a, da [H]; bm, cm, db, dc [B,S,N]; h0, dh0 f32 and
// hfin, dhf [B,H,P,N]; cum, dcq, dcs, ddv [B,H,n,Q]; hbuf, gbuf
// [B,n,H,P,N]; cb [B,n,Q,qp] (rows padded to 16 bytes); dapart
// [B,H,n,nblk]; dapart2 [H, B n].
template <class T> struct Args {
  int B, S, H, n, Q, qp, nqt, hg, hpb, nblk;  // qp: cb's row stride
  const T* x;
  const float* dt;
  const float* arate;
  const T* bm;
  const T* cm;
  const float* h0;
  const T* dy;
  const T* dhf;
  T* y;
  T* hfin;
  float* cum;
  float* hbuf;
  float* cb;
  float* gbuf;
  float* dapart;
  float* dcq;
  float* dcs;
  float* ddv;
  float* ddtx;
  float* dapart2;
  T* dx;
  float* ddt;
  float* da;
  T* db;
  T* dc;
  float* dh0;
};

// ---------------------------------------------------------------------------
// block-wide pieces
// ---------------------------------------------------------------------------

// A thread's share of an M x W tile (256 threads): TX threads across, each
// holding quads of 4 consecutive columns 4 TX apart, and rows t / TX + TY i.
// Where M < TY (a 16 x 16 state) the threads past row M idle.
template <int M, int W>
struct Geo {
  static constexpr int TX = W / 4 < 16 ? W / 4 : 16;
  static constexpr int TY = THREADS / TX;
  static constexpr int RM = M / TY > 0 ? M / TY : 1;
  static constexpr int RN = W / TX;
  static SSD_MEMBER int row(int t, int i) { return t / TX + TY * i; }
  static SSD_MEMBER int col(int t, int j) {
    return 4 * (t % TX) + 4 * TX * (j >> 2) + (j & 3);
  }
};

// acc[i][j] += sum_k fa(row i, k) fb(k, col j), k < K; fb gives the quad of
// 4 consecutive columns at (k, n) from a 16-byte aligned shared row
template <int M, int W, int K, class FA, class FB>
SSD_DEV void mma(float (&acc)[Geo<M, W>::RM][Geo<M, W>::RN], int t, FA fa,
                 FB fb) {
  using G = Geo<M, W>;
  const int tx = t % G::TX, ty = t / G::TX;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[G::RM];
#pragma unroll
    for (int i = 0; i < G::RM; ++i) {
      const int r = ty + G::TY * i;
      av[i] = fa(r < M ? r : M - 1, k);
    }
#pragma unroll
    for (int q = 0; q < G::RN / 4; ++q) {
      const f4 b = fb(k, 4 * tx + 4 * G::TX * q);
#pragma unroll
      for (int i = 0; i < G::RM; ++i) {
        acc[i][4 * q + 0] = fmaf(av[i], b.x, acc[i][4 * q + 0]);
        acc[i][4 * q + 1] = fmaf(av[i], b.y, acc[i][4 * q + 1]);
        acc[i][4 * q + 2] = fmaf(av[i], b.z, acc[i][4 * q + 2]);
        acc[i][4 * q + 3] = fmaf(av[i], b.w, acc[i][4 * q + 3]);
      }
    }
  }
}

template <int RM, int RN>
SSD_DEV void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
}

// A tile's global loads, held in registers: load() starts them and put()
// waits for them and stores the tile to shared memory (converted, scaled by
// scale(r), rows past `valid` zero; dst[r][c] at row stride COLS + 4, or
// transposed dst[c][r] at row stride ROWS + 4).  Started a phase ahead, the
// loads of the next tile run under the tile products of this one.  A thread
// loads 16-byte chunks (8 bfloat16 or 4 float32 of a row): the source's rows
// start on 16 bytes (the wrapper's check).
template <int ROWS, int COLS, class T>
struct Fetch {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int CPR = COLS / VEC;  // chunks a row
  static constexpr int CHUNKS = ROWS * CPR;
  static constexpr int PER = (CHUNKS + THREADS - 1) / THREADS;
  static_assert(CPR * VEC == COLS, "rows of whole chunks");
  u4 v[PER];
  int valid;

  SSD_MEMBER void load(const T* src, long long stride, int valid_, int t) {
    valid = valid_;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = t + k * THREADS, r = e / CPR, cc = e % CPR;
      if (CHUNKS % THREADS == 0 || e < CHUNKS)
        v[k] = ld16(src + (long long)(r < valid_ ? r : valid_ - 1) * stride +
                    cc * VEC);
    }
  }

  template <bool TRANSPOSE = false, class FS>
  SSD_MEMBER void put(float* dst, int t, FS scale,
                      float* dst_t = nullptr) const {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = t + k * THREADS, r = e / CPR, cc = e % CPR;
      if (CHUNKS % THREADS != 0 && e >= CHUNKS) continue;
      float x[VEC];
      widen(v[k], x);
      const float f = r < valid ? scale(r) : 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int c = cc * VEC + i;
        const float y = r < valid ? x[i] * f : 0.f;
        if (TRANSPOSE)
          dst[c * (ROWS + 4) + r] = y;
        else
          dst[r * (COLS + 4) + c] = y;
        if (dst_t) dst_t[c * (ROWS + 4) + r] = y;  // and transposed
      }
    }
  }
};

template <int ROWS, int COLS, bool TRANSPOSE = false, class T, class FS>
SSD_DEV void load_tile(float* dst, const T* src, long long stride, int valid,
                       int t, FS scale, float* dst_t = nullptr) {
  Fetch<ROWS, COLS, T> f;
  f.load(src, stride, valid, t);
  f.template put<TRANSPOSE>(dst, t, scale, dst_t);
}

template <int ROWS, int COLS, class T, class FS>
SSD_DEV void load_tile_t(float* dst, const T* src, long long stride,
                         int valid, int t, FS scale) {
  load_tile<ROWS, COLS, true>(dst, src, stride, valid, t, scale);
}

struct One {
  SSD_MEMBER float operator()(int) const { return 1.f; }
};

// sum over the block, the same order in every block
SSD_DEV float block_sum(float v, float* buf, int t) {
  buf[t] = v;
  SSD_SYNC();
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    if (t < off) buf[t] += buf[t + off];
    SSD_SYNC();
  }
  const float r = buf[0];
  SSD_SYNC();
  return r;
}

// inclusive prefix sum over the block's threads
SSD_DEV float block_scan(float v, float* buf, int t) {
  buf[t] = v;
  SSD_SYNC();
  for (int off = 1; off < THREADS; off <<= 1) {
    const float add = t >= off ? buf[t - off] : 0.f;
    SSD_SYNC();
    v += add;
    buf[t] = v;
    SSD_SYNC();
  }
  return v;
}

// Sums over a tile's threads, several in one phase: put_rows / put_cols
// leave each thread's partials in red (64 x 17 floats), and after a sync
// sum_of(red, r) is row (or column) r's sum, in a fixed order.
template <class G>
SSD_DEV void put_rows(const float (&part)[G::RM], float* red, int t) {
#pragma unroll
  for (int i = 0; i < G::RM; ++i) red[G::row(t, i) * 17 + t % G::TX] = part[i];
}

SSD_DEV void put_cols(const float (&part)[Geo<TILE, TILE>::RN], float* red,
                      int t) {
  using G = Geo<TILE, TILE>;
#pragma unroll
  for (int j = 0; j < G::RN; ++j) red[G::col(t, j) * 17 + t / G::TX] = part[j];
}

template <int COUNT>
SSD_DEV float sum_of(const float* red, int r) {
  float s = 0.f;
  for (int k = 0; k < COUNT; ++k) s += red[r * 17 + k];
  return s;
}

template <class T>
SSD_DEV long long row_x(const Args<T>& a, int b, int s, int h) {
  return (((long long)b * a.S + s) * a.H + h);
}

template <class T>
SSD_DEV long long row_cum(const Args<T>& a, int b, int h, int c) {
  return (((long long)b * a.H + h) * a.n + c) * a.Q;
}

template <class T>
SSD_DEV long long row_state(const Args<T>& a, int b, int c, int h, int pn) {
  return (((long long)b * a.n + c) * a.H + h) * pn;
}

// ---------------------------------------------------------------------------
// state: out[b,c,h] = sum_s w_s X[s] (x) Y[s] over the chunk's steps
// ---------------------------------------------------------------------------

template <int P, int N>
constexpr int state_smem() {
  return 2 * MAX_Q + TILE * (P + 4) + TILE * (N + 4);
}

// FWD: w_s = exp(cum_end - cum_s) dt_s, X = x, Y = B, out = hbuf; the chunk's
// cum is computed and written.  Else w_q = exp(cum_q), X = dy, Y = C,
// out = gbuf.
template <class T, int P, int N, bool FWD>
SSD_DEV void state_body(const Args<T>& a, float* sm, int c, int h, int b,
                        int t) {
  using G = Geo<P, N>;
  const int Q = a.Q;
  float* w = sm;
  float* buf = sm + MAX_Q;
  float* xs = sm + 2 * MAX_Q;          // [64 s][P+4]
  float* ys = xs + TILE * (P + 4);     // [64 s][N+4]
  const long long oc = row_cum(a, b, h, c);
  const T* X = (FWD ? a.x : a.dy) + row_x(a, b, c * Q, h) * P;
  const T* Y = (FWD ? a.bm : a.cm) + ((long long)b * a.S + c * Q) * N;
  const long long xstride = (long long)a.H * P;
  Fetch<TILE, P, T> fx;
  Fetch<TILE, N, T> fy;
  fx.load(X, xstride, Q < TILE ? Q : TILE, t);
  fy.load(Y, N, Q < TILE ? Q : TILE, t);
  if (FWD) {
    const float dt = t < Q ? a.dt[row_x(a, b, c * Q + t, h)] : 0.f;
    const float cum = block_scan(dt * a.arate[h], buf, t);
    if (t < Q) a.cum[oc + t] = cum;
    const float end = buf[Q - 1];
    w[t] = t < Q ? ssd_exp(end - cum) * dt : 0.f;
  } else {
    w[t] = t < Q ? ssd_exp(a.cum[oc + t]) : 0.f;
  }
  float* out = FWD ? a.hbuf : a.gbuf;
  float acc[G::RM][G::RN];
  zero(acc);
  for (int s0 = 0; s0 < Q; s0 += TILE) {
    SSD_SYNC();
    fx.put(xs, t, [&](int r) { return w[s0 + r]; });
    fy.put(ys, t, One());
    const int s1 = s0 + TILE;
    if (s1 < Q) {
      fx.load(X + s1 * xstride, xstride, Q - s1 < TILE ? Q - s1 : TILE, t);
      fy.load(Y + (long long)s1 * N, N, Q - s1 < TILE ? Q - s1 : TILE, t);
    }
    SSD_SYNC();
    mma<P, N, TILE>(acc, t, [&](int m, int k) { return xs[k * (P + 4) + m]; },
                    [&](int k, int n) { return ld4(&ys[k * (N + 4) + n]); });
  }
  float* o = out + row_state(a, b, c, h, P * N);
#pragma unroll
  for (int i = 0; i < G::RM; ++i) {
    const int p = G::row(t, i);
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < G::RN; ++j) o[p * N + G::col(t, j)] = acc[i][j];
  }
}

template <class T, int P, int N>
SSD_DEV void state_f_body(const Args<T>& a, float* sm, int x, int y, int z,
                          int t) {
  state_body<T, P, N, true>(a, sm, x, y, z, t);
}

template <class T, int P, int N>
SSD_DEV void state_g_body(const Args<T>& a, float* sm, int x, int y, int z,
                          int t) {
  state_body<T, P, N, false>(a, sm, x, y, z, t);
}

// ---------------------------------------------------------------------------
// pass: the recurrence over the chunks, one element of [P x N] a thread,
// BATCH chunks' loads in flight at once
// ---------------------------------------------------------------------------

// forward: hbuf[c] S_c -> H_c (the state before chunk c), h_final
template <class T, int P, int N>
SSD_DEV void pass_f_body(const Args<T>& a, float*, int blk, int bh, int,
                         int t) {
  const int b = bh / a.H, h = bh % a.H;
  const long long e = (long long)blk * THREADS + t;
  const long long he = ((long long)b * a.H + h) * P * N + e;
  float hv = a.h0 ? a.h0[he] : 0.f;
  for (int c0 = 0; c0 < a.n; c0 += BATCH) {
    float s[BATCH], decay[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (c0 + k >= a.n) break;
      s[k] = a.hbuf[row_state(a, b, c0 + k, h, P * N) + e];
      decay[k] = ssd_exp(a.cum[row_cum(a, b, h, c0 + k) + a.Q - 1]);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (c0 + k >= a.n) break;
      a.hbuf[row_state(a, b, c0 + k, h, P * N) + e] = hv;
      hv = decay[k] * hv + s[k];
    }
  }
  a.hfin[he] = from_f<T>(hv);
}

// backward: gbuf[c] G_c -> dH_{c+1} (the gradient of S_c), the partial
// sums of dH_{c+1} . H_c, dh0
template <class T, int P, int N>
SSD_DEV void pass_b_body(const Args<T>& a, float* sm, int blk, int bh, int,
                         int t) {
  const int b = bh / a.H, h = bh % a.H;
  const long long e = (long long)blk * THREADS + t;
  const long long he = ((long long)b * a.H + h) * P * N + e;
  float dh = a.dhf ? to_f(a.dhf[he]) : 0.f;
  for (int c1 = a.n - 1; c1 >= 0; c1 -= BATCH) {  // chunks c1, c1 - 1, ...
    float g[BATCH], hb[BATCH], decay[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (c1 - k < 0) break;
      const long long o = row_state(a, b, c1 - k, h, P * N) + e;
      g[k] = a.gbuf[o];
      hb[k] = a.hbuf[o];
      decay[k] = ssd_exp(a.cum[row_cum(a, b, h, c1 - k) + a.Q - 1]);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      float part = 0.f;
      if (c1 - k >= 0) {
        a.gbuf[row_state(a, b, c1 - k, h, P * N) + e] = dh;
        part = dh * hb[k];
        dh = decay[k] * dh + g[k];
      }
      sm[k * THREADS + t] = part;
    }
    SSD_SYNC();
    for (int off = THREADS / 2; off > 0; off >>= 1) {
      if (t < off) {
#pragma unroll
        for (int k = 0; k < BATCH; ++k)
          sm[k * THREADS + t] += sm[k * THREADS + t + off];
      }
      SSD_SYNC();
    }
    if (t < BATCH && c1 - t >= 0)
      a.dapart[(((long long)b * a.H + h) * a.n + c1 - t) * a.nblk + blk] =
          sm[t * THREADS];
    SSD_SYNC();
  }
  if (a.dh0) a.dh0[he] = dh;
}

// ---------------------------------------------------------------------------
// cb: C B^T of each chunk, the causal 64 x 64 tiles
// ---------------------------------------------------------------------------

template <int P, int N>
constexpr int cb_smem() {
  return TILE * (N + 4) + N * LDT;
}

template <class T, int P, int N>
SSD_DEV void cb_body(const Args<T>& a, float* sm, int ij, int c, int b,
                     int t) {
  using G = Geo<TILE, TILE>;
  const int i = ij / a.nqt, j = ij % a.nqt;
  if (j > i) return;  // above the diagonal: never read
  const int Q = a.Q, q0 = i * TILE, s0 = j * TILE;
  float* cs = sm;                   // [64 q][N+4]
  float* bst = sm + TILE * (N + 4);  // [N][64 s + 4]
  const long long base = (long long)b * a.S + c * Q;
  load_tile<TILE, N>(cs, a.cm + (base + q0) * N, N,
                     Q - q0 < TILE ? Q - q0 : TILE, t, One());
  load_tile_t<TILE, N>(bst, a.bm + (base + s0) * N, N,
                       Q - s0 < TILE ? Q - s0 : TILE, t, One());
  SSD_SYNC();
  float acc[G::RM][G::RN];
  zero(acc);
  mma<TILE, TILE, N>(acc, t,
                     [&](int m, int k) { return cs[m * (N + 4) + k]; },
                     [&](int k, int n) { return ld4(&bst[k * LDT + n]); });
  float* o = a.cb + ((long long)b * a.n + c) * Q * a.qp;
#pragma unroll
  for (int ii = 0; ii < G::RM; ++ii)
#pragma unroll
    for (int jj = 0; jj < G::RN; ++jj) {
      const int q = q0 + G::row(t, ii), s = s0 + G::col(t, jj);
      if (q < Q && s < Q) o[(long long)q * a.qp + s] = acc[ii][jj];
    }
}

// ---------------------------------------------------------------------------
// scan: y of a 64-row tile of a chunk, for each head of the block's group
// ---------------------------------------------------------------------------

template <int P, int N>
constexpr int scan_smem() {
  return TILE * (N + 4) + N * (P + 4) + TILE * (P + 4) + MAX_QT * TILE * LDT +
         2 * MAX_Q + MAX_QT * TILE;
}

// exp(cum_q - cum_s) of a tile below the diagonal as exp(cum_q - cum_q0)
// exp(cum_q0 - cum_s), both at most 1 where the decays are (a <= 0,
// dt >= 0, as Mamba-2's): 128 exponentials for the tile's 4096
SSD_DEV void pivots(const float* cq, int q0, int s0, int Q, float* eq,
                    float* es, int t) {
  if (t < TILE)
    eq[t] = q0 + t < Q ? ssd_exp(cq[q0 + t] - cq[q0]) : 0.f;
  else if (t < 2 * TILE)
    es[t - TILE] = ssd_exp(cq[q0] - cq[s0 + t - TILE]);
}

// exp(cum_q - cum_s) on and below the diagonal, 0 above it and past Q
SSD_DEV float decay_of(const float* cq, const float* eq, const float* es,
                       bool pivoted, int qa, int sa, int q, int s, int Q) {
  if (pivoted) return qa < Q ? eq[q] * es[s] : 0.f;
  return sa <= qa && qa < Q ? ssd_exp(cq[qa] - cq[sa]) : 0.f;
}

template <class T, int P, int N>
SSD_DEV void scan_body(const Args<T>& a, float* sm, int c, int bg, int iz,
                       int t) {
  const int i = a.nqt - 1 - iz;  // the longest tiles (most sources) first
  using G = Geo<TILE, P>;
  const int b = bg / a.hg, g = bg % a.hg;
  const int Q = a.Q, q0 = i * TILE;
  const int qv = Q - q0 < TILE ? Q - q0 : TILE;
  const int h1 = (g + 1) * a.hpb < a.H ? (g + 1) * a.hpb : a.H;
  float* cs = sm;                        // [64 q][N+4] C of the tile's rows
  float* hst = cs + TILE * (N + 4);      // [N][P+4] H_c^T of the head
  float* xs = hst + N * (P + 4);         // [64 s][P+4] a source tile's x
  float* cbs = xs + TILE * (P + 4);      // [i][64 q][68 s] CB of the tiles
                                         // below the diagonal; then [64][68]
                                         // CB o L of the diagonal tile
  float* cq = cbs + MAX_QT * TILE * LDT;  // [MAX_Q] cum of the head
  float* dts = cq + MAX_Q;               // [MAX_Q] dt of the head
  float* piv = dts + MAX_Q;              // [64] exp(cum_q - cum_q0), then
                                         // [i][64] exp(cum_q0 - cum_s)
  float* ms = cbs + i * TILE * LDT;
  const long long base = (long long)b * a.S + c * Q;
  const float* cbc = a.cb + ((long long)b * a.n + c) * Q * a.qp;
  const long long xstride = (long long)a.H * P;
  auto x_tile = [&](int h, int s0) { return a.x + row_x(a, b, c * Q + s0, h) * P; };
  Fetch<TILE, P, T> fx;       // the next source tile's x
  load_tile<TILE, N>(cs, a.cm + (base + q0) * N, N, qv, t, One());
  for (int j = 0; j < i; ++j)  // below the diagonal: CB is the heads'
    load_tile<TILE, TILE>(cbs + j * TILE * LDT, cbc + (long long)q0 * a.qp +
                          j * TILE, a.qp, qv, t, One());
  for (int h = g * a.hpb; h < h1; ++h) {
    SSD_SYNC();
    cq[t] = t < Q ? a.cum[row_cum(a, b, h, c) + t] : 0.f;
    dts[t] = t < Q ? a.dt[row_x(a, b, c * Q + t, h)] : 0.f;
    fx.load(x_tile(h, 0), xstride, Q < TILE ? Q : TILE, t);
    SSD_SYNC();
    // exp(cum_q - cum_s) below the diagonal as piv[q] piv[64 + 64 j + s],
    // and exp(cum_q) as piv[q] exp(cum_q0): all at most 1
    if (t < TILE)
      piv[t] = q0 + t < Q ? ssd_exp(cq[q0 + t] - cq[q0]) : 0.f;
    else if (t < TILE * (i + 1))
      piv[t] = ssd_exp(cq[q0] - cq[t - TILE]);
    const float e0 = ssd_exp(cq[q0]);
    load_tile_t<P, N>(hst, a.hbuf + row_state(a, b, c, h, P * N), N, P, t,
                      [&](int) { return e0; });
    SSD_SYNC();
    float acc[G::RM][G::RN];
    zero(acc);
    // inter-chunk: exp(cum_q0) sum_t C[q,t] H[p,t]
    mma<TILE, P, N>(acc, t, [&](int m, int k) { return cs[m * (N + 4) + k]; },
                    [&](int k, int n) { return ld4(&hst[k * (P + 4) + n]); });
    // below the diagonal: sum_s CB[q,s] exp(cum_q0 - cum_s) dt_s x[s,p]
    for (int j = 0; j < i; ++j) {
      const int s0 = j * TILE;
      SSD_SYNC();
      fx.put(xs, t, [&](int r) { return piv[TILE + s0 + r] * dts[s0 + r]; });
      fx.load(x_tile(h, s0 + TILE), xstride,
               Q - s0 - TILE < TILE ? Q - s0 - TILE : TILE, t);
      SSD_SYNC();
      const float* cb = cbs + j * TILE * LDT;
      mma<TILE, P, TILE>(acc, t, [&](int m, int k) { return cb[m * LDT + k]; },
                         [&](int k, int n) { return ld4(&xs[k * (P + 4) + n]); });
    }
#pragma unroll
    for (int ii = 0; ii < G::RM; ++ii) {
      const float e = piv[G::row(t, ii)];
#pragma unroll
      for (int jj = 0; jj < G::RN; ++jj) acc[ii][jj] *= e;
    }
    // the diagonal tile: sum_{s <= q} CB[q,s] exp(cum_q - cum_s) dt_s x[s,p]
    SSD_SYNC();
    fx.put(xs, t, [&](int r) { return dts[q0 + r]; });
    {
      constexpr int PER = TILE * TILE / THREADS;
      float cbv[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int e = t + k * THREADS, qa = q0 + e / TILE, sa = q0 + e % TILE;
        cbv[k] = sa <= qa && qa < Q ? cbc[(long long)qa * a.qp + sa] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int e = t + k * THREADS, q = e / TILE, s = e % TILE;
        const int qa = q0 + q, sa = q0 + s;
        ms[q * LDT + s] =
            sa <= qa && qa < Q ? cbv[k] * ssd_exp(cq[qa] - cq[sa]) : 0.f;
      }
    }
    SSD_SYNC();
    mma<TILE, P, TILE>(acc, t, [&](int m, int k) { return ms[m * LDT + k]; },
                       [&](int k, int n) { return ld4(&xs[k * (P + 4) + n]); });
#pragma unroll
    for (int ii = 0; ii < G::RM; ++ii) {
      const int qa = q0 + G::row(t, ii);
      if (qa >= Q) continue;
      T* yo = a.y + row_x(a, b, c * Q + qa, h) * P;
#pragma unroll
      for (int jj = 0; jj < G::RN; ++jj)
        yo[G::col(t, jj)] = from_f<T>(acc[ii][jj]);
    }
  }
}

// ---------------------------------------------------------------------------
// bwd_s: per 64-row tile of source steps s
// ---------------------------------------------------------------------------

// rows of a buffer that holds a [P x N] state, then a [64 x N] tile
template <int P>
constexpr int WIDE = P > TILE ? P : TILE;

template <int P, int N>
constexpr int bwd_s_smem() {
  return TILE * (N + 4) + WIDE<P> * (N + 4) + N * (P + 4) +
         MAX_QT * TILE * LDT + P * LDT + TILE * (P + 4) + TILE * LDT +
         2 * MAX_Q + 2 * TILE;
}

template <class T, int P, int N>
SSD_DEV void bwd_s_body(const Args<T>& a, float* sm, int c, int bg, int j,
                        int t) {  // blockIdx.z = j: the longest tiles first
  using GP = Geo<TILE, P>;
  using GN = Geo<TILE, N>;
  using GT = Geo<TILE, TILE>;
  const int b = bg / a.hg, g = bg % a.hg;
  const int Q = a.Q, s0 = j * TILE;
  const int sv = Q - s0 < TILE ? Q - s0 : TILE;
  const int h1 = (g + 1) * a.hpb < a.H ? (g + 1) * a.hpb : a.H;
  float* bs = sm;                          // [64 s][N+4] B of the tile's rows
  float* st = bs + TILE * (N + 4);         // [max(P,64)][N+4] dS_h, then C
  float* stt = st + WIDE<P> * (N + 4);     // [N][P+4] dS_h^T
  float* dcb = stt + N * (P + 4);          // [nqt][64 q][68 s] sum_h dM o L
  float* xst = dcb + MAX_QT * TILE * LDT;  // [P][68 s] x^T of the tile
  float* dys = xst + P * LDT;              // [64 q][P+4] dy of a target tile
  float* ms = dys + TILE * (P + 4);        // [64 q][68 s] CB o L; then
                                           // 3 x [64][17] partial sums
  float* cq = ms + TILE * LDT;             // [MAX_Q]
  float* dts = cq + MAX_Q;                 // [MAX_Q]
  float* eq = dts + MAX_Q;                 // [64] exp(cum_q - cum_q0)
  float* es = eq + TILE;                   // [64] exp(cum_q0 - cum_s)
  const long long base = (long long)b * a.S + c * Q;
  const float* cbc = a.cb + ((long long)b * a.n + c) * Q * a.qp;
  const long long xstride = (long long)a.H * P;
  auto x_tile = [&](const T* x, int h, int r0) {
    return x + row_x(a, b, c * Q + r0, h) * P;
  };
  auto ds_tile = [&](int h) { return a.gbuf + row_state(a, b, c, h, P * N); };
  Fetch<P, N, float> fds;     // the next head's dS
  Fetch<TILE, P, T> fx;       // the next head's x of the tile
  Fetch<TILE, P, T> fdy;      // the next target tile's dy
  fds.load(ds_tile(g * a.hpb), N, P, t);
  fx.load(x_tile(a.x, g * a.hpb, s0), xstride, sv, t);
  load_tile<TILE, N>(bs, a.bm + (base + s0) * N, N, sv, t, One());
  for (int e = t; e < MAX_QT * TILE * LDT; e += THREADS) dcb[e] = 0.f;
  float accb[GN::RM][GN::RN];  // dB[s,t], summed over the heads
  zero(accb);
  for (int h = g * a.hpb; h < h1; ++h) {
    SSD_SYNC();
    const long long oc = row_cum(a, b, h, c);
    cq[t] = t < Q ? a.cum[oc + t] : 0.f;
    dts[t] = t < Q ? a.dt[row_x(a, b, c * Q + t, h)] : 0.f;
    fds.put(st, t, One(), stt);
    fx.template put<true>(xst, t, One());
    fdy.load(x_tile(a.dy, h, s0), xstride, sv, t);
    SSD_SYNC();
    // dec_s = exp(cum_end - cum_s), each thread for its own rows
    auto dec = [&](int s) {
      return s0 + s < Q ? ssd_exp(cq[Q - 1] - cq[s0 + s]) : 0.f;
    };
    // state part of dx dt: dec_s sum_t B[s,t] dS[p,t]
    float accx[GP::RM][GP::RN];
    zero(accx);
    mma<TILE, P, N>(accx, t, [&](int m, int k) { return bs[m * (N + 4) + k]; },
                    [&](int k, int n) { return ld4(&stt[k * (P + 4) + n]); });
    float pdd[GP::RM];  // dd_s = dt_s sum_p x[s,p] accx[s,p]
#pragma unroll
    for (int ii = 0; ii < GP::RM; ++ii) {
      const int s = GP::row(t, ii);
      const float d = dec(s);
      pdd[ii] = 0.f;
#pragma unroll
      for (int jj = 0; jj < GP::RN; ++jj) {
        accx[ii][jj] *= d;
        pdd[ii] += xst[GP::col(t, jj) * LDT + s] * accx[ii][jj];
      }
      pdd[ii] *= dts[s0 + s];
    }
    {  // state part of dB: dec_s dt_s sum_p x[s,p] dS[p,t]
      float tmp[GN::RM][GN::RN];
      zero(tmp);
      mma<TILE, N, P>(tmp, t, [&](int m, int k) { return xst[k * LDT + m]; },
                      [&](int k, int n) { return ld4(&st[k * (N + 4) + n]); });
#pragma unroll
      for (int ii = 0; ii < GN::RM; ++ii) {
        const float d = dec(GN::row(t, ii)) * dts[s0 + GN::row(t, ii)];
#pragma unroll
        for (int jj = 0; jj < GN::RN; ++jj) accb[ii][jj] += d * tmp[ii][jj];
      }
    }
    // intra part: over the target tiles i >= j
    float csum[GT::RN];  // columns s
#pragma unroll
    for (int jj = 0; jj < GT::RN; ++jj) csum[jj] = 0.f;
    for (int i = j; i < a.nqt; ++i) {
      const int q0 = i * TILE;
      SSD_SYNC();
      fdy.put(dys, t, One());
      if (i + 1 < a.nqt) {
        const int q1 = q0 + TILE;
        fdy.load(x_tile(a.dy, h, q1), xstride, Q - q1 < TILE ? Q - q1 : TILE,
                  t);
      } else if (h + 1 < h1) {
        fds.load(ds_tile(h + 1), N, P, t);
        fx.load(x_tile(a.x, h + 1, s0), xstride, sv, t);
      }
      if (i > j) pivots(cq, q0, s0, Q, eq, es, t);
      SSD_SYNC();
      float dm[GT::RM][GT::RN];  // dM[q,s] / dt_s = sum_p dy[q,p] x[s,p]
      zero(dm);
      mma<TILE, TILE, P>(dm, t,
                         [&](int m, int k) { return dys[m * (P + 4) + k]; },
                         [&](int k, int n) { return ld4(&xst[k * LDT + n]); });
#pragma unroll
      for (int ii = 0; ii < GT::RM; ++ii)
#pragma unroll
        for (int jj = 0; jj < GT::RN; ++jj) {
          const int q = GT::row(t, ii), s = GT::col(t, jj);
          const int qa = q0 + q, sa = s0 + s;
          const bool ok = sa <= qa && qa < Q;
          const float l = decay_of(cq, eq, es, i > j, qa, sa, q, s, Q);
          const float cbv = ok ? cbc[(long long)qa * a.qp + sa] : 0.f;
          const float dl = dm[ii][jj] * dts[sa] * l;  // as bwd_q forms it
          ms[q * LDT + s] = cbv * l;
          dcb[(i * TILE + q) * LDT + s] += dl;
          csum[jj] += dl * cbv;
        }
      SSD_SYNC();
      // dx dt[s,p] += sum_q M[q,s] dy[q,p]
      mma<TILE, P, TILE>(accx, t, [&](int m, int k) { return ms[k * LDT + m]; },
                         [&](int k, int n) { return ld4(&dys[k * (P + 4) + n]); });
    }
    // dx, and ddt's sum_p (dx dt)[s,p] x[s,p]
    float pdt[GP::RM];
#pragma unroll
    for (int ii = 0; ii < GP::RM; ++ii) {
      const int s = GP::row(t, ii), sa = s0 + s;
      pdt[ii] = 0.f;
      if (sa >= Q) continue;
      const long long r = row_x(a, b, c * Q + sa, h) * P;
#pragma unroll
      for (int jj = 0; jj < GP::RN; ++jj) {
        const int p = GP::col(t, jj);
        a.dx[r + p] = from_f<T>(accx[ii][jj] * dts[sa]);
        pdt[ii] += accx[ii][jj] * xst[p * LDT + s];
      }
    }
    SSD_SYNC();  // ms is free: the three sums in one phase
    put_rows<GP>(pdd, ms, t);
    put_rows<GP>(pdt, ms + TILE * 17, t);
    put_cols(csum, ms + 2 * TILE * 17, t);
    SSD_SYNC();
    if (t < sv) {
      a.ddtx[row_x(a, b, c * Q + s0 + t, h)] =
          sum_of<GP::TX>(ms + TILE * 17, t);
      a.dcs[oc + s0 + t] = -sum_of<GT::TY>(ms + 2 * TILE * 17, t);
      a.ddv[oc + s0 + t] = sum_of<GP::TX>(ms, t);
    }
  }
  // dB[s,t] += sum_q dCB[q,s] C[q,t]
  for (int i = j; i < a.nqt; ++i) {
    const int q0 = i * TILE;
    SSD_SYNC();
    load_tile<TILE, N>(st, a.cm + (base + q0) * N, N,
                       Q - q0 < TILE ? Q - q0 : TILE, t, One());
    SSD_SYNC();
    mma<TILE, N, TILE>(
        accb, t, [&](int m, int k) { return dcb[(i * TILE + k) * LDT + m]; },
        [&](int k, int n) { return ld4(&st[k * (N + 4) + n]); });
  }
#pragma unroll
  for (int ii = 0; ii < GN::RM; ++ii) {
    const int sa = s0 + GN::row(t, ii);
    if (sa >= Q) continue;
    T* o = a.db + (base + sa) * N;
#pragma unroll
    for (int jj = 0; jj < GN::RN; ++jj)
      o[GN::col(t, jj)] = from_f<T>(accb[ii][jj]);
  }
}

// ---------------------------------------------------------------------------
// bwd_q: per 64-row tile of target steps q
// ---------------------------------------------------------------------------

template <int P, int N>
constexpr int bwd_q_smem() {
  return TILE * (N + 4) + WIDE<P> * (N + 4) + MAX_QT * TILE * LDT +
         TILE * (P + 4) + P * LDT + 2 * MAX_Q + 2 * TILE + 2 * TILE * 17;
}

template <class T, int P, int N>
SSD_DEV void bwd_q_body(const Args<T>& a, float* sm, int c, int bg, int iz,
                        int t) {
  const int i = a.nqt - 1 - iz;  // the longest tiles (most sources) first
  using GN = Geo<TILE, N>;
  using GT = Geo<TILE, TILE>;
  const int b = bg / a.hg, g = bg % a.hg;
  const int Q = a.Q, q0 = i * TILE;
  const int qv = Q - q0 < TILE ? Q - q0 : TILE;
  const int h1 = (g + 1) * a.hpb < a.H ? (g + 1) * a.hpb : a.H;
  float* cs = sm;                          // [64 q][N+4] C of the tile's rows
  float* hs = cs + TILE * (N + 4);         // [max(P,64)][N+4] H_c, then B
  float* dcb = hs + WIDE<P> * (N + 4);     // [nqt][64 q][68 s] sum_h dM o L
  float* dys = dcb + MAX_QT * TILE * LDT;  // [64 q][P+4] dy of the tile
  float* xst = dys + TILE * (P + 4);       // [P][68 s] x^T of a tile
  float* cq = xst + P * LDT;               // [MAX_Q]
  float* dts = cq + MAX_Q;                 // [MAX_Q]
  float* red = dts + MAX_Q;                // 2 x [64][17] partial sums
  float* eq = red + 2 * TILE * 17;         // [64] exp(cum_q - cum_q0)
  float* es = eq + TILE;                   // [64] exp(cum_q0 - cum_s)
  const long long base = (long long)b * a.S + c * Q;
  const float* cbc = a.cb + ((long long)b * a.n + c) * Q * a.qp;
  const long long xstride = (long long)a.H * P;
  auto x_tile = [&](const T* x, int h, int r0) {
    return x + row_x(a, b, c * Q + r0, h) * P;
  };
  auto h_tile = [&](int h) { return a.hbuf + row_state(a, b, c, h, P * N); };
  Fetch<TILE, P, T> fdy;      // the next head's dy of the tile
  Fetch<P, N, float> fh;      // the next head's H_c
  Fetch<TILE, P, T> fx;       // the next source tile's x
  fdy.load(x_tile(a.dy, g * a.hpb, q0), xstride, qv, t);
  fh.load(h_tile(g * a.hpb), N, P, t);
  load_tile<TILE, N>(cs, a.cm + (base + q0) * N, N, qv, t, One());
  for (int e = t; e < MAX_QT * TILE * LDT; e += THREADS) dcb[e] = 0.f;
  float accc[GN::RM][GN::RN];  // dC[q,t], summed over the heads
  zero(accc);
  for (int h = g * a.hpb; h < h1; ++h) {
    SSD_SYNC();
    const long long oc = row_cum(a, b, h, c);
    cq[t] = t < Q ? a.cum[oc + t] : 0.f;
    dts[t] = t < Q ? a.dt[row_x(a, b, c * Q + t, h)] : 0.f;
    fdy.put(dys, t, One());
    fh.put(hs, t, One());
    fx.load(x_tile(a.x, h, 0), xstride, Q < TILE ? Q : TILE, t);
    SSD_SYNC();
    float partz[GN::RM];  // d cum_q of the inter part: exp(cum_q) C . Z
    {  // Z = dy H; dC += exp(cum_q) Z
      float z[GN::RM][GN::RN];
      zero(z);
      mma<TILE, N, P>(z, t, [&](int m, int k) { return dys[m * (P + 4) + k]; },
                      [&](int k, int n) { return ld4(&hs[k * (N + 4) + n]); });
#pragma unroll
      for (int ii = 0; ii < GN::RM; ++ii) {
        const int q = GN::row(t, ii);
        const float e = q0 + q < Q ? ssd_exp(cq[q0 + q]) : 0.f;
        partz[ii] = 0.f;
#pragma unroll
        for (int jj = 0; jj < GN::RN; ++jj) {
          const float ze = z[ii][jj] * e;
          accc[ii][jj] += ze;
          partz[ii] += cs[q * (N + 4) + GN::col(t, jj)] * ze;
        }
      }
    }
    // intra part: over the source tiles j <= i
    float partm[GT::RM];  // d cum_q of the intra part: row sums of dM o L o CB
#pragma unroll
    for (int ii = 0; ii < GT::RM; ++ii) partm[ii] = 0.f;
    for (int j = 0; j <= i; ++j) {
      const int s0 = j * TILE;
      SSD_SYNC();
      fx.template put<true>(xst, t, One());
      if (j < i) {
        const int s1 = s0 + TILE;
        fx.load(x_tile(a.x, h, s1), xstride, Q - s1 < TILE ? Q - s1 : TILE,
                 t);
        pivots(cq, q0, s0, Q, eq, es, t);
      } else if (h + 1 < h1) {
        fdy.load(x_tile(a.dy, h + 1, q0), xstride, qv, t);
        fh.load(h_tile(h + 1), N, P, t);
      }
      SSD_SYNC();
      float dm[GT::RM][GT::RN];
      zero(dm);
      mma<TILE, TILE, P>(dm, t,
                         [&](int m, int k) { return dys[m * (P + 4) + k]; },
                         [&](int k, int n) { return ld4(&xst[k * LDT + n]); });
#pragma unroll
      for (int ii = 0; ii < GT::RM; ++ii)
#pragma unroll
        for (int jj = 0; jj < GT::RN; ++jj) {
          const int q = GT::row(t, ii), s = GT::col(t, jj);
          const int qa = q0 + q, sa = s0 + s;
          const bool ok = sa <= qa && qa < Q;
          const float l = decay_of(cq, eq, es, j < i, qa, sa, q, s, Q);
          const float cbv = ok ? cbc[(long long)qa * a.qp + sa] : 0.f;
          const float dl = dm[ii][jj] * dts[sa] * l;  // as bwd_s forms it
          dcb[(j * TILE + q) * LDT + s] += dl;
          partm[ii] += dl * cbv;
        }
    }
    SSD_SYNC();
    put_rows<GN>(partz, red, t);
    put_rows<GT>(partm, red + TILE * 17, t);
    SSD_SYNC();
    if (t < qv)
      a.dcq[oc + q0 + t] = sum_of<GN::TX>(red, t) +
                           sum_of<GT::TX>(red + TILE * 17, t);
  }
  // dC[q,t] += sum_s dCB[q,s] B[s,t]
  for (int j = 0; j <= i; ++j) {
    const int s0 = j * TILE;
    SSD_SYNC();
    load_tile<TILE, N>(hs, a.bm + (base + s0) * N, N,
                       Q - s0 < TILE ? Q - s0 : TILE, t, One());
    SSD_SYNC();
    mma<TILE, N, TILE>(
        accc, t, [&](int m, int k) { return dcb[(j * TILE + m) * LDT + k]; },
        [&](int k, int n) { return ld4(&hs[k * (N + 4) + n]); });
  }
#pragma unroll
  for (int ii = 0; ii < GN::RM; ++ii) {
    const int qa = q0 + GN::row(t, ii);
    if (qa >= Q) continue;
    T* o = a.dc + (base + qa) * N;
#pragma unroll
    for (int jj = 0; jj < GN::RN; ++jj)
      o[GN::col(t, jj)] = from_f<T>(accc[ii][jj]);
  }
}

// ---------------------------------------------------------------------------
// fin: d cum -> ddt and da's partials; da
// ---------------------------------------------------------------------------

// d(dt a)_r = sum_{q >= r} (dcq + dcs)_q              (intra and inter terms)
//           + sum_{s < r} dd_s            (the state decay exp(cum_end - cum_s):
//                                         + dd_s at the end, - dd_s at s)
//           + exp(cum_end) sum dH_{c+1} . H_c         (the chunk's decay)
template <class T, int P, int N>
SSD_DEV void fin_body(const Args<T>& a, float* sm, int c, int h, int b,
                      int t) {
  const int Q = a.Q;
  float* buf = sm;
  float* dcum = sm + THREADS;
  float* tail = dcum + THREADS;
  const long long oc = row_cum(a, b, h, c);
  dcum[t] = t < Q ? a.dcq[oc + t] + a.dcs[oc + t] : 0.f;
  const float d = t < Q ? a.ddv[oc + t] : 0.f;
  const float before = block_scan(d, buf, t) - d;  // sum_{s < t} dd_s
  float da_c = 0.f;
  const float* pa = a.dapart + (((long long)b * a.H + h) * a.n + c) * a.nblk;
  for (int k = 0; k < a.nblk; ++k) da_c += pa[k];
  const float chunk = da_c * ssd_exp(a.cum[oc + Q - 1]);
  // thread t takes step Q - 1 - t: a prefix sum over t is a sum over the
  // steps at and after it
  const int r = Q - 1 - t;
  const float after = block_scan(t < Q ? dcum[r] : 0.f, buf, t);
  if (t < Q) tail[r] = after;
  SSD_SYNC();
  float part = 0.f;
  if (t < Q) {
    const float dda = tail[t] + before + chunk;
    const long long o = row_x(a, b, c * Q + t, h);
    a.ddt[o] = a.ddtx[o] + dda * a.arate[h];
    part = dda * a.dt[o];
  }
  const float s = block_sum(part, buf, t);
  if (t == 0) a.dapart2[(long long)h * a.B * a.n + (long long)b * a.n + c] = s;
}

template <class T, int P, int N>
SSD_DEV void da_body(const Args<T>& a, float*, int blk, int, int, int t) {
  const int h = blk * THREADS + t;
  if (h >= a.H) return;
  float s = 0.f;
  const float* pa = a.dapart2 + (long long)h * a.B * a.n;
  for (int k = 0; k < a.B * a.n; ++k) s += pa[k];
  a.da[h] = s;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

#if defined(__CUDACC__)

// blocks: the blocks an SM should hold (registers capped to fit them)
#define SSD_KERNEL(name, blocks)                                             \
  template <class T, int P, int N>                                           \
  __global__ void __launch_bounds__(THREADS, blocks)                         \
      name##_kernel(Args<T> a) {                                             \
    extern __shared__ float sm[];                                            \
    name<T, P, N>(a, sm, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x);   \
  }
SSD_KERNEL(state_f_body, 2)
SSD_KERNEL(state_g_body, 2)
SSD_KERNEL(pass_f_body, 1)
SSD_KERNEL(pass_b_body, 1)
SSD_KERNEL(cb_body, 1)
SSD_KERNEL(scan_body, 1)
SSD_KERNEL(bwd_s_body, 1)
SSD_KERNEL(bwd_q_body, 1)
SSD_KERNEL(fin_body, 1)
SSD_KERNEL(da_body, 1)

template <class K, class A>
int launch_kernel(K kern, int gx, int gy, int gz, int floats,
                  cudaStream_t stream, const A& a) {
  const size_t bytes = (size_t)floats * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(gx, gy, gz), THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

#define SSD_RUN(name, gx, gy, gz, floats)                                    \
  do {                                                                       \
    const int e_ = launch_kernel(name##_kernel<T, P, N>, gx, gy, gz, floats, \
                                 (cudaStream_t)stream, a);                   \
    if (e_) return e_;                                                       \
  } while (0)

#else

// a grid's blocks in turn, each block's threads as host threads
template <class F>
void host_grid(int gx, int gy, int gz, int floats, F body) {
  std::vector<float> sm(floats > 0 ? floats : 1);
  std::barrier<> block(THREADS);
  std::vector<std::thread> threads;
  for (int t = 0; t < THREADS; ++t)
    threads.emplace_back([&, t] {
      tl_block = &block;
      for (int z = 0; z < gz; ++z)
        for (int y = 0; y < gy; ++y)
          for (int x = 0; x < gx; ++x) {
            body(sm.data(), x, y, z, t);
            block.arrive_and_wait();
          }
    });
  for (auto& th : threads) th.join();
}

#define SSD_RUN(name, gx, gy, gz, floats)                                  \
  host_grid(gx, gy, gz, floats, [&](float* sm, int x_, int y_, int z_,     \
                                    int t_) { name<T, P, N>(a, sm, x_, y_, \
                                                            z_, t_); })

#endif

template <class T, int P, int N>
int fwd_run(const Args<T>& a, void* stream) {
  (void)stream;
  SSD_RUN(state_f_body, a.n, a.H, a.B, (state_smem<P, N>()));
  SSD_RUN(pass_f_body, a.nblk, a.B * a.H, 1, 0);
  SSD_RUN(cb_body, a.nqt * a.nqt, a.n, a.B, (cb_smem<P, N>()));
  SSD_RUN(scan_body, a.n, a.B * a.hg, a.nqt, (scan_smem<P, N>()));
  return 0;
}

template <class T, int P, int N>
int bwd_run(const Args<T>& a, void* stream) {
  (void)stream;
  SSD_RUN(cb_body, a.nqt * a.nqt, a.n, a.B, (cb_smem<P, N>()));
  SSD_RUN(state_g_body, a.n, a.H, a.B, (state_smem<P, N>()));
  SSD_RUN(pass_b_body, a.nblk, a.B * a.H, 1, BATCH * THREADS);
  SSD_RUN(bwd_s_body, a.n, a.B * a.hg, a.nqt, (bwd_s_smem<P, N>()));
  SSD_RUN(bwd_q_body, a.n, a.B * a.hg, a.nqt, (bwd_q_smem<P, N>()));
  SSD_RUN(fin_body, a.n, a.H, a.B, 3 * THREADS);
  SSD_RUN(da_body, (a.H + THREADS - 1) / THREADS, 1, 1, 0);
  return 0;
}

constexpr int BAD_SHAPE = 1;  // cudaErrorInvalidValue

// split_heads: the forward's scan may cut the heads into groups, a block
// each, where the chunk's tiles alone give too few blocks; the backward's
// blocks sum dB and dC over all the heads, so they take them all.
template <class T>
int fill_geometry(Args<T>& a, int B, int S, int H, int P, int N, int Q,
                  bool split_heads) {
  if (Q < 1 || Q > MAX_Q || S % Q) return BAD_SHAPE;
  a.B = B;
  a.S = S;
  a.H = H;
  a.Q = Q;
  a.qp = (Q + 3) / 4 * 4;
  a.n = S / Q;
  a.nqt = (Q + TILE - 1) / TILE;
  a.nblk = P * N / THREADS;
  // head groups: the fewest that give MIN_BLOCKS blocks (the scan's)
  const int tiles = B * a.n * a.nqt;
  int hg = 1;
  while (split_heads && hg < H && tiles * hg < MIN_BLOCKS) ++hg;
  a.hpb = (H + hg - 1) / hg;
  a.hg = (H + a.hpb - 1) / a.hpb;
  return 0;
}

template <class T, bool FWD>
int run_shape(const Args<T>& a, int P, int N, void* stream) {
  if (P == 64 && N == 128)
    return FWD ? fwd_run<T, 64, 128>(a, stream) : bwd_run<T, 64, 128>(a, stream);
  if (P == 64 && N == 64)
    return FWD ? fwd_run<T, 64, 64>(a, stream) : bwd_run<T, 64, 64>(a, stream);
  if (P == 16 && N == 16)
    return FWD ? fwd_run<T, 16, 16>(a, stream) : bwd_run<T, 16, 16>(a, stream);
  return BAD_SHAPE;
}

template <class T>
int fwd_entry(int B, int S, int H, int P, int N, int Q, const void* x,
              const float* dt, const float* arate, const void* bm,
              const void* cm, const float* h0, void* y, void* hfin,
              float* cum, float* hbuf, float* cb, void* stream) {
  Args<T> a = {};
  if (int e = fill_geometry(a, B, S, H, P, N, Q, true)) return e;
  a.x = (const T*)x;
  a.dt = dt;
  a.arate = arate;
  a.bm = (const T*)bm;
  a.cm = (const T*)cm;
  a.h0 = h0;
  a.y = (T*)y;
  a.hfin = (T*)hfin;
  a.cum = cum;
  a.hbuf = hbuf;
  a.cb = cb;
  return run_shape<T, true>(a, P, N, stream);
}

template <class T>
int bwd_entry(int B, int S, int H, int P, int N, int Q, const void* x,
              const float* dt, const float* arate, const void* bm,
              const void* cm, const float* hbuf, const float* cum,
              const void* dy, const void* dhf, float* cb, float* gbuf,
              float* dapart, float* dcq, float* dcs, float* ddv, float* ddtx,
              float* dapart2, void* dx, float* ddt, float* da, void* db,
              void* dc, float* dh0, void* stream) {
  Args<T> a = {};
  if (int e = fill_geometry(a, B, S, H, P, N, Q, false)) return e;
  a.x = (const T*)x;
  a.dt = dt;
  a.arate = arate;
  a.bm = (const T*)bm;
  a.cm = (const T*)cm;
  a.hbuf = (float*)hbuf;
  a.cum = (float*)cum;
  a.dy = (const T*)dy;
  a.dhf = (const T*)dhf;
  a.cb = cb;
  a.gbuf = gbuf;
  a.dapart = dapart;
  a.dcq = dcq;
  a.dcs = dcs;
  a.ddv = ddv;
  a.ddtx = ddtx;
  a.dapart2 = dapart2;
  a.dx = (T*)dx;
  a.ddt = ddt;
  a.da = da;
  a.db = (T*)db;
  a.dc = (T*)dc;
  a.dh0 = dh0;
  return run_shape<T, false>(a, P, N, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C, y, h_final and their gradients;
// dt, a, h0 and the scratch are float32).  h0 and dhf may be null.
#if defined(__CUDACC__)
#define SSD_ENTRY(name) extern "C" int name##_launch
#define SSD_STREAM , void* stream
#define SSD_STREAM_ARG stream
#else
#define SSD_ENTRY(name) extern "C" int name##_host
#define SSD_STREAM
#define SSD_STREAM_ARG nullptr
#endif

SSD_ENTRY(ssd_fwd)(int dtype, int B, int S, int H, int P, int N, int Q,
                   const void* x, const float* dt, const float* arate,
                   const void* bm, const void* cm, const float* h0, void* y,
                   void* hfin, float* cum, float* hbuf, float* cb SSD_STREAM) {
  if (dtype == 0)
    return fwd_entry<float>(B, S, H, P, N, Q, x, dt, arate, bm, cm, h0, y,
                            hfin, cum, hbuf, cb, SSD_STREAM_ARG);
  if (dtype == 1)
    return fwd_entry<bf16_t>(B, S, H, P, N, Q, x, dt, arate, bm, cm, h0, y,
                             hfin, cum, hbuf, cb, SSD_STREAM_ARG);
  return BAD_SHAPE;
}

SSD_ENTRY(ssd_bwd)(int dtype, int B, int S, int H, int P, int N, int Q,
                   const void* x, const float* dt, const float* arate,
                   const void* bm, const void* cm, const float* hbuf,
                   const float* cum, const void* dy, const void* dhf,
                   float* cb, float* gbuf, float* dapart, float* dcq,
                   float* dcs, float* ddv, float* ddtx, float* dapart2,
                   void* dx, float* ddt, float* da, void* db, void* dc,
                   float* dh0 SSD_STREAM) {
  if (dtype == 0)
    return bwd_entry<float>(B, S, H, P, N, Q, x, dt, arate, bm, cm, hbuf, cum,
                            dy, dhf, cb, gbuf, dapart, dcq, dcs, ddv, ddtx,
                            dapart2, dx, ddt, da, db, dc, dh0, SSD_STREAM_ARG);
  if (dtype == 1)
    return bwd_entry<bf16_t>(B, S, H, P, N, Q, x, dt, arate, bm, cm, hbuf,
                             cum, dy, dhf, cb, gbuf, dapart, dcq, dcs, ddv,
                             ddtx, dapart2, dx, ddt, da, db, dc, dh0, SSD_STREAM_ARG);
  return BAD_SHAPE;
}
