// Split and merge of a flat float32 vector by a fixed selection mask, for
// Hopper (sm_90a), over the mask's per-partition layout:
//
//   split: vec[P] -> enc[n_enc_padded] (the masked elements in index order,
//          then zeros up to whole slot blocks) and plain[P - n_enc] (the
//          rest, in index order);
//   merge: the inverse, out[P] from the first n_enc values of enc (read at
//          any element stride) and plain.
//
// Replaces no TPU kernel: the JAX package gathers and scatters by int32
// index arrays under XLA (src/repro/core/packing.py `split_by_mask`,
// `merge_by_mask`).  Added because the port's boolean indexing (a split:
// two nonzero scans, each with a host sync for its count, two gathers and a
// zero fill; a merge: the same with two scatters) took a sixth of an
// in-memory round, though the partition is fixed for the aggregator's life.
//
// Layout (kernels/mask.py `build_layout`, once per partition and device):
//   words    u32[n_tiles * TILE / 32]: bit j of word i is mask[32 i + j],
//            zero past P;
//   tile_enc i64[n_tiles]: the encrypted elements before each tile.
// The plain elements before element x are x minus the encrypted ones, so
// no index array and no count is read from the device.
//
// Design: a warp takes one tile of 32 steps; a step is 128 elements, one
// 16-byte vector of 4 elements a lane.  Lane s loads step s's 4 mask words
// (the tile's 512 bytes in one 16-byte load a lane) and a warp scan of their
// popcounts gives every step's offset in enc and plain, so no load waits on
// another.  For each step the lanes take its words by shuffle, and a lane
// ranks its 4 elements within the step by __popc over them.  The split puts
// a step in the warp's shared buffer in output order -- the step's
// encrypted elements, then its plain ones -- and the warp writes the buffer
// out with neighbouring lanes on neighbouring addresses of enc and plain, so
// each store instruction is at most two contiguous runs.  The merge reads
// enc and plain the same way into the buffer, and each lane takes its 4
// elements from it for one 16-byte store.  The split keeps SPLIT_BATCH
// steps' loads in flight a warp; the merge, whose 4-byte loads straddle
// cache lines, ran fastest a step at a time.
//
// Bound: device memory.  Per element 4 bytes read, 4 written and 1/8 byte
// of mask: 8.125 B (the pad of enc and tile_enc are under 1e-5 of it).
// Offsets are 64-bit: P may pass 2^31.
//
// Under nvcc the step functions are __device__.  Under a host compiler they
// are plain inline functions, and mask_split_host / mask_merge_host run a
// warp's lanes one after another between the warp's barriers, through the
// same functions, with the tile's words and their scan taken in order
// (host_tile) in place of the shuffles (the CPU test of this file).
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define MASK_HD __device__ __forceinline__
#define MASK_POPC(x) __popc(x)
#else
#define MASK_HD static inline
#define MASK_POPC(x) __builtin_popcount(x)
#endif

namespace {

constexpr int LANES = 32;
constexpr int STEP = 4 * LANES;  // elements a warp step
constexpr int TILE_STEPS = 32;
constexpr long long TILE = (long long)STEP * TILE_STEPS;  // kernels/mask.py
// steps in flight a warp, and warps (so tiles) a block, of each kernel:
// the fastest of the counts timed side by side on an H100 at P =
// 945,808,640 and 368,252,416, p = 0.1 (PERF.md)
constexpr int SPLIT_BATCH = 16, SPLIT_WARPS = 4;
constexpr int MERGE_BATCH = 1, MERGE_WARPS = 8;

// A lane's place in one step.
struct StepRank {
  int n_enc;     // encrypted elements in the step
  int before;    // encrypted elements of the step before the lane's first
  uint32_t nib;  // the lane's 4 mask bits
};

MASK_HD StepRank step_rank(const uint32_t w[4], int lane) {
  const int q = lane >> 3, sh = (lane & 7) * 4;
  const uint32_t wq = q == 0 ? w[0] : q == 1 ? w[1] : q == 2 ? w[2] : w[3];
  const int c0 = MASK_POPC(w[0]), c1 = MASK_POPC(w[1]);
  const int c2 = MASK_POPC(w[2]);
  StepRank r;
  r.n_enc = c0 + c1 + c2 + MASK_POPC(w[3]);
  r.before = (q > 0 ? c0 : 0) + (q > 1 ? c1 : 0) + (q > 2 ? c2 : 0) +
             MASK_POPC(wq & ((1u << sh) - 1u));
  r.nib = (wq >> sh) & 0xFu;
  return r;
}

// The slot in the step's buffer of the lane's element k: the step's
// encrypted elements first, then its plain ones, each in index order.  An
// element past P is plain and lands at or after the step's valid count.
MASK_HD int buffer_slot(const StepRank& r, int lane, int k) {
  const int enc_before = r.before + MASK_POPC(r.nib & ((1u << k) - 1u));
  return (r.nib >> k) & 1u ? enc_before
                           : r.n_enc + (4 * lane + k - enc_before);
}

MASK_HD int step_valid(long long step, long long n) {
  const long long left = n - step;
  return left < STEP ? (int)left : STEP;
}

// The lane's 4 elements of the step (zeros past n).
MASK_HD void load_elems(const float* __restrict__ vec, long long step,
                        long long n, int lane, float v[4]) {
  const long long x = step + 4 * lane;
#if defined(__CUDACC__)
  if (step + STEP <= n) {
    const float4 f = *reinterpret_cast<const float4*>(vec + x);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    return;
  }
#endif
  for (int k = 0; k < 4; ++k) v[k] = x + k < n ? vec[x + k] : 0.f;
}

MASK_HD void split_stage(float* buf, const StepRank& r, int lane,
                         const float v[4]) {
  for (int k = 0; k < 4; ++k) buf[buffer_slot(r, lane, k)] = v[k];
}

// The step's buffer out to enc and plain; e is the encrypted elements
// before the step, so step - e the plain ones.
MASK_HD void split_write(const float* buf, int lane, int n_enc, int valid,
                         long long step, long long e, float* __restrict__ enc,
                         float* __restrict__ plain) {
  for (int j = 0; j < 4; ++j) {
    const int i = j * LANES + lane;
    if (i < valid) {
      const float x = buf[i];
      if (i < n_enc) enc[e + i] = x;
      else plain[step - e + (i - n_enc)] = x;
    }
  }
}

MASK_HD void merge_read(float* buf, int lane, int n_enc, int valid,
                        long long step, long long e,
                        const float* __restrict__ enc, long long enc_stride,
                        const float* __restrict__ plain) {
  for (int j = 0; j < 4; ++j) {
    const int i = j * LANES + lane;
    if (i < valid)
      buf[i] = i < n_enc ? enc[(e + i) * enc_stride]
                         : plain[step - e + (i - n_enc)];
  }
}

MASK_HD void merge_place(const float* buf, const StepRank& r, int lane,
                         long long step, long long n,
                         float* __restrict__ out) {
  float v[4];
  for (int k = 0; k < 4; ++k) v[k] = buf[buffer_slot(r, lane, k)];
  const long long x = step + 4 * lane;
#if defined(__CUDACC__)
  if (step + STEP <= n) {
    *reinterpret_cast<float4*>(out + x) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#endif
  for (int k = 0; k < 4; ++k)
    if (x + k < n) out[x + k] = v[k];
}

#if defined(__CUDACC__)

constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(TILE_STEPS == LANES, "a lane loads one step's words");

// The tile's mask words, lane s holding step s's 4 words, with step s's
// encrypted count and, by a warp scan, the tile's encrypted elements
// before step s.  One 16-byte load a lane: the whole tile's 512 bytes.
struct TileWords {
  uint32_t w[4];
  int n_enc;
  int before;
};

__device__ __forceinline__ TileWords tile_words(
    const uint32_t* __restrict__ words, long long tile, int lane) {
  TileWords t;
  const uint4 u = *reinterpret_cast<const uint4*>(
      words + ((tile * TILE_STEPS + lane) << 2));
  t.w[0] = u.x; t.w[1] = u.y; t.w[2] = u.z; t.w[3] = u.w;
  t.n_enc = __popc(u.x) + __popc(u.y) + __popc(u.z) + __popc(u.w);
  int incl = t.n_enc;
#pragma unroll
  for (int d = 1; d < LANES; d <<= 1) {
    const int x = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += x;
  }
  t.before = incl - t.n_enc;
  return t;
}

__device__ __forceinline__ void step_words(const TileWords& t, int s,
                                           uint32_t w[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = __shfl_sync(FULL, t.w[k], s);
}

template <int BATCH, int WARPS>
__global__ void __launch_bounds__(WARPS * LANES)
    mask_split_kernel(const float* __restrict__ vec,
                      const uint32_t* __restrict__ words,
                      const long long* __restrict__ tile_enc, long long n,
                      long long n_tiles, float* __restrict__ enc,
                      float* __restrict__ plain, long long n_enc,
                      long long pad) {
  __shared__ float buf[WARPS][BATCH * STEP];
  const int lane = threadIdx.x & (LANES - 1), warp = threadIdx.x / LANES;
  const long long threads = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < pad; i += threads)
    enc[n_enc + i] = 0.f;
  const long long tile = (long long)blockIdx.x * WARPS + warp;
  if (tile >= n_tiles) return;
  float* b = buf[warp];
  const TileWords tw = tile_words(words, tile, lane);
  const long long e0 = tile_enc[tile];
  for (int s0 = 0; s0 < TILE_STEPS; s0 += BATCH) {
    const long long step0 = tile * TILE + (long long)s0 * STEP;
    if (step0 >= n) break;
    float v[BATCH][4];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      load_elems(vec, step0 + u * STEP, n, lane, v[u]);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      uint32_t w[4];
      step_words(tw, s0 + u, w);
      split_stage(b + u * STEP, step_rank(w, lane), lane, v[u]);
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const long long step = step0 + u * STEP;
      const int n_step = __shfl_sync(FULL, tw.n_enc, s0 + u);
      const long long e = e0 + __shfl_sync(FULL, tw.before, s0 + u);
      if (step < n)
        split_write(b + u * STEP, lane, n_step, step_valid(step, n), step, e,
                    enc, plain);
    }
    __syncwarp();
  }
}

template <int BATCH, int WARPS>
__global__ void __launch_bounds__(WARPS * LANES)
    mask_merge_kernel(float* __restrict__ out, const float* __restrict__ enc,
                      long long enc_stride, const float* __restrict__ plain,
                      const uint32_t* __restrict__ words,
                      const long long* __restrict__ tile_enc, long long n,
                      long long n_tiles) {
  __shared__ float buf[WARPS][BATCH * STEP];
  const int lane = threadIdx.x & (LANES - 1), warp = threadIdx.x / LANES;
  const long long tile = (long long)blockIdx.x * WARPS + warp;
  if (tile >= n_tiles) return;
  float* b = buf[warp];
  const TileWords tw = tile_words(words, tile, lane);
  const long long e0 = tile_enc[tile];
  for (int s0 = 0; s0 < TILE_STEPS; s0 += BATCH) {
    const long long step0 = tile * TILE + (long long)s0 * STEP;
    if (step0 >= n) break;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const long long step = step0 + u * STEP;
      const int n_step = __shfl_sync(FULL, tw.n_enc, s0 + u);
      const long long e = e0 + __shfl_sync(FULL, tw.before, s0 + u);
      if (step < n)
        merge_read(b + u * STEP, lane, n_step, step_valid(step, n), step, e,
                   enc, enc_stride, plain);
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const long long step = step0 + u * STEP;
      uint32_t w[4];
      step_words(tw, s0 + u, w);
      if (step < n)
        merge_place(b + u * STEP, step_rank(w, lane), lane, step, n, out);
    }
    __syncwarp();
  }
}

long long n_tiles_of(long long n) { return (n + TILE - 1) / TILE; }

unsigned blocks_of(long long n_tiles, int warps) {
  const long long blocks = (n_tiles + warps - 1) / warps;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

#endif  // __CUDACC__

}  // namespace

#if defined(__CUDACC__)

// vec: f32[n], 16-byte aligned; words, tile_enc: the layout of the mask
// (tiles of TILE); enc: f32[n_enc_padded]; plain: f32[n - n_enc].
extern "C" int mask_split_launch(const float* vec, const uint32_t* words,
                                 const long long* tile_enc, long long n,
                                 long long n_enc, long long n_enc_padded,
                                 float* enc, float* plain, void* stream) {
  const long long n_tiles = n_tiles_of(n);
  mask_split_kernel<SPLIT_BATCH, SPLIT_WARPS>
      <<<blocks_of(n_tiles, SPLIT_WARPS), SPLIT_WARPS * LANES, 0,
         (cudaStream_t)stream>>>(vec, words, tile_enc, n, n_tiles, enc,
                                 plain, n_enc, n_enc_padded - n_enc);
  return (int)cudaGetLastError();
}

// out: f32[n], 16-byte aligned; enc: its first n_enc values at element
// stride enc_stride; plain: f32[n - n_enc] contiguous.
extern "C" int mask_merge_launch(float* out, const float* enc,
                                 long long enc_stride, const float* plain,
                                 const uint32_t* words,
                                 const long long* tile_enc, long long n,
                                 void* stream) {
  const long long n_tiles = n_tiles_of(n);
  if (n_tiles == 0) return (int)cudaGetLastError();
  mask_merge_kernel<MERGE_BATCH, MERGE_WARPS>
      <<<blocks_of(n_tiles, MERGE_WARPS), MERGE_WARPS * LANES, 0,
         (cudaStream_t)stream>>>(out, enc, enc_stride, plain, words,
                                 tile_enc, n, n_tiles);
  return (int)cudaGetLastError();
}

#else  // a host compiler: the kernels' steps, a warp's lanes in turn

namespace {

// tile_words for every lane: step s's words, encrypted count, and the
// tile's encrypted elements before it (the warp scan's result)
struct HostTile {
  uint32_t w[TILE_STEPS][4];
  int n_enc[TILE_STEPS];
  int before[TILE_STEPS];
};

void host_tile(const uint32_t* words, long long tile, HostTile& t) {
  int before = 0;
  for (int s = 0; s < TILE_STEPS; ++s) {
    for (int k = 0; k < 4; ++k)
      t.w[s][k] = words[(tile * TILE_STEPS + s) * 4 + k];
    t.n_enc[s] = step_rank(t.w[s], 0).n_enc;
    t.before[s] = before;
    before += t.n_enc[s];
  }
}

}  // namespace

extern "C" void mask_split_host(const float* vec, const uint32_t* words,
                                const long long* tile_enc, long long n,
                                long long n_enc, long long n_enc_padded,
                                float* enc, float* plain) {
  for (long long i = n_enc; i < n_enc_padded; ++i) enc[i] = 0.f;
  float buf[SPLIT_BATCH * STEP];
  HostTile t;
  for (long long tile = 0; tile * TILE < n; ++tile) {
    host_tile(words, tile, t);
    for (int s0 = 0; s0 < TILE_STEPS; s0 += SPLIT_BATCH) {
      const long long step0 = tile * TILE + (long long)s0 * STEP;
      if (step0 >= n) break;
      for (int u = 0; u < SPLIT_BATCH; ++u)
        for (int lane = 0; lane < LANES; ++lane) {
          float v[4];
          load_elems(vec, step0 + u * STEP, n, lane, v);
          split_stage(buf + u * STEP, step_rank(t.w[s0 + u], lane), lane, v);
        }
      for (int u = 0; u < SPLIT_BATCH; ++u) {
        const long long step = step0 + u * STEP;
        const long long e = tile_enc[tile] + t.before[s0 + u];
        if (step < n)
          for (int lane = 0; lane < LANES; ++lane)
            split_write(buf + u * STEP, lane, t.n_enc[s0 + u],
                        step_valid(step, n), step, e, enc, plain);
      }
    }
  }
}

extern "C" void mask_merge_host(float* out, const float* enc,
                                long long enc_stride, const float* plain,
                                const uint32_t* words,
                                const long long* tile_enc, long long n) {
  float buf[MERGE_BATCH * STEP];
  HostTile t;
  for (long long tile = 0; tile * TILE < n; ++tile) {
    host_tile(words, tile, t);
    for (int s0 = 0; s0 < TILE_STEPS; s0 += MERGE_BATCH) {
      const long long step0 = tile * TILE + (long long)s0 * STEP;
      if (step0 >= n) break;
      for (int u = 0; u < MERGE_BATCH; ++u) {
        const long long step = step0 + u * STEP;
        const long long e = tile_enc[tile] + t.before[s0 + u];
        if (step < n)
          for (int lane = 0; lane < LANES; ++lane)
            merge_read(buf + u * STEP, lane, t.n_enc[s0 + u],
                       step_valid(step, n), step, e, enc, enc_stride, plain);
      }
      for (int u = 0; u < MERGE_BATCH; ++u) {
        const long long step = step0 + u * STEP;
        if (step < n)
          for (int lane = 0; lane < LANES; ++lane)
            merge_place(buf + u * STEP, step_rank(t.w[s0 + u], lane), lane,
                        step, n, out);
      }
    }
  }
}

#endif  // __CUDACC__
