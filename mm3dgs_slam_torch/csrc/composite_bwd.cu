// Kernel 2: tile compositing backward for mapping (per-gaussian gradients),
// in two passes, each adding its floats in a fixed order.
//
// Replaces the TPU kernel `_bwd_kernel` (mm3dgs_slam_tpu/ops/
// pallas_composite.py, called through `_composite_pallas_bwd_rows`) and the
// XLA slot-table reduce `_table_reduce` that follows it, in the same two
// steps: from dacc and dtfin,
//   1. `composite_bwd_rows_kernel` writes one row per (tile, pair) slot of
//      the window, rows [P, 6 + nc]: the gradient of the pair's xy, conic,
//      opacity and nc walked features, summed over the tile's pixels;
//   2. `slot_reduce_kernel` gives dpacked [N, 16], row g the sum of
//      Gaussian g's slots' rows in ascending slot order (the slot table of
//      ops/binning.py `build_slots`); columns 6 + nc to 15 are zero. A
//      warp gathers the rows of 32 Gaussians' slots into shared memory
//      with coalesced loads and each lane adds its own Gaussian's.
// The xy columns are included because densification reads them. No float
// is added with an atomic, so dpacked is the same bits on every launch.
//
// Pass 1's route: the front-to-back replay with a prefix accumulator, as the
// TPU kernel's `_chunk_gradient` does. Each pixel re-walks the forward and
// keeps A_j = sum_{k<=j} w_k (f_k . dC), so that
//   dL/dalpha_j = T_j (f_j . dC) - ((C . dC) - A_j + dT_fin T_fin) / (1 - alpha_j)
// with C = acc the pixel's composite. The 0.99 clamp is straight-through.
// The walk is kernel 1's warp-culled one (composite_common.cuh: an 8x4
// pixel box per warp, a warp visits only the pairs its box may use, two at
// a time). A warp where a lane used the pair sums the 6 + nc gradients over
// its lanes with a reduce-scatter (16 shuffles for all fields, against 5 per
// field for a butterfly), after which lane 2k holds field k, and stores them
// in its own slice of a shared stash [NWARP][HALF][6 + nc]. The stash holds
// half a batch (HALF pairs: the whole batch would need 80 KB at nc 4 and
// halve the blocks an SM holds): after the warps have walked a half, one
// thread per (pair, field) adds the 8 warps' partials in warp order, writes
// the slot's row and zeroes the stash for the next half. Slots past the
// block's stop (all its pixels saturated) get zero rows.
//
// Bound on an H100: instruction issue and shuffles in pass 1, not bytes;
// pass 2 by bytes: it reads each slot's row once, scattered, and writes
// dpacked once (writing dpacked alone is over a quarter of its time).
#include "composite_common.cuh"

using namespace mm3dgs;

constexpr int HALF = PIX / 2;  // pairs of a batch walked between two flushes of the stash

// Sum over the warp of v[0..15]: lane l gets the sum of v[(l >> 1) & 15].
// Each step halves the slots a lane keeps and swaps the other half with
// the lane `o` away.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[16], int lane) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool up = lane & 16;
    v[k] = (up ? v[k + 8] : v[k]) + __shfl_xor_sync(FULL, up ? v[k] : v[k + 8], 16);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool up = lane & 8;
    v[k] = (up ? v[k + 4] : v[k]) + __shfl_xor_sync(FULL, up ? v[k] : v[k + 4], 8);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool up = lane & 4;
    v[k] = (up ? v[k + 2] : v[k]) + __shfl_xor_sync(FULL, up ? v[k] : v[k + 2], 4);
  }
  const bool up = lane & 2;
  const float r = (up ? v[1] : v[0]) + __shfl_xor_sync(FULL, up ? v[0] : v[1], 2);
  return r + __shfl_xor_sync(FULL, r, 1);
}

template <int NC>
__global__ void __launch_bounds__(PIX)
composite_bwd_rows_kernel(const float* __restrict__ packed, int ld,
                          const int* __restrict__ pair_gauss,
                          const int* __restrict__ tile_start,
                          const int* __restrict__ tile_count, int tile_lo,
                          int n_tiles, int tiles_x,
                          const float* __restrict__ acc,
                          const float* __restrict__ tfin,
                          const float* __restrict__ dacc,
                          const float* __restrict__ dtfin,
                          float* __restrict__ rows,
                          unsigned long long* __restrict__ work) {
  constexpr int NF = F_FEAT + NC;  // fields read = fields with a gradient
  static_assert(NF <= 4 * NV, "the row's float4s read hold the fields");
  __shared__ float4 s_row[NV][PIX];
  __shared__ unsigned char s_mask[PIX];
  extern __shared__ float s_part[];  // [NWARP][HALF][NF], zero outside a half's walk

  const int lt = blockIdx.x;  // window-local tile (see composite_fwd.cu)
  const int tile = tile_lo + lt;
  if (tile >= n_tiles) return;  // the window's pad: no pairs
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pix = tile_pixel(warp, lane);
  const int x0 = (tile % tiles_x) * TILE, y0 = (tile / tiles_x) * TILE;
  const float px = (float)(x0 + pix % TILE);
  const float py = (float)(y0 + pix / TILE);
  const int start = tile_start[lt];
  const int count = tile_count[lt];
  float* out = rows + (size_t)start * NF;  // the tile's slots
  for (int e = threadIdx.x; e < NWARP * HALF * NF; e += PIX) s_part[e] = 0.0f;

  float dC[NC];
  float cdc = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const size_t o = ((size_t)lt * NC + c) * PIX + pix;
    dC[c] = dacc[o];
    cdc += acc[o] * dC[c];
  }
  const float tail = dtfin[(size_t)lt * PIX + pix] * tfin[(size_t)lt * PIX + pix];

  float T = 1.0f;
  float A = 0.0f;
  int done = 0, kept = 0, walked = 0;
  int base = 0;
  for (; base < count; base += PIX) {
    if (__syncthreads_count(done) == PIX) break;
    const int n = min(PIX, count - base);
    kept += load_batch(packed, ld, pair_gauss + start + base, n, x0, y0, s_row, s_mask,
                       nullptr);
    __syncthreads();
    for (int h = 0; h < n; h += HALF) {
      const int nh = min(HALF, n - h);
      walked += walk_range(s_row, s_mask, h, h + nh, px, py, done, [&](int i, const Pair& p) {
        float v[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = 0.0f;
        bool use = false;
        if (!done && p.hit) {
          const float test_T = T * (1.0f - p.alpha);
          if (test_T < 1e-4f) {
            done = 1;
          } else {
            use = true;
            const float c0 = p.f[F_C0], c1 = p.f[F_C1], c2 = p.f[F_C2];
            const float dx = p.dx, dy = p.dy, alpha = p.alpha;
            const float w = alpha * T;
            float fdc = 0.0f;
#pragma unroll
            for (int c = 0; c < NC; ++c) fdc += p.f[F_FEAT + c] * dC[c];
            A += w * fdc;
            const float dalpha = T * fdc - (cdc - A + tail) / (1.0f - alpha);
            const float dop = p.expp * dalpha;
            const float dpower = p.f[F_OP] * dop;
            v[F_X] = -(c0 * dx + c1 * dy) * dpower;
            v[F_Y] = -(c2 * dy + c1 * dx) * dpower;
            v[F_C0] = -0.5f * dx * dx * dpower;
            v[F_C1] = -dx * dy * dpower;
            v[F_C2] = -0.5f * dy * dy * dpower;
            v[F_OP] = dop;
#pragma unroll
            for (int c = 0; c < NC; ++c) v[F_FEAT + c] = w * dC[c];
            T = test_T;
          }
        }
        if (!__any_sync(FULL, use)) return;
        const float sum = warp_reduce_scatter(v, lane);
        if (lane % 2 == 0 && lane / 2 < NF) s_part[(warp * HALF + i - h) * NF + lane / 2] = sum;
      });
      __syncthreads();
      // each (pair, field) of the half: the warps' partials in warp order
      for (int e = threadIdx.x; e < nh * NF; e += PIX) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < NWARP; ++w) {
          s += s_part[w * HALF * NF + e];
          s_part[w * HALF * NF + e] = 0.0f;
        }
        out[(size_t)(base + h) * NF + e] = s;
      }
      __syncthreads();
    }
  }
  // the slots past the block's stop: no pixel uses them
  for (int e = base * NF + threadIdx.x; e < count * NF; e += PIX) out[e] = 0.0f;
  add_work(work, kept, walked);
}

// Pass 2: one warp per 32 consecutive Gaussians, lane l Gaussian g0 + l.
// Their slots are one run of the slot table, gauss_slot[gauss_start[g0] ..
// gauss_start[g0 + 32]), which the warp takes RED_CHUNK slots at a time:
//   1. the chunk's slot indices, one coalesced load, into shared memory;
//   2. its rows gathered into shared memory, flat (slot, column) e to lane
//      e % 32, so NF consecutive lanes read one 36-40 B row and each lane
//      has up to RED_CHUNK * NF / 32 independent loads in flight;
//   3. each lane adds its own Gaussian's rows of the chunk, column by
//      column, in ascending slot order onto its running sums (from 0, as
//      slot_reduce_plain does, so the bits are the plain reduce's).
// Then the warp stages its 32 dpacked rows in shared memory and writes them
// as 2 KB of contiguous float4s. A Gaussian's adds are a chain in slot order
// whatever its length; a long one only makes its warp take more chunks.
// Each warp waits on three dependent loads (its segment bounds, the slot
// indices, the rows), so the card needs many warps in flight: the kernel is
// held to 64 registers a thread so that 4 blocks (32 warps) share an SM.
// Tensor cores and TMA have no part here: this is a gather-sum of 36-40 B
// rows at scattered addresses followed by a streaming write.
constexpr int RED_WARPS = 8;       // warps of a block
constexpr int RED_MIN_BLOCKS = 4;  // blocks an SM holds at once
constexpr int RED_CHUNK = 64;      // slots a warp gathers at a time

template <int NF>
__device__ __forceinline__ float col(const float (&acc)[NF], int k) {
  return k < NF ? acc[k < NF ? k : 0] : 0.0f;
}

template <int NF>
__global__ void __launch_bounds__(32 * RED_WARPS, RED_MIN_BLOCKS)
slot_reduce_kernel(const float* __restrict__ rows, const int* __restrict__ gauss_start,
                   const int* __restrict__ gauss_slot, int n, float* __restrict__ dpacked) {
  constexpr int PER_LANE = RED_CHUNK * NF / 32;
  static_assert(RED_CHUNK * NF % 32 == 0, "a chunk's (slot, column)s fill whole warps");
  static_assert(RED_CHUNK * NF >= 32 * 16, "the staged dpacked rows reuse the rows' buffer");
  __shared__ __align__(16) float s_rows[RED_WARPS][RED_CHUNK * NF];
  __shared__ int s_slot[RED_WARPS][RED_CHUNK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g0 = (blockIdx.x * RED_WARPS + warp) * 32;
  if (g0 >= n) return;
  const int g = min(g0 + lane, n);  // lanes past n: the empty segment [P, P)
  const int a = __ldg(gauss_start + g), b = __ldg(gauss_start + min(g + 1, n));
  const int lo = __shfl_sync(FULL, a, 0), hi = __shfl_sync(FULL, b, 31);
  float* sr = s_rows[warp];
  int* ss = s_slot[warp];
  float acc[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) acc[k] = 0.0f;
  for (int c0 = lo; c0 < hi; c0 += RED_CHUNK) {
    const int cnt = min(RED_CHUNK, hi - c0);
    for (int i = lane; i < cnt; i += 32) ss[i] = __ldg(gauss_slot + c0 + i);
    __syncwarp();
    float v[PER_LANE];
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int e = lane + 32 * u, j = e / NF;
      v[u] = j < cnt ? __ldg(rows + (size_t)ss[j] * NF + (e - j * NF)) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) sr[lane + 32 * u] = v[u];
    __syncwarp();
    const int j1 = min(b, c0 + cnt);
    for (int j = max(a, c0); j < j1; ++j) {
#pragma unroll
      for (int k = 0; k < NF; ++k) acc[k] += sr[(j - c0) * NF + k];
    }
    __syncwarp();
  }
  float4* st = reinterpret_cast<float4*>(sr);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    st[lane * 4 + q] = make_float4(col(acc, 4 * q), col(acc, 4 * q + 1), col(acc, 4 * q + 2),
                                   col(acc, 4 * q + 3));
  __syncwarp();
  float4* out = reinterpret_cast<float4*>(dpacked) + (size_t)g0 * 4;
  const int n_rows = min(32, n - g0);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int f = q * 32 + lane;
    if (f / 4 < n_rows) out[f] = st[f];
  }
}

template <int NC>
static int launch_rows(const float* packed, int ld, const int* pair_gauss,
                       const int* tile_start, const int* tile_count, int tile_lo,
                       int n_local, int n_tiles, int tiles_x, const float* acc,
                       const float* tfin, const float* dacc, const float* dtfin,
                       float* rows, unsigned long long* work, cudaStream_t s) {
  constexpr size_t smem = sizeof(float) * NWARP * HALF * (F_FEAT + NC);
  // the stash and the static buffers pass the 48 KB a block gets unasked;
  // opted in once per width and process (each process of the port drives
  // one card), not on every launch
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      composite_bwd_rows_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  composite_bwd_rows_kernel<NC><<<n_local, PIX, smem, s>>>(
      packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_tiles, tiles_x,
      acc, tfin, dacc, dtfin, rows, work);
  return (int)cudaGetLastError();
}

// Pass 1: rows [P, 6 + nc], 16-B aligned, every slot of the window written
// (P = the sum of tile_count: the window's bins as ops/binning.py builds
// them). packed, the window and work as for mm3dgs_composite_fwd. Returns a
// cudaError_t.
extern "C" int mm3dgs_composite_bwd_rows(const float* packed, int ld,
                                         const int* pair_gauss,
                                         const int* tile_start,
                                         const int* tile_count, int tile_lo,
                                         int n_local, int n_tiles,
                                         int tiles_x, int nc, const float* acc,
                                         const float* tfin, const float* dacc,
                                         const float* dtfin, float* rows,
                                         unsigned long long* work, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (nc) {  // mapping: nc 3, or 4 with the depth-estimate loss
    case 3: return launch_rows<3>(packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_local, n_tiles, tiles_x, acc, tfin, dacc, dtfin, rows, work, s);
    case 4: return launch_rows<4>(packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_local, n_tiles, tiles_x, acc, tfin, dacc, dtfin, rows, work, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Pass 2: dpacked [n, 16] (16-B aligned) from rows [P, nf], nf = 6 + nc
// (mapping's nc 3 or 4), through the slot table gauss_start [n + 1],
// gauss_slot [P]. Returns a cudaError_t.
extern "C" int mm3dgs_slot_reduce(const float* rows, int nf, const int* gauss_start,
                                  const int* gauss_slot, int n, float* dpacked,
                                  void* stream) {
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((n + 32 * RED_WARPS - 1) / (32 * RED_WARPS));
  switch (nf) {
    case 9: slot_reduce_kernel<9><<<blocks, 32 * RED_WARPS, 0, s>>>(rows, gauss_start, gauss_slot, n, dpacked); break;
    case 10: slot_reduce_kernel<10><<<blocks, 32 * RED_WARPS, 0, s>>>(rows, gauss_start, gauss_slot, n, dpacked); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
