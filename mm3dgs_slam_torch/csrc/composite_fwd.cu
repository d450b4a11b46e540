// Kernel 1: tile compositing forward.
//
// Replaces the TPU kernel `_fwd_kernel` (mm3dgs_slam_tpu/ops/
// pallas_composite.py, called through `_composite_pallas_fwd`): per 16x16
// tile, a front-to-back alpha composite of the tile's depth-sorted pairs
// into acc = sum_j alpha_j T_j feat_j over the first nc of the features
// [r, g, b, z, 1, z^2] (channel-major [n_tiles, nc, 256]) and the final
// transmittance tfin [n_tiles, 1, 256]. The TPU kernel's log-space
// triangular-matmul cumsum, bf16 operand splits and 128-aligned field-major
// slabs are not carried over: each thread walks its pixel sequentially in
// exact f32, the reference rasterizer's shape.
//
// Bound on an H100: instruction issue and latency, not bytes (the packed
// rows, 4 B per pair and (nc + 1) * 4 B per pixel out are a few MB at
// 640x480). A pair reaches about a tenth of a tile's pixels, so the kernel
// culls per warp (composite_common.cuh): each warp owns an 8x4 pixel box,
// the batch load tests every pair against the 8 boxes once per thread, and
// a warp walks only the pairs its box may use, with warp-uniform control
// flow, two pairs at a time so that their exp and alpha overlap. Rows are
// read as float4s. The per-pixel arithmetic is the reference walk's, op for
// op, so acc and tfin do not depend on the cull.
//
// Tile window (the TPU kernel's `tile_lo` scalar, for the tile-sharded
// render): block b walks global tile tile_lo + b with the window-local
// segment b and writes output row b; a block past the grid (the last
// window's pad) writes acc 0 and T 1 and returns.
#include "composite_common.cuh"

using namespace mm3dgs;

template <int NC>
__global__ void __launch_bounds__(PIX)
composite_fwd_kernel(const float* __restrict__ packed, int ld,
                     const int* __restrict__ pair_gauss,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int tile_lo,
                     int n_tiles, int tiles_x,
                     float* __restrict__ acc, float* __restrict__ tfin,
                     unsigned long long* __restrict__ work) {
  __shared__ float4 s_row[NV][PIX];
  __shared__ unsigned char s_mask[PIX];

  const int lt = blockIdx.x;  // window-local tile: the bins' and outputs' row
  const int tile = tile_lo + lt;
  const int pix = tile_pixel(threadIdx.x / 32, threadIdx.x % 32);
  if (tile >= n_tiles) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[((size_t)lt * NC + c) * PIX + pix] = 0.0f;
    tfin[(size_t)lt * PIX + pix] = 1.0f;
    return;
  }
  const int x0 = (tile % tiles_x) * TILE, y0 = (tile / tiles_x) * TILE;
  const float px = (float)(x0 + pix % TILE);
  const float py = (float)(y0 + pix / TILE);
  const int start = tile_start[lt];
  const int count = tile_count[lt];

  float T = 1.0f;
  int done = 0, kept = 0, walked = 0;
  float a[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) a[c] = 0.0f;

  for (int base = 0; base < count; base += PIX) {
    // barrier: the previous batch is consumed before it is overwritten
    if (__syncthreads_count(done) == PIX) break;
    const int n = min(PIX, count - base);
    kept += load_batch(packed, ld, pair_gauss + start + base, n, x0, y0, s_row, s_mask, nullptr);
    __syncthreads();
    walked += walk_batch(s_row, s_mask, n, px, py, done, [&](int, const Pair& p) {
      if (done || !p.hit) return;
      const float test_T = T * (1.0f - p.alpha);
      if (test_T < 1e-4f) {
        done = 1;
        return;
      }
      const float w = p.alpha * T;
#pragma unroll
      for (int c = 0; c < NC; ++c) a[c] += w * p.f[F_FEAT + c];
      T = test_T;
    });
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[((size_t)lt * NC + c) * PIX + pix] = a[c];
  tfin[(size_t)lt * PIX + pix] = T;
  add_work(work, kept, walked);
}

template <int NC>
static void launch(const float* packed, int ld, const int* pair_gauss,
                   const int* tile_start, const int* tile_count, int tile_lo,
                   int n_local, int n_tiles, int tiles_x, float* acc, float* tfin,
                   unsigned long long* work, cudaStream_t s) {
  composite_fwd_kernel<NC><<<n_local, PIX, 0, s>>>(
      packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_tiles, tiles_x, acc,
      tfin, work);
}

// packed rows are 16-B aligned with ld % 4 == 0; tile_start/tile_count,
// acc and tfin have n_local rows, for the global tiles from tile_lo on of a
// grid of n_tiles; work is null or two counters the kernel adds to. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int mm3dgs_composite_fwd(const float* packed, int ld,
                                    const int* pair_gauss,
                                    const int* tile_start,
                                    const int* tile_count, int tile_lo,
                                    int n_local, int n_tiles,
                                    int tiles_x, int nc, float* acc,
                                    float* tfin, unsigned long long* work,
                                    void* stream) {
  // mapping: nc 3 (4 with the depth-estimate loss); tracking 5; eval 6
  cudaStream_t s = (cudaStream_t)stream;
  switch (nc) {
    case 3: launch<3>(packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_local, n_tiles, tiles_x, acc, tfin, work, s); break;
    case 4: launch<4>(packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_local, n_tiles, tiles_x, acc, tfin, work, s); break;
    case 5: launch<5>(packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_local, n_tiles, tiles_x, acc, tfin, work, s); break;
    case 6: launch<6>(packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_local, n_tiles, tiles_x, acc, tfin, work, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
