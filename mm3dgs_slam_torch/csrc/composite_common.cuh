// Shared pieces of the three tile-compositing kernels (composite_fwd.cu,
// composite_bwd.cu, composite_pose_bwd.cu).
//
// Layout common to all three: one block per 16x16 pixel tile, one thread per
// pixel (256 threads). A tile's (tile, depth)-sorted pair segment
// [tile_start, tile_start + tile_count) of gaussian ids is walked front to
// back in batches of 256 pairs; each thread loads one pair's row, read by
// gaussian id from the packed per-gaussian table, into shared memory, and
// every pixel then walks the batch in exact float32 with the reference
// rasterizer's rules (`pair_step`). A block stops at a batch boundary once
// every pixel has saturated (__syncthreads_count): past the stop, pixels take
// no pair and gradients are exactly zero.
//
// Kernels 1 and 2 add an exact warp-level cull. Warp w owns the 8x4 pixel
// box at column w % 2, row w / 2 of the tile's boxes (`tile_pixel`). While a
// batch is loaded, each thread tests its pair against the 8 boxes with
// `box_keep`, the closed-form minimum of -power over a box with a
// floating-point margin, op for op the test of ops/binning.py
// `box_alpha_keep`, and writes one 8-bit mask per pair. A pair outside a
// warp's mask has alpha < 1/255 at every pixel of the box, so each of them
// would skip it; `walk_batch` has each warp visit only the pairs of its mask,
// in depth order, 32 masks per ballot, two pairs at a time. No pixel's
// sequence of used pairs, its stop or its final T changes. With the cull,
// the (warp, pair)s a tile walks fall from 8 per pair to ~2.2 at 640x480
// (PERF.md); what is left is the work of the pixels that use the pairs.
// Kernel 3 does not cull yet: each of its pixels tests every pair.
#pragma once

#include <cuda_runtime.h>

namespace mm3dgs {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;   // threads per block
constexpr int NWARP = PIX / 32;
constexpr int BOX_W = 8, BOX_H = 4, BOXES_X = TILE / BOX_W;  // a warp's box
constexpr int NV = 3;              // float4s per row read: fields 0-11
constexpr unsigned FULL = 0xffffffffu;

// Fields of a packed row: 0-1 xy, 2-4 conic, 5 opacity, 6-11 features
// [r, g, b, z, 1, z^2]; rows 16-24 (pose path) d(conic)/d(mean_cam),
// 25-27 the world-frame mean.
enum : int { F_X = 0, F_Y = 1, F_C0 = 2, F_C1 = 3, F_C2 = 4, F_OP = 5, F_FEAT = 6 };

enum : int { STEP_SKIP = 0, STEP_USE = 1, STEP_STOP = 2 };

// The part of a pixel's test of a pair that does not depend on T, with the
// reference rasterizer's rules: alpha = min(0.99, op * exp(power)); the
// pixel skips the pair when power > 0 or alpha < 1/255 (returns false).
// exp is taken either way (a skipped pair's value is never used), so the
// code has no branch and a warp can overlap two pairs.
__device__ __forceinline__ bool pair_alpha(float gx, float gy, float c0, float c1, float c2,
                                           float op, float px, float py, float& dx, float& dy,
                                           float& expp, float& alpha) {
  dx = gx - px;
  dy = gy - py;
  const float power = -0.5f * (c0 * dx * dx + c2 * dy * dy) - c1 * dx * dy;
  expp = expf(power);
  alpha = fminf(0.99f, op * expp);
  return power <= 0.0f && alpha >= 1.0f / 255.0f;
}

// One pixel's test of one pair: pair_alpha, then stop when
// T * (1 - alpha) < 1e-4 (the pair is dropped and T freezes).
__device__ __forceinline__ int pair_step(float gx, float gy, float c0, float c1,
                                         float c2, float op, float px, float py,
                                         float T, float& dx, float& dy,
                                         float& expp, float& alpha,
                                         float& test_T) {
  if (!pair_alpha(gx, gy, c0, c1, c2, op, px, py, dx, dy, expp, alpha)) return STEP_SKIP;
  test_T = T * (1.0f - alpha);
  if (test_T < 1e-4f) return STEP_STOP;
  return STEP_USE;
}

// A pair's row (fields 0-11) and pair_alpha's results at this lane's pixel.
struct Pair {
  float f[4 * NV];
  float dx, dy, expp, alpha;
  bool hit;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// Index in the tile's row-major 256 pixels of lane `lane` of warp `warp`.
__device__ __forceinline__ int tile_pixel(int warp, int lane) {
  return ((warp / BOXES_X) * BOX_H + lane / BOX_W) * TILE
         + (warp % BOXES_X) * BOX_W + lane % BOX_W;
}

// 0.5*a*x*x + b*x*y + 0.5*c*y*y, each operation rounded once (no FMA) in
// the order PyTorch evaluates it in ops/binning.py, so that the kernels and
// the plain count keep exactly the same boxes.
__device__ __forceinline__ float qform(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, a), x), x),
                             __fmul_rn(__fmul_rn(b, x), y)),
                   __fmul_rn(__fmul_rn(__fmul_rn(0.5f, c), y), y));
}

// ops/binning.py `box_alpha_keep` for one pair and one box: lx = x_lo - gx,
// ly = y_lo - gy, hx/hy the far pixel; tau = log(255 op).
__device__ __forceinline__ bool box_keep(float lx, float ly, float hx, float hy,
                                         float a, float b, float c, float tau) {
  const float ra = fmaxf(a, (float)1e-12), rc = fmaxf(c, (float)1e-12);
  auto edge_x = [&](float ex) {
    const float ys = fminf(fmaxf(__fdiv_rn(__fmul_rn(-b, ex), rc), ly), hy);
    return qform(a, b, c, ex, ys);
  };
  auto edge_y = [&](float ey) {
    const float xs = fminf(fmaxf(__fdiv_rn(__fmul_rn(-b, ey), ra), lx), hx);
    return qform(a, b, c, xs, ey);
  };
  float qmin = fminf(fminf(edge_x(lx), edge_x(hx)), fminf(edge_y(ly), edge_y(hy)));
  if (lx <= 0.0f && hx >= 0.0f && ly <= 0.0f && hy >= 0.0f) qmin = 0.0f;
  const float mx = fmaxf(fabsf(lx), fabsf(hx)), my = fmaxf(fabsf(ly), fabsf(hy));
  const float margin = __fadd_rn((float)1e-3, __fmul_rn((float)1e-5, qform(a, fabsf(b), c, mx, my)));
  return qmin <= __fadd_rn(tau, margin);
}

// Thread t loads pair t of the batch (n pairs from `pairs`) as NV float4s
// into s_row[.][t] and its 8-box mask into s_mask[t] (0 past n); returns
// the number of boxes kept. The caller synchronizes before the walk.
__device__ __forceinline__ int load_batch(const float* __restrict__ packed, int ld,
                                          const int* __restrict__ pairs, int n,
                                          int x0, int y0, float4 (*s_row)[PIX],
                                          unsigned char* s_mask, int* s_g) {
  const int t = threadIdx.x;
  unsigned mask = 0;
  if (t < n) {
    const int g = pairs[t];
    if (s_g != nullptr) s_g[t] = g;
    const float4* row = reinterpret_cast<const float4*>(packed + (size_t)g * ld);
    float4 r[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) s_row[k][t] = r[k] = __ldg(row + k);
    const float gx = r[0].x, gy = r[0].y, a = r[0].z, b = r[0].w, c = r[1].x;
    const float tau = logf(fmaxf(__fmul_rn(255.0f, r[1].y), (float)1e-12));
    // not unrolled: unrolled, this pass needs ~20 more registers than the
    // walk, and 3 blocks fit on an SM instead of 4
#pragma unroll 1
    for (int w = 0; w < NWARP; ++w) {
      const float lx = __fsub_rn((float)(x0 + (w % BOXES_X) * BOX_W), gx);
      const float ly = __fsub_rn((float)(y0 + (w / BOXES_X) * BOX_H), gy);
      const float hx = __fadd_rn(lx, (float)(BOX_W - 1));
      const float hy = __fadd_rn(ly, (float)(BOX_H - 1));
      mask |= (unsigned)box_keep(lx, ly, hx, hy, a, b, c, tau) << w;
    }
  }
  s_mask[t] = (unsigned char)mask;
  return __popc(mask);
}

// Batch pair i's fields, from shared memory, and its pair_alpha at (px, py).
__device__ __forceinline__ void read_pair(float4 (*s_row)[PIX], int i, float px, float py,
                                          Pair& p) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const float4 v = s_row[k][i];
    p.f[4 * k] = v.x;
    p.f[4 * k + 1] = v.y;
    p.f[4 * k + 2] = v.z;
    p.f[4 * k + 3] = v.w;
  }
  p.hit = pair_alpha(p.f[F_X], p.f[F_Y], p.f[F_C0], p.f[F_C1], p.f[F_C2], p.f[F_OP], px, py,
                     p.dx, p.dy, p.expp, p.alpha);
}

// The warp walks the pairs of the batch whose mask holds its bit, in depth
// order, calling step(i, pair) on every lane (a uniform call: step may use
// warp collectives, and a lane that has stopped takes no pair). It takes
// the pairs two at a time: their reads and pair_alpha do not depend on T,
// so the two overlap, and only the steps run in order. The warp leaves the
// batch once all its lanes have stopped. Returns the pairs walked.
template <class Step>
__device__ __forceinline__ int walk_batch(float4 (*s_row)[PIX], const unsigned char* s_mask,
                                          int n, float px, float py, const int& done,
                                          Step step) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int walked = 0;
  for (int c = 0; c < n; c += 32) {
    const int i = c + lane;
    unsigned bits = __ballot_sync(FULL, i < n && ((s_mask[i] >> warp) & 1u));
    while (bits) {
      if (__all_sync(FULL, done)) return walked;
      const int j0 = c + __ffs(bits) - 1;
      bits &= bits - 1;
      const bool two = bits != 0;
      const int j1 = two ? c + __ffs(bits) - 1 : j0;
      bits &= bits - 1;
      Pair p0, p1;
      read_pair(s_row, j0, px, py, p0);
      read_pair(s_row, j1, px, py, p1);
      step(j0, p0);
      if (two) step(j1, p1);
      walked += 1 + two;
    }
  }
  return walked;
}

// Adds the block's boxes kept (work[0]) and (warp, pair)s walked (work[1]).
__device__ __forceinline__ void add_work(unsigned long long* work, int kept, int walked) {
  if (work == nullptr) return;
  kept = (int)__reduce_add_sync(FULL, (unsigned)kept);
  if (threadIdx.x % 32 == 0) {
    atomicAdd(work, (unsigned long long)kept);
    atomicAdd(work + 1, (unsigned long long)walked);
  }
}

}  // namespace mm3dgs
