// Shared pieces of the three tile-compositing kernels (composite_fwd.cu,
// composite_bwd.cu, composite_pose_bwd.cu).
//
// Layout common to all three: one block per 16x16 pixel tile, one thread per
// pixel (256 threads). A tile's (tile, depth)-sorted pair segment
// [tile_start, tile_start + tile_count) of gaussian ids is walked front to
// back in batches of 256 pairs; each thread loads one pair's row, read by
// gaussian id from the packed per-gaussian table, into shared memory, and
// every thread then walks the batch for its own pixel in exact float32.
// A block stops at a batch boundary once every pixel has saturated
// (__syncthreads_count): past the stop, pixels take no pair and gradients
// are exactly zero.
#pragma once

#include <cuda_runtime.h>

namespace mm3dgs {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;   // threads per block
constexpr int NWARP = PIX / 32;

// Fields of a packed row: 0-1 xy, 2-4 conic, 5 opacity, 6-11 features
// [r, g, b, z, 1, z^2]; rows 16-24 (pose path) d(conic)/d(mean_cam),
// 25-27 the world-frame mean.
enum : int { F_X = 0, F_Y = 1, F_C0 = 2, F_C1 = 3, F_C2 = 4, F_OP = 5, F_FEAT = 6 };

enum : int { STEP_SKIP = 0, STEP_USE = 1, STEP_STOP = 2 };

// One pixel's test of one pair, the reference rasterizer's rules:
// alpha = min(0.99, op * exp(power)); skip when power > 0 or
// alpha < 1/255; stop when T * (1 - alpha) < 1e-4 (the pair is dropped and
// T freezes).
__device__ __forceinline__ int pair_step(float gx, float gy, float c0, float c1,
                                         float c2, float op, float px, float py,
                                         float T, float& dx, float& dy,
                                         float& expp, float& alpha,
                                         float& test_T) {
  dx = gx - px;
  dy = gy - py;
  const float power = -0.5f * (c0 * dx * dx + c2 * dy * dy) - c1 * dx * dy;
  if (power > 0.0f) return STEP_SKIP;
  expp = expf(power);
  alpha = fminf(0.99f, op * expp);
  if (alpha < 1.0f / 255.0f) return STEP_SKIP;
  test_T = T * (1.0f - alpha);
  if (test_T < 1e-4f) return STEP_STOP;
  return STEP_USE;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace mm3dgs
