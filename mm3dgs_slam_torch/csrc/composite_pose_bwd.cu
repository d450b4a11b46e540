// Kernel 3: tile compositing backward for tracking (pose gradient).
//
// Replaces the TPU kernel `_bwd_pose_kernel` (mm3dgs_slam_tpu/ops/
// pallas_composite.py, called through `_composite_pose_bwd`). Tracking
// optimizes only the 7-DoF camera pose, and in transform_means_python mode
// every pose-dependent packed field (screen xy, conic, z, z^2) is a function
// of the camera-frame mean alone. So the kernel replays the walk (the same
// prefix-accumulator backward as composite_bwd.cu), turns each used
// pixel-pair's field gradients into d(mean_cam) with the gaussian's pose
// Jacobians, and accumulates 12 numbers per tile:
//   [sum d(mean_cam) (3) | sum d(mean_cam) (x) mean_world (9, row-major)]
// which the caller sums over tiles into dT and dL/dR (dq follows from the
// quaternion -> R chain outside). d(xy)/d(mean_cam) is rebuilt from the
// packed xy and z and the intrinsics (px = fx x / z + cx - 0.5, the
// half-pixel ndc2Pix convention); d(conic)/d(mean_cam) is rows 16-24 of the
// [N, 32] packed table and the world mean rows 25-27.
//
// Bound on an H100: operations. Besides the forward walk, each used
// pixel-pair costs ~60 more f32 operations; the bytes are the [N, 32] rows
// (128 B each), 4 B per pair and 2 * (nc + 1) * 4 B per pixel in. The
// contraction is linear, so each thread keeps its own 12 sums in registers
// over the whole walk, and the block reduces them once at the end (warp
// shuffles, then shared memory) into [n_tiles, 12] partials: no atomics,
// no per-pair gradient ever leaves the SM.
#include "composite_common.cuh"

using namespace mm3dgs;

constexpr int NJ = 12;  // rows 16-27: 9 conic Jacobian entries, 3 world mean

template <int NC>
__global__ void __launch_bounds__(PIX)
composite_pose_bwd_kernel(const float* __restrict__ packed, int ld,
                          const int* __restrict__ pair_gauss,
                          const int* __restrict__ tile_start,
                          const int* __restrict__ tile_count, int tiles_x,
                          const float* __restrict__ acc,
                          const float* __restrict__ tfin,
                          const float* __restrict__ dacc,
                          const float* __restrict__ dtfin, float fx, float fy,
                          float bx, float by, float* __restrict__ psum) {
  constexpr int NF = F_FEAT + NC;
  __shared__ float s_f[NF][PIX];
  __shared__ float s_j[NJ][PIX];
  __shared__ float s_red[NWARP][12];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const float px = (float)((tile % tiles_x) * TILE + lane % TILE);
  const float py = (float)((tile / tiles_x) * TILE + lane / TILE);
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  float dC[NC];
  float cdc = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const size_t o = ((size_t)tile * NC + c) * PIX + lane;
    dC[c] = dacc[o];
    cdc += acc[o] * dC[c];
  }
  const float tail = dtfin[(size_t)tile * PIX + lane] * tfin[(size_t)tile * PIX + lane];

  float s[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) s[k] = 0.0f;
  float T = 1.0f;
  float A = 0.0f;
  int done = 0;
  for (int base = 0; base < count; base += PIX) {
    if (__syncthreads_count(done) == PIX) break;
    const int j = base + lane;
    if (j < count) {
      const float* row = packed + (size_t)pair_gauss[start + j] * ld;
#pragma unroll
      for (int k = 0; k < NF; ++k) s_f[k][lane] = row[k];
#pragma unroll
      for (int k = 0; k < NJ; ++k) s_j[k][lane] = row[16 + k];
    }
    __syncthreads();
    const int n = min(PIX, count - base);
    for (int i = 0; i < n && !done; ++i) {
      float dx, dy, expp, alpha, test_T;
      const float gx = s_f[F_X][i], gy = s_f[F_Y][i];
      const float c0 = s_f[F_C0][i], c1 = s_f[F_C1][i], c2 = s_f[F_C2][i];
      const int st = pair_step(gx, gy, c0, c1, c2, s_f[F_OP][i], px, py, T,
                               dx, dy, expp, alpha, test_T);
      if (st == STEP_SKIP) continue;
      if (st == STEP_STOP) {
        done = 1;
        break;
      }
      const float w = alpha * T;
      float fdc = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) fdc += s_f[F_FEAT + c][i] * dC[c];
      A += w * fdc;
      const float dalpha = T * fdc - (cdc - A + tail) / (1.0f - alpha);
      const float dpower = s_f[F_OP][i] * expp * dalpha;
      const float dxy_x = -(c0 * dx + c1 * dy) * dpower;
      const float dxy_y = -(c2 * dy + c1 * dx) * dpower;
      const float dc0 = -0.5f * dx * dx * dpower;
      const float dc1 = -dx * dy * dpower;
      const float dc2 = -0.5f * dy * dy * dpower;
      const float z = s_f[F_FEAT + 3][i];
      float dz = w * dC[3];
      if constexpr (NC == 6) dz += 2.0f * z * (w * dC[5]);
      const float p_w = 1.0f / (z + 1e-7f);
      const float dm_x = dxy_x * (fx * p_w) + dc0 * s_j[0][i] + dc1 * s_j[3][i] + dc2 * s_j[6][i];
      const float dm_y = dxy_y * (fy * p_w) + dc0 * s_j[1][i] + dc1 * s_j[4][i] + dc2 * s_j[7][i];
      const float dm_z = dxy_x * (p_w * (bx - gx)) + dxy_y * (p_w * (by - gy))
                         + dc0 * s_j[2][i] + dc1 * s_j[5][i] + dc2 * s_j[8][i] + dz;
      const float mw0 = s_j[9][i], mw1 = s_j[10][i], mw2 = s_j[11][i];
      s[0] += dm_x;
      s[1] += dm_y;
      s[2] += dm_z;
      s[3] += dm_x * mw0; s[4] += dm_x * mw1; s[5] += dm_x * mw2;
      s[6] += dm_y * mw0; s[7] += dm_y * mw1; s[8] += dm_y * mw2;
      s[9] += dm_z * mw0; s[10] += dm_z * mw1; s[11] += dm_z * mw2;
      T = test_T;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const float v = warp_sum(s[k]);
    if ((lane & 31) == 0) s_red[lane / 32][k] = v;
  }
  __syncthreads();
  if (lane < 12) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) v += s_red[w][lane];
    psum[(size_t)tile * 12 + lane] = v;
  }
}

template <int NC>
static void launch(const float* packed, int ld, const int* pair_gauss,
                   const int* tile_start, const int* tile_count, int n_tiles,
                   int tiles_x, const float* acc, const float* tfin,
                   const float* dacc, const float* dtfin, float fx, float fy,
                   float bx, float by, float* psum, cudaStream_t s) {
  composite_pose_bwd_kernel<NC><<<n_tiles, PIX, 0, s>>>(
      packed, ld, pair_gauss, tile_start, tile_count, tiles_x, acc, tfin,
      dacc, dtfin, fx, fy, bx, by, psum);
}

// packed is [N, ld] with ld >= 28. Returns cudaGetLastError().
extern "C" int mm3dgs_composite_pose_bwd(
    const float* packed, int ld, const int* pair_gauss, const int* tile_start,
    const int* tile_count, int n_tiles, int tiles_x, int nc, const float* acc,
    const float* tfin, const float* dacc, const float* dtfin, float fx,
    float fy, float bx, float by, float* psum, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (nc) {  // tracking: nc 5; render_tiles_pose's default: 6
    case 5: launch<5>(packed, ld, pair_gauss, tile_start, tile_count, n_tiles, tiles_x, acc, tfin, dacc, dtfin, fx, fy, bx, by, psum, s); break;
    case 6: launch<6>(packed, ld, pair_gauss, tile_start, tile_count, n_tiles, tiles_x, acc, tfin, dacc, dtfin, fx, fy, bx, by, psum, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
