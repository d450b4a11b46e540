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
// Bound on an H100: bytes (the 6 + nc fields and 12 pose columns of each
// gaussian in some pair, 4 B per pair, 2 (nc + 1) 4 B per pixel in, 12
// floats per tile out); the walk's instruction rate and latency set its
// time. The walk is kernels 1 and 2's warp-culled one
// (composite_common.cuh): each warp owns an 8x4 pixel box and visits only
// the pairs its box may use, two at a time. The same load pass reads each pair's pose columns as 3 float4s
// into shared memory, and computes once per pair the terms of
// d(xy)/d(mean_cam) that depend only on the gaussian: fx p, fy p,
// p (bx - gx) and p (by - gy), p = 1 / (z + 1e-7). A lane reads both only
// for a pair it uses, at the address every lane of its warp reads (a
// broadcast); they stay out of `Pair`, whose ~20 more live registers would
// cost a block per SM. The 12 sums and the walk's two pairs in flight need
// ~73 registers, 3 blocks per SM; the launch bound holds the kernel to 64
// (4 blocks) at the cost of a few spilled bytes, which ran faster on the
// H100 (PERF.md). The contraction is linear, so each lane keeps its
// own 12 sums in registers over the whole walk, with no shuffle or atomic
// per pair, and the block reduces them once at the end (warp shuffles, then
// shared memory) into the [n_tiles, 12] partials. The cull drops only
// pixel-pairs whose terms are exactly zero, so the partials depend on it
// only through the order of the float sums.
#include "composite_common.cuh"

using namespace mm3dgs;

constexpr int NJ = 3;  // float4s of pose columns: rows 16-27

template <int NC>
__global__ void __launch_bounds__(PIX, 4)
composite_pose_bwd_kernel(const float* __restrict__ packed, int ld,
                          const int* __restrict__ pair_gauss,
                          const int* __restrict__ tile_start,
                          const int* __restrict__ tile_count, int tile_lo,
                          int n_tiles, int tiles_x,
                          const float* __restrict__ acc,
                          const float* __restrict__ tfin,
                          const float* __restrict__ dacc,
                          const float* __restrict__ dtfin, float fx, float fy,
                          float bx, float by, float* __restrict__ psum,
                          unsigned long long* __restrict__ work) {
  static_assert(F_FEAT + NC <= 4 * NV, "the row's float4s read hold the fields");
  __shared__ float4 s_row[NV][PIX];
  __shared__ float4 s_jac[NJ][PIX];
  __shared__ float4 s_dxy[PIX];  // fx p, fy p, p (bx - gx), p (by - gy)
  __shared__ unsigned char s_mask[PIX];
  __shared__ int s_g[PIX];
  __shared__ float s_red[NWARP][12];

  const int lt = blockIdx.x;  // window-local tile (see composite_fwd.cu)
  const int tile = tile_lo + lt;
  const int t = threadIdx.x;
  if (tile >= n_tiles) {  // the window's pad: zero partials
    if (t < 12) psum[(size_t)lt * 12 + t] = 0.0f;
    return;
  }
  const int pix = tile_pixel(t / 32, t % 32);
  const int x0 = (tile % tiles_x) * TILE, y0 = (tile / tiles_x) * TILE;
  const float px = (float)(x0 + pix % TILE);
  const float py = (float)(y0 + pix / TILE);
  const int start = tile_start[lt];
  const int count = tile_count[lt];

  float dC[NC];
  float cdc = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const size_t o = ((size_t)lt * NC + c) * PIX + pix;
    dC[c] = dacc[o];
    cdc += acc[o] * dC[c];
  }
  const float tail = dtfin[(size_t)lt * PIX + pix] * tfin[(size_t)lt * PIX + pix];

  float s[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) s[k] = 0.0f;
  float T = 1.0f;
  float A = 0.0f;
  int done = 0, kept = 0, walked = 0;
  for (int base = 0; base < count; base += PIX) {
    if (__syncthreads_count(done) == PIX) break;
    const int n = min(PIX, count - base);
    kept += load_batch(packed, ld, pair_gauss + start + base, n, x0, y0, s_row, s_mask, s_g);
    if (t < n) {  // s_g[t] and s_row[.][t] were written by this thread
      const float4* jac = reinterpret_cast<const float4*>(packed + (size_t)s_g[t] * ld + 16);
#pragma unroll
      for (int k = 0; k < NJ; ++k) s_jac[k][t] = __ldg(jac + k);
      const float gx = s_row[0][t].x, gy = s_row[0][t].y, z = s_row[2][t].y;
      const float p_w = 1.0f / (z + 1e-7f);
      s_dxy[t] = make_float4(fx * p_w, fy * p_w, p_w * (bx - gx), p_w * (by - gy));
    }
    __syncthreads();
    walked += walk_batch(s_row, s_mask, n, px, py, done, [&](int i, const Pair& p) {
      if (done || !p.hit) return;
      const float test_T = T * (1.0f - p.alpha);
      if (test_T < 1e-4f) {
        done = 1;
        return;
      }
      const float c0 = p.f[F_C0], c1 = p.f[F_C1], c2 = p.f[F_C2];
      const float dx = p.dx, dy = p.dy, alpha = p.alpha;
      const float w = alpha * T;
      float fdc = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) fdc += p.f[F_FEAT + c] * dC[c];
      A += w * fdc;
      const float dalpha = T * fdc - (cdc - A + tail) / (1.0f - alpha);
      const float dpower = p.f[F_OP] * (p.expp * dalpha);
      const float dxy_x = -(c0 * dx + c1 * dy) * dpower;
      const float dxy_y = -(c2 * dy + c1 * dx) * dpower;
      const float dc0 = -0.5f * dx * dx * dpower;
      const float dc1 = -dx * dy * dpower;
      const float dc2 = -0.5f * dy * dy * dpower;
      float dz = w * dC[3];
      if constexpr (NC == 6) dz += 2.0f * p.f[F_FEAT + 3] * (w * dC[5]);
      // rows 16-27: j0 = J0..J3, j1 = J4..J7, j2 = (J8, mean_world)
      const float4 k = s_dxy[i], j0 = s_jac[0][i], j1 = s_jac[1][i], j2 = s_jac[2][i];
      const float dm_x = dxy_x * k.x + dc0 * j0.x + dc1 * j0.w + dc2 * j1.z;
      const float dm_y = dxy_y * k.y + dc0 * j0.y + dc1 * j1.x + dc2 * j1.w;
      const float dm_z = dxy_x * k.z + dxy_y * k.w + dc0 * j0.z + dc1 * j1.y + dc2 * j2.x + dz;
      s[0] += dm_x;
      s[1] += dm_y;
      s[2] += dm_z;
      s[3] += dm_x * j2.y; s[4] += dm_x * j2.z; s[5] += dm_x * j2.w;
      s[6] += dm_y * j2.y; s[7] += dm_y * j2.z; s[8] += dm_y * j2.w;
      s[9] += dm_z * j2.y; s[10] += dm_z * j2.z; s[11] += dm_z * j2.w;
      T = test_T;
    });
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const float v = warp_sum(s[k]);
    if (t % 32 == 0) s_red[t / 32][k] = v;
  }
  __syncthreads();
  if (t < 12) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) v += s_red[w][t];
    psum[(size_t)lt * 12 + t] = v;
  }
  add_work(work, kept, walked);
}

template <int NC>
static void launch(const float* packed, int ld, const int* pair_gauss,
                   const int* tile_start, const int* tile_count, int tile_lo,
                   int n_local, int n_tiles, int tiles_x, const float* acc,
                   const float* tfin, const float* dacc, const float* dtfin,
                   float fx, float fy, float bx, float by, float* psum,
                   unsigned long long* work, cudaStream_t s) {
  composite_pose_bwd_kernel<NC><<<n_local, PIX, 0, s>>>(
      packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_tiles, tiles_x,
      acc, tfin, dacc, dtfin, fx, fy, bx, by, psum, work);
}

// packed is [N, ld] with ld >= 28; psum has n_local rows; packed, the
// window and work as for mm3dgs_composite_fwd. Returns cudaGetLastError().
extern "C" int mm3dgs_composite_pose_bwd(
    const float* packed, int ld, const int* pair_gauss, const int* tile_start,
    const int* tile_count, int tile_lo, int n_local, int n_tiles, int tiles_x,
    int nc, const float* acc,
    const float* tfin, const float* dacc, const float* dtfin, float fx,
    float fy, float bx, float by, float* psum, unsigned long long* work,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (nc) {  // tracking: nc 5; render_tiles_pose's default: 6
    case 5: launch<5>(packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_local, n_tiles, tiles_x, acc, tfin, dacc, dtfin, fx, fy, bx, by, psum, work, s); break;
    case 6: launch<6>(packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_local, n_tiles, tiles_x, acc, tfin, dacc, dtfin, fx, fy, bx, by, psum, work, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
