// Kernel 2: tile compositing backward for mapping (per-gaussian gradients).
//
// Replaces the TPU kernel `_bwd_kernel` (mm3dgs_slam_tpu/ops/
// pallas_composite.py, called through `_composite_pallas_bwd_rows`) together
// with the XLA slot-table reduce `_table_reduce` that followed it: from dacc
// and dtfin it gives dpacked [N, 16], the gradient of every gaussian's packed
// row (xy, conic, opacity and the nc walked features; the other columns
// stay zero). The xy columns are included because densification reads them.
//
// Route: the front-to-back replay with a prefix accumulator, as the TPU
// kernel's `_chunk_gradient` does. Each pixel re-walks the forward and keeps
// A_j = sum_{k<=j} w_k (f_k . dC), so that
//   dL/dalpha_j = T_j (f_j . dC) - ((C . dC) - A_j + dT_fin T_fin) / (1 - alpha_j)
// with C = acc the pixel's composite. The 0.99 clamp is straight-through.
//
// Bound on an H100: operations. Besides the forward walk, each used
// pixel-pair costs ~40 more f32 operations, and each pair's 6 + nc field
// gradients are summed over the tile's 256 pixels: warp shuffles, then the
// 8 warp partials in shared memory, then one atomicAdd per field per pair
// into dpacked. The design groups 32 pairs per shared-memory reduction (two
// barriers per group), skips the shuffles of a warp where no lane used the
// pair, and adds no zero. Float atomics add in no fixed order, so dpacked is
// not bit-identical from run to run.
#include "composite_common.cuh"

using namespace mm3dgs;

constexpr int GROUP = 32;  // pairs per shared-memory reduction

template <int NC>
__global__ void __launch_bounds__(PIX)
composite_bwd_kernel(const float* __restrict__ packed, int ld,
                     const int* __restrict__ pair_gauss,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int tiles_x,
                     const float* __restrict__ acc,
                     const float* __restrict__ tfin,
                     const float* __restrict__ dacc,
                     const float* __restrict__ dtfin,
                     float* __restrict__ dpacked) {
  constexpr int NF = F_FEAT + NC;  // fields read = fields with a gradient
  __shared__ float s_f[NF][PIX];
  __shared__ int s_g[PIX];
  __shared__ float s_red[GROUP][NWARP][NF];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane / 32;
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

  float T = 1.0f;
  float A = 0.0f;
  int done = 0;
  for (int base = 0; base < count; base += PIX) {
    if (__syncthreads_count(done) == PIX) break;
    const int j = base + lane;
    if (j < count) {
      const int g = pair_gauss[start + j];
      s_g[lane] = g;
      const float* row = packed + (size_t)g * ld;
#pragma unroll
      for (int k = 0; k < NF; ++k) s_f[k][lane] = row[k];
    }
    __syncthreads();
    const int n = min(PIX, count - base);
    for (int g0 = 0; g0 < n; g0 += GROUP) {
      const int m = min(GROUP, n - g0);
      for (int ii = 0; ii < m; ++ii) {
        const int i = g0 + ii;
        float v[NF];
#pragma unroll
        for (int k = 0; k < NF; ++k) v[k] = 0.0f;
        bool use = false;
        if (!done) {
          float dx, dy, expp, alpha, test_T;
          const float c0 = s_f[F_C0][i], c1 = s_f[F_C1][i], c2 = s_f[F_C2][i];
          const int st = pair_step(s_f[F_X][i], s_f[F_Y][i], c0, c1, c2,
                                   s_f[F_OP][i], px, py, T, dx, dy, expp,
                                   alpha, test_T);
          if (st == STEP_STOP) done = 1;
          if (st == STEP_USE) {
            use = true;
            const float w = alpha * T;
            float fdc = 0.0f;
#pragma unroll
            for (int c = 0; c < NC; ++c) fdc += s_f[F_FEAT + c][i] * dC[c];
            A += w * fdc;
            const float dalpha = T * fdc - (cdc - A + tail) / (1.0f - alpha);
            const float dop = expp * dalpha;
            const float dpower = s_f[F_OP][i] * dop;
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
        if (__any_sync(0xffffffffu, use)) {
#pragma unroll
          for (int k = 0; k < NF; ++k) v[k] = warp_sum(v[k]);
        }
        if ((lane & 31) == 0) {
#pragma unroll
          for (int k = 0; k < NF; ++k) s_red[ii][warp][k] = v[k];
        }
      }
      __syncthreads();
      for (int item = lane; item < m * NF; item += PIX) {
        const int ii = item / NF;
        const int k = item - ii * NF;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < NWARP; ++w) s += s_red[ii][w][k];
        if (s != 0.0f) atomicAdd(dpacked + (size_t)s_g[g0 + ii] * 16 + k, s);
      }
      __syncthreads();
    }
  }
}

template <int NC>
static void launch(const float* packed, int ld, const int* pair_gauss,
                   const int* tile_start, const int* tile_count, int n_tiles,
                   int tiles_x, const float* acc, const float* tfin,
                   const float* dacc, const float* dtfin, float* dpacked,
                   cudaStream_t s) {
  composite_bwd_kernel<NC><<<n_tiles, PIX, 0, s>>>(
      packed, ld, pair_gauss, tile_start, tile_count, tiles_x, acc, tfin,
      dacc, dtfin, dpacked);
}

// dpacked must be zeroed by the caller. Returns cudaGetLastError().
extern "C" int mm3dgs_composite_bwd(const float* packed, int ld,
                                    const int* pair_gauss,
                                    const int* tile_start,
                                    const int* tile_count, int n_tiles,
                                    int tiles_x, int nc, const float* acc,
                                    const float* tfin, const float* dacc,
                                    const float* dtfin, float* dpacked,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (nc) {  // mapping: nc 3, or 4 with the depth-estimate loss
    case 3: launch<3>(packed, ld, pair_gauss, tile_start, tile_count, n_tiles, tiles_x, acc, tfin, dacc, dtfin, dpacked, s); break;
    case 4: launch<4>(packed, ld, pair_gauss, tile_start, tile_count, n_tiles, tiles_x, acc, tfin, dacc, dtfin, dpacked, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
