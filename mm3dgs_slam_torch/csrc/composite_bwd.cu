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
// Bound on an H100: instruction issue and shuffles, not bytes. Besides the
// forward walk, each used pixel-pair costs ~40 more f32 operations, and each
// pair's 6 + nc field gradients are summed over the pixels that used it. The
// walk is kernel 1's warp-culled one (composite_common.cuh: an 8x4 pixel box
// per warp, a warp visits only the pairs its box may use, two at a time).
// There is no block-level reduction: a warp where a lane used the pair sums
// the 6 + nc gradients over its lanes and adds them straight into the
// pair's dpacked row with global atomics. The sum is a reduce-scatter (16
// shuffles for all fields, against 5 per field for a butterfly: the SM
// shuffles one warp-instruction per clock), after which lane 2k holds field
// k and the lanes add their fields in one scalar atomic instruction. The
// only barriers are the two per batch load. Float atomics add in no fixed
// order, so dpacked is not bit-identical from run to run.
#include "composite_common.cuh"

using namespace mm3dgs;

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
composite_bwd_kernel(const float* __restrict__ packed, int ld,
                     const int* __restrict__ pair_gauss,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int tile_lo,
                     int n_tiles, int tiles_x,
                     const float* __restrict__ acc,
                     const float* __restrict__ tfin,
                     const float* __restrict__ dacc,
                     const float* __restrict__ dtfin,
                     float* __restrict__ dpacked,
                     unsigned long long* __restrict__ work) {
  constexpr int NF = F_FEAT + NC;  // fields read = fields with a gradient
  static_assert(NF <= 4 * NV, "the row's float4s read hold the fields");
  __shared__ float4 s_row[NV][PIX];
  __shared__ unsigned char s_mask[PIX];
  __shared__ int s_g[PIX];

  const int lt = blockIdx.x;  // window-local tile (see composite_fwd.cu)
  const int tile = tile_lo + lt;
  if (tile >= n_tiles) return;  // the window's pad: no pairs, no gradient
  const int lane = threadIdx.x % 32;
  const int pix = tile_pixel(threadIdx.x / 32, lane);
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

  float T = 1.0f;
  float A = 0.0f;
  int done = 0, kept = 0, walked = 0;
  for (int base = 0; base < count; base += PIX) {
    if (__syncthreads_count(done) == PIX) break;
    const int n = min(PIX, count - base);
    kept += load_batch(packed, ld, pair_gauss + start + base, n, x0, y0, s_row, s_mask, s_g);
    __syncthreads();
    walked += walk_batch(s_row, s_mask, n, px, py, done, [&](int i, const Pair& p) {
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
      float* dst = dpacked + (size_t)s_g[i] * 16;
      const float sum = warp_reduce_scatter(v, lane);
      if (lane % 2 == 0 && lane / 2 < NF) atomicAdd(dst + lane / 2, sum);
    });
  }
  add_work(work, kept, walked);
}

template <int NC>
static void launch(const float* packed, int ld, const int* pair_gauss,
                   const int* tile_start, const int* tile_count, int tile_lo,
                   int n_local, int n_tiles, int tiles_x, const float* acc,
                   const float* tfin, const float* dacc, const float* dtfin,
                   float* dpacked, unsigned long long* work, cudaStream_t s) {
  composite_bwd_kernel<NC><<<n_local, PIX, 0, s>>>(
      packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_tiles, tiles_x,
      acc, tfin, dacc, dtfin, dpacked, work);
}

// dpacked [N, 16] must be zeroed and 16-B aligned by the caller; the
// window's tiles add into the rows of every Gaussian they walk. packed, the
// window and work as for mm3dgs_composite_fwd. Returns cudaGetLastError().
extern "C" int mm3dgs_composite_bwd(const float* packed, int ld,
                                    const int* pair_gauss,
                                    const int* tile_start,
                                    const int* tile_count, int tile_lo,
                                    int n_local, int n_tiles,
                                    int tiles_x, int nc, const float* acc,
                                    const float* tfin, const float* dacc,
                                    const float* dtfin, float* dpacked,
                                    unsigned long long* work, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (nc) {  // mapping: nc 3, or 4 with the depth-estimate loss
    case 3: launch<3>(packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_local, n_tiles, tiles_x, acc, tfin, dacc, dtfin, dpacked, work, s); break;
    case 4: launch<4>(packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_local, n_tiles, tiles_x, acc, tfin, dacc, dtfin, dpacked, work, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
