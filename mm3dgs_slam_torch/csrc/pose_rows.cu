// Kernel 4: tracking's pose rows, [N, 32] in one launch.
//
// Replaces no Pallas kernel. The JAX package builds the same rows from
// project_gaussians and the three jax.jvp calls of conic_pose_jacobian_rows
// (mm3dgs_slam_tpu/ops/projection.py), which XLA fuses under jit. In eager
// PyTorch that chain (the plain version, ops/projection.py pose_rows_plain)
// is ~850 launches per tracking iteration, so it was written out here.
//
// Row i, for the camera-frame mean m = R(q) xyz_i + T (transform_means_python
// mode: the projection sees w2c = I; sh_degree 0):
//   0-15  project_gaussians' packed row: xy (the projection matrix, ndc2Pix),
//         the EWA conic (1.3 tanfov clamp, +0.3 low-pass, det != 0 guard,
//         tz_safe = 1 for z <= 0.2), opacity, max(C0 sh_dc + 0.5, 0), z, 1,
//         z^2, four zeros;
//   16-24 d(conic_a, b, c)/d(m_x, m_y, m_z), conic-major, in closed form with
//         the branch semantics of forward-mode AD through the plain version:
//         no tangent through tz_safe behind z = 0.2 or through det_safe where
//         det == 0; inside the clamp (limits included, torch's clamp rule)
//         d tx/d t_x = 1 and d tx/d tz = 0, outside it tx = +-lim tz;
//   25-27 the world-frame mean; 28-31 zero.
//
// Bound on an H100: bytes. A row reads 56 B (xyz, scales, rotation,
// opacity, the DC colour) and writes 128 B: 56.5 MB at 307,200 rows, 16.9 us
// at 3.35 TB/s. One thread per Gaussian keeps every intermediate in
// registers; the camera's 3x3 is computed once per block into shared memory.
// A row written by one thread would be 32 strided stores, so each warp stages
// its 32 rows in shared memory (4 KB; a row's float4 slot j sits at j ^ (row
// & 7), so neither the staging stores nor the reads back conflict on banks)
// and writes them as 256 contiguous float4s.
//
// The pixel coordinates, and what feeds them (the pose's rotation, the
// camera-frame mean), round each product and sum on its own, as the plain
// version's separate PyTorch ops do (mul/add below): near pixel 0, ndc2Pix's
// (x + 1) * width - 1 cancels, and an FMA's one rounding fewer moves it by
// ~1e-4, five times IMG_TOL's atol. Everything else may contract.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int NWARP = BLOCK / 32;
constexpr int ROW4 = 8;  // float4s in a 32-float row

struct Cam {
  float fx, fy, limx, limy;  // focal lengths, 1.3 tanfov
  float p00, p02, p11, p12;  // the projection matrix's nonzero xy entries
  float width, height;
};

struct Conic {
  float a, b, c;
};

// a product and a sum that nvcc does not contract into an FMA
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// r0 a + r1 b + r2 c + t, summed left to right as render.means_cam_soa does
__device__ __forceinline__ float affine(float a, float b, float c, const float* r, float t) {
  return add(add(add(mul(a, r[0]), mul(b, r[1])), mul(c, r[2])), t);
}

// torch.clamp's value: NaN passes through
__device__ __forceinline__ float clampf(float v, float lim) {
  return v < -lim ? -lim : (v > lim ? lim : v);
}

// The 2D covariance's tangent, and from it the conic's, along the tangent
// (dtx, dty, dtz) of the clamped (tx, ty) and tz_safe.
struct Ewa {
  float fx, fy;
  float s00, s01, s02, s11, s12, s22;  // Sigma's upper triangle
  float tx, ty, inv_z, inv_z2;
  float J00, J02, J11, J12;
  float c00, c01, c11, inv_det;
  bool det_ok;

  __device__ __forceinline__ Conic tangent(float dtx, float dty, float dtz) const {
    const float dinv_z = -(inv_z * inv_z) * dtz;
    const float dinv_z2 = 2.0f * inv_z * dinv_z;
    const float dJ00 = fx * dinv_z;
    const float dJ11 = fy * dinv_z;
    const float dJ02 = -fx * (dtx * inv_z2 + tx * dinv_z2);
    const float dJ12 = -fy * (dty * inv_z2 + ty * dinv_z2);
    const float dc00 = 2.0f * J00 * dJ00 * s00 + 2.0f * J02 * dJ02 * s22 +
                       2.0f * (dJ00 * J02 + J00 * dJ02) * s02;
    const float dc11 = 2.0f * J11 * dJ11 * s11 + 2.0f * J12 * dJ12 * s22 +
                       2.0f * (dJ11 * J12 + J11 * dJ12) * s12;
    const float dc01 = (dJ02 * J12 + J02 * dJ12) * s22 + (dJ00 * J11 + J00 * dJ11) * s01 +
                       (dJ00 * J12 + J00 * dJ12) * s02 + (dJ02 * J11 + J02 * dJ11) * s12;
    const float ddet = det_ok ? dc00 * c11 + c00 * dc11 - 2.0f * c01 * dc01 : 0.0f;
    const float dinv_det = -ddet * (inv_det * inv_det);
    return {dc11 * inv_det + c11 * dinv_det, -(dc01 * inv_det + c01 * dinv_det),
            dc00 * inv_det + c00 * dinv_det};
  }
};

// One row (see the head of the file). R, t: the camera pose, R row-major.
__device__ __forceinline__ void pose_row(const float* R, const float* t, float wx, float wy,
                                         float wz, float s0, float s1, float s2, float qr,
                                         float qx, float qy, float qz, float op, float d0,
                                         float d1, float d2, const Cam& cam, float* r) {
  // render.means_cam_soa
  const float mx = affine(wx, wy, wz, R, t[0]);
  const float my = affine(wx, wy, wz, R + 3, t[1]);
  const float mz = affine(wx, wy, wz, R + 6, t[2]);

  // projection._cov3d_components: the Gaussian's rotation, normalized with
  // its norm clamped at 1e-12
  Ewa e;
  float qn = sqrtf(qr * qr + qx * qx + qy * qy + qz * qz);
  qn = qn < 1e-12f ? 1e-12f : qn;
  const float w = qr / qn, x = qx / qn, y = qy / qn, z = qz / qn;
  const float g[9] = {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - w * z),
                      2.0f * (x * z + w * y),        2.0f * (x * y + w * z),
                      1.0f - 2.0f * (x * x + z * z), 2.0f * (y * z - w * x),
                      2.0f * (x * z - w * y),        2.0f * (y * z + w * x),
                      1.0f - 2.0f * (x * x + y * y)};
  const float a0 = s0 * s0, a1 = s1 * s1, a2 = s2 * s2;
#define SIGMA(i, j) \
  (g[3 * i] * g[3 * j] * a0 + g[3 * i + 1] * g[3 * j + 1] * a1 + g[3 * i + 2] * g[3 * j + 2] * a2)
  e.s00 = SIGMA(0, 0);
  e.s01 = SIGMA(0, 1);
  e.s02 = SIGMA(0, 2);
  e.s11 = SIGMA(1, 1);
  e.s12 = SIGMA(1, 2);
  e.s22 = SIGMA(2, 2);
#undef SIGMA

  // projection._conic_soa at w2c = I
  const bool in_front = mz > 0.2f;
  const float tzs = in_front ? mz : 1.0f;
  const float ux = mx / tzs, uy = my / tzs;
  const float cux = clampf(ux, cam.limx), cuy = clampf(uy, cam.limy);
  const bool inx = ux >= -cam.limx && ux <= cam.limx;
  const bool iny = uy >= -cam.limy && uy <= cam.limy;
  e.fx = cam.fx;
  e.fy = cam.fy;
  e.tx = cux * tzs;
  e.ty = cuy * tzs;
  e.inv_z = 1.0f / tzs;
  e.inv_z2 = e.inv_z * e.inv_z;
  e.J00 = cam.fx * e.inv_z;
  e.J02 = -cam.fx * e.tx * e.inv_z2;
  e.J11 = cam.fy * e.inv_z;
  e.J12 = -cam.fy * e.ty * e.inv_z2;
  e.c00 = (e.J00 * e.J00 * e.s00 + e.J02 * e.J02 * e.s22) +
          (e.J00 * e.J02 + e.J02 * e.J00) * e.s02 + 0.3f;
  e.c01 = e.J02 * e.J12 * e.s22 + e.J00 * e.J11 * e.s01 + e.J00 * e.J12 * e.s02 +
          e.J02 * e.J11 * e.s12;
  e.c11 = (e.J11 * e.J11 * e.s11 + e.J12 * e.J12 * e.s22) +
          (e.J11 * e.J12 + e.J12 * e.J11) * e.s12 + 0.3f;
  const float det = e.c00 * e.c11 - e.c01 * e.c01;
  e.det_ok = det != 0.0f;
  e.inv_det = 1.0f / (e.det_ok ? det : 1.0f);

  // the tangents along m_x, m_y, m_z: tx's is 1 along m_x inside the clamp,
  // +-lim tz's outside; tz_safe's is 0 behind z = 0.2
  const float dz = in_front ? 1.0f : 0.0f;
  const Conic jx = e.tangent(inx ? 1.0f : 0.0f, 0.0f, 0.0f);
  const Conic jy = e.tangent(0.0f, iny ? 1.0f : 0.0f, 0.0f);
  const Conic jz = e.tangent(inx ? 0.0f : cux * dz, iny ? 0.0f : cuy * dz, dz);

  // project_gaussians: ndc2Pix of the projected mean
  const float p_w = 1.0f / add(mz, 1e-7f);
  const float ph_x = add(mul(mx, cam.p00), mul(mz, cam.p02));
  const float ph_y = add(mul(my, cam.p11), mul(mz, cam.p12));
  r[0] = add(mul(add(mul(ph_x, p_w), 1.0f), cam.width), -1.0f) * 0.5f;
  r[1] = add(mul(add(mul(ph_y, p_w), 1.0f), cam.height), -1.0f) * 0.5f;
  r[2] = e.c11 * e.inv_det;
  r[3] = -e.c01 * e.inv_det;
  r[4] = e.c00 * e.inv_det;
  r[5] = op;
  const float C0 = 0.28209479177387814f;
  const float d[3] = {d0, d1, d2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = C0 * d[c] + 0.5f;
    r[6 + c] = v < 0.0f ? 0.0f : v;  // torch.clamp(min=0): NaN passes through
  }
  r[9] = mz;
  r[10] = 1.0f;
  r[11] = mz * mz;
  const Conic jac[3] = {jx, jy, jz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r[16 + k] = jac[k].a;
    r[19 + k] = jac[k].b;
    r[22 + k] = jac[k].c;
  }
  r[25] = wx;
  r[26] = wy;
  r[27] = wz;
#pragma unroll
  for (int k = 12; k < 16; ++k) r[k] = 0.0f;
#pragma unroll
  for (int k = 28; k < 32; ++k) r[k] = 0.0f;
}

__global__ void __launch_bounds__(BLOCK)
pose_rows_kernel(const float* __restrict__ xyz, const float* __restrict__ scales, int iso,
                 const float* __restrict__ rot, const float* __restrict__ opacity,
                 const float* __restrict__ shs, int sh_ld, const float* __restrict__ q,
                 const float* __restrict__ T, int n, Cam cam, float4* __restrict__ out) {
  __shared__ float s_pose[12];  // R row-major, then T
  __shared__ float4 s_rows[NWARP][32 * ROW4];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  if (t == 0) {  // pose.quat_to_rotmat: normalized, no clamp
    const float qn = sqrtf(add(add(add(mul(q[0], q[0]), mul(q[1], q[1])), mul(q[2], q[2])),
                               mul(q[3], q[3])));
    const float w = q[0] / qn, x = q[1] / qn, y = q[2] / qn, z = q[3] / qn;
    // 1 - 2 (a a + b b) and 2 (a b +- c d); a product by 2 is exact
    const auto diag = [](float a, float b) { return add(1.0f, -2.0f * add(mul(a, a), mul(b, b))); };
    const auto off = [](float a, float b, float c, float d) {
      return 2.0f * add(mul(a, b), mul(c, d));
    };
    s_pose[0] = diag(y, z);
    s_pose[1] = off(x, y, -w, z);
    s_pose[2] = off(x, z, w, y);
    s_pose[3] = off(x, y, w, z);
    s_pose[4] = diag(x, z);
    s_pose[5] = off(y, z, -w, x);
    s_pose[6] = off(x, z, -w, y);
    s_pose[7] = off(y, z, w, x);
    s_pose[8] = diag(x, y);
    s_pose[9] = T[0];
    s_pose[10] = T[1];
    s_pose[11] = T[2];
  }
  __syncthreads();
  const int i = blockIdx.x * BLOCK + t;
  float r[32];
  if (i < n) {
    const size_t i3 = (size_t)i * 3, i4 = (size_t)i * 4, ish = (size_t)i * sh_ld;
    const float s0 = scales[i3];
    pose_row(s_pose, s_pose + 9, xyz[i3], xyz[i3 + 1], xyz[i3 + 2], s0,
             iso ? s0 : scales[i3 + 1], iso ? s0 : scales[i3 + 2], rot[i4], rot[i4 + 1],
             rot[i4 + 2], rot[i4 + 3], opacity[i], shs[ish], shs[ish + 1], shs[ish + 2], cam, r);
  } else {  // staged, never stored
#pragma unroll
    for (int k = 0; k < 32; ++k) r[k] = 0.0f;
  }
  float4* rows = s_rows[warp];
#pragma unroll
  for (int j = 0; j < ROW4; ++j)
    rows[lane * ROW4 + (j ^ (lane & 7))] =
        make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
  __syncwarp();
  const int row0 = blockIdx.x * BLOCK + warp * 32;
#pragma unroll
  for (int k = 0; k < ROW4; ++k) {
    const int o = k * 32 + lane;  // the warp's o-th float4
    const int row = o / ROW4, j = o % ROW4;
    if (row0 + row < n) out[(size_t)(row0 + row) * ROW4 + j] = rows[row * ROW4 + (j ^ (row & 7))];
  }
}

}  // namespace

// xyz, scales [n, 3] (only column 0 read where iso), rot [n, 4], opacity
// [n], shs [n, K, 3] with K * 3 = sh_ld (the DC row read), q [4], T [3];
// out [n, 32], 16-B aligned. n 0 launches nothing. Returns
// cudaGetLastError().
extern "C" int mm3dgs_pose_rows(const float* xyz, const float* scales, int iso,
                                const float* rot, const float* opacity, const float* shs,
                                int sh_ld, const float* q, const float* T, int n, float fx,
                                float fy, float limx, float limy, float p00, float p02,
                                float p11, float p12, float width, float height, float* out,
                                void* stream) {
  if (n <= 0) return 0;
  const Cam cam{fx, fy, limx, limy, p00, p02, p11, p12, width, height};
  pose_rows_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      xyz, scales, iso, rot, opacity, shs, sh_ld, q, T, n, cam, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}
