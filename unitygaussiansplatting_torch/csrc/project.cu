// The splat projection: world-space Gaussians -> screen-space view data.
//
// Replaces no TPU kernel: the TPU package's projection
// (unitygaussiansplatting_tpu/ops/projection.py:project_splats) is XLA,
// which fuses it into a few loops; the port had kept it as ~350 eager
// PyTorch launches, each an elementwise pass over the splats with its
// intermediates in device memory.  Two kernels, one thread per splat, keep
// every intermediate in registers:
//
//   project_geom: means, rotation, scale -> view position, depth, valid (and
//     not killed), pixel center, Sigma = (R S)(R S)^T scaled by splat_scale^2,
//     the clamped EWA Jacobian, the 0.3 low-pass, the screen axes and the
//     conic; written as the planar rows of one (10, N) buffer: depth, cx, cy,
//     a1x, a1y, a2x, a2y, conic a, b, c; plus the (N,) valid bytes.
//   project_sh: the normalised view direction (through inv_model_rot when a
//     model matrix is given), SH bands 0-3, the clamp at 0, the opacity
//     scale and clamp, the fp16 round trip; written as a (4, N) buffer: r, g,
//     b, opacity.  A block of 128 splats stages its 128 x 180 B of
//     interleaved SH into shared memory with 16-byte loads (the rows are
//     contiguous, and a block's run starts 16-byte aligned), so no thread
//     walks 45 scalar loads at a 180-byte stride; planar or strided SH is read
//     in place.
//
// Bound on the H100 by bytes: 40 read and 41 written a splat (geometry), 208
// read and 16 written (shading); the ~300 instructions a splat hide under
// them.  The view matrices, the camera position and the model's inverse
// rotation are read from device memory (the same address in every thread),
// never copied to the host.
//
// Every value rounds like the plain PyTorch version (ops/projection.py,
// ops/covariance.py, ops/sh.py) on the card, bit for bit: the same
// operations in the same order, float32 throughout; build with --fmad=false
// and without --use_fast_math; IEEE divisions and sqrtf (a tensor divided by
// a tensor; `1.0 / t` is torch.reciprocal, also a division); clamp and
// torch.where propagate NaN as PyTorch's do; constants are the float
// rounding of the same double literals (a Python float multiplies a float32
// tensor as its float rounding); the three-term sum of the view direction's
// squares is added in the order torch.sum's reduction takes on the card,
// (x0 + x2) + x1.  The model's inverse rotation of the view direction is a
// cuBLAS product in the plain version (`view_dir @ inv_model_rot.T`): the
// library's kernel forms each output as fma(d2, m2, fma(d1, m1, d0 m0)),
// which this kernel repeats; the card tests' model scene holds the two equal,
// since a library may pick another kernel elsewhere.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGeomThreads = 256;
constexpr int kShThreads = 128;
constexpr int kShFloats = 45;  // 15 coefficients x 3 channels of one splat

constexpr int kShOnly = 1;
constexpr int kFp16Color = 2;
constexpr int kShStaged = 4;   // interleaved, contiguous (N, 15, 3), 16-byte aligned
constexpr int kHasModel = 8;

constexpr float kLowPass = (float)0.3;
constexpr float kMinLambda = (float)0.1;
constexpr float kMaxAxisLen = 4096.0f;
constexpr float kOpacityClamp = 65000.0f;

constexpr float kShC1 = (float)0.4886025;
constexpr float kShC20 = (float)1.0925484, kShC21 = (float)-1.0925484, kShC22 = (float)0.3153916;
constexpr float kShC23 = (float)-1.0925484, kShC24 = (float)0.5462742;
constexpr float kShC30 = (float)-0.5900436, kShC31 = (float)2.8906114, kShC32 = (float)-0.4570458;
constexpr float kShC33 = (float)0.3731763, kShC34 = (float)-0.4570458, kShC35 = (float)1.4453057;
constexpr float kShC36 = (float)-0.5900436;

// torch.clamp: NaN in, NaN out.
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp_max(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float f16_round(float x) { return __half2float(__float2half_rn(x)); }

// A (rows, cols) float32 matrix in device memory at element strides.
struct Mat {
  const float* p;
  long long s0, s1;
  __device__ __forceinline__ float operator()(int r, int c) const { return __ldg(p + r * s0 + c * s1); }
};

// ops.projection.affine: ((x m0 + y m1) + z m2) + m3 for each of the 3 rows.
__device__ __forceinline__ void affine(const Mat& m, float x, float y, float z, float out[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) out[r] = x * m(r, 0) + y * m(r, 1) + z * m(r, 2) + m(r, 3);
}

struct GeomIn {
  const float *means, *rot, *scales;
  const unsigned char* kill;  // null: no kill mask
  long long ms0, ms1, rs0, rs1, ss0, ss1, ks0;
  Mat mv;
};

struct GeomScalars {
  float tan_fovx, tan_fovy, lim_x, lim_y, focal, neg_focal, width, height, splat_scale2;
};

__global__ void __launch_bounds__(kGeomThreads)
project_geom_kernel(GeomIn in, int n, GeomScalars s, float* __restrict__ out,
                    unsigned char* __restrict__ valid) {
  const long long i = (long long)blockIdx.x * kGeomThreads + threadIdx.x;
  if (i >= n) return;
  const float px = in.means[i * in.ms0], py = in.means[i * in.ms0 + in.ms1];
  const float pz = in.means[i * in.ms0 + 2 * in.ms1];
  float v[3];
  affine(in.mv, px, py, pz, v);
  const float depth = v[2];
  bool ok = depth > (float)1e-8;
  if (in.kill != nullptr) ok = ok && in.kill[i * in.ks0] == 0;

  // Camera.view_to_pixel.
  const float ndc_x = v[0] / (v[2] * s.tan_fovx);
  const float ndc_y = v[1] / (v[2] * s.tan_fovy);
  const float cx = (ndc_x * 0.5f + 0.5f) * s.width;
  const float cy = (0.5f - ndc_y * 0.5f) * s.height;

  // covariance.project_covariance_planar: R rows (GaussianSplatting.hlsl:36-44).
  const float x = in.rot[i * in.rs0], y = in.rot[i * in.rs0 + in.rs1];
  const float z = in.rot[i * in.rs0 + 2 * in.rs1], w = in.rot[i * in.rs0 + 3 * in.rs1];
  const float s0 = in.scales[i * in.ss0], s1 = in.scales[i * in.ss0 + in.ss1];
  const float s2 = in.scales[i * in.ss0 + 2 * in.ss1];
  const float r00 = 1.0f - 2.0f * (y * y + z * z);
  const float r01 = 2.0f * (x * y - w * z);
  const float r02 = 2.0f * (x * z + w * y);
  const float r10 = 2.0f * (x * y + w * z);
  const float r11 = 1.0f - 2.0f * (x * x + z * z);
  const float r12 = 2.0f * (y * z - w * x);
  const float r20 = 2.0f * (x * z - w * y);
  const float r21 = 2.0f * (y * z + w * x);
  const float r22 = 1.0f - 2.0f * (x * x + y * y);
  // M = R diag(s); Sigma = M M^T, scaled by splat_scale^2.
  const float m00 = r00 * s0, m01 = r01 * s1, m02 = r02 * s2;
  const float m10 = r10 * s0, m11 = r11 * s1, m12 = r12 * s2;
  const float m20 = r20 * s0, m21 = r21 * s1, m22 = r22 * s2;
  const float ss2 = s.splat_scale2;
  const float vxx = (m00 * m00 + m01 * m01 + m02 * m02) * ss2;
  const float vxy = (m00 * m10 + m01 * m11 + m02 * m12) * ss2;
  const float vxz = (m00 * m20 + m01 * m21 + m02 * m22) * ss2;
  const float vyy = (m10 * m10 + m11 * m11 + m12 * m12) * ss2;
  const float vyz = (m10 * m20 + m11 * m21 + m12 * m22) * ss2;
  const float vzz = (m20 * m20 + m21 * m21 + m22 * m22) * ss2;

  // EWA Jacobian with the 1.3x frustum clamp (hlsl:56-90).
  const float zc = v[2];
  const float tx = clamp(v[0] / zc, -s.lim_x, s.lim_x) * zc;
  const float ty = clamp(v[1] / zc, -s.lim_y, s.lim_y) * zc;
  const float inv_z = 1.0f / zc;
  const float inv_z2 = inv_z * inv_z;
  const float j00 = s.focal * inv_z;
  const float j02 = s.neg_focal * tx * inv_z2;
  const float j12 = s.neg_focal * ty * inv_z2;
  const Mat& vr = in.mv;
  const float t00 = j00 * vr(0, 0) + j02 * vr(2, 0);
  const float t01 = j00 * vr(0, 1) + j02 * vr(2, 1);
  const float t02 = j00 * vr(0, 2) + j02 * vr(2, 2);
  const float t10 = j00 * vr(1, 0) + j12 * vr(2, 0);
  const float t11 = j00 * vr(1, 1) + j12 * vr(2, 1);
  const float t12 = j00 * vr(1, 2) + j12 * vr(2, 2);
  auto quad = [&](float a0, float a1, float a2, float b0, float b1, float b2) {
    return a0 * (vxx * b0 + vxy * b1 + vxz * b2) + a1 * (vxy * b0 + vyy * b1 + vyz * b2) +
           a2 * (vxz * b0 + vyz * b1 + vzz * b2);
  };
  const float cxx = quad(t00, t01, t02, t00, t01, t02) + kLowPass;
  const float cyy = quad(t10, t11, t12, t10, t11, t12) + kLowPass;
  const float cxy = -quad(t00, t01, t02, t10, t11, t12);  // y-up NDC -> y-down pixels

  // covariance._decompose (SplatUtilities.compute:147-159).
  const float mid = 0.5f * (cxx + cyy);
  const float half = (cxx - cyy) * 0.5f;
  const float radius = sqrtf(clamp_min(half * half + cxy * cxy, (float)1e-24));
  const float lam1 = mid + radius;
  const float lam2 = clamp_min(mid - radius, kMinLambda);
  const float vx = cxy, vy = lam1 - cxx;
  const float norm = sqrtf(clamp_min(vx * vx + vy * vy, (float)1e-30));
  const bool dir_ok = norm > (float)1e-12;
  const float nrm = clamp_min(norm, (float)1e-12);
  const float vxn = dir_ok ? vx / nrm : 1.0f;
  const float vyn = dir_ok ? vy / nrm : 0.0f;
  const float len1 = clamp_max(sqrtf(2.0f * lam1), kMaxAxisLen);
  const float len2 = clamp_max(sqrtf(2.0f * lam2), kMaxAxisLen);

  // The conic (projection.project_splats).
  const float det = cxx * cyy - cxy * cxy;
  const float inv_det = 1.0f / clamp_min(det, (float)1e-12);

  const float rows[10] = {depth, cx, cy, len1 * vxn, len1 * vyn, len2 * vyn, -(len2 * vxn),
                          cyy * inv_det, -cxy * inv_det, cxx * inv_det};
#pragma unroll
  for (int r = 0; r < 10; ++r) out[r * (long long)n + i] = rows[r];
  valid[i] = ok ? 1 : 0;
}

struct ShIn {
  const float *means, *base, *opacity;
  const float* sh[3];  // per channel; coefficient k of splat i at sh[c][i * sh_s0[c] + k * sh_s1[c]]
  long long ms0, ms1, bs0, bs1, os0, sh_s0[3], sh_s1[3], ps0;
  const float* cam_pos;
  Mat model, inv_rot;  // used under kHasModel
};

__global__ void __launch_bounds__(kShThreads)
project_sh_kernel(ShIn in, int n, int sh_order, int flags, float opacity_scale, float* __restrict__ out) {
  __shared__ __align__(16) float stage[kShThreads * kShFloats];
  const long long first = (long long)blockIdx.x * kShThreads;
  const long long i = first + threadIdx.x;
  const bool staged = (flags & kShStaged) && sh_order > 0;
  if (staged) {
    // The block's contiguous run of interleaved SH, 16 bytes a load.
    const int total = (int)min((long long)kShThreads, n - first) * kShFloats;
    const float* src = in.sh[0] + first * kShFloats;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(stage);
    for (int j = threadIdx.x; j < total / 4; j += kShThreads) dst4[j] = __ldcs(src4 + j);
    for (int j = (total / 4) * 4 + threadIdx.x; j < total; j += kShThreads) stage[j] = __ldcs(src + j);
    __syncthreads();
  }
  if (i >= n) return;

  const bool sh_only = flags & kShOnly;
  float res[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) res[c] = sh_only ? 0.5f : in.base[i * in.bs0 + c * in.bs1];

  if (sh_order >= 1) {
    // View-dependent color: direction camera -> splat in object space.
    const float mx = in.means[i * in.ms0], my = in.means[i * in.ms0 + in.ms1];
    const float mz = in.means[i * in.ms0 + 2 * in.ms1];
    float wp[3] = {mx, my, mz};
    if (flags & kHasModel) affine(in.model, mx, my, mz, wp);
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = wp[k] - __ldg(in.cam_pos + k * in.ps0);
    if (flags & kHasModel) {
      // view_dir @ inv_model_rot.T: cuBLAS's fused multiply-add chain.
      float e[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        e[r] = fmaf(d[2], in.inv_rot(r, 2), fmaf(d[1], in.inv_rot(r, 1), d[0] * in.inv_rot(r, 0)));
      d[0] = e[0], d[1] = e[1], d[2] = e[2];
    }
    // torch.sum over a last dim of 3 on the card: (x0 + x2) + x1.
    const float sq = (d[0] * d[0] + d[2] * d[2]) + d[1] * d[1];
    const float len = sqrtf(clamp_min(sq, (float)1e-24));
    const float x = d[0] / len, y = d[1] / len, z = d[2] / len;

    auto coef = [&](int k, int c) -> float {
      return staged ? stage[threadIdx.x * kShFloats + k * 3 + c] : in.sh[c][i * in.sh_s0[c] + k * in.sh_s1[c]];
    };
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    const float b2[5] = {kShC20 * xy, kShC21 * yz, kShC22 * (2.0f * zz - xx - yy), kShC23 * xz,
                         kShC24 * (xx - yy)};
    const float b3[7] = {kShC30 * y * (3.0f * xx - yy),
                         kShC31 * xy * z,
                         kShC32 * y * (4.0f * zz - xx - yy),
                         kShC33 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy),
                         kShC34 * x * (4.0f * zz - xx - yy),
                         kShC35 * z * (xx - yy),
                         kShC36 * x * (xx - 3.0f * yy)};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      res[c] = res[c] + kShC1 * (-coef(0, c) * y + coef(1, c) * z - coef(2, c) * x);
      if (sh_order >= 2) {
        float t = b2[0] * coef(3, c);
#pragma unroll
        for (int k = 1; k < 5; ++k) t = t + b2[k] * coef(3 + k, c);
        res[c] = res[c] + t;
        if (sh_order >= 3) {
          t = b3[0] * coef(8, c);
#pragma unroll
          for (int k = 1; k < 7; ++k) t = t + b3[k] * coef(8 + k, c);
          res[c] = res[c] + t;
        }
      }
    }
  }

  float op = clamp_max(in.opacity[i * in.os0] * opacity_scale, kOpacityClamp);
#pragma unroll
  for (int c = 0; c < 3; ++c) res[c] = clamp_min(res[c], 0.0f);
  if (flags & kFp16Color) {
#pragma unroll
    for (int c = 0; c < 3; ++c) res[c] = f16_round(res[c]);
    op = f16_round(op);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c * (long long)n + i] = res[c];
  out[3 * (long long)n + i] = op;
}

unsigned grid(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" {

const char* project_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

// means (n, 3), rot (n, 4) xyzw, scales (n, 3), the (4, 4) model-view
// matrix and the (n,) kill mask (null: none) at element strides; out
// (10, n) float32 row-major, valid (n,) bytes.  Launches on `stream`;
// returns cudaGetLastError().
int project_geom_launch(const float* means, long long ms0, long long ms1, const float* rot, long long rs0,
                        long long rs1, const float* scales, long long ss0, long long ss1, const float* mv,
                        long long mvs0, long long mvs1, const unsigned char* kill, long long ks0, int n,
                        float tan_fovx, float tan_fovy, float lim_x, float lim_y, float focal, float neg_focal,
                        float width, float height, float splat_scale2, float* out, unsigned char* valid,
                        void* stream) {
  const GeomIn in{means, rot, scales, kill, ms0, ms1, rs0, rs1, ss0, ss1, ks0, Mat{mv, mvs0, mvs1}};
  const GeomScalars s{tan_fovx, tan_fovy, lim_x, lim_y, focal, neg_focal, width, height, splat_scale2};
  project_geom_kernel<<<grid(n, kGeomThreads), kGeomThreads, 0, (cudaStream_t)stream>>>(in, n, s, out, valid);
  return (int)cudaGetLastError();
}

// means (n, 3), base color (n, 3), opacities (n,); SH channel c's
// coefficient k of splat i at sh_c[i * s0_c + k * s1_c] (interleaved SH:
// three offsets into one (n, 15, 3) tensor; under flags & 4 sh0 is that
// tensor, contiguous and 16-byte aligned); the camera position (3,); under
// flags & 8 the (4, 4) model matrix and the (3, 3) inverse model rotation.
// Flags: 1 sh_only, 2 fp16_color, 4 staged SH, 8 model.  out (4, n)
// float32 row-major.  Launches on `stream`; returns cudaGetLastError().
int project_sh_launch(const float* means, long long ms0, long long ms1, const float* base, long long bs0,
                      long long bs1, const float* opacity, long long os0, const float* sh0, long long sh0s0,
                      long long sh0s1, const float* sh1, long long sh1s0, long long sh1s1, const float* sh2,
                      long long sh2s0, long long sh2s1, const float* cam_pos, long long ps0, const float* model,
                      long long mds0, long long mds1, const float* inv_rot, long long irs0, long long irs1, int n,
                      int sh_order, int flags, float opacity_scale, float* out, void* stream) {
  const ShIn in{means, base, opacity, {sh0, sh1, sh2}, ms0, ms1, bs0, bs1, os0, {sh0s0, sh1s0, sh2s0},
                {sh0s1, sh1s1, sh2s1}, ps0, cam_pos, Mat{model, mds0, mds1}, Mat{inv_rot, irs0, irs1}};
  project_sh_kernel<<<grid(n, kShThreads), kShThreads, 0, (cudaStream_t)stream>>>(in, n, sh_order, flags,
                                                                                  opacity_scale, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
