// Per-splat table of the pair expansion (K2's operand build).
//
// Replaces the XLA prelude of the TPU package's `bin_and_prepare`
// (unitygaussiansplatting_tpu/ops/pair_expand.py:579-653: tile rects, slot
// counts, depth keys, axis codes, the run bounds, the (16, N) table), which
// the port had kept as a couple of hundred PyTorch launches.  One thread per
// splat reads the projected columns (center, axes, color, opacity, depth,
// valid; never the conic) at any strides and computes, in registers and in
// the plain version's order of operations, the forward values of
//   quantize_view_fp16 (the color / opacity / axis lattices, straight-through
//   x + (q - x) as the plain version adds them), tile_rects, live, the slot
//   count max(pairs, 1) of a live splat (1 for a dead one), quantize_depth
//   and, under pack_axes_u32, the axis codes re-encoded from the
//   straight-through axes (computed twice, as the plain version does),
// then writes K2's table column (14 rows, scrubbed to 0 where not finite),
// the slot count into bounds[1 + i] (bounds[0] = 0: the wrapper's in-place
// torch.cumsum turns the counts into the run bounds; the scan stays a
// library call, as it is one jnp.cumsum outside any Pallas kernel in the
// TPU package) and adds the block's real pair count into num_real (an
// integer block sum and one atomicAdd a block: exact in any order).
//
// Table rows: cx, cy, a1x, a1y, a2x, a2y, r, g, b, opacity (0 unless live),
// x0, y0, nx, depth key; under pack_axes_u32 rows 2/3 hold the codes
// theta*1024 + n1 and n2 and rows 4/5 are 0.  A dead splat gets x0 =
// num_tiles (the sentinel tile), y0 = 0, nx = 1, depth key 0.
//
// Bound on the H100: bytes (45 read and 60 written per splat); the ~600
// instructions a splat of the lattices and rects hide under them.  Every
// value rounds like the plain PyTorch version, bit for bit: build with
// --fmad=false and without --use_fast_math (accurate atan2f, log2f, logf,
// sqrtf, cosf, sinf, exp2f); clamp, minimum and maximum propagate NaN as
// PyTorch's do; torch.round is rintf (half to even); the divisions are IEEE
// (tile_common.true_div), never a reciprocal; constants are the float
// rounding of the same double literals.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

constexpr int kQuadClip = 1;
constexpr int kPackAx32 = 4;
constexpr int kPackAxesF16 = 8;
constexpr int kPackColorF16 = 16;
constexpr int kPackRgba8 = 32;

constexpr float kF16MinNormal = (float)6.103515625e-05;
constexpr float kPi = (float)3.14159265358979324;
constexpr float kThetaScale = (float)(4096.0 / 6.2831853071795864769);
constexpr float kThetaStep = (float)(6.2831853071795864769 / 4096.0);
constexpr float kAx32Lo = (float)-1.3219281;
constexpr float kAx32Step = (float)((12.0 - -1.3219281) / 1023.0);

// torch.clamp / torch.minimum / torch.maximum: NaN in, NaN out.
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float minimum(float a, float b) { return (isnan(a) || isnan(b)) ? a + b : fminf(a, b); }
__device__ __forceinline__ float scrub(float x) { return isfinite(x) ? x : 0.0f; }
// binning._to_int: NaN -> 0 (the argument is clamped to the grid already).
__device__ __forceinline__ int to_int(float x) { return isnan(x) ? 0 : (int)x; }
// x + (q - x): the straight-through rounding's forward value.
__device__ __forceinline__ float ste(float x, float q) { return x + (q - x); }

__device__ __forceinline__ float f16_round(float x) {
  const float r = __half2float(__float2half_rn(x));
  return fabsf(r) < kF16MinNormal ? 0.0f : r;
}

__device__ __forceinline__ float unorm8_round(float x, float scale) {
  return rintf(clamp(x, 0.0f, 255.0f / scale) * scale) / scale;
}

struct Codes {
  float tc, n1c, n2c;
};

__device__ __forceinline__ float length_code(float n) {
  return scrub(clamp(rintf((log2f(clamp(n, (float)0.4, 4096.0f)) - kAx32Lo) / kAx32Step), 0.0f, 1023.0f));
}

// tile_common.axes_u32_codes.
__device__ Codes axes_codes(float a1x, float a1y, float a2x, float a2y) {
  const float n1 = sqrtf(clamp_min(a1x * a1x + a1y * a1y, (float)1e-12));
  const float n2 = sqrtf(clamp_min(a2x * a2x + a2y * a2y, (float)1e-12));
  float tc = rintf((atan2f(a1y, a1x) + kPi) * kThetaScale);
  tc = tc >= 4096.0f ? 0.0f : tc;
  return Codes{scrub(tc), length_code(n1), length_code(n2)};
}

// The projected columns K2's table is built from, each with its element
// strides (a column may be a strided view).
struct Columns {
  const float *center, *axis1, *axis2, *color, *opacity, *depth;
  const unsigned char* valid;
  long long cs0, cs1, a1s0, a1s1, a2s0, a2s1, cls0, cls1, os0, ds0, vs0;
};

// One splat's table column and slot count; returns its real pair count.
__device__ int splat_column(const Columns& in, long long i, int n, int tiles_x, int tiles_y,
                            float tile_w, float tile_h, int db, float alpha_discard, int flags,
                            float* __restrict__ table, int* __restrict__ bounds) {
  const int num_tiles = tiles_x * tiles_y;
  const float cx = in.center[i * in.cs0], cy = in.center[i * in.cs0 + in.cs1];
  float a1x = in.axis1[i * in.a1s0], a1y = in.axis1[i * in.a1s0 + in.a1s1];
  float a2x = in.axis2[i * in.a2s0], a2y = in.axis2[i * in.a2s0 + in.a2s1];
  float r = in.color[i * in.cls0], g = in.color[i * in.cls0 + in.cls1];
  float b = in.color[i * in.cls0 + 2 * in.cls1];
  float op = in.opacity[i * in.os0];
  const float dep = in.depth[i * in.ds0];
  bool ok = in.valid[i * in.vs0] != 0;

  // quantize_view_fp16.
  if (flags & kPackRgba8) {
    r = ste(r, unorm8_round(r, 127.5f));
    g = ste(g, unorm8_round(g, 127.5f));
    b = ste(b, unorm8_round(b, 127.5f));
    op = ste(op, unorm8_round(op, 255.0f));
  } else if (flags & kPackColorF16) {
    r = f16_round(r);
    g = f16_round(g);
    b = f16_round(b);
    op = f16_round(op);
  }
  if (flags & kPackAx32) {
    const Codes c = axes_codes(a1x, a1y, a2x, a2y);
    const float theta = c.tc * kThetaStep - kPi;
    const float ct = cosf(theta), st = sinf(theta);
    const float n1 = exp2f(kAx32Lo + c.n1c * kAx32Step);
    const float n2 = exp2f(kAx32Lo + c.n2c * kAx32Step);
    a1x = ste(a1x, n1 * ct);
    a1y = ste(a1y, n1 * st);
    a2x = ste(a2x, n2 * st);
    a2y = ste(a2y, -n2 * ct);
  } else if (flags & kPackAxesF16) {
    a1x = f16_round(a1x);
    a1y = f16_round(a1y);
    a2x = f16_round(a2x);
    a2y = f16_round(a2y);
  }

  // tile_rects.
  float rx, ry;
  if (alpha_discard > 0.0f) {
    const float rho = sqrtf(clamp_min(logf(clamp_min(op, (float)1e-30) / alpha_discard), 0.0f));
    rx = rho * sqrtf(a1x * a1x + a2x * a2x) * (float)1.0001 + (float)0.01;
    ry = rho * sqrtf(a1y * a1y + a2y * a2y) * (float)1.0001 + (float)0.01;
    if (flags & kQuadClip) {
      rx = minimum(rx, 2.0f * (fabsf(a1x) + fabsf(a2x)) + (float)0.01);
      ry = minimum(ry, 2.0f * (fabsf(a1y) + fabsf(a2y)) + (float)0.01);
    }
    ok = ok && op >= alpha_discard;
  } else {
    rx = 2.0f * (fabsf(a1x) + fabsf(a2x));
    ry = 2.0f * (fabsf(a1y) + fabsf(a2y));
  }
  const float txs = (float)tiles_x, tys = (float)tiles_y;
  const int x0 = to_int(clamp(floorf((cx - rx) / tile_w), 0.0f, txs));
  const int x1 = to_int(clamp(floorf((cx + rx) / tile_w) + 1.0f, 0.0f, txs));
  const int y0 = to_int(clamp(floorf((cy - ry) / tile_h), 0.0f, tys));
  const int y1 = to_int(clamp(floorf((cy + ry) / tile_h) + 1.0f, 0.0f, tys));
  const int nx = max(x1 - x0, 0), ny = max(y1 - y0, 0);
  const int count = ok ? nx * ny : 0;
  const bool live = count > 0;  // valid & (counts > 0): counts is 0 unless valid

  // quantize_depth: the top db bits of the non-negative float's pattern.
  const int dq = max(__float_as_int(dep), 0) >> (32 - db);

  float rows[14];
  rows[0] = cx;
  rows[1] = cy;
  if (flags & kPackAx32) {
    const Codes c = axes_codes(a1x, a1y, a2x, a2y);
    rows[2] = c.tc * 1024.0f + c.n1c;
    rows[3] = c.n2c;
    rows[4] = 0.0f;
    rows[5] = 0.0f;
  } else {
    rows[2] = a1x;
    rows[3] = a1y;
    rows[4] = a2x;
    rows[5] = a2y;
  }
  rows[6] = r;
  rows[7] = g;
  rows[8] = b;
  rows[9] = live ? op : 0.0f;
  rows[10] = live ? (float)x0 : (float)num_tiles;
  rows[11] = live ? (float)y0 : 0.0f;
  rows[12] = live ? (float)nx : 1.0f;
  rows[13] = live ? (float)dq : 0.0f;
#pragma unroll
  for (int row = 0; row < 14; ++row) table[row * (long long)n + i] = scrub(rows[row]);
  bounds[i + 1] = live ? count : 1;
  return count;
}

__global__ void __launch_bounds__(kThreads)
pair_table_kernel(Columns in, int n, int tiles_x, int tiles_y, float tile_w, float tile_h, int db,
                  float alpha_discard, int flags, float* __restrict__ table, int* __restrict__ bounds,
                  int* __restrict__ num_real) {
  __shared__ int warp_sums[kThreads / 32];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i == 0) bounds[0] = 0;
  int count = 0;
  if (i < n)
    count = splat_column(in, i, n, tiles_x, tiles_y, tile_w, tile_h, db, alpha_discard, flags, table,
                         bounds);
  // The block's real pairs, one atomicAdd: integer sums are exact in any order.
  count = __reduce_add_sync(0xffffffffu, count);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_sums[w];
    if (sum != 0) atomicAdd(num_real, sum);
  }
}

}  // namespace

extern "C" {

const char* pair_table_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// Element strides for every input column; table (14, n) float32 row-major,
// bounds (n + 1,) int32 (gets 0 and the slot counts), num_real () int32
// (zeroed by the caller; gets the real pair count).  Launches on `stream`;
// returns cudaGetLastError().
int pair_table_launch(const float* center, long long cs0, long long cs1, const float* axis1,
                      long long a1s0, long long a1s1, const float* axis2, long long a2s0,
                      long long a2s1, const float* color, long long cls0, long long cls1,
                      const float* opacity, long long os0, const float* depth, long long ds0,
                      const unsigned char* valid, long long vs0, int n, int tiles_x, int tiles_y,
                      int tile_w, int tile_h, int db, float alpha_discard, int flags, float* table,
                      int* bounds, int* num_real, void* stream) {
  const Columns in{center, axis1, axis2, color, opacity, depth, valid, cs0, cs1, a1s0, a1s1,
                   a2s0, a2s1, cls0, cls1, os0, ds0, vs0};
  const long long blocks = ((long long)n + kThreads - 1) / kThreads;
  pair_table_kernel<<<(unsigned)(blocks > 0 ? blocks : 1), kThreads, 0, (cudaStream_t)stream>>>(
      in, n, tiles_x, tiles_y, (float)tile_w, (float)tile_h, db, alpha_discard, flags, table, bounds,
      num_real);
  return (int)cudaGetLastError();
}

}  // extern "C"
