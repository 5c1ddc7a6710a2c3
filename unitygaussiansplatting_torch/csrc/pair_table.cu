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
// With a `record` to write (a frame whose fields depend on the splat alone,
// no center packing), the splat's record for K1 too: its table column
// decoded as K2 decodes a slot's fields (csrc/pair_lattice.cuh), then staged
// as K1 stages a pair (csrc/composite_fwd.cu), as three float4
//   (cx, cy, a1x / |a1|^2, a1y / |a1|^2), (a2x / |a2|^2, a2y / |a2|^2,
//   opacity, 0), (r, g, b, 0),
// |a|^2 = max(ax * ax + ay * ay, 1e-12).  K1 reads a pair's record through
// its splat id, so its stage holds the bits the sorted fields gave it.  A
// block's records go through shared memory, so that their stores coalesce.
//
// Bound on the H100: bytes (45 read and 60 written per splat, 48 more with
// the record); the ~600 instructions a splat of the lattices and rects hide
// under them.  Every
// value rounds like the plain PyTorch version, bit for bit: build with
// --fmad=false and without --use_fast_math (accurate atan2f, log2f, logf,
// sqrtf, cosf, sinf, exp2f); clamp, minimum and maximum propagate NaN as
// PyTorch's do; torch.round is rintf (half to even); the divisions are IEEE
// (tile_common.true_div), never a reciprocal; constants are the float
// rounding of the same double literals.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "pair_lattice.cuh"

namespace {

constexpr int kThreads = 256;

using namespace pair_lattice;

constexpr float kF16MinNormal = (float)6.103515625e-05;
constexpr float kThetaScale = (float)(4096.0 / 6.2831853071795864769);

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

// K1's record of a splat from its table column `col`.
__device__ void write_record(const float (&col)[14], int flags, float4* __restrict__ out) {
  Axes a = (flags & kPackAx32) ? decode_ax32(col[2], col[3]) : Axes{col[2], col[3], col[4], col[5]};
  if ((flags & kPackAxesF16) && !(flags & kPackAx32))
    a = Axes{f16_round_trip(a.a1x), f16_round_trip(a.a1y), f16_round_trip(a.a2x), f16_round_trip(a.a2y)};
  float c[4] = {col[6], col[7], col[8], col[9]};  // r, g, b, opacity
  if (flags & kPackRgba8) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = unorm8_round_trip(c[j], j < 3 ? 127.5f : 255.0f);
  } else if (flags & kPackColorF16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = f16_round_trip(c[j]);
  }
  const float a1_sq = fmaxf(a.a1x * a.a1x + a.a1y * a.a1y, 1e-12f);
  const float a2_sq = fmaxf(a.a2x * a.a2x + a.a2y * a.a2y, 1e-12f);
  out[0] = make_float4(col[0], col[1], a.a1x / a1_sq, a.a1y / a1_sq);
  out[1] = make_float4(a.a2x / a2_sq, a.a2y / a2_sq, c[3], 0.0f);
  out[2] = make_float4(c[0], c[1], c[2], 0.0f);
}

// One splat's table column, slot count and, where `record` is not null,
// its record there (three float4); returns its real pair count.
__device__ int splat_column(const Columns& in, long long i, int n, int tiles_x, int tiles_y,
                            float tile_w, float tile_h, int db, float alpha_discard, int flags,
                            float* __restrict__ table, int* __restrict__ bounds, float4* __restrict__ record) {
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
  for (int row = 0; row < 14; ++row) {
    rows[row] = scrub(rows[row]);
    table[row * (long long)n + i] = rows[row];
  }
  if (record != nullptr) write_record(rows, flags, record);
  bounds[i + 1] = live ? count : 1;
  return count;
}

__global__ void __launch_bounds__(kThreads)
pair_table_kernel(Columns in, int n, int tiles_x, int tiles_y, float tile_w, float tile_h, int db,
                  float alpha_discard, int flags, float* __restrict__ table, int* __restrict__ bounds,
                  int* __restrict__ num_real, float4* __restrict__ record) {
  __shared__ int warp_sums[kThreads / 32];
  __shared__ float4 block_records[3 * kThreads];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i == 0) bounds[0] = 0;
  int count = 0;
  if (i < n)
    count = splat_column(in, i, n, tiles_x, tiles_y, tile_w, tile_h, db, alpha_discard, flags, table,
                         bounds, record != nullptr ? block_records + 3 * threadIdx.x : nullptr);
  // The block's real pairs, one atomicAdd: integer sums are exact in any order.
  count = __reduce_add_sync(0xffffffffu, count);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = count;
  __syncthreads();
  if (record != nullptr) {
    const long long first = 3LL * blockIdx.x * kThreads, end = 3LL * n;
    for (int j = threadIdx.x; j < 3 * kThreads && first + j < end; j += kThreads) record[first + j] = block_records[j];
  }
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
// (zeroed by the caller; gets the real pair count); record (n, 12) float32,
// 16-byte aligned, or null for none.  Launches on `stream`; returns
// cudaGetLastError().
int pair_table_launch(const float* center, long long cs0, long long cs1, const float* axis1,
                      long long a1s0, long long a1s1, const float* axis2, long long a2s0,
                      long long a2s1, const float* color, long long cls0, long long cls1,
                      const float* opacity, long long os0, const float* depth, long long ds0,
                      const unsigned char* valid, long long vs0, int n, int tiles_x, int tiles_y,
                      int tile_w, int tile_h, int db, float alpha_discard, int flags, float* table,
                      int* bounds, int* num_real, float* record, void* stream) {
  const Columns in{center, axis1, axis2, color, opacity, depth, valid, cs0, cs1, a1s0, a1s1,
                   a2s0, a2s1, cls0, cls1, os0, ds0, vs0};
  const long long blocks = ((long long)n + kThreads - 1) / kThreads;
  pair_table_kernel<<<(unsigned)(blocks > 0 ? blocks : 1), kThreads, 0, (cudaStream_t)stream>>>(
      in, n, tiles_x, tiles_y, (float)tile_w, (float)tile_h, db, alpha_discard, flags, table, bounds,
      num_real, reinterpret_cast<float4*>(record));
  return (int)cudaGetLastError();
}

}  // extern "C"
