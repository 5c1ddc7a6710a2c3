// Pair expansion (K2): one (splat, tile) pair per slot of the static budget.
//
// Replaces the Pallas kernel `_expand_kernel` / `_expand_window` of
// unitygaussiansplatting_tpu/ops/pair_expand.py.  Splat i owns the slot run
// [bounds[i], bounds[i+1]) (bounds = exclusive scan of max(pairs, 1), so a
// dead splat keeps one slot aimed at the sentinel tile and no run is empty).
// For each slot s < k this kernel writes
//   comp[s]        = (key << 31) | splat, key = (tile << db) | depth_key, as
//                    one non-negative int64 sort key (splat < 2^31);
//   fields[r*k+s]  = the 10 composite fields (cx, cy, a1x, a1y, a2x, a2y,
//                    r, g, b, opacity) after the same lattice round trips as
//                    the TPU package's pack / sort / unpack, decoded in place.
// A tile none of whose pixel centers can pass the alpha / quad keep test is
// replaced by the sentinel tile (the ellipse-interval cull).  Slots past the
// demand get the sentinel key, splat id n and zero fields; slots past k are
// never written, which truncates splat-major on overflow.
//
// Bound on the H100: bytes.  Per slot it reads one table column (14 floats,
// cached across the run of the splat) and writes 48 bytes; per-slot math is
// a few dozen flops.  Design: one thread per slot, which finds its splat by a
// binary search of `bounds` (L2-resident at full size), so work is perfectly
// balanced and every store is coalesced; none of the TPU machinery (window
// rebase, one-hot MXU select, boundary halves in the table) is needed.
//
// Build with --fmad=false: the cull and center arithmetic must round like
// the plain PyTorch version (one rounding per operation).

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFields = 10;
constexpr int kTableRows = 14;

constexpr int kQuadClip = 1;
constexpr int kPackCenter = 2;
constexpr int kPackAx32 = 4;
constexpr int kPackAxesF16 = 8;
constexpr int kPackColorF16 = 16;
constexpr int kPackRgba8 = 32;

// pack_axes_u32 lattice constants, rounded from the same double expressions
// as tile_common.py.
constexpr float kAx32Lo = (float)-1.3219281;
constexpr float kAx32Step = (float)((12.0 - -1.3219281) / 1023.0);
constexpr float kThetaStep = (float)(6.2831853071795864769 / 4096.0);
constexpr float kPi = (float)3.14159265358979324;

__device__ __forceinline__ float f16_round_trip(float x) {
  // Exact on the flushed f16 lattice that quantize_view_fp16 produces.
  float r = __half2float(__float2half_rn(x));
  return fabsf(r) < 6.103515625e-05f ? copysignf(0.0f, x) : r;
}

__device__ __forceinline__ float unorm8_round_trip(float x, float scale) {
  unsigned code = (unsigned)(int)floorf(x * scale + 0.5f) & 0xFFu;
  return (float)code / scale;
}

__device__ __forceinline__ float qcap_of(float op, float alpha_discard) {
  // rho^2 = log(opacity / alpha_discard): beyond it alpha < alpha_discard.
  return alpha_discard > 0.0f ? fmaxf(logf(fmaxf(op, 1e-30f) / alpha_discard), 0.0f)
                              : 1e30f;
}

// Orthonormal eigen-frame of a pair and the half-ranges of its center offset
// (pack_center_u32): u1 = a1/|a1|, u2 = the exact perpendicular of u1 on a2's
// side, r1/r2 from the ellipse cull's survival bound.
struct Frame {
  float u1x, u1y, u2x, u2y, r1, r2;
};

__device__ Frame center_frame(float a1x, float a1y, float a2x, float a2y, float op,
                              float alpha_discard, bool quad_clip, float tile_w,
                              float tile_h) {
  Frame f;
  float n1 = sqrtf(fmaxf(a1x * a1x + a1y * a1y, 1e-12f));
  float n2 = sqrtf(fmaxf(a2x * a2x + a2y * a2y, 1e-12f));
  f.u1x = a1x / n1;
  f.u1y = a1y / n1;
  float sg = (a2y * f.u1x - a2x * f.u1y >= 0.0f) ? 1.0f : -1.0f;
  f.u2x = -sg * f.u1y;
  f.u2y = sg * f.u1x;
  float qb = sqrtf(fmaxf(qcap_of(op, alpha_discard) * 1.0002f + 1e-3f, 0.0f));
  if (quad_clip) qb = fminf(qb, 2.001f);
  float half1 = 0.5f * (fabsf(f.u1x) * tile_w + fabsf(f.u1y) * tile_h);
  float half2 = 0.5f * (fabsf(f.u2x) * tile_w + fabsf(f.u2y) * tile_h);
  f.r1 = qb * n1 + half1 + 0.51f;
  f.r2 = qb * n2 + half2 + 0.51f + 0.002f * f.r1;
  return f;
}

// Least |(dx*ax + dy*ay) * inv| over the tile's pixel centers: the form is
// affine in (dx, dy), so its range comes from the corners.
__device__ __forceinline__ float min_abs_q(float ax, float ay, float inv, float dx_lo,
                                           float dx_hi, float dy_lo, float dy_hi) {
  float tx_min = fminf(dx_lo * ax, dx_hi * ax);
  float tx_max = fmaxf(dx_lo * ax, dx_hi * ax);
  float ty_min = fminf(dy_lo * ay, dy_hi * ay);
  float ty_max = fmaxf(dy_lo * ay, dy_hi * ay);
  float q_min = (tx_min + ty_min) * inv;
  float q_max = (tx_max + ty_max) * inv;
  return fmaxf(fmaxf(q_min, -q_max), 0.0f);
}

__global__ void expand_pairs_kernel(const float* __restrict__ table,
                                    const int* __restrict__ bounds, int n, long long k,
                                    int tiles_x, int num_tiles, float tile_w, float tile_h,
                                    int db, float alpha_discard, int flags,
                                    long long* __restrict__ comp,
                                    float* __restrict__ fields) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= k) return;
  const int num_slots = bounds[n];
  if (s >= num_slots) {
    comp[s] = ((long long)((unsigned)num_tiles << db) << 31) | n;
    for (int r = 0; r < kFields; ++r) fields[r * k + s] = 0.0f;
    return;
  }
  // The splat whose run holds s: the last i with bounds[i] <= s.
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (bounds[mid] <= s) lo = mid; else hi = mid - 1;
  }
  const int i = lo;
  float col[kTableRows];
  for (int r = 0; r < kTableRows; ++r) col[r] = table[(long long)r * n + i];

  const int j = (int)(s - bounds[i]);  // index within the run
  const int x0 = (int)col[10], y0 = (int)col[11];
  const int nx = max((int)col[12], 1);
  const unsigned dq = (unsigned)(int)col[13];
  const int tq = j / nx;
  const int tx = x0 + (j - tq * nx), ty = y0 + tq;
  const int tile = ty * tiles_x + tx;
  const bool quad_clip = flags & kQuadClip;

  const float cx = col[0], cy = col[1];
  float a1x, a1y, a2x, a2y;
  if (flags & kPackAx32) {
    // Rows 2/3 hold the codes theta*1024 + n1 and n2 (float32-exact ints).
    const float tcv = floorf(col[2] * (1.0f / 1024.0f));
    const float n1cv = col[2] - tcv * 1024.0f;
    const float theta = tcv * kThetaStep - kPi;
    const float ct = cosf(theta), st = sinf(theta);
    const float n1v = exp2f(kAx32Lo + n1cv * kAx32Step);
    const float n2v = exp2f(kAx32Lo + col[3] * kAx32Step);
    a1x = n1v * ct;
    a1y = n1v * st;
    a2x = n2v * st;
    a2y = -n2v * ct;
  } else {
    a1x = col[2];
    a1y = col[3];
    a2x = col[4];
    a2y = col[5];
  }
  const float op = col[9];

  // Ellipse-interval cull to the sentinel tile.
  const float qcap = qcap_of(op, alpha_discard);
  const float inv1 = 1.0f / fmaxf(a1x * a1x + a1y * a1y, 1e-12f);
  const float inv2 = 1.0f / fmaxf(a2x * a2x + a2y * a2y, 1e-12f);
  const float txf = (float)tx, tyf = (float)ty;
  const float dx_lo = txf * tile_w + 0.5f - cx;
  const float dx_hi = txf * tile_w + (tile_w - 0.5f) - cx;
  const float dy_lo = tyf * tile_h + 0.5f - cy;
  const float dy_hi = tyf * tile_h + (tile_h - 0.5f) - cy;
  const float mqx = min_abs_q(a1x, a1y, inv1, dx_lo, dx_hi, dy_lo, dy_hi);
  const float mqy = min_abs_q(a2x, a2y, inv2, dx_lo, dx_hi, dy_lo, dy_hi);
  bool touches = mqx * mqx + mqy * mqy <= qcap * 1.0002f + 1e-3f;
  if (quad_clip) touches = touches && mqx <= 2.001f && mqy <= 2.001f;
  const int tile_i = touches ? tile : num_tiles;
  const unsigned key = ((unsigned)tile_i << db) | dq;
  comp[s] = ((long long)key << 31) | i;

  // Field values after the pack / unpack round trips.
  float out[kFields];
  if (flags & kPackAx32) {
    out[2] = a1x; out[3] = a1y; out[4] = a2x; out[5] = a2y;
  } else if (flags & kPackAxesF16) {
    out[2] = f16_round_trip(a1x); out[3] = f16_round_trip(a1y);
    out[4] = f16_round_trip(a2x); out[5] = f16_round_trip(a2y);
  } else {
    out[2] = a1x; out[3] = a1y; out[4] = a2x; out[5] = a2y;
  }
  if (flags & kPackRgba8) {
    out[6] = unorm8_round_trip(col[6], 127.5f);
    out[7] = unorm8_round_trip(col[7], 127.5f);
    out[8] = unorm8_round_trip(col[8], 127.5f);
    out[9] = unorm8_round_trip(op, 255.0f);
  } else if (flags & kPackColorF16) {
    out[6] = f16_round_trip(col[6]); out[7] = f16_round_trip(col[7]);
    out[8] = f16_round_trip(col[8]); out[9] = f16_round_trip(op);
  } else {
    out[6] = col[6]; out[7] = col[7]; out[8] = col[8]; out[9] = op;
  }
  if (flags & kPackCenter) {
    // Quantize the offset from the tile center in the pair's eigen-frame
    // (12-bit major, 17-bit minor), then decode it from the round-tripped
    // axes and opacity, as the TPU package's post-sort decode does.
    const float tcx = (float)(tile_i % tiles_x) * tile_w + 0.5f * tile_w;
    const float tcy = (float)(tile_i / tiles_x) * tile_h + 0.5f * tile_h;
    const Frame e = center_frame(a1x, a1y, a2x, a2y, op, alpha_discard, quad_clip,
                                 tile_w, tile_h);
    const float dxc = cx - tcx, dyc = cy - tcy;
    const float s1 = dxc * e.u1x + dyc * e.u1y;
    const float s2 = dxc * e.u2x + dyc * e.u2y;
    const float q1 = fminf(fmaxf(floorf(s1 / e.r1 * 2047.0f + 0.5f) + 2048.0f, 0.0f), 4095.0f);
    const float q2 =
        fminf(fmaxf(floorf(s2 / e.r2 * 65535.0f + 0.5f) + 65536.0f, 0.0f), 131071.0f);
    const Frame d = center_frame(out[2], out[3], out[4], out[5], out[9], alpha_discard,
                                 quad_clip, tile_w, tile_h);
    const float ds1 = (q1 - 2048.0f) * (d.r1 / 2047.0f);
    const float ds2 = (q2 - 65536.0f) * (d.r2 / 65535.0f);
    out[0] = tcx + ds1 * d.u1x + ds2 * d.u2x;
    out[1] = tcy + ds1 * d.u1y + ds2 * d.u2y;
  } else {
    out[0] = cx;
    out[1] = cy;
  }
  for (int r = 0; r < kFields; ++r) fields[r * k + s] = out[r];
}

}  // namespace

extern "C" {

const char* pair_expand_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// table (14, n) float32 row-major; bounds (n + 1,) int32; comp (k,) int64;
// fields (10, k) float32.  Launches on `stream`; returns cudaGetLastError().
int expand_pairs_launch(const float* table, const int* bounds, int n, long long k,
                        int tiles_x, int num_tiles, int tile_w, int tile_h, int db,
                        float alpha_discard, int flags, long long* comp, float* fields,
                        void* stream) {
  const int threads = 256;
  const long long blocks = (k + threads - 1) / threads;
  expand_pairs_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      table, bounds, n, k, tiles_x, num_tiles, (float)tile_w, (float)tile_h, db,
      alpha_discard, flags, comp, fields);
  return (int)cudaGetLastError();
}

}  // extern "C"
