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
//                    the TPU package's pack / sort / unpack, decoded in place;
//                    not written when `fields` is null (keys only: a frame
//                    whose composite reads each pair's fields from its
//                    splat's record, csrc/pair_table.cu).
// A tile none of whose pixel centers can pass the alpha / quad keep test is
// replaced by the sentinel tile (the ellipse-interval cull).  Slots past the
// demand get the sentinel key, splat id n and zero fields; slots past k are
// never written, which truncates splat-major on overflow.
//
// Bound on the H100: bytes (the table and bounds read once, 48 bytes a slot
// written, 8 with keys only).  Design: a block of 256 threads walks
// kWindowsPerBlock windows of 512 consecutive slots, two consecutive slots a
// thread, so every store is a coalesced vector (16 bytes of keys, 8 of each
// field row).  Runs are never
// empty, so a window's slots belong to at most 512 consecutive splats, from
// r0 = the splat of its first slot (the TPU kernel's window start).  The
// block finds r0 once, by a 32-way search of `bounds` in one warp (five
// dependent loads at 6.1M splats), and carries it from window to window.
// Thread t owns the window's splat r0 + t: its run start and table column
// come in with coalesced loads, issued during the previous window (the
// start before that window's slots, the column after them), and it derives,
// once per splat, everything that does not depend on the tile (the decoded
// axes, 1/|a|^2, the cull bound, the round-tripped colors, both eigen-frames
// of the center packing) into shared memory, 55 KB a block, four blocks an
// SM.  Each slot then finds its splat by a binary search of the window's run
// starts in shared memory (the thread's second slot steps from its first)
// and does only the tile's work: the tile index, the interval cull, the key
// and the center quantize / decode.
//
// Build with --fmad=false: the cull and center arithmetic must round like
// the plain PyTorch version (one rounding per operation).

#include <cuda_runtime.h>

#include <atomic>
#include <climits>

#include "pair_lattice.cuh"

namespace {

constexpr int kFields = 10;
constexpr int kTableRows = 14;

// The launch geometry.  chip_smoke.py --explore rebuilds this file with
// other values of the two macros to time them against the default.
#ifndef K2_WINDOWS_PER_BLOCK
#define K2_WINDOWS_PER_BLOCK 8
#endif
#ifndef K2_BLOCKS_PER_SM
#define K2_BLOCKS_PER_SM 4
#endif
constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 2;  // store_slots writes them as one vector a row
constexpr int kWindow = kThreads * kSlotsPerThread;
constexpr int kWindowsPerBlock = K2_WINDOWS_PER_BLOCK;
constexpr int kBlocksPerSm = K2_BLOCKS_PER_SM;  // 55 KB of shared memory each

using namespace pair_lattice;

// Per-splat values of a window, one row of kWindow each.
enum Value {
  kCx, kCy, kA1x, kA1y, kA2x, kA2y,  // center, decoded axes
  kInv1, kInv2, kCullBound,          // 1/|a1|^2, 1/|a2|^2, qcap * 1.0002 + 1e-3
  kR, kG, kB, kOp,                   // fields 6-9 after their round trips
  kEU1x, kEU1y, kESg, kER1, kER2,    // encode frame: from the axes and opacity
  kDU1x, kDU1y, kDSg, kDR1, kDR2,    // decode frame: from the round-tripped ones,
                                     // its ranges over 2047 and 65535
  kValues
};

struct WindowSplats {
  int start[kWindow + 1];  // bounds[r0 + t]; INT_MAX past splat n
  unsigned x0dq[kWindow];  // (x0 << db) | depth key
  int y0[kWindow];
  int nx[kWindow];
  float v[kValues][kWindow];
};

__device__ __forceinline__ float qcap_of(float op, float alpha_discard) {
  // rho^2 = log(opacity / alpha_discard): beyond it alpha < alpha_discard.
  return alpha_discard > 0.0f ? fmaxf(logf(fmaxf(op, 1e-30f) / alpha_discard), 0.0f)
                              : 1e30f;
}

// Orthonormal eigen-frame of a pair and the half-ranges of its center offset
// (pack_center_u32): u1 = a1/|a1|, u2 = the exact perpendicular of u1 on a2's
// side (sg * (-u1y, u1x)), r1/r2 from the ellipse cull's survival bound
// qcap * 1.0002 + 1e-3 (`cull_bound`).
struct Frame {
  float u1x, u1y, sg, r1, r2;
};

__device__ Frame center_frame(float a1x, float a1y, float a2x, float a2y, float cull_bound,
                              bool quad_clip, float tile_w, float tile_h) {
  Frame f;
  float n1 = sqrtf(fmaxf(a1x * a1x + a1y * a1y, 1e-12f));
  float n2 = sqrtf(fmaxf(a2x * a2x + a2y * a2y, 1e-12f));
  f.u1x = a1x / n1;
  f.u1y = a1y / n1;
  f.sg = (a2y * f.u1x - a2x * f.u1y >= 0.0f) ? 1.0f : -1.0f;
  const float u2x = -f.sg * f.u1y, u2y = f.sg * f.u1x;
  float qb = sqrtf(fmaxf(cull_bound, 0.0f));
  if (quad_clip) qb = fminf(qb, 2.001f);
  float half1 = 0.5f * (fabsf(f.u1x) * tile_w + fabsf(f.u1y) * tile_h);
  float half2 = 0.5f * (fabsf(u2x) * tile_w + fabsf(u2y) * tile_h);
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

// The last i in [0, n) with bounds[i] <= s (bounds[0] = 0 <= s), by one
// warp: 32 probes a step cut the range 32-fold.  Every lane returns it.
__device__ int find_splat(const int* __restrict__ bounds, int n, long long s) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const long long p = lo + (long long)(lane + 1) * step;
    const bool le = p <= hi && bounds[p] <= s;  // true on a prefix of the lanes
    const int c = __popc(__ballot_sync(0xffffffffu, le));
    const int next = lo + c * step;
    hi = (int)min((long long)hi, (long long)next + step - 1);
    lo = next;
  }
  return lo;
}

// A thread's two slots from s: vector stores (both keys, 16 bytes; both
// slots of a field row, 8 bytes) when both are below k and every row is
// aligned (k even), else one slot at a time.  kKeysOnly: the keys alone.
template <bool kKeysOnly>
__device__ __forceinline__ void store_slots(long long* __restrict__ comp, float* __restrict__ fields,
                                            long long k, long long s,
                                            const long long (&c)[kSlotsPerThread],
                                            const float (&f)[kFields][kSlotsPerThread]) {
  if (k % 2 == 0 && s + 2 <= k) {
    *reinterpret_cast<longlong2*>(comp + s) = make_longlong2(c[0], c[1]);
    if (kKeysOnly) return;
#pragma unroll
    for (int r = 0; r < kFields; ++r)
      *reinterpret_cast<float2*>(fields + r * k + s) = make_float2(f[r][0], f[r][1]);
    return;
  }
#pragma unroll
  for (int q = 0; q < kSlotsPerThread; ++q) {
    if (s + q >= k) return;
    comp[s + q] = c[q];
    if (kKeysOnly) continue;
#pragma unroll
    for (int r = 0; r < kFields; ++r) fields[r * k + s + q] = f[r][q];
  }
}

__device__ __forceinline__ float cull_bound_of(float op, float alpha_discard) {
  return qcap_of(op, alpha_discard) * 1.0002f + 1e-3f;
}

// Once per splat of the window: everything derived from its table column
// that no tile changes (kKeysOnly: what the keys need).
template <bool kKeysOnly>
__device__ void derive_splat(WindowSplats& sp, int t, const float (&col)[kTableRows], int db,
                             float tile_w, float tile_h, float alpha_discard, int flags) {
  const bool quad_clip = flags & kQuadClip;
  sp.x0dq[t] = ((unsigned)(int)col[10] << db) | (unsigned)(int)col[13];
  sp.y0[t] = (int)col[11];
  sp.nx[t] = max((int)col[12], 1);

  float a1x, a1y, a2x, a2y;
  if (flags & kPackAx32) {
    const Axes a = decode_ax32(col[2], col[3]);
    a1x = a.a1x;
    a1y = a.a1y;
    a2x = a.a2x;
    a2y = a.a2y;
  } else {
    a1x = col[2];
    a1y = col[3];
    a2x = col[4];
    a2y = col[5];
  }
  const float op = col[9];
  const float cull_bound = cull_bound_of(op, alpha_discard);
  sp.v[kCx][t] = col[0];
  sp.v[kCy][t] = col[1];
  sp.v[kA1x][t] = a1x;
  sp.v[kA1y][t] = a1y;
  sp.v[kA2x][t] = a2x;
  sp.v[kA2y][t] = a2y;
  sp.v[kInv1][t] = 1.0f / fmaxf(a1x * a1x + a1y * a1y, 1e-12f);
  sp.v[kInv2][t] = 1.0f / fmaxf(a2x * a2x + a2y * a2y, 1e-12f);
  sp.v[kCullBound][t] = cull_bound;
  if (kKeysOnly) return;

  float out[4];
  if (flags & kPackRgba8) {
    out[0] = unorm8_round_trip(col[6], 127.5f);
    out[1] = unorm8_round_trip(col[7], 127.5f);
    out[2] = unorm8_round_trip(col[8], 127.5f);
    out[3] = unorm8_round_trip(op, 255.0f);
  } else if (flags & kPackColorF16) {
    out[0] = f16_round_trip(col[6]);
    out[1] = f16_round_trip(col[7]);
    out[2] = f16_round_trip(col[8]);
    out[3] = f16_round_trip(op);
  } else {
    out[0] = col[6];
    out[1] = col[7];
    out[2] = col[8];
    out[3] = op;
  }
  sp.v[kR][t] = out[0];
  sp.v[kG][t] = out[1];
  sp.v[kB][t] = out[2];
  sp.v[kOp][t] = out[3];

  if (flags & kPackCenter) {
    // Encoded from the axes and opacity, decoded from the round-tripped
    // ones, as the TPU package's post-sort decode does.  Where the round
    // trips changed nothing (an opacity on its lattice, axes not rounded
    // through f16) the two frames are one.
    const Frame e = center_frame(a1x, a1y, a2x, a2y, cull_bound, quad_clip, tile_w, tile_h);
    const bool f16_axes = (flags & kPackAxesF16) && !(flags & kPackAx32);
    Frame d = e;
    if (f16_axes)
      d = center_frame(f16_round_trip(a1x), f16_round_trip(a1y), f16_round_trip(a2x), f16_round_trip(a2y),
                       cull_bound_of(out[3], alpha_discard), quad_clip, tile_w, tile_h);
    else if (out[3] != op)
      d = center_frame(a1x, a1y, a2x, a2y, cull_bound_of(out[3], alpha_discard), quad_clip, tile_w, tile_h);
    sp.v[kEU1x][t] = e.u1x;
    sp.v[kEU1y][t] = e.u1y;
    sp.v[kESg][t] = e.sg;
    sp.v[kER1][t] = e.r1;
    sp.v[kER2][t] = e.r2;
    sp.v[kDU1x][t] = d.u1x;
    sp.v[kDU1y][t] = d.u1y;
    sp.v[kDSg][t] = d.sg;
    sp.v[kDR1][t] = d.r1 / 2047.0f;
    sp.v[kDR2][t] = d.r2 / 65535.0f;
  }
}

// bounds[r0 + t], INT_MAX past splat n.
__device__ __forceinline__ int load_start(const int* __restrict__ bounds, int n, int r0, int t) {
  return (long long)r0 + t <= n ? bounds[r0 + t] : INT_MAX;
}

__device__ __forceinline__ void load_column(const float* __restrict__ table, int n, int i,
                                            float (&col)[kTableRows]) {
#pragma unroll
  for (int r = 0; r < kTableRows; ++r) col[r] = table[(long long)r * n + i];
}

// kKeysOnly: the keys alone (`fields` unused), a specialization of its own,
// so that the fields' work costs the keys-only kernel nothing and the
// kernel with fields keeps its registers.
template <bool kKeysOnly>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
expand_pairs_kernel(const float* __restrict__ table, const int* __restrict__ bounds, int n,
                    long long k, int tiles_x, int num_tiles, float tile_w, float tile_h, int db,
                    float alpha_discard, int flags, long long* __restrict__ comp,
                    float* __restrict__ fields) {
  extern __shared__ __align__(16) unsigned char smem[];
  WindowSplats& sp = *reinterpret_cast<WindowSplats*>(smem);
  __shared__ int s_r0;

  const long long num_slots = bounds[n];
  const long long demand_end = min(k, num_slots);
  const int tiles_y = num_tiles / tiles_x;
  const long long sentinel = ((long long)((unsigned)num_tiles << db) << 31) | n;
  const unsigned dq_mask = (1u << db) - 1u;
  const bool quad_clip = flags & kQuadClip;
  const bool f16_axes = (flags & kPackAxesF16) && !(flags & kPackAx32);
  const int tid = threadIdx.x;

  // The current window's first splat, and this thread's splat r0 + tid of
  // it: its run start and, if that lies in the window, its table column.
  // Both are loaded a window ahead, during the previous window's slots.
  int r0 = -1, start = 0;
  float col[kTableRows];

  for (int win = 0; win < kWindowsPerBlock; ++win) {
    const long long w0 = ((long long)blockIdx.x * kWindowsPerBlock + win) * kWindow;
    if (w0 >= k) return;
    const long long s0 = w0 + (long long)tid * kSlotsPerThread;  // this thread's first slot
    long long c[kSlotsPerThread];
    float f[kFields][kSlotsPerThread];
    if (w0 >= num_slots) {  // past the demand: sentinel slots only
#pragma unroll
      for (int q = 0; q < kSlotsPerThread; ++q) {
        c[q] = sentinel;
#pragma unroll
        for (int r = 0; r < kFields; ++r) f[r][q] = 0.0f;
      }
      store_slots<kKeysOnly>(comp, fields, k, s0, c, f);
      continue;
    }
    const long long w_end = min(w0 + kWindow, num_slots);  // end of the window's demand
    if (r0 < 0) {  // the block's first window in the demand
      if (tid < 32) {
        const int found = find_splat(bounds, n, w0);
        if (tid == 0) s_r0 = found;
      }
      __syncthreads();
      r0 = s_r0;
      start = load_start(bounds, n, r0, tid);
      if (start < w_end) load_column(table, n, r0 + tid, col);
    }
    __syncthreads();  // the previous window's slots are done with sp

    // The window's splats r0 .. r0 + count - 1 start below w_end: derive
    // them, kThreads at a time (a window holds ~130 at 6.1M splats and
    // 23.5M slots), with the run start after the last one.
    sp.start[tid] = start;
    if (start < w_end) derive_splat<kKeysOnly>(sp, tid, col, db, tile_w, tile_h, alpha_discard, flags);
    __syncthreads();
    int loaded = kThreads;
    while (loaded <= kWindow && sp.start[loaded - 1] < w_end) {
      const int t = loaded + tid;
      if (t <= kWindow) {
        const int st = load_start(bounds, n, r0, t);
        sp.start[t] = st;
        if (t < kWindow && st < w_end) {
          float more[kTableRows];
          load_column(table, n, r0 + t, more);
          derive_splat<kKeysOnly>(sp, t, more, db, tile_w, tile_h, alpha_discard, flags);
        }
      }
      loaded = min(loaded + kThreads, kWindow + 1);
      __syncthreads();
    }
    // count: the first t with start[t] >= w_end (start[0] <= w0 < w_end).
    int count = 1;
    for (int hi = loaded - 1; count < hi;) {
      const int mid = (count + hi) >> 1;
      if (sp.start[mid] >= w_end) hi = mid; else count = mid + 1;
    }
    // The next window starts in the run that holds slot w0 + kWindow.
    const int r0_next = r0 + count - (sp.start[count] <= w0 + kWindow ? 0 : 1);
    const long long w0_next = w0 + kWindow, w_end_next = min(w0_next + kWindow, num_slots);
    const bool prefetch = win + 1 < kWindowsPerBlock && w0_next < demand_end;
    if (prefetch) start = load_start(bounds, n, r0_next, tid);

    // This thread's slots: the first one's splat by a binary search of the
    // window's bounds and its tile by a division; the next ones by stepping
    // (no run is empty, and a run walks its tile rect row by row).
    int li = 0;
    for (int hi = count - 1; li < hi;) {
      const int mid = (li + hi + 1) >> 1;
      if (sp.start[mid] <= s0) li = mid; else hi = mid - 1;
    }
    unsigned xd = sp.x0dq[li];
    int x0 = (int)(xd >> db), nx = sp.nx[li], tx = 0, ty = 0;
#pragma unroll
    for (int q = 0; q < kSlotsPerThread; ++q) {
      const long long s = s0 + q;
      if (s >= w_end) {
        c[q] = sentinel;
#pragma unroll
        for (int r = 0; r < kFields; ++r) f[r][q] = 0.0f;
        continue;
      }
      if (q == 0) {
        const int j = (int)(s - sp.start[li]);  // index within the run
        const int tq = j / nx;
        tx = x0 + (j - tq * nx);
        ty = sp.y0[li] + tq;
      } else if (li + 1 < count && sp.start[li + 1] <= s) {  // the next splat's first slot
        ++li;
        xd = sp.x0dq[li];
        x0 = (int)(xd >> db);
        nx = sp.nx[li];
        tx = x0;
        ty = sp.y0[li];
      } else if (++tx == x0 + nx) {
        tx = x0;
        ++ty;
      }
      const int tile = ty * tiles_x + tx;

      // Ellipse-interval cull to the sentinel tile.
      const float cx = sp.v[kCx][li], cy = sp.v[kCy][li];
      const float a1x = sp.v[kA1x][li], a1y = sp.v[kA1y][li];
      const float a2x = sp.v[kA2x][li], a2y = sp.v[kA2y][li];
      const float txf = (float)tx, tyf = (float)ty;
      const float dx_lo = txf * tile_w + 0.5f - cx;
      const float dx_hi = txf * tile_w + (tile_w - 0.5f) - cx;
      const float dy_lo = tyf * tile_h + 0.5f - cy;
      const float dy_hi = tyf * tile_h + (tile_h - 0.5f) - cy;
      const float mqx = min_abs_q(a1x, a1y, sp.v[kInv1][li], dx_lo, dx_hi, dy_lo, dy_hi);
      const float mqy = min_abs_q(a2x, a2y, sp.v[kInv2][li], dx_lo, dx_hi, dy_lo, dy_hi);
      bool touches = mqx * mqx + mqy * mqy <= sp.v[kCullBound][li];
      if (quad_clip) touches = touches && mqx <= 2.001f && mqy <= 2.001f;
      const int tile_i = touches ? tile : num_tiles;
      const unsigned key = ((unsigned)tile_i << db) | (xd & dq_mask);
      c[q] = ((long long)key << 31) | (r0 + li);
      if (kKeysOnly) continue;

      // Field values after the pack / unpack round trips.
      if (f16_axes) {
        f[2][q] = f16_round_trip(a1x); f[3][q] = f16_round_trip(a1y);
        f[4][q] = f16_round_trip(a2x); f[5][q] = f16_round_trip(a2y);
      } else {
        f[2][q] = a1x; f[3][q] = a1y; f[4][q] = a2x; f[5][q] = a2y;
      }
      f[6][q] = sp.v[kR][li];
      f[7][q] = sp.v[kG][li];
      f[8][q] = sp.v[kB][li];
      f[9][q] = sp.v[kOp][li];
      if (flags & kPackCenter) {
        // Quantize the offset from the tile center in the pair's eigen-frame
        // (12-bit major, 17-bit minor), then decode it in the decode frame.
        // (tile_i % tiles_x, tile_i / tiles_x): a live splat's tiles lie on
        // the grid, and the sentinel tile num_tiles is (0, tiles_y).
        const bool on_grid = tile_i < num_tiles;
        const float tcx = (float)(on_grid ? tx : 0) * tile_w + 0.5f * tile_w;
        const float tcy = (float)(on_grid ? ty : tiles_y) * tile_h + 0.5f * tile_h;
        const float eu1x = sp.v[kEU1x][li], eu1y = sp.v[kEU1y][li], esg = sp.v[kESg][li];
        const float eu2x = -esg * eu1y, eu2y = esg * eu1x;
        const float dxc = cx - tcx, dyc = cy - tcy;
        const float s1 = dxc * eu1x + dyc * eu1y;
        const float s2 = dxc * eu2x + dyc * eu2y;
        const float q1 =
            fminf(fmaxf(floorf(s1 / sp.v[kER1][li] * 2047.0f + 0.5f) + 2048.0f, 0.0f), 4095.0f);
        const float q2 = fminf(
            fmaxf(floorf(s2 / sp.v[kER2][li] * 65535.0f + 0.5f) + 65536.0f, 0.0f), 131071.0f);
        const float du1x = sp.v[kDU1x][li], du1y = sp.v[kDU1y][li], dsg = sp.v[kDSg][li];
        const float du2x = -dsg * du1y, du2y = dsg * du1x;
        const float ds1 = (q1 - 2048.0f) * sp.v[kDR1][li];
        const float ds2 = (q2 - 65536.0f) * sp.v[kDR2][li];
        f[0][q] = tcx + ds1 * du1x + ds2 * du2x;
        f[1][q] = tcy + ds1 * du1y + ds2 * du2y;
      } else {
        f[0][q] = cx;
        f[1][q] = cy;
      }
    }
    store_slots<kKeysOnly>(comp, fields, k, s0, c, f);
    if (prefetch && start < w_end_next) load_column(table, n, r0_next + tid, col);
    r0 = r0_next;
  }
}

}  // namespace

// Opt in to the dynamic shared memory and to the largest shared-memory
// carveout, so that kBlocksPerSm blocks fit on an SM: once per device.
static std::atomic<unsigned long long> g_attributes_set{0};  // bit d: device d

template <bool kKeysOnly>
static cudaError_t set_kernel_attributes() {
  cudaError_t err = cudaFuncSetAttribute(expand_pairs_kernel<kKeysOnly>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(WindowSplats));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(expand_pairs_kernel<kKeysOnly>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

static cudaError_t set_attributes() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (g_attributes_set.load() & bit) return cudaSuccess;
  err = set_kernel_attributes<false>();
  if (err == cudaSuccess) err = set_kernel_attributes<true>();
  if (err == cudaSuccess) g_attributes_set.fetch_or(bit);
  return err;
}

extern "C" {

// Blocks of K2 resident on one SM of the current device, the fewer of its
// two specializations' (negative: a CUDA error).  chip_smoke.py holds it to
// kBlocksPerSm, which __launch_bounds__ sizes the registers for.
int expand_pairs_blocks_per_sm() {
  cudaError_t err = set_attributes();
  int blocks = 0, keys_only = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, expand_pairs_kernel<false>, kThreads,
                                                        sizeof(WindowSplats));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&keys_only, expand_pairs_kernel<true>, kThreads,
                                                        sizeof(WindowSplats));
  return err == cudaSuccess ? (blocks < keys_only ? blocks : keys_only) : -(int)err;
}

const char* pair_expand_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// table (14, n) float32 row-major; bounds (n + 1,) int32; comp (k,) int64;
// fields (10, k) float32, or null for the keys alone.  Launches on `stream`;
// returns cudaGetLastError().
int expand_pairs_launch(const float* table, const int* bounds, int n, long long k,
                        int tiles_x, int num_tiles, int tile_w, int tile_h, int db,
                        float alpha_discard, int flags, long long* comp, float* fields,
                        void* stream) {
  const long long per_block = (long long)kWindow * kWindowsPerBlock;
  const long long blocks = (k + per_block - 1) / per_block;
  if (blocks == 0) return (int)cudaSuccess;
  const int smem = (int)sizeof(WindowSplats);
  const cudaError_t err = set_attributes();
  if (err != cudaSuccess) return (int)err;
  auto kernel = fields == nullptr ? expand_pairs_kernel<true> : expand_pairs_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      table, bounds, n, k, tiles_x, num_tiles, (float)tile_w, (float)tile_h, db, alpha_discard,
      flags, comp, fields);
  return (int)cudaGetLastError();
}

}  // extern "C"
