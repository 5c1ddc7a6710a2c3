// Backward tile composite (K3): the VJP of the forward composite (K1), per
// (splat, tile) pair.
//
// Replaces the Pallas kernel `_bwd_kernel` of
// unitygaussiansplatting_tpu/ops/rasterize_pallas_bwd.py (launched by its
// `composite_pallas_bwd`) and the fold of its per-step blocks into pairs
// (`steps_to_pair_gradients`): here a pair belongs to one tile and one block,
// so no two steps share a block and there is nothing to fold.
//
// One thread block per (tile, segment): K1 cut each tile's walk into
// segments of `segment_steps` steps and saved, at the start of each segment
// it reached, every pixel's transmittance (a product, the TPU kernel's own
// rule) and color sums.  A block starts from its segment's checkpoint, the
// way the TPU kernel carries (prefix of u, T) from one grid step to the next
// in `state_ref`, and walks at most `segment_steps` steps, cut at global
// multiples of `chunk`; a block whose segment starts at or past K1's exit
// returns at once.  Blocks start heaviest segment first (`seg_order`).  Each
// thread owns PPT pixels, and a warp's pixels are PPT runs of 32 consecutive
// pixels.  The block replays K1's alpha in K1's term order.  Per pixel it
// carries the transmittance T and the prefix of u = w * (D . c), which starts
// at D . (the checkpoint's color sums); with D = dL/d(rgb), dA =
// dL/d(coverage) and the saved forward output (C_tot, A):
//   t_i = T_step * prod_{earlier in step}(1 - alpha),  w_i = t_i * alpha_i,
//   dL/dalpha_i = t_i (D . c_i) - (D . C_tot - prefix_i(u)) / (1 - alpha_i)
//                 + dA (1 - A) / (1 - alpha_i),
// zero where alpha was discarded or clipped at alpha_max.  Before each step
// the block tests the tile's max T against transmittance_eps and stops below
// it, as the TPU kernel does; T never grows, so a segment after the exit
// stops at its first test.  Per pair it sums ten per-pixel terms over the
// tile's pixels (sum gx, gy, gx dx, gx dy, gy dx, gy dy, w D_r, w D_g, w D_b,
// dalpha exp(power); gx = dL/dqx) and turns them into the gradients of the
// pair's cx, cy, a1x, a1y, a2x, a2y, r, g, b, opacity.
//
// Reduction: per thread over its pixels, then over the warp four pairs at a
// time by a transpose reduction (each shuffle step halves the 40 sums a lane
// holds: 45 shuffles for four pairs, against 200 for an xor tree per sum),
// then a fixed-order pass over the warps in shared memory, 32 pairs at a
// time.  Each pair belongs to one block, so no float atomics: two launches
// give identical bits.  Each pair's ten gradients go straight to its slot,
// column perm[j] of the (10, K) output (f32, or bf16 rounded to nearest even
// with -0 stored as +0), so the output is grouped in K2's splat-major runs for
// the run reduce (K4).  The pairs walked per tile are summed with integer
// atomics (exact in any order).
//
// Bound on the H100: instruction issue (the function needs 24 instructions per
// evaluated pair and pixel for the alpha replay and 48 more where the pixel
// keeps the pair; this loop issues ~30 and ~58, and the warp reduction more).
// Design: segments spread the busiest tile over many SMs; the per-pair
// divisions are hoisted into the shared-memory staging; the warp reduction is
// batched over four pairs, and a warp whose pixels all drop them skips it.  Build with
// --fmad=false so the alpha replay rounds like K1 and the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFields = 10;  // cx, cy, a1x, a1y, a2x, a2y, r, g, b, opacity
constexpr int kBatch = 32;   // pairs per shared-memory reduction round
constexpr int kGroup = 4;    // pairs per warp reduction
constexpr int kPerLane = kGroup * kFields / 8;  // sums each lane holds after it
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBatch % kGroup == 0 && kGroup * kFields == 40, "the reduction halves 40 sums three times");

// One halving step of the transpose reduction: a lane keeps the half of its
// first 2H values that its `offset` bit selects, hands the other half to the
// lane `offset` away, and adds what it gets, into v[0 .. H).
template <int H, int N>
__device__ __forceinline__ void halve(float (&v)[N], int lane, int offset) {
  const bool upper = lane & offset;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = upper ? v[k] : v[k + H];
    const float keep = upper ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, offset);
  }
}

// Sums each of 40 values over the warp's 32 lanes in a fixed order: three
// halving steps (lanes 16, 8, 4 apart: 20 + 10 + 5 shuffles), then two full
// butterfly steps over the last 5 (lanes 2 and 1 apart: 10 shuffles), 45 in
// all.  Lane l ends with the totals of
// values 5 * (l / 4) .. 5 * (l / 4) + 4 in v[0 .. 5).
__device__ __forceinline__ void warp_transpose_sum(float (&v)[40], int lane) {
  halve<20>(v, lane, 16);
  halve<10>(v, lane, 8);
  halve<5>(v, lane, 4);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    v[k] += __shfl_xor_sync(kFull, v[k], 2);
    v[k] += __shfl_xor_sync(kFull, v[k], 1);
  }
}

__device__ __forceinline__ void store(float* out, long long idx, float v) { out[idx] = v; }

__device__ __forceinline__ void store(unsigned short* out, long long idx, float v) {
  // Round to nearest even; +0 for -0 (the TPU kernel's `_bf16_bits`).
  out[idx] = __bfloat16_as_ushort(__float2bfloat16_rn(v == 0.0f ? 0.0f : v));
}

template <int PPT, typename OutT>
__global__ void __launch_bounds__(512)
composite_bwd_kernel(const float* __restrict__ fields, long long k,
                     const int* __restrict__ tile_starts, int tiles_x, int tile_w,
                     int tile_h, int chunk, float eps, float alpha_discard, float alpha_max,
                     int quad_clip, const float* __restrict__ raw,
                     const float* __restrict__ dout, const long long* __restrict__ perm,
                     OutT* __restrict__ out, int* __restrict__ pairs_done,
                     const int* __restrict__ seg_order, const int* __restrict__ seg_tile,
                     const int* __restrict__ seg_starts, int num_tiles, int segment_steps,
                     const float* __restrict__ ckpt, const int* __restrict__ fwd_done) {
  extern __shared__ float smem[];
  float* s_cx = smem;  // the step's pairs, kFields rows of `chunk`
  float* s_cy = s_cx + chunk;
  float* s_ux = s_cy + chunk;  // a1 / |a1|^2
  float* s_uy = s_ux + chunk;
  float* s_vx = s_uy + chunk;  // a2 / |a2|^2
  float* s_vy = s_vx + chunk;
  float* s_r = s_vy + chunk;
  float* s_g = s_r + chunk;
  float* s_b = s_g + chunk;
  float* s_op = s_b + chunk;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads / 32;
  float* part = s_op + chunk;                  // [nwarps][kFields][kBatch] warp sums
  float* tot = part + nwarps * kFields * kBatch;  // [kFields][kBatch] tile sums

  const int seg = seg_order[blockIdx.x];
  if (seg >= seg_starts[num_tiles]) return;  // past this frame's segments
  const int t = seg_tile[seg];
  const int start = tile_starts[t];
  const int end = tile_starts[t + 1];
  const long long first = start / chunk, last = (end - 1) / chunk;
  const long long seg_first = first + (long long)(seg - seg_starts[t]) * segment_steps;
  const long long seg_last = seg_first + segment_steps - 1 < last ? seg_first + segment_steps - 1 : last;
  const long long seg_lo = seg_first * chunk > start ? seg_first * chunk : start;
  if (seg_lo - start >= fwd_done[t]) return;  // K1 stopped before this segment

  const int npix = tile_w * tile_h;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float tx0 = (float)(t % tiles_x) * (float)tile_w;
  const float ty0 = (float)(t / tiles_x) * (float)tile_h;
  const float* fwd = raw + (long long)t * 4 * npix;
  const float* dg = dout + (long long)t * 4 * npix;

  const float* state = ckpt + (long long)seg * 4 * npix;

  // Per pixel: position, upstream gradient, D . C_tot, dA * T_final, and the
  // carried transmittance and prefix of u, from the segment's checkpoint.
  float px[PPT], py[PPT], d_r[PPT], d_g[PPT], d_b[PPT], d_ctot[PPT], d_at[PPT];
  float trans[PPT], pref[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = (warp * PPT + q) * 32 + lane;
    px[q] = tx0 + (float)(p % tile_w) + 0.5f;
    py[q] = ty0 + (float)(p / tile_w) + 0.5f;
    d_r[q] = dg[p];
    d_g[q] = dg[npix + p];
    d_b[q] = dg[2 * npix + p];
    d_ctot[q] = d_r[q] * fwd[p] + d_g[q] * fwd[npix + p] + d_b[q] * fwd[2 * npix + p];
    d_at[q] = dg[3 * npix + p] * (1.0f - fwd[3 * npix + p]);
    trans[q] = state[p];
    pref[q] = d_r[q] * state[npix + p] + d_g[q] * state[2 * npix + p] + d_b[q] * state[3 * npix + p];
  }

  int done = 0;
  for (long long blk = seg_first; blk <= seg_last; ++blk) {
    bool active = false;
#pragma unroll
    for (int q = 0; q < PPT; ++q) active |= trans[q] >= eps;
    if (!__syncthreads_or(active)) break;  // tile saturated: skip the rest

    const long long lo = blk * chunk > start ? blk * chunk : start;
    const long long hi = (blk + 1) * chunk < end ? (blk + 1) * chunk : end;
    const int m = (int)(hi - lo);
    for (int i = tid; i < m; i += nthreads) {
      const long long g = lo + i;
      const float a1x = fields[2 * k + g], a1y = fields[3 * k + g];
      const float a2x = fields[4 * k + g], a2y = fields[5 * k + g];
      const float a1_sq = fmaxf(a1x * a1x + a1y * a1y, 1e-12f);
      const float a2_sq = fmaxf(a2x * a2x + a2y * a2y, 1e-12f);
      s_cx[i] = fields[g];
      s_cy[i] = fields[k + g];
      s_ux[i] = a1x / a1_sq;
      s_uy[i] = a1y / a1_sq;
      s_vx[i] = a2x / a2_sq;
      s_vy[i] = a2y / a2_sq;
      s_r[i] = fields[6 * k + g];
      s_g[i] = fields[7 * k + g];
      s_b[i] = fields[8 * k + g];
      s_op[i] = fields[9 * k + g];
    }
    __syncthreads();

    float run[PPT], su[PPT];  // in-step prefix product of (1 - alpha) and sum of u
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      run[q] = 1.0f;
      su[q] = 0.0f;
    }
    for (int b0 = 0; b0 < m; b0 += kBatch) {
      const int nb = m - b0 < kBatch ? m - b0 : kBatch;
      for (int j0 = 0; j0 < nb; j0 += kGroup) {
        float acc[kGroup * kFields];  // this thread's sums, [pair of the group][field]
#pragma unroll
        for (int v = 0; v < kGroup * kFields; ++v) acc[v] = 0.0f;
        bool any = false;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (j0 + g >= nb) break;  // the batch's ragged end, the same for the whole block
          const int i = b0 + j0 + g;
          float* a = acc + g * kFields;
          const float cx = s_cx[i], cy = s_cy[i];
          const float ux = s_ux[i], uy = s_uy[i], vx = s_vx[i], vy = s_vy[i];
          const float cr = s_r[i], cg = s_g[i], cb = s_b[i], op = s_op[i];
#pragma unroll
          for (int q = 0; q < PPT; ++q) {
            const float dx = px[q] - cx;
            const float dy = py[q] - cy;
            const float qx = dx * ux + dy * uy;
            const float qy = dx * vx + dy * vy;
            const float expp = expf(-(qx * qx + qy * qy));
            const float alpha_raw = expp * op;
            const float alpha = fminf(alpha_raw, alpha_max);
            bool keep = alpha >= alpha_discard;
            if (quad_clip) keep = keep && fabsf(qx) <= 2.0f && fabsf(qy) <= 2.0f;
            if (keep) {
              any = true;
              const float t_i = trans[q] * run[q];
              const float w = t_i * alpha;
              const float e = cr * d_r[q] + cg * d_g[q] + cb * d_b[q];
              su[q] += w * e;
              const float d_suffix = d_ctot[q] - (pref[q] + su[q]);
              const float one_minus = 1.0f - alpha;
              const float inv_om = 1.0f / fmaxf(one_minus, 1e-6f);
              run[q] *= one_minus;
              a[6] += w * d_r[q];
              a[7] += w * d_g[q];
              a[8] += w * d_b[q];
              if (!(alpha_raw > alpha_max)) {
                const float dalpha = t_i * e - d_suffix * inv_om + d_at[q] * inv_om;
                const float gx = dalpha * (-2.0f * qx) * alpha;
                const float gy = dalpha * (-2.0f * qy) * alpha;
                a[0] += gx;
                a[1] += gy;
                a[2] += gx * dx;
                a[3] += gx * dy;
                a[4] += gy * dx;
                a[5] += gy * dy;
                a[9] += dalpha * expp;
              }
            }
          }
        }
        // The group's 40 sums over the warp (all zero where no lane kept a
        // pair): lane l ends with sums 5 * (l / 4) .. 5 * (l / 4) + 4.
        if (__any_sync(kFull, any)) warp_transpose_sum(acc, lane);
        if (lane % 4 == 0) {
#pragma unroll
          for (int v = 0; v < kPerLane; ++v) {
            const int idx = (lane / 4) * kPerLane + v;  // pair idx / kFields, field idx % kFields
            part[(warp * kFields + idx % kFields) * kBatch + j0 + idx / kFields] = acc[v];
          }
        }
      }
      __syncthreads();
      for (int it = tid; it < kFields * kBatch; it += nthreads) {
        const int f = it / kBatch, j = it % kBatch;
        if (j < nb) {
          float s = 0.0f;
          for (int w = 0; w < nwarps; ++w) s += part[(w * kFields + f) * kBatch + j];
          tot[f * kBatch + j] = s;
        }
      }
      __syncthreads();
      if (tid < nb) {
        const long long g = lo + b0 + tid;
        const float a1x = fields[2 * k + g], a1y = fields[3 * k + g];
        const float a2x = fields[4 * k + g], a2y = fields[5 * k + g];
        const float inv1 = 1.0f / fmaxf(a1x * a1x + a1y * a1y, 1e-12f);
        const float inv2 = 1.0f / fmaxf(a2x * a2x + a2y * a2y, 1e-12f);
        const float sgx = tot[0 * kBatch + tid], sgy = tot[1 * kBatch + tid];
        const float sgx_dx = tot[2 * kBatch + tid], sgx_dy = tot[3 * kBatch + tid];
        const float sgy_dx = tot[4 * kBatch + tid], sgy_dy = tot[5 * kBatch + tid];
        const float sgx_qx = (a1x * sgx_dx + a1y * sgx_dy) * inv1;  // sum gx * qx
        const float sgy_qy = (a2x * sgy_dx + a2y * sgy_dy) * inv2;
        const long long slot = perm[g];
        store(out, slot, -(a1x * inv1) * sgx - (a2x * inv2) * sgy);
        store(out, k + slot, -(a1y * inv1) * sgx - (a2y * inv2) * sgy);
        store(out, 2 * k + slot, (sgx_dx - 2.0f * sgx_qx * a1x) * inv1);
        store(out, 3 * k + slot, (sgx_dy - 2.0f * sgx_qx * a1y) * inv1);
        store(out, 4 * k + slot, (sgy_dx - 2.0f * sgy_qy * a2x) * inv2);
        store(out, 5 * k + slot, (sgy_dy - 2.0f * sgy_qy * a2y) * inv2);
        store(out, 6 * k + slot, tot[6 * kBatch + tid]);
        store(out, 7 * k + slot, tot[7 * kBatch + tid]);
        store(out, 8 * k + slot, tot[8 * kBatch + tid]);
        store(out, 9 * k + slot, tot[9 * kBatch + tid]);
      }
    }
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      trans[q] = trans[q] * run[q];
      pref[q] = pref[q] + su[q];
    }
    done += m;
    __syncthreads();  // the next step overwrites the stage
  }
  if (tid == 0 && done > 0) atomicAdd(&pairs_done[t], done);
}

template <typename OutT>
using Kernel = void (*)(const float*, long long, const int*, int, int, int, int, float, float, float,
                        int, const float*, const float*, const long long*, OutT*, int*, const int*,
                        const int*, const int*, int, int, const float*, const int*);

template <typename OutT>
Kernel<OutT> kernel_for(int ppt) {
  switch (ppt) {
    case 1: return composite_bwd_kernel<1, OutT>;
    case 2: return composite_bwd_kernel<2, OutT>;
    case 4: return composite_bwd_kernel<4, OutT>;
    case 8: return composite_bwd_kernel<8, OutT>;
    case 16: return composite_bwd_kernel<16, OutT>;
    default: return nullptr;
  }
}

template <typename OutT>
cudaError_t launch(int ppt, int blocks, int threads, size_t smem, cudaStream_t stream,
                   const float* fields, long long k, const int* tile_starts, int tiles_x,
                   int tile_w, int tile_h, int chunk, float eps, float alpha_discard,
                   float alpha_max, int quad_clip, const float* raw, const float* dout,
                   const long long* perm, void* out, int* pairs_done, const int* seg_order,
                   const int* seg_tile, const int* seg_starts, int num_tiles, int segment_steps,
                   const float* ckpt, const int* fwd_done) {
  const Kernel<OutT> kernel = kernel_for<OutT>(ppt);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, threads, smem, stream>>>(
      fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk, eps, alpha_discard, alpha_max,
      quad_clip, raw, dout, perm, (OutT*)out, pairs_done, seg_order, seg_tile, seg_starts,
      num_tiles, segment_steps, ckpt, fwd_done);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* composite_bwd_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// Pixels per thread for a tile of npix pixels: the fewest that keep a block
// at <= 512 threads, a whole number of warps.  0 when no supported split.
int composite_bwd_pixels_per_thread(int npix) {
  for (int ppt = 1; ppt <= 16; ppt *= 2) {
    if (npix % ppt == 0 && npix / ppt <= 512 && (npix / ppt) % 32 == 0) return ppt;
  }
  return 0;
}

// fields (10, k) float32 in sorted pair order; tile_starts (num_tiles + 1,)
// int32; raw, dout (num_tiles + 1, 4, tile_w * tile_h) float32 (forward
// output, upstream gradient); perm (k,) int64 slot of each sorted pair;
// out (10, k) float32, or bfloat16 when bf16 != 0, zeroed by the caller (only
// the slots of pairs the walk reaches are written); pairs_done (num_tiles,)
// int32, zeroed by the caller, gets the pairs walked before the exit.  K1's
// checkpoints: ckpt (segments, 4, tile_w * tile_h) float32, seg_starts
// (num_tiles + 1,) int32 the first segment of each tile, fwd_done
// (num_tiles,) int32 K1's pairs per tile.  One block per entry of seg_order
// (segments,) int32, the segments in launch order; seg_tile (segments,)
// int32 the tile of each segment.  Launches on `stream`; returns
// cudaGetLastError().
int composite_bwd_launch(const float* fields, long long k, const int* tile_starts,
                         int num_tiles, int tiles_x, int tile_w, int tile_h, int chunk,
                         float eps, float alpha_discard, float alpha_max, int quad_clip,
                         const float* raw, const float* dout, const long long* perm, int bf16,
                         void* out, int* pairs_done, const int* seg_order, const int* seg_tile,
                         const int* seg_starts, int segments, int segment_steps,
                         const float* ckpt, const int* fwd_done, void* stream) {
  const int npix = tile_w * tile_h;
  const int ppt = composite_bwd_pixels_per_thread(npix);
  const int threads = ppt ? npix / ppt : 0;
  const size_t smem =
      ((size_t)kFields * chunk + (size_t)(threads / 32) * kFields * kBatch + kFields * kBatch) *
      sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    return (int)launch<unsigned short>(
        ppt, segments, threads, smem, st, fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk,
        eps, alpha_discard, alpha_max, quad_clip, raw, dout, perm, out, pairs_done, seg_order,
        seg_tile, seg_starts, num_tiles, segment_steps, ckpt, fwd_done);
  }
  return (int)launch<float>(
      ppt, segments, threads, smem, st, fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk,
      eps, alpha_discard, alpha_max, quad_clip, raw, dout, perm, out, pairs_done, seg_order,
      seg_tile, seg_starts, num_tiles, segment_steps, ckpt, fwd_done);
}

}  // extern "C"
