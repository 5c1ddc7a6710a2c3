// Backward tile composite (K3): the VJP of the forward composite (K1), per
// (splat, tile) pair.
//
// Replaces the Pallas kernel `_bwd_kernel` of
// unitygaussiansplatting_tpu/ops/rasterize_pallas_bwd.py (launched by its
// `composite_pallas_bwd`) and the fold of its per-step blocks into pairs
// (`steps_to_pair_gradients`): here a pair belongs to one tile and one block,
// so no two steps share a block and there is nothing to fold.
//
// One thread block per tile, as in K1; each thread owns PPT pixels, and a
// warp's pixels are PPT runs of 32 consecutive pixels.  The block walks the
// tile's pairs in steps cut at global multiples of `chunk` and replays K1's
// alpha in K1's term order.  Per pixel it carries the transmittance T (a
// product, the TPU kernel's own rule) and the prefix of u = w * (D . c); with
// D = dL/d(rgb), dA = dL/d(coverage) and the saved forward output (C_tot, A):
//   t_i = T_step * prod_{earlier in step}(1 - alpha),  w_i = t_i * alpha_i,
//   dL/dalpha_i = t_i (D . c_i) - (D . C_tot - prefix_i(u)) / (1 - alpha_i)
//                 + dA (1 - A) / (1 - alpha_i),
// zero where alpha was discarded or clipped at alpha_max.  Before each step
// the block tests the tile's max T against transmittance_eps and stops below
// it, as the TPU kernel does.  Per pair it sums ten per-pixel terms over the
// tile's pixels (sum gx, gy, gx dx, gx dy, gy dx, gy dy, w D_r, w D_g, w D_b,
// dalpha exp(power); gx = dL/dqx) and turns them into the gradients of the
// pair's cx, cy, a1x, a1y, a2x, a2y, r, g, b, opacity.
//
// Reduction: per thread over its pixels, then a fixed xor-shuffle tree in the
// warp, then a fixed-order pass over the warps in shared memory, 32 pairs at
// a time.  No float atomics: two launches give identical bits.  Each pair's
// ten gradients go straight to its slot, column perm[j] of the (10, K)
// output (f32, or bf16 rounded to nearest even with -0 stored as +0), so the
// output is grouped in K2's splat-major runs for the run reduce (K4).
//
// Bound on the H100: fp32 operations (~31 per evaluated pair and pixel for
// the alpha replay, ~43 more where the pixel keeps the pair).  Design: the
// per-pair divisions are hoisted into the shared-memory staging; a warp whose
// pixels all drop a pair skips that pair's shuffle reduction.  Build with
// --fmad=false so the alpha replay rounds like K1 and the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFields = 10;  // cx, cy, a1x, a1y, a2x, a2y, r, g, b, opacity
constexpr int kBatch = 32;   // pairs per shared-memory reduction round
constexpr unsigned kFull = 0xffffffffu;

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
                     OutT* __restrict__ out, int* __restrict__ pairs_done) {
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

  const int t = blockIdx.x;
  const int npix = tile_w * tile_h;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int start = tile_starts[t];
  const int end = tile_starts[t + 1];
  const float tx0 = (float)(t % tiles_x) * (float)tile_w;
  const float ty0 = (float)(t / tiles_x) * (float)tile_h;
  const float* fwd = raw + (long long)t * 4 * npix;
  const float* dg = dout + (long long)t * 4 * npix;

  // Per pixel: position, upstream gradient, D . C_tot, dA * T_final, and the
  // carried transmittance and prefix of u.
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
    trans[q] = 1.0f;
    pref[q] = 0.0f;
  }

  int done = 0;
  if (end > start) {
    const long long first = start / chunk, last = (end - 1) / chunk;
    for (long long blk = first; blk <= last; ++blk) {
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
        for (int j = 0; j < nb; ++j) {
          const int i = b0 + j;
          const float cx = s_cx[i], cy = s_cy[i];
          const float ux = s_ux[i], uy = s_uy[i], vx = s_vx[i], vy = s_vy[i];
          const float cr = s_r[i], cg = s_g[i], cb = s_b[i], op = s_op[i];
          float acc[kFields];
#pragma unroll
          for (int f = 0; f < kFields; ++f) acc[f] = 0.0f;
          bool any = false;
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
              acc[6] += w * d_r[q];
              acc[7] += w * d_g[q];
              acc[8] += w * d_b[q];
              if (!(alpha_raw > alpha_max)) {
                const float dalpha = t_i * e - d_suffix * inv_om + d_at[q] * inv_om;
                const float gx = dalpha * (-2.0f * qx) * alpha;
                const float gy = dalpha * (-2.0f * qy) * alpha;
                acc[0] += gx;
                acc[1] += gy;
                acc[2] += gx * dx;
                acc[3] += gx * dy;
                acc[4] += gy * dx;
                acc[5] += gy * dy;
                acc[9] += dalpha * expp;
              }
            }
          }
          if (__any_sync(kFull, any)) {
#pragma unroll
            for (int f = 0; f < kFields; ++f) {
#pragma unroll
              for (int s = 16; s > 0; s >>= 1) acc[f] += __shfl_xor_sync(kFull, acc[f], s);
            }
          }
          if (lane == 0) {
#pragma unroll
            for (int f = 0; f < kFields; ++f) part[(warp * kFields + f) * kBatch + j] = acc[f];
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
  }
  if (tid == 0) pairs_done[t] = done;
}

template <int PPT, typename OutT>
cudaError_t launch(int num_tiles, int threads, size_t smem, cudaStream_t stream,
                   const float* fields, long long k, const int* tile_starts, int tiles_x,
                   int tile_w, int tile_h, int chunk, float eps, float alpha_discard,
                   float alpha_max, int quad_clip, const float* raw, const float* dout,
                   const long long* perm, void* out, int* pairs_done) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(composite_bwd_kernel<PPT, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  composite_bwd_kernel<PPT, OutT><<<num_tiles, threads, smem, stream>>>(
      fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk, eps, alpha_discard, alpha_max,
      quad_clip, raw, dout, perm, (OutT*)out, pairs_done);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(int ppt, int num_tiles, int threads, size_t smem, cudaStream_t st,
                     const float* fields, long long k, const int* tile_starts, int tiles_x,
                     int tile_w, int tile_h, int chunk, float eps, float alpha_discard,
                     float alpha_max, int quad_clip, const float* raw, const float* dout,
                     const long long* perm, void* out, int* pairs_done) {
  switch (ppt) {
    case 1: return launch<1, OutT>(num_tiles, threads, smem, st, fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk, eps, alpha_discard, alpha_max, quad_clip, raw, dout, perm, out, pairs_done);
    case 2: return launch<2, OutT>(num_tiles, threads, smem, st, fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk, eps, alpha_discard, alpha_max, quad_clip, raw, dout, perm, out, pairs_done);
    case 4: return launch<4, OutT>(num_tiles, threads, smem, st, fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk, eps, alpha_discard, alpha_max, quad_clip, raw, dout, perm, out, pairs_done);
    case 8: return launch<8, OutT>(num_tiles, threads, smem, st, fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk, eps, alpha_discard, alpha_max, quad_clip, raw, dout, perm, out, pairs_done);
    case 16: return launch<16, OutT>(num_tiles, threads, smem, st, fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk, eps, alpha_discard, alpha_max, quad_clip, raw, dout, perm, out, pairs_done);
    default: return cudaErrorInvalidValue;
  }
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
// int32 pairs walked before the exit.  Launches on `stream`; returns
// cudaGetLastError().
int composite_bwd_launch(const float* fields, long long k, const int* tile_starts,
                         int num_tiles, int tiles_x, int tile_w, int tile_h, int chunk,
                         float eps, float alpha_discard, float alpha_max, int quad_clip,
                         const float* raw, const float* dout, const long long* perm, int bf16,
                         void* out, int* pairs_done, void* stream) {
  const int npix = tile_w * tile_h;
  const int ppt = composite_bwd_pixels_per_thread(npix);
  const int threads = ppt ? npix / ppt : 0;
  const size_t smem =
      ((size_t)kFields * chunk + (size_t)(threads / 32) * kFields * kBatch + kFields * kBatch) *
      sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (bf16) {
    e = dispatch<unsigned short>(ppt, num_tiles, threads, smem, st, fields, k, tile_starts,
                                 tiles_x, tile_w, tile_h, chunk, eps, alpha_discard, alpha_max,
                                 quad_clip, raw, dout, perm, out, pairs_done);
  } else {
    e = dispatch<float>(ppt, num_tiles, threads, smem, st, fields, k, tile_starts, tiles_x,
                        tile_w, tile_h, chunk, eps, alpha_discard, alpha_max, quad_clip, raw,
                        dout, perm, out, pairs_done);
  }
  return (int)e;
}

}  // extern "C"
