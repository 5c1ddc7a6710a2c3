// Forward tile composite (K1): front-to-back "under" compositing of each
// tile's depth-sorted pairs.
//
// Replaces the Pallas kernel `_kernel` of
// unitygaussiansplatting_tpu/ops/rasterize_pallas.py (schedule from its
// `build_schedule`).  One thread block per tile; each thread owns PPT pixels.
// The block walks the tile's pair range [tile_starts[t], tile_starts[t+1])
// in steps cut at global multiples of `chunk` (the TPU kernel's grid steps),
// stages a step's pairs in shared memory, and per pixel:
//   alpha = clip(exp(-|q|^2) * opacity, 0, alpha_max), q = eigen-axis coords,
//   dropped where alpha < alpha_discard or (quad_clip) |q|_inf > 2;
//   rgb += T * prod_{earlier in step}(1 - alpha) * alpha * color;
//   coverage = 1 - T * prod_{step}(1 - alpha),  T = 1 - coverage at step start.
// Before each step the block checks the tile's max T; once it is below
// transmittance_eps the rest of the tile is skipped.  This per-tile, per-step
// exit is part of the function: a per-pixel exit moves pixels by ~1e-4.
// Output: raw (T+1, 4, P) premultiplied rgb + coverage per tile (row T, the
// sentinel tile, stays as the caller allocated it: zero), and per tile the
// number of pairs composited before the exit.
//
// Bound on the H100: operations.  Each pair costs ~25 fp32 operations and one
// exp per pixel it is evaluated at; the fields it reads are 40 bytes per
// pair.  Design: the per-pair divisions are done once while staging, so the
// per-pixel loop is multiplies, adds and one expf; shared-memory reads are
// warp broadcasts.  Build with --fmad=false: the term order of q must round
// like the plain PyTorch version's, and without fast math expf stays the
// accurate one.

#include <cuda_runtime.h>

namespace {

constexpr int kFields = 10;  // cx, cy, a1x, a1y, a2x, a2y, r, g, b, opacity

template <int PPT>
__global__ void composite_fwd_kernel(const float* __restrict__ fields, long long k,
                                     const int* __restrict__ tile_starts, int tiles_x,
                                     int tile_w, int tile_h, int chunk, float eps,
                                     float alpha_discard, float alpha_max, int quad_clip,
                                     float* __restrict__ raw, int* __restrict__ pairs_done) {
  extern __shared__ float stage[];  // kFields rows of `chunk` floats
  float* s_cx = stage;
  float* s_cy = s_cx + chunk;
  float* s_ux = s_cy + chunk;  // a1 / |a1|^2
  float* s_uy = s_ux + chunk;
  float* s_vx = s_uy + chunk;  // a2 / |a2|^2
  float* s_vy = s_vx + chunk;
  float* s_r = s_vy + chunk;
  float* s_g = s_r + chunk;
  float* s_b = s_g + chunk;
  float* s_op = s_b + chunk;

  const int t = blockIdx.x;
  const int npix = tile_w * tile_h;
  const int nthreads = blockDim.x;
  const int start = tile_starts[t];
  const int end = tile_starts[t + 1];
  const float tx0 = (float)(t % tiles_x) * (float)tile_w;
  const float ty0 = (float)(t / tiles_x) * (float)tile_h;

  float px[PPT], py[PPT], cov[PPT], acc_r[PPT], acc_g[PPT], acc_b[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = threadIdx.x + q * nthreads;
    px[q] = tx0 + (float)(p % tile_w) + 0.5f;
    py[q] = ty0 + (float)(p / tile_w) + 0.5f;
    cov[q] = 0.0f;
    acc_r[q] = acc_g[q] = acc_b[q] = 0.0f;
  }

  int done = 0;
  if (end > start) {
    const long long first = start / chunk, last = (end - 1) / chunk;
    for (long long blk = first; blk <= last; ++blk) {
      bool active = false;
#pragma unroll
      for (int q = 0; q < PPT; ++q) active |= (1.0f - cov[q]) >= eps;
      if (!__syncthreads_or(active)) break;  // tile saturated: skip the rest

      const long long lo = blk * chunk > start ? blk * chunk : start;
      const long long hi = (blk + 1) * chunk < end ? (blk + 1) * chunk : end;
      const int m = (int)(hi - lo);
      for (int i = threadIdx.x; i < m; i += nthreads) {
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

      float trans[PPT], run[PPT], step_r[PPT], step_g[PPT], step_b[PPT];
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        trans[q] = 1.0f - cov[q];
        run[q] = 1.0f;
        step_r[q] = step_g[q] = step_b[q] = 0.0f;
      }
      for (int i = 0; i < m; ++i) {
        const float cx = s_cx[i], cy = s_cy[i];
        const float ux = s_ux[i], uy = s_uy[i], vx = s_vx[i], vy = s_vy[i];
        const float op = s_op[i];
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          const float dx = px[q] - cx;
          const float dy = py[q] - cy;
          const float qx = dx * ux + dy * uy;
          const float qy = dx * vx + dy * vy;
          const float power = -(qx * qx + qy * qy);
          const float alpha = fminf(fmaxf(expf(power) * op, 0.0f), alpha_max);
          bool keep = alpha >= alpha_discard;
          if (quad_clip) keep = keep && fabsf(qx) <= 2.0f && fabsf(qy) <= 2.0f;
          if (keep) {
            const float w = run[q] * alpha * trans[q];
            step_r[q] += w * s_r[i];
            step_g[q] += w * s_g[i];
            step_b[q] += w * s_b[i];
            run[q] *= 1.0f - alpha;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        acc_r[q] += step_r[q];
        acc_g[q] += step_g[q];
        acc_b[q] += step_b[q];
        cov[q] = 1.0f - trans[q] * run[q];
      }
      done += m;
      __syncthreads();  // the next step overwrites the stage
    }
  }

  float* out = raw + (long long)t * 4 * npix;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = threadIdx.x + q * nthreads;
    out[p] = acc_r[q];
    out[npix + p] = acc_g[q];
    out[2 * npix + p] = acc_b[q];
    out[3 * npix + p] = cov[q];
  }
  if (threadIdx.x == 0) pairs_done[t] = done;
}

template <int PPT>
cudaError_t launch(int num_tiles, int threads, size_t smem, cudaStream_t stream,
                   const float* fields, long long k, const int* tile_starts, int tiles_x,
                   int tile_w, int tile_h, int chunk, float eps, float alpha_discard,
                   float alpha_max, int quad_clip, float* raw, int* pairs_done) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(composite_fwd_kernel<PPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  composite_fwd_kernel<PPT><<<num_tiles, threads, smem, stream>>>(
      fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk, eps, alpha_discard,
      alpha_max, quad_clip, raw, pairs_done);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* composite_fwd_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// Pixels per thread for a tile of npix pixels: the fewest that keep a block
// at <= 512 threads, a whole number of warps.  0 when no supported split.
int composite_fwd_pixels_per_thread(int npix) {
  for (int ppt = 1; ppt <= 16; ppt *= 2) {
    if (npix % ppt == 0 && npix / ppt <= 512 && (npix / ppt) % 32 == 0) return ppt;
  }
  return 0;
}

// fields (10, k) float32 sorted by (tile, depth, splat); tile_starts
// (num_tiles + 1,) int32; raw (num_tiles + 1, 4, tile_w * tile_h) float32;
// pairs_done (num_tiles,) int32.  Launches on `stream`; returns
// cudaGetLastError().
int composite_fwd_launch(const float* fields, long long k, const int* tile_starts,
                         int num_tiles, int tiles_x, int tile_w, int tile_h, int chunk,
                         float eps, float alpha_discard, float alpha_max, int quad_clip,
                         float* raw, int* pairs_done, void* stream) {
  const int npix = tile_w * tile_h;
  const int ppt = composite_fwd_pixels_per_thread(npix);
  const int threads = ppt ? npix / ppt : 0;
  const size_t smem = (size_t)kFields * chunk * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  switch (ppt) {
    case 1: e = launch<1>(num_tiles, threads, smem, st, fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk, eps, alpha_discard, alpha_max, quad_clip, raw, pairs_done); break;
    case 2: e = launch<2>(num_tiles, threads, smem, st, fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk, eps, alpha_discard, alpha_max, quad_clip, raw, pairs_done); break;
    case 4: e = launch<4>(num_tiles, threads, smem, st, fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk, eps, alpha_discard, alpha_max, quad_clip, raw, pairs_done); break;
    case 8: e = launch<8>(num_tiles, threads, smem, st, fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk, eps, alpha_discard, alpha_max, quad_clip, raw, pairs_done); break;
    case 16: e = launch<16>(num_tiles, threads, smem, st, fields, k, tile_starts, tiles_x, tile_w, tile_h, chunk, eps, alpha_discard, alpha_max, quad_clip, raw, pairs_done); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}

}  // extern "C"
