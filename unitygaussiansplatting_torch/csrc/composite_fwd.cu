// Forward tile composite (K1): front-to-back "under" compositing of each
// tile's depth-sorted pairs.
//
// Replaces the Pallas kernel `_kernel` of
// unitygaussiansplatting_tpu/ops/rasterize_pallas.py (schedule from its
// `build_schedule`).  The tile's pixels are split over a thread-block cluster
// of C CTAs (C the largest power of two up to 8 that leaves each CTA whole
// warps); each thread owns PPT of its CTA's pixels.  Every CTA walks the
// tile's pair range [tile_starts[t], tile_starts[t+1]) in steps cut at global
// multiples of `chunk` (the TPU kernel's grid steps), stages a step's pairs in
// its own shared memory, and per pixel:
//   alpha = clip(exp(-|q|^2) * opacity, 0, alpha_max), q = eigen-axis coords,
//   dropped where alpha < alpha_discard or (quad_clip) |q|_inf > 2;
//   rgb += T * prod_{earlier in step}(1 - alpha) * alpha * color;
//   coverage = 1 - T * prod_{step}(1 - alpha),  T = 1 - coverage at step start.
// Before each step the cluster checks the tile's max T; once it is below
// transmittance_eps the rest of the tile is skipped.  This per-tile, per-step
// exit is part of the function (a per-pixel exit moves pixels by ~1e-4), so
// the CTAs take it together: each CTA's OR goes into every CTA's shared
// memory (distributed shared memory, double-buffered by step parity), one
// cluster barrier, and every CTA reads the same OR.
// Output: raw (T+1, 4, P) premultiplied rgb + coverage per tile (row T, the
// sentinel tile, stays as the caller allocated it: zero), and per tile the
// number of pairs composited before the exit.
//
// Checkpoints for the backward (K3), when `ckpt` is not null: each tile's walk
// is cut into segments of `segment_steps` steps; at the start of each segment
// the walk reaches, every pixel's transmittance as a product of the steps'
// prod(1 - alpha) (K3's own rule, carried beside the coverage) and its three
// color sums go to ckpt[(seg_starts[t] + segment) * 4 * P + {0,1,2,3} * P + p].
// K3 starts one block per segment from them.
//
// A pair's inputs come from one of two layouts.  The sorted per-slot fields
// (10, k) (cx, cy, a1x, a1y, a2x, a2y, r, g, b, opacity), staged with the
// per-pair divisions done once; or, with `pair_rank`, the per-splat record
// (n, 12) of csrc/pair_table.cu, already in the stage's three float4 and
// read at row pair_rank[g] (the splat id the pair sort writes for sorted
// pair g): a coalesced 4-byte id, then three 16-byte loads.  The two give
// the stage the same bits wherever each pair's fields depend on its splat
// alone (no center packing).
//
// Bound on the H100: instruction issue.  The function needs 25 instructions
// per pair and pixel evaluated (an accurate expf among them) and 10 more where
// the pixel keeps the pair; this loop issues ~36 and ~11.  It reads 40 bytes
// of fields a pair, or 4 of id and 48 of record.  Design: the cluster spreads
// the busiest tile over C SMs, and clusters start heaviest tile first
// (`tile_order`); the per-pair divisions are done before the pixel loop, so
// it is multiplies, adds and one expf; a pair's stage is read as two float4
// warp broadcasts (a third, its color, where the pixel keeps it).
// Build with --fmad=false: the term order of q must round like the plain
// PyTorch version's, and without fast math expf stays the accurate one.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kStageFloats = 12;  // per pair in shared memory: three float4
constexpr int kMaxCluster = 8;
constexpr int kMaxThreads = 512;

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
composite_fwd_kernel(const float* __restrict__ fields, long long k, const int* __restrict__ pair_rank,
                     const int* __restrict__ tile_starts, const int* __restrict__ tile_order,
                     int tiles_x, int tile_w, int tile_h, int chunk, float eps,
                     float alpha_discard, float alpha_max, int quad_clip,
                     float* __restrict__ raw, int* __restrict__ pairs_done,
                     const int* __restrict__ seg_starts, int segment_steps,
                     float* __restrict__ ckpt) {
  // The step's pairs, three float4 per pair: (cx, cy, u) and (v, opacity, 0)
  // with u = a1 / |a1|^2, v = a2 / |a2|^2, read by every pixel; (r, g, b, 0),
  // read where the pixel keeps the pair.
  extern __shared__ float4 stage[];
  __shared__ int exit_or[2][kMaxCluster];  // [step parity][CTA rank]
  float4* s_cu = stage;
  float4* s_vo = s_cu + chunk;
  float4* s_rgb = s_vo + chunk;

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = tile_order[blockIdx.x / csize];
  const int npix = tile_w * tile_h;
  const int nthreads = blockDim.x;
  const int p0 = rank * (npix / csize);  // this CTA's pixels: [p0, p0 + npix / csize)
  const int start = tile_starts[t];
  const int end = tile_starts[t + 1];
  const float tx0 = (float)(t % tiles_x) * (float)tile_w;
  const float ty0 = (float)(t / tiles_x) * (float)tile_h;

  float px[PPT], py[PPT], cov[PPT], tprod[PPT], acc_r[PPT], acc_g[PPT], acc_b[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = p0 + threadIdx.x + q * nthreads;
    px[q] = tx0 + (float)(p % tile_w) + 0.5f;
    py[q] = ty0 + (float)(p / tile_w) + 0.5f;
    cov[q] = 0.0f;
    tprod[q] = 1.0f;
    acc_r[q] = acc_g[q] = acc_b[q] = 0.0f;
  }

  int done = 0;
  if (end > start) {
    // Every CTA of the cluster must run before any writes into another's
    // shared memory.  All CTAs of a cluster share the tile, so they make the
    // same number of cluster barriers.
    cluster.sync();
    const long long first = start / chunk, last = (end - 1) / chunk;
    for (long long blk = first; blk <= last; ++blk) {
      const int step = (int)(blk - first);
      bool active = false;
#pragma unroll
      for (int q = 0; q < PPT; ++q) active |= (1.0f - cov[q]) >= eps;
      const int mine = __syncthreads_or(active);
      // A CTA reaches step + 2's writes only after every CTA passed step + 1's
      // barrier, i.e. after it read this step's flags: two buffers suffice.
      if (threadIdx.x < csize) *cluster.map_shared_rank(&exit_or[step & 1][rank], threadIdx.x) = mine;
      cluster.sync();
      int any = 0;
      for (int r = 0; r < csize; ++r) any |= exit_or[step & 1][r];
      if (!any) break;  // tile saturated: skip the rest

      if (ckpt != nullptr && step % segment_steps == 0) {
        float* st = ckpt + (long long)(seg_starts[t] + step / segment_steps) * 4 * npix;
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          const int p = p0 + threadIdx.x + q * nthreads;
          st[p] = tprod[q];
          st[npix + p] = acc_r[q];
          st[2 * npix + p] = acc_g[q];
          st[3 * npix + p] = acc_b[q];
        }
      }

      const long long lo = blk * chunk > start ? blk * chunk : start;
      const long long hi = (blk + 1) * chunk < end ? (blk + 1) * chunk : end;
      const int m = (int)(hi - lo);
      for (int i = threadIdx.x; i < m; i += nthreads) {
        const long long g = lo + i;
        if (pair_rank != nullptr) {
          const float4* rec = reinterpret_cast<const float4*>(fields) + 3 * (long long)pair_rank[g];
          s_cu[i] = rec[0];
          s_vo[i] = rec[1];
          s_rgb[i] = rec[2];
          continue;
        }
        const float a1x = fields[2 * k + g], a1y = fields[3 * k + g];
        const float a2x = fields[4 * k + g], a2y = fields[5 * k + g];
        const float a1_sq = fmaxf(a1x * a1x + a1y * a1y, 1e-12f);
        const float a2_sq = fmaxf(a2x * a2x + a2y * a2y, 1e-12f);
        s_cu[i] = make_float4(fields[g], fields[k + g], a1x / a1_sq, a1y / a1_sq);
        s_vo[i] = make_float4(a2x / a2_sq, a2y / a2_sq, fields[9 * k + g], 0.0f);
        s_rgb[i] = make_float4(fields[6 * k + g], fields[7 * k + g], fields[8 * k + g], 0.0f);
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
        const float4 cu = s_cu[i], vo = s_vo[i];
        const float cx = cu.x, cy = cu.y, ux = cu.z, uy = cu.w, vx = vo.x, vy = vo.y, op = vo.z;
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
            const float4 c = s_rgb[i];
            const float w = run[q] * alpha * trans[q];
            step_r[q] += w * c.x;
            step_g[q] += w * c.y;
            step_b[q] += w * c.z;
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
        tprod[q] *= run[q];
      }
      done += m;
      __syncthreads();  // the next step overwrites the stage
    }
  }

  float* out = raw + (long long)t * 4 * npix;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = p0 + threadIdx.x + q * nthreads;
    out[p] = acc_r[q];
    out[npix + p] = acc_g[q];
    out[2 * npix + p] = acc_b[q];
    out[3 * npix + p] = cov[q];
  }
  if (rank == 0 && threadIdx.x == 0) pairs_done[t] = done;
}

// Cluster size for a tile of npix pixels: the largest power of two up to 8
// that leaves each CTA a whole number of warps; 0 when npix is not a
// multiple of 32.
int cluster_size(int npix) {
  for (int c = kMaxCluster; c >= 1; c /= 2) {
    if (npix % (32 * c) == 0) return c;
  }
  return 0;
}

// Pixels per thread: the fewest that keep a CTA at <= 512 threads, whole
// warps.  0 when no supported split.
int pixels_per_thread(int npix) {
  const int c = cluster_size(npix);
  if (c == 0) return 0;
  const int own = npix / c;
  for (int ppt = 1; ppt <= 16; ppt *= 2) {
    if (own % ppt == 0 && own / ppt <= kMaxThreads && (own / ppt) % 32 == 0) return ppt;
  }
  return 0;
}

using Kernel = void (*)(const float*, long long, const int*, const int*, const int*, int, int, int, int,
                        float, float, float, int, float*, int*, const int*, int, float*);

Kernel kernel_for(int ppt) {
  switch (ppt) {
    case 1: return composite_fwd_kernel<1>;
    case 2: return composite_fwd_kernel<2>;
    case 4: return composite_fwd_kernel<4>;
    case 8: return composite_fwd_kernel<8>;
    case 16: return composite_fwd_kernel<16>;
    default: return nullptr;
  }
}

// The launch configuration of `clusters` clusters for a tile of npix pixels
// and a stage of `chunk` pairs; sets the kernel's shared-memory limit.
cudaError_t configure(int npix, int chunk, int clusters, cudaStream_t stream, Kernel* kernel,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const int c = cluster_size(npix);
  const int ppt = pixels_per_thread(npix);
  *kernel = kernel_for(ppt);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  // Set always: the static exit flags count against the 48 KB a kernel gets
  // without it, so a 48 KB stage (chunk 1024) already needs it.
  const size_t smem = (size_t)kStageFloats * chunk * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(clusters * c));
  cfg->blockDim = dim3((unsigned)(npix / c / ppt));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* composite_fwd_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

int composite_fwd_cluster_size(int npix) { return cluster_size(npix); }

int composite_fwd_pixels_per_thread(int npix) { return pixels_per_thread(npix); }

// How many clusters of this kernel the card can hold at once for a tile of
// npix pixels and a stage of `chunk` pairs (cudaOccupancyMaxActiveClusters);
// a negative CUDA error code if the query fails.
int composite_fwd_max_active_clusters(int npix, int chunk) {
  Kernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(npix, chunk, 1, nullptr, &kernel, &cfg, &attr);
  if (e != cudaSuccess) return -(int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// fields (10, k) float32 sorted by (tile, depth, splat), pair_rank null; or
// pair_rank (k,) int32, each sorted pair's splat id, and fields the per-splat
// record (n, 12) float32, 16-byte aligned.  tile_starts (num_tiles + 1,)
// int32; tile_order (num_tiles,) int32, the tiles in launch order; raw
// (num_tiles + 1, 4, tile_w * tile_h) float32; pairs_done (num_tiles,) int32.  ckpt null, or (segments, 4, tile_w * tile_h) float32
// with seg_starts (num_tiles + 1,) int32 the first segment of each tile.
// Launches on `stream`; returns the launch's error.
int composite_fwd_launch(const float* fields, long long k, const int* pair_rank, const int* tile_starts,
                         const int* tile_order, int num_tiles, int tiles_x, int tile_w,
                         int tile_h, int chunk, float eps, float alpha_discard, float alpha_max,
                         int quad_clip, float* raw, int* pairs_done, const int* seg_starts,
                         int segment_steps, float* ckpt, void* stream) {
  Kernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(tile_w * tile_h, chunk, num_tiles, (cudaStream_t)stream, &kernel, &cfg,
                            &attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaLaunchKernelEx(&cfg, kernel, fields, k, pair_rank, tile_starts, tile_order, tiles_x, tile_w,
                                 tile_h, chunk, eps, alpha_discard, alpha_max, quad_clip, raw,
                                 pairs_done, seg_starts, segment_steps, ckpt);
}

}  // extern "C"
