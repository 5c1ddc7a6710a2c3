// Grid probe of the pair expansion (K2): K2's launch with none of its work.
//
// Replaces the no-op Pallas kernels of tools/tpu_jobs/475_expand_overhead.py
// (`noop_variant` and `noop_fused_out`), which ran the TPU expansion kernel's
// grid and output blocks with zero compute to time its grid and output DMAs.
// Here: K2's launch geometry and store width (blocks of 256 threads, each
// block kWindowsPerBlock windows of 512 slots, two consecutive slots a
// thread: 16-byte key stores, 8-byte field stores), each thread writing zeros to K2's
// outputs for its slots, either all of them (the key, int64, and the 10
// field rows, float32: the probe's 6-out variant) or the key alone (its
// 1-out variant).  K2's fields are already one (10, k) array, so the
// fused-block variant has no separate counterpart.  Its time is K2's floor
// of launch + stores.
//
// Bound on the H100: bytes (48 or 8 per slot written, nothing read).

#include <cuda_runtime.h>

namespace {

constexpr int kFields = 10;
constexpr int kThreads = 256;  // as pair_expand.cu
constexpr int kSlotsPerThread = 2;
constexpr int kWindow = kThreads * kSlotsPerThread;
constexpr int kWindowsPerBlock = 8;

__global__ void __launch_bounds__(kThreads)
expand_probe_kernel(long long k, int keys_only, long long* __restrict__ comp,
                    float* __restrict__ fields) {
  for (int win = 0; win < kWindowsPerBlock; ++win) {
    const long long s =
        ((long long)blockIdx.x * kWindowsPerBlock + win) * kWindow + (long long)threadIdx.x * kSlotsPerThread;
    if (s >= k) return;
    if (k % 2 == 0 && s + 2 <= k) {  // as pair_expand.cu's store_slots
      *reinterpret_cast<longlong2*>(comp + s) = make_longlong2(0, 0);
      if (keys_only) continue;
#pragma unroll
      for (int r = 0; r < kFields; ++r)
        *reinterpret_cast<float2*>(fields + r * k + s) = make_float2(0.0f, 0.0f);
      continue;
    }
    for (long long q = s; q < s + kSlotsPerThread && q < k; ++q) {
      comp[q] = 0;
      if (keys_only) continue;
      for (int r = 0; r < kFields; ++r) fields[r * k + q] = 0.0f;
    }
  }
}

}  // namespace

extern "C" {

const char* expand_probe_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// comp (k,) int64; fields (10, k) float32, unused when keys_only != 0.
// Launches on `stream`; returns cudaGetLastError().
int expand_probe_launch(long long k, int keys_only, long long* comp, float* fields, void* stream) {
  const long long per_block = (long long)kWindow * kWindowsPerBlock;
  const long long blocks = (k + per_block - 1) / per_block;
  if (blocks == 0) return (int)cudaSuccess;
  expand_probe_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(k, keys_only, comp,
                                                                                fields);
  return (int)cudaGetLastError();
}

}  // extern "C"
