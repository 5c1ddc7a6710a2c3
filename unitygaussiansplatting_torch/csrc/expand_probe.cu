// Grid probe of the pair expansion (K2): K2's launch with none of its work.
//
// Replaces the no-op Pallas kernels of tools/tpu_jobs/475_expand_overhead.py
// (`noop_variant` and `noop_fused_out`), which ran the TPU expansion kernel's
// grid and output blocks with zero compute to time its grid and output DMAs.
// Here: K2's exact launch geometry (one thread per slot, 256 threads a
// block), each thread writing zeros to K2's outputs for its slot, either all
// of them (the key, int64, and the 10 field rows, float32: the probe's 6-out
// variant) or the key alone (its 1-out variant).  K2's fields are already one
// (10, k) array, so the fused-block variant has no separate counterpart.  Its
// time is K2's floor of launch + stores.
//
// Bound on the H100: bytes (48 or 8 per slot written, nothing read).

#include <cuda_runtime.h>

namespace {

constexpr int kFields = 10;

__global__ void expand_probe_kernel(long long k, int keys_only, long long* __restrict__ comp,
                                    float* __restrict__ fields) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= k) return;
  comp[s] = 0;
  if (keys_only) return;
  for (int r = 0; r < kFields; ++r) fields[r * k + s] = 0.0f;
}

}  // namespace

extern "C" {

const char* expand_probe_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// comp (k,) int64; fields (10, k) float32, unused when keys_only != 0.
// Launches on `stream`; returns cudaGetLastError().
int expand_probe_launch(long long k, int keys_only, long long* comp, float* fields, void* stream) {
  const int threads = 256;  // as expand_pairs_launch
  const long long blocks = (k + threads - 1) / threads;
  if (blocks == 0) return (int)cudaSuccess;
  expand_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(k, keys_only, comp,
                                                                               fields);
  return (int)cudaGetLastError();
}

}  // extern "C"
