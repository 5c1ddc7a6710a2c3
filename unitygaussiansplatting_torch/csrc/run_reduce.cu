// Run reduce (K4): per-splat sums of the per-pair gradients.
//
// Replaces the Pallas kernel `_run_reduce_kernel` of
// unitygaussiansplatting_tpu/ops/rasterize_pallas_bwd.py (launched by its
// `_run_reduce`, from `pair_gradients_to_splats`).  There a grouping sort
// brings each splat's pairs together and a one-hot MXU product sums them; here
// the backward composite (K3) has already written every pair's gradients into
// its slot, and K2's slots are splat-major: splat i owns the run
// [bounds[i], bounds[i+1]), clipped to the budget K.  So the reduction is a
// plain segmented sum over contiguous runs.
//
// One thread per splat sums its run of each of the 10 gradient rows in slot
// order, in float32 (bf16 input is widened exactly).  Fixed order, no atomics:
// the same input gives the same bits, and the plain PyTorch version, which
// adds in the same order, gives them too.  A run clipped to nothing (a splat
// whose slots all fell past the budget) sums to exactly 0.  The sentinel-slot
// invariant (a dead splat owns one zero slot) keeps untruncated runs
// non-empty; nothing here relies on it.
//
// Bound on the H100: bytes (10 rows of K gradients read once, N + 1 bounds,
// 10 x N sums written).  Adjacent threads own adjacent runs, so a warp's loads
// fall in one contiguous stretch of each row.

#include <cuda_runtime.h>

namespace {

constexpr int kFields = 10;
constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short bits) {
  return __uint_as_float((unsigned)bits << 16);
}

template <typename InT>
__global__ void run_reduce_kernel(const InT* __restrict__ grads, long long k,
                                  const int* __restrict__ bounds, int n,
                                  float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long b0 = bounds[i], b1 = bounds[i + 1];
  const long long s = b0 < k ? b0 : k;
  const long long e = b1 < k ? b1 : k;
  for (int f = 0; f < kFields; ++f) {
    const InT* row = grads + f * k;
    float acc = 0.0f;
    for (long long j = s; j < e; ++j) acc += widen(row[j]);
    out[f * (long long)n + i] = acc;
  }
}

}  // namespace

extern "C" {

const char* run_reduce_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// grads (10, k) float32, or bfloat16 when bf16 != 0, in slot order; bounds
// (n + 1,) int32 non-decreasing; out (10, n) float32.  Launches on `stream`;
// returns cudaGetLastError().
int run_reduce_launch(const void* grads, long long k, int bf16, const int* bounds, int n,
                      float* out, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    run_reduce_kernel<unsigned short><<<blocks, kThreads, 0, st>>>(
        (const unsigned short*)grads, k, bounds, n, out);
  } else {
    run_reduce_kernel<float><<<blocks, kThreads, 0, st>>>((const float*)grads, k, bounds, n, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
