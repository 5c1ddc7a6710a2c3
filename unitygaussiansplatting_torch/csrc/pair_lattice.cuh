// The composite fields' lattices, decoded as the TPU package's pack / sort /
// unpack round trips them: shared by K2 (csrc/pair_expand.cu), which decodes
// a slot's fields, and the per-splat pass (csrc/pair_table.cu), which encodes
// the axis codes and decodes a splat's fields once into K1's record.  One
// definition, so that both round every value alike (both are built with
// --fmad=false).

#pragma once

#include <cuda_fp16.h>

namespace pair_lattice {

// The kernels' flag word (pair_expand.expand_flags).
constexpr int kQuadClip = 1;
constexpr int kPackCenter = 2;
constexpr int kPackAx32 = 4;
constexpr int kPackAxesF16 = 8;
constexpr int kPackColorF16 = 16;
constexpr int kPackRgba8 = 32;

// pack_axes_u32 lattice constants, rounded from the same double expressions
// as tile_common.py.
constexpr float kPi = (float)3.14159265358979324;
constexpr float kThetaStep = (float)(6.2831853071795864769 / 4096.0);
constexpr float kAx32Lo = (float)-1.3219281;
constexpr float kAx32Step = (float)((12.0 - -1.3219281) / 1023.0);

__device__ __forceinline__ float f16_round_trip(float x) {
  // Exact on the flushed f16 lattice that quantize_view_fp16 produces.
  float r = __half2float(__float2half_rn(x));
  return fabsf(r) < 6.103515625e-05f ? copysignf(0.0f, x) : r;
}

__device__ __forceinline__ float unorm8_round_trip(float x, float scale) {
  unsigned code = (unsigned)(int)floorf(x * scale + 0.5f) & 0xFFu;
  return (float)code / scale;
}

struct Axes {
  float a1x, a1y, a2x, a2y;
};

// The axes of table rows 2/3 under pack_axes_u32, which hold the codes
// theta*1024 + n1 and n2 (float32-exact integers).
__device__ __forceinline__ Axes decode_ax32(float code1, float code2) {
  const float tcv = floorf(code1 * (1.0f / 1024.0f));
  const float n1cv = code1 - tcv * 1024.0f;
  const float theta = tcv * kThetaStep - kPi;
  const float ct = cosf(theta), st = sinf(theta);
  const float n1v = exp2f(kAx32Lo + n1cv * kAx32Step);
  const float n2v = exp2f(kAx32Lo + code2 * kAx32Step);
  return Axes{n1v * ct, n1v * st, n2v * st, -n2v * ct};
}

}  // namespace pair_lattice
