// The per-frame asset decode: a DeviceAsset's quantized words -> the
// activated Gaussians (means, rotations, scales, opacities, base colour, SH).
//
// Replaces no TPU kernel: the TPU package's decode
// (unitygaussiansplatting_tpu/io/device_asset.py:decode_device) is XLA,
// which fuses it into a few loops; the port had kept it as ~330 eager
// PyTorch launches (bit-field shifts, divisions, chunk lerps, stacks), each
// a pass over the splats or their 15 SH coefficients with its intermediates
// in device memory.  This is the reference's own design: LoadSplatData
// (GaussianSplatting.hlsl:428-608) decodes each splat inside one compute
// kernel every frame.
//
// One block of 256 threads decodes one 256-splat chunk (io/formats.py
// CHUNK_SIZE, the unit of the ChunkInfo min/max rows), one thread a splat
// for the per-splat fields.  Bound on the H100 by bytes: a Medium splat
// reads 46 B of words and writes 236 B of floats, 180 of them SH.  So:
//   - the chunk's SH words (Norm11 or Norm6, 15 a splat) come into shared
//     memory as 16-byte loads; each thread then forms whole float4s of the
//     chunk's contiguous run of SH output and stores them, so every store
//     of the block is coalesced (no thread walks 45 floats at a 180-byte
//     stride, and no 46 KB output stage is needed);
//   - Norm6 SH has 32 or 64 codes a channel: the block computes each
//     code's value once (its division and chunk lerp) into a 128-entry
//     table and looks the coefficients up;
//   - means, scales and base colour, three floats a splat, go through a
//     shared stage and out as float4s; rotations go out as one float4 a
//     thread; the ragged last chunk is masked.
// Each field's format is a template parameter of its decode function (the
// SH format and the chunk table of the kernel); one kernel takes every
// format io/device_asset.py:decode_device_plain takes.  Float32 SH is not
// written: the wrapper returns the asset's own words as the plain version
// does.
//
// Every value rounds like the plain PyTorch version on the card, bit for
// bit: the same operations in the same order, float32 throughout; build
// with --fmad=false and without --use_fast_math.  ((u >> s) & m) as a float
// over m by an IEEE division (ops.tile_common.true_div); the chunk lerp as
// lo + x * (hi - lo); scale^8 as three squarings; the opacity's inverse
// square warp as sign(t) * sqrt(|t|) * 0.5 + 0.5; the smallest-three
// unpack with round half to even and its three squares summed in the order
// torch.sum's reduction takes on the card, (x0 + x2) + x1; constants are
// the float rounding of the same double literals; float16 -> float32 is
// exact.

#include <cassert>
#include <cstdint>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 256;    // splats a chunk and threads a block
constexpr int kCoefs = 15;     // SH coefficients of bands 1-3 a splat
constexpr int kShFloats = 45;  // 15 coefficients x 3 channels
constexpr int kInfoWords = 16; // a ChunkInfo row (GaussianSplatAsset.cs:231-237)

// io/formats.py's enums.
constexpr int kVecFloat32 = 0, kVecNorm16 = 1, kVecNorm11 = 2, kVecNorm6 = 3;
constexpr int kColFloat32x4 = 0, kColFloat16x4 = 1, kColNorm8x4 = 2;  // BC7 (3) is held as Norm8x4 words
constexpr int kShFloat32 = 0, kShFloat16 = 1, kShNorm11 = 2, kShNorm6 = 3, kShCluster = 4;

constexpr float kSqrt2 = (float)1.4142135623730951;
constexpr float kInvSqrt2 = (float)(1.0 / 1.4142135623730951);

// ((u >> s) & m) / m, a true division.
__device__ __forceinline__ float unorm(unsigned u, int s, unsigned m) { return (float)((u >> s) & m) / (float)m; }
__device__ __forceinline__ float half_bits(unsigned bits) { return __half2float(__ushort_as_half((unsigned short)bits)); }
__device__ __forceinline__ float lo_half(unsigned w) { return half_bits(w & 0xFFFFu); }
__device__ __forceinline__ float hi_half(unsigned w) { return half_bits(w >> 16); }
// _chunk_lerp: lo + x * (hi - lo), each operation rounded.
__device__ __forceinline__ float lerp(float x, float lo, float hi) { return lo + x * (hi - lo); }
__device__ __forceinline__ float lerp_f16(float x, unsigned pair) { return lerp(x, lo_half(pair), hi_half(pair)); }

// _vector_cols: a packed vector field's three values in [0, 1] (or the floats).
template <int kFmt>
__device__ __forceinline__ void vector3(const void* q, long long i, float v[3]) {
  if constexpr (kFmt == kVecFloat32) {
    const float* p = static_cast<const float*>(q) + 3 * i;
    v[0] = p[0], v[1] = p[1], v[2] = p[2];
  } else if constexpr (kFmt == kVecNorm16) {
    const unsigned short* p = static_cast<const unsigned short*>(q) + 3 * i;
#pragma unroll
    for (int j = 0; j < 3; ++j) v[j] = (float)p[j] / 65535.0f;
  } else if constexpr (kFmt == kVecNorm11) {
    const unsigned u = static_cast<const unsigned*>(q)[i];
    v[0] = unorm(u, 0, 2047), v[1] = unorm(u, 11, 1023), v[2] = unorm(u, 21, 2047);
  } else {
    const unsigned u = static_cast<const unsigned short*>(q)[i];
    v[0] = unorm(u, 0, 63), v[1] = unorm(u, 6, 31), v[2] = unorm(u, 11, 31);
  }
}

__device__ __forceinline__ void vector3(const void* q, int fmt, long long i, float v[3]) {
  switch (fmt) {
    case kVecFloat32: vector3<kVecFloat32>(q, i, v); break;
    case kVecNorm16: vector3<kVecNorm16>(q, i, v); break;
    case kVecNorm11: vector3<kVecNorm11>(q, i, v); break;
    default: vector3<kVecNorm6>(q, i, v); break;
  }
}

// The colour words' rgba.
template <int kFmt>
__device__ __forceinline__ void color4(const void* q, long long i, float c[4]) {
  if constexpr (kFmt == kColFloat32x4) {
    const float* p = static_cast<const float*>(q) + 4 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = p[j];
  } else if constexpr (kFmt == kColFloat16x4) {
    const unsigned* p = static_cast<const unsigned*>(q) + 2 * i;
    const unsigned w0 = p[0], w1 = p[1];
    c[0] = lo_half(w0), c[1] = hi_half(w0), c[2] = lo_half(w1), c[3] = hi_half(w1);
  } else {
    const unsigned u = static_cast<const unsigned*>(q)[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = unorm(u, 8 * j, 0xFF);
  }
}

__device__ __forceinline__ void color4(const void* q, int fmt, long long i, float c[4]) {
  switch (fmt) {
    case kColFloat32x4: color4<kColFloat32x4>(q, i, c); break;
    case kColFloat16x4: color4<kColFloat16x4>(q, i, c); break;
    default: color4<kColNorm8x4>(q, i, c); break;
  }
}

// The 10.10.10.2 word through ops.quaternion.unpack_smallest3.
__device__ __forceinline__ float4 smallest3(unsigned u) {
  const float a0 = unorm(u, 0, 1023), a1 = unorm(u, 10, 1023), a2 = unorm(u, 20, 1023);
  const int idx = (int)rintf(unorm(u, 30, 3) * 3.0f);  // torch.round: half to even
  const float t0 = a0 * kSqrt2 - kInvSqrt2, t1 = a1 * kSqrt2 - kInvSqrt2, t2 = a2 * kSqrt2 - kInvSqrt2;
  const float sq = (t0 * t0 + t2 * t2) + t1 * t1;  // torch.sum over a last dim of 3 on the card
  const float r = 1.0f - sq;
  const float largest = sqrtf(isnan(r) ? r : fmaxf(r, (float)1e-24));
  float4 q;
  q.x = idx == 0 ? largest : t0;
  q.y = idx == 1 ? largest : (idx == 0 ? t0 : t1);
  q.z = idx == 2 ? largest : (idx <= 1 ? t1 : t2);
  q.w = idx == 3 ? largest : t2;
  return q;
}

struct Words {
  const void *pos, *rot, *scale, *color, *sh;
  const int* sh_idx;     // cluster formats: (n,) rows of the table sh
  const unsigned* info;  // (chunks, 16) ChunkInfo rows; null when unchunked
  int pos_fmt, scale_fmt, color_fmt, sh_rows;
};

struct Cloud {
  float *means, *scales, *opacity, *base;
  float4* rot;
  float* sh[3];  // interleaved: sh[0] is (n, 15, 3); planar: three (n, 15) channels
  int planar;
};

// ``count`` floats at dst (16-byte aligned), element e being value(e): float4
// stores by consecutive threads, then the tail.
template <typename F>
__device__ __forceinline__ void store_run(float* dst, int count, F value) {
  const int vecs = count / 4;
  for (int q = threadIdx.x; q < vecs; q += kChunk) {
    const int e = 4 * q;
    reinterpret_cast<float4*>(dst)[q] = make_float4(value(e), value(e + 1), value(e + 2), value(e + 3));
  }
  for (int e = 4 * vecs + threadIdx.x; e < count; e += kChunk) dst[e] = value(e);
}

template <int kSh, bool kChunks>
__global__ void __launch_bounds__(kChunk) decode_kernel(Words in, int n, Cloud out) {
  constexpr bool kNormSh = kSh == kShNorm11 || kSh == kShNorm6;
  constexpr int kWordBytes = kSh == kShNorm11 ? 4 : 2;
  __shared__ __align__(16) unsigned char words[kNormSh ? kChunk * kCoefs * kWordBytes : 16];
  __shared__ __align__(16) float stage[3][kChunk * 3];  // means, scales, base colour
  __shared__ float table[kSh == kShNorm6 ? 128 : 1];      // Norm6: channel 0 codes, 1's, 2's
  __shared__ int rows[kSh == kShCluster ? kChunk : 1];

  const int t = threadIdx.x;
  const long long first = (long long)blockIdx.x * kChunk;
  const int count = (int)min((long long)kChunk, n - first);
  const unsigned* info = kChunks ? in.info + (long long)blockIdx.x * kInfoWords : nullptr;

  if constexpr (kNormSh) {
    // The chunk's SH words, 16 bytes a load where the run is aligned (a
    // chunk's run starts at a multiple of 16 bytes past the tensor's start).
    const unsigned char* src = static_cast<const unsigned char*>(in.sh) + first * kCoefs * kWordBytes;
    const int nwords = count * kCoefs;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int vecs = nwords * kWordBytes / 16;
      for (int j = t; j < vecs; j += kChunk)
        reinterpret_cast<uint4*>(words)[j] = __ldcs(reinterpret_cast<const uint4*>(src) + j);
      done = vecs * 16 / kWordBytes;
    }
    for (int j = done + t; j < nwords; j += kChunk) {
      if constexpr (kWordBytes == 4)
        reinterpret_cast<unsigned*>(words)[j] = reinterpret_cast<const unsigned*>(src)[j];
      else
        reinterpret_cast<unsigned short*>(words)[j] = reinterpret_cast<const unsigned short*>(src)[j];
    }
  }
  if constexpr (kSh == kShNorm6) {
    // Every code's value: channel 0 (bits 0-4) codes at 0-31, channel 1
    // (bits 5-10) at 32-95, channel 2 (bits 11-15) at 96-127.
    if (t < 128) {
      const int c = t < 32 ? 0 : (t < 96 ? 1 : 2);
      const int code = t - (c == 0 ? 0 : (c == 1 ? 32 : 96));
      float v = (float)code / (c == 1 ? 63.0f : 31.0f);
      if constexpr (kChunks) v = lerp_f16(v, info[13 + c]);
      table[t] = v;
    }
  }

  if (t < count) {
    const long long i = first + t;
    float p[3], s[3], c[4];
    vector3(in.pos, in.pos_fmt, i, p);
    vector3(in.scale, in.scale_fmt, i, s);
    color4(in.color, in.color_fmt, i, c);
    float opacity = c[3];
    if constexpr (kChunks) {
#pragma unroll
      for (int j = 0; j < 3; ++j) p[j] = lerp(p[j], __uint_as_float(info[4 + 2 * j]), __uint_as_float(info[5 + 2 * j]));
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float x = lerp_f16(s[j], info[10 + j]);
        x = x * x;  // _pow8: s *= s three times (hlsl:578-581)
        x = x * x;
        s[j] = x * x;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = lerp_f16(c[j], info[j]);
      // InvSquareCentered01 (GaussianUtils.cs:25-38, hlsl:583); torch.sign is (0 < t) - (t < 0).
      const float w = c[3] * 2.0f - 1.0f;
      const float sign = (float)((0.0f < w) - (w < 0.0f));
      opacity = sign * sqrtf(fabsf(w)) * 0.5f + 0.5f;
    }
    out.rot[i] = smallest3(static_cast<const unsigned*>(in.rot)[i]);
    out.opacity[i] = opacity;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      stage[0][3 * t + j] = p[j];
      stage[1][3 * t + j] = s[j];
      stage[2][3 * t + j] = c[j];
    }
    if constexpr (kSh == kShCluster) {
      const int row = in.sh_idx[i];
      assert(row >= 0 && row < in.sh_rows);  // index_select's bound
      rows[t] = row;
    }
  }
  __syncthreads();

  float* const fields[3] = {out.means, out.scales, out.base};
#pragma unroll
  for (int f = 0; f < 3; ++f) store_run(fields[f] + 3 * first, 3 * count, [&](int e) { return stage[f][e]; });

  if constexpr (kSh == kShNorm6) {
    const unsigned short* w16 = reinterpret_cast<const unsigned short*>(words);
    auto code = [&](int word, int ch) -> float {
      const unsigned u = w16[word];
      return ch == 0 ? table[u & 31] : (ch == 1 ? table[32 + ((u >> 5) & 63)] : table[96 + ((u >> 11) & 31)]);
    };
    if (out.planar) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        store_run(out.sh[ch] + kCoefs * first, kCoefs * count, [&](int e) { return code(e, ch); });
    } else {
      store_run(out.sh[0] + kShFloats * first, kShFloats * count, [&](int e) {
        const int h = e % 3;
        return code(e / 3, h);  // coefficient e / 3 of the run (splat * 15 + k), channel e % 3
      });
    }
  } else if constexpr (kSh == kShNorm11) {
    const unsigned* w32 = reinterpret_cast<const unsigned*>(words);
    float lo[3], hi[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      lo[ch] = kChunks ? lo_half(info[13 + ch]) : 0.0f;
      hi[ch] = kChunks ? hi_half(info[13 + ch]) : 0.0f;
    }
    auto code = [&](int word, int ch) -> float {
      const unsigned u = w32[word];
      const float v = ch == 0 ? unorm(u, 0, 2047) : (ch == 1 ? unorm(u, 11, 1023) : unorm(u, 21, 2047));
      return kChunks ? lerp(v, lo[ch], hi[ch]) : v;
    };
    if (out.planar) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        store_run(out.sh[ch] + kCoefs * first, kCoefs * count, [&](int e) { return code(e, ch); });
    } else {
      store_run(out.sh[0] + kShFloats * first, kShFloats * count, [&](int e) { return code(e / 3, e % 3); });
    }
  } else if constexpr (kSh == kShFloat16 || kSh == kShCluster) {
    // 24 words of float16 pairs a row, halves 0-44 used: half h of splat s
    // is SH value (s, h / 3, h % 3).
    const unsigned* table_words = static_cast<const unsigned*>(in.sh);
    store_run(out.sh[0] + kShFloats * first, kShFloats * count, [&](int e) {
      const int s = e / kShFloats, h = e - kShFloats * s;
      const long long row = kSh == kShCluster ? (long long)rows[s] : first + s;
      const unsigned w = table_words[row * 24 + (h >> 1)];
      return (h & 1) ? hi_half(w) : lo_half(w);
    });
  }
}

template <int kSh>
cudaError_t launch(const Words& in, int n, const Cloud& out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kChunk - 1) / kChunk);
  if (in.info != nullptr)
    decode_kernel<kSh, true><<<blocks, kChunk, 0, stream>>>(in, n, out);
  else
    decode_kernel<kSh, false><<<blocks, kChunk, 0, stream>>>(in, n, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* decode_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

// A DeviceAsset's words, contiguous, in io/device_asset.py's layouts: pos and
// scale by format (Float32 (n, 3) f32, Norm16 (n, 3) u16, Norm11 (n,) u32,
// Norm6 (n,) u16), rot (n,) u32, colour (Float32x4 (n, 4) f32, Float16x4
// (n, 2) u32, Norm8x4 and BC7 (n,) u32), SH by sh_kind (0 Float32: not
// read; 1 Float16 (n, 24) u32; 2 Norm11 (n, 15) u32; 3 Norm6 (n, 15) u16;
// 4 a cluster table (sh_rows, 24) u32 with sh_idx (n,) i32), info
// (>= ceil(n / 256), 16) ChunkInfo words or null.  Writes means (n, 3),
// rot (n, 4), scales (n, 3), opacity (n,), base (n, 3) and, unless sh_kind
// is 0, SH: (n, 15, 3) at sh0, or with planar (Norm11 and Norm6 only) the
// channels (n, 15) at sh0, sh1, sh2; every output 16-byte aligned.
// Launches on `stream` (nothing for n = 0); returns cudaGetLastError().
int decode_launch(const void* pos, const void* rot, const void* scale, const void* color, const void* sh,
                  const int* sh_idx, const unsigned* info, int n, int pos_fmt, int scale_fmt, int color_fmt,
                  int sh_kind, int sh_rows, int planar, float* means, float* rot_out, float* scales,
                  float* opacity, float* base, float* sh0, float* sh1, float* sh2, void* stream) {
  if (n <= 0) return 0;
  const Words in{pos, rot, scale, color, sh, sh_idx, info, pos_fmt, scale_fmt, color_fmt, sh_rows};
  const Cloud out{means, scales, opacity, base, reinterpret_cast<float4*>(rot_out), {sh0, sh1, sh2}, planar};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (sh_kind) {
    case kShFloat32: return (int)launch<kShFloat32>(in, n, out, st);
    case kShFloat16: return (int)launch<kShFloat16>(in, n, out, st);
    case kShNorm11: return (int)launch<kShNorm11>(in, n, out, st);
    case kShNorm6: return (int)launch<kShNorm6>(in, n, out, st);
    case kShCluster: return (int)launch<kShCluster>(in, n, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
