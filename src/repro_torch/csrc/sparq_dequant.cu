// K6: §5.1 meta-decode of the KV read-back path (store + meta -> codes, or
// -> floats with the plane's scale applied).
//
// Replaces: src/repro/kernels/sparq_dequant.py::sparq_dequant_pallas
//           (_kernel), and in float mode also the `.astype(f32) * scale`
//           (and `.astype(dtype)`) that src/repro/models/cache.py::
//           CachedTensor.read runs after it.
// Computes: codes[i] = int8(sign(store[i]) * (|store[i]| << shift[i])),
//   shift = (meta >> 3) & 7 on even lanes and meta & 7 on odd lanes of the
//   last axis. The product is formed in int32 and narrowed to int8 by
//   keeping the low byte, as XLA's and PyTorch's int32 -> int8 conversion
//   do, so every (store, meta) byte pair decodes as in the reference.
//   Codes mode stores the int8 codes (the Pallas contract). Float mode
//   widens the int8 code, multiplies by the scale (read from its device
//   pointer) in IEEE f32, and stores f32 or, rounded to nearest even,
//   bf16: bit for bit the plain `dequant(...).to(float32) * scale` and
//   `.to(bfloat16)`.
// Bound: device-memory bytes (2 B read per value; 1 B written in codes
//   mode, 4 or 2 B in float mode; a handful of integer operations).
// Design: a thread per 16 lanes: one 16-byte load of store and of meta,
//   decoded in registers (K is even, so lane parity is the parity of the
//   flat index), then one 16-byte store of codes, or four (f32) or two
//   (bf16) 16-byte stores of floats. Float mode replaces the four
//   full-plane passes the read took (K6, cast, multiply, cast) with one. A
//   grid-stride loop covers any M; the last M*K % 16 values, and every
//   value when a pointer is not 16-byte aligned, are decoded as scalars.
#include <cuda_bf16.h>

#include "sparq_common.cuh"

namespace {

constexpr int THREADS = 256;

enum Out : int { OUT_CODES = 0, OUT_F32 = 1, OUT_BF16 = 2 };

__device__ __forceinline__ signed char decode_lane(int store, int meta,
                                                   int odd) {
  const int q = static_cast<signed char>(store);
  const int m = static_cast<signed char>(meta);
  const int s = odd ? (m & 7) : ((m >> 3) & 7);
  const int mag = abs(q) << s;
  const int r = q < 0 ? -mag : mag;
  return static_cast<signed char>(static_cast<unsigned int>(r) & 0xff);
}

__device__ __forceinline__ unsigned short to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <int OUT>
__device__ __forceinline__ void store_one(void* out, long long i,
                                          signed char c, float a) {
  if constexpr (OUT == OUT_CODES) {
    static_cast<signed char*>(out)[i] = c;
  } else if constexpr (OUT == OUT_F32) {
    static_cast<float*>(out)[i] = __fmul_rn(static_cast<float>(c), a);
  } else {
    static_cast<unsigned short*>(out)[i] =
        to_bf16(__fmul_rn(static_cast<float>(c), a));
  }
}

template <int OUT>
__global__ void __launch_bounds__(THREADS)
sparq_dequant_kernel(const signed char* __restrict__ store,
                     const signed char* __restrict__ meta,
                     void* __restrict__ out, const float* __restrict__ scale,
                     long long n, long long n_vec) {
  const float a = OUT == OUT_CODES ? 0.f : *scale;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  for (long long i = t; i < n_vec; i += stride) {
    const uint4 s4 = __ldg(reinterpret_cast<const uint4*>(store) + i);
    const uint4 m4 = __ldg(reinterpret_cast<const uint4*>(meta) + i);
    const unsigned sw[4] = {s4.x, s4.y, s4.z, s4.w};
    const unsigned mw[4] = {m4.x, m4.y, m4.z, m4.w};
    signed char c[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      c[j] = decode_lane((sw[j >> 2] >> (8 * (j & 3))) & 0xff,
                         (mw[j >> 2] >> (8 * (j & 3))) & 0xff, j & 1);
    if constexpr (OUT == OUT_CODES) {
      unsigned w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = static_cast<unsigned char>(c[4 * k]) |
               static_cast<unsigned char>(c[4 * k + 1]) << 8 |
               static_cast<unsigned char>(c[4 * k + 2]) << 16 |
               static_cast<unsigned>(static_cast<unsigned char>(c[4 * k + 3]))
                   << 24;
      reinterpret_cast<uint4*>(out)[i] = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (OUT == OUT_F32) {
      float4* o = reinterpret_cast<float4*>(out) + 4 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = make_float4(__fmul_rn(static_cast<float>(c[4 * k]), a),
                           __fmul_rn(static_cast<float>(c[4 * k + 1]), a),
                           __fmul_rn(static_cast<float>(c[4 * k + 2]), a),
                           __fmul_rn(static_cast<float>(c[4 * k + 3]), a));
    } else {
      unsigned w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[k] = to_bf16(__fmul_rn(static_cast<float>(c[2 * k]), a)) |
               static_cast<unsigned>(
                   to_bf16(__fmul_rn(static_cast<float>(c[2 * k + 1]), a)))
                   << 16;
      uint4* o = reinterpret_cast<uint4*>(out) + 2 * i;
      o[0] = make_uint4(w[0], w[1], w[2], w[3]);
      o[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
  for (long long i = n_vec * 16 + t; i < n; i += stride)
    store_one<OUT>(out, i, decode_lane(store[i], meta[i], i & 1), a);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// store, meta: (M, K) int8, K even. out_mode 0: out int8 codes (M, K);
// 1: out f32 = code * *scale; 2: out bf16 of the same. scale: f32 device
// pointer (unused in mode 0).
extern "C" int sparq_dequant_launch(const void* store, const void* meta,
                                    void* out, const void* scale,
                                    int out_mode, int M, int K,
                                    void* stream) {
  if (out_mode < OUT_CODES || out_mode > OUT_BF16 || K % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(M) * K;
  if (n == 0) return 0;
  const bool vec = aligned16(store) && aligned16(meta) && aligned16(out);
  const long long n_vec = vec ? n / 16 : 0;
  const long long work = n_vec > 0 ? n_vec : n;
  const long long want = (work + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const signed char*>(store);
  const auto* m = static_cast<const signed char*>(meta);
  const auto* a = static_cast<const float*>(scale);
  if (out_mode == OUT_CODES)
    sparq_dequant_kernel<OUT_CODES>
        <<<blocks, THREADS, 0, st>>>(s, m, out, a, n, n_vec);
  else if (out_mode == OUT_F32)
    sparq_dequant_kernel<OUT_F32>
        <<<blocks, THREADS, 0, st>>>(s, m, out, a, n, n_vec);
  else
    sparq_dequant_kernel<OUT_BF16>
        <<<blocks, THREADS, 0, st>>>(s, m, out, a, n, n_vec);
  return static_cast<int>(cudaGetLastError());
}
