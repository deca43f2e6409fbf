// K4: SPARQ quantization of the KV write path (float -> codes + meta).
//
// Replaces: src/repro/kernels/sparq_quant.py::sparq_quant_pallas (_kernel).
// Computes: for x (M, K) f32 and a scale a (one for all rows, or one per
//   row), q = clip(rint(x / a)) and, per vSPARQ lane pair, the SPARQ
//   reconstruction (bSPARQ window with the rounding carry, partner-zero
//   passthrough, sign-magnitude) as int8 codes, and the pair's meta byte
//   mux_any * 64 + shift_even * 8 + shift_odd mirrored onto both lanes.
//   With trimming off (a8w8): the clipped codes and zero meta.
// Bound: device-memory bytes (4 B read, 2 B written per value; a few
//   dozen integer operations per pair).
// Design: one thread per lane pair. K is even, so a pair never straddles
//   a row; the ragged end of M is the thread-index guard (the TPU kernel
//   padded M to its row tile). The pair is read as one float2 and written
//   as one 16-bit word per output; the codec is sparq_common.cuh's, the
//   one K1 runs.
#include "sparq_common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
sparq_quant_kernel(const float2* __restrict__ x,
                   const float* __restrict__ scale, int scale_per_row,
                   char2* __restrict__ codes, char2* __restrict__ meta,
                   long long n_pairs, int half_k, SparqCodec codec) {
  const float qmax = static_cast<float>(codec.max_val);
  const float qmin = codec.is_signed ? -qmax : 0.f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_pairs; i += (long long)gridDim.x * blockDim.x) {
    const float a = scale[scale_per_row ? i / half_k : 0];
    const float2 v = x[i];
    int r0, r1, mb;
    sparq_encode_pair(quantize_code(v.x, a, qmin, qmax),
                      quantize_code(v.y, a, qmin, qmax), codec, r0, r1, mb);
    codes[i] = make_char2(static_cast<signed char>(r0),
                          static_cast<signed char>(r1));
    meta[i] = make_char2(static_cast<signed char>(mb),
                         static_cast<signed char>(mb));
  }
}

}  // namespace

// x (M, K) f32; scale f32 (1,) or (M,); codes, meta (M, K) int8.
extern "C" int sparq_quant_launch(const void* x, const void* scale,
                                  int scale_per_row, void* codes, void* meta,
                                  int M, int K, int bits, int shift_mask,
                                  int shift_max, int rounding, int vsparq,
                                  int is_signed, int max_val, int enabled,
                                  void* stream) {
  const SparqCodec codec{bits,   shift_mask, shift_max, rounding,
                         vsparq, is_signed,  max_val,   enabled};
  const long long n_pairs = (long long)M * (K / 2);
  if (n_pairs == 0) return 0;
  const long long want = (n_pairs + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 65535 * 8 ? want : 65535 * 8);
  sparq_quant_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float*>(scale),
      scale_per_row, static_cast<char2*>(codes), static_cast<char2*>(meta),
      n_pairs, K / 2, codec);
  return static_cast<int>(cudaGetLastError());
}
