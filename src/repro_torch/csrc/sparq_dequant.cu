// K6: §5.1 meta-decode of the KV read-back path (store + meta -> codes).
//
// Replaces: src/repro/kernels/sparq_dequant.py::sparq_dequant_pallas
//           (_kernel).
// Computes: codes[i] = int8(sign(store[i]) * (|store[i]| << shift[i])),
//   shift = (meta >> 3) & 7 on even lanes and meta & 7 on odd lanes of the
//   last axis. The product is formed in int32 and narrowed to int8 by
//   keeping the low byte, as XLA's and PyTorch's int32 -> int8 conversion
//   do, so every (store, meta) byte pair decodes as in the reference.
// Bound: device-memory bytes (2 B read, 1 B written per value; a handful
//   of integer operations).
// Design: one thread per lane pair (K is even, so lane parity is the
//   parity of the flat index and a pair never straddles a row); each
//   thread reads the pair's two bytes of store and of meta as 16-bit
//   words and writes one. A grid-stride loop covers any M.
#include "sparq_common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ signed char decode_lane(signed char store,
                                                   signed char meta,
                                                   int odd) {
  const int q = store;
  const int m = meta;
  const int s = odd ? (m & 7) : ((m >> 3) & 7);
  const int mag = abs(q) << s;
  const int r = q < 0 ? -mag : mag;
  return static_cast<signed char>(static_cast<unsigned int>(r) & 0xff);
}

__global__ void __launch_bounds__(THREADS)
sparq_dequant_kernel(const char2* __restrict__ store,
                     const char2* __restrict__ meta,
                     char2* __restrict__ codes, long long n_pairs) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_pairs; i += (long long)gridDim.x * blockDim.x) {
    const char2 s = store[i], m = meta[i];
    codes[i] = make_char2(decode_lane(s.x, m.x, 0), decode_lane(s.y, m.y, 1));
  }
}

}  // namespace

// store, meta, codes: (M, K) int8, K even.
extern "C" int sparq_dequant_launch(const void* store, const void* meta,
                                    void* codes, int M, int K,
                                    void* stream) {
  const long long n_pairs = (long long)M * (K / 2);
  if (n_pairs == 0) return 0;
  const long long want = (n_pairs + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 65535 * 8 ? want : 65535 * 8);
  sparq_dequant_kernel<<<blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char2*>(store), static_cast<const char2*>(meta),
      static_cast<char2*>(codes), n_pairs);
  return static_cast<int>(cudaGetLastError());
}
