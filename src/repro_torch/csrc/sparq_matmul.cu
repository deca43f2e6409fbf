// K1: fused SPARQ activation quantization + int8 matmul, for Hopper.
//
// Replaces: src/repro/kernels/sparq_matmul.py::sparq_matmul_pallas
//           (_kernel, _recon_tile).
// Computes: out[M,N] f32 = (sum_k r[m,k] * w[k,n]) * a * c[n], where r is
//   the SPARQ reconstruction of clip(rint(x / a)) (bSPARQ window with the
//   rounding carry, vSPARQ passthrough when the pair partner is 0,
//   sign-magnitude) and w holds int8 per-channel weight codes.
// Bound: at decode (M = active slots) the int8 weight bytes dominate, so
//   the kernel is bound by device-memory bytes; at prefill (M = chunk
//   rows) it moves toward the integer tensor-core rate.
// Design: one block computes a BM x 64 output tile. The x tile is
//   quantized and SPARQ-reconstructed while it is staged to shared memory
//   (each thread owns whole vSPARQ pairs, and K tiles are even, so a pair
//   never straddles a tile); the weight tile is staged transposed so both
//   operands give 4 consecutive k per 32-bit word, and the products
//   accumulate exactly in int32 with __dp4a. The epilogue multiplies
//   (float(acc) * a) * c[n] in that order, so the result is bit-identical
//   to the plain version. BM = 16 for decode-sized M keeps fewer idle rows.
//   First version: no tensor cores, TMA or pipelining yet.
#include <cuda_bf16.h>

#include "sparq_common.cuh"

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

template <int BM, typename T>
__global__ void __launch_bounds__(THREADS)
sparq_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ ascale,
                    const float* __restrict__ cscale, float* __restrict__ out,
                    int M, int N, int K, SparqCodec codec) {
  constexpr int TM = BM / 16;  // output rows per thread
  __shared__ __align__(16) int8_t xs[BM * BK];   // [m][k] reconstructed codes
  __shared__ __align__(16) int8_t wsT[BN * BK];  // [n][k] weight codes
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float a = ascale[0];
  const float qmax = static_cast<float>(codec.max_val);
  const float qmin = codec.is_signed ? -qmax : 0.f;

  int acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage x: quantize + reconstruct whole pairs
    for (int idx = tid; idx < BM * BK / 2; idx += THREADS) {
      const int m = idx / (BK / 2), kp = idx - m * (BK / 2);
      const int gm = m0 + m, gk = k0 + 2 * kp;
      int r0 = 0, r1 = 0;
      if (gm < M && gk < K) {  // K is even: gk + 1 < K too
        const float x0 = to_float(x[(size_t)gm * K + gk]);
        const float x1 = to_float(x[(size_t)gm * K + gk + 1]);
        const float f0 = fminf(fmaxf(rintf(__fdiv_rn(x0, a)), qmin), qmax);
        const float f1 = fminf(fmaxf(rintf(__fdiv_rn(x1, a)), qmin), qmax);
        sparq_recon_pair(static_cast<int>(f0), static_cast<int>(f1), codec,
                         r0, r1);
      }
      xs[m * BK + 2 * kp] = static_cast<int8_t>(r0);
      xs[m * BK + 2 * kp + 1] = static_cast<int8_t>(r1);
    }
    // stage w transposed: wsT[n][k] = w[k0 + k][n0 + n]
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int k = idx / BN, n = idx - k * BN;
      const int gk = k0 + k, gn = n0 + n;
      wsT[n * BK + k] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0;
    }
    __syncthreads();
    const int* xs32 = reinterpret_cast<const int*>(xs);
    const int* ws32 = reinterpret_cast<const int*>(wsT);
#pragma unroll 4
    for (int kk = 0; kk < BK / 4; ++kk) {
      int av[TM], bv[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = xs32[(ty + 16 * i) * (BK / 4) + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws32[(tx + 16 * j) * (BK / 4) + kk];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      out[(size_t)gm * N + gn] =
          __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), a), cscale[gn]);
    }
  }
}

template <int BM, typename T>
void launch(const void* x, const int8_t* w, const float* a, const float* c,
            float* out, int M, int N, int K, const SparqCodec& codec,
            cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  sparq_matmul_kernel<BM, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, a, c, out, M, N, K, codec);
}

}  // namespace

// x: (M, K) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w: (K, N) int8;
// ascale: 1 f32 (device); cscale: (N,) f32; out: (M, N) f32.
extern "C" int sparq_matmul_launch(const void* x, int x_bf16, const void* w,
                                   const void* ascale, const void* cscale,
                                   void* out, int M, int N, int K, int bits,
                                   int shift_mask, int shift_max,
                                   int rounding, int vsparq, int is_signed,
                                   int max_val, int enabled, void* stream) {
  const SparqCodec codec{bits,   shift_mask, shift_max, rounding,
                         vsparq, is_signed,  max_val,   enabled};
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* ap = static_cast<const float*>(ascale);
  const auto* cp = static_cast<const float*>(cscale);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 16) {
    if (x_bf16)
      launch<16, __nv_bfloat16>(x, wp, ap, cp, op, M, N, K, codec, st);
    else
      launch<16, float>(x, wp, ap, cp, op, M, N, K, codec, st);
  } else {
    if (x_bf16)
      launch<64, __nv_bfloat16>(x, wp, ap, cp, op, M, N, K, codec, st);
    else
      launch<64, float>(x, wp, ap, cp, op, M, N, K, codec, st);
  }
  return static_cast<int>(cudaGetLastError());
}
