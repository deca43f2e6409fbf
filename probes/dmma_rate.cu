// Throughput of the f64 tensor-core shapes (mma.sync ... f64) on one card:
// every warp of `blocks` x `threads` runs NACC independent accumulator
// chains for `iters` rounds. Built and run by probes/k3_probe.py.
#include <cuda_runtime.h>

namespace {

template <int SHAPE, int NACC>
__global__ void rate(double* out, int iters) {
  const int lane = threadIdx.x & 31;
  double a[4], b[2], c[NACC][4];
  for (int i = 0; i < 4; ++i) a[i] = 1.0 + 1e-9 * (lane + i);
  for (int i = 0; i < 2; ++i) b[i] = 1.0 - 1e-9 * (lane + i);
  for (int n = 0; n < NACC; ++n)
    for (int i = 0; i < 4; ++i) c[n][i] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < NACC; ++n) {
      if (SHAPE == 0) {
        asm volatile(
            "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, "
            "{%2}, {%3}, {%0, %1};\n"
            : "+d"(c[n][0]), "+d"(c[n][1])
            : "d"(a[0]), "d"(b[0]));
      } else if (SHAPE == 1) {
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, "
            "%3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
            : "+d"(c[n][0]), "+d"(c[n][1]), "+d"(c[n][2]), "+d"(c[n][3])
            : "d"(a[0]), "d"(a[1]), "d"(b[0]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, "
            "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+d"(c[n][0]), "+d"(c[n][1]), "+d"(c[n][2]), "+d"(c[n][3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
              "d"(b[1]));
      }
    }
  }
  double s = 0.0;
  for (int n = 0; n < NACC; ++n)
    for (int i = 0; i < 4; ++i) s += c[n][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int SHAPE>
float run(int blocks, int threads, int iters, double* out) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  rate<SHAPE, 8><<<blocks, threads>>>(out, 16);  // warm-up
  cudaEventRecord(e0);
  rate<SHAPE, 8><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return ms;
}

}  // namespace

// shape 0: m8n8k4, 1: m16n8k4, 2: m16n8k8; 8 chains per warp. Writes the
// time in ms of one launch of `iters` rounds; returns a CUDA error code.
extern "C" int dmma_rate(int shape, int blocks, int threads, int iters,
                         float* ms) {
  double* out = nullptr;
  cudaError_t e = cudaMalloc(&out, sizeof(double) * blocks * threads);
  if (e != cudaSuccess) return static_cast<int>(e);
  *ms = shape == 0   ? run<0>(blocks, threads, iters, out)
        : shape == 1 ? run<1>(blocks, threads, iters, out)
                     : run<2>(blocks, threads, iters, out);
  e = cudaGetLastError();
  cudaFree(out);
  return static_cast<int>(e);
}
