// K2: paged flash-decode attention over the §5.1 packed page pool.
//
// Replaces: src/repro/kernels/sparq_decode_attn.py::
//           sparq_paged_decode_attn_pallas (_paged_kernel, _flash_tile_body,
//           _meta_decode_f32).
// Computes: for every slot b and KV head h, the G grouped query heads of
//   the one decode token attend over the slot's pages, gathered through the
//   block table. Each page tile is meta-decoded in the loop:
//   sign(q) * (|q| << shift) * scale[b]. Mask: block allocated and
//   kpos <= cur[b] (and kpos > cur[b] - window). Online softmax with f32
//   statistics and f64 tile sums (score_dot, online_softmax_tile);
//   out = acc / max(l, 1e-30). An inactive slot (cur < 0) writes zeros.
// Bound: device-memory bytes (the packed pages, 2 B per cached value for
//   data + meta, plus the f32 query/output); there are ~2 flops per byte.
// Design: one block per (slot, KV head) walks that slot's logical blocks
//   up to cur // page_size, reading block_table[b, t] itself (the TPU
//   kernel scalar-prefetched it). A block beyond cur, or unallocated, is
//   fully masked and would leave (m, l, acc) unchanged, so skipping it is
//   exact. Each page tile is decoded into shared memory as f32 (padded rows
//   against bank conflicts); scores, statistics and the accumulator live in
//   shared memory. First version: one page per iteration, no split-K.
#include "sparq_common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ kd,
                    const int8_t* __restrict__ km,
                    const float* __restrict__ kscale,
                    const int8_t* __restrict__ vd,
                    const int8_t* __restrict__ vm,
                    const float* __restrict__ vscale,
                    const int* __restrict__ block_table,
                    const int* __restrict__ cur, float* __restrict__ out,
                    int KV, int G, int hd, int ps, int NB, int window,
                    float sm_scale) {
  extern __shared__ float smem[];
  const int ldk = hd + 1;
  float* qs = smem;                 // [G][hd]
  float* acc = qs + G * hd;         // [G][hd]
  float* kt = acc + G * hd;         // [ps][ldk]
  float* vt = kt + ps * ldk;        // [ps][ldk]
  float* sc = vt + ps * ldk;        // [G][ps]
  float* m = sc + G * ps;           // [G]
  float* l = m + G;                 // [G]
  float* corr = l + G;              // [G]

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int c = cur[b];
  const size_t qbase = ((size_t)b * KV + h) * G * hd;
  if (c < 0) {
    for (int i = tid; i < G * hd; i += THREADS) out[qbase + i] = 0.f;
    return;
  }
  for (int i = tid; i < G * hd; i += THREADS) {
    qs[i] = q[qbase + i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
  }
  const float ks = kscale[b], vs = vscale[b];
  const int nt = min(NB, c / ps + 1);
  const int t0 = window ? max(0, (c - window + 1) / ps) : 0;
  __syncthreads();
  for (int t = t0; t < nt; ++t) {
    const int page = block_table[(size_t)b * NB + t];
    if (page < 0) continue;  // unallocated: fully masked, exact to skip
    for (int idx = tid; idx < ps * hd; idx += THREADS) {
      const int r = idx / hd, d = idx - r * hd;
      const size_t off = (((size_t)page * ps + r) * KV + h) * hd + d;
      kt[r * ldk + d] = meta_decode(kd[off], km[off], d, ks);
      vt[r * ldk + d] = meta_decode(vd[off], vm[off], d, vs);
    }
    __syncthreads();
    for (int idx = tid; idx < G * ps; idx += THREADS) {
      const int g = idx / ps, j = idx - g * ps;
      const int kpos = t * ps + j;
      const bool ok = kpos <= c && (window == 0 || kpos > c - window);
      sc[idx] = ok ? score_dot(qs + g * hd, kt + j * ldk, hd) * sm_scale
                   : -CUDART_INF_F;
    }
    __syncthreads();
    online_softmax_tile(sc, vt, ldk, m, l, corr, acc, G, ps, hd);
  }
  for (int i = tid; i < G * hd; i += THREADS)
    out[qbase + i] = acc[i] / fmaxf(l[i / hd], 1e-30f);
}

}  // namespace

// q: (S, KV, G, hd) f32; pools (P, ps, KV, hd) int8; scales (S,) f32;
// block_table (S, NB) int32; cur (S,) int32; out (S, KV, G, hd) f32.
extern "C" int sparq_paged_decode_attn_launch(
    const void* q, const void* kd, const void* km, const void* kscale,
    const void* vd, const void* vm, const void* vscale,
    const void* block_table, const void* cur, void* out, int S, int KV,
    int G, int hd, int ps, int NB, int window, float sm_scale,
    void* stream) {
  const size_t smem =
      sizeof(float) * (2 * G * hd + 2 * ps * (hd + 1) + G * ps + 3 * G);
  cudaFuncSetAttribute(paged_decode_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  dim3 grid(S, KV);
  paged_decode_kernel<<<grid, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kd),
      static_cast<const int8_t*>(km), static_cast<const float*>(kscale),
      static_cast<const int8_t*>(vd), static_cast<const int8_t*>(vm),
      static_cast<const float*>(vscale), static_cast<const int*>(block_table),
      static_cast<const int*>(cur), static_cast<float*>(out), KV, G, hd, ps,
      NB, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
