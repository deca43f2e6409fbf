// K5: contiguous flash-decode attention over the §5.1 packed KV planes.
//
// Replaces: src/repro/kernels/sparq_decode_attn.py::sparq_decode_attn_pallas
//           (_kernel, _flash_tile_body, _meta_decode_f32).
// Computes: for every sequence b and KV head h, the G grouped query heads
//   of the one decode token attend over the sequence's Tk cache slots.
//   Each Tk tile of bk slots is meta-decoded in the loop:
//   sign(q) * (|q| << shift) * scale. Mask: kpos >= 0 and kpos <= cur
//   (and kpos > cur - window), where kpos is the slot's absolute position
//   (-1 = empty; arange for the linear cache, rotated for a ring).
//   Online softmax with f32 statistics and f64 tile sums (score_dot,
//   online_softmax_tile); out = acc / max(l, 1e-30).
// Bound: device-memory bytes (the packed planes, 2 B per cached value for
//   data + meta, plus kpos and the f32 query/output); ~2 flops per byte.
// Design: one block per (sequence, KV head) loops over the Tk tiles (the
//   TPU kernel's sequential grid axis). cur and both scales are read from
//   device memory, so the decode loop needs no host sync. The ragged last
//   tile is masked here, with its rows beyond Tk decoded as zeros: the
//   same numbers as the reference's zero/-1 padding, without copying the
//   cache every step. A tile with no unmasked slot leaves (m, l, acc)
//   unchanged, so it is skipped. The tile body (meta_decode,
//   online_softmax_tile, the score loop) is K2's: with bk == page_size the
//   two kernels agree bit for bit on the same bytes.
#include "sparq_common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const float* __restrict__ q, const int8_t* __restrict__ kd,
                   const int8_t* __restrict__ km,
                   const float* __restrict__ kscale,
                   const int8_t* __restrict__ vd,
                   const int8_t* __restrict__ vm,
                   const float* __restrict__ vscale,
                   const int* __restrict__ kpos, const int* __restrict__ cur,
                   float* __restrict__ out, int Tk, int KV, int G, int hd,
                   int bk, int window, float sm_scale) {
  extern __shared__ float smem[];
  const int ldk = hd + 1;
  float* qs = smem;                 // [G][hd]
  float* acc = qs + G * hd;         // [G][hd]
  float* kt = acc + G * hd;         // [bk][ldk]
  float* vt = kt + bk * ldk;        // [bk][ldk]
  float* sc = vt + bk * ldk;        // [G][bk]
  float* m = sc + G * bk;           // [G]
  float* l = m + G;                 // [G]
  float* corr = l + G;              // [G]
  int* okt = reinterpret_cast<int*>(corr + G);  // [bk]

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int c = cur[0];
  const float ks = kscale[0], vs = vscale[0];
  const size_t qbase = ((size_t)b * KV + h) * G * hd;
  for (int i = tid; i < G * hd; i += THREADS) {
    qs[i] = q[qbase + i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
  }
  const int nt = (Tk + bk - 1) / bk;
  for (int t = 0; t < nt; ++t) {
    int any = 0;
    for (int j = tid; j < bk; j += THREADS) {
      const int row = t * bk + j;
      const int kp = row < Tk ? kpos[(size_t)b * Tk + row] : -1;
      const int ok =
          kp >= 0 && kp <= c && (window == 0 || kp > c - window);
      okt[j] = ok;
      any |= ok;
    }
    // also orders the previous tile's reads of kt/vt/sc before the writes
    if (!__syncthreads_or(any)) continue;  // fully masked: exact to skip
    for (int idx = tid; idx < bk * hd; idx += THREADS) {
      const int r = idx / hd, d = idx - r * hd;
      const int row = t * bk + r;
      float kv = 0.f, vv = 0.f;
      if (row < Tk) {
        const size_t off = (((size_t)b * Tk + row) * KV + h) * hd + d;
        kv = meta_decode(kd[off], km[off], d, ks);
        vv = meta_decode(vd[off], vm[off], d, vs);
      }
      kt[r * ldk + d] = kv;
      vt[r * ldk + d] = vv;
    }
    __syncthreads();
    for (int idx = tid; idx < G * bk; idx += THREADS) {
      const int g = idx / bk, j = idx - g * bk;
      sc[idx] = okt[j] ? score_dot(qs + g * hd, kt + j * ldk, hd) * sm_scale
                       : -CUDART_INF_F;
    }
    __syncthreads();
    online_softmax_tile(sc, vt, ldk, m, l, corr, acc, G, bk, hd);
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += THREADS)
    out[qbase + i] = acc[i] / fmaxf(l[i / hd], 1e-30f);
}

}  // namespace

// q: (B, KV, G, hd) f32; planes (B, Tk, KV, hd) int8; scales (1,) f32;
// kpos (B, Tk) int32; cur (1,) int32; out (B, KV, G, hd) f32.
extern "C" int sparq_decode_attn_launch(
    const void* q, const void* kd, const void* km, const void* kscale,
    const void* vd, const void* vm, const void* vscale, const void* kpos,
    const void* cur, void* out, int B, int Tk, int KV, int G, int hd, int bk,
    int window, float sm_scale, void* stream) {
  const size_t smem = sizeof(float) * (2 * G * hd + 2 * bk * (hd + 1) +
                                       G * bk + 3 * G) +
                      sizeof(int) * bk;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, KV);
  decode_attn_kernel<<<grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kd),
      static_cast<const int8_t*>(km), static_cast<const float*>(kscale),
      static_cast<const int8_t*>(vd), static_cast<const int8_t*>(vm),
      static_cast<const float*>(vscale), static_cast<const int*>(kpos),
      static_cast<const int*>(cur), static_cast<float*>(out), Tk, KV, G, hd,
      bk, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
