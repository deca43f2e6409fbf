// K2: paged flash-decode attention over the §5.1 packed page pool.
//
// Replaces: src/repro/kernels/sparq_decode_attn.py::
//           sparq_paged_decode_attn_pallas (_paged_kernel, _flash_tile_body,
//           _meta_decode_f32).
// Computes: for every slot b and KV head h, the G grouped query heads of
//   the one decode token attend over the slot's pages, gathered through the
//   block table. Each page is a tile, meta-decoded in the loop:
//   sign(q) * (|q| << shift) * scale[b]. Mask: block allocated and
//   kpos <= cur[b] (and kpos > cur[b] - window). Online softmax with f32
//   statistics and f64 sums per tile; out = acc / max(l, 1e-30). An
//   inactive slot (cur < 0) writes exact zeros.
// Bound: device-memory bytes (the packed pages, 4 bytes per cached key and
//   head dim for K and V data + meta, plus the f32 query and output): ~2
//   flops per byte.
// Design: the split-key body of sparq_decode_common.cuh, a block per
//   (slot, KV head, split of split_plan over logical key positions), the
//   last block of a (slot, head) combining the splits. A block finds its
//   keys' rows through block_table[b, key / ps] itself (the TPU kernel
//   scalar-prefetched the table); keys beyond cur, outside the window or
//   on unallocated blocks are masked and never read, so a split beyond cur
//   only stores an empty partial. With bk == page_size, K5 runs the same
//   splits and tiles over the same bytes: the two agree bit for bit.
#include "sparq_decode_common.cuh"

namespace {

__global__ void __launch_bounds__(splitkey::THREADS)
paged_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ kd,
                    const int8_t* __restrict__ km,
                    const float* __restrict__ kscale,
                    const int8_t* __restrict__ vd,
                    const int8_t* __restrict__ vm,
                    const float* __restrict__ vscale,
                    const int* __restrict__ block_table,
                    const int* __restrict__ cur, float* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters,
                    int KV, int G, int hd, int ps, int NB, int window,
                    int kps, int n_splits, int vec, float sm_scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int c = cur[b];
  const splitkey::PagedRows rows{block_table + (size_t)b * NB, NB, ps, c,
                                 window, KV, h, hd};
  splitkey::split_decode(rows, q, kd, km, kscale[b], vd, vm, vscale[b], out,
                         ws, counters, G, hd, ps, kps, n_splits, vec,
                         sm_scale);
}

}  // namespace

// q: (S, KV, G, hd) f32; pools (P, ps, KV, hd) int8; scales (S,) f32;
// block_table (S, NB) int32; cur (S,) int32; out (S, KV, G, hd) f32;
// ws: S * KV * n_splits * G * (hd + 2) f32 and counters: S * KV int32, all
// 0, with n_splits = ceil(NB * ps / kps); kps: keys per split, a multiple
// of ps (kernels/sparq_decode_attn.py::split_geometry); vec: the four
// pools start 16-byte aligned.
extern "C" int sparq_paged_decode_attn_launch(
    const void* q, const void* kd, const void* km, const void* kscale,
    const void* vd, const void* vm, const void* vscale,
    const void* block_table, const void* cur, void* out, void* ws,
    void* counters, int S, int KV, int G, int hd, int ps, int NB,
    int window, int kps, int vec, float sm_scale, void* stream) {
  if (S <= 0 || KV <= 0 || G <= 0 || hd <= 0 || ps <= 0 || NB <= 0 ||
      kps <= 0 || kps % ps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_splits = (NB * ps + kps - 1) / kps;
  const size_t smem = splitkey::smem_bytes(G, hd, ps, kps);
  static size_t attr_smem[64] = {};
  const cudaError_t e = set_smem_once(paged_decode_kernel, smem, attr_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(S, KV, n_splits);
  paged_decode_kernel<<<grid, splitkey::THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kd),
      static_cast<const int8_t*>(km), static_cast<const float*>(kscale),
      static_cast<const int8_t*>(vd), static_cast<const int8_t*>(vm),
      static_cast<const float*>(vscale), static_cast<const int*>(block_table),
      static_cast<const int*>(cur), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), KV, G, hd, ps,
      NB, window, kps, n_splits, vec && hd % 16 == 0, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
