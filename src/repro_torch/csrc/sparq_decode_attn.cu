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
//   Online softmax with f32 statistics and f64 sums per tile;
//   out = acc / max(l, 1e-30).
// Bound: device-memory bytes (the packed planes, 4 bytes per cached key and
//   head dim for K and V data + meta, plus kpos and the f32 query and
//   output): ~2 flops per byte.
// Design: the split-key body of sparq_decode_common.cuh, a block per
//   (sequence, KV head, split of split_plan over the Tk rows), the last
//   block of a (sequence, head) combining the splits. cur and both scales
//   are read from device memory, so the decode loop needs no host sync.
//   Each block reads its rows' kpos in place and masks the ragged last
//   tile itself (rows beyond Tk are zeros, masked): the numbers of the
//   reference's zero / -1 padding, without copying the cache every step.
//   With bk == page_size the splits, tiles and sums are K2's over the same
//   bytes, so the two kernels agree bit for bit.
#include "sparq_decode_common.cuh"

namespace {

__global__ void __launch_bounds__(splitkey::THREADS)
decode_attn_kernel(const float* __restrict__ q, const int8_t* __restrict__ kd,
                   const int8_t* __restrict__ km,
                   const float* __restrict__ kscale,
                   const int8_t* __restrict__ vd,
                   const int8_t* __restrict__ vm,
                   const float* __restrict__ vscale,
                   const int* __restrict__ kpos, const int* __restrict__ cur,
                   float* __restrict__ out, float* __restrict__ ws,
                   int* __restrict__ counters, int KV, int G, int hd, int bk,
                   int Tk, int window, int kps, int n_splits, int vec,
                   float sm_scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const splitkey::ContigRows rows{kpos + (size_t)b * Tk, (long long)b * Tk,
                                  Tk, cur[0], window, KV, h, hd};
  splitkey::split_decode(rows, q, kd, km, kscale[0], vd, vm, vscale[0], out,
                         ws, counters, G, hd, bk, kps, n_splits, vec,
                         sm_scale);
}

}  // namespace

// q: (B, KV, G, hd) f32; planes (B, Tk, KV, hd) int8; scales (1,) f32;
// kpos (B, Tk) int32; cur (1,) int32; out (B, KV, G, hd) f32;
// ws: B * KV * n_splits * G * (hd + 2) f32 and counters: B * KV int32, all
// 0, with n_splits = ceil(Tk / kps); kps: keys per split, a multiple of bk
// (kernels/sparq_decode_attn.py::split_geometry); vec: the four planes
// start 16-byte aligned.
extern "C" int sparq_decode_attn_launch(
    const void* q, const void* kd, const void* km, const void* kscale,
    const void* vd, const void* vm, const void* vscale, const void* kpos,
    const void* cur, void* out, void* ws, void* counters, int B, int KV,
    int G, int hd, int bk, int Tk, int window, int kps, int vec,
    float sm_scale, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || hd <= 0 || bk <= 0 || Tk <= 0 ||
      kps <= 0 || kps % bk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_splits = (Tk + kps - 1) / kps;
  const size_t smem = splitkey::smem_bytes(G, hd, bk, kps);
  static size_t attr_smem[64] = {};
  const cudaError_t e = set_smem_once(decode_attn_kernel, smem, attr_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B, KV, n_splits);
  decode_attn_kernel<<<grid, splitkey::THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kd),
      static_cast<const int8_t*>(km), static_cast<const float*>(kscale),
      static_cast<const int8_t*>(vd), static_cast<const int8_t*>(vm),
      static_cast<const float*>(vscale), static_cast<const int*>(kpos),
      static_cast<const int*>(cur), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), KV, G, hd, bk,
      Tk, window, kps, n_splits, vec && hd % 16 == 0, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
