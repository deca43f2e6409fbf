// K3, loop path: ragged chunked-prefill attention over the §5.1 packed page
// pool, for every shape the tensor-core path (sparq_chunked_prefill_attn.cu)
// does not take.
//
// Replaces: src/repro/kernels/sparq_prefill_attn.py::
//           sparq_chunked_prefill_attn_pallas (_kernel), where
//           kernels/sparq_prefill_attn.py::k3_path returns "loop": a head
//           dim other than 64, more than 64 query rows (bq * G) per tile,
//           a page size that does not divide 64, or a tensor that does not
//           start 16-byte aligned (the Pallas kernel asserts only C % bq ==
//           0 and an even hd).
// Computes: a chunk of C stream tokens (several sequences, each run
//   contiguous and aligned to bq rows, padding seq_id = -1) attends, per
//   token, to (1) its sequence's packed pages for kpos < hist, gathered
//   through the block table and meta-decoded in the loop, then (2) the
//   chunk's own float K/V of the same sequence with hist <= kpos <= pos;
//   an optional window keeps kpos > pos - window. Stage order: pages
//   ascending, then the chunk, as in the oracle. Online softmax with f32
//   statistics; each tile's q.k (score_dot), p.v and sum of p in f64,
//   rounded once to f32, as the tensor-core path; padding rows and padding
//   tiles write zeros.
// Bound: at serving shapes the score and value products (~30 flops per
//   byte moved) bound it; this path runs them on the f64 pipes, one
//   thread per (row, key) or (row, column), with no tensor cores. It is
//   the general path, not the fast one: shapes the serving configs run at
//   the CLI defaults take the tensor-core path.
// Design: one block per (query tile of bq tokens, KV head) holds bq * G
//   rows of statistics, any hd and any page size (shared memory is the
//   only limit; k3_path raises above it). The page stage reads
//   block_table[tile_seq, t] itself and stops at the tile's largest hist;
//   the chunk stage walks key tiles of 16 tokens and skips (exactly: a
//   fully masked tile leaves (m, l, acc) unchanged) any tile holding no
//   token of the tile's sequence. Decoded K/V tiles, scores, statistics and
//   the accumulator sit in shared memory. cudaFuncSetAttribute runs once
//   per device and larger shared-memory size.
#include "sparq_common.cuh"

namespace {

constexpr int THREADS = 256;
// chunk-stage key tile (kernels/sparq_prefill_attn.py::LOOP_KEY_TILE)
constexpr int KT = 16;

__global__ void __launch_bounds__(THREADS)
chunked_prefill_loop_kernel(const float* __restrict__ q,
                            const float* __restrict__ kc,
                            const float* __restrict__ vc,
                            const int8_t* __restrict__ kd,
                            const int8_t* __restrict__ km,
                            const float* __restrict__ kscale,
                            const int8_t* __restrict__ vd,
                            const int8_t* __restrict__ vm,
                            const float* __restrict__ vscale,
                            const int* __restrict__ block_table,
                            const int* __restrict__ seq_id,
                            const int* __restrict__ pos,
                            const int* __restrict__ hist,
                            const int* __restrict__ tile_seq,
                            float* __restrict__ out, int C, int KV,
                            int G, int hd, int ps, int NB, int bq,
                            int window, float sm_scale) {
  extern __shared__ float smem[];
  const int R = bq * G;
  const int T = max(ps, KT);
  const int ldk = hd + 1;
  float* qs = smem;                  // [R][hd]
  float* acc = qs + R * hd;          // [R][hd]
  float* kt = acc + R * hd;          // [T][ldk]
  float* vt = kt + T * ldk;          // [T][ldk]
  float* sc = vt + T * ldk;          // [R][T]
  float* m = sc + R * T;             // [R]
  float* l = m + R;                  // [R]
  float* corr = l + R;               // [R]
  int* rpos = reinterpret_cast<int*>(corr + R);  // [bq] per query token
  int* rhist = rpos + bq;                        // [bq]
  int* rvalid = rhist + bq;                      // [bq]
  int* kpos = rvalid + bq;                       // [KT] chunk key tile
  int* ksid = kpos + KT;                         // [KT]
  __shared__ int max_hist;

  const int qt = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int ts = tile_seq[qt];
  const int i0 = qt * bq;  // first stream token of the tile
  if (ts < 0) {
    for (int idx = tid; idx < R * hd; idx += THREADS) {
      const int r = idx / hd, d = idx - r * hd;
      const int i = i0 + r / G, g = r % G;
      out[(((size_t)i * KV + h) * G + g) * hd + d] = 0.f;
    }
    return;
  }
  for (int idx = tid; idx < R * hd; idx += THREADS) {
    const int r = idx / hd, d = idx - r * hd;
    const int i = i0 + r / G, g = r % G;
    qs[idx] = q[(((size_t)i * KV + h) * G + g) * hd + d];
    acc[idx] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
  }
  for (int t = tid; t < bq; t += THREADS) {
    const int i = i0 + t;
    rvalid[t] = seq_id[i] >= 0;
    rpos[t] = pos[i];
    rhist[t] = hist[i];
  }
  __syncthreads();
  if (tid == 0) {
    int mh = 0;
    for (int t = 0; t < bq; ++t)
      if (rvalid[t]) mh = max(mh, rhist[t]);
    max_hist = mh;
  }
  __syncthreads();

  // ---- stage 1: the sequence's packed pages, kpos < hist
  const float ks = kscale[ts], vs = vscale[ts];
  const int nblk = min(NB, (max_hist + ps - 1) / ps);
  for (int t = 0; t < nblk; ++t) {
    const int page = block_table[(size_t)ts * NB + t];
    if (page < 0) continue;  // unallocated: fully masked, exact to skip
    for (int idx = tid; idx < ps * hd; idx += THREADS) {
      const int r = idx / hd, d = idx - r * hd;
      const size_t off = (((size_t)page * ps + r) * KV + h) * hd + d;
      kt[r * ldk + d] = meta_decode(kd[off], km[off], d, ks);
      vt[r * ldk + d] = meta_decode(vd[off], vm[off], d, vs);
    }
    __syncthreads();
    for (int idx = tid; idx < R * ps; idx += THREADS) {
      const int r = idx / ps, j = idx - r * ps;
      const int tr = r / G;
      const int kp = t * ps + j;
      const bool ok = rvalid[tr] && kp < rhist[tr] &&
                      (window == 0 || kp > rpos[tr] - window);
      sc[idx] = ok ? score_dot(qs + r * hd, kt + j * ldk, hd) * sm_scale
                   : -CUDART_INF_F;
    }
    __syncthreads();
    online_softmax_tile(sc, vt, ldk, m, l, corr, acc, R, ps, hd);
  }

  // ---- stage 2: the chunk's float K/V, same sequence, hist <= kpos <= pos
  for (int j0 = 0; j0 < C; j0 += KT) {
    const int nk = min(KT, C - j0);
    bool mine = false;
    if (tid < nk) {
      ksid[tid] = seq_id[j0 + tid];
      kpos[tid] = pos[j0 + tid];
      mine = ksid[tid] == ts;
    }
    if (!__syncthreads_or(mine)) continue;  // no key of this sequence
    for (int idx = tid; idx < nk * hd; idx += THREADS) {
      const int j = idx / hd, d = idx - j * hd;
      const size_t off = ((size_t)(j0 + j) * KV + h) * hd + d;
      kt[j * ldk + d] = kc[off];
      vt[j * ldk + d] = vc[off];
    }
    __syncthreads();
    for (int idx = tid; idx < R * nk; idx += THREADS) {
      const int r = idx / nk, j = idx - r * nk;
      const int tr = r / G;
      const bool ok = rvalid[tr] && ksid[j] == ts && kpos[j] <= rpos[tr] &&
                      kpos[j] >= rhist[tr] &&
                      (window == 0 || kpos[j] > rpos[tr] - window);
      sc[idx] = ok ? score_dot(qs + r * hd, kt + j * ldk, hd) * sm_scale
                   : -CUDART_INF_F;
    }
    __syncthreads();
    online_softmax_tile(sc, vt, ldk, m, l, corr, acc, R, nk, hd);
  }

  for (int idx = tid; idx < R * hd; idx += THREADS) {
    const int r = idx / hd, d = idx - r * hd;
    const int i = i0 + r / G, g = r % G;
    out[(((size_t)i * KV + h) * G + g) * hd + d] =
        acc[idx] / fmaxf(l[r], 1e-30f);
  }
}

}  // namespace

// q (C, KV, G, hd) f32; k/v_chunk (C, KV, hd) f32; pools (P, ps, KV, hd)
// int8; scales (S,) f32; block_table (S, NB) int32; seq_id/pos/hist (C,)
// int32; tile_seq (C / bq,) int32; out (C, KV, G, hd) f32.
extern "C" int sparq_chunked_prefill_attn_loop_launch(
    const void* q, const void* kc, const void* vc, const void* kd,
    const void* km, const void* kscale, const void* vd, const void* vm,
    const void* vscale, const void* block_table, const void* seq_id,
    const void* pos, const void* hist, const void* tile_seq, void* out,
    int C, int KV, int G, int hd, int ps, int NB, int bq, int window,
    float sm_scale, void* stream) {
  if (C <= 0 || KV <= 0 || G <= 0 || hd <= 0 || ps <= 0 || NB <= 0 ||
      bq <= 0 || C % bq)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = bq * G, T = ps > KT ? ps : KT;
  const size_t smem = sizeof(float) * (2 * R * hd + 2 * T * (hd + 1) +
                                       R * T + 3 * R) +
                      sizeof(int) * (3 * bq + 2 * KT);
  static size_t attr_smem[64] = {};
  const cudaError_t e =
      set_smem_once(chunked_prefill_loop_kernel, smem, attr_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(C / bq, KV);
  chunked_prefill_loop_kernel<<<grid, THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<const int8_t*>(kd),
      static_cast<const int8_t*>(km), static_cast<const float*>(kscale),
      static_cast<const int8_t*>(vd), static_cast<const int8_t*>(vm),
      static_cast<const float*>(vscale), static_cast<const int*>(block_table),
      static_cast<const int*>(seq_id), static_cast<const int*>(pos),
      static_cast<const int*>(hist), static_cast<const int*>(tile_seq),
      static_cast<float*>(out), C, KV, G, hd, ps, NB, bq, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
