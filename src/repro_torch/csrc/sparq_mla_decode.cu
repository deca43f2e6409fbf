// K7: absorbed-MLA flash-decode over the two §5.1 packed latent planes.
//
// Replaces: src/repro/models/mla.py::_sparq_mla_decode. Not a Pallas kernel
//   in the reference: a lax.scan over tiles of 128 keys, each tile calling
//   sparq_dequantize (K6) on both planes and then about fifteen XLA ops.
//   Ported as Python, that would be two K6 launches and ~15 PyTorch ops a
//   tile, a layer and a decode step; this kernel is one launch a layer and
//   a step, and meta-decodes the packed bytes inside its loop, as K2 and
//   K5 do, so the MLA decode launches no K6.
// Computes: for batch row b and head h, with c = decode(c) * c_scale and
//   pe = decode(pe) * pe_scale (each plane under its own f32 scale):
//     s[t] = (q_lat[b,h] . c[b,t] + q_pe[b,h] . pe[b,t]) * sm_scale,
//   keys t >= pos masked (pos: the cache position after this step's
//   append, one value for the batch), softmax over t, and
//     o_lat[b,h] = sum_t p[t] c[b,t] / max(l, 1e-30):
//   the values are the latent plane itself, of width r; the keys are
//   [c, pe], of width r + dr.
// Bound: device-memory bytes. A step reads each live key's r + dr data and
//   meta bytes once (2 x 576 bytes a key at deepseek-v2-lite's widths) and
//   does about 2 x 16 heads x (576 + 512) flops a key: ~30 flops a byte,
//   below the card's f32 ridge. At the scan decode's 8 x 296 keys that is
//   2.7 MB, ~0.8 us at 3.35 TB/s.
// Design: the split-key pattern of sparq_decode_common.cuh, specialised:
//   - a block per (batch row, split of kps keys), all H heads in the block,
//     since every head attends over the same latent keys (MQA-like: G = H
//     over one "KV head"). Live keys are a prefix (t < min(pos, Tk)), so a
//     split knows its live count from pos alone and reads nothing else.
//   - the split's keys are meta-decoded once into one f32 shared tile of
//     rows [c | pe] (16-byte vectors of both planes when r and dr are
//     multiples of 16 and the planes aligned, else byte by byte); the
//     value rows are the tile's first r columns, so no value tile exists.
//   - q (both parts) and p sit in f64 in shared memory; the scores are f64
//     sums over r + dr rounded once to f32 (a thread per key and RG heads),
//     the softmax statistics f32 with an f64 sum of p (a warp per head),
//     and P V f64 sums over the split's keys (a thread per column and RG
//     heads).
//   - each block stores (m, l, acc[H][r]) in an f32 workspace (an empty
//     split m = -inf only), takes a ticket from its batch row's counter,
//     and the last block combines the splits and resets the counter: one
//     launch, no memset. The combine loads every split's m and l at once
//     into shared memory, a thread a head turns them into f32 weights
//     e^(m_i - M) and an f64 l, and then every thread takes 4 columns of
//     out [H][r] at a time, each an f64 sum over the splits in order, with
//     the 4 x 8 loads of 8 splits in flight together: the combine is one
//     block's, so its loads in flight set its time. (splitkey::combine,
//     built for hd <= 256 and a few rows, walks 64 columns of two rows a
//     pass, each a chain of L2 round trips: 16 passes at H 16, r 512.)
//   The block holds q [H][r + dr] and p [H][kps] in f64 and the tile
//   [kps][row_stride(r + dr)] in f32: 152,064 bytes at H 16, r 512, dr 64
//   and 32 keys (kernels/sparq_mla_decode.py::smem_bytes, which halves the
//   split until the layout fits; the combine reuses it and needs 4 (2 H
//   n_splits + H) bytes).
#include "sparq_decode_common.cuh"

namespace {

using splitkey::RG;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// dynamic shared memory of one block (kernels/sparq_mla_decode.py::
// smem_bytes): q [H][r + dr] and p [H][kps] in f64 (their count rounded up
// to even, so the tile starts 16-byte aligned), then the f32 key tile
// [kps][row_stride(r + dr)]; at least the combine's m, l [n_splits][H]
// and 1 / l [H] in f32
inline size_t smem_bytes(int H, int r, int dr, int kps, int n_splits) {
  const size_t nd = (size_t)H * (r + dr) + (size_t)H * kps;
  const size_t layout =
      sizeof(double) * (nd + (nd & 1)) +
      sizeof(float) * (size_t)kps * splitkey::row_stride(r + dr);
  const size_t comb = sizeof(float) * (2 * (size_t)H * n_splits + H);
  return layout > comb ? layout : comb;
}

// The last block's combine of a batch row's n_splits partials (each m [H],
// l [H], acc [H][r] at parts + z * part_len) into out [H][r]: M = max_z m,
// w_z = e^(m_z - M) in f32 (0 for an empty split), l = sum_z w_z l_z in
// f64 in split order, out = (sum_z w_z acc_z in f64, split order) / max(l,
// 1e-30) in f32. sm holds at least 2 H n_splits + H floats.
__device__ __forceinline__ void combine(const float* __restrict__ parts,
                                        float* __restrict__ out, int H,
                                        int rank, int n_splits,
                                        size_t part_len, float* sm) {
  float* w = sm;                           // [n_splits][H]: m, then w
  float* lz = w + (size_t)n_splits * H;    // [n_splits][H]
  float* lsum = lz + (size_t)n_splits * H; // [H]
  for (int i = threadIdx.x; i < n_splits * H; i += THREADS) {
    const int z = i / H, h = i - z * H;
    w[i] = __ldcg(parts + z * part_len + h);
    lz[i] = __ldcg(parts + z * part_len + H + h);
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += THREADS) {
    float mx = -CUDART_INF_F;
    for (int z = 0; z < n_splits; ++z) mx = fmaxf(mx, w[z * H + h]);
    double l = 0.0;
    for (int z = 0; z < n_splits; ++z) {
      const float m = w[z * H + h];
      const float wt = m == -CUDART_INF_F ? 0.f : expf(m - mx);
      w[z * H + h] = wt;
      if (wt != 0.f)
        l = fma(static_cast<double>(wt), static_cast<double>(lz[z * H + h]),
                l);
    }
    lsum[h] = fmaxf(static_cast<float>(l), 1e-30f);
  }
  __syncthreads();
  // EC columns a thread and ZB splits at a time: EC x ZB loads in flight
  // before the sums that need them (one block does a whole row's
  // combine, so its memory-level parallelism is its time)
  constexpr int EC = 4, ZB = 8;
  const float* acc = parts + 2 * H;
  const int n = H * rank;
  for (int i0 = threadIdx.x; i0 < n; i0 += EC * THREADS) {
    double a[EC];
#pragma unroll
    for (int e = 0; e < EC; ++e) a[e] = 0.0;
    for (int z0 = 0; z0 < n_splits; z0 += ZB) {
      float x[EC][ZB];
#pragma unroll
      for (int e = 0; e < EC; ++e)
#pragma unroll
        for (int v = 0; v < ZB; ++v) {
          const int i = i0 + e * THREADS;
          x[e][v] = i < n && z0 + v < n_splits
                        ? __ldcg(acc + (z0 + v) * part_len + i)
                        : 0.f;
        }
#pragma unroll
      for (int e = 0; e < EC; ++e) {
        const int h = min(i0 + e * THREADS, n - 1) / rank;
#pragma unroll
        for (int v = 0; v < ZB; ++v) {
          const float wt = z0 + v < n_splits ? w[(z0 + v) * H + h] : 0.f;
          if (wt != 0.f)
            a[e] = fma(static_cast<double>(wt),
                       static_cast<double>(x[e][v]), a[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < EC; ++e) {
      const int i = i0 + e * THREADS;
      if (i < n) out[i] = static_cast<float>(a[e]) / lsum[i / rank];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
mla_decode_kernel(const float* __restrict__ q_lat,
                  const float* __restrict__ q_pe,
                  const int8_t* __restrict__ cd, const int8_t* __restrict__ cm,
                  const float* __restrict__ cscale,
                  const int8_t* __restrict__ pd, const int8_t* __restrict__ pm,
                  const float* __restrict__ pscale,
                  const int* __restrict__ pos, float* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters, int H,
                  int rank, int dr, int Tk, int kps, int n_splits, int vec,
                  float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dk = rank + dr, ldk = splitkey::row_stride(dk);
  const size_t nd = (size_t)H * dk + (size_t)H * kps;
  double* q64 = reinterpret_cast<double*>(smem_raw);  // [H][dk]
  double* p64 = q64 + (size_t)H * dk;                 // [H][kps]
  float* kt = reinterpret_cast<float*>(q64 + nd + (nd & 1));  // [kps][ldk]
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, split = blockIdx.y;
  const size_t part_len = (size_t)H * (rank + 2);
  float* part = ws + ((size_t)b * n_splits + split) * part_len;
  const int k0 = split * kps;
  // live keys t < min(pos, Tk): a prefix, so this split's are its first nk
  const int nk = max(0, min(kps, min(pos[0], Tk) - k0));

  if (nk > 0) {
    for (int i = tid; i < H * dk; i += THREADS) {
      const int h = i / dk, d = i - h * dk;
      const size_t bh = (size_t)b * H + h;
      q64[i] = d < rank ? q_lat[bh * rank + d] : q_pe[bh * dr + d - rank];
    }
    const float cs = cscale[0], ps = pscale[0];
    const long long c0 = ((long long)b * Tk + k0) * rank;
    const long long p0 = ((long long)b * Tk + k0) * dr;
    if (vec) {  // rank, dr multiples of 16; the four planes 16-byte aligned
      const int nvc = rank >> 4, nv = nvc + (dr >> 4);
      for (int idx = tid; idx < nk * nv; idx += THREADS) {
        const int j = idx / nv, u = idx - j * nv;
        if (u < nvc) {
          const long long e = c0 + (long long)j * rank + 16 * u;
          splitkey::decode16(__ldg(reinterpret_cast<const int4*>(cd + e)),
                             __ldg(reinterpret_cast<const int4*>(cm + e)),
                             cs, kt + j * ldk + 16 * u);
        } else {
          const int w = u - nvc;
          const long long e = p0 + (long long)j * dr + 16 * w;
          splitkey::decode16(__ldg(reinterpret_cast<const int4*>(pd + e)),
                             __ldg(reinterpret_cast<const int4*>(pm + e)),
                             ps, kt + j * ldk + rank + 16 * w);
        }
      }
    } else {
      for (int idx = tid; idx < nk * dk; idx += THREADS) {
        const int j = idx / dk, d = idx - j * dk;
        float x;
        if (d < rank) {
          const long long e = c0 + (long long)j * rank + d;
          x = meta_decode(cd[e], cm[e], d, cs);
        } else {
          const int d2 = d - rank;
          const long long e = p0 + (long long)j * dr + d2;
          x = meta_decode(pd[e], pm[e], d2, ps);
        }
        kt[j * ldk + d] = x;
      }
    }
    __syncthreads();

    // scores: a thread per key and RG heads, f64 sums over [c | pe]
    const int ngr = (H + RG - 1) / RG;
    const bool v4 = (dk & 3) == 0;
    for (int it = tid; it < nk * ngr; it += THREADS) {
      const int j = it % nk, g0 = (it / nk) * RG;
      const int nr = min(RG, H - g0);
      const float* kr = kt + j * ldk;
      const double* qr[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) qr[r] = q64 + (g0 + min(r, nr - 1)) * dk;
      double a[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) a[r] = 0.0;
      if (v4) {
        for (int d = 0; d < dk; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
          const double x0 = k4.x, x1 = k4.y, x2 = k4.z, x3 = k4.w;
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            a[r] = fma(qr[r][d], x0, a[r]);
            a[r] = fma(qr[r][d + 1], x1, a[r]);
            a[r] = fma(qr[r][d + 2], x2, a[r]);
            a[r] = fma(qr[r][d + 3], x3, a[r]);
          }
        }
      } else {
        for (int d = 0; d < dk; ++d) {
          const double x = kr[d];
#pragma unroll
          for (int r = 0; r < RG; ++r) a[r] = fma(qr[r][d], x, a[r]);
        }
      }
      for (int r = 0; r < nr; ++r)
        p64[(g0 + r) * kps + j] = static_cast<float>(a[r]) * sm_scale;
    }
    __syncthreads();

    // the split's softmax statistics, a warp per head: every key is live
    for (int g = warp; g < H; g += WARPS) {
      double* prow = p64 + g * kps;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < nk; j += 32)
        mx = fmaxf(mx, static_cast<float>(prow[j]));
      mx = splitkey::warp_max(mx);
      double sum = 0.0;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(static_cast<float>(prow[j]) - mx);
        prow[j] = p;
        sum += p;
      }
      sum = splitkey::warp_sum(sum);
      if (lane == 0) {
        part[g] = mx;
        part[H + g] = static_cast<float>(sum);
      }
    }
    __syncthreads();

    // P V over the tile's first rank columns: a thread per column, RG heads
    for (int it = tid; it < rank * ngr; it += THREADS) {
      const int d = it % rank, g0 = (it / rank) * RG;
      const int nr = min(RG, H - g0);
      int gr[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) gr[r] = g0 + min(r, nr - 1);
      double a[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) a[r] = 0.0;
#pragma unroll 4
      for (int j = 0; j < nk; ++j) {
        const double v = kt[j * ldk + d];
#pragma unroll
        for (int r = 0; r < RG; ++r) a[r] = fma(p64[gr[r] * kps + j], v, a[r]);
      }
      for (int r = 0; r < nr; ++r)
        part[2 * H + (g0 + r) * rank + d] = static_cast<float>(a[r]);
    }
  } else {
    for (int g = tid; g < H; g += THREADS) part[g] = -CUDART_INF_F;
  }

  // the last block of this batch row to arrive combines the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + b, 1) == n_splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (tid == 0) counters[b] = 0;
  combine(ws + (size_t)b * n_splits * part_len, out + (size_t)b * H * rank,
          H, rank, n_splits, part_len, reinterpret_cast<float*>(smem_raw));
}

}  // namespace

// q_lat (B, H, r) and q_pe (B, H, dr) f32; c planes (B, Tk, r) and pe
// planes (B, Tk, dr) int8; scales (1,) f32; pos (1,) int32; out (B, H, r)
// f32; ws: B * n_splits * H * (r + 2) f32 and counters: B int32, all 0
// between calls, with n_splits = ceil(Tk / kps); vec: r and dr multiples of
// 16 and the four planes 16-byte aligned.
extern "C" int sparq_mla_decode_launch(
    const void* q_lat, const void* q_pe, const void* cd, const void* cm,
    const void* cscale, const void* pd, const void* pm, const void* pscale,
    const void* pos, void* out, void* ws, void* counters, int B, int H,
    int rank, int dr, int Tk, int kps, int vec, float sm_scale,
    void* stream) {
  if (B <= 0 || H <= 0 || rank <= 0 || dr <= 0 || rank % 2 || dr % 2 ||
      Tk <= 0 || kps <= 0 || (vec && (rank % 16 || dr % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_splits = (Tk + kps - 1) / kps;
  const size_t smem = smem_bytes(H, rank, dr, kps, n_splits);
  static size_t attr_smem[64] = {};
  const cudaError_t e = set_smem_once(mla_decode_kernel, smem, attr_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mla_decode_kernel<<<dim3(B, n_splits), THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_pe),
      static_cast<const int8_t*>(cd), static_cast<const int8_t*>(cm),
      static_cast<const float*>(cscale), static_cast<const int8_t*>(pd),
      static_cast<const int8_t*>(pm), static_cast<const float*>(pscale),
      static_cast<const int*>(pos), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), H, rank, dr, Tk,
      kps, n_splits, vec, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
