// The split-key flash-decode body of K2 (sparq_paged_decode_attn.cu) and
// K5 (sparq_decode_attn.cu): one query token per slot, G grouped query
// heads per KV head, attending over the slot's §5.1 packed keys.
//
// Bound: device-memory bytes. A decode step reads each cached key's int8
//   data and meta planes once (4 bytes per key and head dim for K and V)
//   and does ~2 flops per byte, so the card's floor is the packed bytes
//   over 3.35 TB/s (about 0.6 us for 2 MB). The TPU kernels walked a
//   slot's tiles in series on one core; here that chain was the time.
// Design:
//   - Split keys: a block per (slot, KV head, split). A split is a fixed
//     run of max(1, SPLIT_KEYS / tile) tiles at key positions (K2: logical
//     positions through the block table; K5: rows of the planes): the rule
//     is kernels/sparq_decode_attn.py::split_plan, and it depends only on
//     the positions and the tile size, so K5 at bk = page size and K2 over
//     the same bytes cut, and round, identically. A serving batch of 8
//     slots x 4 KV heads gives a few hundred blocks instead of 32.
//   - Loads: one pass finds every key's row (block table or kpos, the
//     mask), then all the split's int8 data and meta bytes are loaded at
//     once as 16-byte vectors (UNROLL per plane in flight per thread) and
//     meta-decoded once per element into f32 shared tiles (the oracle's
//     f32 product, exact in f32). Masked keys are zero-filled, not read.
//   - Per tile: q (widened once per block) and p sit in f64 in shared
//     memory, so the products convert each K and V element once per RG
//     rows instead of once per product. A thread takes one key and RG
//     query rows of the scores (RG independent f64 chains, k read as
//     float4; each dot an f64 sum in d order, rounded once), a
//     warp per query row takes the row max and the f64 sum of p with
//     shuffles, and a thread takes one column and RG rows of P V (RG
//     independent f64 sums over the tile's keys in key order). The f32
//     statistics follow the oracle's rules (m_safe = 0 when m is -inf,
//     corr = 0 when the previous m is -inf); a tile without a live key is
//     skipped, which is exact. Widening both f32 operands of every f64
//     product made the conversions, not the products, the tiles' cost
//     (probes/decode_probe.py).
//   - Combine: each block stores its partial (m, l, acc) in an f32
//     workspace (an empty split stores m = -inf only) and takes a ticket
//     from its (slot, head)'s arrival counter; the last block combines the
//     partials (`combine`, below) and resets the counter to 0. The result
//     does not depend on which block finishes last, and a call is one
//     launch with no memset.
//   - Chunks: when a split's whole layout does not fit one block's shared
//     memory (a tile of 128 keys at G 48 / hd 128, or at hd 256), the
//     split is walked in chunks of `sub` keys (kernels/sparq_decode_attn.py
//     ::sub_keys halves the split until the layout fits): each chunk is
//     loaded, scored and applied as its own online-softmax update, with the
//     row statistics and the f32 accumulator kept in shared memory between
//     chunks. A split that fits is one chunk and runs as before; K5 at bk =
//     page size and K2 take the same chunks, so they still agree bit for bit.
#pragma once

#include "sparq_common.cuh"

namespace splitkey {

constexpr int SPLIT_KEYS = 32;  // kernels/sparq_decode_attn.py::SPLIT_KEYS
constexpr int THREADS = 128;    // kernels/sparq_decode_attn.py::THREADS
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;       // 16-byte vectors per plane per batch
constexpr int RG = 4;           // query rows a thread takes in a product

// row stride (floats) of the q, K and V tiles: hd rounded up to 4, plus 4,
// so rows are 16-byte aligned and 8 rows read as float4 hit 32 banks
__host__ __device__ inline int row_stride(int hd) {
  return ((hd + 3) & ~3) + 4;
}

// dynamic shared memory of one block (kernels/sparq_decode_attn.py::
// smem_bytes): row offsets [kps] int64, q [G][hd] and the chunk's scores,
// then p, [G][sub] f64 (each count rounded up to even), then f32 K and V
// [sub][ld], corr [units][G], the units' live flags (int) and, when the
// split takes more than one chunk, the f32 accumulator [G][hd] and the row
// statistics m [G], l [G]. A unit is min(tile, sub) keys: one online update
inline size_t smem_bytes(int G, int hd, int tile, int kps, int sub) {
  const size_t ld = row_stride(hd), gk = (size_t)G * sub;
  const size_t tps = sub / (tile < sub ? tile : sub);
  return sizeof(double) * ((kps + (kps & 1)) + (size_t)G * hd + gk +
                           (gk & 1)) +
         sizeof(float) * (2 * (size_t)sub * ld + tps * G) +
         sizeof(int) * tps +
         (sub < kps ? sizeof(float) * ((size_t)G * hd + 2 * G) : 0);
}

// K2's keys: logical position `key` of slot b through its block-table row
struct PagedRows {
  const int* bt;  // block_table + b * NB
  int NB, ps, c, window, KV, h, hd;
  __device__ __forceinline__ long long operator()(int key) const {
    if (c < 0 || key > c || (window && key <= c - window)) return -1;
    const int t = key / ps;
    if (t >= NB) return -1;
    const int page = bt[t];
    if (page < 0) return -1;
    return (((long long)page * ps + (key - t * ps)) * KV + h) * hd;
  }
};

// K5's keys: row `key` of slot b's planes, masked by its kpos
struct ContigRows {
  const int* kpos;  // kpos + b * Tk
  long long row0;   // b * Tk
  int Tk, c, window, KV, h, hd;
  __device__ __forceinline__ long long operator()(int key) const {
    if (key >= Tk) return -1;
    const int kp = kpos[key];
    if (kp < 0 || kp > c || (window && kp <= c - window)) return -1;
    return ((row0 + key) * KV + h) * hd;
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// butterfly sum: every lane ends with the same bits (a + b == b + a)
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// meta-decode 16 lanes (a 16-byte data vector and its meta vector) of one
// key row starting at an even head-dim lane
__device__ __forceinline__ void decode16(int4 dv, int4 mv, float scale,
                                         float* dst) {
  const uint32_t dw[4] = {static_cast<uint32_t>(dv.x),
                          static_cast<uint32_t>(dv.y),
                          static_cast<uint32_t>(dv.z),
                          static_cast<uint32_t>(dv.w)};
  const uint32_t mw[4] = {static_cast<uint32_t>(mv.x),
                          static_cast<uint32_t>(mv.y),
                          static_cast<uint32_t>(mv.z),
                          static_cast<uint32_t>(mv.w)};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int sh = 8 * (i & 3);
    dst[i] = meta_decode(static_cast<int8_t>(dw[i >> 2] >> sh),
                         static_cast<int8_t>(mw[i >> 2] >> sh), i, scale);
  }
}

// The last block's combine of a (slot, head)'s n_splits partials into
// out [G][hd]: a warp per pair of query rows. M = max_i m_i; l = sum_i
// l_i e^(m_i - M) in f64, lane i % 32 summing its splits in order and a
// butterfly adding the lanes; acc = sum_i acc_i e^(m_i - M) in f64 in
// split order, lanes over the columns; out = acc / max(l, 1e-30) in f32.
// An empty split (m = -inf) weighs 0. The acc columns do not depend on the
// weights, so ZB splits' columns are loaded in one go, the first batch
// together with m and l: the combine takes one round trip to L2 per ZB
// splits and row pair. Each dependent round trip costs the last block
// about 2k clocks on an H100 (probes/decode_probe.py), more than the rest
// of its work.
__device__ __forceinline__ void combine(const float* __restrict__ parts,
                                        float* __restrict__ out, int G,
                                        int hd, int n_splits,
                                        size_t part_len) {
  constexpr int ZB = 8;  // splits whose columns load at once
  constexpr int CK = 2;  // columns a lane takes per pass
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float ninf = -CUDART_INF_F;
  for (int g = warp; g < G; g += 2 * WARPS) {
    const int gr[2] = {g, min(g + WARPS, G - 1)};
    const bool two = g + WARPS < G;
    for (int d0 = 0; d0 < hd; d0 += 32 * CK) {
      // columns of splits z0 .. z0 + ZB - 1 (zero past n_splits)
      auto load = [&](int z0, float (&x)[ZB][2][CK]) {
#pragma unroll
        for (int v = 0; v < ZB; ++v)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int k = 0; k < CK; ++k) {
              const int d = d0 + lane + 32 * k;
              x[v][r][k] = (z0 + v < n_splits && d < hd)
                               ? __ldcg(parts + (z0 + v) * part_len + 2 * G +
                                        gr[r] * hd + d)
                               : 0.f;
            }
      };
      float x[ZB][2][CK];
      load(0, x);
      float m0[2], l0[2], mx[2], wl[2];
      double ls[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool in = lane < n_splits;
        m0[r] = in ? __ldcg(parts + lane * part_len + gr[r]) : ninf;
        l0[r] = in ? __ldcg(parts + lane * part_len + G + gr[r]) : 0.f;
        mx[r] = m0[r];
      }
      for (int z = lane + 32; z < n_splits; z += 32)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          mx[r] = fmaxf(mx[r], __ldcg(parts + z * part_len + gr[r]));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = warp_max(mx[r]);  // -inf: no split holds a live key
        wl[r] = m0[r] == ninf ? 0.f : expf(m0[r] - mx[r]);
        ls[r] = wl[r] != 0.f ? static_cast<double>(wl[r]) *
                                   static_cast<double>(l0[r])
                             : 0.0;
      }
      for (int z = lane + 32; z < n_splits; z += 32)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mz = __ldcg(parts + z * part_len + gr[r]);
          if (mz != ninf)
            ls[r] = fma(static_cast<double>(expf(mz - mx[r])),
                        static_cast<double>(
                            __ldcg(parts + z * part_len + G + gr[r])),
                        ls[r]);
        }
      float lf[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lf[r] = fmaxf(static_cast<float>(warp_sum(ls[r])), 1e-30f);
      double a[2][CK];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int k = 0; k < CK; ++k) a[r][k] = 0.0;
      for (int z0 = 0; z0 < n_splits; z0 += ZB) {
        if (z0 > 0) {
          if ((z0 & 31) == 0) {  // lane u: the weight of split z0 + u
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float mz =
                  z0 + lane < n_splits
                      ? __ldcg(parts + (z0 + lane) * part_len + gr[r])
                      : ninf;
              wl[r] = mz == ninf ? 0.f : expf(mz - mx[r]);
            }
          }
          load(z0, x);
        }
#pragma unroll
        for (int v = 0; v < ZB; ++v)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float w =
                __shfl_sync(0xffffffffu, wl[r], (z0 + v) & 31);
            if (z0 + v < n_splits && w != 0.f)
#pragma unroll
              for (int k = 0; k < CK; ++k)
                a[r][k] = fma(static_cast<double>(w),
                              static_cast<double>(x[v][r][k]), a[r][k]);
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int k = 0; k < CK; ++k) {
          const int d = d0 + lane + 32 * k;
          if (d < hd && (r == 0 || two))
            out[gr[r] * hd + d] = static_cast<float>(a[r][k]) / lf[r];
        }
    }
  }
}

// The body: grid (slots, KV heads, splits), THREADS threads, smem_bytes
// of dynamic shared memory. `rows(key)` gives the element offset of the
// key's hd bytes for this block's head in every plane, or -1 when the key
// is masked. ws holds per (slot, head, split) m [G], l [G], acc [G][hd];
// counters one int per (slot, head), 0 between calls. vec: the planes
// start 16-byte aligned and hd % 16 == 0. sub: keys of one chunk, kps or
// a divisor of tile when the split is one tile (sub_keys).
template <class Rows>
__device__ __forceinline__ void split_decode(
    const Rows& rows, const float* __restrict__ q,
    const int8_t* __restrict__ kd, const int8_t* __restrict__ km, float ks,
    const int8_t* __restrict__ vd, const int8_t* __restrict__ vm, float vs,
    float* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int G, int hd, int tile, int kps, int sub,
    int n_splits, int vec, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = row_stride(hd);
  const bool v4 = (hd & 3) == 0;  // float4 reads of K rows
  const int unit = min(tile, sub);  // keys of one online update
  const int tps = sub / unit;       // units of a chunk
  const int n_chunks = kps / sub;
  long long* koff = reinterpret_cast<long long*>(smem_raw);  // [kps]
  double* q64 = reinterpret_cast<double*>(koff + kps + (kps & 1));
  double* sc = q64 + G * hd;             // [G][sub]: scores, then p
  float* kt = reinterpret_cast<float*>(sc + G * sub + ((G * sub) & 1));
  float* vt = kt + (size_t)sub * ldk;                        // [sub][ldk]
  float* corr = vt + (size_t)sub * ldk;                      // [tps][G]
  int* tile_live = reinterpret_cast<int*>(corr + tps * G);   // [tps]
  float* acc_s = reinterpret_cast<float*>(tile_live + tps);  // [G][hd]
  float* ml_s = acc_s + G * hd;                              // m [G], l [G]
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x * gridDim.y + blockIdx.y;
  const int split = blockIdx.z;
  const size_t part_len = (size_t)G * (hd + 2);
  float* part = ws + ((size_t)bh * n_splits + split) * part_len;
  const int k0 = split * kps;

  int any = 0;
  for (int j = tid; j < kps; j += THREADS) {
    const long long off = rows(k0 + j);
    koff[j] = off;
    any |= off >= 0;
  }
  if (__syncthreads_or(any)) {
    const size_t qbase = (size_t)bh * G * hd;
    for (int i = tid; i < G * hd; i += THREADS) q64[i] = q[qbase + i];
    const int ngr = (G + RG - 1) / RG;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const long long* co = koff + ch * sub;  // this chunk's row offsets
      const bool first = ch == 0, last = ch == n_chunks - 1;
      if (!first) __syncthreads();  // the previous chunk's tiles are read
      if (vec) {
        const int nv = hd >> 4;
        const int n = sub * nv;
        for (int base = tid; base < n; base += THREADS * UNROLL) {
          int4 a[UNROLL], am[UNROLL], b[UNROLL], bm[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int idx = base + u * THREADS;
            const long long off = idx < n ? co[idx / nv] : -1;
            if (off >= 0) {
              const long long e = off + 16 * (idx % nv);
              a[u] = __ldg(reinterpret_cast<const int4*>(kd + e));
              am[u] = __ldg(reinterpret_cast<const int4*>(km + e));
              b[u] = __ldg(reinterpret_cast<const int4*>(vd + e));
              bm[u] = __ldg(reinterpret_cast<const int4*>(vm + e));
            } else {
              a[u] = am[u] = b[u] = bm[u] = make_int4(0, 0, 0, 0);
            }
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int idx = base + u * THREADS;
            if (idx < n) {
              const int j = idx / nv, d0 = 16 * (idx % nv);
              decode16(a[u], am[u], ks, kt + j * ldk + d0);
              decode16(b[u], bm[u], vs, vt + j * ldk + d0);
            }
          }
        }
      } else {
        for (int idx = tid; idx < sub * hd; idx += THREADS) {
          const int j = idx / hd, d = idx - j * hd;
          const long long off = co[j];
          float kv = 0.f, vv = 0.f;
          if (off >= 0) {
            kv = meta_decode(kd[off + d], km[off + d], d, ks);
            vv = meta_decode(vd[off + d], vm[off + d], d, vs);
          }
          kt[j * ldk + d] = kv;
          vt[j * ldk + d] = vv;
        }
      }
      __syncthreads();

      // scores of every key of the chunk at once (they do not depend on
      // the softmax state): a thread takes one key and RG query rows
      for (int it = tid; it < sub * ngr; it += THREADS) {
        const int j = it % sub, g0 = (it / sub) * RG;
        const int nr = min(RG, G - g0);
        const float* kr = kt + j * ldk;
        const double* qr[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r) qr[r] = q64 + (g0 + min(r, nr - 1)) * hd;
        double a[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r) a[r] = 0.0;
        if (v4) {
          for (int d = 0; d < hd; d += 4) {
            const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
            const double k0_ = k4.x, k1 = k4.y, k2 = k4.z, k3 = k4.w;
#pragma unroll
            for (int r = 0; r < RG; ++r) {
              a[r] = fma(qr[r][d], k0_, a[r]);
              a[r] = fma(qr[r][d + 1], k1, a[r]);
              a[r] = fma(qr[r][d + 2], k2, a[r]);
              a[r] = fma(qr[r][d + 3], k3, a[r]);
            }
          }
        } else {
          for (int d = 0; d < hd; ++d) {
            const double kd_ = kr[d];
#pragma unroll
            for (int r = 0; r < RG; ++r) a[r] = fma(qr[r][d], kd_, a[r]);
          }
        }
        const bool ok = co[j] >= 0;
        for (int r = 0; r < nr; ++r)
          sc[(g0 + r) * sub + j] =
              ok ? static_cast<float>(a[r]) * sm_scale : -CUDART_INF_F;
      }
      __syncthreads();

      // the online-softmax updates of the chunk's units, in order, a warp
      // per query row; a unit without a live key is skipped (exact)
      for (int g = warp; g < G; g += WARPS) {
        double* srow = sc + g * sub;  // f32 scores, widened; then p
        float mrow = first ? -CUDART_INF_F : ml_s[g];
        float lrow = first ? 0.f : ml_s[G + g];
        for (int t = 0; t < tps; ++t) {
          const int j0 = t * unit;
          int lv = 0;
          for (int j = lane; j < unit; j += 32) lv |= co[j0 + j] >= 0;
          lv = __any_sync(0xffffffffu, lv);
          if (warp == 0 && lane == 0) tile_live[t] = lv;
          if (!lv) continue;
          float mx = -CUDART_INF_F;
          for (int j = lane; j < unit; j += 32)
            mx = fmaxf(mx, static_cast<float>(srow[j0 + j]));
          mx = warp_max(mx);
          const float m_new = fmaxf(mrow, mx);
          const float m_safe = (m_new == -CUDART_INF_F) ? 0.f : m_new;
          double sum = 0.0;
          for (int j = lane; j < unit; j += 32) {
            const float x = static_cast<float>(srow[j0 + j]);
            const float p = (x == -CUDART_INF_F) ? 0.f : expf(x - m_safe);
            srow[j0 + j] = p;
            sum += p;
          }
          sum = warp_sum(sum);
          const float cr = (mrow == -CUDART_INF_F) ? 0.f : expf(mrow - m_safe);
          lrow = lrow * cr + static_cast<float>(sum);
          mrow = m_new;
          if (lane == 0) corr[t * G + g] = cr;
        }
        if (lane == 0) {
          float* dst = last ? part : ml_s;
          dst[g] = mrow;
          dst[G + g] = lrow;
        }
      }
      __syncthreads();

      // P V of every live unit, a thread taking one column and RG rows;
      // acc = acc * corr + (p v of the unit), unit by unit in registers
      for (int it = tid; it < hd * ngr; it += THREADS) {
        const int d = it % hd, g0 = (it / hd) * RG;
        const int nr = min(RG, G - g0);
        int gr[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r) gr[r] = g0 + min(r, nr - 1);
        float av[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r)
          av[r] = first ? 0.f : acc_s[gr[r] * hd + d];
        for (int t = 0; t < tps; ++t) {
          if (!tile_live[t]) continue;
          const int j0 = t * unit;
          const float* v = vt + (size_t)j0 * ldk + d;
          double a[RG];
#pragma unroll
          for (int r = 0; r < RG; ++r) a[r] = 0.0;
#pragma unroll 4
          for (int j = 0; j < unit; ++j) {
            const double vj = v[j * ldk];
#pragma unroll
            for (int r = 0; r < RG; ++r)
              a[r] = fma(sc[gr[r] * sub + j0 + j], vj, a[r]);
          }
#pragma unroll
          for (int r = 0; r < RG; ++r)
            av[r] = av[r] * corr[t * G + gr[r]] + static_cast<float>(a[r]);
        }
        float* dst = last ? part + 2 * G : acc_s;
        for (int r = 0; r < nr; ++r) dst[(g0 + r) * hd + d] = av[r];
      }
    }
  } else {
    for (int g = tid; g < G; g += THREADS) part[g] = -CUDART_INF_F;
  }

  // the last block of this (slot, head) to arrive combines the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + bh, 1) == n_splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (tid == 0) counters[bh] = 0;
  combine(ws + (size_t)bh * n_splits * part_len, out + (size_t)bh * G * hd,
          G, hd, n_splits, part_len);
}

}  // namespace splitkey
