// K3: ragged chunked-prefill attention over the §5.1 packed page pool, for
// Hopper.
//
// Replaces: src/repro/kernels/sparq_prefill_attn.py::
//           sparq_chunked_prefill_attn_pallas (_kernel).
// Computes: a chunk of C stream tokens (several sequences, each run
//   contiguous and aligned to bq rows, padding seq_id = -1) attends, per
//   token, to (1) its sequence's packed pages for kpos < hist, gathered
//   through the block table and meta-decoded, then (2) the chunk's own
//   float K/V of the same sequence with hist <= kpos <= pos; an optional
//   sliding window keeps kpos > pos - window. Stage order: pages
//   ascending, then the chunk, as in the oracle. Online softmax with f32
//   statistics m, l (the oracle's m_safe and corr rules); each tile's q.k,
//   p.v and sum of p are taken in f64 and rounded once to f32;
//   out = acc / max(l, 1e-30); padding rows and padding tiles write zeros.
// Bound: at serving shapes (C = 256, G = 8, hd = 64, 256 tokens of
//   history) the score and value products are ~30 flops per byte moved,
//   so K3 is bound by operations: at the f64 tensor-core rate (67
//   TFLOP/s, H100 SXM data sheet, 700 W) the critical block's ~6.6 MFLOP
//   take ~13 us on its SM. f64 and not bf16/TF32 operands, because the
//   oracle rounds only f32 results and the port holds K3 within 1e-4 of
//   it: f32 products are exact in f64, so only the order of the sums
//   differs.
// Design, against what held the first version back:
//   - Tensor cores: both products run on mma.sync.m16n8k8 f64 (DMMA). The
//     m8n8k4 shape runs at half its rate (probes/k3_probe.py on an H100
//     80GB HBM3 at 700 W: 31.6-32.9 against 65.0-66.5 TFLOP/s).
//     Q, K, V and P sit in shared memory widened to f64, in rows of 68
//     doubles, so that every fragment load is free of bank conflicts.
//   - Statistics per warp: 8 warps, two per row group of 16 query rows
//     (bq * G <= 64). In each key tile, warp half h of a group takes keys
//     32 h .. 32 h + 31 for S = Q K^T; the pair meets at a named barrier to
//     take the row max over both halves, each writes its p (f32, exp of the
//     f32-rounded, f32-scaled score) into the group's P tile and its row
//     sums of p (f64) beside it, and after a second pair barrier each
//     takes output columns 32 h .. 32 h + 31 of P V over all 64 keys. m, l
//     and each warp's half of acc (f32) live in registers in the
//     accumulator layout (rows lane / 4 and lane / 4 + 8, columns
//     2 (lane & 3) + {0, 1}), flash-attention-2 style. Two warps per SM
//     sub-partition hide each other's latencies (with one, every phase
//     waited on its own loads); the two warps of a pair sit on different
//     sub-partitions.
//   - Key tiles of KT = 64 keys (4 pages at ps = 16), two __syncthreads
//     each: the raw bytes (int8 data + meta planes, 64 bytes per row and
//     KV head; or the chunk's f32 K/V rows) arrive in a 2-stage ring by
//     16-byte cp.async, the next tile's copies issued before this tile is
//     widened and computed. One pass per tile decodes (meta_decode, the
//     oracle's f32 product) or widens every element once into the f64
//     tiles. The prologue puts all its reads (Q, the block-table row, the
//     chunk's seq_id and pos) in flight at once.
//   - Exact skipping: a key tile in which no (row, key) pair is unmasked
//     leaves (m, l, acc) bit for bit unchanged, so the block visits only
//     the tiles kernels/sparq_prefill_attn.py::walk lists: page tiles
//     holding a live page (block-table entry >= 0, keys inside
//     [max(0, min_pos - window + 1), max_hist)) and chunk tiles holding a
//     key of the tile's sequence with max(min_hist, that lower bound) <=
//     kpos <= max_pos. Within a visited tile the pages that are not live
//     are zero-filled instead of loaded. walk is the rule; this kernel
//     implements it.
//   - Launch: cudaFuncSetAttribute runs once per device and larger
//     shared-memory size, not on every launch.
#include "sparq_common.cuh"

namespace {

constexpr int HD = 64;             // head dim (the wrapper raises otherwise)
constexpr int KT = 64;             // keys per tile (walk's key_tile)
constexpr int GROUPS = 4;          // row groups of 16 query rows
constexpr int WARPS = 2 * GROUPS;  // two warps per row group
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = GROUPS * 16;  // most bq * G a block holds
constexpr int LD = HD + 4;         // f64 row stride of Q, K, V and P tiles:
                                   // fragment loads of rows lane / 4 or
                                   // lane & 3 at 4 or 8 lanes conflict-free
// ring stage rows, padded by 16 bytes so that the widen pass reads 8 rows
// at a time without bank conflicts: a page tile's 4 int8 planes of KT rows,
// or a chunk tile's f32 K and V rows
constexpr int PRS = HD + 16;            // bytes per page-plane row
constexpr int CRS = (HD + 4) * 4;       // bytes per chunk row
constexpr int RING = 2 * KT * CRS;      // one stage (the larger of the two)
constexpr int BIG = 0x7fffffff;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the two warps of row group rg meet at barrier 1 + rg
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg) : "memory");
}

// d += A B on one 16x8x8 f64 tile (g = lane / 4, t = lane & 3):
// a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}, b = {B[t][g],
// B[t+4][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double a2, double a3, double b0,
                                     double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

__device__ __forceinline__ void store_d2(double* dst, double a, double b) {
  *reinterpret_cast<double2*>(dst) = make_double2(a, b);
}

__global__ void __launch_bounds__(THREADS, 1)
chunked_prefill_kernel(const float* __restrict__ q,
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
                       float* __restrict__ out, int C, int KV, int G, int ps,
                       int NB, int bq, int window, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                 // [2][RING]
  double* qw = reinterpret_cast<double*>(smem + 2 * RING);    // [ROWS][LD]
  double* kw = qw + ROWS * LD;                                // [KT][LD]
  double* vw = kw + KT * LD;                                  // [KT][LD]
  double* pw = vw + KT * LD;                                  // [ROWS][LD]
  double* ssum = pw + ROWS * LD;                              // [WARPS][16]
  float* smax = reinterpret_cast<float*>(ssum + WARPS * 16);  // [WARPS][16]
  int* kseq = reinterpret_cast<int*>(smax + WARPS * 16);      // [C]
  int* kpos = kseq + C;                                       // [C]
  int* pg = kpos + C;          // [NB] live page id, else -1
  const int pss = __ffs(ps) - 1;  // ps is a power of two dividing KT
  const int ppt = KT >> pss;      // pages per page tile
  const int npt = (NB + ppt - 1) / ppt, nct = (C + KT - 1) / KT;
  int* flag = pg + NB;            // [npt + nct] tile visited?
  int* visit = flag + npt + nct;  // [npt + nct] u < npt: page tile u,
                                  // else chunk tile u - npt
  __shared__ int s_ok[ROWS], s_pos[ROWS], s_hist[ROWS];
  __shared__ int s_nvisit;

  const int qt = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // row group and key / column half; the pair's warps are neighbours, so
  // they run on different SM sub-partitions
  const int rg = warp / 2, half = warp % 2;
  const int R = bq * G;
  const int i0 = qt * bq;  // first stream token of the tile
  const int ts = tile_seq[qt];
  if (ts < 0) {
    for (int idx = tid; idx < R * HD; idx += THREADS) {
      const int r = idx / HD, d = idx - r * HD;
      out[(((size_t)(i0 + r / G) * KV + h) * G + r % G) * HD + d] = 0.f;
    }
    return;
  }

  // ---- prologue: every global read in flight at once, then the walk
  // (kernels/sparq_prefill_attn.py::walk)
  for (int t = tid; t < bq; t += THREADS) {
    s_ok[t] = seq_id[i0 + t] >= 0;
    s_pos[t] = pos[i0 + t];
    s_hist[t] = hist[i0 + t];
  }
  for (int u = tid; u < npt + nct; u += THREADS) flag[u] = 0;
  for (int t = tid; t < NB; t += THREADS)
    pg[t] = block_table[(size_t)ts * NB + t];
  for (int j = tid; j < C; j += THREADS) {
    kseq[j] = seq_id[j];
    kpos[j] = pos[j];
  }
  {
    constexpr int N = ROWS * (HD / 4) / THREADS;  // float4 of Q per thread
    float4 x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = tid + i * THREADS, r = idx / (HD / 4), c = idx % (HD / 4);
      x[i] = r < R ? *reinterpret_cast<const float4*>(
                         q + (((size_t)(i0 + r / G) * KV + h) * G + r % G) *
                                 HD + 4 * c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = tid + i * THREADS, r = idx / (HD / 4), c = idx % (HD / 4);
      store_d2(qw + r * LD + 4 * c, x[i].x, x[i].y);
      store_d2(qw + r * LD + 4 * c + 2, x[i].z, x[i].w);
    }
  }
  __syncthreads();
  int mn_pos = BIG, mx_pos = -BIG, mn_hist = BIG, mx_hist = 0;
  for (int t = 0; t < bq; ++t) {
    if (!s_ok[t]) continue;
    mn_pos = min(mn_pos, s_pos[t]);
    mx_pos = max(mx_pos, s_pos[t]);
    mn_hist = min(mn_hist, s_hist[t]);
    mx_hist = max(mx_hist, s_hist[t]);
  }
  // no valid row: mx_hist = 0 and mx_pos = -BIG, so nothing is visited
  const int lo = window ? max(0, mn_pos - window + 1) : 0;
  const int lo_c = max(mn_hist, lo);
  for (int t = tid; t < NB; t += THREADS) {
    const bool live = pg[t] >= 0 && (t << pss) < mx_hist &&
                      ((t + 1) << pss) > lo;
    if (!live) pg[t] = -1;
    if (live) flag[t / ppt] = 1;
  }
  for (int j = tid; j < C; j += THREADS)
    if (kseq[j] == ts && kpos[j] >= lo_c && kpos[j] <= mx_pos)
      flag[npt + j / KT] = 1;
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int u = 0; u < npt + nct; ++u)
      if (flag[u]) visit[n++] = u;
    s_nvisit = n;
  }
  __syncthreads();
  const int nvisit = s_nvisit;
  const float ks = kscale[ts], vs = vscale[ts];

  // this thread's rows g and g + 8 of its group's 16 (index mt = 0, 1)
  bool rok[2];
  int rpos[2], rhist[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = rg * 16 + mt * 8 + g;
    const int t = r < R ? r / G : 0;
    rok[mt] = r < R && s_ok[t];
    rpos[mt] = s_pos[t];
    rhist[mt] = s_hist[t];
  }
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  // acc: this warp's half of the output columns, in the P V accumulator
  // layout, rounded to f32
  float acc[HD / 16][4];
#pragma unroll
  for (int dt = 0; dt < HD / 16; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;

  // copies of visited tile v into ring stage v & 1 (one commit group)
  auto issue = [&](int v) {
    unsigned char* st = ring + (v & 1) * RING;
    const int u = visit[v];
    if (u < npt) {  // page tile: planes kd, km, vd, vm, each [KT][HD] bytes
#pragma unroll
      for (int i = 0; i < 4 * KT * (HD / 16) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int c = idx % (HD / 16), j = (idx / (HD / 16)) % KT;
        const int plane = idx / (KT * (HD / 16));
        const int tp = u * ppt + (j >> pss);
        const int page = tp < NB ? pg[tp] : -1;
        if (page < 0) continue;  // not live: zero-filled when widened
        const int8_t* base =
            plane == 0 ? kd : plane == 1 ? km : plane == 2 ? vd : vm;
        cp_async16(st + (plane * KT + j) * PRS + 16 * c,
                   base + ((((size_t)page << pss) + (j & (ps - 1))) * KV +
                           h) * HD + 16 * c,
                   true);
      }
    } else {  // chunk tile: K then V, each [KT][HD] f32
      const int j0 = (u - npt) * KT;
#pragma unroll
      for (int i = 0; i < 2 * KT * (HD / 4) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int c = idx % (HD / 4), j = (idx / (HD / 4)) % KT;
        const int which = idx / (KT * (HD / 4));
        const bool in = j0 + j < C;
        cp_async16(st + (which * KT + j) * CRS + 16 * c,
                   (which ? vc : kc) +
                       ((size_t)(in ? j0 + j : 0) * KV + h) * HD + 4 * c,
                   in);
      }
    }
    cp_async_commit();
  };

  // decode (pages) or widen (chunk) ring stage v & 1 into kw / vw, 16
  // lanes of one row per step. Rows run fastest across the lanes, and a
  // lane whose row has bit 2 set stores its 16-byte pieces in the order
  // k ^ 1: eight lanes then hit eight distinct bank quads.
  auto widen = [&](int v) {
    const unsigned char* st = ring + (v & 1) * RING;
    const int u = visit[v];
#pragma unroll
    for (int i = 0; i < 2 * KT * (HD / 16) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int j = idx % KT, c = (idx / KT) % (HD / 16);
      const int which = idx / (KT * (HD / 16));  // 0: K, 1: V
      double o[16];
      if (u < npt) {
        const int tp = u * ppt + (j >> pss);
        uint4 dv = make_uint4(0u, 0u, 0u, 0u), mv = dv;
        if (tp < NB && pg[tp] >= 0) {  // else zeros, which decode to 0
          dv = *reinterpret_cast<const uint4*>(
              st + (2 * which * KT + j) * PRS + 16 * c);
          mv = *reinterpret_cast<const uint4*>(
              st + ((2 * which + 1) * KT + j) * PRS + 16 * c);
        }
        const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
        const uint32_t mw[4] = {mv.x, mv.y, mv.z, mv.w};
        const float sc = which ? vs : ks;
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            o[4 * w + b] = meta_decode(static_cast<int8_t>(dw[w] >> (8 * b)),
                                       static_cast<int8_t>(mw[w] >> (8 * b)),
                                       b, sc);
      } else {
        const float4* src = reinterpret_cast<const float4*>(
            st + (which * KT + j) * CRS + 64 * c);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 x = src[k];
          o[4 * k] = x.x;
          o[4 * k + 1] = x.y;
          o[4 * k + 2] = x.z;
          o[4 * k + 3] = x.w;
        }
      }
      double* dst = (which ? vw : kw) + j * LD + 16 * c;
      const bool sw = (j >> 2) & 1;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int k1 = k ^ 1;
        store_d2(dst + 2 * (sw ? k1 : k), sw ? o[2 * k1] : o[2 * k],
                 sw ? o[2 * k1 + 1] : o[2 * k + 1]);
      }
    }
  };

  const double* qa = qw + (rg * 16 + g) * LD + t4;
  double* prow = pw + (rg * 16 + g) * LD;
  if (nvisit > 0) issue(0);
  for (int v = 0; v < nvisit; ++v) {
    if (v + 1 < nvisit) {
      issue(v + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile v landed; every warp is done with tile v - 1
    widen(v);
    __syncthreads();
    const int u = visit[v];
    const bool page_tile = u < npt;
    const int k0 = (page_tile ? u * KT : (u - npt) * KT) + half * (KT / 2);

    // S = Q K^T over this warp's half of the keys: s[nt] holds rows g,
    // g + 8 x keys k0 + 8 nt + 2 t4 + {0, 1}
    double s[KT / 16][4];
#pragma unroll
    for (int nt = 0; nt < KT / 16; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.0;
    const double* kb = kw + (half * (KT / 2) + g) * LD + t4;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const double a0 = qa[8 * kk], a1 = qa[8 * LD + 8 * kk];
      const double a2 = qa[8 * kk + 4], a3 = qa[8 * LD + 8 * kk + 4];
#pragma unroll
      for (int nt = 0; nt < KT / 16; ++nt)
        dmma(s[nt], a0, a1, a2, a3, kb[nt * 8 * LD + 8 * kk],
             kb[nt * 8 * LD + 8 * kk + 4]);
    }

    // scores in f32 (rounded, then scaled, as the oracle's einsum * scale)
    // and masked; the row max over both halves meets in smax
    float p[KT / 16][4];
#pragma unroll
    for (int nt = 0; nt < KT / 16; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + nt * 8 + 2 * t4 + e;
        bool kok;
        int x;
        if (page_tile) {  // j is the key's position
          const int tp = j >> pss;
          kok = tp < NB && pg[tp] >= 0;
          x = j;
        } else {  // j is the key's stream index
          kok = j < C && kseq[j] == ts;
          x = j < C ? kpos[j] : 0;
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          bool ok = rok[mt] && kok && (window == 0 || x > rpos[mt] - window);
          ok = ok && (page_tile ? x < rhist[mt]
                                : (x <= rpos[mt] && x >= rhist[mt]));
          p[nt][2 * mt + e] =
              ok ? static_cast<float>(s[nt][2 * mt + e]) * sm_scale
                 : -CUDART_INF_F;
        }
      }
    float corr[2], m_safe[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < KT / 16; ++nt)
        mx = fmaxf(mx, fmaxf(p[nt][2 * mt], p[nt][2 * mt + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (t4 == 0) smax[warp * 16 + mt * 8 + g] = mx;
      m_safe[mt] = mx;
    }
    pair_sync(rg);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float mx = fmaxf(
          m_safe[mt], smax[(warp ^ 1) * 16 + mt * 8 + g]);
      const float m_new = fmaxf(m[mt], mx);
      m_safe[mt] = (m_new == -CUDART_INF_F) ? 0.f : m_new;
      corr[mt] = (m[mt] == -CUDART_INF_F) ? 0.f : expf(m[mt] - m_safe[mt]);
      m[mt] = m_new;
    }
    // p = exp(s - m_safe) in f32, into the group's P tile (f64, key order);
    // each warp's row sums of p over its keys, in f64, meet in ssum
    double rs[2] = {0.0, 0.0};
#pragma unroll
    for (int nt = 0; nt < KT / 16; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        double pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = p[nt][2 * mt + e];
          pv[e] = (sv == -CUDART_INF_F) ? 0.f : expf(sv - m_safe[mt]);
        }
        rs[mt] += pv[0] + pv[1];
        store_d2(prow + mt * 8 * LD + half * (KT / 2) + nt * 8 + 2 * t4,
                 pv[0], pv[1]);
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      rs[mt] += __shfl_xor_sync(0xffffffffu, rs[mt], 1);
      rs[mt] += __shfl_xor_sync(0xffffffffu, rs[mt], 2);
      if (t4 == 0) ssum[warp * 16 + mt * 8 + g] = rs[mt];
    }
    pair_sync(rg);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      l[mt] = l[mt] * corr[mt] + static_cast<float>(
                  rs[mt] + ssum[(warp ^ 1) * 16 + mt * 8 + g]);

    // P V over all keys for this warp's half of the columns
    double o[HD / 16][4];
#pragma unroll
    for (int dt = 0; dt < HD / 16; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[dt][i] = 0.0;
    const double* pa = pw + (rg * 16 + g) * LD + t4;
    const double* vb = vw + t4 * LD + half * (HD / 2) + g;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
      const double a0 = pa[8 * nt], a1 = pa[8 * LD + 8 * nt];
      const double a2 = pa[8 * nt + 4], a3 = pa[8 * LD + 8 * nt + 4];
      const double* vr = vb + nt * 8 * LD;
#pragma unroll
      for (int dt = 0; dt < HD / 16; ++dt)
        dmma(o[dt], a0, a1, a2, a3, vr[dt * 8], vr[4 * LD + dt * 8]);
    }
#pragma unroll
    for (int dt = 0; dt < HD / 16; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[dt][i] = acc[dt][i] * corr[i >> 1] + static_cast<float>(o[dt][i]);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = rg * 16 + mt * 8 + g;
    if (r >= R) continue;
    const float lm = fmaxf(l[mt], 1e-30f);
    float* orow = out + (((size_t)(i0 + r / G) * KV + h) * G + r % G) * HD +
                  half * (HD / 2) + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < HD / 16; ++dt)
      *reinterpret_cast<float2*>(orow + dt * 8) = make_float2(
          acc[dt][2 * mt] / lm, acc[dt][2 * mt + 1] / lm);
  }
}

}  // namespace

// q (C, KV, G, hd) f32; k/v_chunk (C, KV, hd) f32; pools (P, ps, KV, hd)
// int8; scales (S,) f32; block_table (S, NB) int32; seq_id/pos/hist (C,)
// int32; tile_seq (C / bq,) int32; out (C, KV, G, hd) f32. Takes hd = 64,
// bq * G <= 64 and ps dividing 64 (the wrapper checks); every pointer
// 16-byte aligned.
extern "C" int sparq_chunked_prefill_attn_launch(
    const void* q, const void* kc, const void* vc, const void* kd,
    const void* km, const void* kscale, const void* vd, const void* vm,
    const void* vscale, const void* block_table, const void* seq_id,
    const void* pos, const void* hist, const void* tile_seq, void* out,
    int C, int KV, int G, int hd, int ps, int NB, int bq, int window,
    float sm_scale, void* stream) {
  if (hd != HD || bq * G > ROWS || ps <= 0 || KT % ps || C % bq)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ppt = KT / ps;
  const int nvis = (NB + ppt - 1) / ppt + (C + KT - 1) / KT;
  const size_t smem = 2 * RING + sizeof(double) * (2 * ROWS + 2 * KT) * LD +
                      (sizeof(double) + sizeof(float)) * WARPS * 16 +
                      sizeof(int) * (2 * C + NB + 2 * nvis);
  static size_t attr_smem[64] = {};
  const cudaError_t e =
      set_smem_once(chunked_prefill_kernel, smem, attr_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(C / bq, KV);
  chunked_prefill_kernel<<<grid, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<const int8_t*>(kd),
      static_cast<const int8_t*>(km), static_cast<const float*>(kscale),
      static_cast<const int8_t*>(vd), static_cast<const int8_t*>(vm),
      static_cast<const float*>(vscale), static_cast<const int*>(block_table),
      static_cast<const int*>(seq_id), static_cast<const int*>(pos),
      static_cast<const int*>(hist), static_cast<const int*>(tile_seq),
      static_cast<float*>(out), C, KV, G, ps, NB, bq, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
