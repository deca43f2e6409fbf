// K7: absorbed-MLA flash-decode over the two §5.1 packed latent planes, for
// Hopper: f16 tensor cores over the exact codes, a run of key tiles a
// block, and the splits of a batch row combined in a thread-block cluster.
//
// Replaces: src/repro/models/mla.py::_sparq_mla_decode. Not a Pallas kernel
//   in the reference: a lax.scan over tiles of 128 keys, each tile calling
//   sparq_dequantize (K6) on both planes and then about fifteen XLA ops.
//   This kernel is one launch a layer and a decode step, and meta-decodes
//   the packed bytes inside its loop, so the MLA decode launches no K6.
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
//   does 2 x 16 heads x (576 + 512) flops a key: ~30 flops a byte, far
//   below the f16 tensor cores' ridge (~295). On an H100 SXM (3.35 TB/s)
//   the scan decode's 8 x 287 live keys (2.6 MB) take 0.79 us, an 8K cache
//   at 8 rows (75.5 MB) 22.5 us.
// Design (probes/k7_probe.py splits a block's clocks by phase):
//   - Exact codes on f16 tensor cores. A decoded value before its scale is
//     q << s with |q| <= 128 and s <= 7: at most 8 significant bits and
//     |q << s| <= 2^14, exact in f16 (and in bf16). Each key tile is
//     meta-decoded once into an f16 tile [TK][r + dr] of unscaled codes
//     (rows padded against bank conflicts, two lanes an f16x2 op); the
//     value rows are its first r columns. The scales stay outside the
//     products: q times its plane's scale and sm_scale in f32, each head
//     row times a power of two that puts its largest entry in [2^14,
//     2^15), is split into QT = 2 f16 terms (about 22 bits), and p 2^15
//     into PT = 2, so the sums, f32 on mma.sync m16n8k16, keep about
//     f32's precision; the row's power of two is undone on the scores,
//     c's scale and 2^-15 on the output. (Three bf16 terms of q, 8 bits
//     each, did the same with one MMA more a k-step and a costlier
//     decode.) H = 16 heads are one m16 row tile (wgmma's 64 rows would be
//     three quarters empty); a larger H takes ceil(H / 16) head groups
//     (grid y).
//   - Scores S = Q K^T: warp w takes the k-steps (16 columns of [c | pe])
//     [w nks / 8, (w + 1) nks / 8) for all TK keys, its Q fragments held in
//     registers for the whole call (KSW k-steps x QT terms); the eight
//     partial score tiles are summed through shared memory. The online
//     softmax runs in f32, 16 threads a head row, across the split's
//     tiles. P V: warp w owns NP pairs of 8-column output tiles, an f32
//     accumulator [16][16 NP] in registers (32 floats a thread at r 512),
//     V fragments by ldmatrix.trans from the same f16 tile.
//   - Loads: the tile's int8 data and meta bytes of both planes (four
//     contiguous runs) come in by 16-byte cp.async into a ring of STAGES
//     raw stages, so two tiles load while one is computed. Only the live
//     keys' rows are read; the rest of a stage is zero-filled. Planes that
//     are not 16-byte aligned (or widths not multiples of 16) are read
//     byte by byte into the same stages.
//   - Splits: the n_splits blocks of a (batch row, head group) form one
//     cluster (grid x), n_splits <= 16, the largest cluster of which the
//     card holds all the call's at once and never more than the cache's
//     tiles (kernels/sparq_mla_decode.py::plan), so the number of splits
//     and the combine do not grow with the cache. Live keys are a prefix
//     (t < min(pos, Tk)): each block reads pos first and takes run z of
//     the live tiles cut into n_splits runs of ceil(live tiles /
//     n_splits), so a cache sized at max_len early in decode spreads its
//     few live tiles over the cluster; a block whose run starts past them
//     is empty (weight 0 in the combine).
//   - Combine: block z owns 1 / n_splits of the group's [H][r] outputs.
//     Each block arrives at the cluster's barrier once its prologue is
//     done and waits on it after its tiles, so every block of the cluster
//     has started before any stores into another's shared memory. Then it
//     pushes its m, l [16] to every block and each element of its f32
//     accumulator to the block that owns it, by stores into distributed
//     shared memory (no round trip to wait on) into the owner's combine
//     buffer; after one cluster.sync() block z combines its share from
//     its own shared memory: w_z = e^(m_z - M),
//     out = sum_z w_z acc_z / max(sum_z w_z l_z, 1e-30) * c_scale 2^-15.
//     No workspace, no counter, no ticket: a cluster moves a fixed 16 r
//     n_splits floats whatever Tk is.
//   Shared memory: STAGES raw stages of TK (r + dr) data and meta bytes,
//   the f16 tile, the partial scores [8][16][TK + 4] f32, the P tile
//   [PT][16][TK + 8] f16, the row statistics and the combine buffer:
//   204,160 bytes at r 512, dr 64 (kernels/sparq_mla_decode.py::
//   smem_bytes), one block an SM.
#include <cooperative_groups.h>
#include <cuda_fp16.h>

#include "sparq_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TK = 32;          // keys a tile (sparq_mla_decode.py::TILE)
constexpr int STAGES = 3;       // raw tiles in the cp.async ring
constexpr int HR = 16;          // head rows of a block: one m16 tile
constexpr int QT = 2;           // f16 terms of q (under its row's scale)
constexpr int PT = 2;           // f16 terms of p 2^15
constexpr int RED_LD = TK + 4;  // row stride (floats) of the partial scores
constexpr int P_LD = TK + 8;    // row stride (f16) of the P tile
constexpr int MAX_SPLITS = 16;  // the largest (non-portable) cluster

__host__ __device__ inline int ksteps(int r, int dr) {
  return (r + dr + 15) / 16;
}
// row stride (f16) of the decoded tile: 16-byte rows whose 8-row ldmatrix
// reads hit 32 distinct banks
__host__ __device__ inline int tile_ld(int r, int dr) {
  return 16 * ksteps(r, dr) + 8;
}
__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// byte sizes of one block's dynamic shared memory (sparq_mla_decode.py::
// smem_bytes): the ring of raw stages, the f16 tile, the partial scores,
// the P tile, the row statistics m, l, corr, and the combine's buffer
// (this block's share of the cluster's accumulators [n_splits][share]
// float2, share <= ceil(8 r / n_splits), then m, l [n_splits][2][16]),
// which the other blocks of the cluster write while this one still runs
// its tiles. The combine's weights reuse the partial scores.
struct Layout {
  size_t stage, tile, red, ptile, stats, comb, total;
  __host__ __device__ Layout(int r, int dr) {
    stage = align16(static_cast<size_t>(TK) * (r + dr) * 2);
    tile = align16(static_cast<size_t>(TK) * tile_ld(r, dr) * 2);
    red = sizeof(float) * WARPS * HR * RED_LD;
    ptile = 2 * PT * HR * P_LD;
    stats = sizeof(float) * 4 * HR;
    comb = align16(8 * (static_cast<size_t>(HR) * r / 2 + MAX_SPLITS) +
                   sizeof(float) * 2 * HR * MAX_SPLITS);
    total = STAGES * stage + tile + red + ptile + stats + comb;
  }
};

// ------------------------------------------------------------ PTX helpers

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

__device__ __forceinline__ void ldmatrix_x4(const void* p, uint32_t (&a)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(const void* p,
                                                  uint32_t (&a)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a b on the f16 tensor cores, f32 sums
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x split into N f16 terms, each the round-to-nearest of what the earlier
// ones leave: x - t[0] - ... - t[N - 1] is exact in f32 at every step
template <int N>
__device__ __forceinline__ void split_f16(float x, float (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    t[i] = __half2float(__float2half_rn(x));
    x = __fsub_rn(x, t[i]);
  }
}

// the §5.1 code of one stored lane before its scale: q << shift (q * 2^s),
// shift (meta >> 3) & 7 on even lanes, meta & 7 on odd ones
__device__ __forceinline__ float lane_code(int q, int m, int odd) {
  const int s = odd ? (m & 7) : ((m >> 3) & 7);
  return static_cast<float>(q * (1 << s));
}

// the cluster's hardware barrier, split in its two halves: a relaxed
// arrive (no memory order) and the wait for every block's arrival
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ------------------------------------------------------------ the kernel

struct Args {
  const float* q_lat;
  const float* q_pe;
  const int8_t* cd;
  const int8_t* cm;
  const float* cscale;
  const int8_t* pd;
  const int8_t* pm;
  const float* pscale;
  const int* pos;
  float* out;
  int H, rank, dr, Tk, vec;
  float sm_scale;
};

// the packed bytes of keys [k0, k0 + TK) of batch row b into a raw stage:
// four contiguous runs, c data [TK][r], c meta [TK][r], pe data [TK][dr],
// pe meta [TK][dr], whose first nk rows are the live keys'; the rest are
// zero-filled, not read
__device__ __forceinline__ void load_tile(const Args& a, unsigned char* st,
                                          long long key0, int nk) {
  const int r = a.rank, dr = a.dr, rb = TK * r, pb = TK * dr;
  const int8_t* src[4] = {a.cd + key0 * r, a.cm + key0 * r,
                          a.pd + key0 * dr, a.pm + key0 * dr};
  unsigned char* dst[4] = {st, st + rb, st + 2 * rb, st + 2 * rb + pb};
  const int len[4] = {rb, rb, pb, pb};
  const int live[4] = {nk * r, nk * r, nk * dr, nk * dr};
  if (a.vec) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      for (int o = 16 * threadIdx.x; o < len[p]; o += 16 * THREADS)
        cp_async16(dst[p] + o, o < live[p] ? src[p] + o : a.cd,
                   o < live[p]);
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      for (int o = threadIdx.x; o < len[p]; o += THREADS)
        dst[p][o] = o < live[p] ? static_cast<unsigned char>(src[p][o]) : 0;
  }
}

// 4 lanes (a data word and its meta word, the first lane even) as two
// f16x2 codes before their scale: q + 128 dropped into the low byte of
// f16 1024 (0x64uu) is 1024 + q + 128 exactly, less 1152 is q, and times
// 2^shift (exponent 15 + shift; even lanes (meta >> 3) & 7, odd lanes meta
// & 7) is q << shift, exact in f16 (at most 8 significant bits, |q <<
// shift| <= 2^14)
__device__ __forceinline__ void decode4(uint32_t dw, uint32_t mw,
                                        uint32_t& lo, uint32_t& hi) {
  const uint32_t dx = dw ^ 0x80808080u;  // q + 128 in every byte
  const __half2 off = __float2half2_rn(1152.f);
  const uint32_t q01 = __byte_perm(dx, 0x64646464u, 0x5140);
  const uint32_t q23 = __byte_perm(dx, 0x64646464u, 0x5342);
  const uint32_t p01 =
      0x3C003C00u + ((mw << 7) & 0x1C00u) + ((mw << 18) & 0x1C000000u);
  const uint32_t p23 =
      0x3C003C00u + ((mw >> 9) & 0x1C00u) + ((mw << 2) & 0x1C000000u);
  const __half2 c01 = __hmul2(
      __hsub2(*reinterpret_cast<const __half2*>(&q01), off),
      *reinterpret_cast<const __half2*>(&p01));
  const __half2 c23 = __hmul2(
      __hsub2(*reinterpret_cast<const __half2*>(&q23), off),
      *reinterpret_cast<const __half2*>(&p23));
  lo = *reinterpret_cast<const uint32_t*>(&c01);
  hi = *reinterpret_cast<const uint32_t*>(&c23);
}

// n / d for 0 <= n < 2^16 and 0 < d < 2^16, with m = ceil(2^32 / d): the
// high word of n m is exact there, and costs one multiply
__device__ __forceinline__ int div_by(int n, uint32_t m) {
  return static_cast<int>(__umulhi(static_cast<uint32_t>(n), m));
}
__device__ __forceinline__ uint32_t div_magic(int d) {
  return static_cast<uint32_t>((0x100000000ull + d - 1) / d);
}

// meta-decode a raw stage into the f16 tile [TK][ld]: columns [0, r) the
// latent plane's codes, [r, r + dr) the rope plane's; units of 8 lanes
// when r and dr are multiples of 8 (DU units a thread with their loads in
// flight together), else lane pairs
__device__ __forceinline__ void decode_tile(const unsigned char* st,
                                            __half* tile, int r,
                                            int dr, int ld) {
  if (((r | dr) & 7) == 0) {
    constexpr int DU = 3;
    const int nc = r >> 3, per = nc + (dr >> 3), n = TK * per;
    const uint32_t mper = div_magic(per);
    for (int i0 = threadIdx.x; i0 < n; i0 += DU * THREADS) {
      uint2 dv[DU], mv[DU];
      int col[DU];
#pragma unroll
      for (int k = 0; k < DU; ++k) {
        const int i = i0 + k * THREADS;
        const int j = div_by(i, mper), u = i - j * per;
        const unsigned char* d;
        int mo;
        if (u < nc) {
          d = st + j * r + 8 * u;
          mo = TK * r;
          col[k] = j * ld + 8 * u;
        } else {
          d = st + 2 * TK * r + j * dr + 8 * (u - nc);
          mo = TK * dr;
          col[k] = j * ld + r + 8 * (u - nc);
        }
        if (i < n) {
          dv[k] = *reinterpret_cast<const uint2*>(d);
          mv[k] = *reinterpret_cast<const uint2*>(d + mo);
        }
      }
#pragma unroll
      for (int k = 0; k < DU; ++k)
        if (i0 + k * THREADS < n) {
          uint4 o;
          decode4(dv[k].x, mv[k].x, o.x, o.y);
          decode4(dv[k].y, mv[k].y, o.z, o.w);
          *reinterpret_cast<uint4*>(tile + col[k]) = o;
        }
    }
  } else {
    const int nc = r >> 1, per = nc + (dr >> 1);
    const uint32_t mper = div_magic(per);
    for (int i = threadIdx.x; i < TK * per; i += THREADS) {
      const int j = div_by(i, mper), u = i - j * per;
      const unsigned char* d;
      const unsigned char* m;
      int col;
      if (u < nc) {
        d = st + j * r + 2 * u;
        m = d + TK * r;
        col = 2 * u;
      } else {
        d = st + 2 * TK * r + j * dr + 2 * (u - nc);
        m = d + TK * dr;
        col = r + 2 * (u - nc);
      }
      *reinterpret_cast<uint32_t*>(tile + j * ld + col) = pack_f16(
          lane_code(static_cast<int8_t>(d[0]), static_cast<int8_t>(m[0]), 0),
          lane_code(static_cast<int8_t>(d[1]), static_cast<int8_t>(m[1]), 1));
    }
  }
}

// KSW: k-steps of the scores a warp holds Q fragments for (>= ceil(ksteps
// / 8)); NP: pairs of 8-column output tiles a warp owns (>= ceil(ceil(r /
// 16) / 8))
template <int KSW, int NP>
__global__ void __launch_bounds__(THREADS, 1)
    mla_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = a.rank, dr = a.dr, ld = tile_ld(r, dr);
  const Layout L(r, dr);
  unsigned char* stages = smem;
  unsigned char* at = smem + STAGES * L.stage;
  __half* tile = reinterpret_cast<__half*>(at);
  float* red = reinterpret_cast<float*>(at += L.tile);
  __half* ptile = reinterpret_cast<__half*>(at += L.red);
  float* corr_s = reinterpret_cast<float*>(at += L.ptile);  // [HR]
  float* row_un = corr_s + HR;  // [HR]: 2^-k, q's row scale undone
  float2* buf = reinterpret_cast<float2*>(at += L.stats);
  // probe: begin

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x, n_splits = gridDim.x;
  const int h0 = blockIdx.y * HR, b = blockIdx.z;

  // this split's run of the live tiles: keys t < min(pos, Tk) are a
  // prefix of ceil(live / TK) tiles, cut into n_splits runs of tps
  const int pos = a.pos[0];
  const int live = max(0, min(pos, a.Tk));
  const int live_tiles = (live + TK - 1) / TK;
  const int tps = (live_tiles + n_splits - 1) / n_splits;
  const int tile0 = split * tps;
  const int n_live = max(0, min(tps, live_tiles - tile0));
  const long long row0 = static_cast<long long>(b) * a.Tk;
  auto issue = [&](int it) {  // the loads of the split's tile it
    const int k0 = (tile0 + it) * TK;
    load_tile(a, stages + (it % STAGES) * L.stage, row0 + k0,
              min(TK, live - k0));
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_live) issue(s);
    cp_async_commit();
  }

  // q times its plane's scale and sm_scale, [HR][dk] f32 in the tile's
  // space, then this warp's Q fragments (A of m16n8k16: rows g and g + 8,
  // columns 2 t4 (+1) and 2 t4 + 8 (+1) of each of its k-steps) in QT f16
  // terms under the row's power-of-two scale. The group's rows of q_lat
  // and of q_pe are two contiguous runs of float2 (r and dr are even),
  // loaded with the scales in one round (QU float2 a thread in flight)
  const int dk = r + dr, nks = ksteps(r, dr);
  const int rows = min(HR, a.H - h0);
  float* qs = reinterpret_cast<float*>(tile);
  const float cs = a.cscale[0], ps = a.pscale[0];
  {
    constexpr int QU = 24;
    const size_t bh = static_cast<size_t>(b) * a.H + h0;
    const int nl = rows * r / 2, n = nl + rows * dr / 2;
    const float2* ql = reinterpret_cast<const float2*>(a.q_lat + bh * r);
    const float2* qp = reinterpret_cast<const float2*>(a.q_pe + bh * dr);
    const uint32_t mr = div_magic(r), mdr = div_magic(dr);
    for (int i0 = tid; i0 < n; i0 += QU * THREADS) {
      float2 v[QU];
#pragma unroll
      for (int k = 0; k < QU; ++k) {
        const int i = i0 + k * THREADS;
        if (i < n) v[k] = i < nl ? ql[i] : qp[i - nl];
      }
#pragma unroll
      for (int k = 0; k < QU; ++k) {
        const int i = i0 + k * THREADS;
        if (i < n) {
          const bool lat = i < nl;
          const int e = 2 * (lat ? i : i - nl);
          const int h = lat ? div_by(e, mr) : div_by(e, mdr);
          const float sc = lat ? cs : ps;
          float* dst = qs + h * dk + (lat ? e - h * r : r + e - h * dr);
          dst[0] = __fmul_rn(__fmul_rn(v[k].x, sc), a.sm_scale);
          dst[1] = __fmul_rn(__fmul_rn(v[k].y, sc), a.sm_scale);
        }
      }
    }
    for (int i = rows * dk + tid; i < HR * dk; i += THREADS) qs[i] = 0.f;
  }
  __syncthreads();
  // each row's scale 2^k, k = 14 - floor(log2 max |q|): its largest entry
  // in [2^14, 2^15), so the f16 terms keep about 22 bits of every entry
  // not 2^29 below it (those lose under 2^-40 of the row's largest)
  for (int h = warp; h < HR; h += WARPS) {
    float mx = 0.f;
    for (int d = lane; d < dk; d += 32) mx = fmaxf(mx, fabsf(qs[h * dk + d]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0)
      row_un[h] = mx > 0.f ? ldexpf(1.f, max(-100, min(100, ilogbf(mx) - 14)))
                           : 1.f;
  }
  __syncthreads();
  const int ks_lo = warp * nks / WARPS, ks_hi = (warp + 1) * nks / WARPS;
  uint32_t qa[KSW][QT][4];
#pragma unroll
  for (int i = 0; i < KSW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = g + 8 * (j & 1);
      const int d = 16 * (ks_lo + i) + 2 * t4 + 8 * (j >> 1);
      const bool ok = ks_lo + i < ks_hi && d < dk;  // dk even: d + 1 too
      const float up = __frcp_rn(row_un[h]);       // 2^k, exact
      float x0[QT], x1[QT];
      split_f16(ok ? __fmul_rn(qs[h * dk + d], up) : 0.f, x0);
      split_f16(ok ? __fmul_rn(qs[h * dk + d + 1], up) : 0.f, x1);
#pragma unroll
      for (int k = 0; k < QT; ++k) qa[i][k][j] = pack_f16(x0[k], x1[k]);
    }
  __syncthreads();
  // the tile's columns past r + dr stay 0 (q is 0 there too)
  for (int i = tid; i < TK * (16 * nks - dk); i += THREADS) {
    const int w = 16 * nks - dk, j = i / w;
    tile[j * ld + dk + (i - j * w)] = __float2half_rn(0.f);
  }
  // this block has started: the others may store into its shared memory
  // once every block of the cluster has arrived (cluster_wait below)
  cluster_arrive_relaxed();

  // the online softmax's row statistics: thread tid keeps row tid / 16's
  // (its 16 threads hold equal values)
  const int srow = tid >> 4, scol = tid & 15;
  float m_run = -CUDART_INF_F, l_run = 0.f;
  const int npairs = (r + 15) / 16;
  float acc[2 * NP][4];
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[n][k] = 0.f;
  // probe: setup

  for (int it = 0; it < n_live; ++it) {
    if (it + STAGES - 1 < n_live) issue(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    // probe: wait
    decode_tile(stages + (it % STAGES) * L.stage, tile, r, dr, ld);
    __syncthreads();
    // probe: decode

    // partial scores of this warp's k-steps for the tile's TK keys
    float sc[TK / 8][4];
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[n][k] = 0.f;
#pragma unroll
    for (int i = 0; i < KSW; ++i) {
      const int ks = ks_lo + i;
      if (ks < ks_hi) {
        uint32_t kb[TK / 8][2];
#pragma unroll
        for (int pr = 0; pr < TK / 16; ++pr) {
          // matrix lane / 8: key tile 2 pr + (lane / 16), k half lane / 8 % 2
          const int mi = lane >> 3;
          const int key = (2 * pr + (mi >> 1)) * 8 + (lane & 7);
          uint32_t v[4];
          ldmatrix_x4(tile + key * ld + 16 * ks + 8 * (mi & 1), v);
          kb[2 * pr][0] = v[0];
          kb[2 * pr][1] = v[1];
          kb[2 * pr + 1][0] = v[2];
          kb[2 * pr + 1][1] = v[3];
        }
#pragma unroll
        for (int n = 0; n < TK / 8; ++n)
#pragma unroll
          for (int k = 0; k < QT; ++k)
            mma_f16(sc[n], qa[i][k], kb[n][0], kb[n][1]);
      }
    }
    float* rw = red + warp * HR * RED_LD;
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) {
      *reinterpret_cast<float2*>(rw + g * RED_LD + 8 * n + 2 * t4) =
          make_float2(sc[n][0], sc[n][1]);
      *reinterpret_cast<float2*>(rw + (g + 8) * RED_LD + 8 * n + 2 * t4) =
          make_float2(sc[n][2], sc[n][3]);
    }
    __syncthreads();
    // probe: scores

    // online softmax over the tile: row srow, keys scol and scol + 16
    {
      const int nk = min(TK, live - (tile0 + it) * TK);
      float s[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = scol + 16 * e;
        float x = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) x += red[(w * HR + srow) * RED_LD + j];
        s[e] = j < nk ? __fmul_rn(x, row_un[srow]) : -CUDART_INF_F;
      }
      float mt = fmaxf(s[0], s[1]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m_run, mt);  // finite: a live key per tile
      const float corr =
          m_run == -CUDART_INF_F ? 0.f : expf(m_run - m_new);
      float p[2], sum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = s[e] == -CUDART_INF_F ? 0.f : expf(s[e] - m_new);
        sum += p[e];
        float pt[PT];
        split_f16(__fmul_rn(p[e], 32768.f), pt);  // P V is 2^15 times
#pragma unroll
        for (int k = 0; k < PT; ++k)
          ptile[(k * HR + srow) * P_LD + scol + 16 * e] =
              __float2half_rn(pt[k]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if (scol == 0) corr_s[srow] = corr;
    }
    __syncthreads();
    // probe: softmax

    // acc = acc * corr + P V over the tile's live k-steps of 16 keys
    {
      const float c0 = corr_s[g], c1 = corr_s[g + 8];
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) {
        acc[n][0] *= c0;
        acc[n][1] *= c0;
        acc[n][2] *= c1;
        acc[n][3] *= c1;
      }
      const int nk = min(TK, live - (tile0 + it) * TK);
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        if (16 * kk >= nk) break;
        uint32_t pa[PT][4];
#pragma unroll
        for (int k = 0; k < PT; ++k)
          ldmatrix_x4(ptile + (k * HR + (lane & 15)) * P_LD + 16 * kk +
                          8 * (lane >> 4),
                      pa[k]);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int pair = warp * NP + p;
          if (pair < npairs) {
            const int key = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
            uint32_t v[4];
            ldmatrix_x4_trans(tile + key * ld + 16 * pair + 8 * (lane >> 4),
                              v);
#pragma unroll
            for (int k = 0; k < PT; ++k) {
              mma_f16(acc[2 * p], pa[k], v[0], v[1]);
              mma_f16(acc[2 * p + 1], pa[k], v[2], v[3]);
            }
          }
        }
      }
    }
    // probe: pv
  }

  // the combine. Block z owns the float2 columns [z share, (z + 1) share)
  // of the group's [rows][r] outputs. Each block, done with its tiles,
  // pushes its m and l [16] to every block and each float2 of its
  // accumulator to the block that owns it (remote stores, no round trip)
  // into buf [n_splits][share] and ml [n_splits][2][16] of the owner's
  // combine buffer, once every block of the cluster has started; after
  // cluster.sync() every block combines its share from its own shared
  // memory.
  cluster_wait();
  const int n2 = rows * r / 2;
  const int share = (n2 + n_splits - 1) / n_splits;
  float* ml = reinterpret_cast<float*>(buf + n_splits * share);
  if (scol < n_splits) {
    float* dst = cluster.map_shared_rank(ml, scol);
    dst[(2 * split) * HR + srow] = m_run;  // -inf: no live key here
    dst[(2 * split + 1) * HR + srow] = l_run;
  }
  {
    const uint32_t ms = div_magic(share);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int pair = warp * NP + p;
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int col = 16 * pair + 8 * hlf + 2 * t4;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int h = g + 8 * rr;
          if (pair < npairs && col < r && h < rows) {
            const int e = h * (r / 2) + col / 2, z = div_by(e, ms);
            cluster.map_shared_rank(buf, z)[split * share + e - z * share] =
                make_float2(acc[2 * p + hlf][2 * rr],
                            acc[2 * p + hlf][2 * rr + 1]);
          }
        }
      }
    }
  }
  cluster.sync();

  float* wz = red;                     // [n_splits][HR]: the weights
  float* linv = wz + MAX_SPLITS * HR;  // [HR]: max(sum_z w_z l_z, 1e-30)
  if (tid < HR) {
    float mx = -CUDART_INF_F;
    for (int z = 0; z < n_splits; ++z) mx = fmaxf(mx, ml[2 * z * HR + tid]);
    float l = 0.f;
    for (int z = 0; z < n_splits; ++z) {
      const float m = ml[2 * z * HR + tid];
      const float w = m == -CUDART_INF_F ? 0.f : expf(m - mx);
      wz[z * HR + tid] = w;
      l = fmaf(w, ml[(2 * z + 1) * HR + tid], l);
    }
    linv[tid] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const int e_lo = split * share, e_hi = min(n2, e_lo + share);
  const uint32_t mr = div_magic(r / 2);
  const float cs_out = __fmul_rn(cs, 1.f / 32768.f);  // P V's 2^15 undone
  for (int e = e_lo + tid; e < e_hi; e += THREADS) {
    const int h = div_by(e, mr), c = 2 * (e - h * (r / 2));
    float2 x = make_float2(0.f, 0.f);
    for (int z = 0; z < n_splits; ++z) {
      // an empty split's weight is 0 and its accumulator 0
      const float w = wz[z * HR + h];
      const float2 v = buf[z * share + e - e_lo];
      x.x = fmaf(w, v.x, x.x);
      x.y = fmaf(w, v.y, x.y);
    }
    *reinterpret_cast<float2*>(a.out + (static_cast<size_t>(b) * a.H + h0 +
                                        h) * r + c) =
        make_float2(__fmul_rn(__fdiv_rn(x.x, linv[h]), cs_out),
                    __fmul_rn(__fdiv_rn(x.y, linv[h]), cs_out));
  }
  // probe: combine
  // probe: end 1, n_live > 0
}

// ------------------------------------------------------------ launch

template <int KSW, int NP>
struct Instance {
  static void* fn() {
    return reinterpret_cast<void*>(mla_decode_kernel<KSW, NP>);
  }
  // dynamic shared memory and non-portable clusters, once a device
  static cudaError_t prepare(size_t smem) {
    static size_t attr_smem[64] = {};
    static bool cluster16[64] = {};
    cudaError_t e = set_smem_once(mla_decode_kernel<KSW, NP>, smem,
                                  attr_smem);
    int dev = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess && !(dev < 64 && cluster16[dev])) {
      e = cudaFuncSetAttribute(mla_decode_kernel<KSW, NP>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
      if (e == cudaSuccess && dev < 64) cluster16[dev] = true;
    }
    return e;
  }
};

// the instantiations (sparq_mla_decode.py::INSTANCES): the reduced and the
// published deepseek widths, and one for any other r + dr <= 1024, r <=
// 1024; the first whose KSW and NP cover the shape
template <class F>
cudaError_t with_instance(int rank, int dr, F&& f) {
  const int kw = (ksteps(rank, dr) + WARPS - 1) / WARPS;
  const int pw = ((rank + 15) / 16 + WARPS - 1) / WARPS;
  if (kw <= 1 && pw <= 1) return f(Instance<1, 1>());
  if (kw <= 5 && pw <= 4) return f(Instance<5, 4>());
  if (kw <= 8 && pw <= 8) return f(Instance<8, 8>());
  return cudaErrorInvalidValue;
}

cudaLaunchConfig_t config(int B, int H, int n_splits, size_t smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, (H + HR - 1) / HR, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// q_lat (B, H, r) and q_pe (B, H, dr) f32; c planes (B, Tk, r) and pe
// planes (B, Tk, dr) int8; scales (1,) f32; pos (1,) int32; out (B, H, r)
// f32. A cluster of n_splits blocks (<= 16) a (batch row, head group), each
// a run of the live tiles of TK keys; vec: r and dr multiples of 16 and the
// four planes 16-byte aligned.
extern "C" int sparq_mla_decode_launch(
    const void* q_lat, const void* q_pe, const void* cd, const void* cm,
    const void* cscale, const void* pd, const void* pm, const void* pscale,
    const void* pos, void* out, int B, int H, int rank, int dr, int Tk,
    int n_splits, int vec, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || rank <= 0 || dr <= 0 || rank % 2 || dr % 2 ||
      Tk <= 0 || n_splits <= 0 || n_splits > MAX_SPLITS ||
      (vec && (rank % 16 || dr % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{static_cast<const float*>(q_lat),
                  static_cast<const float*>(q_pe),
                  static_cast<const int8_t*>(cd),
                  static_cast<const int8_t*>(cm),
                  static_cast<const float*>(cscale),
                  static_cast<const int8_t*>(pd),
                  static_cast<const int8_t*>(pm),
                  static_cast<const float*>(pscale),
                  static_cast<const int*>(pos),
                  static_cast<float*>(out),
                  H, rank, dr, Tk, vec, sm_scale};
  const size_t smem = Layout(rank, dr).total;
  const cudaError_t e = with_instance(rank, dr, [&](auto inst) {
    cudaError_t err = inst.prepare(smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(
        B, H, n_splits, smem, static_cast<cudaStream_t>(stream), attr);
    void* params[] = {const_cast<Args*>(&args)};
    return cudaLaunchKernelExC(&cfg, inst.fn(), params);
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The clusters of n_splits blocks at (H, r, dr) the card can hold at once
// (cudaOccupancyMaxActiveClusters) into *count: 0 when it cannot run one.
extern "C" int sparq_mla_decode_max_clusters(int H, int rank, int dr,
                                             int n_splits, int* count) {
  if (H <= 0 || rank <= 0 || dr <= 0 || n_splits <= 0 ||
      n_splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(rank, dr).total;
  return static_cast<int>(with_instance(rank, dr, [&](auto inst) {
    cudaError_t err = inst.prepare(smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(1, H, n_splits, smem, nullptr,
                                          attr);
    return cudaOccupancyMaxActiveClusters(count, inst.fn(), &cfg);
  }));
}
