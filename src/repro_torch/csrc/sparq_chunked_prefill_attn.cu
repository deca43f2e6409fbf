// K3: ragged chunked-prefill attention over the §5.1 packed page pool, for
// Hopper: one f64 tensor-core kernel for every head dim, row count and
// page size.
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
// Design:
//   - Tensor cores: both products run on mma.sync.m16n8k8 f64 (DMMA). The
//     m8n8k4 shape runs at half its rate (probes/k3_probe.py on an H100
//     80GB HBM3 at 700 W: 31.6-32.9 against 65.0-66.5 TFLOP/s).
//     Q, K and V sit in shared memory widened to f64 in rows of HD + 4
//     doubles, P in rows of KT + 4, so every fragment load is free of bank
//     conflicts.
//   - One template per head dim: Traits<HD, NG> fixes the head dim HD
//     (16, 32, 64, 128 or 256), the key tile KT (64 up to hd 64, 32 at 128,
//     16 at 256, so a block's tiles fit in shared memory) and NG row
//     groups of 16 query rows (1, 2 or 4). A head dim between two
//     instantiations runs in the next one up: Q's and K's columns past hd
//     are zero in shared memory, so they add 0 to q.k, and only the first
//     hd output columns are written. kernels/sparq_prefill_attn.py::
//     k3_traits is the rule that picks the instantiation.
//   - Row blocks: a query tile's bq * G rows are cut into blocks of
//     ROWS = 16 NG rows (grid z). A row's output depends only on its own
//     statistics, so the cut is exact; every row block of a query tile
//     visits the same key tiles, rereading them from L2.
//   - Producers and consumers: at one block an SM the products ran at the
//     f64 tensor-core rate while the decode of the next tile, the softmax
//     and the block barriers took the rest of the time in series
//     (probes/k3_probe.py). Four producer warps load each visited tile's
//     raw bytes (int8 data + meta planes, or the chunk's f32 K/V rows and
//     the keys' seq_id and pos) with 16-byte loads, decode (meta_decode,
//     the oracle's f32 product) or widen them once into one of two f64
//     K/V buffers and write the tile's key list, one tile ahead of the
//     consumers; a producer's loads for a tile are in flight while it
//     waits for the buffer. The buffers pass between the two sides
//     through mbarriers (full: the producers' arrivals; empty: the
//     consumers'), so consumer warps never wait on each other between
//     tiles, and one row group's softmax runs beside another's products.
//     The first tile is decoded by every warp at once. With two producer
//     warps the consumers waited on the decode (same probe).
//   - Consumers, two warps per row group. In each key tile, warp half h
//     of a group takes keys h KT / 2 .. (h + 1) KT / 2 - 1 for S = Q K^T;
//     the pair meets at a named barrier to take the row max over both
//     halves, each writes its p (f32, exp of the f32-rounded, f32-scaled
//     score) into the group's P tile and its row sums of p (f64) beside
//     it, and after a second pair barrier each takes output columns
//     h HD / 2 .. (h + 1) HD / 2 - 1 of P V over all KT keys, DCH column
//     tiles a pass. m, l and each warp's half of acc (f32) live in
//     registers in the accumulator layout (rows lane / 4 and lane / 4 + 8,
//     columns 2 (lane & 3) + {0, 1}), flash-attention-2 style. A row's
//     mask is one interval of key positions for the pages and one for the
//     chunk, computed once per block.
//   - Key position x lies on page x / ps (a multiply and a shift) at row
//     x % ps, so a tile holds several pages (ps < KT) or a slice of one
//     (ps >= KT), for any page size.
//   - Exact skipping: a key tile in which no (row, key) pair is unmasked
//     leaves (m, l, acc) bit for bit unchanged, so the block visits only
//     the tiles kernels/sparq_prefill_attn.py::walk lists: page tiles
//     holding a key x in [max(0, min_pos - window + 1), max_hist) on an
//     allocated page, and chunk tiles holding a key of the tile's sequence
//     with max(min_hist, that lower bound) <= kpos <= max_pos. Chunk tiles
//     are counted from the sequence's first row in the chunk, so a
//     sequence's keys fall into the same tiles, and its rows round the
//     same, wherever the packer placed its run. Within a
//     visited tile the pages that are not live are zero-filled instead of
//     loaded. walk is the rule; this kernel implements it.
//   - Launch: cudaFuncSetAttribute runs once per device, instantiation and
//     larger shared-memory size, not on every launch.
#include "sparq_common.cuh"

namespace {

constexpr int BIG = 0x7fffffff;

// keys per tile of each head dim (kernels/sparq_prefill_attn.py::KEY_TILES)
template <int HD>
struct KeyTile;
template <> struct KeyTile<16> { static constexpr int value = 64; };
template <> struct KeyTile<32> { static constexpr int value = 64; };
template <> struct KeyTile<64> { static constexpr int value = 64; };
template <> struct KeyTile<128> { static constexpr int value = 32; };
template <> struct KeyTile<256> { static constexpr int value = 16; };

template <int HD_, int NG>
struct Traits {
  static constexpr int HD = HD_;
  static constexpr int KT = KeyTile<HD>::value;
  static constexpr int CW = 2 * NG;  // consumer warps, two per row group
  static constexpr int PW = 4;       // producer warps
  static constexpr int CT = 32 * CW, PT = 32 * PW;
  static constexpr int THREADS = CT + PT;
  static constexpr int ROWS = 16 * NG;  // query rows a block holds
  // f64 row strides: Q, K, V (HD + 4) and P (KT + 4); fragment loads of
  // rows lane / 4 or lane & 3 at 4 or 8 lanes are conflict-free
  static constexpr int LD = HD + 4;
  static constexpr int LDP = KT + 4;
  // output column tiles of 8 a warp takes per pass of P V (acc stays in
  // registers; a pass's f64 sums too)
  static constexpr int DCH = HD <= 64 ? HD / 16 : 4;
  // pieces of 16 elements (a K or V row's 16 columns) a tile holds, and
  // a producer thread's share of them
  static constexpr int NP = 2 * KT * (HD / 16);
  static constexpr int PB = (NP + PT - 1) / PT;
  // dynamic shared memory before the per-call index arrays
  // (kernels/sparq_prefill_attn.py::smem_bytes): Q, two K/V buffers, P,
  // the pair exchanges
  static constexpr size_t FIXED =
      sizeof(double) * (ROWS * LD + 4 * KT * LD + ROWS * LDP + CW * 16) +
      sizeof(float) * CW * 16;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// arrive (release): this thread's earlier shared-memory writes are
// visible to a thread whose wait sees the phase complete
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_u32(bar))
               : "memory");
}

// wait (acquire) until the phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  } while (!done);
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

// 16 doubles into row j of an f64 tile at column 16 c. A row whose bit 2
// is set stores its 16-byte pieces in the order k ^ 1: eight lanes on
// consecutive rows then hit eight distinct bank quads.
__device__ __forceinline__ void store_row16(double* tile, int LD, int j,
                                            int c, const double (&o)[16]) {
  double* dst = tile + j * LD + 16 * c;
  const bool sw = (j >> 2) & 1;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int k1 = k ^ 1;
    store_d2(dst + 2 * (sw ? k1 : k), sw ? o[2 * k1] : o[2 * k],
             sw ? o[2 * k1 + 1] : o[2 * k + 1]);
  }
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Args {
  const float* q;
  const float* kc;
  const float* vc;
  const int8_t* kd;
  const int8_t* km;
  const float* kscale;
  const int8_t* vd;
  const int8_t* vm;
  const float* vscale;
  const int* block_table;
  const int* seq_id;
  const int* pos;
  const int* hist;
  const int* tile_seq;
  float* out;
  int C, KV, G, hd, ps, NB, bq, window;
  // x / ps = __umulhi(x, ps_mul) >> ps_shr for 0 <= x < 2^31 (ps > 1)
  unsigned ps_mul;
  int ps_shr;
  float sm_scale;
};

template <int HD, int NG>
__global__ void __launch_bounds__(Traits<HD, NG>::THREADS, 1)
chunked_prefill_kernel(const Args a) {
  using Tr = Traits<HD, NG>;
  constexpr int KT = Tr::KT, ROWS = Tr::ROWS, THREADS = Tr::THREADS;
  constexpr int CW = Tr::CW, CT = Tr::CT, PT = Tr::PT;
  constexpr int LD = Tr::LD, LDP = Tr::LDP, DCH = Tr::DCH;
  constexpr int NP = Tr::NP, PB = Tr::PB;
  const int C = a.C, KV = a.KV, G = a.G, hd = a.hd, ps = a.ps, NB = a.NB;
  const int bq = a.bq, window = a.window;
  extern __shared__ __align__(16) unsigned char smem[];
  double* qw = reinterpret_cast<double*>(smem);  // [ROWS][LD]
  double* kvw = qw + ROWS * LD;   // [2 buffers][K, V][KT][LD]
  double* pw = kvw + 4 * KT * LD;                             // [ROWS][LDP]
  double* ssum = pw + ROWS * LDP;                             // [CW][16]
  float* smax = reinterpret_cast<float*>(ssum + CW * 16);     // [CW][16]
  int* pg = reinterpret_cast<int*>(smax + CW * 16);  // [NB] live page, else -1
  const int npt = static_cast<int>(((long long)NB * ps + KT - 1) / KT);
  const int nct = (C + KT - 1) / KT;
  int* flag = pg + NB;            // [npt + nct] tile visited?
  int* visit = flag + npt + nct;  // [npt + nct] u < npt: page tile u (keys
                                  // [u KT, (u + 1) KT)), else chunk tile
                                  // u - npt (stream keys cb + [(u - npt)
                                  // KT, (u - npt + 1) KT), cb the first
                                  // stream row of the tile's sequence)
  __shared__ int s_kseq[2][KT], s_kpos[2][KT];  // each buffer's keys
  __shared__ int s_bound[5];  // min/max pos, min/max hist, first row of ts
  __shared__ int s_nvisit;
  __shared__ __align__(8) uint64_t s_full[2], s_empty[2];

  const int qt = blockIdx.x, h = blockIdx.y, rb = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool consumer = warp < CW;
  const int R = bq * G;
  const int r0 = rb * ROWS;  // first of the block's rows of the tile
  const int i0 = qt * bq;    // first stream token of the tile
  const int ts = a.tile_seq[qt];
  // output row of tile row r: token i0 + r / G, query head r % G
  auto orow = [&](int r) {
    return a.out + (((size_t)(i0 + r / G) * KV + h) * G + r % G) * hd;
  };
  if (ts < 0) {
    for (int idx = tid; idx < ROWS * hd; idx += THREADS) {
      const int r = r0 + idx / hd;
      if (r < R) orow(r)[idx % hd] = 0.f;
    }
    return;
  }

  // ---- prologue: every global read in flight at once (Q, the block-table
  // row, the tile's tokens, the chunk's first keys), then the walk
  // (kernels/sparq_prefill_attn.py::walk)
  if (tid == 0) {
    s_bound[0] = BIG;
    s_bound[1] = -BIG;
    s_bound[2] = BIG;
    s_bound[3] = 0;
    s_bound[4] = BIG;
    for (int b = 0; b < 2; ++b) {
      mbar_init(&s_full[b], PT);
      mbar_init(&s_empty[b], CT);
    }
  }
  for (int u = tid; u < npt + nct; u += THREADS) flag[u] = 0;
  for (int t = tid; t < NB; t += THREADS)
    pg[t] = a.block_table[(size_t)ts * NB + t];
  // token tid of the tile (the bounds) and stream key tid (the walk)
  const int tsid = tid < bq ? a.seq_id[i0 + tid] : -1;
  const int tpos = tid < bq ? a.pos[i0 + tid] : 0;
  const int thist = tid < bq ? a.hist[i0 + tid] : 0;
  const int ksid = tid < C ? a.seq_id[tid] : -1;
  const int kpos = tid < C ? a.pos[tid] : 0;
  // Q rows r0 .. r0 + ROWS - 1 of the tile as f64, zero past R and past
  // hd: float4 loads, all in flight at once, or float2 where rows of hd
  // floats are not 16-byte aligned
  auto qrow = [&](int r) {
    return a.q + (((size_t)(i0 + (r0 + r) / G) * KV + h) * G + (r0 + r) % G) *
                     hd;
  };
  if (hd % 4 == 0) {
    constexpr int NQ = ROWS * (HD / 4), N = (NQ + THREADS - 1) / THREADS;
    float4 x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = tid + i * THREADS, r = idx / (HD / 4), c = idx % (HD / 4);
      x[i] = idx < NQ && r0 + r < R && 4 * c < hd
                 ? *reinterpret_cast<const float4*>(qrow(r) + 4 * c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = tid + i * THREADS, r = idx / (HD / 4), c = idx % (HD / 4);
      if (idx >= NQ) break;
      store_d2(qw + r * LD + 4 * c, x[i].x, x[i].y);
      store_d2(qw + r * LD + 4 * c + 2, x[i].z, x[i].w);
    }
  } else {
    for (int idx = tid; idx < ROWS * (HD / 2); idx += THREADS) {
      const int r = idx / (HD / 2), c = idx % (HD / 2);
      float2 x = make_float2(0.f, 0.f);
      if (r0 + r < R && 2 * c < hd)
        x = *reinterpret_cast<const float2*>(qrow(r) + 2 * c);
      store_d2(qw + r * LD + 2 * c, x.x, x.y);
    }
  }
  {
    const bool ok = tsid >= 0;
    int mn_p = ok ? tpos : BIG, mx_p = ok ? tpos : -BIG;
    int mn_h = ok ? thist : BIG, mx_h = ok ? thist : 0;
    for (int t = tid + THREADS; t < bq; t += THREADS) {
      const int sid = a.seq_id[i0 + t], p = a.pos[i0 + t];
      const int hh = a.hist[i0 + t];
      if (sid < 0) continue;
      mn_p = min(mn_p, p);
      mx_p = max(mx_p, p);
      mn_h = min(mn_h, hh);
      mx_h = max(mx_h, hh);
    }
    // the first stream row of the tile's sequence: its run starts there
    int mn_r = ksid == ts ? tid : BIG;
    for (int j = tid + THREADS; j < C; j += THREADS)
      if (a.seq_id[j] == ts) mn_r = min(mn_r, j);
    mn_p = warp_min(mn_p);
    mx_p = warp_max(mx_p);
    mn_h = warp_min(mn_h);
    mx_h = warp_max(mx_h);
    mn_r = warp_min(mn_r);
    __syncthreads();  // s_bound's first values, the mbarriers
    if (lane == 0) {
      atomicMin(s_bound, mn_p);
      atomicMax(s_bound + 1, mx_p);
      atomicMin(s_bound + 2, mn_h);
      atomicMax(s_bound + 3, mx_h);
      atomicMin(s_bound + 4, mn_r);
    }
  }
  __syncthreads();
  // no valid row: max hist = 0 and max pos = -BIG, so nothing is visited
  const int mn_pos = s_bound[0], mx_pos = s_bound[1];
  const int mn_hist = s_bound[2], hi = s_bound[3];
  const int lo = window ? max(0, mn_pos - window + 1) : 0;
  const int lo_c = max(mn_hist, lo);
  // chunk tiles start at the sequence's first row, so which of its keys
  // share a tile does not depend on where the packer placed its run
  const int cb = s_bound[4] == BIG ? 0 : s_bound[4];
  // page t (keys [t ps, (t + 1) ps)) is live when allocated and meeting
  // [lo, hi); it marks the tiles that hold its keys inside [lo, hi)
  for (int t = tid; t < NB; t += THREADS) {
    const int k0 = t * ps, k1 = k0 + ps;
    const bool live = pg[t] >= 0 && k0 < hi && k1 > lo;
    if (!live) {
      pg[t] = -1;
      continue;
    }
    const int u1 = (min(k1, hi) - 1) / KT;
    for (int u = max(k0, lo) / KT; u <= u1; ++u) flag[u] = 1;
  }
  for (int j = tid; j < C; j += THREADS) {
    const int sid = j == tid ? ksid : a.seq_id[j];
    const int p = j == tid ? kpos : a.pos[j];
    if (sid == ts && p >= lo_c && p <= mx_pos) flag[npt + (j - cb) / KT] = 1;
  }
  __syncthreads();
  if (warp == 0) {  // the visited tiles in order, 32 flags a ballot
    int n = 0;
    for (int b0 = 0; b0 < npt + nct; b0 += 32) {
      const int u = b0 + lane;
      const bool f = u < npt + nct && flag[u];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) visit[n + __popc(m & ((1u << lane) - 1u))] = u;
      n += __popc(m);
    }
    if (lane == 0) s_nvisit = n;
  }
  __syncthreads();
  const int nvisit = s_nvisit;
  const unsigned ps_mul = a.ps_mul;
  const int ps_shr = a.ps_shr;
  // the page of key position x: x / ps by a multiply and a shift
  auto page_of = [&](int x) {
    return ps == 1 ? x
                   : static_cast<int>(__umulhi(static_cast<unsigned>(x),
                                               ps_mul) >> ps_shr);
  };

  // ---- the decode of visited tile v, in two steps so that a producer's
  // loads are in flight while it waits for a buffer: load() reads thread
  // t of n's share of the raw pieces (t < n, piece idx = t + q n, rows
  // fastest; a page piece: 16 bytes of data and of meta, a chunk piece:
  // 16 floats; zeros for a page that is not live, past hd or past C) and
  // the tile's keys; put() decodes (meta_decode, the oracle's f32
  // product) or widens them into buffer b and writes the key list
  const float ks = a.kscale[ts], vs = a.vscale[ts];
  uint4 raw[PB][4];
  int key_seq = -1, key_pos = 0;
  auto load = [&](int v, int t0, int n) {
    const int u = visit[v];
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      const int idx = t0 + q * n;
      const int j = idx % KT, c = (idx / KT) % (HD / 16);
      const int which = idx / (KT * (HD / 16));
#pragma unroll
      for (int e = 0; e < 4; ++e) raw[q][e] = make_uint4(0u, 0u, 0u, 0u);
      if (idx >= NP) continue;
      if (u < npt) {  // page tile: keys at positions u KT + j
        const int x = u * KT + j, t = page_of(x);
        if (t >= NB || pg[t] < 0 || 16 * c >= hd) continue;
        const size_t off =
            (((size_t)pg[t] * ps + (x - t * ps)) * KV + h) * hd + 16 * c;
        const int8_t* dp = (which ? a.vd : a.kd) + off;
        const int8_t* mp = (which ? a.vm : a.km) + off;
        if (hd % 16 == 0) {
          raw[q][0] = __ldg(reinterpret_cast<const uint4*>(dp));
          raw[q][1] = __ldg(reinterpret_cast<const uint4*>(mp));
        } else {  // rows not 16-byte aligned: byte by byte
          uint32_t dw[4] = {0u, 0u, 0u, 0u}, mw[4] = {0u, 0u, 0u, 0u};
          for (int e = 0; e < 16 && 16 * c + e < hd; ++e) {
            dw[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(dp[e]))
                          << (8 * (e & 3));
            mw[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(mp[e]))
                          << (8 * (e & 3));
          }
          raw[q][0] = make_uint4(dw[0], dw[1], dw[2], dw[3]);
          raw[q][1] = make_uint4(mw[0], mw[1], mw[2], mw[3]);
        }
      } else {  // chunk tile: stream keys cb + (u - npt) KT + j
        const int jc = cb + (u - npt) * KT + j;
        if (jc >= C) continue;
        const float* row = (which ? a.vc : a.kc) + ((size_t)jc * KV + h) * hd;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 16 * c + 4 * e;
          if (col >= hd) break;
          float4 x;
          if (hd % 4 == 0) {
            x = __ldg(reinterpret_cast<const float4*>(row + col));
          } else {  // rows not 16-byte aligned: float2 (hd is even)
            const float2 lo2 = __ldg(reinterpret_cast<const float2*>(row + col));
            const float2 hi2 =
                col + 2 < hd
                    ? __ldg(reinterpret_cast<const float2*>(row + col + 2))
                    : make_float2(0.f, 0.f);
            x = make_float4(lo2.x, lo2.y, hi2.x, hi2.y);
          }
          raw[q][e] = make_uint4(__float_as_uint(x.x), __float_as_uint(x.y),
                                 __float_as_uint(x.z), __float_as_uint(x.w));
        }
      }
    }
    if (u >= npt && t0 < KT) {
      const int jc = cb + (u - npt) * KT + t0;
      key_seq = jc < C ? a.seq_id[jc] : -1;
      key_pos = jc < C ? a.pos[jc] : 0;
    }
  };
  auto put = [&](int v, int b, int t0, int n) {
    const int u = visit[v];
    double* kb = kvw + 2 * b * KT * LD;
    double* vb = kb + KT * LD;
    if (t0 < KT) {  // the key list: sequence (-1: no key) and position
      if (u < npt) {
        const int x = u * KT + t0, t = page_of(x);
        s_kseq[b][t0] = t < NB && pg[t] >= 0 ? ts : -1;
        s_kpos[b][t0] = x;
      } else {
        s_kseq[b][t0] = key_seq;
        s_kpos[b][t0] = key_pos;
      }
    }
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      const int idx = t0 + q * n;
      if (idx >= NP) break;
      const int j = idx % KT, c = (idx / KT) % (HD / 16);
      const int which = idx / (KT * (HD / 16));
      double o[16];
      if (u < npt) {
        const uint32_t dw[4] = {raw[q][0].x, raw[q][0].y, raw[q][0].z,
                                raw[q][0].w};
        const uint32_t mw[4] = {raw[q][1].x, raw[q][1].y, raw[q][1].z,
                                raw[q][1].w};
        const float sc = which ? vs : ks;
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[4 * w + e] =
                meta_decode(static_cast<int8_t>(dw[w] >> (8 * e)),
                            static_cast<int8_t>(mw[w] >> (8 * e)), e, sc);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[4 * e] = __uint_as_float(raw[q][e].x);
          o[4 * e + 1] = __uint_as_float(raw[q][e].y);
          o[4 * e + 2] = __uint_as_float(raw[q][e].z);
          o[4 * e + 3] = __uint_as_float(raw[q][e].w);
        }
      }
      store_row16(which ? vb : kb, LD, j, c, o);
    }
  };
  // the first tile, by every warp at once (so the consumers do not wait
  // for the producers to fill the pipeline), into buffer 0
  if (nvisit > 0) {
    load(0, tid, THREADS);
    put(0, 0, tid, THREADS);
  }
  __syncthreads();

  if (!consumer) {
    // ---- producers: visited tile v > 0 into buffer b = v & 1 once the
    // consumers have emptied it of tile v - 2; tile v is buffer b's k-th
    // use, k = v / 2
    const int ptid = tid - CT;
    for (int v = 1; v < nvisit; ++v) {
      const int b = v & 1, k = v >> 1;
      load(v, ptid, PT);
      if (k > 0) mbar_wait(&s_empty[b], (k - 1) & 1);
      put(v, b, ptid, PT);
      mbar_arrive(&s_full[b]);
    }
  } else {
    // ---- consumers
    const int g = lane >> 2, t4 = lane & 3;
    // row group and key / column half; the pair's warps are neighbours,
    // so they run on different SM sub-partitions
    const int rg = warp / 2, half = warp % 2;
    // this thread's rows g and g + 8 of its group's 16 (index mt = 0, 1):
    // the key positions each may attend to, [plo, phi] in the pages (kpos
    // < hist) and [clo, chi] in the chunk (hist <= kpos <= pos), both
    // inside the window; empty for padding rows
    int plo[2], phi[2], clo[2], chi[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = r0 + rg * 16 + mt * 8 + g;
      const int t = r < R ? r / G : 0;
      const bool ok = r < R && a.seq_id[i0 + t] >= 0;
      const int p = a.pos[i0 + t], hh = a.hist[i0 + t];
      const int wlo = window ? p - window + 1 : -BIG;
      plo[mt] = ok ? wlo : BIG;
      phi[mt] = hh - 1;
      clo[mt] = ok ? max(wlo, hh) : BIG;
      chi[mt] = p;
    }
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
    // acc: this warp's half of the output columns, in the P V accumulator
    // layout, rounded to f32
    float acc[HD / 16][4];
#pragma unroll
    for (int dt = 0; dt < HD / 16; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;

    const double* qa = qw + (rg * 16 + g) * LD + t4;
    double* prow = pw + (rg * 16 + g) * LDP;
    for (int v = 0; v < nvisit; ++v) {
      // tile v decoded: the first by every warp, then buffer 1's k-th and
      // buffer 0's (k - 1)-th fill by the producers
      const int b = v & 1, k = v >> 1;
      if (v > 0) mbar_wait(&s_full[b], (k - b + 1) & 1);
      const double* kw = kvw + 2 * b * KT * LD;
      const double* vw = kw + KT * LD;
      const bool page_tile = visit[v] < npt;

      // S = Q K^T over this warp's half of the keys: s[nt] holds rows g,
      // g + 8 x keys half KT / 2 + 8 nt + 2 t4 + {0, 1} of the tile
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

      // scores in f32 (rounded, then scaled, as the oracle's einsum *
      // scale) and masked; the row max over both halves meets in smax
      float p[KT / 16][4];
#pragma unroll
      for (int nt = 0; nt < KT / 16; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = half * (KT / 2) + nt * 8 + 2 * t4 + e;
          const bool kok = s_kseq[b][jj] == ts;
          const int x = s_kpos[b][jj];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const bool ok = kok && x >= (page_tile ? plo[mt] : clo[mt]) &&
                            x <= (page_tile ? phi[mt] : chi[mt]);
            p[nt][2 * mt + e] =
                ok ? static_cast<float>(s[nt][2 * mt + e]) * a.sm_scale
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
        const float mx =
            fmaxf(m_safe[mt], smax[(warp ^ 1) * 16 + mt * 8 + g]);
        const float m_new = fmaxf(m[mt], mx);
        m_safe[mt] = (m_new == -CUDART_INF_F) ? 0.f : m_new;
        corr[mt] = (m[mt] == -CUDART_INF_F) ? 0.f : expf(m[mt] - m_safe[mt]);
        m[mt] = m_new;
      }
      // p = exp(s - m_safe) in f32, into the group's P tile (f64, key
      // order); each warp's row sums of p over its keys, in f64, meet in
      // ssum
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
          store_d2(prow + mt * 8 * LDP + half * (KT / 2) + nt * 8 + 2 * t4,
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

      // P V over all keys for this warp's half of the columns, DCH column
      // tiles a pass
      const double* pa = pw + (rg * 16 + g) * LDP + t4;
      const double* vbase = vw + t4 * LD + half * (HD / 2) + g;
#pragma unroll
      for (int dc = 0; dc < HD / 16; dc += DCH) {
        double o[DCH][4];
#pragma unroll
        for (int dt = 0; dt < DCH; ++dt)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[dt][i] = 0.0;
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt) {
          const double a0 = pa[8 * nt], a1 = pa[8 * LDP + 8 * nt];
          const double a2 = pa[8 * nt + 4], a3 = pa[8 * LDP + 8 * nt + 4];
          const double* vr = vbase + nt * 8 * LD + dc * 8;
#pragma unroll
          for (int dt = 0; dt < DCH; ++dt)
            dmma(o[dt], a0, a1, a2, a3, vr[dt * 8], vr[4 * LD + dt * 8]);
        }
#pragma unroll
        for (int dt = 0; dt < DCH; ++dt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[dc + dt][i] =
                acc[dc + dt][i] * corr[i >> 1] + static_cast<float>(o[dt][i]);
      }
      mbar_arrive(&s_empty[b]);  // done with buffer b
    }

    // out = acc / max(l, 1e-30)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = r0 + rg * 16 + mt * 8 + g;
      if (r >= R) continue;
      const float lm = fmaxf(l[mt], 1e-30f);
      float* o = orow(r);
#pragma unroll
      for (int dt = 0; dt < HD / 16; ++dt) {
        const int col = half * (HD / 2) + dt * 8 + 2 * t4;
        if (col < hd)
          *reinterpret_cast<float2*>(o + col) = make_float2(
              acc[dt][2 * mt] / lm, acc[dt][2 * mt + 1] / lm);
      }
    }
  }
}

template <int HD, int NG>
int launch(const Args& a, cudaStream_t stream) {
  using Tr = Traits<HD, NG>;
  // the per-call index arrays: pg [NB], flag and visit [npt + nct]
  const long long npt = ((long long)a.NB * a.ps + Tr::KT - 1) / Tr::KT;
  const size_t smem =
      Tr::FIXED +
      sizeof(int) * (a.NB + 2 * (npt + (a.C + Tr::KT - 1) / Tr::KT));
  static size_t attr_smem[64] = {};
  const cudaError_t e =
      set_smem_once(chunked_prefill_kernel<HD, NG>, smem, attr_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.C / a.bq, a.KV, (a.bq * a.G + Tr::ROWS - 1) / Tr::ROWS);
  chunked_prefill_kernel<HD, NG><<<grid, Tr::THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (C, KV, G, hd) f32; k/v_chunk (C, KV, hd) f32; pools (P, ps, KV, hd)
// int8; scales (S,) f32; block_table (S, NB) int32; seq_id/pos/hist (C,)
// int32; tile_seq (C / bq,) int32; out (C, KV, G, hd) f32. hd_pad and
// groups name the instantiation (kernels/sparq_prefill_attn.py::
// k3_traits). The float tensors start 16-byte aligned (the wrapper copies
// those that do not).
extern "C" int sparq_chunked_prefill_attn_launch(
    const void* q, const void* kc, const void* vc, const void* kd,
    const void* km, const void* kscale, const void* vd, const void* vm,
    const void* vscale, const void* block_table, const void* seq_id,
    const void* pos, const void* hist, const void* tile_seq, void* out,
    int C, int KV, int G, int hd, int ps, int NB, int bq, int window,
    int hd_pad, int groups, float sm_scale, void* stream) {
  if (hd < 2 || hd % 2 || hd > hd_pad || ps <= 0 || bq <= 0 || C % bq)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(q),       static_cast<const float*>(kc),
         static_cast<const float*>(vc),      static_cast<const int8_t*>(kd),
         static_cast<const int8_t*>(km),     static_cast<const float*>(kscale),
         static_cast<const int8_t*>(vd),     static_cast<const int8_t*>(vm),
         static_cast<const float*>(vscale),  static_cast<const int*>(block_table),
         static_cast<const int*>(seq_id),    static_cast<const int*>(pos),
         static_cast<const int*>(hist),      static_cast<const int*>(tile_seq),
         static_cast<float*>(out),           C, KV, G, hd, ps, NB, bq, window,
         0u, 0, sm_scale};
  if (ps > 1) {  // p = 31 + ceil(log2 ps), mul = ceil(2^p / ps)
    int l = 0;
    while ((1 << l) < ps) ++l;
    a.ps_mul = static_cast<unsigned>(((1ull << (31 + l)) + ps - 1) / ps);
    a.ps_shr = l - 1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3_INSTANCE(H, N) \
  if (hd_pad == H && groups == N) return launch<H, N>(a, s);
  K3_INSTANCE(16, 1) K3_INSTANCE(16, 2) K3_INSTANCE(16, 4)
  K3_INSTANCE(32, 1) K3_INSTANCE(32, 2) K3_INSTANCE(32, 4)
  K3_INSTANCE(64, 1) K3_INSTANCE(64, 2) K3_INSTANCE(64, 4)
  K3_INSTANCE(128, 1) K3_INSTANCE(128, 2) K3_INSTANCE(128, 4)
  K3_INSTANCE(256, 1) K3_INSTANCE(256, 2)
#undef K3_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}
