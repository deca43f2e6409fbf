// K4: SPARQ quantization of the KV write path, fused with the write.
//
// Replaces: src/repro/kernels/sparq_quant.py::sparq_quant_pallas (_kernel),
//   and with it the PyTorch ops the port ran around that kernel on every KV
//   write: scale resolution, sparq_pack, page and row indices, the
//   four-plane scatter, the scale and position updates. The reference
//   writes are src/repro/models/paging.py::PagedCacheStore.update and
//   write_chunk and src/repro/models/cache.py::CacheStore.update, which XLA
//   fuses inside one jitted step.
// Computes, by mode of the one C entry point sparq_quant_launch:
//   ROWS          the Pallas kernel's contract: x (M, K) f32 and a scale
//                 (one, or one per row) -> reconstructed int8 codes
//                 (window << shift, sign applied) and meta (M, K).
//   PAGED         PagedCacheStore.update, K and V in one launch. A slot's
//                 scale is its stored one if > 0, else max(amax|x|, 1e-8) /
//                 max_val over the slot's own row; its page is
//                 block_table[s, min(pos / ps, NB - 1)] (the trash page for
//                 inactive slots and unallocated blocks), its row pos % ps.
//                 The stored codes and meta go into the four pools; the new
//                 k/v scales and positions (active slots advance) into
//                 fresh tensors.
//   CHUNK_SCALE   write_chunk, first launch: the |x| maximum of every
//                 first-segment token (seq_id >= 0, hist == 0), -1 for the
//                 others.
//   CHUNK_WRITE   write_chunk, second launch: every block folds those maxima
//                 into per-slot scales (frozen if > 0, else the slot's
//                 first-segment range, else unchanged) and writes each token
//                 at block_table[seq_id, pos / ps], row pos % ps (padding
//                 and unallocated blocks to the trash page); the new scales,
//                 and seq_pos = seq_pos_after.
//   CONTIG_ONE    CacheStore.update for both planes in one launch (the
//                 decode append, T = 1): one scale a plane (the slab's range
//                 while the stored scale is 0), rows min(pos, Tmax - T) + t,
//                 pos + T. One block a plane holds the whole slab.
//   CONTIG_SCALE  the same for a large slab (the prefill append) in two
//   CONTIG_WRITE  launches: per-block |x| maxima, then the write, each block
//                 folding the maxima itself.
//   Codes and meta follow sparq_common.cuh's codec (K1's); the stored form
//   is sparq_encode_stored, equal to sparq_pack(ref_sparq_quant(...)).
// Bound: at decode sizes, the launch: a decode write is 8 slots x 4 KV heads
//   x 64 lanes x 2 planes = 4,096 values, ~16 KB in and out, where the
//   write was 59-98 PyTorch ops before, each a device kernel and a host
//   dispatch. At the 8 x 256-token prefill slab, device-memory bytes: x
//   read once in its own dtype, 2 B written a value.
// Design:
//   - launches: the whole write is one launch at decode and two for a chunk
//     or a prefill slab, where a scale must see every token before any
//     token is quantized and the blocks of one launch cannot wait for each
//     other. No other op runs on the card and the host never syncs.
//   - bytes: x is read in the model's dtype (bf16 widened exactly in
//     registers, no f32 copy). The mode sets the lanes a thread encodes:
//     the encode is a serial integer chain, so a write of a few thousand
//     values (decode, a chunk, rows) runs a lane pair a thread (one load,
//     16-bit stores; rows of 10 or 30 lanes too), and the byte-bound
//     prefill slab 8 lanes (a 16-byte load of bf16, two of f32, 8-byte
//     stores) where the row length and the pointers' alignment allow.
//     The stored form is written directly; the scale pass adds one int per
//     token (chunk) or per 8 rows (contiguous), read back from L2.
//   - no block reads a scale or position that a block of the same launch
//     writes: the new ones go to fresh tensors that the caller rebinds.
#include "sparq_common.cuh"

namespace {

enum Mode : int {
  ROWS = 0,
  PAGED = 1,
  CHUNK_SCALE = 2,
  CHUNK_WRITE = 3,
  CONTIG_ONE = 4,
  CONTIG_SCALE = 5,
  CONTIG_WRITE = 6,
};

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// slots the write pass's per-slot scales may cover (8 B of shared memory
// each, inside the 48 KB a block gets without an attribute call)
constexpr int MAX_SLOTS = 4096;

struct KvArgs {
  int mode;
  const void* x[2];          // K, V rows [rows, n] (ROWS: x[0])
  const float* scale_in[2];  // stored scales: [S] paged, chunk; [1] contig
                             // (ROWS: the step, [1] or [M])
  float* scale_out;          // new scales [2][S] or [2]
  int* maxima;               // scale-pass output, [2][rows]
  const int* block_table;    // [S][NB]
  const int* pos;            // seq_pos [S], token pos [C] or pos [1]
  int* pos_out;              // new positions [S] or [1]
  const int* seq_id;         // [C]
  const int* hist;           // [C]
  const int* pos_after;      // [S]
  signed char* data[2];      // pools or planes (ROWS: codes)
  signed char* meta[2];
  int rows;                  // rows of x a plane: M, S, C or B*T
  int n;                     // values a row: K, or KV * hd
  int per_row;               // ROWS: one scale per row
  int n_slots;               // S
  int T, Tmax;               // contiguous: tokens a batch row, capacity
  int ps, NB, trash;         // paged
  SparqCodec codec;
};

// VEC lanes of x at element offset off, widened to f32 (exact)
template <int VEC, bool BF16>
__device__ __forceinline__ void load_lanes(const void* x, long long off,
                                           float (&v)[VEC]) {
  if constexpr (BF16) {
    const unsigned short* p = static_cast<const unsigned short*>(x) + off;
    if constexpr (VEC == 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
      const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
      v[0] = __uint_as_float(u << 16);
      v[1] = __uint_as_float(u & 0xffff0000u);
    }
  } else {
    const float* p = static_cast<const float*>(x) + off;
    if constexpr (VEC == 8) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = a.x;
      v[1] = a.y;
    }
  }
}

__device__ __forceinline__ unsigned pack4(const signed char* b) {
  return static_cast<unsigned char>(b[0]) |
         static_cast<unsigned char>(b[1]) << 8 |
         static_cast<unsigned char>(b[2]) << 16 |
         static_cast<unsigned>(static_cast<unsigned char>(b[3])) << 24;
}

__device__ __forceinline__ unsigned short pack2(const signed char* b) {
  return static_cast<unsigned short>(static_cast<unsigned char>(b[0]) |
                                     static_cast<unsigned char>(b[1]) << 8);
}

// quantize VEC lanes with step a and store codes (stored window form if
// STORED, else reconstructed) and meta at element offset off
template <int VEC, bool STORED>
__device__ __forceinline__ void encode_store(const float (&v)[VEC], float a,
                                             const SparqCodec& c,
                                             signed char* data,
                                             signed char* meta,
                                             long long off) {
  const float qmax = static_cast<float>(c.max_val);
  const float qmin = c.is_signed ? -qmax : 0.f;
  signed char d[VEC], m[VEC];
#pragma unroll
  for (int i = 0; i < VEC; i += 2) {
    const int q0 = quantize_code(v[i], a, qmin, qmax);
    const int q1 = quantize_code(v[i + 1], a, qmin, qmax);
    int e0, e1, mb;
    if constexpr (STORED)
      sparq_encode_stored(q0, q1, c, e0, e1, mb);
    else
      sparq_encode_pair(q0, q1, c, e0, e1, mb);
    d[i] = static_cast<signed char>(e0);
    d[i + 1] = static_cast<signed char>(e1);
    m[i] = m[i + 1] = static_cast<signed char>(mb);
  }
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(data + off) = make_uint2(pack4(d), pack4(d + 4));
    *reinterpret_cast<uint2*>(meta + off) = make_uint2(pack4(m), pack4(m + 4));
  } else {
    *reinterpret_cast<unsigned short*>(data + off) = pack2(d);
    *reinterpret_cast<unsigned short*>(meta + off) = pack2(m);
  }
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// maximum over the block (blockDim a multiple of 32), returned to every
// thread
__device__ __forceinline__ float block_max(float m, float* red) {
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  m = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
  return warp_max(m);
}

// frozen once calibrated (> 0), else max(amax, 1e-8) / max_val in IEEE f32
__device__ __forceinline__ float resolve(float stored, float amax,
                                         int max_val) {
  return stored > 0.f
             ? stored
             : __fdiv_rn(fmaxf(amax, 1e-8f), static_cast<float>(max_val));
}

// element offset of row r's first lane in a contiguous plane
// [B, Tmax, KV, hd]: batch row r / T, time min(pos, Tmax - T) + r % T
__device__ __forceinline__ long long contig_row(const KvArgs& g, int r) {
  const int b = r / g.T, t = r - b * g.T;
  const int start = min(g.pos[0], g.Tmax - g.T);
  return (static_cast<long long>(b) * g.Tmax + start + t) * g.n;
}

// element offset of a pool row: page block_table[s, min(pos / ps, NB - 1)],
// row pos % ps; the trash page when `live` is false or the block is
// unallocated
__device__ __forceinline__ long long page_row(const KvArgs& g, int s,
                                              int pos, bool live) {
  const int eff = max(pos, 0);
  int page = g.block_table[static_cast<long long>(s) * g.NB +
                           min(eff / g.ps, g.NB - 1)];
  if (!live || page < 0) page = g.trash;
  return (static_cast<long long>(page) * g.ps + eff % g.ps) * g.n;
}

// PAGED and CONTIG_ONE: a block per (row, plane); the row is a slot's
// token (PAGED) or a batch row's (CONTIG_ONE, T = 1). The block resolves
// the scale, from its own row (PAGED) or from the whole slab, reduced again
// by every block (CONTIG_ONE; a decode slab is a few thousand values and
// only the first write of a plane needs it), then writes its row.
template <int VEC, bool BF16>
__global__ void __launch_bounds__(THREADS)
sparq_quant_group_kernel(KvArgs g) {
  __shared__ float red[32];
  const int p = blockIdx.y, row = blockIdx.x;
  const bool paged = g.mode == PAGED;
  const int nv = g.n / VEC;
  const float stored = g.scale_in[p][paged ? row : 0];
  float a = stored;
  if (!(stored > 0.f)) {
    const int first = paged ? row * nv : 0;
    const int count = paged ? nv : g.rows * nv;
    float m = 0.f;
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      float v[VEC];
      load_lanes<VEC, BF16>(g.x[p], static_cast<long long>(first + i) * VEC,
                            v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) m = fmaxf(m, fabsf(v[j]));
    }
    a = resolve(stored, block_max(m, red), g.codec.max_val);
  }
  const int pos = g.pos[paged ? row : 0];
  const long long dst = paged ? page_row(g, row, pos, pos >= 0)
                              : contig_row(g, row);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    float v[VEC];
    load_lanes<VEC, BF16>(
        g.x[p], static_cast<long long>(row) * g.n + i * VEC, v);
    encode_store<VEC, true>(v, a, g.codec, g.data[p], g.meta[p],
                            dst + i * VEC);
  }
  if (threadIdx.x != 0) return;
  if (paged) {
    g.scale_out[p * g.n_slots + row] = pos >= 0 ? a : stored;
    if (p == 0) g.pos_out[row] = pos >= 0 ? pos + 1 : pos;
  } else if (row == 0) {
    g.scale_out[p] = a;
    if (p == 0) g.pos_out[0] = pos + g.T;
  }
}

// CHUNK_SCALE and CONTIG_SCALE: a warp per row. CHUNK_SCALE stores each
// first-segment token's maximum (as the bits of a non-negative float, so
// that int order is float order) and -1 for every other token;
// CONTIG_SCALE stores the maximum of the block's 8 rows.
template <int VEC, bool BF16>
__global__ void __launch_bounds__(THREADS)
sparq_quant_amax_kernel(KvArgs g) {
  __shared__ float red[WARPS];
  const int p = blockIdx.y, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + w;
  const int nv = g.n / VEC;
  bool take = row < g.rows;
  if (g.mode == CHUNK_SCALE && take)
    take = g.seq_id[row] >= 0 && g.hist[row] == 0;
  float m = 0.f;
  if (take) {
    for (int i = lane; i < nv; i += 32) {
      float v[VEC];
      load_lanes<VEC, BF16>(g.x[p],
                            static_cast<long long>(row) * g.n + i * VEC, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) m = fmaxf(m, fabsf(v[j]));
    }
  }
  m = warp_max(m);
  int* out = g.maxima + static_cast<long long>(p) * g.rows;
  if (g.mode == CHUNK_SCALE) {
    if (lane == 0 && row < g.rows) out[row] = take ? __float_as_int(m) : -1;
    return;
  }
  if (lane == 0) red[w] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 1; k < WARPS; ++k) m = fmaxf(m, red[k]);
    out[blockIdx.x] = __float_as_int(m);
  }
}

// ROWS, CHUNK_WRITE and CONTIG_WRITE: a thread per VEC lanes of the slab;
// each block first resolves the scales it needs from the scale pass.
template <int VEC, bool BF16, bool STORED>
__global__ void __launch_bounds__(THREADS)
sparq_quant_write_kernel(KvArgs g) {
  extern __shared__ int slot_max[];   // CHUNK_WRITE: [S] maxima, [S] scales
  __shared__ float red[32];
  const int p = blockIdx.y;
  const int S = g.n_slots;
  float* slot_scale = reinterpret_cast<float*>(slot_max + S);
  float a = 0.f;
  if (g.mode == CHUNK_WRITE) {
    for (int s = threadIdx.x; s < S; s += blockDim.x) slot_max[s] = -1;
    __syncthreads();
    const int* mx = g.maxima + static_cast<long long>(p) * g.rows;
    for (int i = threadIdx.x; i < g.rows; i += blockDim.x) {
      const int bits = mx[i], sid = g.seq_id[i];
      if (bits >= 0 && sid < S) atomicMax(&slot_max[sid], bits);
    }
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float stored = g.scale_in[p][s];
      slot_scale[s] = slot_max[s] >= 0
                          ? resolve(stored, __int_as_float(slot_max[s]),
                                    g.codec.max_val)
                          : stored;
    }
    __syncthreads();
  } else if (g.mode == CONTIG_WRITE) {
    const float stored = g.scale_in[p][0];
    a = stored;
    if (!(stored > 0.f)) {
      const int nb = (g.rows + WARPS - 1) / WARPS;
      const int* mx = g.maxima + static_cast<long long>(p) * g.rows;
      float m = 0.f;
      for (int i = threadIdx.x; i < nb; i += blockDim.x)
        m = fmaxf(m, __int_as_float(mx[i]));
      a = resolve(stored, block_max(m, red), g.codec.max_val);
    }
  }
  const int nv = g.n / VEC;
  const int nvec = g.rows * nv;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += gridDim.x * blockDim.x) {
    const int r = i / nv;
    const int lane0 = (i - r * nv) * VEC;
    float sc;
    long long dst;
    if (g.mode == ROWS) {
      sc = g.scale_in[0][g.per_row ? r : 0];
      dst = static_cast<long long>(r) * g.n;
    } else if (g.mode == CHUNK_WRITE) {
      const int sid = g.seq_id[r], s = max(sid, 0);
      sc = slot_scale[s];
      dst = page_row(g, s, g.pos[r], sid >= 0);
    } else {
      sc = a;
      dst = contig_row(g, r);
    }
    float v[VEC];
    load_lanes<VEC, BF16>(g.x[p], static_cast<long long>(r) * g.n + lane0,
                          v);
    encode_store<VEC, STORED>(v, sc, g.codec, g.data[p], g.meta[p],
                              dst + lane0);
  }
  if (blockIdx.x != 0) return;
  if (g.mode == CHUNK_WRITE) {
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      g.scale_out[p * S + s] = slot_scale[s];
      if (p == 0) g.pos_out[s] = g.pos_after[s];
    }
  } else if (g.mode == CONTIG_WRITE && threadIdx.x == 0) {
    g.scale_out[p] = a;
    if (p == 0) g.pos_out[0] = g.pos[0] + g.T;
  }
}

// PAGED, CONTIG_ONE, the chunk modes and ROWS encode a lane pair a thread:
// the encode is a serial integer chain, and at their sizes (a few thousand
// values) more threads finish sooner. The contiguous prefill slab, bound by
// bytes, takes 8 lanes a thread when `vec8`.
template <bool BF16>
cudaError_t launch_mode(const KvArgs& g, bool vec8, cudaStream_t st) {
  const int planes = g.mode == ROWS ? 1 : 2;
  const int pair_blocks = (g.rows * (g.n / 2) + THREADS - 1) / THREADS;
  const int slab_blocks = (g.rows * (g.n / 8) + THREADS - 1) / THREADS;
  const dim3 amax_grid((g.rows + WARPS - 1) / WARPS, planes);
  switch (g.mode) {
    case PAGED:
    case CONTIG_ONE: {
      const int threads = min(THREADS, max(32, (g.n / 2 + 31) / 32 * 32));
      sparq_quant_group_kernel<2, BF16>
          <<<dim3(g.rows, planes), threads, 0, st>>>(g);
      break;
    }
    case CHUNK_SCALE:
      sparq_quant_amax_kernel<2, BF16><<<amax_grid, THREADS, 0, st>>>(g);
      break;
    case CONTIG_SCALE:
      if (vec8)
        sparq_quant_amax_kernel<8, BF16><<<amax_grid, THREADS, 0, st>>>(g);
      else
        sparq_quant_amax_kernel<2, BF16><<<amax_grid, THREADS, 0, st>>>(g);
      break;
    case CHUNK_WRITE:
      sparq_quant_write_kernel<2, BF16, true>
          <<<dim3(min(pair_blocks, 1024), planes), THREADS,
             2 * sizeof(int) * g.n_slots, st>>>(g);
      break;
    case CONTIG_WRITE:
      if (vec8)
        sparq_quant_write_kernel<8, BF16, true>
            <<<dim3(min(slab_blocks, 1024), planes), THREADS, 0, st>>>(g);
      else
        sparq_quant_write_kernel<2, BF16, true>
            <<<dim3(min(pair_blocks, 1024), planes), THREADS, 0, st>>>(g);
      break;
    default:                                  // ROWS: f32 only
      if constexpr (!BF16)
        sparq_quant_write_kernel<2, false, false>
            <<<dim3(min(pair_blocks, 1024), planes), THREADS, 0, st>>>(g);
  }
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// One launch of mode `mode` (see the header). Pointers a mode does not use
// may be null. x_bf16: K/V are bf16 (else f32; ROWS takes f32 only).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// mode or a size the kernels do not take).
extern "C" int sparq_quant_launch(
    int mode, const void* k, const void* v, int x_bf16, const void* k_scale,
    const void* v_scale, int per_row, void* scale_out, void* maxima,
    const void* block_table, const void* pos, void* pos_out,
    const void* seq_id, const void* hist, const void* pos_after,
    void* k_data, void* k_meta, void* v_data, void* v_meta, int rows, int n,
    int n_slots, int T, int Tmax, int ps, int NB, int trash, int bits,
    int shift_mask, int shift_max, int rounding, int vsparq, int is_signed,
    int max_val, int enabled, void* stream) {
  if (mode < ROWS || mode > CONTIG_WRITE || n % 2 || n_slots > MAX_SLOTS ||
      (mode == ROWS && x_bf16) ||
      static_cast<long long>(rows) * n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || n == 0) return 0;
  KvArgs g;
  g.mode = mode;
  g.x[0] = k;
  g.x[1] = v;
  g.scale_in[0] = static_cast<const float*>(k_scale);
  g.scale_in[1] = static_cast<const float*>(v_scale);
  g.scale_out = static_cast<float*>(scale_out);
  g.maxima = static_cast<int*>(maxima);
  g.block_table = static_cast<const int*>(block_table);
  g.pos = static_cast<const int*>(pos);
  g.pos_out = static_cast<int*>(pos_out);
  g.seq_id = static_cast<const int*>(seq_id);
  g.hist = static_cast<const int*>(hist);
  g.pos_after = static_cast<const int*>(pos_after);
  g.data[0] = static_cast<signed char*>(k_data);
  g.meta[0] = static_cast<signed char*>(k_meta);
  g.data[1] = static_cast<signed char*>(v_data);
  g.meta[1] = static_cast<signed char*>(v_meta);
  g.rows = rows;
  g.n = n;
  g.per_row = per_row;
  g.n_slots = n_slots;
  g.T = T;
  g.Tmax = Tmax;
  g.ps = ps;
  g.NB = NB;
  g.trash = trash;
  g.codec = SparqCodec{bits,   shift_mask, shift_max, rounding,
                       vsparq, is_signed,  max_val,   enabled};
  // 8 lanes a thread on the contiguous prefill slab when every row start and
  // pointer stays 16-byte aligned; a lane pair needs its own alignment only
  const int planes = mode == ROWS ? 1 : 2, esize = x_bf16 ? 2 : 4;
  bool al16 = n % 8 == 0;
  for (int q = 0; q < planes; ++q) {
    if (!aligned(g.x[q], 2 * esize) || !aligned(g.data[q], 2) ||
        !aligned(g.meta[q], 2))
      return static_cast<int>(cudaErrorMisalignedAddress);
    al16 = al16 && aligned(g.x[q], 16) && aligned(g.data[q], 16) &&
           aligned(g.meta[q], 16);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = x_bf16 ? launch_mode<true>(g, al16, st)
                               : launch_mode<false>(g, al16, st);
  return static_cast<int>(e);
}
