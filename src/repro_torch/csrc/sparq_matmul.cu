// K1: fused SPARQ activation quantization + 8-bit integer matmul, for
// Hopper: signed codes (int8 x int8) or the paper's unsigned post-ReLU
// codes (uint8 x int8).
//
// Replaces: src/repro/kernels/sparq_matmul.py::sparq_matmul_pallas
//           (_kernel, _recon_tile).
// Computes: out[M,N] f32 = (sum_k r[m,k] * w[k,n]) * a * c[n], where r is
//   the SPARQ reconstruction of clip(rint(x / a)) (bSPARQ window with the
//   rounding carry, vSPARQ passthrough when the pair partner is 0,
//   sign-magnitude) and w holds int8 (K, N) per-channel weight codes.
//   Signed codecs give r in [-127, 127] (int8); unsigned ones (max_val up
//   to 255, the paper's post-ReLU activations) r in [0, 255] (uint8).
// Bound: at decode (M = active slots, 8) the int8 weights are almost all
//   the bytes and the work is tiny, so K1 is bound by device-memory bytes
//   and by how many weight bytes are in flight at once; only at large M
//   (prefill chunks, the scan prefill's 2048 rows) does it approach the
//   int8 tensor-core rate.
// Design, one ctypes call = two launches on the caller's stream:
//   1. sparq_matmul_quant_kernel quantizes x once per call into the
//      reconstructed codes r (M, kp), one byte each (int8 when signed,
//      uint8 when not), kp = K rounded up to the k tile and zero-filled
//      (0 in either type), one thread per vSPARQ lane pair, with
//      sparq_common.cuh's codec (the one K4 runs). The pair decisions are
//      taken here on whole pairs, so nothing downstream can split a pair.
//      It also zeroes the split-K arrival counters.
//   2. sparq_matmul_mma_kernel runs the product on the integer tensor
//      cores (mma.sync m16n8k32 s8.s8.s32, or u8.s8.s32 for unsigned
//      codes; int32 accumulators in registers). r's bytes are copied and
//      ldmatrix'd as raw bits, never widened, so the only place the A
//      type shows is the mma's .atype.
//      Both operands stream into shared memory through a STAGES-deep
//      cp.async ring of 16-byte copies, one __syncthreads per k tile, so
//      the next tiles' loads are in flight while the current one runs.
//      A fragments come from r with ldmatrix (rows swizzled against bank
//      conflicts). The mma wants B k-contiguous per n, but w is (K, N)
//      row-major and ldmatrix .trans moves 16-bit elements only, so the
//      weight tile is staged as it lies in device memory ([k][n], 16-byte
//      chunks swizzled) and each thread reads four k-rows of four n and
//      transposes the 4x4 bytes in registers with __byte_perm. The four
//      words give one B column to each of four n8 mma tiles, so mma tile
//      j column g is output column 4g + j of its 32-column slab; the
//      accumulators then hold 8 consecutive output columns per thread.
//   3. Split-K: when the output tiles give fewer blocks than the card has
//      SMs, the plan (kernels/sparq_matmul.py::plan) cuts K into slices of
//      whole k tiles and gridDim.z blocks share one output tile. Each
//      stores its int32 partial sums to its own plane of a workspace; the
//      block that arrives last at the tile's counter adds the planes in
//      slice order and applies the epilogue. The integer sum is exact in
//      any order, and the float epilogue (float(acc) * a) * c[n] runs
//      once, on the whole sum, in the plain version's order, so K1 is
//      bit-exact and does not depend on the order in which the blocks
//      finish. |r| <= 255, |w| <= 127 and K <= 5632 keep every sum below
//      2^28 (the CNN's K <= 1152: below 2^26).
//   At decode the GEMM is launched as a programmatic dependent of the
//   pre-pass: its blocks start while the pre-pass runs, put their first
//   weight tiles in flight, and only then wait for r, so the pre-pass and
//   the launch gap hide behind the weight stream.
//   The kernel masks ragged M, N and K edges itself (zero-filled copies;
//   byte-wise weight copies where N % 16 != 0).
#include <cuda_bf16.h>

#include "sparq_common.cuh"

namespace {

constexpr int BK = 64;       // k bytes per tile: two mma k-steps of 32
constexpr int B_ROW = 128;   // bytes per staged weight row, for every BN
constexpr int STAGES = 4;    // depth of the cp.async ring
constexpr int QUANT_THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------- pre-pass

// grid ceil(M * kp / 2 / QUANT_THREADS): one thread per lane pair of r,
// row-major over (M, kp / 2), so M is bounded by no grid dimension (the
// CNN's im2col products have M = 256 * H * W, up to 262144)
template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
sparq_matmul_quant_kernel(const T* __restrict__ x,
                          const float* __restrict__ ascale,
                          uchar2* __restrict__ r, int* __restrict__ arrivals,
                          int n_arrivals, int M, int K, int kp,
                          SparqCodec codec) {
  // the GEMM may launch now: it prefetches weights, then waits for r
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const size_t t = (size_t)blockIdx.x * QUANT_THREADS + threadIdx.x;
  const size_t m = t / (kp / 2);
  const int i = static_cast<int>(t - m * (kp / 2));  // pair in row
  if (m < (size_t)M) {
    int r0 = 0, r1 = 0;
    if (2 * i < K) {  // K is even: 2i + 1 < K too
      const float a = ascale[0];
      const float qmax = static_cast<float>(codec.max_val);
      const float qmin = codec.is_signed ? -qmax : 0.f;
      const T* xp = x + m * K + 2 * i;
      sparq_recon_pair(quantize_code(to_float(xp[0]), a, qmin, qmax),
                       quantize_code(to_float(xp[1]), a, qmin, qmax), codec,
                       r0, r1);
    }
    // the code's low byte: int8 two's complement when signed, uint8 when
    // not (r0, r1 in [0, 255])
    r[t] = make_uchar2(static_cast<uint8_t>(r0), static_cast<uint8_t>(r1));
  }
  for (size_t j = t; j < (size_t)n_arrivals;
       j += (size_t)gridDim.x * QUANT_THREADS)
    arrivals[j] = 0;
}

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// c += a * b on the integer tensor cores; A (the codes r, row-major) is
// s8 or, when A_U8, u8; B (the weights) is always s8. PTX orders the
// types .atype.btype.
template <bool A_U8>
__device__ __forceinline__ void mma_i8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  if constexpr (A_U8)
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4x4 byte transpose: v[i] holds row i's bytes 0..3; o[j] gets byte j of
// v[0..3], in row order
__device__ __forceinline__ void transpose4x4(const uint32_t (&v)[4],
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t t1 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// Swizzled byte offsets of 16-byte chunk c of a staged row. A rows are BK
// = 64 bytes: chunk ^ (row / 2 % 4) keeps ldmatrix's 8 row reads on 8
// distinct bank groups. B rows are 128 bytes: chunk ^ 2 * (k / 4 % 4)
// keeps the warp's reads of four k-rows (k = 4t + i, t = lane % 4) by
// eight n-groups on 32 distinct banks.
__device__ __forceinline__ int a_off(int row, int c) {
  return row * BK + ((c ^ ((row >> 1) & 3)) << 4);
}
__device__ __forceinline__ int b_off(int k, int c) {
  return k * B_ROW + ((c ^ (((k >> 2) & 3) << 1)) << 4);
}

__device__ __forceinline__ float epilogue(int acc, float a, float c) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), a), c);
}

// ------------------------------------------------------------------ GEMM

// One block computes a BM x BN output tile over its K slice; its warps
// tile it WTM x WTN (MT m16 tiles by NS 32-column slabs of four n8 tiles).
// A_U8: r holds uint8 codes (unsigned codecs), else int8.
template <int BM, int BN, int WTM, int WTN, bool A_U8>
__global__ void __launch_bounds__((BM / WTM) * (BN / WTN) * 32)
sparq_matmul_mma_kernel(const uint8_t* __restrict__ r,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ ascale,
                        const float* __restrict__ cscale,
                        float* __restrict__ out, int* __restrict__ ws,
                        int* __restrict__ arrivals, int M, int N, int K,
                        int kp, int tiles_per_split, int w_vec) {
  constexpr int WARPS_N = BN / WTN;
  constexpr int THREADS = (BM / WTM) * WARPS_N * 32;
  constexpr int MT = WTM / 16;
  constexpr int NS = WTN / 32;
  constexpr int A_STAGE = BM * BK;
  constexpr int B_STAGE = BK * B_ROW;
  constexpr int CPR = BN / 16;  // 16-byte chunks per weight row
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* As = smem;
  int8_t* Bs = smem + STAGES * A_STAGE;
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * WTM, wn = (warp % WARPS_N) * WTN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int split = gridDim.z;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int nt = min((K + BK - 1) / BK - kt0, tiles_per_split);

  auto load_a = [&](int stage, int kt) {
    const int k0 = kt * BK;
    int8_t* as = As + stage * A_STAGE;
    for (int i = tid; i < BM * (BK / 16); i += THREADS) {
      const int row = i >> 2, c = i & 3;
      const bool ok = m0 + row < M;
      const uint8_t* src = r + (size_t)(ok ? m0 + row : 0) * kp + k0 + c * 16;
      cp_async16(smem_u32(as + a_off(row, c)), src, ok);
    }
  };
  auto load_b = [&](int stage, int kt) {
    const int k0 = kt * BK;
    int8_t* bs = Bs + stage * B_STAGE;
    if (w_vec) {  // N % 16 == 0 and w 16-byte aligned
      for (int i = tid; i < BK * CPR; i += THREADS) {
        const int kr = i / CPR, c = i - kr * CPR;
        const int gk = k0 + kr, gn = n0 + c * 16;
        const bool ok = gk < K && gn < N;
        const int8_t* src = w + (ok ? (size_t)gk * N + gn : 0);
        cp_async16(smem_u32(bs + b_off(kr, c)), src, ok);
      }
    } else {
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kr = i / BN, n = i - kr * BN;
        const int gk = k0 + kr, gn = n0 + n;
        bs[b_off(kr, n >> 4) + (n & 15)] =
            (gk < K && gn < N) ? w[(size_t)gk * N + gn] : int8_t(0);
      }
    }
  };

  int acc[MT][NS * 4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NS * 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // The weights do not depend on the pre-pass: their first tiles are in
  // flight before the wait for r (programmatic dependent launch; without
  // it the wait returns at once).
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < nt) load_b(s, kt0 + s);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load_a(s, kt0 + s);
    cp_async_commit();  // group s holds A of tile s (and B of tile <= s)
  }
  for (int it = 0; it < nt; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile `it` is visible; stage (it - 1) is free
    const int nx = it + STAGES - 1;
    if (nx < nt) {
      load_a(nx % STAGES, kt0 + nx);
      load_b(nx % STAGES, kt0 + nx);
    }
    cp_async_commit();
    const int8_t* as = As + (it % STAGES) * A_STAGE;
    const int8_t* bs = Bs + (it % STAGES) * B_STAGE;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wm + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(smem_u32(as + a_off(row, (ks >> 4) + (lane >> 4))),
                    a[mt]);
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int nb = wn + 32 * s + 4 * g;  // this thread's 4 n bytes
        uint32_t b[2][4];                    // [k half][n8 tile j]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kr = ks + 16 * h + 4 * t + i;
            v[i] = *reinterpret_cast<const uint32_t*>(
                bs + b_off(kr, nb >> 4) + (nb & 15));
          }
          transpose4x4(v, b[h]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_i8<A_U8>(acc[mt][s * 4 + j], a[mt], b[0][j], b[1][j]);
      }
    }
  }
  cp_async_wait<0>();

  // Thread (g, t) holds, per m16 tile and slab, rows g and g + 8 of output
  // columns 8t .. 8t + 7 of the slab: n8 tile j's c0/c2 are column 8t + j,
  // its c1/c3 column 8t + 4 + j.
  const float a_s = ascale[0];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int gm = m0 + wm + mt * 16 + g + 8 * hr;
        const int gn = n0 + wn + 32 * s + 8 * t;
        if (gm >= M || gn >= N) continue;
        int v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = acc[mt][s * 4 + j][2 * hr];
          v[4 + j] = acc[mt][s * 4 + j][2 * hr + 1];
        }
        const size_t o = (size_t)gm * N + gn;
        if (split > 1) {  // this slice's partial sums, plain stores
          int* p = ws + (size_t)blockIdx.z * M * N + o;
          if ((N & 3) == 0 && gn + 8 <= N) {
            reinterpret_cast<int4*>(p)[0] = make_int4(v[0], v[1], v[2], v[3]);
            reinterpret_cast<int4*>(p)[1] = make_int4(v[4], v[5], v[6], v[7]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (gn + e < N) p[e] = v[e];
          }
        } else if ((N & 3) == 0 && gn + 8 <= N) {
          float f[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = epilogue(v[e], a_s, cscale[gn + e]);
          reinterpret_cast<float4*>(out + o)[0] =
              make_float4(f[0], f[1], f[2], f[3]);
          reinterpret_cast<float4*>(out + o)[1] =
              make_float4(f[4], f[5], f[6], f[7]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (gn + e < N) out[o + e] = epilogue(v[e], a_s, cscale[gn + e]);
        }
      }
  if (split == 1) return;

  // split-K: the last block to arrive at this output tile sums the
  // slices' partials in slice order and writes the tile
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(arrivals + blockIdx.y * gridDim.x + blockIdx.x, 1) ==
              split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t plane = (size_t)M * N;
  for (int i = tid; i < BM * BN / 4; i += THREADS) {
    const int gm = m0 + i / (BN / 4), gn = n0 + 4 * (i % (BN / 4));
    if (gm >= M || gn >= N) continue;
    const size_t o = (size_t)gm * N + gn;
    if ((N & 3) == 0) {  // gn + 4 <= N
      const int4* p = reinterpret_cast<const int4*>(ws + o);
      const size_t step = plane / 4;
      int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll 8
      for (int z = 0; z < split; ++z) {
        const int4 q = __ldcg(p + z * step);
        sum.x += q.x;
        sum.y += q.y;
        sum.z += q.z;
        sum.w += q.w;
      }
      reinterpret_cast<float4*>(out + o)[0] = make_float4(
          epilogue(sum.x, a_s, cscale[gn]), epilogue(sum.y, a_s, cscale[gn + 1]),
          epilogue(sum.z, a_s, cscale[gn + 2]),
          epilogue(sum.w, a_s, cscale[gn + 3]));
    } else {
      for (int e = 0; e < 4 && gn + e < N; ++e) {
        int sum = 0;
        for (int z = 0; z < split; ++z) sum += __ldcg(ws + z * plane + o + e);
        out[o + e] = epilogue(sum, a_s, cscale[gn + e]);
      }
    }
  }
}

template <int BM, int BN, int WTM, int WTN, bool A_U8>
int launch_mma(const uint8_t* r, const int8_t* w, const float* a,
               const float* c, float* out, int* ws, int* arrivals, int M,
               int N, int K, int kp, int tiles_per_split, int split_k,
               int w_vec, cudaStream_t stream) {
  constexpr int THREADS = (BM / WTM) * (BN / WTN) * 32;
  constexpr int SMEM = STAGES * (BM * BK + BK * B_ROW);
  auto kernel = sparq_matmul_mma_kernel<BM, BN, WTM, WTN, A_U8>;
  static unsigned long long attr_set = 0;  // per device, per instantiation
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !((attr_set >> dev) & 1)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) attr_set |= 1ull << dev;
  }
  // Programmatic dependent launch at decode (BM = 16): the GEMM's blocks
  // start while the small pre-pass runs and wait for it at
  // griddepcontrol.wait. At larger M the pre-pass fills the SMs, and
  // blocks placed early would crowd onto the SMs it frees first.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = BM == 16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, split_k);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, r, w, a, c, out,
                                             ws, arrivals, M, N, K, kp,
                                             tiles_per_split, w_vec));
}

}  // namespace

// x: (M, K) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w: (K, N) int8;
// ascale: 1 f32 (device); cscale: (N,) f32; out: (M, N) f32.
// Scratch, allocated by the wrapper: r (M, kp) codes, one byte each (int8
// when is_signed, uint8 when not); with split_k > 1 the
// int32 partial sums ws (split_k, M, N) and the arrival counters, one int
// per output tile.
// The tile plan (bm, bn, tiles_per_split, split_k) comes from
// kernels/sparq_matmul.py::plan; w_vec = 1 when N % 16 == 0 and w is
// 16-byte aligned (16-byte weight copies).
extern "C" int sparq_matmul_launch(const void* x, int x_bf16, const void* w,
                                   const void* ascale, const void* cscale,
                                   void* out, void* r, void* ws,
                                   void* arrivals, int M, int N, int K,
                                   int kp, int bm, int bn,
                                   int tiles_per_split, int split_k,
                                   int w_vec, int bits, int shift_mask,
                                   int shift_max, int rounding, int vsparq,
                                   int is_signed, int max_val, int enabled,
                                   void* stream) {
  const SparqCodec codec{bits,   shift_mask, shift_max, rounding,
                         vsparq, is_signed,  max_val,   enabled};
  if (M <= 0 || (M + bm - 1) / bm > 65535 || N <= 0 || K <= 0 ||
      kp % BK || kp < K || max_val < 1 ||
      max_val > (is_signed ? 127 : 255) || split_k < 1 ||
      (split_k > 1 && (ws == nullptr || arrivals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int tiles = ((N + bn - 1) / bn) * ((M + bm - 1) / bm);
  const int n_arr = split_k > 1 ? tiles : 0;
  const size_t pairs = (size_t)M * (kp / 2);
  const dim3 qgrid(
      static_cast<unsigned>((pairs + QUANT_THREADS - 1) / QUANT_THREADS));
  auto* rp = static_cast<uchar2*>(r);
  auto* wsp = static_cast<int*>(ws);
  auto* arp = static_cast<int*>(arrivals);
  if (x_bf16)
    sparq_matmul_quant_kernel<__nv_bfloat16><<<qgrid, QUANT_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(ascale), rp, arp, n_arr, M, K, kp, codec);
  else
    sparq_matmul_quant_kernel<float><<<qgrid, QUANT_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(ascale), rp,
        arp, n_arr, M, K, kp, codec);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* r8 = static_cast<const uint8_t*>(r);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* ap = static_cast<const float*>(ascale);
  const auto* cp = static_cast<const float*>(cscale);
  auto* op = static_cast<float*>(out);
#define SPARQ_MMA(BM, BN, WTM, WTN)                                          \
  if (bm == BM && bn == BN)                                                  \
    return is_signed                                                         \
               ? launch_mma<BM, BN, WTM, WTN, false>(                        \
                     r8, wp, ap, cp, op, wsp, arp, M, N, K, kp,              \
                     tiles_per_split, split_k, w_vec, st)                    \
               : launch_mma<BM, BN, WTM, WTN, true>(                         \
                     r8, wp, ap, cp, op, wsp, arp, M, N, K, kp,              \
                     tiles_per_split, split_k, w_vec, st);
  SPARQ_MMA(16, 128, 16, 32)
  SPARQ_MMA(64, 128, 32, 64)
  SPARQ_MMA(64, 32, 16, 32)
  SPARQ_MMA(128, 128, 32, 64)
#undef SPARQ_MMA
  return static_cast<int>(cudaErrorInvalidValue);
}
