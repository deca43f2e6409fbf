// Shared device code of the SPARQ kernels: the codec (bSPARQ trim with
// rounding carry, vSPARQ pair rule, sign-magnitude), the §5.1 meta-decode,
// and the online-softmax tile update of the flash attention kernels.
// Every function mirrors an oracle of the plain PyTorch versions
// (repro_torch/core/*.py, repro_torch/kernels/ref.py) operation for
// operation. Built without --use_fast_math: divisions are IEEE-correct
// and denormals are kept, so quantization codes match the oracles.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

extern "C" const char* sparq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, smem) once per
// device and larger size, not on every launch: done[dev] holds the largest
// size set so far on that device. Returns the attribute call's error.
template <class F>
inline cudaError_t set_smem_once(F* kernel, size_t smem, size_t (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && smem <= done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess && dev < 64) done[dev] = smem;
  return e;
}

struct SparqCodec {
  int bits;        // window width n
  int shift_mask;  // bit s set <=> window shift s is a placement option
  int shift_max;   // largest placement option
  int rounding;    // +R
  int vsparq;      // pair rule (Eq. 2)
  int is_signed;   // sign-magnitude codes in [-max_val, max_val]
  int max_val;     // 127 signed, 255 unsigned
  int enabled;     // 0: plain int8 codes (a8w8)
};

__device__ __forceinline__ int msb_pos(int x) {
  int m = 0;
#pragma unroll
  for (int k = 1; k < 8; ++k) m += (x >= (1 << k));
  return m;
}

// smallest placement option whose n-bit window covers bit m
__device__ __forceinline__ int select_shift(int m, const SparqCodec& c) {
  const int need = max(m - (c.bits - 1), 0);
#pragma unroll
  for (int opt = 0; opt < 8; ++opt)
    if (((c.shift_mask >> opt) & 1) && need <= opt) return opt;
  return c.shift_max;
}

// bsparq_encode: trim (and round, re-encoding the carry after clamping to
// max_val) a non-negative magnitude; returns q << s and sets s (ShiftCtrl)
__device__ __forceinline__ int bsparq_encode(int x, const SparqCodec& c,
                                             int& s) {
  const int wmask = (1 << c.bits) - 1;
  s = select_shift(msb_pos(x), c);
  const int q = (x >> s) & wmask;
  if (!c.rounding) return q << s;
  const int rbit = s > 0 ? (x >> (s - 1)) & 1 : 0;
  const int v = min((q + rbit) << s, c.max_val);
  s = select_shift(msb_pos(v), c);
  return ((v >> s) & wmask) << s;
}

__device__ __forceinline__ int bsparq_recon(int x, const SparqCodec& c) {
  int s;
  return bsparq_encode(x, c, s);
}

// SPARQ encoding of one vSPARQ pair of clipped integer codes: the
// reconstructed codes r0/r1 and the pair's §5.1 meta byte
// mux_any * 64 + shift_even * 8 + shift_odd (0 when trimming is off).
// A lane whose partner is zero passes through at full precision, with
// shift 0 and its MuxCtrl bit set.
__device__ __forceinline__ void sparq_encode_pair(int q0, int q1,
                                                  const SparqCodec& c,
                                                  int& r0, int& r1,
                                                  int& meta) {
  if (!c.enabled) {
    r0 = q0;
    r1 = q1;
    meta = 0;
    return;
  }
  const int m0 = abs(q0), m1 = abs(q1);
  int s0, s1;
  int t0 = bsparq_encode(m0, c, s0), t1 = bsparq_encode(m1, c, s1);
  int mux = 0;
  if (c.vsparq) {
    if (m1 == 0) {  // partner zero -> full precision
      t0 = m0;
      s0 = 0;
      mux = 1;
    }
    if (m0 == 0) {
      t1 = m1;
      s1 = 0;
      mux = 1;
    }
  }
  r0 = q0 < 0 ? -t0 : t0;
  r1 = q1 < 0 ? -t1 : t1;
  meta = mux * 64 + s0 * 8 + s1;
}

// SPARQ reconstruction of one vSPARQ pair (the codes of sparq_encode_pair)
__device__ __forceinline__ void sparq_recon_pair(int q0, int q1,
                                                 const SparqCodec& c,
                                                 int& r0, int& r1) {
  int meta;
  sparq_encode_pair(q0, q1, c, r0, r1, meta);
}

// clip(rint(x / a)) in f32, as the oracles' quantize_codes (IEEE division,
// round half to even), returned as an int
__device__ __forceinline__ int quantize_code(float x, float a, float qmin,
                                             float qmax) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, a)), qmin), qmax));
}

// §5.1 meta-decode of one stored lane: sign(q) * (|q| << shift) * scale,
// shift = (meta >> 3) & 7 on even lanes, meta & 7 on odd lanes
__device__ __forceinline__ float meta_decode(int8_t store, int8_t meta,
                                             int lane, float scale) {
  const int q = store;
  const int m = meta;
  const int s = (lane & 1) ? (m & 7) : ((m >> 3) & 7);
  const int mag = abs(q) << s;
  return __fmul_rn(static_cast<float>(q < 0 ? -mag : mag), scale);
}

// The dot products of a tile (q . k over hd, p . v and the sum of p over
// the tile's keys) accumulate in f64 and round once to f32. In f32, a
// serial sum's rounding differs from the oracle's (another order) by
// enough to move an output of tens by ~1e-4 when scores reach tens; in f64
// each tile's sums are correctly rounded, and the kernels stay within the
// oracle's own f32 error.
__device__ __forceinline__ float score_dot(const float* q, const float* k,
                                           int hd) {
  double dot = 0.0;
  for (int d = 0; d < hd; ++d)
    dot = fma(static_cast<double>(q[d]), static_cast<double>(k[d]), dot);
  return static_cast<float>(dot);
}

// One online-softmax update over a tile of nk keys for nr query rows.
// sc[r * nk + j] holds the scaled score, -inf where masked; it is
// overwritten with the probabilities. vt[j * ldv + d] is the decoded value
// tile, acc[r * hd + d] the running output; m, l, corr hold per-row
// statistics. Same arithmetic as the oracles: m_safe = 0 when m is -inf,
// corr = 0 when the previous m is -inf, masked probabilities are 0.
__device__ __forceinline__ void online_softmax_tile(
    float* sc, const float* vt, int ldv, float* m, float* l, float* corr,
    float* acc, int nr, int nk, int hd) {
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    float* s = sc + r * nk;
    float mx = -CUDART_INF_F;
    for (int j = 0; j < nk; ++j) mx = fmaxf(mx, s[j]);
    const float m_prev = m[r];
    const float m_new = fmaxf(m_prev, mx);
    const float m_safe = (m_new == -CUDART_INF_F) ? 0.f : m_new;
    double sum = 0.0;
    for (int j = 0; j < nk; ++j) {
      const float p = (s[j] == -CUDART_INF_F) ? 0.f : expf(s[j] - m_safe);
      s[j] = p;
      sum += p;
    }
    const float cr = (m_prev == -CUDART_INF_F) ? 0.f : expf(m_prev - m_safe);
    corr[r] = cr;
    l[r] = l[r] * cr + static_cast<float>(sum);
    m[r] = m_new;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx - r * hd;
    const float* p = sc + r * nk;
    double pv = 0.0;
    for (int j = 0; j < nk; ++j)
      pv = fma(static_cast<double>(p[j]),
               static_cast<double>(vt[j * ldv + d]), pv);
    acc[idx] = acc[idx] * corr[r] + static_cast<float>(pv);
  }
  __syncthreads();
}
