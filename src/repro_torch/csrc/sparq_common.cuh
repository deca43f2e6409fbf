// Shared device code of the SPARQ kernels: the codec (bSPARQ trim with
// rounding carry, vSPARQ pair rule, sign-magnitude) and the §5.1
// meta-decode.
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

// Stored form of one vSPARQ pair (what the §5.1 KV planes hold): the
// window codes st = sign * (|r| >> shift), with r and the shifts of
// sparq_encode_pair (the window on trimmed lanes, the full magnitude on
// mux'd lanes, whose shift is 0), and the pair's meta byte. Equal to
// sparq_pack(ref_sparq_quant(...)) bit for bit; with trimming off the
// meta is 0 and st = q.
__device__ __forceinline__ void sparq_encode_stored(int q0, int q1,
                                                    const SparqCodec& c,
                                                    int& st0, int& st1,
                                                    int& meta) {
  int r0, r1;
  sparq_encode_pair(q0, q1, c, r0, r1, meta);
  const int m0 = abs(r0) >> ((meta >> 3) & 7), m1 = abs(r1) >> (meta & 7);
  st0 = r0 < 0 ? -m0 : m0;
  st1 = r1 < 0 ? -m1 : m1;
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
