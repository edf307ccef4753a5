// Device helpers shared by the port's W4 kernels (w4_gemv_sm90.cu: K1;
// w4_gemv_mma.cu: K6; decode_layer_sm90.cu: K3; w4_pair_sm90.cu: K4, K5):
// the one definition of
// the prologue value that the int8 digits expand, the digit expansion, and
// the int8 tensor-core fragments of the packed nibble planes. Internal
// linkage, like sm90_common.cuh.
//
// The prologue value of element i of an input row, rounded to bf16 before
// the digit expansion (as the TPU kernels do), is one of
//   none   x[i];
//   RMS    bf16((x[i] * r) * gamma[i]), r = f32(1 / sqrt(ss / n + eps)),
//          ss the row's sum of squares;
//   SiLU   bf16((g * s) * u), s = f32(1 / (1 + exp(-g))), for g = x[i],
//          u = x[n + i] of a (gate | up) row.
// The sum of squares, the square root, the reciprocal and exp are taken in
// f64 and rounded once to f32: every f32 square is exact in f64, so for
// rows of up to 2^14-odd elements any two summation orders agree to ~2^-39
// relative, and their f32 roundings agree except on a vanishing set of
// rows. The products stay f32 (rounded in the order written). The plain
// version (`quant._prologue_ref`) computes the same f64 steps, so kernel
// and plain version give the same bits whatever order each sums in.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { PRO_NONE = 0, PRO_RMS = 1, PRO_SILU = 2 };

__device__ __forceinline__ float ld_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// this thread's share (elements tid, tid + stride, ...) of a row's sum of
// squares, in f64
template <typename TIn>
__device__ __forceinline__ double sumsq_part(const TIn* xr, int n, int tid, int stride) {
  double ss = 0.0;
  for (int i = tid; i < n; i += stride) {
    const double v = (double)ld_f(xr, i);
    ss += v * v;
  }
  return ss;
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of v over a block of NW warps (all threads call; `red` holds NW
// doubles): warps in order
template <int NW>
__device__ __forceinline__ double block_sum_f64(double v, double* red) {
  v = warp_sum_f64(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double r = red[0];
  for (int w = 1; w < NW; ++w) r += red[w];
  __syncthreads();
  return r;
}

// the RMSNorm factor from a row's f64 sum of squares
__device__ __forceinline__ float rms_scale(double ss, int n, float eps) {
  return (float)(1.0 / sqrt(ss / (double)n + (double)eps));
}

// SiLU's sigmoid, in f64, rounded once
__device__ __forceinline__ float sigmoid_f64(float g) {
  return (float)(1.0 / (1.0 + exp(-(double)g)));
}

__device__ __forceinline__ float rms_value(float x, float rms, float gamma) {
  return round_bf16(__fmul_rn(__fmul_rn(x, rms), gamma));
}

__device__ __forceinline__ float silu_value(float g, float u) {
  return round_bf16(__fmul_rn(__fmul_rn(g, sigmoid_f64(g)), u));
}

// the prologue value of element i of one input row (bf16-exact); `rms`
// from rms_scale for PRO_RMS
template <int PRO, typename TIn>
__device__ __forceinline__ float pro_value(const TIn* xr, int i, int din, float rms,
                                           const __nv_bfloat16* gamma) {
  if (PRO == PRO_NONE) return ld_f(xr, i);
  if (PRO == PRO_RMS) return rms_value(ld_f(xr, i), rms, __bfloat162float(gamma[i]));
  return silu_value(ld_f(xr, i), ld_f(xr, (size_t)din + i));
}

// the two int8 digits of v, v ~= q1 s1 + q2 s2 (IEEE quotients, no FMA
// contraction: the plain version's roundings)
__device__ __forceinline__ void two_digits(float v, float s1, float s2, int* q1, int* q2) {
  const float a = fminf(fmaxf(rintf(v / s1), -127.f), 127.f);
  const float r = __fsub_rn(v, __fmul_rn(a, s1));
  *q1 = (int)a;
  *q2 = (int)fminf(fmaxf(rintf(r / s2), -127.f), 127.f);
}

// mma position of row rho inside its 32-row step (the inverse of
// rho(kappa) = 8 (kappa % 4) + 2 ((kappa % 16) / 4) + kappa / 16)
__device__ __forceinline__ int kappa_of(int rho) {
  return 16 * (rho & 1) + 4 * ((rho & 7) >> 1) + (rho >> 3);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 32-bit word at byte column col (a multiple of 4) of row r of a 128-byte
// wide tile written by TMA with 128-byte swizzle (16-byte chunk ^ (r & 7))
__device__ __forceinline__ uint32_t lds_sw(const uint8_t* tile, int r, int col) {
  return *reinterpret_cast<const uint32_t*>(
      tile + r * 128 + ((((col >> 4) ^ (r & 7)) << 4) | (col & 15)));
}

// 4 x 4 byte transpose: out[c] byte j = byte c of w[j]
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&out)[4]) {
  const uint32_t t01l = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t01h = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t23l = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t23h = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(t01l, t23l, 0x5410);
  out[1] = __byte_perm(t01l, t23l, 0x7632);
  out[2] = __byte_perm(t01h, t23h, 0x5410);
  out[3] = __byte_perm(t01h, t23h, 0x7632);
}

// The B fragments of one 32-row k step for both planes, 4 n8 tiles (n-tile
// q holds columns 4n + q of the warp's 32): rows 8j + 2t and 8j + 2t + 1 of
// the step (the k order the digits are stored in), column word cw + 4g.
__device__ __forceinline__ void w4_fragments(const uint8_t* st, int k0, int cw, int g, int t,
                                             uint32_t (&b0)[4], uint32_t (&b1)[4]) {
  uint32_t w0[4], w1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int rr = k0 + 8 * j + 2 * t;
    w0[j] = lds_sw(st, rr, cw + 4 * g);
    w1[j] = lds_sw(st, rr + 1, cw + 4 * g);
  }
  transpose4(w0, b0);
  transpose4(w1, b1);
}

__device__ __forceinline__ uint32_t lo_plane(uint32_t b) { return b & 0x0F0F0F0Fu; }
__device__ __forceinline__ uint32_t hi_plane(uint32_t b) {
  return (b & 0xF0F0F0F0u) ^ 0x80808080u;  // h16 = 16 (hi - 8) as s8
}

}  // namespace
