// W4A16 GEMV for M <= 32 rows (decode-shaped), for Hopper (sm_90a).
//
// Replaces the TPU kernels vila_tpu/ops/quant.py:_w4_decode_manual_kernel
// and :_w4_decode_kernel (behind w4_matmul_decode), and provides the four
// weight streams of vila_tpu/ops/fused_decode.py:_fused_layer_kernel
// through the prologue/epilogue variants below.
//
// Arithmetic (identical to the TPU kernels, so greedy transcripts agree):
//   * each activation row is expanded per half-plane into two int8 digits,
//     x ~= q1*s1 + q2*s2 with s1 = amax/127, s2 = s1/127 (round half even);
//   * packed byte [i, o] holds w[i, o] in the low nibble and w[i+din/2, o]
//     in the high nibble; lo = p & 0x0F in [0,15] (weight lo-8), h16 =
//     (p & 0xF0) ^ 0x80 == 16*(hi-8) as int8, both used as s8 in __dp4a;
//   * the lo plane's -8 zero point is corrected with the group row sum of
//     the digits, the hi plane's scale is divided by 16;
//   * per (row, group) the int32 dot products are scaled in f32.
//
// Bound on this card: bytes. At M=1 a weight byte feeds ~2 int ops, far
// below the ~300 ops/byte where an H100 stops being memory-bound, so the
// least time is (packed + scales) / 3.35 TB/s. The design streams the
// packed bytes once, coalesced: a warp reads 128 consecutive bytes of a
// weight row (4 output columns per thread, one 32-bit load per row), four
// rows at a time, transposes the 4x4 byte tile in registers (__byte_perm)
// and feeds __dp4a. Eight warps split each 128-row group; the K dimension
// is further split over blocks (`ksplit`) until the grid has ~2 blocks per
// SM, and the last block of a column tile to finish sums the partials in a
// fixed order (deterministic) and applies the epilogue. Each block redoes
// the per-row prologue (norm statistics, amax) over the whole input row
// from L2, which at D=3584 is cheap next to the weight stream.
//
// Variants (template arguments):
//   prologue: none | RMSNorm(gamma) of an f32/bf16 row | SiLU(gate)*up of
//             a (gate | up) bf16 row, each rounded to bf16 before the digit
//             expansion, as the TPU kernel does;
//   epilogue: + f32 or bf16 residual, + bf16 bias, f32 and/or bf16 output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;  // output columns per block: 32 lanes x 4

enum { PRO_NONE = 0, PRO_RMS = 1, PRO_SILU = 2 };

struct GemvArgs {
  const void* x;  // (M, ldx) prologue input, bf16 or f32
  int ldx;
  const __nv_bfloat16* gamma;  // (din,) RMSNorm scale
  float eps;
  const uint8_t* packed;        // (nj, din/2, bout) of the selected layer
  const __nv_bfloat16* scales;  // (nj, s_rows, bout) of the selected layer
  int M, din, dout, bout, s_rows, group;
  int ksplit, gps;  // K splits over blocks, groups per split
  float* ws;        // (ksplit, M, dout) partials when ksplit > 1
  int* counters;    // per (tile_x, tile_z) arrival counters, left zeroed
  const float* res_f32;
  const __nv_bfloat16* res_bf16;
  const __nv_bfloat16* bias;
  float* out_f32;
  __nv_bfloat16* out_bf16;
};

__device__ __forceinline__ float ld_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float t = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, t) : v + t;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// Prologue value of element i of one input row (already bf16-exact).
template <int PRO, typename TIn>
__device__ __forceinline__ float pro_value(const TIn* xr, int i, int din,
                                           float rms, const __nv_bfloat16* gamma) {
  if (PRO == PRO_NONE) return ld_f(xr, i);
  if (PRO == PRO_RMS)
    return round_bf16(__fmul_rn(__fmul_rn(ld_f(xr, i), rms), __bfloat162float(gamma[i])));
  const float g = ld_f(xr, i);
  const float u = ld_f(xr, (size_t)din + i);
  const float sig = 1.0f / (1.0f + expf(-g));
  return round_bf16(__fmul_rn(__fmul_rn(g, sig), u));
}

__device__ __forceinline__ void epilogue(const GemvArgs& a, int m, int col, float v) {
  const size_t o = (size_t)m * a.dout + col;
  if (a.res_f32) v = a.res_f32[o] + v;
  if (a.res_bf16) v = __bfloat162float(a.res_bf16[o]) + v;
  if (a.bias) v = v + __bfloat162float(a.bias[col]);
  if (a.out_f32) a.out_f32[o] = v;
  if (a.out_bf16) a.out_bf16[o] = __float2bfloat16_rn(v);
}

template <int NR, int PRO, typename TIn>
__global__ void __launch_bounds__(kThreads) w4_gemv_kernel(GemvArgs a) {
  extern __shared__ __align__(16) int8_t qs[];  // [NR][plane][digit][kr]
  __shared__ float red[kWarps];
  __shared__ float s_scale[NR][2][2];           // [row][plane][digit]
  __shared__ float s_part[kWarps][NR][kTileN];  // cross-warp reduction
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = a.din / 2;
  const int ngh = half / a.group;
  const int tile_x = blockIdx.x, split = blockIdx.y, tile_z = blockIdx.z;
  const int m0 = tile_z * NR;
  const int rows = min(NR, a.M - m0);
  const int g0 = split * a.gps, g1 = min(ngh, g0 + a.gps);
  const int kr = a.gps * a.group;  // digit row length per plane in smem
  const int span = (g1 - g0) * a.group;

  // ---- prologue: per-row stats over the whole row, digits for this split
  for (int r = 0; r < rows; ++r) {
    const TIn* xr = reinterpret_cast<const TIn*>(a.x) + (size_t)(m0 + r) * a.ldx;
    float rms = 1.0f;
    if (PRO == PRO_RMS) {
      float ss = 0.f;
      for (int i = tid; i < a.din; i += kThreads) {
        const float v = ld_f(xr, i);
        ss += v * v;
      }
      ss = block_reduce(ss, false, red);
      rms = 1.0f / sqrtf(ss / (float)a.din + a.eps);
    }
    float am_lo = 0.f, am_hi = 0.f;
    for (int i = tid; i < a.din; i += kThreads) {
      const float v = fabsf(pro_value<PRO>(xr, i, a.din, rms, a.gamma));
      if (i < half) am_lo = fmaxf(am_lo, v); else am_hi = fmaxf(am_hi, v);
    }
    am_lo = block_reduce(am_lo, true, red);
    am_hi = block_reduce(am_hi, true, red);
    float s1[2], s2[2];
    s1[0] = fmaxf(am_lo / 127.0f, 1e-20f);
    s1[1] = fmaxf(am_hi / 127.0f, 1e-20f);
    s2[0] = s1[0] / 127.0f;
    s2[1] = s1[1] / 127.0f;
    if (tid == 0) {
      s_scale[r][0][0] = s1[0]; s_scale[r][0][1] = s2[0];
      s_scale[r][1][0] = s1[1]; s_scale[r][1][1] = s2[1];
    }
    for (int t = tid; t < span; t += kThreads) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float v = pro_value<PRO>(xr, p * half + g0 * a.group + t, a.din, rms, a.gamma);
        const float q1 = fminf(fmaxf(rintf(v / s1[p]), -127.f), 127.f);
        const float res = __fsub_rn(v, __fmul_rn(q1, s1[p]));
        const float q2 = fminf(fmaxf(rintf(res / s2[p]), -127.f), 127.f);
        qs[((r * 2 + p) * 2 + 0) * kr + t] = (int8_t)q1;
        qs[((r * 2 + p) * 2 + 1) * kr + t] = (int8_t)q2;
      }
    }
  }
  __syncthreads();

  // ---- weight stream: 4 columns per lane, warps split each group's rows
  const int col = tile_x * kTileN + lane * 4;
  const bool col_ok = col < a.dout;
  const int jb = col_ok ? col / a.bout : 0;
  const int oo = col_ok ? col % a.bout : 0;
  const uint8_t* pcol = a.packed + (size_t)jb * half * a.bout + oo;
  const __nv_bfloat16* scol = a.scales + (size_t)jb * a.s_rows * a.bout + oo;
  const int rpw = a.group / kWarps;  // rows per warp per group (multiple of 4)

  float acc[NR][4];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  if (col_ok) {
    for (int g = g0; g < g1; ++g) {
      int isum[NR][4][4];
      int cs[NR][2];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        cs[r][0] = cs[r][1] = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) isum[r][c][e] = 0;
      }
      const int ibase = g * a.group + warp * rpw;
      const int tbase = (g - g0) * a.group + warp * rpw;
#pragma unroll 4
      for (int s = 0; s < rpw; s += 4) {
        const uint8_t* prow = pcol + (size_t)(ibase + s) * a.bout;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(prow);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(prow + a.bout);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(prow + 2 * a.bout);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(prow + 3 * a.bout);
        // 4x4 byte transpose: wc[c] byte k = row s+k of column c
        const uint32_t t01l = __byte_perm(w0, w1, 0x5140);
        const uint32_t t01h = __byte_perm(w0, w1, 0x7362);
        const uint32_t t23l = __byte_perm(w2, w3, 0x5140);
        const uint32_t t23h = __byte_perm(w2, w3, 0x7362);
        uint32_t wc[4];
        wc[0] = __byte_perm(t01l, t23l, 0x5410);
        wc[1] = __byte_perm(t01l, t23l, 0x7632);
        wc[2] = __byte_perm(t01h, t23h, 0x5410);
        wc[3] = __byte_perm(t01h, t23h, 0x7632);
        int lo[4], hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] = (int)(wc[c] & 0x0F0F0F0Fu);
          hi[c] = (int)((wc[c] & 0xF0F0F0F0u) ^ 0x80808080u);
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          if (r < rows) {
            const int8_t* qb = qs + (size_t)(r * 4) * kr + tbase + s;
            const int x1l = *reinterpret_cast<const int*>(qb);
            const int x2l = *reinterpret_cast<const int*>(qb + kr);
            const int x1h = *reinterpret_cast<const int*>(qb + 2 * kr);
            const int x2h = *reinterpret_cast<const int*>(qb + 3 * kr);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              isum[r][c][0] = __dp4a(x1l, lo[c], isum[r][c][0]);
              isum[r][c][1] = __dp4a(x2l, lo[c], isum[r][c][1]);
              isum[r][c][2] = __dp4a(x1h, hi[c], isum[r][c][2]);
              isum[r][c][3] = __dp4a(x2h, hi[c], isum[r][c][3]);
            }
            cs[r][0] = __dp4a(x1l, 0x01010101, cs[r][0]);
            cs[r][1] = __dp4a(x2l, 0x01010101, cs[r][1]);
          }
        }
      }
      float sl[4], sh[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sl[c] = __bfloat162float(scol[(size_t)g * a.bout + c]);
        sh[c] = __bfloat162float(scol[(size_t)(ngh + g) * a.bout + c]) / 16.0f;
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r < rows) {
          const float s1l = s_scale[r][0][0], s2l = s_scale[r][0][1];
          const float s1h = s_scale[r][1][0], s2h = s_scale[r][1][1];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] += (float)(isum[r][c][0] - 8 * cs[r][0]) * (s1l * sl[c]);
            acc[r][c] += (float)(isum[r][c][1] - 8 * cs[r][1]) * (s2l * sl[c]);
            acc[r][c] += (float)isum[r][c][2] * (s1h * sh[c]);
            acc[r][c] += (float)isum[r][c][3] * (s2h * sh[c]);
          }
        }
      }
    }
  }

  // ---- cross-warp sum, then (split-K) cross-block sum, then epilogue
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s_part[warp][r][lane * 4 + c] = acc[r][c];
  __syncthreads();

  const int n0 = tile_x * kTileN;
  if (a.ksplit == 1) {
    for (int idx = tid; idx < NR * kTileN; idx += kThreads) {
      const int r = idx / kTileN, cc = idx % kTileN;
      if (r >= rows || n0 + cc >= a.dout) continue;
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += s_part[w][r][cc];
      epilogue(a, m0 + r, n0 + cc, v);
    }
    return;
  }
  for (int idx = tid; idx < NR * kTileN; idx += kThreads) {
    const int r = idx / kTileN, cc = idx % kTileN;
    if (r >= rows || n0 + cc >= a.dout) continue;
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += s_part[w][r][cc];
    a.ws[((size_t)split * a.M + m0 + r) * a.dout + n0 + cc] = v;
  }
  __threadfence();
  __syncthreads();
  int* counter = a.counters + tile_z * gridDim.x + tile_x;
  if (tid == 0) s_last = (atomicAdd(counter, 1) == a.ksplit - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int idx = tid; idx < NR * kTileN; idx += kThreads) {
    const int r = idx / kTileN, cc = idx % kTileN;
    if (r >= rows || n0 + cc >= a.dout) continue;
    float v = 0.f;
    for (int sp = 0; sp < a.ksplit; ++sp)
      v += __ldcg(a.ws + ((size_t)sp * a.M + m0 + r) * a.dout + n0 + cc);
    epilogue(a, m0 + r, n0 + cc, v);
  }
  if (tid == 0) *counter = 0;  // leave the counters zeroed for the next launch
}

template <int NR, int PRO, typename TIn>
cudaError_t launch(const GemvArgs& a, cudaStream_t stream) {
  const dim3 grid((a.dout + kTileN - 1) / kTileN, a.ksplit, (a.M + NR - 1) / NR);
  const size_t smem = (size_t)NR * 4 * a.gps * a.group;
  auto kernel = w4_gemv_kernel<NR, PRO, TIn>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NR>
cudaError_t dispatch(const GemvArgs& a, int prologue, int x_is_f32, cudaStream_t s) {
  if (prologue == PRO_NONE && !x_is_f32) return launch<NR, PRO_NONE, __nv_bfloat16>(a, s);
  if (prologue == PRO_RMS && !x_is_f32) return launch<NR, PRO_RMS, __nv_bfloat16>(a, s);
  if (prologue == PRO_RMS && x_is_f32) return launch<NR, PRO_RMS, float>(a, s);
  if (prologue == PRO_SILU && !x_is_f32) return launch<NR, PRO_SILU, __nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers may be null where the
// argument is optional. Returns cudaGetLastError() after the launch.
extern "C" int w4_gemv(const void* x, int x_is_f32, int ldx, int prologue,
                       const void* gamma, float eps, const void* packed,
                       const void* scales, int M, int din, int dout, int bout,
                       int s_rows, int group, int ksplit, int gps, void* ws,
                       void* counters, const void* res_f32, const void* res_bf16,
                       const void* bias, void* out_f32, void* out_bf16,
                       void* stream) {
  GemvArgs a;
  a.x = x;
  a.ldx = ldx;
  a.gamma = static_cast<const __nv_bfloat16*>(gamma);
  a.eps = eps;
  a.packed = static_cast<const uint8_t*>(packed);
  a.scales = static_cast<const __nv_bfloat16*>(scales);
  a.M = M;
  a.din = din;
  a.dout = dout;
  a.bout = bout;
  a.s_rows = s_rows;
  a.group = group;
  a.ksplit = ksplit;
  a.gps = gps;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.res_f32 = static_cast<const float*>(res_f32);
  a.res_bf16 = static_cast<const __nv_bfloat16*>(res_bf16);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.out_f32 = static_cast<float*>(out_f32);
  a.out_bf16 = static_cast<__nv_bfloat16*>(out_bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 1) return (int)dispatch<1>(a, prologue, x_is_f32, s);
  return (int)dispatch<4>(a, prologue, x_is_f32, s);
}
