// W4A16 GEMV for M <= 32 rows (decode-shaped), for Hopper (sm_90a): K1.
//
// Replaces the TPU kernels vila_tpu/ops/quant.py:_w4_decode_manual_kernel
// and :_w4_decode_kernel (behind w4_matmul_decode): layer 0's qkv of a
// decode step, the untied lm_head, and prefill projections of prompts of at
// most 32 tokens. (The fused decode layers run their products on the tensor
// cores: K3 decode_layer_sm90.cu, K4/K5 w4_pair_sm90.cu, K6 w4_gemv_mma.cu.)
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
// and feeds __dp4a. Warp w takes rows 16w.. 16w + 15 of each group (a group
// is any multiple of 16 rows up to 128: 112 takes seven warps); the K
// dimension is further split over blocks
// (`ksplit`) until the grid has ~2 blocks per SM, and the last block of a
// column tile to finish sums the partials in a fixed order (deterministic)
// and writes the bf16 output.
// Each block expands the digits of its rows over the whole input row from
// L2, which at D=3584 is cheap next to the weight stream. For M > 1 a block
// takes 4 rows, so the weights are read once per 4 rows (the lm_head of the
// batched serving routes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w4_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;  // output columns per block: 32 lanes x 4

struct GemvArgs {
  const __nv_bfloat16* x;  // (M, din)
  const uint8_t* packed;        // (nj, din/2, bout) of the selected layer
  const __nv_bfloat16* scales;  // (nj, s_rows, bout) of the selected layer
  int M, din, dout, bout, s_rows, group;
  int ksplit, gps;  // K splits over blocks, groups per split
  float* ws;        // (ksplit, M, dout) partials when ksplit > 1
  int* counters;    // per (tile_x, tile_z) arrival counters, left zeroed
  __nv_bfloat16* out;  // (M, dout)
};

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

__device__ __forceinline__ void epilogue(const GemvArgs& a, int m, int col, float v) {
  a.out[(size_t)m * a.dout + col] = __float2bfloat16_rn(v);
}

template <int NR>
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

  // ---- each row's amax over the whole row, digits for this split
  for (int r = 0; r < rows; ++r) {
    const __nv_bfloat16* xr = a.x + (size_t)(m0 + r) * a.din;
    float am_lo = 0.f, am_hi = 0.f;
    for (int i = tid; i < a.din; i += kThreads) {
      const float v = fabsf(__bfloat162float(xr[i]));
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
        const float v = __bfloat162float(xr[p * half + g0 * a.group + t]);
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

  float acc[NR][4];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  if (col_ok && warp * 16 < a.group) {  // (warp 7 has no band of a group of 112)
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
      const int ibase = g * a.group + warp * 16, tbase = (g - g0) * a.group + warp * 16;
#pragma unroll
      for (int s = 0; s < 16; s += 4) {
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

template <int NR>
cudaError_t launch(const GemvArgs& a, cudaStream_t stream) {
  const dim3 grid((a.dout + kTileN - 1) / kTileN, a.ksplit, (a.M + NR - 1) / NR);
  const size_t smem = (size_t)NR * 4 * a.gps * a.group;
  auto kernel = w4_gemv_kernel<NR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): x (M, din) bf16, packed (nj,
// din/2, bout) uint8 and scales (nj, s_rows, bout) bf16 of the selected
// layer, groups of `group` input rows (a multiple of 16 up to 128); out (M, dout)
// bf16; ws (ksplit, M, dout) f32 when ksplit > 1; counters zeroed ints.
// Returns cudaGetLastError() after the launch.
extern "C" int w4_gemv(const void* x, const void* packed, const void* scales, int M, int din,
                       int dout, int bout, int s_rows, int group, int ksplit, int gps, void* ws,
                       void* counters, void* out, void* stream) {
  if (M < 1 || M > 32 || group < 16 || group > 16 * kWarps || group % 16 ||
      din % (2 * group) || bout % 4 || ksplit < 1 || gps < 1 || (ksplit > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  GemvArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
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
  a.out = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return M == 1 ? (int)launch<1>(a, s) : (int)launch<4>(a, s);
}
