// W4A16 GEMV for up to 32 rows on the tensor cores, for Hopper (sm_90a):
// the four products of the batched decode layer K6, a port of
// vila_tpu/ops/fused_decode.py:_fused_layer_b_kernel (pallas_call :1447)
// whose weight stream is the decode kernel vila_tpu/ops/quant.py:
// _w4_decode_kernel. Two launches per product:
//
//   w4_digits     the prologue for the M rows, once per product: the input
//                 value (as it is, RMSNorm(gamma) of an f32/bf16 row, or
//                 SiLU(gate)*up of a (gate | up) bf16 row, rounded to bf16:
//                 w4_common.cuh's definition, bit for bit the plain
//                 version's), each half-plane's amax,
//                 the two int8 digits x ~= q1*s1 + q2*s2 (s1 = amax/127,
//                 s2 = s1/127, round half even: of its own values, bit for
//                 bit quant._digits and the JAX package's _int8_digits /
//                 _prequantize_plane) and the per-(row, group) digit sums
//                 of the lo plane. Each group (a multiple of 16 input rows,
//                 up to 128) is stored padded with zero digits to gp, the
//                 next multiple of 32 (quant.padded_group). On request it
//                 also writes the values.
//                 One block of 1024 threads per row; the row's values stay
//                 in shared memory between the amax and the digits.
//   w4_gemv_rows  one weight pass for all rows: the (row, digit) pairs are
//                 the A rows of mma.sync m16n8k32 s8 x s8 -> s32 (8 rows,
//                 16 pairs, per m16 tile); each packed byte tile gives the
//                 B fragments of both planes (lo = p & 0x0F, h16 = (p & 0xF0)
//                 ^ 0x80 == 16 * (hi - 8)), so both planes come from one load.
//                 Each group of input rows is summed whole in int32
//                 (|sum| < 2^21), corrected for the lo plane's -8 zero point
//                 with the group digit sum and scaled in f32 per (row, group,
//                 column): the order of quant._w4_gemv_ref.
//
// Bound on this card: bytes. At M = 8 a weight byte feeds 4 * 8 int8
// operations, far below the ~600 ops/byte where the int8 tensor cores
// would bound, so the least time is (packed + scales) / 3.35 TB/s.
//
// Design of w4_gemv_rows. A CTA owns 128 output columns (inside one bout
// block of the tiled layout) and a run of whole groups; the host takes the
// fewest K splits that give one CTA per SM (more, shorter CTAs measured
// slower: each CTA's start and each split's partial cost more than they
// hide). One producer warp keeps a 4-stage mbarrier ring full: per group, a
// TMA copy of its gp x 128 packed bytes (a 3-D map over the (nj, din/2,
// bout) slab; gp = the group padded to a multiple of 32: the rows past the
// group meet zero digits, and past the slab TMA fills zeros) and one of the
// group's digits (a 2-D map over the (plane, digit, row) x ngh * gp buffer),
// both with 128-byte swizzle, and
// bulk copies of its two scale rows and its digit sums, so the consumers
// read every operand from shared memory. Four consumer warps own 32
// columns each. mma.sync wants, per thread, 4 consecutive k of one column
// in a register; the bytes lie column-contiguous, so each thread reads one
// 32-bit word (4 columns) from 4 rows and transposes the 4 x 4 bytes
// (__byte_perm, as w4_gemv_sm90.cu). The four columns of a word go to four n8
// tiles (n-tile q holds columns 4n + q), and the k order inside each
// 32-row step is permuted so that the 4 rows a thread reads differ in
// (row & 7) by thread, which with the swizzle leaves no bank conflict: mma
// position kappa = 4t + j holds row 8j + 2t, kappa = 16 + 4t + j row 8j +
// 2t + 1. w4_digits writes the digits in that order, so each A fragment is
// one 32-bit load. The m16 tiles are walked one at a time and the f32 sums
// kept in shared memory, so registers do not grow with the rows. Split-K
// partials are summed by the last CTA of a column tile in split order
// (deterministic), which applies the epilogue: + f32 or bf16 residual,
// + bf16 bias, f32 and/or bf16 output.

#include <cuda_bf16.h>

#include "sm90_common.cuh"
#include "w4_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kGroup = 128;                   // the largest group: input rows per stage
constexpr int kTileN = 128;                   // output columns per CTA
constexpr int kConsumers = 4;                 // warps of 32 columns
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int kStages = 4;
constexpr int kStageBytes = kGroup * kTileN;  // 16 KB
constexpr int kDigitThreads = 1024;

// ---------------------------------------------------------------------------
// w4_digits
// ---------------------------------------------------------------------------

__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float t = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, t) : v + t;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kDigitThreads / 32; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// Block m (of m_pad): row m of x. digits (2 planes, 2 digits, m_pad, din/2)
// int8 in mma order, dscale (m_pad, plane, digit) f32, gsum (ngh, digit,
// m_pad) int32 (lo plane); rows m >= M are zeros.
template <int PRO, typename TIn>
__global__ void __launch_bounds__(kDigitThreads) w4_digits_kernel(
    const TIn* __restrict__ x, int ldx, const bf16* __restrict__ gamma, float eps, int M,
    int din, int group, int8_t* __restrict__ digits, float* __restrict__ dscale,
    int* __restrict__ gsum, bf16* __restrict__ vout) {
  extern __shared__ float sv[];  // the row's din prologue values
  __shared__ float red[kDigitThreads / 32];
  __shared__ double red64[kDigitThreads / 32];
  const int m = blockIdx.x, m_pad = gridDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int half = din / 2, ngh = half / group, gp = (group + 31) & ~31, hp = ngh * gp;
  // plane p, digit d of this row at dm + (2 p + d) * plane
  int8_t* dm = digits + (size_t)m * hp;
  const size_t plane = (size_t)m_pad * hp;
  if (m >= M) {
    for (int i = tid; i < 4 * hp; i += kDigitThreads) dm[(i / hp) * plane + i % hp] = 0;
    if (tid < 4) dscale[m * 4 + tid] = 0.f;
    for (int i = tid; i < 2 * ngh; i += kDigitThreads) gsum[(size_t)i * m_pad + m] = 0;
    return;
  }
  const TIn* xr = x + (size_t)m * ldx;
  // pass 1: the prologue values into shared memory, each half-plane's amax
  float am_lo = 0.f, am_hi = 0.f;
  if (PRO == PRO_RMS) {
    double ss = 0.0;
#pragma unroll 4
    for (int i = tid; i < din; i += kDigitThreads) {
      const float v = ld_f(xr, i);
      sv[i] = v;
      ss += (double)v * (double)v;
    }
    const float rms = rms_scale(block_sum_f64<kDigitThreads / 32>(ss, red64), din, eps);
#pragma unroll 4
    for (int i = tid; i < din; i += kDigitThreads) {  // (each thread its own elements)
      const float v = rms_value(sv[i], rms, __bfloat162float(gamma[i]));
      sv[i] = v;
      if (i < half) am_lo = fmaxf(am_lo, fabsf(v)); else am_hi = fmaxf(am_hi, fabsf(v));
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < din; i += kDigitThreads) {
      const float v = pro_value<PRO>(xr, i, din, 1.0f, gamma);
      sv[i] = v;
      if (i < half) am_lo = fmaxf(am_lo, fabsf(v)); else am_hi = fmaxf(am_hi, fabsf(v));
    }
  }
  am_lo = block_reduce(am_lo, true, red);  // (its barriers also publish sv)
  am_hi = block_reduce(am_hi, true, red);
  if (vout)  // the prologue values themselves, when asked for (checks)
    for (int i = tid; i < din; i += kDigitThreads)
      vout[(size_t)m * din + i] = __float2bfloat16_rn(sv[i]);
  const float s1l = fmaxf(am_lo / 127.0f, 1e-20f), s1h = fmaxf(am_hi / 127.0f, 1e-20f);
  const float s2l = s1l / 127.0f, s2h = s1h / 127.0f;
  if (tid == 0) {
    dscale[m * 4 + 0] = s1l;
    dscale[m * 4 + 1] = s2l;
    dscale[m * 4 + 2] = s1h;
    dscale[m * 4 + 3] = s2h;
  }
  // pass 2: one warp per (group, plane): a lane's digits go to their mma
  // positions in the lane's 32-block (one 32-byte segment per store), zero
  // digits past the group's end, and the lo plane's group sums are reduced
  // across the warp
  for (int gg = warp; gg < 2 * ngh; gg += kDigitThreads / 32) {
    const int p = gg >= ngh, gi = gg - p * ngh;
    const float s1 = p ? s1h : s1l, s2 = p ? s2h : s2l;
    int a = 0, b = 0;
    for (int b4 = 0; b4 < gp / 32; ++b4) {
      const int e = b4 * 32 + lane, ii = gi * gp + b4 * 32;
      int q1 = 0, q2 = 0;
      if (e < group) two_digits(sv[p * half + gi * group + e], s1, s2, &q1, &q2);
      dm[(2 * p) * plane + ii + kappa_of(lane)] = (int8_t)q1;
      dm[(2 * p + 1) * plane + ii + kappa_of(lane)] = (int8_t)q2;
      a += q1;
      b += q2;
    }
    if (p == 0) {  // warp-uniform
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      if (lane == 0) {
        gsum[((size_t)gi * 2 + 0) * m_pad + m] = a;
        gsum[((size_t)gi * 2 + 1) * m_pad + m] = b;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// w4_gemv_rows
// ---------------------------------------------------------------------------

struct RowsArgs {
  const int* gsum;     // (ngh, 2, m_pad)
  const float* dscale; // (m_pad, 2, 2)
  const bf16* scales;  // (nj, s_rows, bout) of the selected layer
  int M, m_pad, half, dout, bout, s_rows, group, gp, ngh, ksplit, gps;
  float* ws;      // (ksplit, M, dout) partials when ksplit > 1
  int* counters;  // per column tile, left zeroed
  const float* res_f32;
  const bf16* res_bf16;
  const bf16* bias;
  float* out_f32;
  bf16* out_bf16;
};

// one ring stage: packed weights (gp <= 128 rows x 128 columns), the
// group's digits ((plane, digit, row) x 128 k: a box as wide as the
// swizzle, of which the first gp are the group's), its scale rows (lo, hi:
// 128 bf16 each) and digit sums ((digit, row) int32), each by one copy
__host__ __device__ constexpr int stage_digits(int m_pad) { return 4 * m_pad * kGroup; }
__host__ __device__ constexpr int stage_scales(int m_pad) { return kStageBytes + stage_digits(m_pad); }
__host__ __device__ constexpr int stage_gsum(int m_pad) { return stage_scales(m_pad) + 2 * kTileN * 2; }
// bytes a stage receives: the weight box has gp rows
__host__ __device__ constexpr int stage_tx(int m_pad, int gp) {
  return stage_gsum(m_pad) + 2 * m_pad * 4 - (kGroup - gp) * kTileN;
}
__host__ __device__ constexpr int stage_bytes(int m_pad) {
  return (stage_tx(m_pad, kGroup) + 1023) & ~1023;
}
__host__ __device__ constexpr int rows_smem(int m_pad) {
  return 1024 + kStages * stage_bytes(m_pad) + 2 * kStages * 8;
}

// A fragments of one plane at k-step column col: digit 0 of row r (A row g)
// at shared row r0, digit 1 (A row g + 8) m_pad rows further
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const uint8_t* dig, int r0, int m_pad,
                                       int col) {
  f[0] = lds_sw(dig, r0, col);
  f[1] = lds_sw(dig, r0 + m_pad, col);
  f[2] = lds_sw(dig, r0, col + 16);
  f[3] = lds_sw(dig, r0 + m_pad, col + 16);
}

__device__ __forceinline__ void epilogue(const RowsArgs& a, int m, int col, float v) {
  const size_t o = (size_t)m * a.dout + col;
  if (a.res_f32) v = a.res_f32[o] + v;
  if (a.res_bf16) v = __bfloat162float(a.res_bf16[o]) + v;
  if (a.bias) v = v + __bfloat162float(a.bias[col]);
  if (a.out_f32) a.out_f32[o] = v;
  if (a.out_bf16) a.out_bf16[o] = __float2bfloat16_rn(v);
}

// Grid (column tiles, splits). MT = m_pad / 8 m16 tiles: rows 8 tau .. 8 tau
// + 7, the pair (row, digit d) at A row g + 8 d.
template <int MT>
__global__ void __launch_bounds__(kThreads, MT <= 2 ? 2 : 1) w4_gemv_rows_kernel(
    const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_d,
    RowsArgs a) {
  constexpr int kMPad = 8 * MT, kStage = stage_bytes(kMPad);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;
  __shared__ int s_last;
  __shared__ float s_sd[kMPad * 4];  // the rows' digit scales: s1 lo, s2 lo, s1 hi, s2 hi
  // the f32 sums, [warp][m tile][n tile q * 2 + e][lane]: in shared memory so
  // that the registers do not grow with the rows
  __shared__ float s_acc[kConsumers][MT][8][32];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile_x = blockIdx.x, split = blockIdx.y;
  const int n0 = tile_x * kTileN;
  const int jb = n0 / a.bout, oo0 = n0 % a.bout;
  const int g0 = split * a.gps, ng = min(a.ngh, g0 + a.gps) - g0;
  for (int i = tid; i < kMPad * 4; i += kThreads) s_sd[i] = a.dscale[i];
  for (int i = tid; i < kConsumers * MT * 8 * 32; i += kThreads) (&s_acc[0][0][0][0])[i] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const int cw = warp * 32;  // the warp's first column in the tile
  if (warp == kConsumers) {  // producer
    if (lane == 0) {
      const bf16* srow = a.scales + (size_t)jb * a.s_rows * a.bout + oo0;
      for (int i = 0; i < ng; ++i) {
        const int s = i % kStages, gi = g0 + i;
        uint8_t* st = ring + s * kStage;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], stage_tx(kMPad, a.gp));
        tma_load_3d(st, &tm_w, &full[s], oo0, gi * a.group, jb);
        tma_load_2d(st + kStageBytes, &tm_d, &full[s], gi * a.gp, 0);
        bulk_load(st + stage_scales(kMPad), srow + (size_t)gi * a.bout, kTileN * 2, &full[s]);
        bulk_load(st + stage_scales(kMPad) + kTileN * 2, srow + (size_t)(a.ngh + gi) * a.bout,
                  kTileN * 2, &full[s]);
        bulk_load(st + stage_gsum(kMPad), a.gsum + (size_t)gi * 2 * kMPad, 2 * kMPad * 4,
                  &full[s]);
      }
    }
  } else {
    for (int i = 0; i < ng; ++i) {
      const int s = i % kStages;
      const uint8_t* st = ring + s * kStage;
      const uint8_t* dig = st + kStageBytes;
      mbar_wait(&full[s], (i / kStages) & 1);
      // this thread's 8 columns' scales (lo, and hi / 16)
      const bf16* sc = reinterpret_cast<const bf16*>(st + stage_scales(kMPad)) + cw + 8 * t;
      const int* gs = reinterpret_cast<const int*>(st + stage_gsum(kMPad));
      float sl[8], sh[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        sl[c] = __bfloat162float(sc[c]);
        sh[c] = __bfloat162float(sc[kTileN + c]) / 16.0f;
      }
      // one m tile at a time (its int sums live for one group)
#pragma unroll 1
      for (int tau = 0; tau < MT; ++tau) {
        const int r = 8 * tau + g;
        int ilo[4][4], ihi[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) ilo[q][e] = ihi[q][e] = 0;
#pragma unroll 4
        for (int ks = 0; ks < a.gp / 32; ++ks) {
          uint32_t alo[4], ahi[4];
          load_a(alo, dig, r, kMPad, ks * 32 + 4 * t);           // plane lo
          load_a(ahi, dig, 2 * kMPad + r, kMPad, ks * 32 + 4 * t);  // plane hi
          uint32_t b0[4], b1[4];
          w4_fragments(st, ks * 32, cw, g, t, b0, b1);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            mma_s8(ilo[q], alo, lo_plane(b0[q]), lo_plane(b1[q]));
            mma_s8(ihi[q], ahi, hi_plane(b0[q]), hi_plane(b1[q]));
          }
        }
        // whole-group integer sums -> f32, per (row, group, column)
        const int gs0 = gs[r], gs1 = gs[kMPad + r];
        const float* sd = s_sd + r * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 4 * e + q;  // column cw + 8t + 4e + q
            float v = s_acc[warp][tau][2 * q + e][lane];
            v += (float)(ilo[q][e] - 8 * gs0) * (sd[0] * sl[c]);
            v += (float)(ilo[q][2 + e] - 8 * gs1) * (sd[1] * sl[c]);
            v += (float)ihi[q][e] * (sd[2] * sh[c]);
            v += (float)ihi[q][2 + e] * (sd[3] * sh[c]);
            s_acc[warp][tau][2 * q + e][lane] = v;
          }
      }
      __syncwarp();
      mbar_arrive_if(&empty[s], lane == 0);  // the warp's reads of the stage are done
    }
#pragma unroll
    for (int tau = 0; tau < MT; ++tau) {
      const int r = 8 * tau + g;
      if (r >= a.M) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + cw + 8 * t + 4 * e + q;
          const float v = s_acc[warp][tau][2 * q + e][lane];
          if (a.ksplit == 1)
            epilogue(a, r, col, v);
          else
            a.ws[((size_t)split * a.M + r) * a.dout + col] = v;
        }
    }
  }
  if (a.ksplit == 1) return;

  // split-K: the last CTA of the column tile sums the partials in split order
  __syncwarp();  // the producer warp's lanes wait for its lane 0
  __threadfence();
  __syncthreads();
  int* counter = a.counters + tile_x;
  if (tid == 0) s_last = (atomicAdd(counter, 1) == a.ksplit - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // four columns a thread, eight splits' loads in flight, summed in order
  const size_t split_stride = (size_t)a.M * a.dout;
  for (int idx = tid; idx < a.M * kTileN / 4; idx += kThreads) {
    const int r = idx / (kTileN / 4), col = n0 + 4 * (idx % (kTileN / 4));
    const float* src = a.ws + (size_t)r * a.dout + col;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < a.ksplit; sp0 += 8) {
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (sp0 + u < a.ksplit)
          x[u] = __ldcg(reinterpret_cast<const float4*>(src + (sp0 + u) * split_stride));
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (sp0 + u < a.ksplit) {
          v.x += x[u].x;
          v.y += x[u].y;
          v.z += x[u].z;
          v.w += x[u].w;
        }
    }
    epilogue(a, r, col, v.x);
    epilogue(a, r, col + 1, v.y);
    epilogue(a, r, col + 2, v.z);
    epilogue(a, r, col + 3, v.w);
  }
  if (tid == 0) *counter = 0;  // leave the counters zeroed for the next launch
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <int PRO, typename TIn>
int launch_digits(const void* x, int ldx, const void* gamma, float eps, int M, int m_pad,
                  int din, int group, void* digits, void* dscale, void* gsum, void* vout,
                  cudaStream_t s) {
  static int granted = 0;
  const int smem = din * 4;
  auto kernel = w4_digits_kernel<PRO, TIn>;
  const int st = allow_smem((const void*)kernel, smem, &granted);
  if (st) return st;
  kernel<<<m_pad, kDigitThreads, smem, s>>>(
      static_cast<const TIn*>(x), ldx, static_cast<const bf16*>(gamma), eps, M, din, group,
      static_cast<int8_t*>(digits), static_cast<float*>(dscale), static_cast<int*>(gsum),
      static_cast<bf16*>(vout));
  return (int)cudaGetLastError();
}

template <int MT>
int launch_rows(const CUtensorMap& tw, const CUtensorMap& td, const RowsArgs& a,
                cudaStream_t s) {
  static int granted = 0;
  const int smem = rows_smem(8 * MT);
  const int st = allow_smem((const void*)w4_gemv_rows_kernel<MT>, smem, &granted);
  if (st) return st;
  const dim3 grid(a.dout / kTileN, a.ksplit);
  w4_gemv_rows_kernel<MT><<<grid, kThreads, smem, s>>>(tw, td, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes); each returns cudaGetLastError()
// or cudaErrorInvalidValue for what it does not take.
//
// w4_digits: x holds M rows (ldx apart) of din values (SiLU: gate | up, 2 din
// values); groups of `group` input rows (a multiple of 16, at most 128),
// ngh = din / 2 / group of them a plane, each padded to gp (the next
// multiple of 32); m_pad = 8 * ceil(M / 8) blocks write digits (2, 2, m_pad,
// ngh * gp) int8, dscale (m_pad, 2, 2) f32, gsum (ngh, 2, m_pad) int32 and,
// when vout is not null, the M rows' bf16 prologue values (M, din).
extern "C" int w4_digits(const void* x, int x_is_f32, int ldx, int prologue,
                         const void* gamma, float eps, int M, int m_pad, int din, int group,
                         void* digits, void* dscale, void* gsum, void* vout, void* stream) {
  if (M < 1 || m_pad < M || m_pad > 32 || m_pad % 8 || group < 16 || group > kGroup ||
      group % 16 || din % (2 * group) || din * 4 > kMaxDynSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prologue == PRO_NONE && !x_is_f32)
    return launch_digits<PRO_NONE, bf16>(x, ldx, gamma, eps, M, m_pad, din, group, digits,
                                         dscale, gsum, vout, s);
  if (prologue == PRO_RMS && !x_is_f32)
    return launch_digits<PRO_RMS, bf16>(x, ldx, gamma, eps, M, m_pad, din, group, digits,
                                        dscale, gsum, vout, s);
  if (prologue == PRO_RMS && x_is_f32)
    return launch_digits<PRO_RMS, float>(x, ldx, gamma, eps, M, m_pad, din, group, digits,
                                         dscale, gsum, vout, s);
  if (prologue == PRO_SILU && !x_is_f32)
    return launch_digits<PRO_SILU, bf16>(x, ldx, gamma, eps, M, m_pad, din, group, digits,
                                         dscale, gsum, vout, s);
  return (int)cudaErrorInvalidValue;
}

// w4_gemv_rows: packed (nj, din/2, bout) uint8 and scales (nj, s_rows, bout)
// bf16 of the selected layer, groups of `group` input rows (a multiple of
// 16, at most 128); w4_digits' buffers for m_pad rows; grid of dout / 128
// column tiles x ksplit splits of gps groups; ws (ksplit, M, dout) f32 when
// ksplit > 1; counters dout / 128 zeroed ints.
extern "C" int w4_gemv_rows(const void* digits, const void* dscale, const void* gsum,
                            const void* packed, const void* scales, int M, int m_pad, int din,
                            int dout, int bout, int s_rows, int group, int ksplit, int gps,
                            void* ws, void* counters, const void* res_f32,
                            const void* res_bf16, const void* bias, void* out_f32,
                            void* out_bf16, void* stream) {
  if (group < 16 || group > kGroup || group % 16 || din % (2 * group))
    return (int)cudaErrorInvalidValue;
  const int half = din / 2, ngh = half / group, gp = (group + 31) & ~31;
  if (M < 1 || m_pad < M || m_pad > 32 || m_pad % 8 || bout % kTileN ||
      dout % bout || ksplit < 1 || gps < 1 || (ksplit - 1) * gps >= ngh || ksplit * gps < ngh ||
      (ksplit > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorSharedObjectInitFailed;
  // the packed slab as (bout, half, nj) bytes, gp rows a box, and the padded
  // digits as (ngh * gp, 4 m_pad)
  CUtensorMap tw, td;
  const cuuint64_t wdims[3] = {(cuuint64_t)bout, (cuuint64_t)half, (cuuint64_t)(dout / bout)};
  const cuuint64_t wstrides[2] = {(cuuint64_t)bout, (cuuint64_t)half * bout};
  const cuuint32_t wbox[3] = {kTileN, (cuuint32_t)gp, 1};
  const cuuint64_t ddims[2] = {(cuuint64_t)ngh * gp, (cuuint64_t)(4 * m_pad)};
  const cuuint64_t dstrides[1] = {(cuuint64_t)ngh * gp};
  const cuuint32_t dbox[2] = {kGroup, (cuuint32_t)(4 * m_pad)};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (enc(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(packed), wdims, wstrides,
          wbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      enc(&td, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(digits), ddims, dstrides,
          dbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  RowsArgs a;
  a.gsum = static_cast<const int*>(gsum);
  a.dscale = static_cast<const float*>(dscale);
  a.scales = static_cast<const bf16*>(scales);
  a.M = M;
  a.m_pad = m_pad;
  a.half = half;
  a.dout = dout;
  a.bout = bout;
  a.s_rows = s_rows;
  a.group = group;
  a.gp = gp;
  a.ngh = ngh;
  a.ksplit = ksplit;
  a.gps = gps;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.res_f32 = static_cast<const float*>(res_f32);
  a.res_bf16 = static_cast<const bf16*>(res_bf16);
  a.bias = static_cast<const bf16*>(bias);
  a.out_f32 = static_cast<float*>(out_f32);
  a.out_bf16 = static_cast<bf16*>(out_bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m_pad / 8) {
    case 1: return launch_rows<1>(tw, td, a, s);
    case 2: return launch_rows<2>(tw, td, a, s);
    case 3: return launch_rows<3>(tw, td, a, s);
    case 4: return launch_rows<4>(tw, td, a, s);
  }
  return (int)cudaErrorInvalidValue;
}
