// K1, the W4A16 GEMV for M <= 32 rows, for Hopper (sm_90a): the port of
// vila_tpu/ops/quant.py:_w4_decode_manual_kernel (pallas_call :384; grid
// form :349, behind w4_matmul_decode): layer 0's qkv of every decode step,
// the untied lm_head, and the projections of prompts of at most 32 tokens.
//
// Arithmetic (the TPU kernel's, so greedy transcripts agree): each input
// row is expanded per half-plane into two int8 digits, x ~= q1 s1 + q2 s2
// (s1 = amax / 127, s2 = s1 / 127, round half even), or, at act_digits = 1
// (the TPU kernel's static `act_digits`), into the first alone, x ~= q1 s1
// (~7 bits: the first digit of the two-digit expansion is the one-digit
// expansion, so the prologue is shared and the one-digit form skips the
// second digit's residual, its dots and its lo-plane group-sum
// correction; a template parameter ND, picked per launch); packed byte [i, o]
// holds w[i, o] in its low nibble and w[i + din/2, o] in its high one; the
// lo plane (p & 0x0F, weight + 8) and the h16 plane ((p & 0xF0) ^ 0x80 ==
// 16 (hi - 8) as s8) meet the digits in exact s8 x s8 -> s32 dots, each
// group of input rows summed whole in int32, the lo plane's +8 corrected by
// the group's digit sum, the hi plane's scale divided by 16, then scaled in
// f32 per (row, group, column) (quant._w4_gemv_ref). A group is any
// multiple of 16 rows up to 128 (112 at D = 896).
//
// Bound on this card: bytes. A packed byte feeds 4 M int8 multiply-adds,
// far below where the int8 tensor cores would bound at any M <= 32, so the
// least time is (packed + scales) / 3.35 TB/s: 0.085 ms for the NVILA-8B
// lm_head (272 MB) at any M. What the old kernel lost: it streamed the
// slab once per 4 rows on CUDA-core dp4a (integer throughput, not bytes,
// bound it at M > 1), and at M = 1 each thread held its bytes in flight in
// registers, so the bytes in flight per SM followed the register count.
// Two forms, chosen by a rule written once (quant.k1_form):
//
//   w4_gemv_wgmma  (M >= 2) one cooperative launch, one CTA per SM, built
//     from K4/K5's pieces (w4_persist.cuh): the digits and lo-plane group
//     sums of all rows are written once over the grid into an L2-resident
//     workspace (w4_gemv_rows' padded layout and k order, each row taken by
//     N / m_pad CTAs, its half-plane amax published), then one grid
//     barrier; a producer warp streams the CTA's weight tiles through an
//     mbarrier TMA ring from the launch's start, a second adds each stage's
//     digit tile once the barrier's count says the digits are written; the
//     group product runs on wgmma with the weights as the register A
//     operand and the (row, digit) pairs as N = 2 m_pad, so every weight
//     byte is read once for all rows. Column tiles that fill whole waves
//     are units of their own; the others are split over K (quant.unit_plan)
//     and their partials summed in split order after a second barrier.
//   w4_gemv_stream (M = 1) dp4a on the CUDA cores, whose rate is plenty
//     at one row: a producer warp keeps a ring of TMA boxes (one group of
//     rows by 128 bytes of columns, 8 stages: 128 KB an SM) in flight, so
//     the bytes in flight no longer follow the register count; each CTA
//     expands its row's digits once into shared memory, from the row it
//     loads before the weight stream starts (loads issued behind every
//     SM's first boxes waited ~10 us for them); eight consumer warps take
//     the ring's stages in turn, read 4 k rows x 4 bytes a thread,
//     transpose them (__byte_perm), run dp4a and add each group's
//     scaled sums to their own sums of the unit in shared memory, so no
//     warp waits for another at a unit's end. Persistent CTAs (one per SM)
//     walk (column span, K split) units; a span's splits are summed by its
//     last CTA to finish, in split order (no atomics on values).
//   w4_gemv_probe  on no path: the stream form's ring with consumers that
//     only sum the bytes, at 128- and 256-byte boxes, and a grid of plain
//     16-byte loads; it measures what this layout lets a stream reach (the
//     128-byte boxes beat the 256-byte ones on the H100; PERF.md).

#include <cuda_bf16.h>

#include "w4_persist.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ===========================================================================
// The stream form
// ===========================================================================

constexpr int kSWarps = 8;  // consumer warps
constexpr int kSConsumers = 32 * kSWarps;
constexpr int kSThreads = kSConsumers + 32;  // + the producer warp
constexpr int kSMaxStages = 16;
constexpr int kSMaxUnits = 16;  // units a CTA sums at once
constexpr int kSChunks = 10;    // 16-byte chunks of an input row a consumer holds
constexpr int kSMaxDin = 8 * kSConsumers * kSChunks;  // the stream form's longest row: 20480

struct StreamArgs {
  const bf16* x;          // (1, din)
  const bf16* scales;     // (nj, s_rows, bout) of the layer
  bf16* out;              // (1, dout)
  float* part;            // (ks, dout) when ks > 1
  int* counters;          // one a span, left zeroed
  unsigned* probe;        // the probe's byte sum a CTA (else null)
  int din, dout, bout, s_rows, group, half, ngh;
  int nfs, n_fspans, n_spans;  // whole spans a bout block, whole spans, spans
  int ks, gps, n_units;        // K splits, groups a split, units
  int stages, sbytes;
  int maxu;  // units a CTA sums at once (a round)
};

// unit u: span u % n_spans (bout block jb, columns o0.. of it, wv of them),
// split z = u / n_spans (groups g0..g1). The whole spans come first, block
// by block, then the narrower last span of each block where WBOX does not
// divide bout (dealt round-robin in this order, the CTAs' loads even out)
template <int WBOX>
__device__ __forceinline__ void span_of(const StreamArgs& a, int u, int& sp, int& jb, int& o0,
                                        int& wv, int& z, int& g0, int& g1) {
  sp = u % a.n_spans;
  z = u / a.n_spans;
  if (sp < a.n_fspans) {
    jb = sp / a.nfs;
    o0 = (sp - jb * a.nfs) * WBOX;
    wv = WBOX;
  } else {
    jb = sp - a.n_fspans;
    o0 = a.nfs * WBOX;
    wv = a.bout - o0;
  }
  g0 = z * a.gps;
  g1 = min(a.ngh, g0 + a.gps);
}

// The row's digits, once a CTA, into shared memory, for the groups its units
// take (the q2 words unwritten and unread at ND = 1):
// sdig[k4] = {q1 lo, q2 lo, q1 hi, q2 hi} of input rows 4 k4..
// 4 k4 + 3 of each half-plane (4 bytes a word, the dp4a operands), sgs[g]
// the lo plane's group digit sums (q1, q2), s_sd = s1, s2 of the lo plane,
// then of the hi (from the whole row's amax). xv holds the thread's 16-byte
// chunks of the row (elements 8 (tid + 256 j)..), loaded before the weight
// stream starts: loads issued behind every SM's first TMA boxes would wait
// for them.
template <int ND>
__device__ __forceinline__ void stream_digits(const StreamArgs& a, const uint4 (&xv)[kSChunks],
                                              int4* sdig, int* sgs, float* s_sd, float* red) {
  const int tid = threadIdx.x, gw = a.group / 4;
  unsigned need = 0;  // the K splits this CTA's units take
  for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) need |= 1u << (u / a.n_spans);
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int j = 0; j < kSChunks; ++j) {
    const int i = 8 * (tid + j * kSConsumers);
    const bf16* e = reinterpret_cast<const bf16*>(&xv[j]);
    float m = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) m = fmaxf(m, fabsf(__bfloat162float(e[q])));
    if (i < a.half) lo = fmaxf(lo, m); else hi = fmaxf(hi, m);  // (zeros past the row)
  }
  cons_max2<kSWarps>(lo, hi, red);
  if (tid == 0) {
    const float s1l = fmaxf(lo / 127.0f, 1e-20f), s1h = fmaxf(hi / 127.0f, 1e-20f);
    s_sd[0] = s1l;
    s_sd[1] = s1l / 127.0f;
    s_sd[2] = s1h;
    s_sd[3] = s1h / 127.0f;
  }
  csync<kSConsumers>();
#pragma unroll
  for (int j = 0; j < kSChunks; ++j) {
    const int i = 8 * (tid + j * kSConsumers);
    const int pl = i < a.half ? 0 : 1, ip = i - pl * a.half;
    if (i >= a.din || !((need >> (ip / a.group / a.gps)) & 1)) continue;
    const bf16* e = reinterpret_cast<const bf16*>(&xv[j]);
    uint32_t w1[2] = {0u, 0u}, w2[2] = {0u, 0u};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      int q1, q2 = 0;
      if (ND == 2)
        two_digits(__bfloat162float(e[q]), s_sd[2 * pl], s_sd[2 * pl + 1], &q1, &q2);
      else
        q1 = (int)first_digit(__bfloat162float(e[q]), s_sd[2 * pl]);
      w1[q >> 2] |= ((uint32_t)q1 & 0xFFu) << (8 * (q & 3));
      w2[q >> 2] |= ((uint32_t)q2 & 0xFFu) << (8 * (q & 3));
    }
    int* d = reinterpret_cast<int*>(sdig + ip / 4) + 2 * pl;
    d[0] = (int)w1[0];
    d[4] = (int)w1[1];
    if (ND == 2) {
      d[1] = (int)w2[0];
      d[5] = (int)w2[1];
    }
  }
  csync<kSConsumers>();
  for (int g = tid; g < a.ngh; g += kSConsumers) {  // a thread per group
    if (!((need >> (g / a.gps)) & 1)) continue;
    const int4* d = sdig + g * gw;
    int s1 = 0, s2 = 0;
    for (int k = 0; k < gw; ++k) {
      const int4 e = d[k];
      s1 = __dp4a(e.x, 0x01010101, s1);
      if (ND == 2) s2 = __dp4a(e.y, 0x01010101, s2);
    }
    sgs[2 * g] = s1;
    sgs[2 * g + 1] = s2;
  }
  csync<kSConsumers>();
}

// the integer dots of `rows` rows (a multiple of 4) of one group for the
// thread's column word: 4 rows x 4 bytes a step, transposed (byte j of
// wc[c] = row 4 k4 + j of column c; the second digit's at ND = 2 only)
template <int WBOX, int ND>
__device__ __forceinline__ void group_dp4a(const uint8_t* wp, int rows, const int4* dq,
                                           int (&isum)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) isum[c][e] = 0;
#pragma unroll 4
  for (int k4 = 0; k4 < rows / 4; ++k4) {
    uint32_t w[4], wc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const uint32_t*>(wp + (4 * k4 + j) * WBOX);
    transpose4(w, wc);
    const int4 d = dq[k4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int lo = (int)lo_plane(wc[c]), hi = (int)hi_plane(wc[c]);
      isum[c][0] = __dp4a(d.x, lo, isum[c][0]);
      isum[c][2] = __dp4a(d.z, hi, isum[c][2]);
      if (ND == 2) {
        isum[c][1] = __dp4a(d.y, lo, isum[c][1]);
        isum[c][3] = __dp4a(d.w, hi, isum[c][3]);
      }
    }
  }
}

// A team of kWpt = WBOX / 128 warps takes a stage, 32 column words a warp,
// and scales each group into the team's sum of the unit, in shared memory.
// The teams' sums meet once a round (maxu units, all of the CTA's where they
// fit), in team order, so no team waits for another at a unit's end. ND
// digits a row.
template <int WBOX, bool PROBE, int ND>
__global__ void __launch_bounds__(kSThreads, 1)
    w4_stream_kernel(const __grid_constant__ CUtensorMap tm, const __grid_constant__ StreamArgs a) {
  constexpr int kWpt = WBOX / 128;           // warps a stage
  constexpr int kTeams = kSWarps / kWpt;     // teams of warps taking the stages in turn
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  float* s_acc = reinterpret_cast<float*>(ring + a.stages * a.sbytes);  // [team][slot][col]
  int4* sdig = reinterpret_cast<int4*>(s_acc + kTeams * a.maxu * WBOX);  // [half / 4]
  int* sgs = reinterpret_cast<int*>(sdig + a.half / 4);                  // [group][2]
  __shared__ uint64_t full[kSMaxStages], empty[kSMaxStages];
  __shared__ float s_sd[4];
  __shared__ float s_red2[2 * kSWarps];
  __shared__ int s_last[kSMaxUnits];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint4 xv[kSChunks];  // the row, loaded before the weights (stream_digits)
  if (!PROBE && warp < kSWarps)
#pragma unroll
    for (int j = 0; j < kSChunks; ++j) {
      const int i = 8 * (tid + j * kSConsumers);
      xv[j] = i < a.din ? __ldg(reinterpret_cast<const uint4*>(a.x + i)) : make_uint4(0, 0, 0, 0);
    }
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWpt);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kSWarps) {  // the producer: every box of the CTA's units, in order
    if (lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
        int sp, jb, o0, wv, z, g0, g1;
        span_of<WBOX>(a, u, sp, jb, o0, wv, z, g0, g1);
        for (int g = g0; g < g1; ++g, ++it) {
          const int s = it % a.stages;
          mbar_wait(&empty[s], ((it / a.stages) & 1) ^ 1);
          // the whole box counts, columns past the block included (TMA
          // fills them with zeros without reading memory)
          mbar_expect_tx(&full[s], a.group * WBOX);
          tma_load_3d(ring + s * a.sbytes, &tm, &full[s], o0, g * a.group, jb);
        }
      }
    }
    return;
  }

  if (!PROBE) stream_digits<ND>(a, xv, sdig, sgs, s_sd, s_red2);
  const int team = warp / kWpt, cword = (warp - team * kWpt) * 32 + lane;
  const int my_units = (a.n_units - (int)blockIdx.x + gridDim.x - 1) / gridDim.x;
  unsigned psum = 0;
  int it = 0;
  for (int k0 = 0; k0 < my_units; k0 += a.maxu) {  // a round of units
    const int nu = min(a.maxu, my_units - k0);
    float* acc0 = s_acc + (size_t)team * a.maxu * WBOX + 4 * cword;  // slot at slot WBOX
    if (!PROBE)
      for (int i = 0; i < nu; ++i)
        *reinterpret_cast<float4*>(acc0 + i * WBOX) = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = k0; k < k0 + nu; ++k) {
      int sp, jb, o0, wv, z, g0, g1;
      span_of<WBOX>(a, blockIdx.x + k * gridDim.x, sp, jb, o0, wv, z, g0, g1);
      const bool col_ok = 4 * cword < wv;
      const bf16* srow = a.scales + (size_t)jb * a.s_rows * a.bout + o0 + 4 * cword;
      for (int g = g0; g < g1; ++g, ++it) {
        if (it % kTeams != team) continue;
        const int s = it % a.stages;
        const uint8_t* wp = ring + s * a.sbytes + 4 * cword;
        if (PROBE) {
          mbar_wait(&full[s], (it / a.stages) & 1);
          if (col_ok)
            for (int kk = 0; kk < a.group; ++kk)
              psum = __dp4a(*reinterpret_cast<const uint32_t*>(wp + kk * WBOX), 0x01010101u,
                            psum);
          __syncwarp();
          mbar_arrive_if(&empty[s], lane == 0);
          continue;
        }
        uint2 gl = make_uint2(0, 0), gh = make_uint2(0, 0);  // the group's scales, in flight
        if (col_ok) {
          gl = __ldg(reinterpret_cast<const uint2*>(srow + (size_t)g * a.bout));
          gh = __ldg(reinterpret_cast<const uint2*>(srow + (size_t)(a.ngh + g) * a.bout));
        }
        mbar_wait(&full[s], (it / a.stages) & 1);
        int isum[4][4];
        group_dp4a<WBOX, ND>(wp, col_ok ? a.group : 0, sdig + g * (a.group / 4), isum);
        __syncwarp();
        mbar_arrive_if(&empty[s], lane == 0);  // the warp's reads of the stage are done
        const bf16* scl = reinterpret_cast<const bf16*>(&gl);
        const bf16* sch = reinterpret_cast<const bf16*>(&gh);
        const int gs0 = sgs[2 * g], gs1 = sgs[2 * g + 1];
        float* ap = acc0 + (k - k0) * WBOX;
        float4 v4 = *reinterpret_cast<float4*>(ap);
        float* v = &v4.x;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float sl = __bfloat162float(scl[c]), sh = __bfloat162float(sch[c]) / 16.0f;
          v[c] += (float)(isum[c][0] - 8 * gs0) * (s_sd[0] * sl);
          if (ND == 2) v[c] += (float)(isum[c][1] - 8 * gs1) * (s_sd[1] * sl);
          v[c] += (float)isum[c][2] * (s_sd[2] * sh);
          if (ND == 2) v[c] += (float)isum[c][3] * (s_sd[3] * sh);
        }
        *reinterpret_cast<float4*>(ap) = v4;
      }
    }
    if (PROBE) continue;
    // the round's units: the teams' sums in team order, then bf16 out, or a
    // partial and each span's last CTA sums the splits in split order
    csync<kSConsumers>();
    for (int i = tid; i < nu * WBOX; i += kSConsumers) {
      const int slot = i / WBOX, col = i % WBOX;
      int sp, jb, o0, wv, z, g0, g1;
      span_of<WBOX>(a, blockIdx.x + (k0 + slot) * gridDim.x, sp, jb, o0, wv, z, g0, g1);
      if (col >= wv) continue;
      const float* ap = s_acc + (size_t)slot * WBOX + col;
      float v = ap[0];
#pragma unroll
      for (int t = 1; t < kTeams; ++t) v += ap[(size_t)t * a.maxu * WBOX];
      const size_t n = (size_t)jb * a.bout + o0 + col;
      if (a.ks == 1)
        a.out[n] = __float2bfloat16_rn(v);
      else
        __stcg(a.part + (size_t)z * a.dout + n, v);
    }
    if (a.ks > 1) {
      __threadfence();
      csync<kSConsumers>();
      if (tid < nu) {
        int sp, jb, o0, wv, z, g0, g1;
        span_of<WBOX>(a, blockIdx.x + (k0 + tid) * gridDim.x, sp, jb, o0, wv, z, g0, g1);
        s_last[tid] = atomicAdd(a.counters + sp, 1) == a.ks - 1;
        if (s_last[tid]) a.counters[sp] = 0;  // (the last arrival: zeroed for the next launch)
      }
      csync<kSConsumers>();
      __threadfence();
      for (int i = tid; i < nu * WBOX; i += kSConsumers) {
        const int slot = i / WBOX, col = i % WBOX;
        int sp, jb, o0, wv, z, g0, g1;
        span_of<WBOX>(a, blockIdx.x + (k0 + slot) * gridDim.x, sp, jb, o0, wv, z, g0, g1);
        if (!s_last[slot] || col >= wv) continue;
        const size_t n = (size_t)jb * a.bout + o0 + col;
        float v = 0.f;
        for (int zz = 0; zz < a.ks; ++zz) v += __ldcg(a.part + (size_t)zz * a.dout + n);
        a.out[n] = __float2bfloat16_rn(v);
      }
    }
    csync<kSConsumers>();  // s_acc and s_last are free for the next round
  }
  if (PROBE && psum) atomicAdd(a.probe + blockIdx.x, psum);
}

// the probe's other yardstick: plain 16-byte loads that skip L1, four a
// thread in flight, over the slab as it lies
__device__ __forceinline__ uint4 ld_stream_v4(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__global__ void __launch_bounds__(256) probe_v4_kernel(const uint4* p, long long n16,
                                                       unsigned* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned acc = 0;
  for (; i + 3 * stride < n16; i += 4 * stride) {
    uint4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = ld_stream_v4(p + i + k * stride);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc = __dp4a(v[k].x, 0x01010101u, acc);
      acc = __dp4a(v[k].y, 0x01010101u, acc);
      acc = __dp4a(v[k].z, 0x01010101u, acc);
      acc = __dp4a(v[k].w, 0x01010101u, acc);
    }
  }
  for (; i < n16; i += stride) {
    const uint4 v = ld_stream_v4(p + i);
    acc = __dp4a(v.x, 0x01010101u, acc);
    acc = __dp4a(v.y, 0x01010101u, acc);
    acc = __dp4a(v.z, 0x01010101u, acc);
    acc = __dp4a(v.w, 0x01010101u, acc);
  }
  if (acc) atomicAdd(out + blockIdx.x, acc);
}

// ===========================================================================
// The wgmma form: one product of w4_persist.cuh's launch, its rows as they
// are
// ===========================================================================

constexpr int kStaticSmem = 2048;  // the kernel's static shared memory, rounded up

struct WgArgs {
  const bf16* x;  // (M, din)
  bf16* out;      // (M, dout)
  unsigned long long* bar;  // the grid barrier's arrival count (w4_persist.cuh),
                            // then the (row, plane) amax as int bits (2 x kWMaxRows)
  WProd pr;
  int M, m_pad, stages, sbytes;
};

template <int MT, int ND>
__global__ void __launch_bounds__(kWThreads, 1)
    w4_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_d, const __grid_constant__ WgArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  float* s_unit = reinterpret_cast<float*>(ring + a.stages * a.sbytes);  // MT * 8 * 128
  bf16* rowv = reinterpret_cast<bf16*>(s_unit + MT * 8 * 128);         // a row's values
  __shared__ uint64_t full[kWMaxStages], empty[kWMaxStages];
  __shared__ __align__(16) float s_sd[4 * kWMaxRows];
  __shared__ float s_red[2 * kWConsumerWarps];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the count the launch starts from (thread 0 and the digit producer), read
  // before this CTA's first arrival
  unsigned long long target = tid == 0 || tid == kWConsumers + 32 ? launch_start(a.bar) : 0;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 2);  // the weight and the digit producer each arrive
      mbar_init(&empty[s], kWConsumerWarps / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // (before any arrival of this CTA at a grid barrier)

  // the warpgroup's role, warp-uniform for the compiler (setmaxnreg needs it,
  // and a role of each branch of one if/else)
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp < kWConsumerWarps + 2 && lane == 0) {
      const bool weights = warp == kWConsumerWarps;
      if (!weights) {  // the digits: after the barrier that follows their writes
        wait_count(a.bar, target + gridDim.x);
        fence_proxy_async_global();
      }
      int it = 0;
      produce<ND>(a.pr, a.m_pad, weights, weights ? &tm_w : &tm_d, a.stages, a.sbytes, ring,
                  full, empty, it);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    int* amax = reinterpret_cast<int*>(a.bar + 1);
    rows_prologue<ND>(a.pr, a.x, a.pr.din, a.M, a.m_pad, amax, rowv, s_red);
    grid_sync<kWConsumers>(a.bar, target);
    row_scales(amax, a.m_pad, s_sd);
    int it = 0;
    run_units<MT, ND>(a.pr, a.M, a.stages, a.sbytes, s_sd, ring, full, empty, s_unit, it,
                      nullptr, a.out);
    if (a.pr.n_full < a.pr.dout / kPTileN) {
      grid_sync<kWConsumers>(a.bar, target);
      final_sum(a.pr, a.M, nullptr, a.out);
    }
  }
}

template <int MT, int ND>
int launch_wgmma(const CUtensorMap* tw, const CUtensorMap* td, const WgArgs& a, int n_cta,
                 int smem, cudaStream_t s) {
  static int granted = 0;
  const void* kernel = (const void*)w4_wgmma_kernel<MT, ND>;
  const int st = allow_smem(kernel, smem, &granted);
  if (st) return st;
  CUtensorMap t0 = *tw, t1 = *td;
  WgArgs args = a;
  void* params[] = {&t0, &t1, &args};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(n_cta), dim3(kWThreads), params, smem, s);
}

// the wgmma form's ring for ND digits a row, then the launch at m_pad rows
template <int ND>
int launch_wgmma_nd(const CUtensorMap* tw, const CUtensorMap* td, WgArgs a, int n_cta,
                    cudaStream_t s) {
  a.sbytes = stage_bytes<ND>(a.m_pad);
  const int fixed = 1024 + (a.m_pad / 8) * 8 * 128 * 4 + ((2 * a.pr.din + 15) & ~15);
  a.stages = ring_stages<ND>(a.m_pad, fixed, kStaticSmem);
  if (a.stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = fixed + a.stages * a.sbytes;
  switch (a.m_pad / 8) {
    case 1: return launch_wgmma<1, ND>(tw, td, a, n_cta, smem, s);
    case 2: return launch_wgmma<2, ND>(tw, td, a, n_cta, smem, s);
    case 3: return launch_wgmma<3, ND>(tw, td, a, n_cta, smem, s);
    case 4: return launch_wgmma<4, ND>(tw, td, a, n_cta, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int WBOX, bool PROBE, int ND>
int launch_stream(const CUtensorMap* tm, StreamArgs a, int n_cta, cudaStream_t s) {
  static int granted = 0;
  constexpr int kTeams = kSWarps / (WBOX / 128);
  constexpr int kStatic = 1024;  // the kernel's static shared memory (padded by the alignment)
  a.sbytes = kPGroup * WBOX;
  auto fixed = [&](int maxu) {
    return 1024 + kTeams * maxu * WBOX * 4 + 4 * a.half + a.ngh * 8;
  };
  auto stages = [&](int maxu) {
    const int st = min(kSMaxStages, (kMaxDynSmem - kStatic - fixed(maxu)) / a.sbytes);
    return st - st % kTeams;
  };
  a.maxu = min(kSMaxUnits, (a.n_units + n_cta - 1) / n_cta);
  for (int mu = a.maxu - 1; mu >= 1; --mu)
    if (stages(mu) > stages(a.maxu)) a.maxu = mu;
  a.stages = stages(a.maxu);
  if (a.stages < kTeams) return (int)cudaErrorInvalidValue;
  const int smem = fixed(a.maxu) + a.stages * a.sbytes;
  auto kernel = w4_stream_kernel<WBOX, PROBE, ND>;
  const int st = allow_smem((const void*)kernel, smem, &granted);
  if (st) return st;
  kernel<<<n_cta, kSThreads, smem, s>>>(*tm, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// w4_gemv_encode_weights: the TMA map (128 bytes at `map`) of a layer's
// packed (nj, din/2, bout) slab: `rows` k rows a box, `width` bytes of
// columns (128 with 128-byte swizzle for the wgmma form, `rows` = the
// padded group; 128 or 256 unswizzled for the stream form and the probe,
// `rows` = the group); 0 or a cudaError_t.
extern "C" int w4_gemv_encode_weights(void* map, const void* packed, int din, int dout,
                                      int bout, int rows, int width, int swizzle, int device) {
  if (din < 2 || dout < 1 || bout < 16 || bout % 16 || dout % bout || rows < 1 || rows > 256 ||
      (width != 128 && width != 256) || (swizzle && width != 128))
    return (int)cudaErrorInvalidValue;
  // the device's context current in this thread before the map is encoded
  // (a thread's first CUDA call may be this one)
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorSharedObjectInitFailed;
  CUtensorMap* tm = static_cast<CUtensorMap*>(map);
  if (swizzle)
    return encode_weights(enc, tm, packed, din, dout, bout, rows) ? 0
                                                                  : (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)bout, (cuuint64_t)(din / 2), (cuuint64_t)(dout / bout)};
  const cuuint64_t strides[2] = {(cuuint64_t)bout, (cuuint64_t)(din / 2) * bout};
  const cuuint32_t box[3] = {(cuuint32_t)width, (cuuint32_t)rows, 1}, elem[3] = {1, 1, 1};
  return enc(tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(packed), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// w4_gemv_encode_digits: the TMA map of the wgmma form's digit workspace of
// nd digits a row, (hp, 2 nd m_pad) bytes, boxes of 128 k x all rows,
// 128-byte swizzle (a box past a padded group of less than 128 reads the
// next group's digits, or zeros past the row, which no k step of the group
// reads).
extern "C" int w4_gemv_encode_digits(void* map, void* dig, int hp, int m_pad, int nd,
                                     int device) {
  if (hp < 32 || hp % 32 || m_pad < 8 || m_pad > kWMaxRows || m_pad % 8 || nd < 1 || nd > 2)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorSharedObjectInitFailed;
  const cuuint64_t ddims[2] = {(cuuint64_t)hp, (cuuint64_t)(2 * nd * m_pad)};
  const cuuint64_t dstrides[1] = {(cuuint64_t)hp};
  const cuuint32_t dbox[2] = {128, (cuuint32_t)(2 * nd * m_pad)}, elem[2] = {1, 1};
  return enc(static_cast<CUtensorMap*>(map), CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, dig, ddims,
             dstrides, dbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// w4_gemv_wgmma (M = 2..32): maps of the weights (w4_gemv_encode_weights,
// swizzled, rows = the padded group) and of the digits; ptrs: scales of the
// layer, digits, group sums, partials (ks, M, dout) f32 or null, barrier
// words (2 + 2 kWMaxRows zeroed u32: the grid barrier's u64 arrival count,
// left counting, then the rows' amax); ints: M, din, dout, bout, s_rows,
// group, n_full, ks, gps (quant.unit_plan), n_cta (one CTA per SM), unused,
// digits a row (1 or 2); x (M, din), out (M, dout). Returns the launch's
// cudaError_t.
extern "C" int w4_gemv_wgmma(const void* tm_w, const void* tm_d, void* const* ptrs,
                             const int* ints, const void* x, void* out, void* stream) {
  WgArgs a;
  WProd& pr = a.pr;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  pr.packed = nullptr;  // (read through tm_w)
  pr.scales = static_cast<const bf16*>(ptrs[0]);
  pr.dig = static_cast<int8_t*>(ptrs[1]);
  pr.gsum = static_cast<int*>(ptrs[2]);
  pr.part = static_cast<float*>(ptrs[3]);
  a.bar = static_cast<unsigned long long*>(ptrs[4]);
  a.M = ints[0];
  pr.din = ints[1];
  pr.dout = ints[2];
  pr.bout = ints[3];
  pr.s_rows = ints[4];
  pr.group = ints[5];
  pr.n_full = ints[6];
  pr.ks = ints[7];
  pr.gps = ints[8];
  const int n_cta = ints[9], nd = ints[11];
  a.m_pad = 8 * ((a.M + 7) / 8);
  pr.half = pr.din / 2;
  if (a.M < 1 || a.M > kWMaxRows || n_cta < 1 || (nd != 1 && nd != 2) || pr.group < 16 ||
      pr.group > kPGroup ||
      pr.group % 16 || pr.din % (2 * pr.group) || pr.bout % kPTileN || pr.dout % pr.bout)
    return (int)cudaErrorInvalidValue;
  pr.gp = (pr.group + 31) & ~31;
  pr.ngh = pr.half / pr.group;
  pr.hp = pr.ngh * pr.gp;
  const int tiles = pr.dout / kPTileN;
  if (pr.n_full < 0 || pr.n_full > tiles || pr.ks < 1 || pr.ks > kWMaxSplits || pr.gps < 1 ||
      (pr.ks - 1) * pr.gps >= pr.ngh || pr.ks * pr.gps < pr.ngh ||
      (pr.n_full == tiles && pr.ks != 1) || (pr.n_full < tiles && !pr.part))
    return (int)cudaErrorInvalidValue;
  const CUtensorMap* tw = static_cast<const CUtensorMap*>(tm_w);
  const CUtensorMap* td = static_cast<const CUtensorMap*>(tm_d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nd == 1 ? launch_wgmma_nd<1>(tw, td, a, n_cta, s) : launch_wgmma_nd<2>(tw, td, a, n_cta, s);
}

// w4_gemv_stream (M = 1) and the probe's ring (probe != 0: the consumers
// only sum the bytes into probe_out, one u32 a CTA, zeroed): map of the
// weights (w4_gemv_encode_weights, unswizzled, rows = the group, width =
// the box); ptrs: scales of the layer, partials (ks, dout) f32 or null, span counters (zeroed ints, left zeroed), probe_out or null;
// ints: M, din, dout, bout, s_rows, group, box width (128; the probe also
// 256), ks, gps, n_cta, probe, digits a row (1 or 2; the probe 2). Returns
// the launch's cudaError_t.
extern "C" int w4_gemv_stream(const void* tm, void* const* ptrs, const int* ints, const void* x,
                              void* out, void* stream) {
  StreamArgs a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.scales = static_cast<const bf16*>(ptrs[0]);
  a.part = static_cast<float*>(ptrs[1]);
  a.counters = static_cast<int*>(ptrs[2]);
  a.probe = static_cast<unsigned*>(ptrs[3]);
  const int m = ints[0];
  a.din = ints[1];
  a.dout = ints[2];
  a.bout = ints[3];
  a.s_rows = ints[4];
  a.group = ints[5];
  const int wbox = ints[6];
  a.ks = ints[7];
  a.gps = ints[8];
  const int n_cta = ints[9], probe = ints[10], nd = ints[11];
  a.half = a.din / 2;
  if (m != 1 || (probe && !a.probe) || n_cta < 1 || (nd != 1 && nd != 2) || a.group < 16 ||
      (!probe && a.din > kSMaxDin) ||
      a.group > kPGroup || a.group % 16 || a.din % (2 * a.group) || a.bout % 16 ||
      a.dout % a.bout || (wbox != 128 && wbox != 256))
    return (int)cudaErrorInvalidValue;
  a.ngh = a.half / a.group;
  a.nfs = a.bout / wbox;
  a.n_fspans = a.dout / a.bout * a.nfs;
  a.n_spans = a.n_fspans + (a.bout % wbox ? a.dout / a.bout : 0);
  if (a.ks < 1 || a.ks > 32 || a.gps < 1 || (a.ks - 1) * a.gps >= a.ngh ||
      a.ks * a.gps < a.ngh || (a.ks > 1 && (!a.part || !a.counters)))
    return (int)cudaErrorInvalidValue;
  a.n_units = a.n_spans * a.ks;
  const CUtensorMap* t = static_cast<const CUtensorMap*>(tm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (probe)
    return wbox == 128 ? launch_stream<128, true, 2>(t, a, n_cta, s)
                       : launch_stream<256, true, 2>(t, a, n_cta, s);
  if (wbox != 128) return (int)cudaErrorInvalidValue;
  return nd == 1 ? launch_stream<128, false, 1>(t, a, n_cta, s)
                 : launch_stream<128, false, 2>(t, a, n_cta, s);
}

// w4_gemv_probe_v4: the plain-load yardstick: the byte sum of `bytes` (a
// multiple of 16) bytes at p, one u32 a CTA into out (n_cta zeroed).
extern "C" int w4_gemv_probe_v4(const void* p, long long bytes, void* out, int n_cta,
                                void* stream) {
  if (bytes < 16 || bytes % 16 || n_cta < 1 || reinterpret_cast<uintptr_t>(p) % 16)
    return (int)cudaErrorInvalidValue;
  probe_v4_kernel<<<n_cta, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(p), bytes / 16, static_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}
