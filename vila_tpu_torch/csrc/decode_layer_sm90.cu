// One bs=1 W4 decoder layer as one persistent launch, for Hopper (sm_90a):
// the port of the TPU decode megakernel vila_tpu/ops/fused_decode.py:
// _fused_layer_kernel (pallas_call :937), K3.
//
// What it computes (== fused_decode._fused_layer_ref): GQA attention of the
// rope'd, pre-scaled, group-padded q (Hkv * P heads of 128) over the live
// prefix [0, n_rows) of layer l's flat (S, Hkv * 128) cache, additive f32
// mask, f32 softmax, zeros in the pad heads; then
//   h32  = h + x_att @ W_o[l]                  (f32)
//   gu   = rms(h32) * g_post[l] @ W_gu[l]      (bf16)
//   h32b = h32 + (silu(g) * u) @ W_d[l]        (f32; h_new = bf16(h32b))
//   qkv  = rms(h32b) * g_in[l+1] @ W_qkv[l+1] + b   (bf16)
// Every product keeps the TPU kernel's int8-digit arithmetic (two digits
// per half-plane, exact integer dots summed per group of 128 input rows,
// f32 group scales), with the prologue values of w4_common.cuh, as
// w4_gemv.cu and w4_gemv_mma.cu compute them.
//
// Bound on this card: bytes (~120 MB of packed weights and scales and the
// live KV per layer at the NVILA-8B shape, a few int8 operations a byte).
//
// Design. The TPU kernel keeps the layer in 100 MB of VMEM on one core; a
// Hopper CTA has 227 KB, so the layer is one cooperative launch of one CTA
// per SM (the launch refuses a grid that cannot be co-resident), with seven
// grid-wide barriers between its stages:
//   0  attention partials: a CTA takes kv head g and a chunk of <= 64 cache
//      rows (staged in shared memory by cp.async), reads each K and V row
//      once for the group's heads (the heads' score reductions interleaved)
//      and writes (max, sum, P V) per head;
//   1  the partials merged in split order into x_att (bf16), 32 splits a
//      round gathered into shared memory, with per-CTA half-plane amax;
//   2  o; 3 gate_up; 5 down; 6 qkv: per product a fixed plan of (column
//      tile of 128, K split) units dealt round-robin to the CTAs; each CTA
//      expands the digits of the groups its units cover (a warp per group
//      and plane) and writes one f32 partial per unit; the next stage sums
//      the partials in split order (every CTA for h32 and h32b, which the
//      RMS prologue needs whole, from one gather of the partials, gamma and
//      h; a distributed pass for gate_up (4) and qkv (7)), so no arrival
//      counters are needed and the result is deterministic;
//   4  gu = bf16(sum of partials) and the down product's SiLU prologue
//      values, once per element over the grid, with per-CTA half-plane
//      amax partials.
// Weights do not depend on the activations, so a producer warp streams
// each CTA's weight tiles of all four products, in the order the consumers
// take them, through a 6-stage ring of 16 KB TMA tiles (128 input rows x
// 128 columns, 128-byte swizzle) and their scale rows, from the launch on:
// the o weights arrive while attention runs, and each product's head while
// the CTA waits at the barrier before it and expands its digits. Units are dealt split-major, so
// the CTAs that run at once read the same input rows of neighbouring column
// tiles. What a stage reads that other CTAs wrote is gathered into shared
// memory by cp.async, every copy in flight at once: the stages between the
// weight streams are latency-bound. Eight consumer warps take the ring's
// stages alternately (two sets of four warps, 32 columns a warp); each
// group's integer dots run on mma.sync m16n8k32 s8 with the row's two
// digits as A rows 0 and 8 (w4_gemv_mma.cu's fragment layout). Scratch
// lives in one workspace made once per device; the barrier word counts
// generations, so launches need no reset.

#include <cuda_bf16.h>

#include "sm90_common.cuh"
#include "w4_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kGroup = 128;                // input rows per scale group and ring stage
constexpr int kTileN = 128;                // output columns per unit
constexpr int kStages = 6;                 // even: stage s belongs to warp set s & 1
constexpr int kWeightBytes = kGroup * kTileN;
constexpr int kStageTx = kWeightBytes + 2 * kTileN * 2;
constexpr int kStageBytes = (kStageTx + 1023) & ~1023;
constexpr int kHd = 128;
constexpr int kMaxChunk = 64;
constexpr int kMaxP = 8;
constexpr int kMaxGroups = 128;  // per plane: din <= 32768
constexpr int kStamps = 13;  // start; after each barrier and each product's prologue; end
constexpr int kMaxSplits = 16;   // K splits of a product
constexpr int kMaxResSplits = 4;  // K splits of o and down (summed by every CTA)
constexpr int kAttStride = 2 + kHd + 2;  // attention partial: max, sum, P V, pad to 16 B
constexpr int kMergeChunk = 32;  // attention partials merged per round

struct Prod {
  const uint8_t* packed;  // (nj, din/2, bout) of the layer
  const bf16* scales;     // (nj, s_rows, bout) of the layer
  float* part;            // (ks, dout) partials
  int din, dout, bout, s_rows, ngh, ks, gps;
};

struct LayerArgs {
  const bf16* q;     // (hkv * pad, 128)
  const bf16* k;     // (S, kv_ld) of layer l
  const bf16* v;
  const float* mask;  // (>= n_rows,) additive
  const bf16* h;      // (D,)
  const bf16* gpost;  // (D,)
  const bf16* gin;    // (D,)
  const bf16* bias;   // (dq,) or null
  float* att;         // (hkv * pad, nsplit, kAttStride)
  bf16* x_att;        // (hkv * pad * 128,)
  bf16* m_act;        // (inter,)
  float* amax_part;   // (gridDim.x, 2)
  unsigned* bar;      // arrivals, generation
  bf16* h_out;        // (D,)
  bf16* qkv_out;      // (dq,)
  unsigned long long* stamps;  // (kStamps,) or null
  Prod pr[4];                  // o, gate_up, down, qkv
  int n_rows, kv_ld, hkv, pad, grp, chunk, nsplit, D, inter, dig_bytes, vals_bytes;
  float eps;
};

__device__ __forceinline__ void csync() {  // the consumer warps
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// CTA 0's %globaltimer reading k (checks only)
__device__ __forceinline__ void stamp(const LayerArgs& a, int k) {
  if (a.stamps && blockIdx.x == 0 && threadIdx.x == 0) a.stamps[k] = globaltimer();
}

__device__ __forceinline__ float cons_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  csync();
  float r = red[0];
  for (int w = 1; w < kConsumerWarps; ++w) r = fmaxf(r, red[w]);
  csync();
  return r;
}

__device__ __forceinline__ double cons_sum64(double v, double* red) {
  v = warp_sum_f64(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  csync();
  double r = red[0];
  for (int w = 1; w < kConsumerWarps; ++w) r += red[w];
  csync();
  return r;
}

// every CTA's consumers: arrive, wait for the last, then read what the grid
// wrote before it (through L2). Thread 0 arrives with an acq_rel add on the
// arrival count; the last resets it and releases the next generation, the
// others acquire it (as CUTLASS's grid barrier).
__device__ void grid_sync(const LayerArgs& a, int k) {
  csync();
  if (threadIdx.x == 0) {
    unsigned g0, old;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(g0) : "l"(a.bar + 1) : "memory");
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(a.bar) : "memory");
    if (old == gridDim.x - 1) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], 0;\n" ::"l"(a.bar) : "memory");
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(a.bar + 1) : "memory");
    } else {
      unsigned g;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(g) : "l"(a.bar + 1) : "memory");
      } while (g == g0);
    }
  }
  stamp(a, k);
  csync();
}

// 16 bytes global -> shared through L2, not waited for
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows x 16-byte chunks from global (row i at src + i * stride bytes) to
// shared memory (row i at dst + i * chunks * 16), every copy in flight at
// once; waited for by the caller
__device__ __forceinline__ void gather(void* dst, const void* src, int rows, int chunks,
                                       size_t stride) {
  for (int k = threadIdx.x; k < rows * chunks; k += kConsumers) {
    const int r = k / chunks, c = k - r * chunks;
    cp_async16(static_cast<char*>(dst) + 16 * k,
               static_cast<const char*>(src) + r * stride + 16 * c);
  }
}

// ---- stage 0: one attention partial (kv head g, rows [t0, t0 + chunk)):
// the chunk's K and V rows of head g into shared memory (kvs: 2 x 64 x 128
// bf16) by cp.async, all in flight at once, then scores, softmax and P V
__device__ void attn_partial(const LayerArgs& a, int g, int split, float (*sc)[kMaxChunk],
                             float (*pv)[kMaxP][kHd], float* s_ml, bf16* kvs) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = split * a.chunk, rows = min(a.chunk, a.n_rows - t0);
  for (int idx = tid; idx < 2 * rows * 16; idx += kConsumers) {
    const int which = idx >= rows * 16, r = (idx - which * rows * 16) >> 4, c = idx & 15;
    cp_async16(kvs + (which * kMaxChunk + r) * kHd + c * 8,
               (which ? a.v : a.k) + (size_t)(t0 + r) * a.kv_ld + g * kHd + c * 8);
  }
  float qr[kMaxP][4];  // elements 4 lane .. 4 lane + 3 of each head
#pragma unroll
  for (int j = 0; j < kMaxP; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qr[j][i] = j < a.grp ? __bfloat162float(a.q[(size_t)(g * a.pad + j) * kHd + 4 * lane + i])
                           : 0.f;
  cp_async_wait_all();
  csync();
  for (int r = warp; r < rows; r += kConsumerWarps) {
    const uint2 kw = *reinterpret_cast<const uint2*>(kvs + r * kHd + 4 * lane);
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kw);
    const float2 k01 = __bfloat1622float2(k2[0]), k23 = __bfloat1622float2(k2[1]);
    const float mk = a.mask[t0 + r];
    float s[kMaxP];  // every head's reduction interleaved (pad heads: q = 0)
#pragma unroll
    for (int j = 0; j < kMaxP; ++j)
      s[j] = qr[j][0] * k01.x + qr[j][1] * k01.y + qr[j][2] * k23.x + qr[j][3] * k23.y;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < kMaxP; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
    if (lane < kMaxP) {  // lane j stores head j
      float v = s[0];
#pragma unroll
      for (int j = 1; j < kMaxP; ++j) v = lane == j ? s[j] : v;
      sc[lane][r] = v + mk;
    }
  }
  csync();
  if (warp < a.grp) {  // warp j: head j's max, probabilities and sum
    const float s0 = lane < rows ? sc[warp][lane] : -3.4e38f;
    const float s1 = lane + 32 < rows ? sc[warp][lane + 32] : -3.4e38f;
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float p0 = lane < rows ? expf(s0 - m) : 0.f;
    const float p1 = lane + 32 < rows ? expf(s1 - m) : 0.f;
    float l = p0 + p1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    sc[warp][lane] = p0;
    sc[warp][lane + 32] = p1;
    if (lane == 0) {
      s_ml[2 * warp] = m;
      s_ml[2 * warp + 1] = l;
    }
  }
  csync();
  {  // P V: thread (d, half) sums rows half, half + 2, ...
    const int d = tid & (kHd - 1), hh = tid >> 7;
    float acc[kMaxP];
#pragma unroll
    for (int j = 0; j < kMaxP; ++j) acc[j] = 0.f;
    for (int r = hh; r < rows; r += 2) {
      const float vv = __bfloat162float(kvs[(kMaxChunk + r) * kHd + d]);
#pragma unroll
      for (int j = 0; j < kMaxP; ++j) acc[j] += sc[j][r] * vv;
    }
#pragma unroll
    for (int j = 0; j < kMaxP; ++j) pv[hh][j][d] = acc[j];
  }
  csync();
  if (tid < kHd) {
    for (int j = 0; j < a.grp; ++j) {
      float* w = a.att + ((size_t)(g * a.pad + j) * a.nsplit + split) * kAttStride;
      w[2 + tid] = pv[0][j][tid] + pv[1][j][tid];
      if (tid == 0) {
        w[0] = s_ml[2 * j];
        w[1] = s_ml[2 * j + 1];
      }
    }
  }
  csync();  // sc, pv, s_ml and kvs are free for the next unit
}

// ---- the products: this CTA's digits of the input row for the groups of
// its units (w4_gemv_rows' k order inside each 32-row step), the lo plane's
// group digit sums, then its units' partials
struct ProdSmem {
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  int8_t* dig;    // (plane, digit, din/2) int8
  int* gsum;      // (ngh, digit) int32, lo plane
  float* sd;      // s1 lo, s2 lo, s1 hi, s2 hi
  int* glist;     // the groups of this CTA's units, their count at kMaxGroups
  float (*unit)[kTileN];
};

// units u = split * tiles + tile, split-major: the CTAs that run at once
// stream the same input rows of neighbouring column tiles
__device__ __forceinline__ unsigned need_splits(const Prod& pr) {
  const int tiles = pr.dout / kTileN;
  unsigned need = 0;  // the splits of this CTA's units
  for (int u = blockIdx.x; u < tiles * pr.ks; u += gridDim.x) need |= 1u << (u / tiles);
  return need;
}

// the input row's values (bf16, from global) of the groups this CTA's units
// cover into `vals` at their own offsets, all copies in flight at once
__device__ void stage_values(const Prod& pr, const bf16* src, bf16* vals) {
  const int half = pr.din / 2;
  const unsigned need = need_splits(pr);
  for (int z = 0; z < pr.ks; ++z) {
    if (!(need >> z & 1)) continue;
    const int g0 = z * pr.gps, g1 = min(pr.ngh, g0 + pr.gps);
    for (int k = threadIdx.x; k < (g1 - g0) * 32; k += kConsumers) {
      const int gi = g0 + (k >> 5), p = (k >> 4) & 1, c = k & 15;
      const size_t off = (size_t)p * half + gi * kGroup + c * 8;
      cp_async16(vals + off, src + off);
    }
  }
  cp_async_wait_all();
  csync();
}

__device__ void expand_digits(const Prod& pr, const ProdSmem& sm, const bf16* vals,
                              float am_lo, float am_hi) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = pr.din / 2;
  const float s1l = fmaxf(am_lo / 127.0f, 1e-20f), s1h = fmaxf(am_hi / 127.0f, 1e-20f);
  const float s2l = s1l / 127.0f, s2h = s1h / 127.0f;
  if (tid < 4) sm.sd[tid] = tid == 0 ? s1l : tid == 1 ? s2l : tid == 2 ? s1h : s2h;
  if (tid == 0) {  // the groups of this CTA's units
    const unsigned need = need_splits(pr);
    int n = 0;
    for (int z = 0; z < pr.ks; ++z)
      if (need >> z & 1)
        for (int gi = z * pr.gps; gi < min(pr.ngh, (z + 1) * pr.gps); ++gi) sm.glist[n++] = gi;
    sm.glist[kMaxGroups] = n;
  }
  csync();
  // one warp per (group, plane) block of 128: four elements a lane, one
  // reduction of the lo plane's digit sums per block
  const int nblk = 2 * sm.glist[kMaxGroups];
  for (int b = warp; b < nblk; b += kConsumerWarps) {
    const int gi = sm.glist[b >> 1], p = b & 1;
    const float s1 = p ? s1h : s1l, s2 = p ? s2h : s2l;
    int a1 = 0, a2 = 0;
#pragma unroll
    for (int e = 0; e < kGroup / 32; ++e) {
      const int ii = gi * kGroup + 32 * e;  // a 32-row step
      int q1, q2;
      two_digits(__bfloat162float(vals[p * half + ii + lane]), s1, s2, &q1, &q2);
      sm.dig[(2 * p) * half + ii + kappa_of(lane)] = (int8_t)q1;
      sm.dig[(2 * p + 1) * half + ii + kappa_of(lane)] = (int8_t)q2;
      a1 += q1;
      a2 += q2;
    }
    if (p == 0) {  // (warp-uniform)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a1 += __shfl_xor_sync(0xffffffffu, a1, o);
        a2 += __shfl_xor_sync(0xffffffffu, a2, o);
      }
      if (lane == 0) {
        sm.gsum[gi * 2] = a1;
        sm.gsum[gi * 2 + 1] = a2;
      }
    }
  }
  csync();
}

// the units of one product; `it` counts ring stages as the producer does
__device__ void run_product(const Prod& pr, const ProdSmem& sm, int& it) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int set = warp >> 2, cw = (warp & 3) * 32, g = lane >> 2, t = lane & 3;
  const int half = pr.din / 2, nunits = (pr.dout / kTileN) * pr.ks;
  const float sd0 = sm.sd[0], sd1 = sm.sd[1], sd2 = sm.sd[2], sd3 = sm.sd[3];
  for (int u = blockIdx.x; u < nunits; u += gridDim.x) {
    const int tile = u % (pr.dout / kTileN), split = u / (pr.dout / kTileN);
    const int g0 = split * pr.gps, g1 = min(pr.ngh, g0 + pr.gps);
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    for (int gi = g0; gi < g1; ++gi, ++it) {
      if ((it & 1) != set) continue;
      const int s = it % kStages;
      const uint8_t* st = sm.ring + s * kStageBytes;
      mbar_wait(&sm.full[s], (it / kStages) & 1);
      int ilo[4][4], ihi[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) ilo[q][e] = ihi[q][e] = 0;
#pragma unroll
      for (int ks = 0; ks < kGroup / 32; ++ks) {
        // A rows 0 and 8: the row's two digits; rows 1-7 and 9-15 zero
        uint32_t alo[4] = {0, 0, 0, 0}, ahi[4] = {0, 0, 0, 0};
        if (g == 0) {
          const int8_t* d0 = sm.dig + gi * kGroup + ks * 32 + 4 * t;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            alo[2 * hh] = *reinterpret_cast<const uint32_t*>(d0 + 16 * hh);
            alo[2 * hh + 1] = *reinterpret_cast<const uint32_t*>(d0 + half + 16 * hh);
            ahi[2 * hh] = *reinterpret_cast<const uint32_t*>(d0 + 2 * half + 16 * hh);
            ahi[2 * hh + 1] = *reinterpret_cast<const uint32_t*>(d0 + 3 * half + 16 * hh);
          }
        }
        uint32_t b0[4], b1[4];
        w4_fragments(st, ks * 32, cw, g, t, b0, b1);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          mma_s8(ilo[q], alo, lo_plane(b0[q]), lo_plane(b1[q]));
          mma_s8(ihi[q], ahi, hi_plane(b0[q]), hi_plane(b1[q]));
        }
      }
      if (g == 0) {  // the whole group's integer sums -> f32 (row 0 in lanes 0-3)
        const bf16* sc = reinterpret_cast<const bf16*>(st + kWeightBytes) + cw + 8 * t;
        const int gs0 = sm.gsum[gi * 2], gs1 = sm.gsum[gi * 2 + 1];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 4 * e + q;  // column cw + 8t + c
            const float sl = __bfloat162float(sc[c]);
            const float sh = __bfloat162float(sc[kTileN + c]) / 16.0f;
            float v = acc[c];
            v += (float)(ilo[q][e] - 8 * gs0) * (sd0 * sl);
            v += (float)(ilo[q][2 + e] - 8 * gs1) * (sd1 * sl);
            v += (float)ihi[q][e] * (sd2 * sh);
            v += (float)ihi[q][2 + e] * (sd3 * sh);
            acc[c] = v;
          }
      }
      __syncwarp();
      mbar_arrive_if(&sm.empty[s], lane == 0);  // the warp's reads of the stage are done
    }
    if (g == 0)
#pragma unroll
      for (int c = 0; c < 8; ++c) sm.unit[set][cw + 8 * t + c] = acc[c];
    csync();
    if (tid < kTileN)
      pr.part[(size_t)split * pr.dout + tile * kTileN + tid] = sm.unit[0][tid] + sm.unit[1][tid];
    csync();
  }
}

// sum of a product's partials for column c, in split order (the loads
// issued together)
__device__ __forceinline__ float part_sum(const Prod& pr, int c) {
  float x[kMaxSplits];
#pragma unroll
  for (int z = 0; z < kMaxSplits; ++z)
    x[z] = z < pr.ks ? __ldcg(pr.part + (size_t)z * pr.dout + c) : 0.f;
  float v = 0.f;
#pragma unroll
  for (int z = 0; z < kMaxSplits; ++z)
    if (z < pr.ks) v += x[z];
  return v;
}

// the largest |value| of each half-plane over the CTAs' partials
__device__ __forceinline__ void amax_of_parts(const LayerArgs& a, float* red, float* lo,
                                              float* hi) {
  float l = 0.f, h = 0.f;
  for (int c = threadIdx.x; c < (int)gridDim.x; c += kConsumers) {
    l = fmaxf(l, __ldcg(a.amax_part + 2 * c));
    h = fmaxf(h, __ldcg(a.amax_part + 2 * c + 1));
  }
  *lo = cons_max(l, red);
  *hi = cons_max(h, red);
}

// h32 = (h or h32) + the sum of product `res`'s partials in split order,
// then vals = bf16(rms(h32) * gamma) and each half-plane's amax of them:
// every CTA over the whole row. gamma, h and the partials are gathered into
// `scratch` first (one round trip), vals written after they are read.
__device__ void residual_and_rms(const LayerArgs& a, const Prod& res, const bf16* h,
                                 const bf16* gamma, float* h32, float* scratch, bf16* vals,
                                 int half, double* red64, float* redf, float* lo, float* hi) {
  const int D = a.D, tid = threadIdx.x;
  bf16* g_s = reinterpret_cast<bf16*>(scratch);  // gamma (D)
  bf16* h_s = g_s + D;                           // h (D)
  float* p_s = scratch + D;                      // partials (ks, D)
  gather(g_s, gamma, 1, D / 8, 0);
  if (h) gather(h_s, h, 1, D / 8, 0);
  gather(p_s, res.part, 1, res.ks * D / 4, 0);
  cp_async_wait_all();
  csync();
  // (latency-bound on 8 warps: independent chains, the f64 sum in 4 parts)
  double ss[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i0 = tid; i0 < D; i0 += 4 * kConsumers) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kConsumers;
      if (i < D) {
        float sum = 0.f;
#pragma unroll
        for (int z = 0; z < kMaxResSplits; ++z)
          if (z < res.ks) sum += p_s[z * D + i];
        const float v = (h ? __bfloat162float(h_s[i]) : h32[i]) + sum;
        h32[i] = v;
        ss[u] += (double)v * (double)v;
      }
    }
  }
  const float rms =
      rms_scale(cons_sum64((ss[0] + ss[1]) + (ss[2] + ss[3]), red64), D, a.eps);  // (p_s read)
  float l = 0.f, hh = 0.f;
#pragma unroll 4
  for (int i = tid; i < D; i += kConsumers) {
    const float v = rms_value(h32[i], rms, __bfloat162float(g_s[i]));
    vals[i] = __float2bfloat16_rn(v);
    if (i < half) l = fmaxf(l, fabsf(v)); else hh = fmaxf(hh, fabsf(v));
  }
  *lo = cons_max(l, redf);  // (its barriers publish vals)
  *hi = cons_max(hh, redf);
}

__global__ void __launch_bounds__(kThreads, 1) decode_layer_kernel(
    const __grid_constant__ CUtensorMap tm_o, const __grid_constant__ CUtensorMap tm_gu,
    const __grid_constant__ CUtensorMap tm_d, const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ LayerArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* h32 = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  int8_t* dig = reinterpret_cast<int8_t*>(h32 + a.D);
  // each product's input values; the attention's K and V chunk
  bf16* vals = reinterpret_cast<bf16*>(dig + a.dig_bytes);
  // dig and vals together: scratch for what a stage gathers before it
  float* scratch = reinterpret_cast<float*>(dig);
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ float sc[kMaxP][kMaxChunk];
  __shared__ float pv[2][kMaxP][kHd];
  __shared__ float s_ml[2 * kMaxP];
  __shared__ float s_unit[2][kTileN];
  __shared__ int s_gsum[2 * kMaxGroups];
  __shared__ int s_glist[kMaxGroups + 1];
  __shared__ float s_sd[4];
  __shared__ float redf[kConsumerWarps];
  __shared__ double red64[kConsumerWarps];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  stamp(a, 0);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer: every weight tile of the four products
    if (lane == 0) {
      int it = 0;
      for (int p = 0; p < 4; ++p) {
        const Prod& pr = a.pr[p];
        const CUtensorMap* tm = p == 0 ? &tm_o : p == 1 ? &tm_gu : p == 2 ? &tm_d : &tm_q;
        for (int u = blockIdx.x; u < (pr.dout / kTileN) * pr.ks; u += gridDim.x) {
          const int tile = u % (pr.dout / kTileN), split = u / (pr.dout / kTileN);
          const int n0 = tile * kTileN, jb = n0 / pr.bout, oo0 = n0 % pr.bout;
          const bf16* srow = pr.scales + (size_t)jb * pr.s_rows * pr.bout + oo0;
          const int g1 = min(pr.ngh, (split + 1) * pr.gps);
          for (int gi = split * pr.gps; gi < g1; ++gi, ++it) {
            const int s = it % kStages;
            uint8_t* st = ring + s * kStageBytes;
            mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(&full[s], kStageTx);
            tma_load_3d(st, tm, &full[s], oo0, gi * kGroup, jb);
            bulk_load(st + kWeightBytes, srow + (size_t)gi * pr.bout, kTileN * 2, &full[s]);
            bulk_load(st + kWeightBytes + kTileN * 2, srow + (size_t)(pr.ngh + gi) * pr.bout,
                      kTileN * 2, &full[s]);
          }
        }
      }
    }
    return;
  }

  const ProdSmem sm{ring, full, empty, dig, s_gsum, s_sd, s_glist, s_unit};
  const int N = gridDim.x, D = a.D;
  int it = 0;

  // 0: attention partials
  for (int u = blockIdx.x; u < a.hkv * a.nsplit; u += N)
    attn_partial(a, u / a.nsplit, u % a.nsplit, sc, pv, s_ml, vals);
  grid_sync(a, 1);

  // 1: merge them into x_att (pad heads: zeros), kMergeChunk splits a round
  // in split order, with this CTA's amax of each half-plane
  {
    const int half = a.pr[0].din / 2;
    float lo = 0.f, hi = 0.f;
    for (int u = blockIdx.x; u < a.hkv * a.pad; u += N) {
      if (u % a.pad >= a.grp) {  // a pad head (block-uniform)
        if (tid < kHd) a.x_att[(size_t)u * kHd + tid] = __float2bfloat16_rn(0.f);
        continue;
      }
      float m = -3.4e38f, l = 0.f, o = 0.f;
      for (int z0 = 0; z0 < a.nsplit; z0 += kMergeChunk) {
        const int nz = min(kMergeChunk, a.nsplit - z0);
        gather(scratch, a.att + ((size_t)u * a.nsplit + z0) * kAttStride, 1,
               nz * kAttStride / 4, 0);
        cp_async_wait_all();
        csync();
        if (tid < kHd) {
          float mz = m;
#pragma unroll 8
          for (int z = 0; z < nz; ++z) mz = fmaxf(mz, scratch[z * kAttStride]);
          const float f0 = expf(m - mz);
          l *= f0;
          o *= f0;
#pragma unroll 8
          for (int z = 0; z < nz; ++z) {
            const float* w = scratch + z * kAttStride;
            const float f = expf(w[0] - mz);
            l += w[1] * f;
            o += w[2 + tid] * f;
          }
          m = mz;
        }
        csync();
      }
      if (tid < kHd) {
        const int i = u * kHd + tid;
        const bf16 ob = __float2bfloat16_rn(o / l);
        a.x_att[i] = ob;
        if (i < half) lo = fmaxf(lo, fabsf(__bfloat162float(ob)));
        else hi = fmaxf(hi, fabsf(__bfloat162float(ob)));
      }
    }
    lo = cons_max(lo, redf);
    hi = cons_max(hi, redf);
    if (tid == 0) {
      a.amax_part[2 * blockIdx.x] = lo;
      a.amax_part[2 * blockIdx.x + 1] = hi;
    }
  }
  grid_sync(a, 2);

  // 2: o, over x_att as it is
  {
    const Prod& pr = a.pr[0];
    float lo, hi;
    amax_of_parts(a, redf, &lo, &hi);
    stage_values(pr, a.x_att, vals);
    expand_digits(pr, sm, vals, lo, hi);
    stamp(a, 3);
    run_product(pr, sm, it);
  }
  grid_sync(a, 4);

  // 3: h32 = h + o (every CTA, whole row), gate_up over rms(h32) * g_post
  {
    const Prod& pr = a.pr[1];
    float lo, hi;
    residual_and_rms(a, a.pr[0], a.h, a.gpost, h32, scratch, vals, pr.din / 2, red64, redf,
                     &lo, &hi);
    expand_digits(pr, sm, vals, lo, hi);
    stamp(a, 5);
    run_product(pr, sm, it);
  }
  grid_sync(a, 6);

  // 4: gu = bf16(sum of partials) and silu(g) * u, each element once (this
  // CTA's columns of gate and up gathered first)
  {
    const Prod& pr = a.pr[1];
    const int per = ((a.inter + N - 1) / N + 3) & ~3, c0 = blockIdx.x * per;
    const int n = max(0, min(a.inter, c0 + per) - c0), half = a.inter / 2;
    const size_t stride = (size_t)pr.dout * 4;
    if (n > 0) {  // (block-uniform)
      gather(scratch, pr.part + c0, pr.ks, n / 4, stride);
      gather(scratch + pr.ks * n, pr.part + a.inter + c0, pr.ks, n / 4, stride);
    }
    cp_async_wait_all();
    csync();
    float lo = 0.f, hi = 0.f;
#pragma unroll 2
    for (int c = tid; c < n; c += kConsumers) {
      float g = 0.f, u = 0.f;
#pragma unroll
      for (int z = 0; z < kMaxSplits; ++z) {
        if (z >= pr.ks) break;
        g += scratch[z * n + c];
        u += scratch[(pr.ks + z) * n + c];
      }
      const float v = silu_value(round_bf16(g), round_bf16(u));
      a.m_act[c0 + c] = __float2bfloat16_rn(v);
      if (c0 + c < half) lo = fmaxf(lo, fabsf(v)); else hi = fmaxf(hi, fabsf(v));
    }
    lo = cons_max(lo, redf);
    hi = cons_max(hi, redf);
    if (tid == 0) {
      a.amax_part[2 * blockIdx.x] = lo;
      a.amax_part[2 * blockIdx.x + 1] = hi;
    }
  }
  grid_sync(a, 7);

  // 5: down over the SiLU values
  {
    const Prod& pr = a.pr[2];
    float lo, hi;
    amax_of_parts(a, redf, &lo, &hi);
    stage_values(pr, a.m_act, vals);
    expand_digits(pr, sm, vals, lo, hi);
    stamp(a, 8);
    run_product(pr, sm, it);
  }
  grid_sync(a, 9);

  // 6: h32b = h32 + down (every CTA, whole row; h_new by slices), qkv over
  // rms(h32b) * g_in
  {
    const Prod& pr = a.pr[3];
    float lo, hi;
    residual_and_rms(a, a.pr[2], nullptr, a.gin, h32, scratch, vals, pr.din / 2, red64, redf,
                     &lo, &hi);
    const int per = (D + N - 1) / N;
    for (int i = blockIdx.x * per + tid; i < min(D, ((int)blockIdx.x + 1) * per);
         i += kConsumers)
      a.h_out[i] = __float2bfloat16_rn(h32[i]);
    expand_digits(pr, sm, vals, lo, hi);
    stamp(a, 10);
    run_product(pr, sm, it);
  }
  grid_sync(a, 11);

  // 7: qkv = bf16(sum of partials + bias)
  {
    const Prod& pr = a.pr[3];
    const int per = (pr.dout + N - 1) / N, c0 = blockIdx.x * per;
    for (int c = c0 + tid; c < min(pr.dout, c0 + per); c += kConsumers) {
      float v = part_sum(pr, c);
      if (a.bias) v = v + __bfloat162float(a.bias[c]);
      a.qkv_out[c] = __float2bfloat16_rn(v);
    }
  }
  stamp(a, kStamps - 1);
}

// the workspace (floats) of one plan: attention partials, x_att, each
// product's partials, the SiLU values, the amax partials
inline size_t ws_layout(const int* in, size_t* off) {
  const int hkv = in[2], pad = in[3], nsplit = in[6], inter = in[8], n_cta = in[9];
  size_t o = 0;
  auto region = [&](int k, size_t floats) {  // 256-byte aligned
    off[k] = o;
    o += (floats + 63) & ~size_t(63);
  };
  region(0, (size_t)hkv * pad * nsplit * kAttStride);  // attention partials
  region(1, (size_t)hkv * pad * kHd / 2);             // x_att (bf16)
  for (int p = 0; p < 4; ++p)                          // partials (ks, dout)
    region(2 + p, (size_t)in[10 + 6 * p + 4] * in[10 + 6 * p + 1]);
  region(6, (inter + 1) / 2);   // m_act (bf16)
  region(7, 2 * (size_t)n_cta);  // amax partials
  return o;
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// ints: n_rows, kv_ld, hkv, pad, grp, chunk, nsplit, D, inter, n_cta, then
// per product (o, gate_up, down, qkv) din, dout, bout, s_rows, ks, gps,
// then the device index.
// decode_layer_ws_floats: the f32 workspace the plan needs.
extern "C" long long decode_layer_ws_floats(const int* ints) {
  size_t off[8];
  return (long long)ws_layout(ints, off);
}

// ptrs: q, k, v (layer l), mask, h, g_post, g_in, bias (or null), ws,
// barrier words (2 zeroed u32, left as generations), h_out, qkv_out, stamps
// (or null: 13 u64 %globaltimer readings of CTA 0: start; after the grid
// barriers 1, 2, 3, 4, 5, 6, 7 at 1, 2, 4, 6, 7, 9, 11; after the o,
// gate_up, down and qkv prologues at 3, 5, 8, 10; end at 12), then
// packed[4] and scales[4] of the products' layers. One CTA per
// SM (n_cta), cooperative. Returns the launch's cudaError_t.
extern "C" int decode_layer(void* const* ptrs, const int* ints, float eps, void* stream) {
  static int granted = 0;
  LayerArgs a;
  a.q = static_cast<const bf16*>(ptrs[0]);
  a.k = static_cast<const bf16*>(ptrs[1]);
  a.v = static_cast<const bf16*>(ptrs[2]);
  a.mask = static_cast<const float*>(ptrs[3]);
  a.h = static_cast<const bf16*>(ptrs[4]);
  a.gpost = static_cast<const bf16*>(ptrs[5]);
  a.gin = static_cast<const bf16*>(ptrs[6]);
  a.bias = static_cast<const bf16*>(ptrs[7]);
  float* ws = static_cast<float*>(ptrs[8]);
  a.bar = static_cast<unsigned*>(ptrs[9]);
  a.h_out = static_cast<bf16*>(ptrs[10]);
  a.qkv_out = static_cast<bf16*>(ptrs[11]);
  a.stamps = static_cast<unsigned long long*>(ptrs[12]);
  a.n_rows = ints[0];
  a.kv_ld = ints[1];
  a.hkv = ints[2];
  a.pad = ints[3];
  a.grp = ints[4];
  a.chunk = ints[5];
  a.nsplit = ints[6];
  a.D = ints[7];
  a.inter = ints[8];
  const int n_cta = ints[9];
  a.eps = eps;
  // the device's context current in this thread before the descriptors
  // are encoded (a thread's first CUDA call may be this one)
  const cudaError_t dev_err = cudaSetDevice(ints[34]);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (a.n_rows < 1 || a.pad > kMaxP || a.grp > a.pad || a.chunk < 1 || a.chunk > kMaxChunk ||
      a.nsplit * a.chunk < a.n_rows || a.kv_ld < a.hkv * kHd || n_cta < 1 || a.D % 8)
    return (int)cudaErrorInvalidValue;
  size_t off[8];
  ws_layout(ints, off);
  a.att = ws + off[0];
  a.x_att = reinterpret_cast<bf16*>(ws + off[1]);
  a.m_act = reinterpret_cast<bf16*>(ws + off[6]);
  a.amax_part = ws + off[7];
  const EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorSharedObjectInitFailed;
  CUtensorMap tm[4];
  int max_din = 0;
  for (int p = 0; p < 4; ++p) {
    const int* d = ints + 10 + 6 * p;
    Prod& pr = a.pr[p];
    pr.packed = static_cast<const uint8_t*>(ptrs[13 + p]);
    pr.scales = static_cast<const bf16*>(ptrs[17 + p]);
    pr.part = ws + off[2 + p];
    pr.din = d[0];
    pr.dout = d[1];
    pr.bout = d[2];
    pr.s_rows = d[3];
    pr.ks = d[4];
    pr.gps = d[5];
    pr.ngh = pr.din / 2 / kGroup;
    if (pr.din % (2 * kGroup) || pr.ngh > kMaxGroups || pr.bout % kTileN ||
        pr.dout % pr.bout || pr.ks < 1 || pr.ks > kMaxSplits || pr.gps < 1 ||
        (pr.ks - 1) * pr.gps >= pr.ngh || pr.ks * pr.gps < pr.ngh)
      return (int)cudaErrorInvalidValue;
    if (pr.din > max_din) max_din = pr.din;
    const int half = pr.din / 2;
    const cuuint64_t dims[3] = {(cuuint64_t)pr.bout, (cuuint64_t)half,
                                (cuuint64_t)(pr.dout / pr.bout)};
    const cuuint64_t strides[2] = {(cuuint64_t)pr.bout, (cuuint64_t)half * pr.bout};
    const cuuint32_t box[3] = {kTileN, kGroup, 1}, elem[3] = {1, 1, 1};
    if (enc(&tm[p], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<uint8_t*>(pr.packed), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  if (a.pr[1].dout != 2 * a.inter || a.pr[2].din != a.inter || a.pr[0].dout != a.D ||
      a.pr[2].dout != a.D || a.pr[1].din != a.D || a.pr[3].din != a.D ||
      a.pr[0].din != a.hkv * a.pad * kHd)
    return (int)cudaErrorInvalidValue;
  if (a.pr[0].ks > kMaxResSplits || a.pr[2].ks > kMaxResSplits) return (int)cudaErrorInvalidValue;
  a.dig_bytes = 2 * max_din;  // (plane, digit, din/2) int8
  // vals: max_din bf16 values, or the attention's K and V chunk; with dig,
  // the scratch of the gathers: gamma, h and (o or down) partials; a merge
  // round of attention partials; the SiLU stage's columns
  int vals_bytes = 2 * max_din;
  const int need[4] = {2 * kMaxChunk * kHd * 2,
                       4 * a.D + kMaxResSplits * a.D * 4 - a.dig_bytes,
                       kMergeChunk * kAttStride * 4 - a.dig_bytes,
                       2 * a.pr[1].ks * (((a.inter + n_cta - 1) / n_cta + 3) & ~3) * 4 -
                           a.dig_bytes};
  for (int k = 0; k < 4; ++k) vals_bytes = vals_bytes > need[k] ? vals_bytes : need[k];
  vals_bytes = (vals_bytes + 15) & ~15;
  a.vals_bytes = vals_bytes;
  if (a.dig_bytes < 2 * a.D) return (int)cudaErrorInvalidValue;  // gamma stays below vals
  const int smem = 1024 + kStages * kStageBytes + a.D * 4 + a.dig_bytes + vals_bytes;
  const int st = allow_smem((const void*)decode_layer_kernel, smem, &granted);
  if (st) return st;
  void* args[] = {&tm[0], &tm[1], &tm[2], &tm[3], &a};
  return (int)cudaLaunchCooperativeKernel((const void*)decode_layer_kernel, dim3(n_cta),
                                          dim3(kThreads), args, smem,
                                          static_cast<cudaStream_t>(stream));
}
