// One bs=1 W4 decoder layer as one persistent launch, for Hopper (sm_90a):
// the port of the TPU decode megakernel vila_tpu/ops/fused_decode.py:
// _fused_layer_kernel (pallas_call :937), K3.
//
// What it computes (== fused_decode._fused_layer_ref): GQA attention of the
// rope'd, pre-scaled, group-padded q (Hkv * P heads of hd = 64 or 128) over
// the live prefix [0, n_rows) of layer l's flat (S, Hkv * hd) cache, additive f32
// mask, f32 softmax, zeros in the pad heads; then
//   h32  = h + x_att @ W_o[l]                  (f32)
//   gu   = rms(h32) * g_post[l] @ W_gu[l]      (bf16)
//   h32b = h32 + (silu(g) * u) @ W_d[l]        (f32; h_new = bf16(h32b))
//   qkv  = rms(h32b) * g_in[l+1] @ W_qkv[l+1] + b   (bf16)
// Every product keeps the TPU kernel's int8-digit arithmetic (two digits
// per half-plane, exact integer dots summed per group of input rows, f32
// group scales), with the prologue values of w4_common.cuh, as w4_gemv_sm90.cu
// and w4_gemv_mma.cu compute them. A group is any multiple of 16 rows up to
// 128 (112 at Qwen2-0.5B's D = 896): its digits are padded with zeros to the
// next multiple of 32 (the mma k step), so the weight rows a padded step
// reads past the group meet zero digits.
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
// take them, through a 6-stage ring of TMA tiles (one group's rows, padded
// to a multiple of 32, x 128 columns, 128-byte swizzle) and their scale
// rows, from the launch on:
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
// arrivals, so launches need no reset. The grid barrier, the gathers, the
// ring's stage layout and the group product are w4_persist.cuh's, shared
// with K4/K5 (w4_pair_sm90.cu).

#include <cuda_bf16.h>

#include "w4_persist.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kTileN = kPTileN;            // output columns per unit
constexpr int kStages = 6;                 // even: stage s belongs to warp set s & 1
constexpr int kWeightBytes = kPWeightBytes;
constexpr int kStageBytes = kPStageBytes;
constexpr int kMaxChunk = 64;
constexpr int kMaxP = 8;
constexpr int kMaxGroups = 128;  // per plane: din <= 32768
constexpr int kStamps = 13;  // start; after each barrier and each product's prologue; end
constexpr int kMaxSplits = 16;   // K splits of a product
constexpr int kMaxResSplits = 4;  // K splits of o and down (summed by every CTA)
constexpr int kMergeChunk = 32;  // attention partials merged per round

// attention partial of one head: max, sum, P V, pad to 16 bytes
__host__ __device__ constexpr int att_stride(int hd) { return 2 + hd + 2; }

struct Prod {
  const uint8_t* packed;  // (nj, din/2, bout) of the layer
  const bf16* scales;     // (nj, s_rows, bout) of the layer
  float* part;            // (ks, dout) partials
  int din, dout, bout, s_rows, group, gp, hp, ngh, ks, gps;  // gp: group padded; hp: ngh * gp
};

struct LayerArgs {
  const bf16* q;     // (hkv * pad, hd)
  const bf16* k;     // (S, kv_ld) of layer l
  const bf16* v;
  const float* mask;  // (>= n_rows,) additive
  const bf16* h;      // (D,)
  const bf16* gpost;  // (D,)
  const bf16* gin;    // (D,)
  const bf16* bias;   // (dq,) or null
  float* att;         // (hkv * pad, nsplit, att_stride(hd))
  bf16* x_att;        // (hkv * pad * hd,)
  bf16* m_act;        // (inter,)
  float* amax_part;   // (gridDim.x, 2)
  unsigned long long* bar;  // the grid barrier's arrival count (w4_persist.cuh)
  bf16* h_out;        // (D,)
  bf16* qkv_out;      // (dq,)
  unsigned long long* stamps;  // (kStamps,) or null
  Prod pr[4];                  // o, gate_up, down, qkv
  int n_rows, kv_ld, hkv, pad, grp, chunk, nsplit, D, inter, dig_bytes, vals_bytes;
  float eps;
};

__device__ __forceinline__ void csync() { ::csync<kConsumers>(); }

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

// the grid barrier (w4_persist.cuh; `target`: thread 0's), then CTA 0's stamp k
__device__ void grid_sync(const LayerArgs& a, unsigned long long& target, int k) {
  ::grid_sync<kConsumers>(a.bar, target);
  stamp(a, k);
}

__device__ __forceinline__ void gather(void* dst, const void* src, int rows, int chunks,
                                       size_t stride) {
  ::gather<kConsumers>(dst, src, rows, chunks, stride);
}

// ---- stage 0: one attention partial (kv head g, rows [t0, t0 + chunk)):
// the chunk's K and V rows of head g into shared memory (kvs: 2 x 64 x HD
// bf16) by cp.async, all in flight at once, then scores, softmax and P V.
// A lane holds HD / 32 elements of each head; P V runs on kConsumers / HD
// parts of the rows, summed in part order.
template <int HD>
__device__ void attn_partial(const LayerArgs& a, int g, int split, float (*sc)[kMaxChunk],
                             float* pv, float* s_ml, bf16* kvs) {
  constexpr int EPL = HD / 32, NP = kConsumers / HD, CPR = HD / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = split * a.chunk, rows = min(a.chunk, a.n_rows - t0);
  for (int idx = tid; idx < 2 * rows * CPR; idx += kConsumers) {
    const int which = idx >= rows * CPR, r = (idx - which * rows * CPR) / CPR, c = idx % CPR;
    cp_async16(kvs + (which * kMaxChunk + r) * HD + c * 8,
               (which ? a.v : a.k) + (size_t)(t0 + r) * a.kv_ld + g * HD + c * 8);
  }
  float qr[kMaxP][EPL];  // elements EPL lane .. EPL lane + EPL - 1 of each head
#pragma unroll
  for (int j = 0; j < kMaxP; ++j)
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      qr[j][i] = j < a.grp ? __bfloat162float(a.q[(size_t)(g * a.pad + j) * HD + EPL * lane + i])
                           : 0.f;
  cp_async_wait_all();
  csync();
  for (int r = warp; r < rows; r += kConsumerWarps) {
    float kf[EPL];
#pragma unroll
    for (int i = 0; i < EPL; i += 2) {
      const float2 k2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(kvs + r * HD + EPL * lane + i));
      kf[i] = k2.x;
      kf[i + 1] = k2.y;
    }
    const float mk = a.mask[t0 + r];
    float s[kMaxP];  // every head's reduction interleaved (pad heads: q = 0)
#pragma unroll
    for (int j = 0; j < kMaxP; ++j) {
      s[j] = qr[j][0] * kf[0];
#pragma unroll
      for (int i = 1; i < EPL; ++i) s[j] += qr[j][i] * kf[i];
    }
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
  {  // P V: thread (d, part hh) sums rows hh, hh + NP, ...
    const int d = tid % HD, hh = tid / HD;
    float acc[kMaxP];
#pragma unroll
    for (int j = 0; j < kMaxP; ++j) acc[j] = 0.f;
    for (int r = hh; r < rows; r += NP) {
      const float vv = __bfloat162float(kvs[(kMaxChunk + r) * HD + d]);
#pragma unroll
      for (int j = 0; j < kMaxP; ++j) acc[j] += sc[j][r] * vv;
    }
#pragma unroll
    for (int j = 0; j < kMaxP; ++j) pv[(hh * kMaxP + j) * HD + d] = acc[j];
  }
  csync();
  if (tid < HD) {
    for (int j = 0; j < a.grp; ++j) {
      float* w = a.att + ((size_t)(g * a.pad + j) * a.nsplit + split) * att_stride(HD);
      float v = pv[j * HD + tid];
#pragma unroll
      for (int hh = 1; hh < NP; ++hh) v += pv[(hh * kMaxP + j) * HD + tid];
      w[2 + tid] = v;
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
  int8_t* dig;    // (plane, digit, ngh * gp) int8, each group padded with zeros
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
  const int cpg = pr.group / 8;  // 16-byte chunks of one group and plane
  for (int z = 0; z < pr.ks; ++z) {
    if (!(need >> z & 1)) continue;
    const int g0 = z * pr.gps, g1 = min(pr.ngh, g0 + pr.gps);
    for (int k = threadIdx.x; k < (g1 - g0) * 2 * cpg; k += kConsumers) {
      int gi, p, c;
      if (cpg == 16) {  // (groups of 128: shifts)
        gi = g0 + (k >> 5), p = (k >> 4) & 1, c = k & 15;
      } else {
        gi = g0 + k / (2 * cpg), p = (k / cpg) & 1, c = k % cpg;
      }
      const size_t off = (size_t)p * half + gi * pr.group + c * 8;
      cp_async16(vals + off, src + off);
    }
  }
  cp_async_wait_all();
  csync();
}

template <int FULL>
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
  // one warp per (group, plane) block: one element a lane per 32-row step
  // (zero digits past the group's end), one reduction of the lo plane's
  // digit sums per block
  const int nblk = 2 * sm.glist[kMaxGroups];
  for (int b = warp; b < nblk; b += kConsumerWarps) {
    const int gi = sm.glist[b >> 1], p = b & 1;
    const float s1 = p ? s1h : s1l, s2 = p ? s2h : s2l;
    int a1 = 0, a2 = 0;
#pragma unroll 4
    for (int e = 0; e < (FULL ? kPGroup / 32 : pr.gp / 32); ++e) {
      const int ii = gi * pr.gp + 32 * e, el = 32 * e + lane;  // a 32-row step
      int q1 = 0, q2 = 0;
      if (el < pr.group)
        two_digits(__bfloat162float(vals[p * half + gi * pr.group + el]), s1, s2, &q1, &q2);
      sm.dig[(2 * p) * pr.hp + ii + kappa_of(lane)] = (int8_t)q1;
      sm.dig[(2 * p + 1) * pr.hp + ii + kappa_of(lane)] = (int8_t)q2;
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

// the units of one product; `it` counts ring stages as the producer does.
// FULL: the group is padded to 128 rows (four whole k steps)
template <int FULL>
__device__ void run_product(const Prod& pr, const ProdSmem& sm, int& it) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int set = warp >> 2, cw = (warp & 3) * 32, g = lane >> 2, t = lane & 3;
  const int nunits = (pr.dout / kTileN) * pr.ks;
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
      const uint8_t* st = ring_stage(sm.ring, it, kStages);
      mbar_wait(&sm.full[s], (it / kStages) & 1);
      // A rows 0 and 8: the row's two digits; rows 1-7 and 9-15 zero
      const int8_t* dg = sm.dig + gi * pr.gp + 4 * t;
      const int hp = pr.hp;
      auto load_a = [&](int ks, uint32_t (&alo)[4], uint32_t (&ahi)[4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) alo[i] = ahi[i] = 0u;
        if (g == 0) {
          const int8_t* d0 = dg + ks * 32;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            alo[2 * hh] = *reinterpret_cast<const uint32_t*>(d0 + 16 * hh);
            alo[2 * hh + 1] = *reinterpret_cast<const uint32_t*>(d0 + hp + 16 * hh);
            ahi[2 * hh] = *reinterpret_cast<const uint32_t*>(d0 + 2 * hp + 16 * hh);
            ahi[2 * hh + 1] = *reinterpret_cast<const uint32_t*>(d0 + 3 * hp + 16 * hh);
          }
        }
      };
      int ilo[4][4], ihi[4][4];
      group_dots<FULL ? kPGroup / 32 : 0>(st, pr.gp, cw, g, t, load_a, ilo, ihi);
      if (g == 0)  // the whole group's integer sums -> f32 (row 0 in lanes 0-3)
        group_scale(acc, ilo, ihi, sm.gsum[gi * 2], sm.gsum[gi * 2 + 1], sd0, sd1, sd2, sd3,
                    reinterpret_cast<const bf16*>(st + kWeightBytes) + cw + 8 * t);
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

// HD: the head dim; FULL: every product's group padded to 128 rows
template <int HD, int FULL>
__global__ void __launch_bounds__(kThreads, 1) decode_layer_kernel(
    const __grid_constant__ CUtensorMap tm_o, const __grid_constant__ CUtensorMap tm_gu,
    const __grid_constant__ CUtensorMap tm_d, const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ LayerArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  float* h32 = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  int8_t* dig = reinterpret_cast<int8_t*>(h32 + a.D);
  // each product's input values; the attention's K and V chunk
  bf16* vals = reinterpret_cast<bf16*>(dig + a.dig_bytes);
  // dig and vals together: scratch for what a stage gathers before it
  float* scratch = reinterpret_cast<float*>(dig);
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ float sc[kMaxP][kMaxChunk];
  __shared__ float pv[kConsumers * kMaxP];
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
            uint8_t* st = ring_stage(ring, it, kStages);
            mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(&full[s], ring_stage_tx(pr.gp));
            tma_load_3d(st, tm, &full[s], oo0, gi * pr.group, jb);
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
  unsigned long long target = tid == 0 ? launch_start(a.bar) : 0;  // (before any arrival)

  // 0: attention partials
  for (int u = blockIdx.x; u < a.hkv * a.nsplit; u += N)
    attn_partial<HD>(a, u / a.nsplit, u % a.nsplit, sc, pv, s_ml, vals);
  grid_sync(a, target, 1);

  // 1: merge them into x_att (pad heads: zeros), kMergeChunk splits a round
  // in split order, with this CTA's amax of each half-plane
  {
    const int half = a.pr[0].din / 2;
    float lo = 0.f, hi = 0.f;
    for (int u = blockIdx.x; u < a.hkv * a.pad; u += N) {
      if (u % a.pad >= a.grp) {  // a pad head (block-uniform)
        if (tid < HD) a.x_att[(size_t)u * HD + tid] = __float2bfloat16_rn(0.f);
        continue;
      }
      float m = -3.4e38f, l = 0.f, o = 0.f;
      for (int z0 = 0; z0 < a.nsplit; z0 += kMergeChunk) {
        const int nz = min(kMergeChunk, a.nsplit - z0);
        gather(scratch, a.att + ((size_t)u * a.nsplit + z0) * att_stride(HD), 1,
               nz * att_stride(HD) / 4, 0);
        cp_async_wait_all();
        csync();
        if (tid < HD) {
          float mz = m;
#pragma unroll 8
          for (int z = 0; z < nz; ++z) mz = fmaxf(mz, scratch[z * att_stride(HD)]);
          const float f0 = expf(m - mz);
          l *= f0;
          o *= f0;
#pragma unroll 8
          for (int z = 0; z < nz; ++z) {
            const float* w = scratch + z * att_stride(HD);
            const float f = expf(w[0] - mz);
            l += w[1] * f;
            o += w[2 + tid] * f;
          }
          m = mz;
        }
        csync();
      }
      if (tid < HD) {
        const int i = u * HD + tid;
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
  grid_sync(a, target, 2);

  // 2: o, over x_att as it is
  {
    const Prod& pr = a.pr[0];
    float lo, hi;
    amax_of_parts(a, redf, &lo, &hi);
    stage_values(pr, a.x_att, vals);
    expand_digits<FULL>(pr, sm, vals, lo, hi);
    stamp(a, 3);
    run_product<FULL>(pr, sm, it);
  }
  grid_sync(a, target, 4);

  // 3: h32 = h + o (every CTA, whole row), gate_up over rms(h32) * g_post
  {
    const Prod& pr = a.pr[1];
    float lo, hi;
    residual_and_rms(a, a.pr[0], a.h, a.gpost, h32, scratch, vals, pr.din / 2, red64, redf,
                     &lo, &hi);
    expand_digits<FULL>(pr, sm, vals, lo, hi);
    stamp(a, 5);
    run_product<FULL>(pr, sm, it);
  }
  grid_sync(a, target, 6);

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
  grid_sync(a, target, 7);

  // 5: down over the SiLU values
  {
    const Prod& pr = a.pr[2];
    float lo, hi;
    amax_of_parts(a, redf, &lo, &hi);
    stage_values(pr, a.m_act, vals);
    expand_digits<FULL>(pr, sm, vals, lo, hi);
    stamp(a, 8);
    run_product<FULL>(pr, sm, it);
  }
  grid_sync(a, target, 9);

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
    expand_digits<FULL>(pr, sm, vals, lo, hi);
    stamp(a, 10);
    run_product<FULL>(pr, sm, it);
  }
  grid_sync(a, target, 11);

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
  const int hd = in[10];
  size_t o = 0;
  auto region = [&](int k, size_t floats) {  // 256-byte aligned
    off[k] = o;
    o += (floats + 63) & ~size_t(63);
  };
  region(0, (size_t)hkv * pad * nsplit * att_stride(hd));  // attention partials
  region(1, (size_t)hkv * pad * hd / 2);                  // x_att (bf16)
  for (int p = 0; p < 4; ++p)                              // partials (ks, dout)
    region(2 + p, (size_t)in[11 + 7 * p + 5] * in[11 + 7 * p + 1]);
  region(6, (inter + 1) / 2);   // m_act (bf16)
  region(7, 2 * (size_t)n_cta);  // amax partials
  return o;
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// ints: n_rows, kv_ld, hkv, pad, grp, chunk, nsplit, D, inter, n_cta, hd (64
// or 128), then per product (o, gate_up, down, qkv) din, dout, bout, s_rows,
// group (a multiple of 16 up to 128), ks, gps, then the device index.
// decode_layer_ws_floats: the f32 workspace the plan needs.
extern "C" long long decode_layer_ws_floats(const int* ints) {
  size_t off[8];
  return (long long)ws_layout(ints, off);
}

// ptrs: q, k, v (layer l), mask, h, g_post, g_in, bias (or null), ws,
// barrier word (a zeroed u64, left counting arrivals), h_out, qkv_out, stamps
// (or null: 13 u64 %globaltimer readings of CTA 0: start; after the grid
// barriers 1, 2, 3, 4, 5, 6, 7 at 1, 2, 4, 6, 7, 9, 11; after the o,
// gate_up, down and qkv prologues at 3, 5, 8, 10; end at 12), then
// packed[4] and scales[4] of the products' layers. One CTA per
// SM (n_cta), cooperative. Returns the launch's cudaError_t.
extern "C" int decode_layer(void* const* ptrs, const int* ints, float eps, void* stream) {
  static int granted[2][2] = {{0, 0}, {0, 0}};  // [hd == 64][full]
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
  a.bar = static_cast<unsigned long long*>(ptrs[9]);
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
  const int n_cta = ints[9], hd = ints[10];
  a.eps = eps;
  // the device's context current in this thread before the descriptors
  // are encoded (a thread's first CUDA call may be this one)
  const cudaError_t dev_err = cudaSetDevice(ints[39]);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (a.n_rows < 1 || a.pad > kMaxP || a.grp > a.pad || a.chunk < 1 || a.chunk > kMaxChunk ||
      a.nsplit * a.chunk < a.n_rows || (hd != 64 && hd != 128) || a.kv_ld < a.hkv * hd ||
      n_cta < 1 || a.D % 8)
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
  int max_din = 0, max_hp = 0;
  for (int p = 0; p < 4; ++p) {
    const int* d = ints + 11 + 7 * p;
    Prod& pr = a.pr[p];
    pr.packed = static_cast<const uint8_t*>(ptrs[13 + p]);
    pr.scales = static_cast<const bf16*>(ptrs[17 + p]);
    pr.part = ws + off[2 + p];
    pr.din = d[0];
    pr.dout = d[1];
    pr.bout = d[2];
    pr.s_rows = d[3];
    pr.group = d[4];
    pr.ks = d[5];
    pr.gps = d[6];
    if (pr.group < 16 || pr.group > kPGroup || pr.group % 16 || pr.din % (2 * pr.group))
      return (int)cudaErrorInvalidValue;
    pr.gp = (pr.group + 31) & ~31;
    pr.ngh = pr.din / 2 / pr.group;
    pr.hp = pr.ngh * pr.gp;
    if (pr.ngh > kMaxGroups || pr.bout % kTileN ||
        pr.dout % pr.bout || pr.ks < 1 || pr.ks > kMaxSplits || pr.gps < 1 ||
        (pr.ks - 1) * pr.gps >= pr.ngh || pr.ks * pr.gps < pr.ngh)
      return (int)cudaErrorInvalidValue;
    if (pr.din > max_din) max_din = pr.din;
    if (pr.hp > max_hp) max_hp = pr.hp;
    if (!encode_weights(enc, &tm[p], pr.packed, pr.din, pr.dout, pr.bout, pr.gp))
      return (int)cudaErrorInvalidValue;
  }
  if (a.pr[1].dout != 2 * a.inter || a.pr[2].din != a.inter || a.pr[0].dout != a.D ||
      a.pr[2].dout != a.D || a.pr[1].din != a.D || a.pr[3].din != a.D ||
      a.pr[0].din != a.hkv * a.pad * hd)
    return (int)cudaErrorInvalidValue;
  if (a.pr[0].ks > kMaxResSplits || a.pr[2].ks > kMaxResSplits) return (int)cudaErrorInvalidValue;
  a.dig_bytes = 4 * max_hp;  // (plane, digit, ngh * gp) int8
  // vals: max_din bf16 values, or the attention's K and V chunk; with dig,
  // the scratch of the gathers: gamma, h and (o or down) partials; a merge
  // round of attention partials; the SiLU stage's columns
  int vals_bytes = 2 * max_din;
  const int need[4] = {2 * kMaxChunk * hd * 2,
                       4 * a.D + kMaxResSplits * a.D * 4 - a.dig_bytes,
                       kMergeChunk * att_stride(hd) * 4 - a.dig_bytes,
                       2 * a.pr[1].ks * (((a.inter + n_cta - 1) / n_cta + 3) & ~3) * 4 -
                           a.dig_bytes};
  for (int k = 0; k < 4; ++k) vals_bytes = vals_bytes > need[k] ? vals_bytes : need[k];
  vals_bytes = (vals_bytes + 15) & ~15;
  a.vals_bytes = vals_bytes;
  if (a.dig_bytes < 2 * a.D) return (int)cudaErrorInvalidValue;  // gamma stays below vals
  const int smem = 1024 + kStages * kStageBytes + a.D * 4 + a.dig_bytes + vals_bytes;
  bool full = true;
  for (int p = 0; p < 4; ++p) full &= a.pr[p].gp == kPGroup;
  const void* kernel =
      hd == 64 ? (full ? (const void*)decode_layer_kernel<64, 1>
                       : (const void*)decode_layer_kernel<64, 0>)
               : (full ? (const void*)decode_layer_kernel<128, 1>
                       : (const void*)decode_layer_kernel<128, 0>);
  const int st = allow_smem(kernel, smem, &granted[hd == 64][full]);
  if (st) return st;
  void* args[] = {&tm[0], &tm[1], &tm[2], &tm[3], &a};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(n_cta), dim3(kThreads), args, smem,
                                          static_cast<cudaStream_t>(stream));
}
