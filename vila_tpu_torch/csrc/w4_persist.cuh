// Machinery shared by the port's persistent W4 kernels (decode_layer_sm90.cu:
// K3, the bs=1 layer; w4_pair_sm90.cu: K4 and K5, the m <= 32 layer halves;
// w4_gemv_sm90.cu: K1's wgmma form).
// Each is one cooperative launch of one CTA per SM: a producer warp streams
// the CTA's weight tiles through an mbarrier ring of TMA stages from the
// launch on, consumer warps run the int8 products on mma.sync, and grid-wide
// barriers separate the stages that read what other CTAs wrote. Here:
//   * csync: the consumer warps' named barrier;
//   * grid_sync: the grid barrier, one 64-bit arrival count that no launch
//     resets;
//   * cp_async16 / gather: what other CTAs wrote, into shared memory
//     through L2, every copy in flight at once;
//   * the ring: stage layout (a weight box of gp <= 128 rows x 128 columns,
//     then the two scale rows) and the stage index of a ring position;
//     the proxy fence that orders other CTAs' writes before TMA reads them;
//   * the group product: one group's integer dots (the nibble planes' B
//     fragments from the stage's swizzled weight tile) on mma.sync for one
//     m16 tile of A rows (K3), or on wgmma for all rows with the weights as
//     the A operand (K4, K5, K1), and their f32 scaling per (row, group,
//     column), in the order of quant._w4_gemv_ref;
//   * a wgmma product's launch pieces (K4, K5, K1): its unit plan, ring
//     stage, row stage (the rows' digits and group sums once over the
//     grid), producers, units and split sums.
// Internal linkage, like the headers it includes.
#pragma once

#include <cuda_bf16.h>

#include "sm90_common.cuh"
#include "w4_common.cuh"

namespace {

constexpr int kPGroup = 128;  // the largest W4 group: k rows a ring stage holds
constexpr int kPTileN = 128;  // output columns a unit
constexpr int kPWeightBytes = kPGroup * kPTileN;
constexpr int kPStageBytes = (kPWeightBytes + 2 * kPTileN * 2 + 1023) & ~1023;

// bytes a stage of a product with padded group gp receives: its weight box
// (gp rows) and its two scale rows
__host__ __device__ constexpr int ring_stage_tx(int gp) { return gp * kPTileN + 2 * kPTileN * 2; }

// the named barrier 1 over the N consumer threads
template <int N>
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// The grid barrier. `word` (u64, zeroed once) counts every arrival of every
// launch and is never reset: launches of one kernel on a device all have
// gridDim.x CTAs and pass all their barriers, so a launch starts at a
// multiple of gridDim.x, and its k-th barrier is done when the count reaches
// that start + k gridDim.x. Arrivals are fire-and-forget release adds; one
// thread a CTA polls with acquire loads. (A CTA reads the start before its
// first arrival: fewer than gridDim.x arrivals can precede that read.)
__device__ __forceinline__ unsigned long long launch_start(const unsigned long long* word) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(word) : "memory");
  return v / gridDim.x * gridDim.x;
}

// until the count reaches `target` (after this, the writes of the CTAs that
// arrived are visible to the calling thread)
__device__ __forceinline__ void wait_count(const unsigned long long* word,
                                           unsigned long long target) {
  unsigned long long v;
  do {
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(word) : "memory");
  } while (v < target);
}

// every CTA's N consumers: arrive, wait for the others, then read what the
// grid wrote before it (through L2); `target` (thread 0's) is the count that
// ends this barrier, advanced here
template <int N>
__device__ void grid_sync(unsigned long long* word, unsigned long long& target) {
  csync<N>();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(word) : "memory");
    wait_count(word, target);
  }
  csync<N>();
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
// shared memory (row i at dst + i * chunks * 16), by the N consumer threads,
// every copy in flight at once; waited for by the caller
template <int N>
__device__ __forceinline__ void gather(void* dst, const void* src, int rows, int chunks,
                                       size_t stride) {
  for (int k = threadIdx.x; k < rows * chunks; k += N) {
    const int r = k / chunks, c = k - r * chunks;
    cp_async16(static_cast<char*>(dst) + 16 * k,
               static_cast<const char*>(src) + r * stride + 16 * c);
  }
}

// the ring stage of ring position `it` (stages of `bytes` each)
__device__ __forceinline__ uint8_t* ring_stage(uint8_t* ring, int it, int stages,
                                               int bytes = kPStageBytes) {
  return ring + (it % stages) * bytes;
}

// fence between this thread's generic-proxy writes to global memory and
// later async-proxy (TMA) reads of them, or between an acquire and the TMA
// reads it orders
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The integer dots of one group (gp / 32 k steps; NKS of them when NKS > 0,
// the loop then unrolled whole) for one m16 tile of A rows (digit 0 of 8
// rows, then digit 1), for the warp's 32 columns cw.. of the stage's weight
// tile: n-tile q holds columns 4n + q. la(ks, alo, ahi) gives the A
// fragments of both planes at k step ks.
template <int NKS, class LoadA>
__device__ __forceinline__ void group_dots(const uint8_t* st, int gp, int cw, int g, int t,
                                           LoadA la, int (&ilo)[4][4], int (&ihi)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) ilo[q][e] = ihi[q][e] = 0;
#pragma unroll 4
  for (int ks = 0; ks < (NKS > 0 ? NKS : gp / 32); ++ks) {
    uint32_t alo[4], ahi[4];
    la(ks, alo, ahi);
    uint32_t b0[4], b1[4];
    w4_fragments(st, ks * 32, cw, g, t, b0, b1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mma_s8(ilo[q], alo, lo_plane(b0[q]), lo_plane(b1[q]));
      mma_s8(ihi[q], ahi, hi_plane(b0[q]), hi_plane(b1[q]));
    }
  }
}

// One group's whole integer sums -> f32 for A row g (the row's digit 0 at
// accumulator e, digit 1 at 2 + e): acc[c] of column cw + 8t + c gains
// (lo - 8 gs) s1 sl + ... per digit and plane; sc holds the stage's lo scale
// row at cw + 8t and the hi row kPTileN further; sd0..sd3 = s1 lo, s2 lo, s1
// hi, s2 hi of the row (by value: a pointer to a local array would put it in
// local memory).
__device__ __forceinline__ void group_scale(float (&acc)[8], const int (&ilo)[4][4],
                                            const int (&ihi)[4][4], int gs0, int gs1,
                                            float sd0, float sd1, float sd2, float sd3,
                                            const __nv_bfloat16* sc) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 4 * e + q;
      const float sl = __bfloat162float(sc[c]);
      const float sh = __bfloat162float(sc[kPTileN + c]) / 16.0f;
      float v = acc[c];
      v += (float)(ilo[q][e] - 8 * gs0) * (sd0 * sl);
      v += (float)(ilo[q][2 + e] - 8 * gs1) * (sd1 * sl);
      v += (float)ihi[q][e] * (sd2 * sh);
      v += (float)ihi[q][2 + e] * (sd3 * sh);
      acc[c] = v;
    }
}

// The group product on wgmma (K4, K5): one group (nks = gp / 32 k steps, NKS
// of them when NKS > 0) for
// all m_pad = MPAD rows, swap-AB. A = the weights, 64 output columns a
// wgmma, from registers: thread (g, t) of warp w reads word column cw + 4g
// of the stage's weight tile at rows 8j + 2t (+ 1) of each 32-row k step and
// transposes the 4 x 4 bytes (as w4_fragments), which gives, per column c of
// its four, the k positions 4t.. and 16 + 4t.. of the digits' k order: A
// rows g and g + 8 of warp w are columns cw + 4g + 2T and + 1 in tile T (two
// tiles a warpgroup's 128 columns), masked to the lo or the hi nibble plane.
// B = the digit tile (rows (plane, digit, row), 128 bytes of k, swizzled): a
// plane's 2 MPAD rows, N = 2 MPAD. The planes run one after the other, each
// plane's s32 sums (two tiles) in registers for the group (so that nothing
// spills); two A register sets alternate between k steps, each kept until
// the wgmmas that read it are done. acc[c][2j + e] gains the
// scaled sums of row 8j + 2t + e, column cw + 4g + c (the order of
// quant._w4_gemv_ref); sl, sh: the stage's lo scales and hi scales / 16 of
// those columns; sd the rows' digit scales (4 a row, 16-byte aligned); gs
// the group's lo-plane digit sums (2 x MPAD).
template <int MPAD, int NKS>
__device__ __forceinline__ void group_product_wgmma(const uint8_t* st, const uint8_t* dig,
                                                    int nks, const int* gs, const float* sd,
                                                    int cw, int g, int t,
                                                    const float (&sl)[4], const float (&sh)[4],
                                                    float (&acc)[4][MPAD / 4]) {
  constexpr int N = 2 * MPAD;
  const int bch = (cw >> 4) + (g >> 2), bw = 4 * (g & 3);
  const int boff0 = 2 * t * 128 + ((bch ^ (2 * t)) << 4) + bw;
  const int boff1 = (2 * t + 1) * 128 + ((bch ^ (2 * t + 1)) << 4) + bw;
  // the transposed weight words of the k steps: b[ks][0][c] the k positions
  // 4t.. of column c, b[ks][1][c] the positions 16 + 4t..
  uint32_t b[4][2][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (NKS == 0 && ks >= nks) break;
    uint32_t w0[4], w1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w0[j] = *reinterpret_cast<const uint32_t*>(st + (ks * 32 + 8 * j) * 128 + boff0);
      w1[j] = *reinterpret_cast<const uint32_t*>(st + (ks * 32 + 8 * j) * 128 + boff1);
    }
    transpose4(w0, b[ks][0]);
    transpose4(w1, b[ks][1]);
  }
  // the planes one after the other (lo, then hi): the s32 sums of one plane
  // (two tiles) are live at a time
#pragma unroll
  for (int pl = 0; pl < 2; ++pl) {
    int d[2][MPAD];        // [tile][register]
    uint32_t a[2][2][4];   // [set][tile][register]
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (NKS == 0 && ks >= nks) break;  // (NKS: the steps known, no branch near a wgmma)
      const int s = ks & 1;
      if (ks >= 2) {  // the wgmmas that read set s (k step ks - 2) are done
        wg_wait<1>();
        reg_fence(a[s][0]);
        reg_fence(a[s][1]);
      }
#pragma unroll
      for (int T = 0; T < 2; ++T)
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // A rows g, g + 8: columns 2T, 2T + 1
          const uint32_t w = b[ks][r >> 1][2 * T + (r & 1)];
          a[s][T][r] = pl ? hi_plane(w) : lo_plane(w);
        }
      const uint64_t db = desc_sw128_b8(dig + 2 * pl * MPAD * 128 + ks * 32);
      wg_fence();
      wgmma_s8_rs<N>(d[0], a[s][0], db, ks > 0);
      wgmma_s8_rs<N>(d[1], a[s][1], db, ks > 0);
      wg_commit();
    }
    wg_wait<0>();
#pragma unroll
    for (int T = 0; T < 2; ++T) {
      reg_fence(d[T]);
      reg_fence(a[0][T]);
      reg_fence(a[1][T]);
    }
    // D register i of a tile: A row g + 8 ((i >> 1) & 1), B row 8 (i >> 2) +
    // 2t + (i & 1); B rows MPAD.. are digit 1 of rows 0..
#pragma unroll
    for (int j = 0; j < MPAD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * t + e;
        const int z0 = pl ? 0 : 8 * gs[n], z1 = pl ? 0 : 8 * gs[MPAD + n];
        const float2 s2 = *reinterpret_cast<const float2*>(sd + 4 * n + 2 * pl);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int T = c >> 1, i0 = 4 * j + 2 * (c & 1) + e, i1 = i0 + MPAD / 2;
          const float sc = pl ? sh[c] : sl[c];
          float v = acc[c][2 * j + e];
          v += (float)(d[T][i0] - z0) * (s2.x * sc);
          v += (float)(d[T][i1] - z1) * (s2.y * sc);
          acc[c][2 * j + e] = v;
        }
      }
  }
}

// the 3-D TMA map of a product's packed (nj, din/2, bout) slab: boxes of gp
// k rows x 128 columns, 128-byte swizzle (rows past the slab read zeros)
inline bool encode_weights(EncodeTiled enc, CUtensorMap* tm, const void* packed, int din,
                           int dout, int bout, int gp) {
  const int half = din / 2;
  const cuuint64_t dims[3] = {(cuuint64_t)bout, (cuuint64_t)half, (cuuint64_t)(dout / bout)};
  const cuuint64_t strides[2] = {(cuuint64_t)bout, (cuuint64_t)half * bout};
  const cuuint32_t box[3] = {kPTileN, (cuuint32_t)gp, 1}, elem[3] = {1, 1, 1};
  return enc(tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(packed), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


// ===========================================================================
// A wgmma product's launch (K4, K5, K1): one CTA per SM, two consumer
// warpgroups that take the ring's stages in turn (so the ring holds an even
// number of stages: stage s is always taken by one set, which waited for its
// previous phase itself; a set that waited on a stage whose previous phase
// had not completed would take that phase's parity for done) and a producer
// warpgroup: the weight warp, the digit warp, two idle warps (setmaxnreg
// works on whole warpgroups)
// ===========================================================================

constexpr int kWConsumerWarps = 8;
constexpr int kWConsumers = 32 * kWConsumerWarps;
constexpr int kWThreads = kWConsumers + 128;
constexpr int kWMaxStages = 8;
constexpr int kWMaxRows = 32;
constexpr int kWMaxSplits = 16;  // K splits of a product's tile

// one ring stage (bytes): the weight box at 0, the digit tile (4 m_pad rows
// x 128, 1024-aligned for the 128-byte swizzle) at 16384, the two scale
// rows, the group's digit sums (2 x m_pad int32)
__host__ __device__ constexpr int st_digits() { return kPWeightBytes; }
__host__ __device__ constexpr int st_scales(int m_pad) { return kPWeightBytes + 4 * m_pad * 128; }
__host__ __device__ constexpr int st_gsum(int m_pad) { return st_scales(m_pad) + 2 * kPTileN * 2; }
__host__ __device__ constexpr int stage_bytes(int m_pad) {
  return (st_gsum(m_pad) + 2 * m_pad * 4 + 1023) & ~1023;
}
__host__ __device__ constexpr int digit_tx(int m_pad) { return 4 * m_pad * 128 + 2 * m_pad * 4; }

// the ring's stages in what shared memory `fixed` bytes leave: even, at most
// kWMaxStages, 0 where fewer than 2 fit
inline int ring_stages(int m_pad, int fixed, int static_smem) {
  int st = (kMaxDynSmem - static_smem - fixed) / stage_bytes(m_pad);
  if (st > kWMaxStages) st = kWMaxStages;
  st &= ~1;
  return st;
}

struct WProd {
  const uint8_t* packed;         // (nj, din/2, bout) of the layer
  const __nv_bfloat16* scales;   // (nj, s_rows, bout) of the layer
  int8_t* dig;                   // (2 planes, 2 digits, m_pad, hp) int8
  int* gsum;                     // (ngh, 2 digits, m_pad) int32, lo plane
  float* part;                   // (splits, M, dout) f32
  int din, dout, bout, s_rows, group, gp, hp, ngh, half;
  int n_full, ks, gps;  // tiles [0, n_full) whole; the rest in ks splits of gps groups
};

// ---- the unit plan: units [0, n_full) are whole tiles; unit n_full + v is
// split z = v / rest of tile n_full + v % rest; CTA c takes units c, c + N, ...
__device__ __forceinline__ int n_units(const WProd& pr) {
  return pr.n_full + (pr.dout / kPTileN - pr.n_full) * pr.ks;
}
__device__ __forceinline__ void unit_of(const WProd& pr, int u, int& tile, int& z, int& g0,
                                        int& g1) {
  if (u < pr.n_full) {
    tile = u, z = 0, g0 = 0, g1 = pr.ngh;
    return;
  }
  const int rest = pr.dout / kPTileN - pr.n_full, v = u - pr.n_full;
  z = v / rest;
  tile = pr.n_full + v % rest;
  g0 = z * pr.gps;
  g1 = min(pr.ngh, g0 + pr.gps);
}
__device__ __forceinline__ int splits_of(const WProd& pr, int tile) {
  return tile < pr.n_full ? 1 : pr.ks;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the largest |value| over the NW consumer warps, for two values at once
// (every consumer calls; `red` holds 2 NW floats)
template <int NW>
__device__ __forceinline__ void cons_max2(float& lo, float& hi, float* red) {
  lo = warp_max(lo);
  hi = warp_max(hi);
  if ((threadIdx.x & 31) == 0) {
    red[2 * (threadIdx.x >> 5)] = lo;
    red[2 * (threadIdx.x >> 5) + 1] = hi;
  }
  csync<32 * NW>();
  lo = red[0], hi = red[1];
  for (int w = 1; w < NW; ++w) {
    lo = fmaxf(lo, red[2 * w]);
    hi = fmaxf(hi, red[2 * w + 1]);
  }
  csync<32 * NW>();
}

// the digits and lo-plane group sums of row r from its values (bf16 in
// rowv) and its half-planes' amax, into the workspace: a warp per (plane,
// group), zero digits past the group, kappa_of's k order; part `part` of
// `parts` CTAs of the row takes every parts-th run of eight blocks
__device__ __forceinline__ void row_digits(const WProd& pr, int m_pad, int r,
                                           const __nv_bfloat16* rowv, float am_lo, float am_hi,
                                           int part, int parts) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = part * kWConsumerWarps + warp; b < 2 * pr.ngh; b += kWConsumerWarps * parts) {
    const int pl = b / pr.ngh, g = b - pl * pr.ngh;
    const float s1 = fmaxf((pl ? am_hi : am_lo) / 127.0f, 1e-20f), s2 = s1 / 127.0f;
    int8_t* d0 = pr.dig + ((size_t)(2 * pl) * m_pad + r) * pr.hp + g * pr.gp;
    int8_t* d1 = d0 + (size_t)m_pad * pr.hp;
    const __nv_bfloat16* v = rowv + pl * pr.half + g * pr.group;
    float vv[4];  // (the loads before the stores)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      vv[j] = 32 * j + lane < pr.group ? __bfloat162float(v[32 * j + lane]) : 0.f;
    int a1 = 0, a2 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (32 * j >= pr.gp) break;
      int q1 = 0, q2 = 0;
      if (32 * j + lane < pr.group) two_digits(vv[j], s1, s2, &q1, &q2);
      d0[32 * j + kappa_of(lane)] = (int8_t)q1;
      d1[32 * j + kappa_of(lane)] = (int8_t)q2;
      a1 += q1;
      a2 += q2;
    }
    if (pl == 0) {  // (warp-uniform)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a1 += __shfl_xor_sync(0xffffffffu, a1, o);
        a2 += __shfl_xor_sync(0xffffffffu, a2, o);
      }
      if (lane == 0) {
        pr.gsum[((size_t)g * 2 + 0) * m_pad + r] = a1;
        pr.gsum[((size_t)g * 2 + 1) * m_pad + r] = a2;
      }
    }
  }
}

// The row stage of a product whose rows are its input as it is (K4's
// product 1, K1): row r = blockIdx.x % m_pad (of x's M rows, ldx apart; rows
// past M are zeros) is taken by parts = N / m_pad CTAs, each reading the row
// whole, 8 values a load, for its half-planes' amax (latency-bound: the same
// bits in every part) and writing a share of its digit blocks; part 0
// publishes the amax (a store: one owner) into amax[2 r], amax[2 r + 1]
__device__ __forceinline__ void rows_prologue(const WProd& pr, const __nv_bfloat16* x, int ldx,
                                              int M, int m_pad, int* amax,
                                              __nv_bfloat16* rowv, float* red) {
  const int parts = max(1, (int)gridDim.x / m_pad);
  if ((int)blockIdx.x < m_pad * parts) {
    const int r = blockIdx.x % m_pad, part = blockIdx.x / m_pad;
    float lo = 0.f, hi = 0.f;
    for (int i0 = 8 * threadIdx.x; i0 < pr.din; i0 += 4 * 8 * kWConsumers) {
      uint4 w[4];  // (the loads before the stores)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * 8 * kWConsumers;
        w[k] = make_uint4(0, 0, 0, 0);
        if (r < M && i < pr.din) w[k] = *reinterpret_cast<const uint4*>(x + (size_t)r * ldx + i);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * 8 * kWConsumers;
        if (i >= pr.din) break;
        *reinterpret_cast<uint4*>(rowv + i) = w[k];
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w[k]);
        float m = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) m = fmaxf(m, fabsf(__bfloat162float(e[q])));
        if (i < pr.half) lo = fmaxf(lo, m); else hi = fmaxf(hi, m);  // (half % 8 == 0)
      }
    }
    cons_max2<kWConsumerWarps>(lo, hi, red);  // (its barriers publish rowv)
    if (threadIdx.x == 0 && part == 0) {
      amax[2 * r] = __float_as_int(lo);
      amax[2 * r + 1] = __float_as_int(hi);
    }
    row_digits(pr, m_pad, r, rowv, lo, hi, part, parts);
  }
  fence_proxy_async_global();  // the digits are read by TMA after the barrier
}

// every row's digit scales (s1, s2 of each plane) from the grid's amax
// words (int bits of (row, plane))
__device__ __forceinline__ void row_scales(const int* amax, int m_pad, float* s_sd) {
  const int tid = threadIdx.x;
  if (tid < 2 * m_pad) {
    const float mm = __int_as_float(__ldcg(amax + tid));
    const float s1 = fmaxf(mm / 127.0f, 1e-20f);
    s_sd[2 * tid] = s1;  // (row, plane) at 4 row + 2 plane: s1, s2
    s_sd[2 * tid + 1] = s1 / 127.0f;
  }
  csync<kWConsumers>();
}

// a producer's boxes of one product, in the order the consumers take them
// (`it` counts ring positions across products): the weight warp's weight
// box and scale rows, or the digit warp's digit tile and group sums
__device__ __forceinline__ void produce(const WProd& pr, int m_pad, bool weights,
                                        const CUtensorMap* tm, int stages, int sbytes,
                                        uint8_t* ring, uint64_t* full, uint64_t* empty, int& it) {
  for (int u = blockIdx.x; u < n_units(pr); u += gridDim.x) {
    int tile, z, g0, g1;
    unit_of(pr, u, tile, z, g0, g1);
    const int n0 = tile * kPTileN, jb = n0 / pr.bout, oo0 = n0 % pr.bout;
    const __nv_bfloat16* srow = pr.scales + (size_t)jb * pr.s_rows * pr.bout + oo0;
    for (int gi = g0; gi < g1; ++gi, ++it) {
      const int s = it % stages;
      uint8_t* st = ring_stage(ring, it, stages, sbytes);
      mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
      if (weights) {
        mbar_expect_tx(&full[s], ring_stage_tx(pr.gp));
        tma_load_3d(st, tm, &full[s], oo0, gi * pr.group, jb);
        bulk_load(st + st_scales(m_pad), srow + (size_t)gi * pr.bout, kPTileN * 2, &full[s]);
        bulk_load(st + st_scales(m_pad) + kPTileN * 2, srow + (size_t)(pr.ngh + gi) * pr.bout,
                  kPTileN * 2, &full[s]);
      } else {
        mbar_expect_tx(&full[s], digit_tx(m_pad));
        tma_load_2d(st + st_digits(), tm, &full[s], gi * pr.gp, 0);
        bulk_load(st + st_gsum(m_pad), pr.gsum + (size_t)gi * 2 * m_pad, 2 * m_pad * 4, &full[s]);
      }
    }
  }
}

// the units of one product (`it` counts ring positions as the producers
// do): a split tile's unit writes its f32 partial (split z); a whole tile's
// writes bf16(sum (+ bias)) into out (M, dout) where out is given, else its
// partial
template <int MT>
__device__ __forceinline__ void run_units(const WProd& pr, int M, int stages, int sbytes,
                                          const float* s_sd, uint8_t* ring, uint64_t* full,
                                          uint64_t* empty, float* s_unit, int& it,
                                          const __nv_bfloat16* bias, __nv_bfloat16* out) {
  constexpr int kMPad = 8 * MT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int set = warp >> 2, cw = (warp & 3) * 32, g = lane >> 2, t = lane & 3;
  const int nu = n_units(pr);
  for (int u = blockIdx.x; u < nu; u += gridDim.x) {
    int tile, z, g0, g1;
    unit_of(pr, u, tile, z, g0, g1);
    float acc[4][kMPad / 4];  // [column cw + 4g + c][row 8j + 2t + e at 2j + e]
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < kMPad / 4; ++k) acc[c][k] = 0.f;
    for (int gi = g0; gi < g1; ++gi, ++it) {
      if ((it & 1) != set) continue;
      const int s = it % stages;
      const uint8_t* st = ring_stage(ring, it, stages, sbytes);
      mbar_wait(&full[s], (it / stages) & 1);
      const __nv_bfloat16* sc =
          reinterpret_cast<const __nv_bfloat16*>(st + st_scales(kMPad)) + cw + 4 * g;
      float sl[4], sh[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sl[c] = __bfloat162float(sc[c]);
        sh[c] = __bfloat162float(sc[kPTileN + c]) / 16.0f;
      }
      const int* gs = reinterpret_cast<const int*>(st + st_gsum(kMPad));
      if (pr.gp == kPGroup)  // (groups of 112 and 128: four k steps)
        group_product_wgmma<kMPad, 4>(st, st + st_digits(), 4, gs, s_sd, cw, g, t, sl, sh, acc);
      else
        group_product_wgmma<kMPad, 0>(st, st + st_digits(), pr.gp / 32, gs, s_sd, cw, g, t, sl,
                                      sh, acc);
      __syncwarp();
      mbar_arrive_if(&empty[s], lane == 0);  // the warp's reads of the stage are done
    }
    // the two sets' sums: set 1 hands its own to set 0, which writes
    const int slot = tid & 127;
    if (set == 1)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < kMPad / 4; ++k) s_unit[(c * (kMPad / 4) + k) * 128 + slot] = acc[c][k];
    csync<kWConsumers>();
    if (set == 0) {
      const int col = tile * kPTileN + cw + 4 * g;  // 4 consecutive columns
      const bool whole = splits_of(pr, tile) == 1;
#pragma unroll
      for (int k = 0; k < kMPad / 4; ++k) {
        const int r = 8 * (k >> 1) + 2 * t + (k & 1);
        if (r >= M) continue;
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = acc[c][k] + s_unit[(c * (kMPad / 4) + k) * 128 + slot];
        if (out && whole) {
          if (bias)
#pragma unroll
            for (int c = 0; c < 4; ++c) v[c] = v[c] + __bfloat162float(bias[col + c]);
          __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          *reinterpret_cast<uint2*>(out + (size_t)r * pr.dout + col) =
              make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
        } else {
          __stcg(reinterpret_cast<float4*>(pr.part + ((size_t)z * M + r) * pr.dout + col),
                 make_float4(v[0], v[1], v[2], v[3]));
        }
      }
    }
    csync<kWConsumers>();  // s_unit is free for the next unit
  }
}

// the sum of nz partials at p, p + stride, ... in split order (the loads
// issued together)
__device__ __forceinline__ float part_sum(const float* p, int nz, size_t stride) {
  float x[kWMaxSplits];
#pragma unroll
  for (int z = 0; z < kWMaxSplits; ++z) x[z] = z < nz ? __ldcg(p + z * stride) : 0.f;
  float v = 0.f;
#pragma unroll
  for (int z = 0; z < kWMaxSplits; ++z)
    if (z < nz) v += x[z];
  return v;
}

// a product's split tiles: bf16(sum of partials in split order (+ bias))
// into out (M, dout), spread over the grid
__device__ __forceinline__ void final_sum(const WProd& pr, int M, const __nv_bfloat16* bias,
                                          __nv_bfloat16* out) {
  const int rest = pr.dout / kPTileN - pr.n_full, n = M * rest * kPTileN;
  for (int i = blockIdx.x * kWConsumers + threadIdx.x; i < n; i += gridDim.x * kWConsumers) {
    const int r = i / (rest * kPTileN), col = pr.n_full * kPTileN + i % (rest * kPTileN);
    float v = part_sum(pr.part + (size_t)r * pr.dout + col, pr.ks, (size_t)M * pr.dout);
    if (bias) v = v + __bfloat162float(bias[col]);
    out[(size_t)r * pr.dout + col] = __float2bfloat16_rn(v);
  }
}

}  // namespace
