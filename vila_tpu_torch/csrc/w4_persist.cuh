// Machinery shared by the port's persistent W4 kernels (decode_layer_sm90.cu:
// K3, the bs=1 layer; w4_pair_sm90.cu: K4 and K5, the m <= 32 layer halves).
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
//     the A operand (K4, K5), and their f32 scaling per (row, group,
//     column), in the order of quant._w4_gemv_ref.
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

}  // namespace
