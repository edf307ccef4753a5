// Flash attention for training on Hopper (sm_90a), redesigned for the card's
// own tools: the forward with its log-sum-exp (K7), the dQ backward (K8) and
// the group-summed dK/dV backward (K9).
//
// Replaces (vila_tpu/ops/flash_attention.py):
//   K7 flash_fwd_sm90_kernel     <- _fwd_kernel (:50; pallas_call :229)
//   K8 flash_bwd_dq_sm90_kernel  <- _bwd_dq_kernel (:306; pallas_call :436)
//   K9 flash_bwd_dkv_sm90_kernel <- _bwd_dkv_kernel (:356; pallas_call :465),
//      and flash_dkv_group_sum_kernel <- the group sum outside it.
//
// What they compute (public layout (B, S, H, 128) bf16, LSE (B, Hq, Sq)
// f32): row r of q and column c of k/v may attend when c < Skv, r < Sq,
// (not causal or r >= c) and q_seg[r] == kv_seg[c]; scores (q . k in f32) *
// scale; P, and dS, rounded to bf16 before their products; the backward
// recomputes P from the saved LSE and takes delta = rowsum(dO * O) from the
// caller; a row with nothing to attend to writes O = 0 and LSE = -1e30 and
// carries no gradient; causal only when Sq == Skv.
//
// Bound on this card, at the NVILA-Lite-2B training shape (B 1, S 2048,
// 12/2 heads of 128): operations. Each product is 2 * 128 flops per (q, k)
// pair; K7 runs 2 products, K8 3, K9 4. Causal alone leaves S^2/2 pairs per
// head: 12.9 GFLOP for K7 (13 us at 989 TFLOP/s), 19.3 for K8 (20 us) and
// 25.8 for K9 (26 us). The smoke's packed row (three samples and a padding
// tail) allows 0.68 M pairs per head: 4.2, 6.3 and 8.4 GFLOP, where K7's
// 13.7 MB of q, k, v, o and LSE (4.1 us at 3.35 TB/s) come within a few
// percent of its operations.
//
// Design. Each CTA is three warpgroups: a producer warpgroup (setmaxnreg
// down to 24 registers) whose first warp keeps TMA loads in flight, and two
// consumer warpgroups (240 registers) that each own 64 rows of the CTA's
// 128-row tile and run every product as wgmma with f32 accumulators in
// registers. Operand tiles arrive by TMA with 128-byte swizzle (a 128-wide
// bf16 row is two 64-column boxes; rows past S are zero-filled) into a
// ring of kStages (3) stages, each guarded by a full and an empty mbarrier;
// no __syncthreads after the prologue. (ptxas gives the consumers their 240
// registers only when the kernel holds no __trap(); a branch around a
// barrier arrival while a wgmma is in flight makes it serialize the wgmmas,
// so arrivals are predicated inside the instruction.)
//   K7: one CTA per (128-row q tile, q head); Q is loaded once, K and V of
//       kv head h / G (GQA without copies) stream through the ring, K and
//       V with full and empty barriers of their own (K's slot is free once
//       S is computed, V's once P V is). S = Q K^T is wgmma SS (both
//       K-major); the online softmax stays in registers (exp2 domain); P is
//       rounded to bf16 in the A-register layout (the accumulator layout of
//       wgmma is the A-fragment layout, 16 rows per warp) and O += P V is
//       wgmma RS with V's tile as the MN-major B operand. S of the next tile
//       is issued with P V of this one, so that its softmax runs while P V
//       does, and the two consumer warpgroups take turns to issue (named
//       barriers, ping-pong), so that one's softmax overlaps the other's
//       products. The grid is ordered so that the q tiles with the most kv
//       tiles start first.
//   K8: one CTA per (128-row q tile, q head), ordered as K7's; Q and dO are
//       loaded once, K and V of kv head h / G stream through the ring 64
//       rows at a time (one full and one empty barrier per stage: the slot
//       is free once dQ += dS K is done). S = Q K^T and dP = dO V^T are
//       wgmma SS (m64n64); P is recomputed from the LSE in the exp2 domain
//       (a row whose LSE is -1e30 gets +inf, so P = 0); dS = P * (dP -
//       delta) is rounded to bf16 in the A-register layout and dQ += dS K is
//       wgmma RS with K's tile as the MN-major B operand. dQ stays in
//       registers (64 a thread) and is written once, scaled and rounded:
//       no workspace, no atomics, deterministic.
//   K9: one CTA per (128-row kv tile, q head); K and V are loaded once; the
//       head's q rows stream through the ring 64 at a time (Q, dO by TMA;
//       the producer warp stages their LSE, delta and segment codes). S^T =
//       K Q^T and dP^T = V dO^T are wgmma SS (m64n64); P^T and dS^T =
//       P^T * (dP^T - delta) are rounded to bf16 in registers; dV += P^T dO
//       and dK += dS^T Q are wgmma RS (dO and Q MN-major). dK and dV stay
//       in registers (128 a thread) and are written per head in f32; a
//       second launch sums each group's heads in head order and rounds once
//       (no atomics: deterministic).
//   All three skip tiles that the masks empty. Causal tiles past the diagonal
//   are never walked; with segments, a tile pair is walked only when the
//   ranges of its segment ids meet, with the collator's padding id 0
//   ordered above every sample id (padding attends only to padding). A
//   skipped tile's scores would all be -inf: it changes no running max, no
//   l, dQ, dK or dV. The prologue builds the CTA's list of live tiles (one warp
//   per tile computes its range, one warp compacts); tiles wholly inside
//   one segment, below the diagonal and inside the sequence are also
//   marked as needing no per-element mask.

#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int kD = 128;           // head dim
constexpr int kTile = 128;        // rows of the CTA's own tile; K7's kv tiles
constexpr int kQc = 64;           // K9: q rows per ring stage
constexpr int kStages = 3;        // ring depth
constexpr int kThreads = 384;     // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr float kNoRow = -1e30f;  // LSE of a row with nothing to attend to
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// out-of-range rows and columns get segment codes that never match
constexpr int kOutQ = INT_MIN;
constexpr int kOutKv = INT_MIN + 1;
constexpr int kPadKey = INT_MAX;  // the padding id 0 in the tile-range test
constexpr int kNeedMask = 1 << 30;

// shared memory (bytes from a 1024-aligned base)
constexpr int kTileBytes = kTile * kD * 2;  // 32 KB
constexpr int kQcBytes = kQc * kD * 2;      // 16 KB
constexpr int kFwdBars = kTileBytes + kStages * 2 * kTileBytes;
constexpr int kBwdAux = 2 * kTileBytes + kStages * 2 * kQcBytes;
constexpr int kAuxBytes = 3 * kQc * 4;  // LSE (log2), delta, segment codes
constexpr int kBwdBars = kBwdAux + kStages * kAuxBytes;
constexpr int kDqBars = 2 * kTileBytes + kStages * 2 * kQcBytes;  // K8: Q, dO, ring
constexpr int kBarBytes = 128;           // the mbarriers
constexpr int kListOff = kBarBytes + 16; // the live-tile count, then the list

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// PTX helpers: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

// named barriers 1 and 2 (0 is __syncthreads) between the two consumer
// warpgroups: 256 threads, 128 waiting and 128 arriving
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive_if(int id, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p bar.arrive %0, 256;\n}\n" ::"r"(id),
      "r"((int)pred)
      : "memory");
}

// one box (64 columns x rows) of a (B, S, H, 128) tensor: column c0, head,
// first row, batch
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int head, int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(head), "r"(row0),
      "r"(b)
      : "memory");
}

// a tile of `rows` rows x 128 columns: two 64-column halves, one after the other
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int rows, int head, int row0, int b) {
  tma_load(dst, map, bar, 0, head, row0, b);
  tma_load(dst + rows * 64, map, bar, 64, head, row0, b);
}

// 2^x in one MUFU instruction (exp2(-inf) = 0, results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragments (64 x 16, bf16) of k-step kk from a 64 x N f32
// accumulator: wgmma's accumulator layout (per warp 16 rows; value 4j + 2i
// + e at row g + 8i, column 8j + 2t + e) is its A-register layout
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&x)[N], int kk) {
  a[0] = pack2(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack2(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack2(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack2(x[8 * kk + 6], x[8 * kk + 7]);
}

__device__ __forceinline__ int seg_key(int s) { return s == 0 ? kPadKey : s; }

// [lo, hi] of the segment keys of rows [r0, min(r0 + N, seq)), by one warp
// (all N / 32 loads of a lane in flight at once)
template <int N>
__device__ __forceinline__ int2 warp_range(const int* seg, int r0, int seq) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int x = 0; x < N / 32; ++x) {
    const int r = r0 + lane + 32 * x;
    if (r < seq) {
      const int k = seg_key(seg[r]);
      lo = min(lo, k);
      hi = max(hi, k);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return make_int2(lo, hi);
}

// The live tiles of one CTA, in walking order, by all its threads. The CTA
// owns rows [own0, own0 + kTile) of a sequence of own_n rows (segment ids
// own_seg, this batch row's); it walks tiles i in [i0, i1) of TW rows of
// the other side (walk_seg, walk_n rows). own_is_q says which side is q
// (for the causal diagonal). Writes list[k] = i | kNeedMask (when some
// pair of the tile may be masked) and returns the count. Segment pointers
// are null without segments.
template <int TW>
__device__ __forceinline__ int plan_tiles(int* list, int* count, const int* own_seg, int own0,
                                          int own_n, const int* walk_seg, int walk_n, int i0,
                                          int i1, bool own_is_q, int causal) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int2 own = own_seg ? warp_range<kTile>(own_seg, own0, own_n) : make_int2(0, 0);
  const bool own_ragged = own0 + kTile > own_n;
  for (int i = i0 + warp; i < i1; i += nwarps) {
    const int w0 = i * TW;
    int flag = 1;  // live, no per-element mask
    bool mask = own_ragged || w0 + TW > walk_n;
    if (walk_seg) {
      const int2 wr = warp_range<TW>(walk_seg, w0, walk_n);
      if (wr.x > own.y || own.x > wr.y) flag = 0;
      mask |= !(own.x == own.y && wr.x == wr.y && own.x == wr.x);
    }
    if (causal) {  // some column above some row of the pair
      const int q_lo = own_is_q ? own0 : w0;
      const int kv_hi = own_is_q ? w0 + TW - 1 : own0 + kTile - 1;
      mask |= kv_hi > q_lo;
    }
    if (lane == 0) list[i - i0] = flag ? (mask ? 2 : 1) : 0;
  }
  __syncthreads();
  // compact in place: entry k is written at or below k, after its read
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < i1 - i0; base += 32) {
      const int f = base + lane < i1 - i0 ? list[base + lane] : 0;
      const unsigned live = __ballot_sync(0xffffffffu, f != 0);
      __syncwarp();
      if (f) list[n + __popc(live & ((1u << lane) - 1u))] =
          (i0 + base + lane) | (f == 2 ? kNeedMask : 0);
      n += __popc(live);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return __shfl_sync(0xffffffffu, *count, 0);  // warp-uniform for the compiler
}

// ---------------------------------------------------------------------------
// K7: forward. Grid (Hq, q tiles, B), the last q tile first.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, bf16* __restrict__ o, float* __restrict__ lse, int sq,
    int skv, int hq, int hkv, int causal, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = reinterpret_cast<bf16*>(smem + kTileBytes);  // stage s: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kFwdBars);
  uint64_t* full_k = q_full + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;  // K is free once S is computed,
  uint64_t* empty_v = empty_k + kStages; // V's once P V is
  int* count = reinterpret_cast<int*>(smem + kFwdBars + kBarBytes);
  int* list = reinterpret_cast<int*>(smem + kFwdBars + kListOff);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int hk = h / (hq / hkv);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], kConsumerWarps);
      mbar_init(&empty_v[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, kTileBytes);  // Q arrives while the tiles are planned
    tma_tile(sQ, &tm_q, q_full, kTile, h, q0, b);
  }
  const int n_kv = (skv + kTile - 1) / kTile;
  const int kv_end = causal ? min(n_kv, (q0 + kTile - 1) / kTile + 1) : n_kv;
  const int n = plan_tiles<kTile>(list, count, q_seg ? q_seg + (size_t)b * sq : nullptr, q0,
                                  sq, kv_seg ? kv_seg + (size_t)b * skv : nullptr, skv, 0,
                                  kv_end, true, causal);

  // the warpgroup's role, warp-uniform for the compiler (setmaxnreg needs it)
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 0 && lane == 0) {
      for (int it = 0; it < n; ++it) {
        const int s = it % kStages;
        const uint32_t ph = ((it / kStages) & 1) ^ 1;
        const int j0 = (list[it] & (kNeedMask - 1)) * kTile;
        bf16* sK = sKV + s * 2 * kTile * kD;
        mbar_wait(&empty_k[s], ph);
        mbar_expect_tx(&full_k[s], kTileBytes);
        tma_tile(sK, &tm_k, &full_k[s], kTile, hk, j0, b);
        mbar_wait(&empty_v[s], ph);
        mbar_expect_tx(&full_v[s], kTileBytes);
        tma_tile(sK + kTile * kD, &tm_v, &full_v[s], kTile, hk, j0, b);
      }
    }
  } else {  // consumers: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = (warp >> 2) - 1, w = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int row = q0 + wg * 64 + w * 16 + g;  // this thread's rows: row, row + 8
    int qcode[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      qcode[i] = r < sq ? (q_seg ? q_seg[(size_t)b * sq + r] : 0) : kOutQ;
    }
    const float c = scale * kLog2e;  // scores in the exp2 domain
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m[2] = {kNoRow, kNoRow}, l[2] = {0.f, 0.f};
    const bf16* sQw = sQ + wg * 64 * 64;  // this warpgroup's rows of each half

    // Pipelined walk: S of tile it + 1 is issued together with P V of tile
    // it, so that tile it + 1's softmax runs while P V still does.
    float sc[64];  // the scores of the tile in hand
    uint32_t pa[8][4];
    int kcode[32];  // its columns' segment codes (tiles that need a mask)
    auto fetch_codes = [&](int e) {
      const int j0 = (e & (kNeedMask - 1)) * kTile;
      if (e & kNeedMask) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int col = j0 + 8 * j + 2 * t + x;
            kcode[2 * j + x] =
                col < skv ? (kv_seg ? kv_seg[(size_t)b * skv + col] : 0) : kOutKv;
          }
      }
    };
    // The warpgroups take turns to issue their products (ping-pong), so that
    // one's softmax runs while the other's products do; the second lets the
    // first go first.
    named_arrive_if(1, wg == 1);
    mbar_wait(q_full, 0);
    if (n > 0) {
      mbar_wait(&full_k[0], 0);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n128(sc, desc_k(sQw, kTile, 0, kk), desc_k(sKV, kTile, 0, kk), kk > 0);
      wg_commit();
      fetch_codes(__shfl_sync(0xffffffffu, list[0], 0));
      wg_wait<0>();
      reg_fence(sc);
      mbar_arrive_if(&empty_k[0], lane == 0);
    }
    for (int it = 0; it < n; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int e = __shfl_sync(0xffffffffu, list[it], 0);  // warp-uniform
      const int j0 = (e & (kNeedMask - 1)) * kTile;
      const bool need = e & kNeedMask;
      const bf16* sV = sKV + s * 2 * kTile * kD + kTile * kD;

      // mask; running max per row (raw scores: the scale is positive)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            float v = sc[4 * j + 2 * i + x];
            if (need) {
              const int col = j0 + 8 * j + 2 * t + x;
              const bool ok =
                  qcode[i] == kcode[2 * j + x] && (!causal || row + 8 * i >= col);
              v = ok ? v : -INFINITY;
            }
            sc[4 * j + 2 * i + x] = v;
            mx[i] = fmaxf(mx[i], v);
          }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * c);  // the exp2 domain
        corr[i] = exp2_fast(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int idx = 0; idx < 64; ++idx) {  // masked: exp2(-inf) = 0
        const float p = exp2_fast(fmaf(sc[idx], c, -m[(idx >> 1) & 1]));
        sc[idx] = p;
        l[(idx >> 1) & 1] += p;
      }
      // P V of the previous tile is done (unconditionally waited, so that
      // ptxas sees O settled on every path): O and P are free, its V slot too
      wg_wait<0>();
      reg_fence(acc);
      mbar_arrive_if(&empty_v[(it + kStages - 1) % kStages], lane == 0 && it > 0);
#pragma unroll
      for (int idx = 0; idx < 64; ++idx) acc[idx] *= corr[(idx >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) to_a(pa[kk], sc, kk);  // P rounded to bf16

      // S of the next tile, then O += P V (V MN-major)
      const bool next = it + 1 < n;
      const int s1 = (it + 1) % kStages;
      if (next) mbar_wait(&full_k[s1], ((it + 1) / kStages) & 1);
      mbar_wait(&full_v[s], ph);
      named_sync(1 + wg);
      wg_fence();
      if (next) {
        const bf16* sK1 = sKV + s1 * 2 * kTile * kD;
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          wgmma_ss_n128(sc, desc_k(sQw, kTile, 0, kk), desc_k(sK1, kTile, 0, kk), kk > 0);
        wg_commit();
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) wgmma_rs_n128(acc, pa[kk], desc_mn(sV, kTile, kk));
      wg_commit();
      // the other warpgroup's turn (the second's last turn is not taken)
      named_arrive_if(2 - wg, wg == 0 || next);
      fetch_codes(__shfl_sync(0xffffffffu, list[next ? it + 1 : it], 0));
      // the next S is in, P V may still run (waited on every path, so that
      // ptxas sees the scores settled and keeps the wgmmas asynchronous)
      wg_wait<1>();
      reg_fence(sc);
      mbar_arrive_if(&empty_k[s1], lane == 0 && next);
    }
    wg_wait<0>();
    reg_fence(acc);
    mbar_arrive_if(&empty_v[(n + kStages - 1) % kStages], lane == 0 && n > 0);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lr = l[i];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int r = row + 8 * i;
      if (r >= sq) continue;
      const float inv = lr == 0.f ? 0.f : 1.f / lr;
      bf16* orow = o + (((size_t)b * sq + r) * hq + h) * kD;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack2(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
      if (t == 0)
        lse[((size_t)b * hq + h) * sq + r] = lr == 0.f ? kNoRow : m[i] * kLn2 + logf(lr);
    }
  }
}

// ---------------------------------------------------------------------------
// K9, pass 1: per query head dK and dV of one kv tile, f32 into a workspace
// (B, Skv, Hq, D). Grid (Hq, kv tiles, B).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg, float* __restrict__ ws_k,
    float* __restrict__ ws_v, int sq, int skv, int hq, int hkv, int causal, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kTile * kD;
  bf16* sQdO = sV + kTile * kD;  // stage s: Q (64 rows), then dO
  float* aux = reinterpret_cast<float*>(smem + kBwdAux);  // stage s: LSE2, delta, codes
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + kBwdBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  int* count = reinterpret_cast<int*>(smem + kBwdBars + kBarBytes);
  int* list = reinterpret_cast<int*>(smem + kBwdBars + kListOff);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.z;
  const int kv0 = blockIdx.y * kTile;
  const int hk = h / (hq / hkv);
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes (aux rows), one with the bytes
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kv_full, 2 * kTileBytes);  // K and V arrive while the tiles are planned
    tma_tile(sK, &tm_k, kv_full, kTile, hk, kv0, b);
    tma_tile(sV, &tm_v, kv_full, kTile, hk, kv0, b);
  }
  // under causality the q chunk holding row kv0 is the first with any work
  const int n_qc = (sq + kQc - 1) / kQc;
  const int n = plan_tiles<kQc>(list, count, kv_seg ? kv_seg + (size_t)b * skv : nullptr, kv0,
                                skv, q_seg ? q_seg + (size_t)b * sq : nullptr, sq,
                                causal ? kv0 / kQc : 0, n_qc, false, causal);

  // the warpgroup's role, warp-uniform for the compiler (setmaxnreg needs it)
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 0) {
      const size_t row_base = ((size_t)b * hq + h) * sq;
      for (int it = 0; it < n; ++it) {
        const int s = it % kStages;
        const int i0 = (list[it] & (kNeedMask - 1)) * kQc;
        float* ax = aux + s * (kAuxBytes / 4);
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int rr = lane + 32 * x, r = i0 + rr;
          const bool in = r < sq;
          const float L = in ? lse[row_base + r] : kNoRow;
          // a row without any key gets +inf: exp2(s - inf) = 0, no gradient
          ax[rr] = L > 0.5f * kNoRow ? L * kLog2e : INFINITY;
          ax[kQc + rr] = in ? delta[row_base + r] : 0.f;
          reinterpret_cast<int*>(ax)[2 * kQc + rr] =
              in ? (q_seg ? q_seg[(size_t)b * sq + r] : 0) : kOutQ;
        }
        if (lane == 0) {
          bf16* sQs = sQdO + s * 2 * kQc * kD;
          mbar_expect_tx(&full[s], 2 * kQcBytes);
          tma_tile(sQs, &tm_q, &full[s], kQc, h, i0, b);
          tma_tile(sQs + kQc * kD, &tm_do, &full[s], kQc, h, i0, b);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {  // consumers: 64 kv rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = (warp >> 2) - 1, w = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int krow = kv0 + wg * 64 + w * 16 + g;  // this thread's kv rows: krow, krow + 8
    int kcode[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = krow + 8 * i;
      kcode[i] = r < skv ? (kv_seg ? kv_seg[(size_t)b * skv + r] : 0) : kOutKv;
    }
    const float c = scale * kLog2e;
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    const bf16* sKw = sK + wg * 64 * 64;
    const bf16* sVw = sV + wg * 64 * 64;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int e = __shfl_sync(0xffffffffu, list[it], 0);  // warp-uniform
      const int i0 = (e & (kNeedMask - 1)) * kQc;
      const bool need = e & kNeedMask;
      const bf16* sQs = sQdO + s * 2 * kQc * kD;
      const bf16* sdO = sQs + kQc * kD;
      const float* l2 = aux + s * (kAuxBytes / 4);
      const float* dl = l2 + kQc;
      const int* qc = reinterpret_cast<const int*>(l2 + 2 * kQc);

      // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x 64 q columns per warpgroup
      float st[32], dpt[32];
      mbar_wait(&full[s], ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n64(st, desc_k(sKw, kTile, 0, kk), desc_k(sQs, kQc, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n64(dpt, desc_k(sVw, kTile, 0, kk), desc_k(sdO, kQc, 0, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      reg_fence(st);
      reg_fence(dpt);

      // P^T and dS^T = P^T * (dP^T - delta)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int col = 8 * j + 2 * t + x;  // q row of the chunk
          const float lq = l2[col], dq = dl[col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int idx = 4 * j + 2 * i + x;
            float p = exp2_fast(st[idx] * c - lq);
            if (need) {
              const bool ok =
                  qc[col] == kcode[i] && (!causal || i0 + col >= krow + 8 * i);
              p = ok ? p : 0.f;
            }
            st[idx] = p;
            dpt[idx] = p * (dpt[idx] - dq);
          }
        }

      // dV += P^T dO and dK += dS^T Q, both rounded to bf16; dO and Q MN-major
      uint32_t pa[4][4], pd[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        to_a(pa[kk], st, kk);
        to_a(pd[kk], dpt, kk);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kQc / 16; ++kk) wgmma_rs_n128(dv, pa[kk], desc_mn(sdO, kQc, kk));
#pragma unroll
      for (int kk = 0; kk < kQc / 16; ++kk) wgmma_rs_n128(dk, pd[kk], desc_mn(sQs, kQc, kk));
      wg_commit();
      wg_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
      mbar_arrive_if(&empty[s], lane == 0);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = krow + 8 * i;
      if (r >= skv) continue;
      const size_t off = (((size_t)b * skv + r) * hq + h) * kD;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(ws_k + off + 8 * j + 2 * t) =
            make_float2(dk[4 * j + 2 * i] * scale, dk[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<float2*>(ws_v + off + 8 * j + 2 * t) =
            make_float2(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K9, pass 2: dK and dV = the group's per-head blocks summed in head order
// (the TPU kernel's group sum outside), rounded once. One thread per output
// element of (B, Skv, Hkv, D).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256) flash_dkv_group_sum_kernel(
    const float* __restrict__ ws_k, const float* __restrict__ ws_v, bf16* __restrict__ dk,
    bf16* __restrict__ dv, long long n, int hkv, int grp) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int d = (int)(i % kD);
  const long long row = i / kD;  // (b * Skv + r) * hkv + hk
  const long long src = ((row / hkv) * hkv * grp + (row % hkv) * grp) * kD + d;
  float sk = 0.f, sv = 0.f;
  for (int gi = 0; gi < grp; ++gi) {
    sk += ws_k[src + (long long)gi * kD];
    sv += ws_v[src + (long long)gi * kD];
  }
  dk[i] = __float2bfloat16_rn(sk);
  dv[i] = __float2bfloat16_rn(sv);
}

// ---------------------------------------------------------------------------
// K8: dQ of one 128-row q tile of one query head, written once in bf16.
// Grid (Hq, q tiles, B), the last q tile first.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg, bf16* __restrict__ dq,
    int sq, int skv, int hq, int hkv, int causal, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kTile * kD;
  bf16* sKV = sdO + kTile * kD;  // stage s: K (64 rows), then V
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(smem + kDqBars);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + kStages;
  int* count = reinterpret_cast<int*>(smem + kDqBars + kBarBytes);
  int* list = reinterpret_cast<int*>(smem + kDqBars + kListOff);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int hk = h / (hq / hkv);
  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qd_full, 2 * kTileBytes);  // Q and dO arrive while the tiles are planned
    tma_tile(sQ, &tm_q, qd_full, kTile, h, q0, b);
    tma_tile(sdO, &tm_do, qd_full, kTile, h, q0, b);
  }
  const int n_kv = (skv + kQc - 1) / kQc;
  const int kv_end = causal ? min(n_kv, (q0 + kTile - 1) / kQc + 1) : n_kv;
  const int n = plan_tiles<kQc>(list, count, q_seg ? q_seg + (size_t)b * sq : nullptr, q0, sq,
                                kv_seg ? kv_seg + (size_t)b * skv : nullptr, skv, 0, kv_end,
                                true, causal);

  // the warpgroup's role, warp-uniform for the compiler (setmaxnreg needs it)
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 0 && lane == 0) {
      for (int it = 0; it < n; ++it) {
        const int s = it % kStages;
        const int j0 = (list[it] & (kNeedMask - 1)) * kQc;
        bf16* sK = sKV + s * 2 * kQc * kD;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kQcBytes);
        tma_tile(sK, &tm_k, &full[s], kQc, hk, j0, b);
        tma_tile(sK + kQc * kD, &tm_v, &full[s], kQc, hk, j0, b);
      }
    }
  } else {  // consumers: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = (warp >> 2) - 1, w = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int row = q0 + wg * 64 + w * 16 + g;  // this thread's rows: row, row + 8
    int qcode[2];
    float l2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      const bool in = r < sq;
      qcode[i] = in ? (q_seg ? q_seg[(size_t)b * sq + r] : 0) : kOutQ;
      const float L = in ? lse[((size_t)b * hq + h) * sq + r] : kNoRow;
      // a row without any key gets +inf: exp2(s - inf) = 0, no gradient
      l2[i] = L > 0.5f * kNoRow ? L * kLog2e : INFINITY;
      dl[i] = in ? delta[((size_t)b * hq + h) * sq + r] : 0.f;
    }
    const float c = scale * kLog2e;  // scores in the exp2 domain
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const bf16* sQw = sQ + wg * 64 * 64;  // this warpgroup's rows of each half
    const bf16* sdOw = sdO + wg * 64 * 64;

    mbar_wait(qd_full, 0);
    for (int it = 0; it < n; ++it) {
      const int s = it % kStages;
      const int e = __shfl_sync(0xffffffffu, list[it], 0);  // warp-uniform
      const int j0 = (e & (kNeedMask - 1)) * kQc;
      const bool need = e & kNeedMask;
      const bf16* sK = sKV + s * 2 * kQc * kD;
      const bf16* sV = sK + kQc * kD;
      int kcode[16];  // this thread's columns' segment codes (tiles that need a mask)
      if (need) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int col = j0 + 8 * j + 2 * t + x;
            kcode[2 * j + x] = col < skv ? (kv_seg ? kv_seg[(size_t)b * skv + col] : 0) : kOutKv;
          }
      }

      // S = Q K^T and dP = dO V^T: 64 q rows x 64 kv columns per warpgroup
      float sc[32], dp[32];
      mbar_wait(&full[s], (it / kStages) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n64(sc, desc_k(sQw, kTile, 0, kk), desc_k(sK, kQc, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n64(dp, desc_k(sdOw, kTile, 0, kk), desc_k(sV, kQc, 0, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      reg_fence(sc);
      reg_fence(dp);

      // P from the LSE, dS = P * (dP - delta)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int idx = 4 * j + 2 * i + x;
            float p = exp2_fast(sc[idx] * c - l2[i]);
            if (need) {
              const int col = j0 + 8 * j + 2 * t + x;
              const bool ok = qcode[i] == kcode[2 * j + x] && (!causal || row + 8 * i >= col);
              p = ok ? p : 0.f;
            }
            sc[idx] = p * (dp[idx] - dl[i]);
          }

      // dQ += dS K, dS rounded to bf16; K MN-major
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) to_a(pa[kk], sc, kk);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kQc / 16; ++kk) wgmma_rs_n128(acc, pa[kk], desc_mn(sK, kQc, kk));
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
      mbar_arrive_if(&empty[s], lane == 0);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      if (r >= sq) continue;
      bf16* drow = dq + (((size_t)b * sq + r) * hq + h) * kD;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(drow + 8 * j + 2 * t) =
            pack2(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

int check_shape(int batch, int sq, int skv, int hq, int hkv, int d, int causal) {
  if (d != kD || batch < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv || batch > 65535 ||
      hq > 65535 || (causal && sq != skv))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// a (B, S, H, 128) bf16 tensor as TMA boxes of 64 columns x `rows` rows of
// one head, 128-byte swizzle; rows past S read as zeros
int make_map(CUtensorMap* map, const void* p, int batch, int seq, int heads, int rows) {
  const EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorSharedObjectInitFailed;
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)kD * 2, (cuuint64_t)heads * kD * 2,
                                 (cuuint64_t)seq * heads * kD * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes), the signatures of the first
// mma.sync versions of K7-K9; each returns cudaGetLastError() or an error for what it
// does not take. q, o, do are (B, Sq, Hq, 128) and k, v, dk, dv
// (B, Skv, Hkv, 128) contiguous bf16, 16-byte aligned; lse and delta
// (B, Hq, Sq) f32; q_seg (B, Sq) and kv_seg (B, Skv) int32, both null
// without segments. causal needs Sq == Skv.

extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* q_seg,
                         const void* kv_seg, void* o, void* lse, int batch, int sq, int skv,
                         int hq, int hkv, int d, int causal, float scale, void* stream) {
  int st = check_shape(batch, sq, skv, hq, hkv, d, causal);
  if (st) return st;
  const int n_kv = (skv + kTile - 1) / kTile;
  const int smem = 1024 + kFwdBars + kListOff + 4 * n_kv;
  static int granted = 0;
  st = allow_smem((const void*)flash_fwd_sm90_kernel, smem, &granted);
  CUtensorMap tq, tk, tv;
  if (!st) st = make_map(&tq, q, batch, sq, hq, kTile);
  if (!st) st = make_map(&tk, k, batch, skv, hkv, kTile);
  if (!st) st = make_map(&tv, v, batch, skv, hkv, kTile);
  if (st) return st;
  const dim3 grid(hq, (sq + kTile - 1) / kTile, batch);
  flash_fwd_sm90_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<bf16*>(o), static_cast<float*>(lse), sq, skv, hq, hkv, causal, scale);
  return (int)cudaGetLastError();
}

// flash_bwd_dkv: ws holds 2 * B * Skv * Hq * 128 f32 (the per-head dK, then
// dV blocks); two launches.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* q_seg,
                             const void* kv_seg, void* ws, void* dk, void* dv, int batch,
                             int sq, int skv, int hq, int hkv, int d, int causal, float scale,
                             void* stream) {
  int st = check_shape(batch, sq, skv, hq, hkv, d, causal);
  if (st) return st;
  const int n_qc = (sq + kQc - 1) / kQc;
  const int smem = 1024 + kBwdBars + kListOff + 4 * n_qc;
  static int granted = 0;
  st = allow_smem((const void*)flash_bwd_dkv_sm90_kernel, smem, &granted);
  CUtensorMap tq, tk, tv, tdo;
  if (!st) st = make_map(&tq, q, batch, sq, hq, kQc);
  if (!st) st = make_map(&tdo, dout, batch, sq, hq, kQc);
  if (!st) st = make_map(&tk, k, batch, skv, hkv, kTile);
  if (!st) st = make_map(&tv, v, batch, skv, hkv, kTile);
  if (st) return st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws_k = static_cast<float*>(ws);
  float* ws_v = ws_k + (size_t)batch * skv * hq * kD;
  const dim3 grid(hq, (skv + kTile - 1) / kTile, batch);
  flash_bwd_dkv_sm90_kernel<<<grid, kThreads, smem, s>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), ws_k, ws_v, sq, skv, hq,
      hkv, causal, scale);
  const long long n = (long long)batch * skv * hkv * kD;
  flash_dkv_group_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      ws_k, ws_v, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, hkv, hq / hkv);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* q_seg,
                            const void* kv_seg, void* dq, int batch, int sq, int skv, int hq,
                            int hkv, int d, int causal, float scale, void* stream) {
  int st = check_shape(batch, sq, skv, hq, hkv, d, causal);
  if (st) return st;
  const int n_kv = (skv + kQc - 1) / kQc;
  const int smem = 1024 + kDqBars + kListOff + 4 * n_kv;
  static int granted = 0;
  st = allow_smem((const void*)flash_bwd_dq_sm90_kernel, smem, &granted);
  CUtensorMap tq, tk, tv, tdo;
  if (!st) st = make_map(&tq, q, batch, sq, hq, kTile);
  if (!st) st = make_map(&tdo, dout, batch, sq, hq, kTile);
  if (!st) st = make_map(&tk, k, batch, skv, hkv, kQc);
  if (!st) st = make_map(&tv, v, batch, skv, hkv, kQc);
  if (st) return st;
  const dim3 grid(hq, (sq + kTile - 1) / kTile, batch);
  flash_bwd_dq_sm90_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), static_cast<bf16*>(dq),
      sq, skv, hq, hkv, causal, scale);
  return (int)cudaGetLastError();
}
