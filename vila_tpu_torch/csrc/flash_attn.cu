// Flash attention for training on Hopper (sm_90a): the forward with its
// log-sum-exp (K7) and the two backward kernels, dQ (K8) and group-summed
// dK/dV (K9). Ports of the TPU kernels in vila_tpu/ops/flash_attention.py:
// _fwd_kernel (K7), _bwd_dq_kernel (K8) and _bwd_dkv_kernel (K9).
//
// What they compute (public layout (B, S, H, D), D = 128, bf16 in and out,
// f32 statistics). Row r of q and column c of k/v may attend when
//   c < Skv, r < Sq, (not causal or r >= c), q_seg[r] == kv_seg[c]
// (segments only when given). Scores are (q . k in f32) * scale; a row with
// nothing to attend to writes O = 0 and LSE = -1e30. P is rounded to bf16
// before P.V, and dS and P before the dQ, dK and dV products, as the TPU
// kernels round them. K8 recomputes P from the saved LSE and takes
// delta = rowsum(dO * O) from the caller; rows whose LSE is -1e30 carry no
// gradient (the row-validity guard of the TPU kernel's _block_p).
//
// Bound on this card: operations (each product is 2*D flops per score and
// the scores are S^2/2 under causality; K7 runs 2 products, K8 3 and K9 4).
// Design: one CTA of 4 warps owns a 64-row tile (q tile for K7/K8, kv tile
// for K9); each warp owns 16 of its rows and runs the products with
// warp-level mma.sync m16n8k16 (bf16 in, f32 accumulators in registers),
// reading its operand fragments from shared memory. The other operand
// streams through shared memory in 64-row tiles: K7/K8 walk the kv tiles of
// kv head h / G (GQA without copies), stopping at the causal diagonal; K9
// walks the q tiles of one query head from the diagonal on and writes that
// head's dK and dV in f32, and a second launch sums each group's heads in
// head order and rounds once (the TPU kernel's per-head blocks and group
// sum; one CTA per (kv tile, q head) keeps all SMs busy, where one per kv
// head left half of them idle). Each output tile has one owner: no
// atomics, the results are deterministic. Ragged edges are bounds-checked
// (zero-filled tiles, masked scores) instead of padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;          // head dim
constexpr int kT = 64;           // rows per tile (q and kv)
constexpr int kLd = kD + 8;      // shared row stride in bf16 (conflict-free fragments)
constexpr int kThreads = 128;    // 4 warps x 16 rows
constexpr float kNoRow = -1e30f; // LSE of a row with nothing to attend to
// out-of-range rows and columns get segment codes that never match
constexpr int kOutQ = -2147483647 - 1;
constexpr int kOutKv = -2147483647;

constexpr int kTileBytes = kT * kLd * 2;
constexpr int kFwdSmem = 3 * kTileBytes + 2 * kT * 4;
constexpr int kBwdSmem = 4 * kTileBytes + 4 * kT * 4;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two neighbours of one shared row
__device__ __forceinline__ uint32_t row2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// one column of two neighbouring shared rows
__device__ __forceinline__ uint32_t col2(const bf16* p) {
  return (uint32_t)__bfloat16_as_ushort(p[0]) |
         ((uint32_t)__bfloat16_as_ushort(p[kLd]) << 16);
}

// A fragment (16 x 16, rows r0 .. r0+15, cols k0 .. k0+15) of a shared tile
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* s, int r0, int k0,
                                       int g, int t) {
  const bf16* p = s + (r0 + g) * kLd + k0 + 2 * t;
  a[0] = row2(p);
  a[1] = row2(p + 8 * kLd);
  a[2] = row2(p + 8);
  a[3] = row2(p + 8 * kLd + 8);
}

// rows [row0, row0 + 64) of head h of batch b of a (B, S, H, D) tensor into
// a shared tile; rows past S are zeros
__device__ __forceinline__ void load_tile(bf16* s, const bf16* x, int b, int row0,
                                          int seq, int heads, int h) {
  for (int i = threadIdx.x; i < kT * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq)
      v = *reinterpret_cast<const uint4*>(
          x + (((size_t)b * seq + row0 + r) * heads + h) * kD + c);
    *reinterpret_cast<uint4*>(s + r * kLd + c) = v;
  }
}

// segment codes of rows [row0, row0 + 64): the segment id (0 without
// segments) in range, `out` past the sequence
__device__ __forceinline__ void load_seg(int* s, const int* seg, int b, int row0,
                                         int seq, int out) {
  for (int i = threadIdx.x; i < kT; i += kThreads) {
    const int r = row0 + i;
    s[i] = r < seq ? (seg ? seg[(size_t)b * seq + r] : 0) : out;
  }
}

// ---------------------------------------------------------------------------
// K7: forward. Grid (q tiles, Hq, B).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, bf16* __restrict__ o, float* __restrict__ lse,
    int sq, int skv, int hq, int hkv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kT * kLd;
  bf16* sV = sK + kT * kLd;
  int* sQs = reinterpret_cast<int*>(sV + kT * kLd);
  int* sKs = sQs + kT;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int rw = warp * 16;  // this warp's first row of the tile

  load_tile(sQ, q, b, q0, sq, hq, h);
  load_seg(sQs, q_seg, b, q0, sq, kOutQ);

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNoRow, kNoRow}, l[2] = {0.f, 0.f};

  const int kv_end = causal ? min(skv, q0 + kT) : skv;
  for (int j0 = 0; j0 < kv_end; j0 += kT) {
    __syncthreads();  // the previous tiles are consumed
    load_tile(sK, k, b, j0, skv, hkv, hk);
    load_tile(sV, v, b, j0, skv, hkv, hk);
    load_seg(sKs, kv_seg, b, j0, skv, kOutKv);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 columns per warp
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, sQ, rw, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* kp = sK + (n * 8 + g) * kLd + kk * 16 + 2 * t;
        mma16816(s[n], a, row2(kp), row2(kp + 8));
      }
    }

    // mask and scale; running max per row (rows rw+g and rw+g+8)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rl = rw + g + (i >> 1) * 8, cl = n * 8 + 2 * t + (i & 1);
        const bool ok = sQs[rl] == sKs[cl] && (!causal || q0 + rl >= j0 + cl);
        s[n][i] = ok ? s[n][i] * scale : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      corr[hr] = expf(m[hr] - m_new);
      m[hr] = m_new;
      l[hr] *= corr[hr];
    }
#pragma unroll
    for (int d = 0; d < 16; ++d)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[d][i] *= corr[i >> 1];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[n][i] - m[i >> 1]);  // masked: exp(-inf) = 0
        s[n][i] = p;
        l[i >> 1] += p;
      }

    // O += P V, P rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t a[4] = {pack2(s[2 * kk][0], s[2 * kk][1]),
                       pack2(s[2 * kk][2], s[2 * kk][3]),
                       pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        const bf16* vp = sV + (kk * 16 + 2 * t) * kLd + d * 8 + g;
        mma16816(acc[d], a, col2(vp), col2(vp + 8 * kLd));
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lr = l[hr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int r = q0 + rw + g + hr * 8;
    if (r >= sq) continue;
    const float den = lr == 0.f ? 1.f : lr;
    bf16* orow = o + (((size_t)b * sq + r) * hq + h) * kD;
#pragma unroll
    for (int d = 0; d < 16; ++d)
      *reinterpret_cast<uint32_t*>(orow + d * 8 + 2 * t) =
          pack2(acc[d][2 * hr] / den, acc[d][2 * hr + 1] / den);
    if (t == 0)
      lse[((size_t)b * hq + h) * sq + r] = lr == 0.f ? kNoRow : m[hr] + logf(lr);
  }
}

// ---------------------------------------------------------------------------
// K8: dQ. Grid (q tiles, Hq, B).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    bf16* __restrict__ dq, int sq, int skv, int hq, int hkv, int causal,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kT * kLd;
  bf16* sK = sdO + kT * kLd;
  bf16* sV = sK + kT * kLd;
  int* sQs = reinterpret_cast<int*>(sV + kT * kLd);
  int* sKs = sQs + kT;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int rw = warp * 16;

  load_tile(sQ, q, b, q0, sq, hq, h);
  load_tile(sdO, dout, b, q0, sq, hq, h);
  load_seg(sQs, q_seg, b, q0, sq, kOutQ);
  float lr[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + rw + g + hr * 8;
    const size_t idx = ((size_t)b * hq + h) * sq + r;
    lr[hr] = r < sq ? lse[idx] : kNoRow;
    dl[hr] = r < sq ? delta[idx] : 0.f;
  }

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int kv_end = causal ? min(skv, q0 + kT) : skv;
  for (int j0 = 0; j0 < kv_end; j0 += kT) {
    __syncthreads();
    load_tile(sK, k, b, j0, skv, hkv, hk);
    load_tile(sV, v, b, j0, skv, hkv, hk);
    load_seg(sKs, kv_seg, b, j0, skv, kOutKv);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a[4], ad[4];
      frag_a(a, sQ, rw, kk * 16, g, t);
      frag_a(ad, sdO, rw, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* kp = sK + (n * 8 + g) * kLd + kk * 16 + 2 * t;
        const bf16* vp = sV + (n * 8 + g) * kLd + kk * 16 + 2 * t;
        mma16816(s[n], a, row2(kp), row2(kp + 8));     // Q K^T
        mma16816(dp[n], ad, row2(vp), row2(vp + 8));   // dO V^T
      }
    }
    // dS = P * (dP - delta), P recomputed from the LSE
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hr = i >> 1;
        const int rl = rw + g + hr * 8, cl = n * 8 + 2 * t + (i & 1);
        const bool ok = sQs[rl] == sKs[cl] && (!causal || q0 + rl >= j0 + cl) &&
                        lr[hr] > 0.5f * kNoRow;
        const float p = ok ? expf(s[n][i] * scale - lr[hr]) : 0.f;
        s[n][i] = p * (dp[n][i] - dl[hr]);
      }
    // dQ += dS K, dS rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t a[4] = {pack2(s[2 * kk][0], s[2 * kk][1]),
                       pack2(s[2 * kk][2], s[2 * kk][3]),
                       pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        const bf16* kp = sK + (kk * 16 + 2 * t) * kLd + d * 8 + g;
        mma16816(acc[d], a, col2(kp), col2(kp + 8 * kLd));
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + rw + g + hr * 8;
    if (r >= sq) continue;
    bf16* row = dq + (((size_t)b * sq + r) * hq + h) * kD;
#pragma unroll
    for (int d = 0; d < 16; ++d)
      *reinterpret_cast<uint32_t*>(row + d * 8 + 2 * t) =
          pack2(acc[d][2 * hr] * scale, acc[d][2 * hr + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// K9, pass 1: per query head dK and dV of one kv tile, f32 into a workspace
// (B, Skv, Hq, D). Grid (kv tiles, Hq, B).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    float* __restrict__ ws_k, float* __restrict__ ws_v, int sq, int skv, int hq,
    int hkv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kT * kLd;
  bf16* sQ = sV + kT * kLd;
  bf16* sdO = sQ + kT * kLd;
  int* sKs = reinterpret_cast<int*>(sdO + kT * kLd);
  int* sQs = sKs + kT;
  float* sL = reinterpret_cast<float*>(sQs + kT);
  float* sDl = sL + kT;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kv0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int rw = warp * 16;  // this warp's first kv row of the tile

  load_tile(sK, k, b, kv0, skv, hkv, hk);
  load_tile(sV, v, b, kv0, skv, hkv, hk);
  load_seg(sKs, kv_seg, b, kv0, skv, kOutKv);

  float ak[16][4], av[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ak[i][j] = av[i][j] = 0.f;

  // under causality the q tile holding row kv0 is the first with any work
  const int q_begin = causal ? kv0 : 0;
  for (int i0 = q_begin; i0 < sq; i0 += kT) {
    __syncthreads();
    load_tile(sQ, q, b, i0, sq, hq, h);
    load_tile(sdO, dout, b, i0, sq, hq, h);
    load_seg(sQs, q_seg, b, i0, sq, kOutQ);
    for (int i = threadIdx.x; i < kT; i += kThreads) {
      const int r = i0 + i;
      const size_t idx = ((size_t)b * hq + h) * sq + r;
      sL[i] = r < sq ? lse[idx] : kNoRow;
      sDl[i] = r < sq ? delta[idx] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;  // this pass's first q row of the tile
      // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 32 q columns per warp
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t a_k[4], a_v[4];
        frag_a(a_k, sK, rw, kk * 16, g, t);
        frag_a(a_v, sV, rw, kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const bf16* qp = sQ + (c0 + n * 8 + g) * kLd + kk * 16 + 2 * t;
          const bf16* op = sdO + (c0 + n * 8 + g) * kLd + kk * 16 + 2 * t;
          mma16816(st[n], a_k, row2(qp), row2(qp + 8));
          mma16816(dpt[n], a_v, row2(op), row2(op + 8));
        }
      }
      // P^T and dS^T = P^T * (dP^T - delta)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = rw + g + (i >> 1) * 8, qc = c0 + n * 8 + 2 * t + (i & 1);
          const float lq = sL[qc];
          const bool ok = sQs[qc] == sKs[kr] && (!causal || i0 + qc >= kv0 + kr) &&
                          lq > 0.5f * kNoRow;
          const float p = ok ? expf(st[n][i] * scale - lq) : 0.f;
          st[n][i] = p;
          dpt[n][i] = p * (dpt[n][i] - sDl[qc]);
        }
      // dV += P^T dO and dK += dS^T Q over these 32 q rows, both rounded
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ap[4] = {pack2(st[2 * kk][0], st[2 * kk][1]),
                          pack2(st[2 * kk][2], st[2 * kk][3]),
                          pack2(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                          pack2(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        uint32_t ads[4] = {pack2(dpt[2 * kk][0], dpt[2 * kk][1]),
                           pack2(dpt[2 * kk][2], dpt[2 * kk][3]),
                           pack2(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                           pack2(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int d = 0; d < 16; ++d) {
          const bf16* op = sdO + (c0 + kk * 16 + 2 * t) * kLd + d * 8 + g;
          const bf16* qp = sQ + (c0 + kk * 16 + 2 * t) * kLd + d * 8 + g;
          mma16816(av[d], ap, col2(op), col2(op + 8 * kLd));
          mma16816(ak[d], ads, col2(qp), col2(qp + 8 * kLd));
        }
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = kv0 + rw + g + hr * 8;
    if (r >= skv) continue;
    const size_t off = (((size_t)b * skv + r) * hq + h) * kD;
#pragma unroll
    for (int d = 0; d < 16; ++d) {
      *reinterpret_cast<float2*>(ws_k + off + d * 8 + 2 * t) =
          make_float2(ak[d][2 * hr] * scale, ak[d][2 * hr + 1] * scale);
      *reinterpret_cast<float2*>(ws_v + off + d * 8 + 2 * t) =
          make_float2(av[d][2 * hr], av[d][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K9, pass 2: dK and dV = the group's per-head blocks summed in head order
// (the TPU kernel's group sum outside), rounded once. One thread per output
// element of (B, Skv, Hkv, D).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256) flash_dkv_group_sum_kernel(
    const float* __restrict__ ws_k, const float* __restrict__ ws_v,
    bf16* __restrict__ dk, bf16* __restrict__ dv, long long n, int hkv, int grp) {
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

int check_shape(int batch, int sq, int skv, int hq, int hkv, int d, int causal) {
  if (d != kD || batch < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv ||
      batch > 65535 || hq > 65535 || (causal && sq != skv))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// dynamic shared memory above 48 KB, granted once per kernel
int allow_smem(const void* kernel, int bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  *done = true;
  return 0;
}

}  // namespace

// Plain C entry points (bound with ctypes); each returns cudaGetLastError()
// or cudaErrorInvalidValue for a shape it does not take. q, o, do, dq are
// (B, Sq, Hq, 128) and k, v, dk, dv (B, Skv, Hkv, 128) contiguous bf16,
// 16-byte aligned; lse and delta (B, Hq, Sq) f32; q_seg (B, Sq) and kv_seg
// (B, Skv) int32, both null without segments. causal needs Sq == Skv.

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* q_seg, const void* kv_seg, void* o, void* lse,
                         int batch, int sq, int skv, int hq, int hkv, int d, int causal,
                         float scale, void* stream) {
  int st = check_shape(batch, sq, skv, hq, hkv, d, causal);
  static bool smem_ok = false;
  if (!st) st = allow_smem((const void*)flash_fwd_kernel, kFwdSmem, &smem_ok);
  if (st) return st;
  const dim3 grid((sq + kT - 1) / kT, hq, batch);
  flash_fwd_kernel<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<bf16*>(o), static_cast<float*>(lse),
      sq, skv, hq, hkv, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            const void* q_seg, const void* kv_seg, void* dq, int batch,
                            int sq, int skv, int hq, int hkv, int d, int causal,
                            float scale, void* stream) {
  int st = check_shape(batch, sq, skv, hq, hkv, d, causal);
  static bool smem_ok = false;
  if (!st) st = allow_smem((const void*)flash_bwd_dq_kernel, kBwdSmem, &smem_ok);
  if (st) return st;
  const dim3 grid((sq + kT - 1) / kT, hq, batch);
  flash_bwd_dq_kernel<<<grid, kThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<bf16*>(dq), sq, skv, hq, hkv, causal, scale);
  return (int)cudaGetLastError();
}

// flash_bwd_dkv: ws holds 2 * B * Skv * Hq * 128 f32 (the per-head dK, then
// dV blocks); two launches.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             const void* q_seg, const void* kv_seg, void* ws, void* dk,
                             void* dv, int batch, int sq, int skv, int hq, int hkv, int d,
                             int causal, float scale, void* stream) {
  int st = check_shape(batch, sq, skv, hq, hkv, d, causal);
  static bool smem_ok = false;
  if (!st) st = allow_smem((const void*)flash_bwd_dkv_kernel, kBwdSmem, &smem_ok);
  if (st) return st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws_k = static_cast<float*>(ws);
  float* ws_v = ws_k + (size_t)batch * skv * hq * kD;
  const dim3 grid((skv + kT - 1) / kT, hq, batch);
  flash_bwd_dkv_kernel<<<grid, kThreads, kBwdSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), ws_k, ws_v, sq,
      skv, hq, hkv, causal, scale);
  const long long n = (long long)batch * skv * hkv * kD;
  flash_dkv_group_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      ws_k, ws_v, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, hkv, hq / hkv);
  return (int)cudaGetLastError();
}
