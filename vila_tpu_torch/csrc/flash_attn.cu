// Flash attention for training on Hopper (sm_90a): the dQ backward kernel
// (K8), a port of _bwd_dq_kernel in vila_tpu/ops/flash_attention.py. The
// forward (K7) and the dK/dV backward (K9) are in flash_attn_sm90.cu.
//
// What it computes (public layout (B, S, H, D), D = 128, bf16 in and out,
// f32 statistics). Row r of q and column c of k/v may attend when
//   c < Skv, r < Sq, (not causal or r >= c), q_seg[r] == kv_seg[c]
// (segments only when given). Scores are (q . k in f32) * scale. K8
// recomputes P from the saved LSE and takes delta = rowsum(dO * O) from the
// caller; rows whose LSE is -1e30 carry no gradient (the row-validity guard
// of the TPU kernel's _block_p); dS is rounded to bf16 before dQ = dS K.
//
// Bound on this card: operations (each product is 2*D flops per score and
// the scores are S^2/2 under causality; K8 runs 3 products).
// Design: one CTA of 4 warps owns a 64-row q tile; each warp owns 16 of its
// rows and runs the products with warp-level mma.sync m16n8k16 (bf16 in,
// f32 accumulators in registers), reading its operand fragments from
// shared memory. K and V of kv head h / G (GQA without copies) stream
// through shared memory in 64-row tiles, stopping at the causal diagonal.
// Each output tile has one owner: no atomics, the results are
// deterministic. Ragged edges are bounds-checked (zero-filled tiles, masked
// scores) instead of padded.

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
