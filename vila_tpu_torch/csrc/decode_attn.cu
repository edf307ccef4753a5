// Single-token GQA attention over each batch row's live prefix of a flat KV
// cache, for Hopper (sm_90a): stage 1 of the port of the TPU decode
// megakernel vila_tpu/ops/fused_decode.py:_fused_layer_b_kernel (1 < B <=
// 16, entry `decode_attn_batched`), attention part with its live-block KV
// skipping. The megakernel's other four stages are w4_gemv_mma.cu's. (The
// bs=1 layer, K3, is one launch of its own: decode_layer_sm90.cu.)
//
// q arrives rope'd, pre-scaled by head_dim**-0.5 and group-padded to
// (B, Hkv * P, hd); pad heads (p >= G) write zeros, matching the zero rows
// of the GQA-padded o_proj (quant.pad_o_heads). Row b reads only rows
// [0, n_rows[b]) of its (S, Hkv*hd) cache slab (n_rows = fill + 1 clamped
// to S, as the TPU kernels stream only the live blocks); the additive f32
// mask row is added to the scores and the softmax runs in f32.
//
// Bound on this card: bytes (2 * n_rows * Hkv * hd * 2 bytes of live KV per
// row and layer, a few flops per byte). The kernel splits the sequence (as
// flash-decoding): a block takes kv head g of batch row b and one chunk of
// 128 cache rows, reads each K and V row once for all G query heads of the
// group, and writes a partial (max, sum, PV) per head to a workspace; the
// last block of a (row, kv head) to finish (an arrival counter) merges the
// partials in split order, so the result is deterministic. The grid is
// sized by the longest row: a block whose chunk lies past its own row's
// live prefix returns at once, writing no partial and taking no part in
// that row's arrival count. The chunk arrives in two halves of 64 rows
// whose K and V arrive by cp.async in four groups (K0, V0, K1, V1), so the
// scores of a half run while its V and the next half are in flight. Four
// warps take 16 rows of each half; scores and P V run on the tensor cores
// (mma.sync m16n8k16 bf16, f32 accumulators): the group's 8 padded q heads
// are rows 0-7 of a 16-row A tile, P is rounded to bf16 in the A-fragment
// layout of the scores' accumulator, and each warp keeps an online softmax
// (f32) over its rows; the four warps' partials are merged in warp order
// into the block's partial.

#include <cuda_bf16.h>

#include "sm90_common.cuh"

namespace {

constexpr int kMaxGrp = 8;  // query heads per kv head (padded group)

// ---------------------------------------------------------------------------
// The batched kernel (hd 64 or 128): grid (Hkv, splits, B), 128 threads.
// ---------------------------------------------------------------------------

constexpr int kBChunk = 128;   // cache rows per block
constexpr int kBHalf = 64;     // rows per cp.async half
constexpr int kBThreads = 128; // 4 warps x 16 rows of each half
// shared row stride in bf16 (conflict-free fragments)
__host__ __device__ constexpr int b_ld(int hd) { return hd + 8; }
// [half][K, V][row][b_ld]
__host__ __device__ constexpr int b_smem(int hd) { return 2 * 2 * kBHalf * b_ld(hd) * 2; }
constexpr float kNeg = -3.0e38f;

// 16 bytes global -> shared; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  // A rows 8-15 are zero (the q tile holds 8 heads)
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows r and r + 1 of one shared column, as a bf16 pair
template <int LD>
__device__ __forceinline__ uint32_t col_pair(const __nv_bfloat16* p) {
  return (uint32_t)__bfloat16_as_ushort(p[0]) | ((uint32_t)__bfloat16_as_ushort(p[LD]) << 16);
}

// HD / 16 k steps of the scores, HD / 8 n tiles of P V
template <int HD>
__global__ void __launch_bounds__(kBThreads) decode_attn_b_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
    const int* __restrict__ n_rows_b, int s_len, int hkv, int grp, int pad_grp, int kv_ld,
    int nsplit) {
  constexpr int kBHd = HD, kBLd = b_ld(HD), KS = HD / 16, NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* skv = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;  // head gq of the group; column pair 2t
  const int g = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int n_rows = min(min(max(n_rows_b[b], 1), s_len), nsplit * kBChunk);
  const int nsplit_b = (n_rows + kBChunk - 1) / kBChunk;
  if (split >= nsplit_b) return;  // past this row's live prefix
  const int t0 = split * kBChunk;
  const size_t q_row = (size_t)b * hkv * pad_grp * kBHd;
  q += q_row;
  out += q_row;
  mask += (size_t)b * s_len;
  ws += (size_t)b * hkv * pad_grp * nsplit * (kBHd + 2);
  counters += b * hkv;
  const __nv_bfloat16* kh = k + (size_t)b * s_len * kv_ld + (size_t)g * kBHd;
  const __nv_bfloat16* vh = v + (size_t)b * s_len * kv_ld + (size_t)g * kBHd;

  // K0, V0, K1, V1 in four cp.async groups; rows past the live prefix are zeros
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      const __nv_bfloat16* src = kv ? vh : kh;
      __nv_bfloat16* dst = skv + (hf * 2 + kv) * kBHalf * kBLd;
      for (int i = tid; i < kBHalf * (kBHd / 8); i += kBThreads) {
        const int r = i / (kBHd / 8), c = (i % (kBHd / 8)) * 8;
        const int row = t0 + hf * kBHalf + r;
        const bool ok = row < n_rows;
        cp_async16(dst + r * kBLd + c, src + (size_t)(ok ? row : 0) * kv_ld + c, ok);
      }
      cp_commit();
    }

  // q of head gq as A fragments (k-step kk: columns 16 kk + 2t, + 8); pad
  // heads and heads past the group are zeros
  uint32_t qa[KS][2];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int x = 0; x < 2; ++x)
      qa[kk][x] = gq < grp ? *reinterpret_cast<const uint32_t*>(
                                 q + (size_t)(g * pad_grp + gq) * kBHd + 16 * kk + 8 * x + 2 * t)
                           : 0u;

  float m_run = kNeg, l_run = 0.f;
  float o[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const __nv_bfloat16* sK = skv + (hf * 2) * kBHalf * kBLd + warp * 16 * kBLd;
    const __nv_bfloat16* sV = sK + kBHalf * kBLd;
    if (hf == 0) cp_wait<3>(); else cp_wait<1>();
    __syncthreads();
    // S (8 heads x 16 rows): two n8 tiles of the warp's rows
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const __nv_bfloat16* kr = sK + (nt * 8 + gq) * kBLd + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma16816(sc[nt], qa[kk][0], qa[kk][1],
                 *reinterpret_cast<const uint32_t*>(kr + 16 * kk),
                 *reinterpret_cast<const uint32_t*>(kr + 16 * kk + 8));
    }
    // mask, online softmax (f32)
    float mx = kNeg;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = t0 + hf * kBHalf + warp * 16 + nt * 8 + 2 * t + e;
        sc[nt][e] = pos < n_rows ? sc[nt][e] + mask[pos] : kNeg;
        mx = fmaxf(mx, sc[nt][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    m_run = m_new;
    l_run *= corr;
    float p[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = t0 + hf * kBHalf + warp * 16 + nt * 8 + 2 * t + e;
        p[nt][e] = pos < n_rows ? expf(sc[nt][e] - m_new) : 0.f;
        l_run += p[nt][e];
      }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      o[i][0] *= corr;
      o[i][1] *= corr;
    }
    // O += P V: P (bf16) is the A fragment of the 16 rows, V's columns the B
    if (hf == 0) cp_wait<2>(); else cp_wait<0>();
    __syncthreads();
    const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]), pa2 = pack_bf16(p[1][0], p[1][1]);
#pragma unroll
    for (int dn = 0; dn < NT; ++dn) {
      const __nv_bfloat16* vr = sV + (2 * t) * kBLd + 8 * dn + gq;
      mma16816(o[dn], pa0, pa2, col_pair<kBLd>(vr), col_pair<kBLd>(vr + 8 * kBLd));
    }
  }
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);

  // the warps' partials (aliasing the K/V buffers), merged in warp order
  __syncthreads();
  float* pm = reinterpret_cast<float*>(smem_raw);  // [warp][head]
  float* pl = pm + 4 * 8;
  float* po = pl + 4 * 8;                          // [warp][head][d]
  if (t == 0) {
    pm[warp * 8 + gq] = m_run;
    pl[warp * 8 + gq] = l_run;
  }
#pragma unroll
  for (int dn = 0; dn < NT; ++dn) {
    po[(warp * 8 + gq) * kBHd + 8 * dn + 2 * t] = o[dn][0];
    po[(warp * 8 + gq) * kBHd + 8 * dn + 2 * t + 1] = o[dn][1];
  }
  __syncthreads();
  const int stride = kBHd + 2;
  for (int idx = tid; idx < grp * kBHd; idx += kBThreads) {
    const int j = idx / kBHd, d = idx % kBHd;
    float mb = kNeg;
#pragma unroll
    for (int w = 0; w < 4; ++w) mb = fmaxf(mb, pm[w * 8 + j]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float e = expf(pm[w * 8 + j] - mb);
      lb += pl[w * 8 + j] * e;
      ab += po[(w * 8 + j) * kBHd + d] * e;
    }
    float* wp = ws + ((size_t)(g * pad_grp + j) * nsplit + split) * stride;
    wp[2 + d] = ab;
    if (d == 0) {
      wp[0] = mb;
      wp[1] = lb;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = (atomicAdd(counters + g, 1) == nsplit_b - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // ---- last block of kv head g: merge the splits in order, pad heads -> 0
  for (int idx = tid; idx < pad_grp * kBHd; idx += kBThreads) {
    const int j = idx / kBHd, dd = idx % kBHd;
    float o_v = 0.f;
    if (j < grp) {
      const float* w = ws + (size_t)(g * pad_grp + j) * nsplit * stride;
      float mx = kNeg;
      for (int sp = 0; sp < nsplit_b; ++sp) mx = fmaxf(mx, __ldcg(w + sp * stride));
      float l = 0.f, a = 0.f;
      for (int sp = 0; sp < nsplit_b; ++sp) {
        const float e = expf(__ldcg(w + sp * stride) - mx);
        l += __ldcg(w + sp * stride + 1) * e;
        a += __ldcg(w + sp * stride + 2 + dd) * e;
      }
      o_v = a / l;
    }
    out[(size_t)(g * pad_grp + j) * kBHd + dd] = __float2bfloat16_rn(o_v);
  }
  if (tid == 0) counters[g] = 0;  // leave the counters zeroed for the next launch
}

}  // namespace

// Plain C entry point (bound with ctypes); returns cudaGetLastError().
//
// decode_attn_batched: B batch rows of one layer, hd 64 or 128. q is (B,
// hkv * pad_grp, hd), mask (B, S) f32, out (B, hkv * pad_grp * hd); k/v point
// at the (B, S, kv_ld) block of the selected layer; n_rows holds B ints on
// the device (live rows per batch row, clamped to [1, S] here); ws holds
// (B, hkv * pad_grp, nsplit, hd + 2) f32 and counters B * hkv zeroed ints;
// nsplit is ceil(max live rows / 128), at most ceil(S / 128).
extern "C" int decode_attn_batched(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* ws,
                                   void* counters, const void* n_rows, int batch,
                                   int hkv, int s_len, int grp, int pad_grp, int hd,
                                   int kv_ld, int nsplit, void* stream) {
  if ((hd != 64 && hd != 128) || pad_grp > kMaxGrp || grp > pad_grp || batch < 1 ||
      batch > 65535 || nsplit < 1 || nsplit > (s_len + kBChunk - 1) / kBChunk || kv_ld % 8)
    return (int)cudaErrorInvalidValue;
  static bool smem_ok[2] = {false, false};
  auto kernel = hd == 64 ? decode_attn_b_kernel<64> : decode_attn_b_kernel<128>;
  if (!smem_ok[hd == 64]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, b_smem(hd));
    if (e != cudaSuccess) return (int)e;
    smem_ok[hd == 64] = true;
  }
  const dim3 grid(hkv, nsplit, batch);
  kernel<<<grid, kBThreads, b_smem(hd), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), static_cast<const int*>(n_rows), s_len, hkv, grp,
      pad_grp, kv_ld, nsplit);
  return (int)cudaGetLastError();
}
