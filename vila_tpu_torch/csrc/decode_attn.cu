// Single-token GQA attention over the live prefix of a flat KV cache, for
// Hopper (sm_90a): stage 1 of the ports of the TPU decode megakernels
// vila_tpu/ops/fused_decode.py:_fused_layer_kernel (bs=1, entry
// `decode_attn`) and :_fused_layer_b_kernel (1 < B <= 16, entry
// `decode_attn_batched`), attention part with their live-block KV
// skipping. The megakernels' other four stages are the W4 GEMV variants of
// w4_gemv.cu.
//
// q arrives rope'd, pre-scaled by head_dim**-0.5 and group-padded to
// (B, Hkv * P, hd); pad heads (p >= G) write zeros, matching the zero rows
// of the GQA-padded o_proj (quant.pad_o_heads). Row b reads only rows
// [0, n_rows[b]) of its (S, Hkv*hd) cache slab (n_rows = fill + 1 clamped
// to S, as the TPU kernels stream only the live blocks); the additive f32
// mask row is added to the scores and the softmax and the PV sum run in
// f32.
//
// Bound on this card: bytes (2 * n_rows * Hkv * hd * 2 bytes of live KV per
// row and layer, a few flops per byte). Design (split over the sequence, as
// flash-decoding): block (g, s, b) takes kv head g of batch row b and cache
// rows [32 s, 32 s + 32), reads each K and V row once for all G query heads
// of the group (q held in registers), and writes a partial (max, sum, PV)
// per head to a workspace; the last block of a (row, kv head) to finish (an
// arrival counter) merges the partials in split order, so the result is
// deterministic. The grid is sized by the longest row: a block whose split
// lies past its own row's live prefix returns at once, writing no partial
// and taking no part in that row's arrival count. At fill 1300 that is
// 41 x 4 blocks per row where one block per head walked all rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;    // cache rows per block
constexpr int kMaxGrp = 8;    // query heads per kv head (padded group)
constexpr int kMaxHdLane = 8; // hd <= 256: elements of a row per lane

__global__ void __launch_bounds__(kThreads) decode_attn_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, const int* __restrict__ n_rows_b, int n_rows1,
    int s_len, int hkv, int grp, int pad_grp, int hd, int kv_ld, int nsplit) {
  __shared__ float sc[kMaxGrp][kChunk];        // scores, then probabilities
  __shared__ float part[kThreads * kMaxGrp];   // PV partial sums over row sets
  __shared__ float s_m[kMaxGrp], s_l[kMaxGrp];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  // live rows of this batch row (clamped: an idle slot's cursor may lie
  // past the cache) and its own split count
  const int n_rows =
      min(min(max(n_rows_b ? n_rows_b[b] : n_rows1, 1), s_len), nsplit * kChunk);
  const int nsplit_b = (n_rows + kChunk - 1) / kChunk;
  if (split >= nsplit_b) return;  // past this row's live prefix
  const int t0 = split * kChunk;
  const int rows = min(kChunk, n_rows - t0);
  const int per_lane = hd / 32;
  const size_t q_row = (size_t)b * hkv * pad_grp * hd;
  q += q_row;
  out += q_row;
  mask += (size_t)b * s_len;
  ws += (size_t)b * hkv * pad_grp * nsplit * (hd + 2);
  counters += b * hkv;
  const __nv_bfloat16* kh = k + (size_t)b * s_len * kv_ld + (size_t)g * hd;
  const __nv_bfloat16* vh = v + (size_t)b * s_len * kv_ld + (size_t)g * hd;

  // ---- scores: warp w takes rows w, w + 8, ...; q of the group in registers
  float qr[kMaxGrp][kMaxHdLane];
#pragma unroll
  for (int j = 0; j < kMaxGrp; ++j)
#pragma unroll
    for (int i = 0; i < kMaxHdLane; ++i)
      qr[j][i] = (j < grp && i < per_lane)
                     ? __bfloat162float(q[(size_t)(g * pad_grp + j) * hd + lane + 32 * i])
                     : 0.f;
  for (int r = warp; r < rows; r += kWarps) {
    const __nv_bfloat16* kr = kh + (size_t)(t0 + r) * kv_ld;
    float kv[kMaxHdLane];
#pragma unroll
    for (int i = 0; i < kMaxHdLane; ++i)
      kv[i] = i < per_lane ? __bfloat162float(kr[lane + 32 * i]) : 0.f;
    const float mk = mask[t0 + r];
#pragma unroll
    for (int j = 0; j < kMaxGrp; ++j) {
      if (j >= grp) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxHdLane; ++i) s += qr[j][i] * kv[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sc[j][r] = s + mk;
    }
  }
  __syncthreads();

  // ---- chunk softmax statistics: warp j owns head j (one row per lane)
  if (warp < grp) {
    const float s = lane < rows ? sc[warp][lane] : -3.4e38f;
    float m = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float p = lane < rows ? expf(s - m) : 0.f;
    float l = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    sc[warp][lane] = p;
    if (lane == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
  }
  __syncthreads();

  // ---- PV: thread (d, set) sums rows set, set + nsets, ... for every head
  const int nsets = kThreads / hd;
  const int d = tid % hd, set = tid / hd;
  if (set < nsets) {
    float acc[kMaxGrp];
#pragma unroll
    for (int j = 0; j < kMaxGrp; ++j) acc[j] = 0.f;
    for (int r = set; r < rows; r += nsets) {
      const float vv = __bfloat162float(vh[(size_t)(t0 + r) * kv_ld + d]);
#pragma unroll
      for (int j = 0; j < kMaxGrp; ++j) acc[j] += sc[j][r] * vv;
    }
#pragma unroll
    for (int j = 0; j < kMaxGrp; ++j) part[(set * kMaxGrp + j) * hd + d] = acc[j];
  }
  __syncthreads();

  // ---- partial (m, l, acc[hd]) per real head -> workspace
  const int stride = hd + 2;
  for (int idx = tid; idx < grp * hd; idx += kThreads) {
    const int j = idx / hd, dd = idx % hd;
    float a = 0.f;
    for (int st = 0; st < nsets; ++st) a += part[(st * kMaxGrp + j) * hd + dd];
    float* w = ws + ((size_t)(g * pad_grp + j) * nsplit + split) * stride;
    w[2 + dd] = a;
    if (dd == 0) {
      w[0] = s_m[j];
      w[1] = s_l[j];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = (atomicAdd(counters + g, 1) == nsplit_b - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // ---- last block of kv head g: merge the splits in order, pad heads -> 0
  for (int idx = tid; idx < pad_grp * hd; idx += kThreads) {
    const int j = idx / hd, dd = idx % hd;
    float o = 0.f;
    if (j < grp) {
      const float* w = ws + (size_t)(g * pad_grp + j) * nsplit * stride;
      float mx = -3.4e38f;
      for (int sp = 0; sp < nsplit_b; ++sp) mx = fmaxf(mx, __ldcg(w + sp * stride));
      float l = 0.f, a = 0.f;
      for (int sp = 0; sp < nsplit_b; ++sp) {
        const float e = expf(__ldcg(w + sp * stride) - mx);
        l += __ldcg(w + sp * stride + 1) * e;
        a += __ldcg(w + sp * stride + 2 + dd) * e;
      }
      o = a / l;
    }
    out[(size_t)(g * pad_grp + j) * hd + dd] = __float2bfloat16_rn(o);
  }
  if (tid == 0) counters[g] = 0;  // leave the counters zeroed for the next launch
}

}  // namespace

// Plain C entry points (bound with ctypes); both return cudaGetLastError().
//
// decode_attn: one batch row. k/v point at the (S, kv_ld) slab of the
// selected layer and batch row; ws holds (hkv * pad_grp, nsplit, hd + 2)
// f32; counters hold hkv zeroed ints. Needs hd % 32 == 0, hd <= 256,
// grp <= pad_grp <= 8, 0 < n_rows <= S and nsplit == ceil(n_rows / 32).
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* mask, void* out, void* ws, void* counters,
                           int hkv, int n_rows, int grp, int pad_grp, int hd,
                           int kv_ld, int nsplit, void* stream) {
  if (hd % 32 || hd > 256 || pad_grp > kMaxGrp || grp > pad_grp || n_rows < 1 ||
      nsplit != (n_rows + kChunk - 1) / kChunk)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(hkv, nsplit, 1);
  decode_attn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), nullptr, n_rows, n_rows, hkv, grp, pad_grp, hd,
      kv_ld, nsplit);
  return (int)cudaGetLastError();
}

// decode_attn_batched: B batch rows of one layer. q is (B, hkv * pad_grp,
// hd), mask (B, S) f32, out (B, hkv * pad_grp * hd); k/v point at the
// (B, S, kv_ld) block of the selected layer; n_rows holds B ints on the
// device (live rows per batch row, clamped to [1, S] here); ws holds
// (B, hkv * pad_grp, nsplit, hd + 2) f32 and counters B * hkv zeroed ints;
// nsplit is ceil(max live rows / 32), at most ceil(S / 32).
extern "C" int decode_attn_batched(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* ws,
                                   void* counters, const void* n_rows, int batch,
                                   int hkv, int s_len, int grp, int pad_grp, int hd,
                                   int kv_ld, int nsplit, void* stream) {
  if (hd % 32 || hd > 256 || pad_grp > kMaxGrp || grp > pad_grp || batch < 1 ||
      batch > 65535 || nsplit < 1 || nsplit > (s_len + kChunk - 1) / kChunk)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(hkv, nsplit, batch);
  decode_attn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), static_cast<const int*>(n_rows), 0, s_len, hkv,
      grp, pad_grp, hd, kv_ld, nsplit);
  return (int)cudaGetLastError();
}
