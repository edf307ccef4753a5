// Single-token GQA attention over the live prefix of a flat KV cache, for
// Hopper (sm_90a): stage 1 of the port of the TPU decode megakernel
// vila_tpu/ops/fused_decode.py:_fused_layer_kernel (attention part, with
// its live-block KV skipping). The megakernel's other four stages are the
// W4 GEMV variants of w4_gemv.cu.
//
// q arrives rope'd, pre-scaled by head_dim**-0.5 and group-padded to
// (Hkv * P, hd); pad heads (p >= G) write zeros, matching the zero rows of
// the GQA-padded o_proj (quant.pad_o_heads). Only rows [0, n_rows) of the
// (S, Hkv*hd) cache layer are read (n_rows = fill + 1, as the TPU kernel
// streams only the live blocks); the additive f32 mask is added to the
// scores and the softmax and the PV sum run in f32.
//
// Bound on this card: bytes (2 * n_rows * Hkv * hd * 2 bytes of live KV per
// layer, a few flops per byte). Design (split over the sequence, as
// flash-decoding): block (g, s) takes kv head g and rows [32 s, 32 s + 32),
// reads each K and V row once for all G query heads of the group (q held in
// registers), and writes a partial (max, sum, PV) per head to a workspace;
// the last block of a kv head to finish (an arrival counter) merges the
// partials in split order, so the result is deterministic. At fill 1300
// that is 41 x 4 blocks where one block per head walked all rows.

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
    int* __restrict__ counters, int n_rows, int grp, int pad_grp, int hd,
    int kv_ld, int nsplit) {
  __shared__ float sc[kMaxGrp][kChunk];        // scores, then probabilities
  __shared__ float part[kThreads * kMaxGrp];   // PV partial sums over row sets
  __shared__ float s_m[kMaxGrp], s_l[kMaxGrp];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x, split = blockIdx.y;
  const int t0 = split * kChunk;
  const int rows = min(kChunk, n_rows - t0);
  const int per_lane = hd / 32;
  const __nv_bfloat16* kh = k + (size_t)g * hd;
  const __nv_bfloat16* vh = v + (size_t)g * hd;

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
  if (tid == 0) s_last = (atomicAdd(counters + g, 1) == nsplit - 1);
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
      for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, __ldcg(w + sp * stride));
      float l = 0.f, a = 0.f;
      for (int sp = 0; sp < nsplit; ++sp) {
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

// Plain C entry point (bound with ctypes). k/v point at the (S, kv_ld) slab
// of the selected layer and batch row; ws holds (hkv * pad_grp, nsplit,
// hd + 2) f32; counters hold hkv zeroed ints. Needs hd % 32 == 0,
// hd <= 256, grp <= pad_grp <= 8 and nsplit == ceil(n_rows / 32).
// Returns cudaGetLastError().
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* mask, void* out, void* ws, void* counters,
                           int hkv, int n_rows, int grp, int pad_grp, int hd,
                           int kv_ld, int nsplit, void* stream) {
  if (hd % 32 || hd > 256 || pad_grp > kMaxGrp || grp > pad_grp ||
      nsplit != (n_rows + kChunk - 1) / kChunk)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(hkv, nsplit);
  decode_attn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), n_rows, grp, pad_grp, hd, kv_ld, nsplit);
  return (int)cudaGetLastError();
}
