// K4 and K5, the two halves of a W4 decoder layer for m <= 32 rows, each as
// one persistent launch, for Hopper (sm_90a): the ports of the TPU kernels
// vila_tpu/ops/fused_decode.py:_fused_o_gateup_kernel (pallas_call :390)
// and :_fused_down_qkv_kernel (pallas_call :484). One template, two
// instantiations:
//
//   K4  h32 = h + x_att @ W_o[l]                       (f32)
//       h_new = bf16(h32); gu = bf16(rms(h32) * g_post[l] @ W_gu[l])
//   K5  h32 = h + (silu(g) * u of gu) @ W_d[l]         (f32; h = K4's h_new)
//       h_new = bf16(h32); qkv = bf16(rms(h32) * g_in[l+1] @ W_qkv[l+1] + b)
//
// == fused_decode._fused_o_gateup_ref / _fused_down_qkv_ref. Both products
// keep the TPU kernels' int8-digit arithmetic: each input row's prologue
// values (w4_common.cuh's definition, bit for bit the plain version's) are
// expanded per half-plane into two int8 digits, whose exact integer dots
// with the nibble planes are summed per group of input rows, corrected for
// the lo plane's zero point, and scaled in f32 per (row, group, column); the
// RMS reads the unrounded f32 sum, and h is handed back rounded to bf16 (K5
// adds to K4's rounded h_new, as on the TPU). A group is any multiple of 16
// input rows up to 128; its digits are padded with zeros to the next
// multiple of 32 (quant.padded_group), so a padded k step reads weight rows
// past the group against zero digits.
//
// Bound on this card: bytes. At m = 24 a packed byte feeds 4 m int8
// multiply-adds, far below where the int8 tensor cores would bound, so the
// least time is the packed weights and scales (K4 ~ 77.6 MB, K5 ~ 43.5 MB
// at the NVILA-8B shape) over 3.35 TB/s.
//
// Design (what held the two-launch GEMV route back, and the answer):
//   * one cooperative launch, one CTA per SM, with grid barriers on one
//     arrival count (w4_persist.cuh, shared with K3);
//   * each product's prologue once over the grid, not once per block, its
//     digits and lo-plane group sums written once into an L2-resident
//     workspace in w4_gemv_rows' layout and k order, each row's half-plane
//     amax published for every CTA's digit scales. K5's SiLU values (an f64
//     exp each) are spread over the grid in pieces (row, plane, group):
//     values and amax partials, a barrier, then the digits. The others are
//     row stages with no barrier inside: a row is taken by N / m_pad CTAs,
//     each computing the row's values and amax whole (latency-bound, the
//     same bits) and a share of its digit blocks. K4's product-1 prologue
//     is one; the merge is the other: h32 = h + product 1's partials in
//     split order, h_new, the RMS of h32 (f64 sum of squares, then the
//     definition of w4_common.cuh), product 2's values and digits.
//   * one weight pass for all m rows on the tensor cores, wgmma in the
//     swap-AB form (w4_persist.cuh: group_product_wgmma): the weights,
//     transposed and masked to a nibble plane in registers, are the 64-row
//     A operand; the (row, digit) pairs of the stage's digit tile are the
//     N = 2 m_pad columns of B; the planes run one after the other so that
//     the s32 sums of one stay in registers (232 a consumer thread,
//     setmaxnreg); no weight byte is read twice, whatever m is. (Measured
//     faster than mma.sync m16n8k32 at m = 24 and 32 on the H100.)
//   * weights from the launch's start: a producer warp streams the CTA's
//     weight tiles of both products, in the order the consumers take them,
//     through an mbarrier ring of TMA stages, and a second producer warp
//     adds each stage's digit tile and group sums once the grid barrier's
//     count says they are written: product 2's first weights arrive while
//     product 1's merge, the RMS and the digit pass run (the TPU kernel's
//     eager issue of both streams);
//   * deterministic sums: a product's column tiles are dealt whole where
//     they fill whole waves of CTAs and split over K for the rest
//     (quant.unit_plan, at most four splits for product 1, whose partials
//     the row stage sums); split partials are summed in split order, with
//     no atomics but the order-free amax maxima.
// Two consumer warpgroups take the ring's stages alternately (32 columns a
// warp) and add their sums at the end of each unit. Grid barriers: K4 four
// (after product 1's prologue, its units, the merge, and, where a tile of
// product 2 is split, its units), K5 one more (between its values and its
// digits).

#include <cuda_bf16.h>

#include "w4_persist.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// the launch's shape (w4_persist.cuh): two consumer warpgroups and a
// producer warpgroup (the consumers take 232 registers, the producers 40)
constexpr int kConsumerWarps = kWConsumerWarps;
constexpr int kConsumers = kWConsumers;
constexpr int kTileN = kPTileN;
constexpr int kMaxRows = kWMaxRows;
constexpr int kMaxPieces = 128;  // (row, plane, group) pieces of one product a CTA
constexpr int kMaxProductSplits = 4;  // K splits of product 1 (the row stage sums them)
constexpr int kStamps = 9;       // start; after each of the seven barriers; end
constexpr int kStaticSmem = 8192;  // the kernel's static shared memory, rounded up

struct PairArgs {
  const bf16* x;      // product 1's rows (M, ldx): x_att, or (gate | up) for SiLU
  const bf16* h;      // (M, D) residual
  const bf16* gamma;  // (D,) RMSNorm scale of product 2's input
  const bf16* bias;   // (dout2,) or null
  bf16* h_out;        // (M, D)
  bf16* out;          // (M, dout2)
  unsigned long long* bar;  // the grid barrier's arrival count (w4_persist.cuh);
                            // then per product the (row, plane) amax as int bits
                            // (2 x kMaxRows), zero between launches
  unsigned long long* stamps;  // (kStamps,) or null
  WProd pr[2];
  int M, m_pad, ldx, D, stages, sbytes;
  float eps;
};

__device__ __forceinline__ void csync() { ::csync<kConsumers>(); }

__device__ __forceinline__ void stamp(const PairArgs& a, int k) {
  if (a.stamps && blockIdx.x == 0 && threadIdx.x == 0) a.stamps[k] = globaltimer();
}

__device__ __forceinline__ void grid_sync(const PairArgs& a, unsigned long long& target, int k) {
  ::grid_sync<kConsumers>(a.bar, target);
  stamp(a, k);
}

// piece q of a product's input: row r, plane pl, group g (rows up to m_pad)
__device__ __forceinline__ void piece_of(const WProd& pr, int q, int& r, int& pl, int& g) {
  r = q / (2 * pr.ngh);
  const int rem = q - r * 2 * pr.ngh;
  pl = rem / pr.ngh;
  g = rem - pl * pr.ngh;
}

__device__ __forceinline__ int* amax_of(const PairArgs& a, int p) {
  return reinterpret_cast<int*>(a.bar + 1) + p * 2 * kMaxRows;
}

// this CTA's amax of each (row, plane) of product p, from s_amax (int bits
// of non-negative floats, maxed with atomicMax: any order gives the same
// result) into the grid's
__device__ __forceinline__ void publish_amax(const PairArgs& a, const int* s_amax, int p) {
  csync();
  int* amax = amax_of(a, p);
  for (int i = threadIdx.x; i < 2 * a.m_pad; i += kConsumers)
    if (s_amax[i]) atomicMax(amax + i, s_amax[i]);
}

// product 1's prologue values of this CTA's pieces into pbuf (rows past M
// zero), with their (row, plane) amax: the pieces' inputs are first gathered
// into pbuf by cp.async, every copy in flight at once (as bf16: gate then up
// for SiLU, in the bytes the piece's f32 values then take)
template <int PRO1>
__device__ __forceinline__ void values1(const PairArgs& a, const WProd& pr, float* pbuf,
                                        int* s_amax) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, N = gridDim.x;
  constexpr int kParts = PRO1 == PRO_SILU ? 2 : 1;
  const int np = a.m_pad * 2 * pr.ngh, cpp = pr.group / 8;  // 16-byte chunks a part
  for (int i = tid; i < 2 * a.m_pad; i += kConsumers) s_amax[i] = 0;
  bf16* raw = reinterpret_cast<bf16*>(pbuf);
  const int mine = (np - (int)blockIdx.x + N - 1) / N;  // this CTA's pieces
  for (int i = tid; i < mine * kParts * cpp; i += kConsumers) {
    const int k = i / (kParts * cpp), c = i - k * kParts * cpp;
    int r, pl, g;
    piece_of(pr, blockIdx.x + k * N, r, pl, g);
    if (r >= a.M) continue;
    const int part = c / cpp, cc = c - part * cpp;
    cp_async16(raw + (size_t)k * 2 * pr.group + part * pr.group + 8 * cc,
               a.x + (size_t)r * a.ldx + pl * pr.half + g * pr.group + (size_t)part * pr.din +
                   8 * cc);
  }
  cp_async_wait_all();
  csync();
  for (int k = warp; (int)blockIdx.x + k * N < np; k += kConsumerWarps) {
    int r, pl, g;
    piece_of(pr, blockIdx.x + k * N, r, pl, g);
    float xv[4], uv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 32 * j + lane;
      const bool ok = e < pr.group && r < a.M;
      xv[j] = ok ? __bfloat162float(raw[(size_t)k * 2 * pr.group + e]) : 0.f;
      uv[j] = ok && kParts == 2 ? __bfloat162float(raw[(size_t)k * 2 * pr.group + pr.group + e])
                                : 0.f;
    }
    __syncwarp();  // (the values overwrite the piece's raw bytes)
    float am = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 32 * j + lane;
      if (e >= pr.group) break;
      const float v = PRO1 == PRO_SILU && r < a.M ? silu_value(xv[j], uv[j]) : xv[j];
      pbuf[k * pr.group + e] = v;
      am = fmaxf(am, fabsf(v));
    }
    am = warp_max(am);
    if (lane == 0) atomicMax(&s_amax[2 * r + pl], __float_as_int(am));
  }
  publish_amax(a, s_amax, 0);
}

// every row's digit scales (s1, s2 of each plane) from the grid's amax of
// product p
__device__ __forceinline__ void row_scales(const PairArgs& a, int p, float* s_sd) {
  ::row_scales(amax_of(a, p), a.m_pad, s_sd);
}

// the digits and lo-plane group sums of this CTA's pieces, once, into the
// workspace (w4_gemv_rows' layout: zero digits past the group, the k order
// of kappa_of inside each 32-row step)
__device__ __forceinline__ void pieces_digits(const PairArgs& a, const WProd& pr,
                                              const float* pbuf, const float* s_sd) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, N = gridDim.x;
  const int np = a.m_pad * 2 * pr.ngh;
  for (int k = warp; (int)blockIdx.x + k * N < np; k += kConsumerWarps) {
    int r, pl, g;
    piece_of(pr, blockIdx.x + k * N, r, pl, g);
    const float s1 = s_sd[4 * r + 2 * pl], s2 = s_sd[4 * r + 2 * pl + 1];
    int8_t* d0 = pr.dig + ((size_t)(2 * pl) * a.m_pad + r) * pr.hp + g * pr.gp;
    int8_t* d1 = d0 + (size_t)a.m_pad * pr.hp;
    float vv[4];  // (the loads before the stores)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      vv[j] = 32 * j + lane < pr.group ? pbuf[k * pr.group + 32 * j + lane] : 0.f;
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
        pr.gsum[((size_t)g * 2 + 0) * a.m_pad + r] = a1;
        pr.gsum[((size_t)g * 2 + 1) * a.m_pad + r] = a2;
      }
    }
  }
  fence_proxy_async_global();  // the digits are read by TMA after the barrier
}

// ---- row stages: a row's whole prologue in the CTA that owns the row
// (rows r = blockIdx.x, + N, ...; rows past M are zeros), no barrier inside

// a row's half-plane amax for every CTA's row_scales (one owner: a store)
__device__ __forceinline__ void publish_row_amax(const PairArgs& a, int p, int r, float lo,
                                                 float hi) {
  amax_of(a, p)[2 * r] = __float_as_int(lo);
  amax_of(a, p)[2 * r + 1] = __float_as_int(hi);
}

// The row stages spread each row over `parts` = N / m_pad CTAs: each takes
// the row's latency-bound values and amax whole (the same bits), and a share
// of its digit blocks; part 0 writes h_new and the amax.
__device__ __forceinline__ int row_parts(const PairArgs& a) {
  return max(1, (int)gridDim.x / a.m_pad);
}

// h32 = h + product 1's partials (split order) of the row, in registers
// (the thread's own elements); h_new = bf16(h32); the row's f64 sum of squares (per thread, then
// the warps in order), its RMS factor, product 2's values bf16(rms(h32) *
// gamma), their amax and digits. Every global load of the row (h, the
// partials of all splits, gamma) is issued before any store: a load after a
// store it might alias would wait for the one before it.
template <int kMaxE>
__device__ __forceinline__ void rows_merge(const PairArgs& a, bf16* rowv, float* red,
                                           double* red64) {
  const WProd& p1 = a.pr[0];
  const WProd& p2 = a.pr[1];
  const int tid = threadIdx.x, D = a.D;
  const size_t zs = (size_t)a.M * p1.dout;  // one split's partials
  const int parts = row_parts(a);
  if ((int)blockIdx.x < a.m_pad * parts) {
    const int r = blockIdx.x % a.m_pad, part = blockIdx.x / a.m_pad;
    const bool real = r < a.M;
    const float* pr0 = p1.part + (size_t)r * p1.dout;
    float hv[kMaxE], gv[kMaxE], x[kMaxProductSplits][kMaxE];
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) {
      const int i = tid + j * kConsumers;
      const bool ok = real && i < D;
      const int nz = ok ? splits_of(p1, i / kTileN) : 0;
      hv[j] = ok ? __bfloat162float(a.h[(size_t)r * D + i]) : 0.f;
      gv[j] = i < D ? __bfloat162float(a.gamma[i]) : 0.f;
#pragma unroll
      for (int z = 0; z < kMaxProductSplits; ++z)
        x[z][j] = z < nz ? __ldcg(pr0 + z * zs + i) : 0.f;
    }
    double ss = 0.0;
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) {
      const int i = tid + j * kConsumers;
      if (i >= D) break;
      float sum = x[0][j];
#pragma unroll
      for (int z = 1; z < kMaxProductSplits; ++z) sum += x[z][j];
      const float v = real ? hv[j] + sum : 0.f;
      if (real && part == 0) a.h_out[(size_t)r * D + i] = __float2bfloat16_rn(v);
      hv[j] = v;  // h32
      ss += (double)v * (double)v;
    }
    ss = warp_sum_f64(ss);
    if ((tid & 31) == 0) red64[tid >> 5] = ss;
    csync();
    double t = red64[0];
    for (int w = 1; w < kConsumerWarps; ++w) t += red64[w];
    const float rms = rms_scale(t, D, a.eps);
    float lo = 0.f, hi = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) {
      const int i = tid + j * kConsumers;
      if (i >= D) break;
      const float v = real ? rms_value(hv[j], rms, gv[j]) : 0.f;
      rowv[i] = __float2bfloat16_rn(v);
      if (i < p2.half) lo = fmaxf(lo, fabsf(v)); else hi = fmaxf(hi, fabsf(v));
    }
    cons_max2<kConsumerWarps>(lo, hi, red);  // (its barriers publish rowv, and red64 is read)
    if (tid == 0 && part == 0) publish_row_amax(a, 1, r, lo, hi);
    row_digits(p2, a.m_pad, r, rowv, lo, hi, part, parts);
  }
  fence_proxy_async_global();
}

template <int PRO1, int MT>
__global__ void __launch_bounds__(kWThreads, 1) w4_pair_kernel(
    const __grid_constant__ CUtensorMap tm_w1, const __grid_constant__ CUtensorMap tm_w2,
    const __grid_constant__ CUtensorMap tm_d1, const __grid_constant__ CUtensorMap tm_d2,
    const __grid_constant__ PairArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  float* s_unit = reinterpret_cast<float*>(ring + a.stages * a.sbytes);  // MT * 8 * 128
  float* pbuf = s_unit + MT * 8 * 128;  // this CTA's pieces' values
  __shared__ uint64_t full[kWMaxStages], empty[kWMaxStages];
  __shared__ __align__(16) float s_sd[2][4 * kMaxRows];
  __shared__ float s_red[2 * kConsumerWarps];
  __shared__ int s_amax[2 * kMaxRows];
  __shared__ double s_red64[kConsumers];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the count the launch starts from (thread 0 and the digit producer), read
  // before this CTA's first arrival
  unsigned long long target = tid == 0 || tid == kConsumers + 32 ? launch_start(a.bar) : 0;
  stamp(a, 0);
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 2);  // the weight and the digit producer each arrive
      mbar_init(&empty[s], kConsumerWarps / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // (before any arrival of this CTA at a grid barrier)

  // the warpgroup's role, warp-uniform for the compiler (setmaxnreg needs it,
  // and a role of each branch of one if/else)
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp < kConsumerWarps + 2 && lane == 0) {
      const bool weights = warp == kConsumerWarps;
      int it = 0;
      for (int p = 0; p < 2; ++p) {
        const WProd& pr = a.pr[p];
        if (!weights) {  // the digits: after the barrier that follows their writes
          // (product 1's digits: after barrier 2 for K5, 1 for K4; product 2's two later)
          const int k = (PRO1 == PRO_SILU ? 2 : 1) + 2 * p;
          wait_count(a.bar, target + k * (unsigned long long)gridDim.x);
          fence_proxy_async_global();
        }
        const CUtensorMap* tm = weights ? (p ? &tm_w2 : &tm_w1) : (p ? &tm_d2 : &tm_d1);
        produce(pr, a.m_pad, weights, tm, a.stages, a.sbytes, ring, full, empty, it);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

    int it = 0, nb = 0;  // nb: grid barriers passed
    // product 1's prologue: K5's SiLU spread over the grid in pieces (values
    // with amax partials, a barrier, digits), K4's by the rows' owners
    if (PRO1 == PRO_SILU) {
      values1<PRO1>(a, a.pr[0], pbuf, s_amax);
      grid_sync(a, target, ++nb);
      row_scales(a, 0, s_sd[0]);
      pieces_digits(a, a.pr[0], pbuf, s_sd[0]);
      grid_sync(a, target, ++nb);
    } else {
      rows_prologue(a.pr[0], a.x, a.ldx, a.M, a.m_pad, amax_of(a, 0),
                    reinterpret_cast<bf16*>(pbuf), s_red);
      grid_sync(a, target, ++nb);
      row_scales(a, 0, s_sd[0]);
    }
    run_units<MT>(a.pr[0], a.M, a.stages, a.sbytes, s_sd[0], ring, full, empty, s_unit, it,
                  nullptr, nullptr);
    grid_sync(a, target, ++nb);
    // (every CTA has read product 1's amax words: zero them for K5's atomics)
    if (blockIdx.x == 0 && tid < 2 * a.m_pad) amax_of(a, 0)[tid] = 0;
    // h32 = h + product 1, h_new, product 2's RMS values and digits, by rows
    if (a.D <= 16 * kConsumers)
      rows_merge<16>(a, reinterpret_cast<bf16*>(pbuf), s_red, s_red64);
    else
      rows_merge<32>(a, reinterpret_cast<bf16*>(pbuf), s_red, s_red64);
    grid_sync(a, target, ++nb);
    row_scales(a, 1, s_sd[1]);
    run_units<MT>(a.pr[1], a.M, a.stages, a.sbytes, s_sd[1], ring, full, empty, s_unit, it,
                  a.bias, a.out);
    if (a.pr[1].n_full < a.pr[1].dout / kTileN && a.pr[1].ks > 1) {
      grid_sync(a, target, ++nb);
      final_sum(a.pr[1], a.M, a.bias, a.out);
    } else {
      stamp(a, ++nb);  // (no split tile: no last barrier)
    }
    stamp(a, kStamps - 1);
  }
}

// the workspace (floats, 256-byte aligned regions) of one call: both
// products' digits and group sums, and their partials. ints as w4_pair's.
inline size_t ws_layout(const int* in, size_t* off) {
  const int M = in[0], m_pad = in[1];
  size_t o = 0;
  auto region = [&](int k, size_t floats) {
    off[k] = o;
    o += (floats + 63) & ~size_t(63);
  };
  for (int p = 0; p < 2; ++p) {
    const int* d = in + 7 + 8 * p;
    const int group = d[4], gp = (group + 31) & ~31, ngh = d[0] / 2 / group;
    region(p, ((size_t)4 * m_pad * ngh * gp + 3) / 4);  // digits (int8)
    region(2 + p, (size_t)ngh * 2 * m_pad);            // group sums (int32)
    const int tiles = d[1] / kTileN, split = d[5] < tiles && d[6] > 1;
    region(4 + p, (size_t)(p == 0 || split ? d[6] : 0) * M * d[1]);  // partials
  }
  return o;
}

template <int PRO1, int MT>
int launch(const CUtensorMap* tm, const PairArgs& a, int n_cta, int smem, cudaStream_t s) {
  static int granted = 0;
  const void* kernel = (const void*)w4_pair_kernel<PRO1, MT>;
  const int st = allow_smem(kernel, smem, &granted);
  if (st) return st;
  CUtensorMap t0 = tm[0], t1 = tm[1], t2 = tm[2], t3 = tm[3];
  PairArgs args = a;
  void* params[] = {&t0, &t1, &t2, &t3, &args};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(n_cta), dim3(kWThreads), params, smem, s);
}

template <int PRO1>
int dispatch(const CUtensorMap* tm, const PairArgs& a, int n_cta, int smem, cudaStream_t s) {
  switch (a.m_pad / 8) {
    case 1: return launch<PRO1, 1>(tm, a, n_cta, smem, s);
    case 2: return launch<PRO1, 2>(tm, a, n_cta, smem, s);
    case 3: return launch<PRO1, 3>(tm, a, n_cta, smem, s);
    case 4: return launch<PRO1, 4>(tm, a, n_cta, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// ints: M, m_pad (8 ceil(M / 8)), ldx (product 1's row stride: din1, or 2
// din1 for SiLU), D, n_cta (one CTA per SM), prologue of product 1 (0 none,
// 2 SiLU), the device index, then per product (1: o or down; 2: gate_up or
// qkv) din, dout, bout, s_rows, group (a multiple of 16 up to 128), n_full,
// ks, gps (fused_decode.pair_plan).
// w4_pair_ws_floats: the f32 workspace a call needs.
extern "C" long long w4_pair_ws_floats(const int* ints) {
  size_t off[6];
  return (long long)ws_layout(ints, off);
}

// w4_pair_ws_offsets: the regions' offsets in floats (digits 1, 2; group
// sums 1, 2; partials 1, 2), for checks
extern "C" void w4_pair_ws_offsets(const int* ints, long long* out) {
  size_t off[6];
  ws_layout(ints, off);
  for (int k = 0; k < 6; ++k) out[k] = (long long)off[k];
}

// ptrs: x (M rows of product 1's input), h (M, D), gamma (D), bias (dout2 or
// null), h_out (M, D), out (M, dout2), ws, barrier words (2 + 4 kMaxRows
// zeroed u32: the barrier's u64 arrival count, left counting, then the two
// products' amax words, product 1's left zeroed), stamps (or null: 9 u64
// %globaltimer readings of CTA 0: the start at 0, after each grid barrier k
// at k (K4: 1-4, K5: 1-5; where product 2 has no split tile, the last is
// taken when CTA 0's units end), the end at 8), then packed and scales of
// product 1 and of product 2 (their layers). Returns the launch's
// cudaError_t.
extern "C" int w4_pair(void* const* ptrs, const int* ints, float eps, void* stream) {
  PairArgs a;
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.h = static_cast<const bf16*>(ptrs[1]);
  a.gamma = static_cast<const bf16*>(ptrs[2]);
  a.bias = static_cast<const bf16*>(ptrs[3]);
  a.h_out = static_cast<bf16*>(ptrs[4]);
  a.out = static_cast<bf16*>(ptrs[5]);
  float* ws = static_cast<float*>(ptrs[6]);
  a.bar = static_cast<unsigned long long*>(ptrs[7]);
  a.stamps = static_cast<unsigned long long*>(ptrs[8]);
  a.M = ints[0];
  a.m_pad = ints[1];
  a.ldx = ints[2];
  a.D = ints[3];
  const int n_cta = ints[4], pro1 = ints[5];
  a.eps = eps;
  if (a.M < 1 || a.M > kMaxRows || a.m_pad != 8 * ((a.M + 7) / 8) || n_cta < 1 ||
      (pro1 != PRO_NONE && pro1 != PRO_SILU) || a.D % 8)
    return (int)cudaErrorInvalidValue;
  // the device's context current in this thread before the descriptors
  // are encoded (a thread's first CUDA call may be this one)
  const cudaError_t dev_err = cudaSetDevice(ints[6]);
  if (dev_err != cudaSuccess) return (int)dev_err;
  size_t off[6];
  ws_layout(ints, off);
  const EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorSharedObjectInitFailed;
  CUtensorMap tm[4];  // weights 1, weights 2, digits 1, digits 2
  int buf_bytes = 0;  // K5's pieces or K4's row (product 1), then a row of h32 and values
  for (int p = 0; p < 2; ++p) {
    const int* d = ints + 7 + 8 * p;
    WProd& pr = a.pr[p];
    pr.packed = static_cast<const uint8_t*>(ptrs[9 + 2 * p]);
    pr.scales = static_cast<const bf16*>(ptrs[10 + 2 * p]);
    pr.dig = reinterpret_cast<int8_t*>(ws + off[p]);
    pr.gsum = reinterpret_cast<int*>(ws + off[2 + p]);
    pr.part = ws + off[4 + p];
    pr.din = d[0];
    pr.dout = d[1];
    pr.bout = d[2];
    pr.s_rows = d[3];
    pr.group = d[4];
    pr.n_full = d[5];
    pr.ks = d[6];
    pr.gps = d[7];
    if (pr.group < 16 || pr.group > kPGroup || pr.group % 16 || pr.din % (2 * pr.group))
      return (int)cudaErrorInvalidValue;
    pr.half = pr.din / 2;
    pr.gp = (pr.group + 31) & ~31;
    pr.ngh = pr.half / pr.group;
    pr.hp = pr.ngh * pr.gp;
    const int tiles = pr.dout / kTileN;
    if (pr.bout % kTileN || pr.dout % pr.bout || pr.n_full < 0 || pr.n_full > tiles ||
        pr.ks < 1 || pr.ks > (p == 0 ? kMaxProductSplits : kWMaxSplits) || pr.gps < 1 ||
        (pr.ks - 1) * pr.gps >= pr.ngh ||
        pr.ks * pr.gps < pr.ngh ||
        (pr.n_full == tiles && pr.ks != 1))
      return (int)cudaErrorInvalidValue;
    if (p == 0 && pro1 == PRO_SILU) {  // K5's product 1: pieces of the grid
      const int pieces = (a.m_pad * 2 * pr.ngh + n_cta - 1) / n_cta;
      if (pieces > kMaxPieces) return (int)cudaErrorInvalidValue;
      buf_bytes = pieces * pr.group * 4;
    } else if (p == 0) {  // K4's product 1: a row's values (bf16)
      buf_bytes = 2 * pr.din;
    }
    if (!encode_weights(enc, &tm[p], pr.packed, pr.din, pr.dout, pr.bout, pr.gp))
      return (int)cudaErrorInvalidValue;
    // the padded digits as (hp, 4 m_pad) bytes: boxes of 128 k x all rows
    const cuuint64_t ddims[2] = {(cuuint64_t)pr.hp, (cuuint64_t)(4 * a.m_pad)};
    const cuuint64_t dstrides[1] = {(cuuint64_t)pr.hp};
    const cuuint32_t dbox[2] = {128, (cuuint32_t)(4 * a.m_pad)}, elem[2] = {1, 1};
    if (enc(&tm[2 + p], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, pr.dig, ddims, dstrides, dbox, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  if (a.pr[0].dout != a.D || a.pr[1].din != a.D || a.D > 32 * kConsumers ||
      a.ldx != (pro1 == PRO_SILU ? 2 : 1) * a.pr[0].din)
    return (int)cudaErrorInvalidValue;
  if (2 * a.D > buf_bytes) buf_bytes = 2 * a.D;  // the row stage's values
  a.sbytes = stage_bytes(a.m_pad);
  const int fixed = 1024 + (a.m_pad / 8) * 8 * 128 * 4 + ((buf_bytes + 15) & ~15);
  a.stages = ring_stages(a.m_pad, fixed, kStaticSmem);  // (even: w4_persist.cuh)
  if (a.stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = fixed + a.stages * a.sbytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pro1 == PRO_SILU ? dispatch<PRO_SILU>(tm, a, n_cta, smem, s)
                          : dispatch<PRO_NONE>(tm, a, n_cta, smem, s);
}
