// W4A16 GEMM for M > 32 rows (prefill-shaped) on Hopper's wgmma (sm_90a).
//
// Replaces the TPU kernels vila_tpu/ops/quant.py:_w4_prefill_kernel (flat)
// and the stacked `wrapped` closure of w4_matmul_prefill, both over
// _prefill_block_body, and carries the ideas of the TPU timing prototypes
// of that body: experiments/chip_prefill_pipeline.py (X1: the dequant
// overlapped with the product, `pipelined_kernel`; and `dots_only_kernel`,
// the product alone, which is this kernel's DOTS variant),
// experiments/chip_kernel_v3.py (X3: `make_prefill`'s v3a interleave and
// v3b one K loop over both planes) and experiments/chip_stacked_hoist.py
// (X2: kernel-ready scales of the stacked weights with no per-layer copy:
// the caller selects the layer by pointer offset).
//
// Arithmetic (identical to _prefill_block_body, hence to dequantize-then-
// matmul): each packed byte of a weight tile gives both planes' weights,
//   w_lo = bf16((lo - 8) * s_lo)    w_hi = bf16((hi - 8) * s_hi)
// (== bf16(h16 * bf16(s_hi / 16)) with h16 = 16 (hi - 8): both products are
// exact before their one rounding). A nibble n becomes the bf16 128 + n by
// its bit pattern 0x4300 | n; minus 136 gives n - 8 exactly, and one bf16
// multiply by the scale rounds once. The two planes contract against
// x[:, :din/2] and x[:, din/2:] into one f32 accumulator (bf16 wgmma).
//
// Bound on this card: operations. At M = 320 the GEMM does 2 M = 640 flops
// per weight element against ~0.5 byte of packed weight, far above the ~295
// ops/byte where an H100 turns compute-bound, so the least time is
// 2 M din dout / 989 TFLOP/s.
//
// Design. A CTA owns 128 output columns (inside one bout block), up to 384
// rows of x (six 64-row wgmma slices: every weight element is dequantised
// once per CTA that covers all of M, and M <= 384 is one CTA row) and a run
// of 32-deep k tiles of both planes (one K loop, X3's v3b). Three
// warpgroups:
//   WG 0  (setmaxnreg 40): warp 0 keeps a 3-stage mbarrier ring full by
//         TMA: per stage the x tiles of both planes (64-byte swizzle, rows
//         past M zero-filled), the packed 32 x 128 byte tile and the scale
//         rows (lo, hi) of the groups its 32 k rows belong to: one group, or
//         two where a group is not a multiple of 32 rows (112) or is 16 rows
//         (a group is any multiple of 16). Warps 1-3 dequantise each stage's
//         packed tile, each k row with its own group's scales, into a
//         bf16 B tile per plane in shared memory, in the 128-byte-swizzled
//         MN-major layout wgmma reads (the packed bytes are k-row by output
//         column), into a ring of three B buffers.
//   WG 1-2 (setmaxnreg 232): slices wg, wg + 2 and wg + 4 each (their
//         accumulators, 64 registers a slice, stay in registers); per stage
//         four wgmma m64n128k16 SS per slice (2 planes x 2 k steps), committed as
//         one group and waited one stage later (wgmma.wait_group 1), so the
//         products of stage k run while stage k + 1 is dequantised and
//         loaded: X1's pipelined kernel.
// The dequant runs on warps of its own, so the consumers' registers hold
// only the accumulators (64 a slice). The DOTS variant (X1's dots_only
// kernel) takes a pre-dequantised bf16 (din, dout) weight through the same
// ring and products and skips the dequant: its time against the W4 one is
// what the dequant still costs. Where the column tiles leave SMs idle, K is
// split over CTAs, whose f32 partials are summed
// in split order: the tile's CTAs wait for each other (a cooperative
// launch) and each sums a share of the tile's rows (deterministic, no
// atomics on the output).

#include <cuda_bf16.h>

#include "sm90_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBN = 128;                 // output columns per CTA
constexpr int kBK = 32;                  // k rows of each plane per stage
constexpr int kSlice = 64;               // x rows per wgmma
constexpr int kMaxSlices = 6;            // x rows per CTA: 384
constexpr int kStages = 3;               // TMA ring
constexpr int kBBufs = 3;                // dequantised B tiles
constexpr int kConsumerWGs = 2;          // slices wg, wg + 2, wg + 4
constexpr int kThreads = 128 * (1 + kConsumerWGs);
constexpr int kDequantThreads = 96;      // warps 1-3
constexpr int kXBox = kSlice * kBK * 2;  // 4 KB: one slice of one plane's x
constexpr int kBPlane = kBK * kBN * 2;   // 8 KB: one plane's bf16 B tile
constexpr int kPacked = kBK * kBN;       // 4 KB of packed bytes
constexpr int kScaleRow = kBN * 2;       // one bf16 scale row
constexpr int kMaxSplits = 8;            // K splits

__host__ __device__ constexpr int x_bytes(int ns) { return 2 * ns * kXBox; }
// W4: the packed tile, then the scale rows lo(ga), hi(ga), lo(gb), hi(gb) of
// the first and the last k row's groups
__host__ __device__ constexpr int stage_bytes(int ns, int dots) {
  return (x_bytes(ns) + (dots ? 2 * kBPlane : kPacked + 4 * kScaleRow) + 1023) & ~1023;
}
__host__ __device__ constexpr int smem_bytes(int ns, int dots) {
  return 1024 + kStages * stage_bytes(ns, dots) + (dots ? 0 : kBBufs * 2 * kBPlane) + 256;
}

struct GemmArgs {
  const bf16* scales;  // (nj, s_rows, bout) of the selected layer (W4)
  bf16* out;           // (M, dout)
  float* ws;           // (ksplit, M, dout) partials when ksplit > 1
  int* counters;       // per (M tile, column tile): arrivals (left 0), generation
  int M, half, dout, bout, s_rows, group, ngh, spt, ksplit, kps;
  int straddle;  // the group is not a multiple of 32: a k tile may hold two groups
  int n_main, parts;  // tail mode (parts > 0): CTAs past n_main share a tile's rows
};

// named barrier 1 over the consumer warpgroups that hold slices
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// two weights of one plane from nibbles n0 (low half of t) and n1 (high
// half), times their two scales: bf16((n - 8) * s), one rounding each
__device__ __forceinline__ uint32_t dequant2(uint32_t t, uint32_t s) {
  uint32_t v = (t & 0x000F000Fu) | 0x43004300u;  // 128 + n, exactly
  const uint32_t k136 = 0x43084308u;
  __nv_bfloat162 w = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&k136));
  w = __hmul2(w, *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<uint32_t*>(&w);
}

// one stage's packed 32 x 128 tile into the bf16 B tiles of both planes (by
// the dequant warps, thread dt of 96): k rows below kb take the first
// group's scale rows, the others (TWO: the tile holds two groups) the second's
template <bool TWO>
__device__ __forceinline__ void dequant_tile(const uint8_t* pk, uint8_t* blo, int dt, int kb) {
  const uint32_t* sc0 = reinterpret_cast<const uint32_t*>(pk + kPacked);
  for (int c = dt; c < kPacked / 8; c += kDequantThreads) {
    const int k = c >> 4, c8 = (c & 15) * 8;  // k row, first of 8 columns
    const uint32_t* sc = TWO && k >= kb ? sc0 + kBN : sc0;  // (kBN words: two scale rows)
    const uint2 w = *reinterpret_cast<const uint2*>(pk + k * kBN + c8);
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // bytes of columns c8 + 2j, c8 + 2j + 1 in the two 16-bit halves
      const uint32_t t = __byte_perm(j < 2 ? w.x : w.y, 0, (j & 1) ? 0x4342 : 0x4140);
      lo[j] = dequant2(t, sc[c8 / 2 + j]);
      hi[j] = dequant2(t >> 4, sc[kBN / 2 + c8 / 2 + j]);
    }
    // 16 bytes at (k, c8) of the swizzled MN-major tile: 64-column
    // halves, 128-byte rows, 16-byte chunk ^ (k & 7)
    const int off = (c8 >> 6) * (kBPlane / 2) + k * 128 + ((((c8 & 63) >> 3) ^ (k & 7)) << 4);
    *reinterpret_cast<uint4*>(blo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(blo + kBPlane + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

template <int DOTS, int SPW>
__global__ void __launch_bounds__(kThreads, 1) w4_gemm_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
    GemmArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  const int sb = stage_bytes(a.spt, DOTS);
  uint8_t* bbuf = ring + kStages * sb;  // W4: the dequantised B tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(bbuf + (DOTS ? 0 : kBBufs * 2 * kBPlane));
  uint64_t* empty = full + kStages;
  uint64_t* bfull = empty + kStages;
  uint64_t* bempty = bfull + kBBufs;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the CTA's column tile and rows: a whole M tile, or in tail mode a part
  // of the slices of one of the last column tiles
  int tile = blockIdx.x, m0 = blockIdx.y * a.spt * kSlice, ns;
  if (a.parts > 0 && (int)blockIdx.x >= a.n_main) {
    const int t = blockIdx.x - a.n_main, part = t % a.parts;
    const int nst = (a.M + kSlice - 1) / kSlice;
    tile = a.n_main + t / a.parts;
    m0 = part * nst / a.parts * kSlice;
    ns = (part + 1) * nst / a.parts - part * nst / a.parts;
  } else {
    ns = min(a.spt, (a.M - m0 + kSlice - 1) / kSlice);  // slices with rows
  }
  const int n0 = tile * kBN;
  const int jb = n0 / a.bout, oo0 = n0 % a.bout;
  const int nact = min(kConsumerWGs, ns);                       // consumer warpgroups
  const int xb = x_bytes(ns);
  const int nk = a.half / kBK;
  const int kt0 = blockIdx.z * a.kps, n = min(nk, kt0 + a.kps) - kt0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], (DOTS ? 0 : kDequantThreads / 32) + nact);
    }
    for (int b = 0; b < kBBufs; ++b) {
      mbar_init(&bfull[b], kDequantThreads / 32);
      mbar_init(&bempty[b], nact);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role, warp-uniform for the compiler (setmaxnreg needs it)
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0) {
      if (lane == 0) {  // producer
        const uint32_t tx = xb + (DOTS ? 2 * kBPlane : kPacked + 2 * kScaleRow);
        const bf16* srow = a.scales + (size_t)jb * a.s_rows * a.bout + oo0;
        for (int i = 0; i < n; ++i) {
          const int s = i % kStages, k0 = (kt0 + i) * kBK;
          uint8_t* st = ring + s * sb;
          mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
          // the second group's scale rows only where the tile holds two groups
          const int ga = k0 / a.group, gb = a.straddle ? (k0 + kBK - 1) / a.group : ga;
          mbar_expect_tx(&full[s], tx + (!DOTS && gb != ga ? 2 * kScaleRow : 0));
          for (int p = 0; p < 2; ++p)
            for (int sl = 0; sl < ns; ++sl)
              tma_load_2d(st + (p * ns + sl) * kXBox, &tm_x, &full[s], p * a.half + k0,
                          m0 + sl * kSlice);
          if (DOTS) {
            for (int p = 0; p < 2; ++p)
              for (int hh = 0; hh < 2; ++hh)
                tma_load_2d(st + xb + p * kBPlane + hh * (kBPlane / 2), &tm_w, &full[s],
                            n0 + 64 * hh, p * a.half + k0);
          } else {
            tma_load_3d(st + xb, &tm_w, &full[s], oo0, k0, jb);
            bulk_load(st + xb + kPacked, srow + (size_t)ga * a.bout, kScaleRow, &full[s]);
            bulk_load(st + xb + kPacked + kScaleRow, srow + (size_t)(a.ngh + ga) * a.bout,
                      kScaleRow, &full[s]);
            if (gb != ga) {
              bulk_load(st + xb + kPacked + 2 * kScaleRow, srow + (size_t)gb * a.bout, kScaleRow,
                        &full[s]);
              bulk_load(st + xb + kPacked + 3 * kScaleRow, srow + (size_t)(a.ngh + gb) * a.bout,
                        kScaleRow, &full[s]);
            }
          }
        }
      }
    } else if (!DOTS) {  // dequant warps
      const int dt = threadIdx.x - 32;
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages, b = i % kBBufs;
        const int k0 = (kt0 + i) * kBK;
        // k rows of the first group (all of them unless the group straddles)
        const int kb = a.straddle ? (k0 / a.group + 1) * a.group - k0 : kBK;
        const uint8_t* pk = ring + s * sb + xb;
        uint8_t* blo = bbuf + b * 2 * kBPlane;
        mbar_wait(&full[s], (i / kStages) & 1);
        mbar_wait(&bempty[b], ((i / kBBufs) & 1) ^ 1);
        // (a stage-uniform branch: most tiles hold one group's rows)
        if (kb >= kBK)
          dequant_tile<false>(pk, blo, dt, kb);
        else
          dequant_tile<true>(pk, blo, dt, kb);
        fence_proxy_async();
        __syncwarp();
        mbar_arrive_if(&bfull[b], lane == 0);
        mbar_arrive_if(&empty[s], lane == 0);  // the packed bytes are read
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = wgi - 1;
    if (wg >= nact) return;
    const int mine = (ns - wg + 1) / 2;  // slices wg + 2 q, q < mine
    const bool leader = (threadIdx.x & 127) == 0;
    float acc[SPW][64];
#pragma unroll
    for (int q = 0; q < SPW; ++q)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[q][e] = 0.f;
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages, b = i % kBBufs;
      const uint8_t* st = ring + s * sb;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* bt = st + xb;
      if (!DOTS) {
        mbar_wait(&bfull[b], (i / kBBufs) & 1);
        bt = bbuf + b * 2 * kBPlane;
      }
      wg_fence();
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t db =
              desc_mn(reinterpret_cast<const bf16*>(bt + p * kBPlane), kBK, kk);
          const bf16* xp = reinterpret_cast<const bf16*>(st + (p * ns + wg) * kXBox);
#pragma unroll
          for (int q = 0; q < SPW; ++q)
            if (q < mine) wgmma_ss_n128<1>(acc[q], desc_k64(xp + q * kXBox, 0, kk), db, 1);
        }
      wg_commit();
      wg_wait<1>();  // the previous stage's products are done
      const int prev = i > 0 ? i - 1 : 0;
      mbar_arrive_if(&empty[prev % kStages], i > 0 && leader);
      if (!DOTS) mbar_arrive_if(&bempty[prev % kBBufs], i > 0 && leader);
    }
    wg_wait<0>();
#pragma unroll
    for (int q = 0; q < SPW; ++q) reg_fence(acc[q]);

    // epilogue: accumulator value 4j + 2i + e at row 16 w + g + 8 i, column
    // 8 j + 2 t + e of the slice
    const int w = warp & 3, g = lane >> 2, t = lane & 3;
    const int cta_threads = nact * 128;
#pragma unroll
    for (int q = 0; q < SPW; ++q) {
      if (q >= mine) break;
      const int rbase = m0 + (wg + 2 * q) * kSlice + 16 * w + g;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int r = rbase + 8 * ii, c = n0 + 8 * j + 2 * t;
          if (r >= a.M) continue;
          const float v0 = acc[q][4 * j + 2 * ii], v1 = acc[q][4 * j + 2 * ii + 1];
          if (a.ksplit == 1)
            *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)r * a.dout + c) =
                __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(
                a.ws + ((size_t)blockIdx.z * a.M + r) * a.dout + c) = make_float2(v0, v1);
        }
    }
    if (a.ksplit == 1) return;

    // split K (a cooperative launch: the CTAs of a tile are co-resident):
    // the tile's CTAs wait for each other, then each sums its share of the
    // tile's rows over the partials in split order
    __threadfence();
    consumers_sync(cta_threads);
    if (wg == 0 && leader) {
      int* counter = a.counters + 2 * (blockIdx.y * gridDim.x + tile);
      int g0;
      asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n" : "=r"(g0) : "l"(counter + 1) : "memory");
      int old;
      asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                   : "=r"(old) : "l"(counter) : "memory");
      if (old == a.ksplit - 1) {
        asm volatile("st.relaxed.gpu.global.b32 [%0], 0;\n" ::"l"(counter) : "memory");
        asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter + 1) : "memory");
      } else {
        int g;
        do {
          asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(g) : "l"(counter + 1) : "memory");
        } while (g == g0);
      }
    }
    consumers_sync(cta_threads);
    const int rows = min(a.M - m0, a.spt * kSlice);
    const int r0 = m0 + rows * (int)blockIdx.z / a.ksplit;
    const int r1 = m0 + rows * ((int)blockIdx.z + 1) / a.ksplit;
    const size_t split_stride = (size_t)a.M * a.dout;
    const int tid = threadIdx.x - 128;
#pragma unroll 4
    for (int idx = tid; idx < (r1 - r0) * (kBN / 4); idx += cta_threads) {
      const int r = r0 + idx / (kBN / 4), c = n0 + 4 * (idx % (kBN / 4));
      const float* src = a.ws + (size_t)r * a.dout + c;
      float4 x[kMaxSplits];
#pragma unroll
      for (int z = 0; z < kMaxSplits; ++z)
        if (z < a.ksplit) x[z] = __ldcg(reinterpret_cast<const float4*>(src + z * split_stride));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int z = 0; z < kMaxSplits; ++z)
        if (z < a.ksplit) {
          v.x += x[z].x;
          v.y += x[z].y;
          v.z += x[z].z;
          v.w += x[z].w;
        }
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)r * a.dout + c);
      o2[0] = __floats2bfloat162_rn(v.x, v.y);
      o2[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  }
}

template <int DOTS, int SPW>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, const GemmArgs& a, int m_tiles,
           cudaStream_t s) {
  static int granted = 0;
  const int smem = smem_bytes(a.spt, DOTS);
  const int st = allow_smem((const void*)w4_gemm_sm90_kernel<DOTS, SPW>, smem, &granted);
  if (st) return st;
  const int tiles = a.dout / kBN;
  const dim3 grid(a.parts ? a.n_main + (tiles - a.n_main) * a.parts : tiles, m_tiles, a.ksplit);
  if (a.ksplit == 1) {
    w4_gemm_sm90_kernel<DOTS, SPW><<<grid, kThreads, smem, s>>>(tx, tw, a);
    return (int)cudaGetLastError();
  }
  CUtensorMap x = tx, w = tw;
  GemmArgs args = a;
  void* params[] = {&x, &w, &args};
  return (int)cudaLaunchCooperativeKernel((const void*)w4_gemm_sm90_kernel<DOTS, SPW>, grid,
                                          dim3(kThreads), params, smem, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). x (M, din) bf16; with dots == 0,
// w is the packed (nj, din/2, bout) uint8 slab and scales its (nj, s_rows,
// bout) bf16 scales, both of the selected layer; with dots == 1, w is a
// bf16 (din, dout) weight and scales is unused. Tile plan (quant.gemm_plan):
// spt slices of 64 rows per M tile (1..6), ksplit splits of kps k tiles of
// 32; with tail_parts > 0 (one M tile, no split) the column tiles past the
// last whole wave of n_sm are each shared by tail_parts CTAs, each taking a
// part of the slices; ws (ksplit, M, dout) f32 and counters (two zeroed ints per M tile
// and column tile, left as arrivals 0 and a generation) when ksplit > 1;
// then the grid must be co-resident (at most one CTA per SM). Needs din/2 a
// multiple of 32, the group a multiple of 16, dout and bout multiples of
// 128. Returns cudaGetLastError() after the launch.
extern "C" int w4_gemm_sm90(const void* x, const void* w, const void* scales, void* out,
                            void* ws, void* counters, int M, int din, int dout, int bout,
                            int s_rows, int group, int spt, int ksplit, int kps,
                            int tail_parts, int n_sm, int dots, int device, void* stream) {
  const int half = din / 2, nk = half / kBK;
  if (M < 1 || din % (2 * kBK) || dout % kBN || spt < 1 || spt > kMaxSlices || ksplit < 1 ||
      kps < 1 || (ksplit - 1) * kps >= nk || ksplit * kps < nk || ksplit > kMaxSplits ||
      (ksplit > 1 && !ws) || (tail_parts > 0 && (ksplit > 1 || M > spt * kSlice ||
                              tail_parts > (M + kSlice - 1) / kSlice)) ||
      (!dots && (bout % kBN || dout % bout || group < 16 || group % 16 || half % group)))
    return (int)cudaErrorInvalidValue;
  // the device's context current in this thread before the descriptors
  // are encoded (a thread's first CUDA call may be this one)
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorSharedObjectInitFailed;
  CUtensorMap tx, tw;
  const cuuint32_t e2[2] = {1, 1}, e3[3] = {1, 1, 1};
  const cuuint64_t xdims[2] = {(cuuint64_t)din, (cuuint64_t)M};
  const cuuint64_t xstr[1] = {(cuuint64_t)din * 2};
  const cuuint32_t xbox[2] = {kBK, kSlice};
  if (enc(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), xdims, xstr, xbox, e2,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  CUresult r;
  if (dots) {
    const cuuint64_t wdims[2] = {(cuuint64_t)dout, (cuuint64_t)din};
    const cuuint64_t wstr[1] = {(cuuint64_t)dout * 2};
    const cuuint32_t wbox[2] = {64, kBK};
    r = enc(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wdims, wstr, wbox,
            e2, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t wdims[3] = {(cuuint64_t)bout, (cuuint64_t)half, (cuuint64_t)(dout / bout)};
    const cuuint64_t wstr[2] = {(cuuint64_t)bout, (cuuint64_t)half * bout};
    const cuuint32_t wbox[3] = {kBN, kBK, 1};
    r = enc(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w), wdims, wstr, wbox, e3,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  GemmArgs a;
  a.scales = static_cast<const bf16*>(scales);
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.M = M;
  a.half = half;
  a.dout = dout;
  a.bout = bout;
  a.s_rows = s_rows;
  a.group = group;
  a.ngh = dots ? 0 : half / group;
  a.straddle = !dots && group % kBK != 0;
  a.spt = spt;
  a.ksplit = ksplit;
  a.kps = kps;
  a.n_main = dout / kBN / n_sm * n_sm;
  a.parts = tail_parts;
  const int m_tiles = (M + spt * kSlice - 1) / (spt * kSlice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // slices per consumer warpgroup
  if (dots)
    return spt > 4 ? launch<1, 3>(tx, tw, a, m_tiles, s)
                   : spt > 2 ? launch<1, 2>(tx, tw, a, m_tiles, s) : launch<1, 1>(tx, tw, a, m_tiles, s);
  return spt > 4 ? launch<0, 3>(tx, tw, a, m_tiles, s)
                 : spt > 2 ? launch<0, 2>(tx, tw, a, m_tiles, s) : launch<0, 1>(tx, tw, a, m_tiles, s);
}
