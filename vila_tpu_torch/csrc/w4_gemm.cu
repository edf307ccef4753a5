// W4A16 GEMM for M > 32 rows (prefill-shaped), for Hopper (sm_90a).
//
// Replaces the TPU kernels vila_tpu/ops/quant.py:_w4_prefill_kernel (flat)
// and the stacked `wrapped` closure of w4_matmul_prefill, both over
// _prefill_block_body.
//
// Arithmetic (identical to _prefill_block_body, hence to dequantize-then-
// matmul): each weight tile is dequantised to bf16 in shared memory as
//   w_lo = bf16((lo - 8) * s_lo)          (lo = low nibble, s_lo bf16)
//   w_hi = bf16(h16 * bf16(s_hi / 16))    (h16 = 16*(hi-8), exact)
// and the two planes contract against x[:, :din/2] and x[:, din/2:] with
// bf16 tensor-core products accumulated in f32 (mma.sync m16n8k16).
//
// Bound on this card: operations. At M=320 the GEMM does 2*M = 640 flops
// per weight element against ~0.5 byte of packed weight, above the ~300
// ops/byte where an H100 turns compute-bound, so the least time is
// 2*M*din*dout / 989 TFLOP/s. Design: BM x 128 output tiles (BM = 128, or
// 64 where the grid would not fill the card), 32-deep k tiles; 8 warps of
// (BM/2) x 32 mma.sync tiles fed by ldmatrix from row-major shared tiles.
// Each weight tile is dequantised once per block and reused by all BM rows;
// the next k tile's global loads are issued into registers while the
// current one is multiplied. Where the tiles alone leave the card idle, K is
// split over blocks and the last block of a tile sums the f32 partials in
// split order (deterministic). wgmma, TMA and a deeper pipeline are later
// work.
//
// The layer index selects the layer of the stacked (L, nj, din/2, bout)
// weights by pointer offset (done by the caller): no per-layer copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128, BK = 32, kThreads = 256;
constexpr int XS = BK + 8;  // x tile row stride (bf16): conflict-free ldmatrix
constexpr int WS = BN + 8;  // weight tile row stride (bf16)

struct GemmArgs {
  const __nv_bfloat16* x;       // (M, din)
  const uint8_t* packed;        // (nj, din/2, bout) of the selected layer
  const __nv_bfloat16* scales;  // (nj, s_rows, bout) of the selected layer
  __nv_bfloat16* out;           // (M, dout)
  float* ws;                    // (ksplit, M, dout) partials when ksplit > 1
  int* counters;                // per output tile, left zeroed
  int M, din, dout, bout, s_rows, group, ksplit, kps;
};

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

template <int BM>
__global__ void __launch_bounds__(kThreads) w4_gemm_kernel(GemmArgs a) {
  constexpr int MI = BM / 32;             // m16 tiles per warp (warp rows BM/2)
  constexpr int XI = BM * BK / 8 / kThreads;  // 16-byte x loads per thread per plane
  __shared__ __align__(16) __nv_bfloat16 xs[2][BM][XS];  // [plane][m][k]
  __shared__ __align__(16) __nv_bfloat16 wt[2][BK][WS];  // [plane][k][n]
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps
  const int half = a.din / 2, ngh = half / a.group;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int jb = n0 / a.bout, oo0 = n0 % a.bout;  // the tile lies in one bout block
  const uint8_t* pblk = a.packed + (size_t)jb * half * a.bout + oo0;
  const __nv_bfloat16* sblk = a.scales + (size_t)jb * a.s_rows * a.bout + oo0;
  const int nk = half / BK;
  const int kt0 = blockIdx.z * a.kps, kt1 = min(nk, kt0 + a.kps);

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // loader roles: x rows (idx >> 2) x 8-column chunks; weight row krow, 16 columns
  const int krow = tid >> 3, ncol = (tid & 7) * 16;
  uint4 xv[2][XI], pv, sl[2], sh[2];

  auto load = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < XI; ++i) {
        const int idx = tid + i * kThreads, gm = m0 + (idx >> 2);
        xv[p][i] = gm < a.M ? *reinterpret_cast<const uint4*>(
                                  a.x + (size_t)gm * a.din + p * half + k0 + (idx & 3) * 8)
                            : make_uint4(0, 0, 0, 0);
      }
    const int k = k0 + krow, g = k / a.group;
    pv = *reinterpret_cast<const uint4*>(pblk + (size_t)k * a.bout + ncol);
    const uint4* slo = reinterpret_cast<const uint4*>(sblk + (size_t)g * a.bout + ncol);
    const uint4* shi = reinterpret_cast<const uint4*>(sblk + (size_t)(ngh + g) * a.bout + ncol);
    sl[0] = slo[0];
    sl[1] = slo[1];
    sh[0] = shi[0];
    sh[1] = shi[1];
  };

  auto store = [&]() {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < XI; ++i) {
        const int idx = tid + i * kThreads;
        *reinterpret_cast<uint4*>(&xs[p][idx >> 2][(idx & 3) * 8]) = xv[p][i];
      }
    const uint8_t* pb = reinterpret_cast<const uint8_t*>(&pv);
    const __nv_bfloat16* s_lo = reinterpret_cast<const __nv_bfloat16*>(sl);
    const __nv_bfloat16* s_hi = reinterpret_cast<const __nv_bfloat16*>(sh);
    __align__(16) __nv_bfloat16 w_lo[16], w_hi[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int lo = pb[e] & 0x0F;
      const int h16 = (int)(int8_t)(uint8_t)((pb[e] & 0xF0) ^ 0x80);
      const float s_h = __bfloat162float(__float2bfloat16_rn(__bfloat162float(s_hi[e]) * 0.0625f));
      w_lo[e] = __float2bfloat16_rn((float)(lo - 8) * __bfloat162float(s_lo[e]));
      w_hi[e] = __float2bfloat16_rn((float)h16 * s_h);
    }
    uint4* dl = reinterpret_cast<uint4*>(&wt[0][krow][ncol]);
    uint4* dh = reinterpret_cast<uint4*>(&wt[1][krow][ncol]);
    dl[0] = reinterpret_cast<const uint4*>(w_lo)[0];
    dl[1] = reinterpret_cast<const uint4*>(w_lo)[1];
    dh[0] = reinterpret_cast<const uint4*>(w_hi)[0];
    dh[1] = reinterpret_cast<const uint4*>(w_hi)[1];
  };

  if (kt0 < kt1) load(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    store();
    __syncthreads();
    if (kt + 1 < kt1) load(kt + 1);  // in flight while the tile is multiplied
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[MI][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldsm_x4(af[mi], &xs[p][wm * (BM / 2) + mi * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t r[4];
          ldsm_x4_t(r, &wt[p][kk + (lane & 15)][wn * 32 + nj * 16 + (lane >> 4) * 8]);
          bfr[2 * nj][0] = r[0];
          bfr[2 * nj][1] = r[1];
          bfr[2 * nj + 1][0] = r[2];
          bfr[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
      }
    }
    __syncthreads();
  }

  // ---- epilogue: bf16 out, or f32 partials summed in split order by the last block
  const int gid = lane >> 2, tig = lane & 3;
  if (a.ksplit > 1) {
    float* part = a.ws + (size_t)blockIdx.z * a.M * a.dout;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + wm * (BM / 2) + mi * 16 + gid + 8 * h;
          const int c = n0 + wn * 32 + ni * 8 + tig * 2;
          if (r < a.M) {
            part[(size_t)r * a.dout + c] = acc[mi][ni][2 * h];
            part[(size_t)r * a.dout + c + 1] = acc[mi][ni][2 * h + 1];
          }
        }
    __threadfence();
    __syncthreads();
    int* counter = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) s_last = (atomicAdd(counter, 1) == a.ksplit - 1);
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + wm * (BM / 2) + mi * 16 + gid + 8 * h;
          const int c = n0 + wn * 32 + ni * 8 + tig * 2;
          if (r >= a.M) continue;
          float v0 = 0.f, v1 = 0.f;
          for (int z = 0; z < a.ksplit; ++z) {
            const float* pz = a.ws + ((size_t)z * a.M + r) * a.dout + c;
            v0 += __ldcg(pz);
            v1 += __ldcg(pz + 1);
          }
          acc[mi][ni][2 * h] = v0;
          acc[mi][ni][2 * h + 1] = v1;
        }
    if (tid == 0) *counter = 0;  // leave the counters zeroed for the next launch
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * (BM / 2) + mi * 16 + gid + 8 * h;
        const int c = n0 + wn * 32 + ni * 8 + tig * 2;
        if (r < a.M)
          *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)r * a.dout + c) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
}

}  // namespace

// Plain C entry point (bound with ctypes). Needs din/2 and group to be
// multiples of 32, bout and dout multiples of 128, bm 64 or 128, and (for
// ksplit > 1) a (ksplit, M, dout) f32 workspace and zeroed counters, one per
// output tile. Returns cudaGetLastError() after the launch.
extern "C" int w4_gemm(const void* x, const void* packed, const void* scales,
                       void* out, void* ws, void* counters, int M, int din,
                       int dout, int bout, int s_rows, int group, int bm,
                       int ksplit, int kps, void* stream) {
  GemmArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.packed = static_cast<const uint8_t*>(packed);
  a.scales = static_cast<const __nv_bfloat16*>(scales);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.M = M;
  a.din = din;
  a.dout = dout;
  a.bout = bout;
  a.s_rows = s_rows;
  a.group = group;
  a.ksplit = ksplit;
  a.kps = kps;
  const dim3 grid(dout / BN, (M + bm - 1) / bm, ksplit);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    w4_gemm_kernel<128><<<grid, kThreads, 0, s>>>(a);
  else if (bm == 64)
    w4_gemm_kernel<64><<<grid, kThreads, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
