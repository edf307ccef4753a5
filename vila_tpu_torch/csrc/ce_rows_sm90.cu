// The rows of the LM head's cross entropy, for Hopper (sm_90a): the port's
// own kernel, with no Pallas twin (the JAX package leaves the loss to XLA).
// Its role is the reference's Liger fused cross entropy: it sits between
// the head's two tensor-core products (ops/cross_entropy.py) so that the
// (rows, vocab) f32 logits are read and their gradient written once.
//
// One block a row of f32 logits x (entry `ce_rows`):
//   pass 1  an online max and sum of exp over the row (each thread its own
//           pair, merged across the block): lse = m + log(s); the row's
//           nll = lse - x[t] + z_loss * lse^2, 0 where t is IGNORE_INDEX;
//   pass 2  (when a gradient buffer is given) d nll / d x = p * (1 +
//           2 z_loss lse) - onehot(t), p = exp(x - lse), written as two bf16
//           rows: hi = bf16(g) at row r and lo = bf16(g - hi) at row
//           rows + r of a (2 rows, vocab) buffer, so that both backward
//           products read the f32 cotangent to within 2^-16 through one bf16
//           operand of twice the depth. An ignored row writes zeros.
// A target outside [0, vocab) other than IGNORE_INDEX gives nll NaN.
//
// Bound on this card: bytes. Pass 1 reads the row once and pass 2 again (a
// 152000-wide row is 608 KB, past what a block can keep), and pass 2 writes
// the same bytes as f32: 3 x 4 bytes an entry. The exps are f32 `expf`
// (within 2 ulp), the sums f32 in a fixed order for a given width, so a
// launch repeats bit for bit. Loads are 16 bytes a thread and stores 8
// where the width is a multiple of 4 and the pointers aligned; else scalar.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr long long kIgnore = -100;

struct MaxSum {
  float m, s;
};

__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return {m, 0.f};
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

__device__ __forceinline__ void add4(MaxSum& acc, float a, float b, float c, float d) {
  const float m = fmaxf(acc.m, fmaxf(fmaxf(a, b), fmaxf(c, d)));
  if (m == -INFINITY) return;
  acc.s = acc.s * expf(acc.m - m) + expf(a - m) + expf(b - m) + expf(c - m) + expf(d - m);
  acc.m = m;
}

__device__ __forceinline__ void add1(MaxSum& acc, float a) {
  const float m = fmaxf(acc.m, a);
  if (m == -INFINITY) return;
  acc.s = acc.s * expf(acc.m - m) + expf(a - m);
  acc.m = m;
}

// The block's merged pair, in every thread.
__device__ MaxSum block_merge(MaxSum v, MaxSum* shared) {
  for (int off = 16; off > 0; off >>= 1) {
    MaxSum o{__shfl_xor_sync(0xffffffffu, v.m, off), __shfl_xor_sync(0xffffffffu, v.s, off)};
    v = merge(v, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? shared[lane] : MaxSum{-INFINITY, 0.f};
    for (int off = 16; off > 0; off >>= 1) {
      MaxSum o{__shfl_xor_sync(0xffffffffu, v.m, off), __shfl_xor_sync(0xffffffffu, v.s, off)};
      v = merge(v, o);
    }
    if (lane == 0) shared[kWarps] = v;
  }
  __syncthreads();
  return shared[kWarps];
}

__device__ __forceinline__ void split(float g, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(g);
  lo = __float2bfloat16_rn(g - __bfloat162float(hi));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    ce_rows_kernel(const float* __restrict__ logits, const int64_t* __restrict__ targets,
                   float* __restrict__ nll, __nv_bfloat16* __restrict__ grad, int rows,
                   int vocab, float z_loss) {
  __shared__ MaxSum shared[kWarps + 1];
  const int r = blockIdx.x;
  const float* x = logits + (size_t)r * vocab;
  const long long t = targets[r];
  const bool valid = t != kIgnore;
  const int n4 = kVec ? vocab / 4 : 0;
  float lse = 0.f;
  if (valid) {
    MaxSum acc{-INFINITY, 0.f};
    if (kVec) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const float4 v = x4[i];
        add4(acc, v.x, v.y, v.z, v.w);
      }
    }
    for (int i = 4 * n4 + threadIdx.x; i < vocab; i += kThreads) add1(acc, x[i]);
    acc = block_merge(acc, shared);
    lse = acc.m + logf(acc.s);
    if (threadIdx.x == 0) {
      nll[r] = (t >= 0 && t < vocab) ? lse - x[t] + z_loss * lse * lse : NAN;
    }
  } else if (threadIdx.x == 0) {
    nll[r] = 0.f;
  }
  if (grad == nullptr) return;
  __nv_bfloat16* hi = grad + (size_t)r * vocab;
  __nv_bfloat16* lo = grad + ((size_t)rows + r) * vocab;
  const float scale = 1.f + 2.f * z_loss * lse;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      __align__(8) __nv_bfloat16 h[4];
      __align__(8) __nv_bfloat16 l[4];
      if (valid) {
        const float4 v = x4[i];
        const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float g = expf(xs[j] - lse) * scale;
          if (4 * i + j == t) g -= 1.f;
          split(g, h[j], l[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) h[j] = l[j] = __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint2*>(hi + 4 * i) = *reinterpret_cast<const uint2*>(h);
      *reinterpret_cast<uint2*>(lo + 4 * i) = *reinterpret_cast<const uint2*>(l);
    }
  }
  for (int i = 4 * n4 + threadIdx.x; i < vocab; i += kThreads) {
    float g = 0.f;
    if (valid) {
      g = expf(x[i] - lse) * scale;
      if (i == t) g -= 1.f;
    }
    split(g, hi[i], lo[i]);
  }
}

}  // namespace

// logits (rows, vocab) f32 row-major; targets (rows,) int64; nll (rows,) f32
// out; grad (2 rows, vocab) bf16 out, or null for the loss alone.
extern "C" int ce_rows(const void* logits, const void* targets, void* nll, void* grad,
                       int rows, int vocab, float z_loss, void* stream) {
  if (rows < 1 || vocab < 1) return (int)cudaErrorInvalidValue;
  const bool vec = vocab % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(grad) % 8 == 0;
  auto kernel = vec ? ce_rows_kernel<true> : ce_rows_kernel<false>;
  kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int64_t*>(targets),
      static_cast<float*>(nll), static_cast<__nv_bfloat16*>(grad), rows, vocab, z_loss);
  return (int)cudaGetLastError();
}
