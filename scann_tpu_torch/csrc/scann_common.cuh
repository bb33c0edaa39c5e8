// Building blocks shared by the whole-model forward and backward kernels:
// one block of kThreads threads per molecule, FP32 FMA products with the
// left operand in shared memory, warp-per-row LayerNorm.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace scann {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedBytes = 232448;   // 227 KB opt-in per block (sm_90)
constexpr int kErrSharedMemory = 10001;
constexpr int kErrShape = 10002;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float swishf(float x) { return x / (1.0f + expf(-x)); }

// d swish(x) / dx = s (1 + x (1 - s)), s = sigmoid(x)
__device__ __forceinline__ float swish_grad(float x) {
  const float s = 1.0f / (1.0f + expf(-x));
  return s * (1.0f + x * (1.0f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

// out[r][c] = sum_k A[r * lda + k] * W[k * ldw + c] for r < rows (<= 64),
// c < nc (a multiple of 4, <= 128). A lives in shared memory, W in global
// memory. Each thread owns up to 8 consecutive rows x 4 columns and hands
// every finished quad to epi(row, col, value). No barrier inside: the
// caller synchronises before reading the results.
template <typename Epi>
__device__ __forceinline__ void tile_gemm(const float* A, int lda, int rows, int K,
                                          const float* __restrict__ W, int ldw, int nc,
                                          Epi epi) {
  const int cg = nc >> 2;
  const int rgs = kThreads / cg;
  const int tid = threadIdx.x;
  if (tid >= rgs * cg) return;
  const int c = (tid % cg) * 4;
  const int rpt = (rows + rgs - 1) / rgs;
  const int r0 = (tid / cg) * rpt;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i][0] = 0.f; acc[i][1] = 0.f; acc[i][2] = 0.f; acc[i][3] = 0.f;
  }
  // the next k-step's four weight quads load while this step's FMAs run
  // (ldw is a multiple of 4, so the rows stay 16-byte aligned)
  int k = 0;
  const float4* Wc = reinterpret_cast<const float4*>(W + c);
  const int ldw4 = ldw >> 2;
  float4 p0 = make_float4(0.f, 0.f, 0.f, 0.f), p1 = p0, p2 = p0, p3 = p0;
  if (K >= 4) {
    p0 = __ldg(Wc); p1 = __ldg(Wc + ldw4); p2 = __ldg(Wc + 2 * ldw4); p3 = __ldg(Wc + 3 * ldw4);
  }
  for (; k + 4 <= K; k += 4) {
    const float4 w0 = p0, w1 = p1, w2 = p2, w3 = p3;
    if (k + 8 <= K) {
      const float4* q = Wc + (size_t)(k + 4) * ldw4;
      p0 = __ldg(q); p1 = __ldg(q + ldw4); p2 = __ldg(q + 2 * ldw4); p3 = __ldg(q + 3 * ldw4);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < rpt && r0 + i < rows) {
        const float4 av = *reinterpret_cast<const float4*>(A + (r0 + i) * lda + k);
        acc[i][0] = fmaf(av.x, w0.x, acc[i][0]);
        acc[i][1] = fmaf(av.x, w0.y, acc[i][1]);
        acc[i][2] = fmaf(av.x, w0.z, acc[i][2]);
        acc[i][3] = fmaf(av.x, w0.w, acc[i][3]);
        acc[i][0] = fmaf(av.y, w1.x, acc[i][0]);
        acc[i][1] = fmaf(av.y, w1.y, acc[i][1]);
        acc[i][2] = fmaf(av.y, w1.z, acc[i][2]);
        acc[i][3] = fmaf(av.y, w1.w, acc[i][3]);
        acc[i][0] = fmaf(av.z, w2.x, acc[i][0]);
        acc[i][1] = fmaf(av.z, w2.y, acc[i][1]);
        acc[i][2] = fmaf(av.z, w2.z, acc[i][2]);
        acc[i][3] = fmaf(av.z, w2.w, acc[i][3]);
        acc[i][0] = fmaf(av.w, w3.x, acc[i][0]);
        acc[i][1] = fmaf(av.w, w3.y, acc[i][1]);
        acc[i][2] = fmaf(av.w, w3.z, acc[i][2]);
        acc[i][3] = fmaf(av.w, w3.w, acc[i][3]);
      }
    }
  }
  for (; k < K; ++k) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(W + (size_t)k * ldw + c));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < rpt && r0 + i < rows) {
        const float av = A[(r0 + i) * lda + k];
        acc[i][0] = fmaf(av, w.x, acc[i][0]);
        acc[i][1] = fmaf(av, w.y, acc[i][1]);
        acc[i][2] = fmaf(av, w.z, acc[i][2]);
        acc[i][3] = fmaf(av, w.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < rpt && r0 + i < rows)
      epi(r0 + i, c, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

// Two-pass LayerNorm (eps 1e-6) of one row of D <= 128 values held by a
// warp, lane l holding elements l, l+32, l+64, l+96.
__device__ __forceinline__ void warp_layer_norm(float (&v)[4], int D, const float* gamma,
                                                const float* beta, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane + 32 * i < D) s += v[i];
  const float mean = warp_sum(s) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane + 32 * i < D) {
      const float t = v[i] - mean;
      q += t * t;
    }
  const float inv = rsqrtf(warp_sum(q) / (float)D + 1e-6f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = lane + 32 * i;
    if (d < D) v[i] = (v[i] - mean) * inv * gamma[d] + beta[d];
  }
}

}  // namespace scann
