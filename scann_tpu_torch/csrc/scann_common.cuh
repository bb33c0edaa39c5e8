// Building blocks shared by the port's kernels: blocks of kThreads threads,
// FP32 FMA products with the left operand in shared memory (the readouts'
// small products), the per-segment GA readout of a packed slot (structure
// packing), warp-per-row LayerNorm, the argument block of the whole-model
// forwards and the parameters of one LocalAttention layer.
//
// The bf16 operand mode of the whole-model forwards (model.dtype "bfloat16",
// scann_tpu/kernels/dots.py) rounds both operands of every product to
// bfloat16 (bf16r) and accumulates in f32; the helpers that take part in a
// product have a template switch for it (kBf16), off by default.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace scann {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedBytes = 232448;   // 227 KB opt-in per block (sm_90)
constexpr int kErrSharedMemory = 10001;
constexpr int kErrShape = 10002;

// The values of a row that each lane holds in the warp LayerNorms
// (warp_layer_norm): lane l holds columns l, l + 32, ..., so a build takes
// widths (D, G, O) up to kMaxWidth = 32 x kLaneValues. The builds of widths
// up to 128 hold 4; the wide-width sources (*_d256.cu) define
// SCANN_WIDTH_256 and hold 8, up to 256. The sources of widths past 256
// (*_d512.cu) define SCANN_WIDTH_512 beside SCANN_WIDTH_256, so they take
// every code path of the builds past 128 columns, and hold 16, up to 512.
#if defined(SCANN_WIDTH_512)
constexpr int kLaneValues = 16;
#elif defined(SCANN_WIDTH_256)
constexpr int kLaneValues = 8;
#else
constexpr int kLaneValues = 4;
#endif
constexpr int kMaxWidth = 32 * kLaneValues;

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

// x rounded to bfloat16 (to nearest, ties to even) and back to f32: the
// operand rounding of the bf16 mode.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x rounded by the operand policy: bf16r in the bf16 mode, unchanged otherwise.
template <bool kBf16>
__device__ __forceinline__ float operand(float x) {
  return kBf16 ? bf16r(x) : x;
}

template <bool kBf16>
__device__ __forceinline__ float4 operand4(float4 v) {
  return kBf16 ? make_float4(bf16r(v.x), bf16r(v.y), bf16r(v.z), bf16r(v.w)) : v;
}

// Element types of the per-layer kernel's tensors (float or bfloat16): to
// and from the f32 it computes in.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// out[r][c] = sum_k A[r * lda + k] * W[k * ldw + c] for r < rows (<= 64),
// c < nc (a multiple of 4; rows <= 8 x (4 kThreads / nc), so one row up to
// nc = 1024: the readouts' heads, O <= 256). A lives in shared memory, W in global
// memory. Each thread owns up to 8 consecutive rows x 4 columns and hands
// every finished quad to epi(row, col, value). No barrier inside: the
// caller synchronises before reading the results. kBf16: both operands
// rounded to bfloat16.
template <bool kBf16 = false, typename Epi>
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
    const float4 w0 = operand4<kBf16>(p0), w1 = operand4<kBf16>(p1), w2 = operand4<kBf16>(p2),
                 w3 = operand4<kBf16>(p3);
    if (k + 8 <= K) {
      const float4* q = Wc + (size_t)(k + 4) * ldw4;
      p0 = __ldg(q); p1 = __ldg(q + ldw4); p2 = __ldg(q + 2 * ldw4); p3 = __ldg(q + 3 * ldw4);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < rpt && r0 + i < rows) {
        const float4 av = operand4<kBf16>(*reinterpret_cast<const float4*>(A + (r0 + i) * lda + k));
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
    const float4 w = operand4<kBf16>(__ldg(reinterpret_cast<const float4*>(W + (size_t)k * ldw + c)));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < rpt && r0 + i < rows) {
        const float av = operand<kBf16>(A[(r0 + i) * lda + k]);
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

// ---- the per-segment GA readout of a packed slot ---------------------------
// Structure packing puts several structures into one slot of M rows; row m
// belongs to segment seg[m] (-1 on a padded row), and every per-structure
// reduction of the GA readout runs per segment: the sums of the GA queries,
// the norm, the softmax denominator, the pooled context, then the head on
// each segment's pooled row. The TPU kernels form these sums as [M, S]
// one-hot products (scann_tpu/kernels/scann_forward.py:372-403); here they are
// ordered sums in shared memory: one thread per column (or one warp per
// segment) walks the rows in order, with no atomics, so a launch repeats bit
// for bit. All four whole-model kernels run the readout over all M rows of
// the slot inside one block, so no sum crosses blocks.
constexpr int kMaxSegments = 32;

// out[s * ldo + g] += coef(m) * x[r * ldx + g] over the rows r < rows of the
// slot (m = m0 + r) with seg[m] = s >= 0, for every s < S and g < G: one
// thread per column, rows in order. With `first` the thread zeroes its
// columns of all S rows first. kRound: each term rounded to bfloat16 before
// it is added (a pool as a bf16-mode product, scann_tpu/kernels/scann_loop.py:375).
// No barrier inside.
template <bool kRound = false, typename Coef>
__device__ __forceinline__ void seg_pool(float* out, int ldo, int S, const float* x, int ldx,
                                         const int* seg, int m0, int rows, int G, bool first,
                                         Coef coef) {
  for (int g = threadIdx.x; g < G; g += kThreads) {
    if (first)
      for (int s = 0; s < S; ++s) out[s * ldo + g] = 0.f;
    for (int r = 0; r < rows; ++r) {
      const int s = seg[m0 + r];
      if (s >= 0) out[s * ldo + g] += operand<kRound>(coef(m0 + r) * x[r * ldx + g]);
    }
  }
}

// v[s] = the sum of f(m) over the rows m < M with seg[m] = s, for s < S: one
// warp per segment, lanes strided over the rows, then the warp's butterfly
// sum, as the unpacked readout sums its rows. kRound: each f(m) rounded to
// bfloat16 first. No barrier inside.
template <bool kRound = false, typename F>
__device__ __forceinline__ void seg_sum(float* v, int S, const int* seg, int M, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < S; s += kWarps) {
    float t = 0.f;
    for (int m = lane; m < M; m += 32)
      if (seg[m] == s) t += operand<kRound>(f(m));
    t = warp_sum(t);
    if (lane == 0) v[s] = t;
  }
}

// v[s] = the largest f(m) over the rows m < M with seg[m] = s (-inf for an
// empty segment), one warp per segment. No barrier inside.
template <typename F>
__device__ __forceinline__ void seg_max(float* v, int S, const int* seg, int M, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < S; s += kWarps) {
    float t = -INFINITY;
    for (int m = lane; m < M; m += 32)
      if (seg[m] == s) t = fmaxf(t, f(m));
    t = warp_max(t);
    if (lane == 0) v[s] = t;
  }
}

// The GA scores of a packed slot. keys [M, ldk] are the GA keys of every row,
// diag [M] = (mask k) . (mask q) of each row, qsum [S, ldq] each segment's sum
// of mask q (seg_pool). Writes agg0 [M] = mask ((mask k) . qsum[seg] - diag),
// nrm [S] (each segment's euclidean norm of agg0 with ga_norm, a zero norm
// counted as 1; 1 without), ga [M] = the softmax over each segment's rows,
// shifted by the slot's max (constant within a segment, as
// scann_tpu/kernels/scann_forward.py:395-398 shifts it) and divided by the segment's sum (a zero sum, from underflow or
// on a padded row, counted as 1), and den [S] = those sums. Barriers inside:
// every thread of the block calls it.
//
// kBf16Pools: the pools as the bf16-mode products of the TPU loop kernel
// (scann_tpu/kernels/scann_loop.py:367-388): each pooled term and each
// pooled value broadcast back to its rows (qsum, the norm, the softmax sum)
// rounded to bfloat16, and the softmax shifted by each segment's own max,
// rounded to bfloat16 (den then holds that max until the sums replace it).
template <bool kBf16Pools = false>
__device__ inline void seg_scores(const float* keys, int ldk, const float* diag,
                                  const float* qsum, int ldq, const float* am, const int* seg,
                                  int M, int S, int G, bool ga_norm, float* agg0, float* nrm,
                                  float* ga, float* den) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int m = warp; m < M; m += kWarps) {
    const int s = seg[m];
    float cross = 0.f;
    if (s >= 0) {
      const float mm = am[m];
      for (int g = lane; g < G; g += 32)
        cross += (mm * keys[m * ldk + g]) * operand<kBf16Pools>(qsum[s * ldq + g]);
    }
    cross = warp_sum(cross);
    if (lane == 0) agg0[m] = s >= 0 ? am[m] * (cross - diag[m]) : 0.f;   // a padded row's mask is 0
  }
  __syncthreads();
  if (ga_norm) seg_sum<kBf16Pools>(nrm, S, seg, M, [&](int m) { return agg0[m] * agg0[m]; });
  __syncthreads();
  for (int s = tid; s < S; s += kThreads) {
    const float n = ga_norm ? operand<kBf16Pools>(sqrtf(nrm[s])) : 1.f;
    nrm[s] = n == 0.f ? 1.f : n;   // a single-atom structure: zero sum
  }
  __syncthreads();
  if (kBf16Pools) {
    for (int m = tid; m < M; m += kThreads) {
      const int s = seg[m];
      ga[m] = (s >= 0 ? agg0[m] / nrm[s] : agg0[m]) + (1.0f - am[m]) * -1e9f;
    }
    __syncthreads();
    seg_max(den, S, seg, M, [&](int m) { return ga[m]; });
    __syncthreads();
    for (int m = tid; m < M; m += kThreads) {
      const int s = seg[m];
      ga[m] = s >= 0 ? expf(ga[m] - bf16r(den[s])) * am[m] : 0.f;
    }
  } else if (warp == 0) {
    float mx = -INFINITY;
    for (int m = lane; m < M; m += 32) {
      const int s = seg[m];
      const float v = (s >= 0 ? agg0[m] / nrm[s] : agg0[m]) + (1.0f - am[m]) * -1e9f;
      ga[m] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    for (int m = lane; m < M; m += 32) ga[m] = expf(ga[m] - mx);
  }
  __syncthreads();
  seg_sum<kBf16Pools>(den, S, seg, M, [&](int m) { return ga[m]; });
  __syncthreads();
  for (int m = tid; m < M; m += kThreads) {
    const int s = seg[m];
    const float d = s >= 0 ? operand<kBf16Pools>(den[s]) : 0.f;
    ga[m] = ga[m] / (d == 0.f ? 1.f : d);
  }
  __syncthreads();
}

// The backward of seg_scores, per segment as
// scann_tpu/kernels/scann_backward.py:367-388: from dga [M] (d ga) to dcd [M]
// = mask d agg0, through each segment's softmax and norm. gd [S] and inner [S]
// are scratch. kBf16Pools: the pools as seg_scores<true> forms them (each
// pooled term and each pooled value broadcast to its rows rounded,
// scann_tpu/kernels/scann_loop.py:702-706). Barriers inside.
template <bool kBf16Pools = false>
__device__ inline void seg_scores_backward(const float* dga, const float* ga,
                                           const float* agg0, const float* nrm,
                                           const float* am, const int* seg, int M, int S,
                                           bool ga_norm, float* gd, float* inner, float* dcd) {
  const int tid = threadIdx.x;
  seg_sum<kBf16Pools>(gd, S, seg, M, [&](int m) { return ga[m] * dga[m]; });
  __syncthreads();
  for (int m = tid; m < M; m += kThreads) {
    const int s = seg[m];
    dcd[m] = ga[m] * (dga[m] - (s >= 0 ? operand<kBf16Pools>(gd[s]) : 0.f));   // softmax over the segment
  }
  __syncthreads();
  if (ga_norm) seg_sum<kBf16Pools>(inner, S, seg, M, [&](int m) { return agg0[m] * dcd[m]; });
  __syncthreads();
  for (int m = tid; m < M; m += kThreads) {
    const int s = seg[m];
    float da = dcd[m];
    if (ga_norm && s >= 0) {
      const float n = nrm[s];
      da = da / n - agg0[m] * (operand<kBf16Pools>(inner[s]) / (n * n * n));
    }
    dcd[m] = da * am[m];
  }
  __syncthreads();
}

// The property head of one pooled row struc [G]: sb [O] = swish(sbf = struc
// @ Wbf + bbf) (sbf kept when non-null), then pred = sb . wp + bp (mrelu on
// request), returned to thread 0 (0 elsewhere); kBf16: both products in the
// bf16 operand mode. Barriers inside.
template <bool kBf16 = false>
__device__ inline float seg_head(const float* struc, int G, int O, const float* wbf,
                                 const float* bbf, const float* wp, const float* bp, bool mrelu,
                                 float* sbf, float* sb) {
  tile_gemm<kBf16>(struc, G, 1, G, wbf, O, O, [&](int r, int c, float4 v) {
    const float4 s = make_float4(v.x + bbf[c], v.y + bbf[c + 1], v.z + bbf[c + 2], v.w + bbf[c + 3]);
    if (sbf) *reinterpret_cast<float4*>(sbf + c) = s;
    *reinterpret_cast<float4*>(sb + c) =
        make_float4(swishf(s.x), swishf(s.y), swishf(s.z), swishf(s.w));
  });
  __syncthreads();
  float p = 0.f;
  if (threadIdx.x < 32) {
    for (int o = threadIdx.x; o < O; o += 32) p += operand<kBf16>(sb[o]) * operand<kBf16>(wp[o]);
    p = warp_sum(p) + bp[0];
    if (mrelu) p = fmaxf(p, 0.f);
  }
  __syncthreads();
  return threadIdx.x == 0 ? p : 0.f;
}

// The backward of seg_head for one pooled row struc [G] with d pred = ctp
// (sb and sbf from seg_head): writes (acc false) or adds to the gradients of
// predict_property (gwp [O], gbp [1]) and bf_property (gwbf [G, O], gbbf
// [O]), each times `mine` (0 in the blocks of a cluster other than its
// first, which write zeros), and writes dstruc [G] = d struc. dsbf [O] is
// scratch. Each gradient element belongs to one thread at every call, so
// the sums over the segments repeat bit for bit. kBf16: the head's
// gradient products in the bf16 operand mode (d pred rounded too; the bias
// gradients unrounded). Barriers inside.
template <bool kBf16 = false>
__device__ inline void seg_head_backward(float ctp, const float* sb, const float* sbf,
                                         const float* struc, int G, int O, const float* wp,
                                         const float* wbf, float mine, bool acc, float* gwp,
                                         float* gbp, float* gwbf, float* gbbf, float* dsbf,
                                         float* dstruc) {
  const int tid = threadIdx.x;
  const float c = operand<kBf16>(ctp);
  if (tid == 0) gbp[0] = (acc ? gbp[0] : 0.f) + ctp * mine;
  for (int o = tid; o < O; o += kThreads) {
    gwp[o] = (acc ? gwp[o] : 0.f) + operand<kBf16>(sb[o]) * c * mine;
    dsbf[o] = c * operand<kBf16>(wp[o]) * swish_grad(sbf[o]);
  }
  __syncthreads();
  for (int i = tid; i < G * O; i += kThreads) {
    const int g = i / O, o = i - g * O;
    gwbf[i] = (acc ? gwbf[i] : 0.f) + operand<kBf16>(struc[g]) * operand<kBf16>(dsbf[o]) * mine;
  }
  for (int o = tid; o < O; o += kThreads) gbbf[o] = (acc ? gbbf[o] : 0.f) + dsbf[o] * mine;
  for (int g = tid; g < G; g += kThreads) {
    float t = 0.f;
    for (int o = 0; o < O; ++o) t += operand<kBf16>(dsbf[o]) * operand<kBf16>(wbf[(size_t)g * O + o]);
    dstruc[g] = t;
  }
  __syncthreads();
}

// Floats of the forward kernels' per-segment readout vectors: qsum and struc
// [S, ld] each, agg0, ga and diag [M] each, nrm and den [S] each, the head's
// [O].
__host__ __device__ inline int seg_forward_floats(int S, int ld, int M, int O) {
  return 2 * S * ld + 3 * round4(M) + 2 * round4(S) + round4(O);
}

// Floats of the backward kernels' per-segment readout vectors: qsum, struc
// (then d qsum) and d struc [S, ld] each; agg0, ga, d ga, dcd and diag [M]
// each; nrm, den, d pred and a scratch [S] each; the head's three [O].
__host__ __device__ inline int seg_backward_floats(int S, int ld, int M, int O) {
  return 3 * S * ld + 5 * round4(M) + 4 * round4(S) + 3 * round4(O);
}

// The per-segment readout vectors of a packed slot in shared memory, at row
// stride ld, laid out as seg_forward_floats (backward false: no dstruc, dga,
// dcd, ctp, cnt, sbf, dsbf) or seg_backward_floats count them.
struct SegVectors {
  int ld;
  float *qsum, *struc, *dstruc;            // [S, ld]; struc becomes d qsum
  float *agg0, *ga, *dga, *dcd, *diag;     // [M]
  float *nrm, *den, *ctp, *cnt;            // [S]
  float *sbf, *sb, *dsbf;                  // [O]
};

__device__ inline SegVectors seg_vectors(float* p, int S, int ld, int M, int O, bool backward) {
  SegVectors v = {};
  auto take = [&](float*& dst, int n) { dst = p; p += n; };
  v.ld = ld;
  take(v.qsum, S * ld);
  take(v.struc, S * ld);
  if (backward) take(v.dstruc, S * ld);
  take(v.agg0, round4(M));
  take(v.ga, round4(M));
  if (backward) {
    take(v.dga, round4(M));
    take(v.dcd, round4(M));
  }
  take(v.diag, round4(M));
  take(v.nrm, round4(S));
  take(v.den, round4(S));
  if (backward) {
    take(v.ctp, round4(S));
    take(v.cnt, round4(S));
    take(v.sbf, round4(O));
  }
  take(v.sb, round4(O));
  if (backward) take(v.dsbf, round4(O));
  return v;
}

// Adds rows m0 .. m0 + rows of a packed slot to their segments' sums of
// mask q (v.qsum, zeroed first with `first`) and writes their diag =
// (mask k) . (mask q). q [rows, ldq] holds those rows' GA queries; keys the
// slot's GA keys, row m at keys + m * ldk. kBf16Pools: the pool's terms
// rounded to bfloat16 (seg_scores). No barrier inside.
template <bool kBf16Pools = false>
__device__ inline void seg_queries(const SegVectors& v, int S, const float* q, int ldq,
                                   const float* keys, int ldk, const float* am, const int* seg,
                                   int m0, int rows, int G, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  seg_pool<kBf16Pools>(v.qsum, v.ld, S, q, ldq, seg, m0, rows, G, first,
                       [&](int m) { return am[m]; });
  for (int r = warp; r < rows; r += kWarps) {
    const float mm = am[m0 + r];
    float dg = 0.f;
    for (int g = lane; g < G; g += 32) dg += (mm * keys[(m0 + r) * ldk + g]) * (mm * q[r * ldq + g]);
    dg = warp_sum(dg);
    if (lane == 0) v.diag[m0 + r] = dg;
  }
}

// The forward readout of a packed slot once seg_queries has seen every row:
// the GA scores (v.ga), the pooled rows and the head per segment; pred [S]
// is written by thread 0 when non-null. kBf16: the head's products in the
// bf16 operand mode; kBf16Pools: the pools too (seg_scores). Barriers inside.
template <bool kBf16 = false, bool kBf16Pools = false>
__device__ inline void seg_readout_forward(const SegVectors& v, const float* keys, int ldk,
                                           const float* am, const int* seg, int M, int S, int G,
                                           int O, bool ga_norm, const float* wbf,
                                           const float* bbf, const float* wp, const float* bp,
                                           bool mrelu, float* pred) {
  seg_scores<kBf16Pools>(keys, ldk, v.diag, v.qsum, v.ld, am, seg, M, S, G, ga_norm, v.agg0,
                         v.nrm, v.ga, v.den);
  seg_pool<kBf16Pools>(v.struc, v.ld, S, keys, ldk, seg, 0, M, G, true,
                       [&](int m) { return am[m] * v.ga[m]; });
  __syncthreads();
  for (int s = 0; s < S; ++s) {
    const float p =
        seg_head<kBf16>(v.struc + s * v.ld, G, O, wbf, bbf, wp, bp, mrelu, nullptr, v.sb);
    if (threadIdx.x == 0 && pred) pred[s] = p;
  }
}

// The readout of a packed slot and its backward, once seg_queries has seen
// every row, as scann_tpu/kernels/scann_backward.py:289-389: the scores, the
// head per segment (pred [S] written by thread 0 when non-null), d pred =
// ct[s], or in one-shot mode the residual pred - ct[s] zeroed for a segment
// without atoms, the head's gradients (times `mine`), d struc, d ga (plus
// ct_ga [M] when non-null), dcd, and d qsum in place of v.struc. kBf16: the
// head's products in the bf16 operand mode; kBf16Pools: the pools too, as
// the TPU loop kernel forms them (scann_tpu/kernels/scann_loop.py:636-714;
// d struc reaches the rows rounded). Barriers inside.
template <bool kBf16 = false, bool kBf16Pools = false>
__device__ inline void seg_readout_backward(const SegVectors& v, const float* keys, int ldk,
                                            const float* am, const int* seg, int M, int S, int G,
                                            int O, bool ga_norm, bool mrelu, bool one_shot,
                                            const float* ct, const float* ct_ga,
                                            const float* wbf, const float* bbf, const float* wp,
                                            const float* bp, float* pred, float mine, float* gwp,
                                            float* gbp, float* gwbf, float* gbbf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, ld = v.ld;
  seg_scores<kBf16Pools>(keys, ldk, v.diag, v.qsum, ld, am, seg, M, S, G, ga_norm, v.agg0, v.nrm,
                         v.ga, v.den);
  seg_pool<kBf16Pools>(v.struc, ld, S, keys, ldk, seg, 0, M, G, true,
                       [&](int m) { return am[m] * v.ga[m]; });
  seg_sum(v.cnt, S, seg, M, [&](int m) { return am[m]; });
  __syncthreads();
  for (int s = 0; s < S; ++s) {
    const float p = seg_head<kBf16>(v.struc + s * ld, G, O, wbf, bbf, wp, bp, mrelu, v.sbf, v.sb);
    if (threadIdx.x == 0) {
      if (pred) pred[s] = p;
      // one-shot: the residual of a segment without atoms is zeroed
      v.ctp[s] = one_shot ? (p - ct[s]) * (v.cnt[s] > 0.f ? 1.f : 0.f) : ct[s];
    }
    __syncthreads();
    seg_head_backward<kBf16>(v.ctp[s], v.sb, v.sbf, v.struc + s * ld, G, O, wp, wbf, mine, s > 0,
                             gwp, gbp, gwbf, gbbf, v.dsbf, v.dstruc + s * ld);
  }
  for (int m = warp; m < M; m += kWarps) {
    const int sg = seg[m];
    float t = 0.f;
    if (sg >= 0)
      for (int g = lane; g < G; g += 32)
        t += am[m] * keys[m * ldk + g] * operand<kBf16Pools>(v.dstruc[sg * ld + g]);
    t = warp_sum(t);
    if (lane == 0) v.dga[m] = t + (ct_ga ? ct_ga[m] : 0.f);
  }
  __syncthreads();
  seg_scores_backward<kBf16Pools>(v.dga, v.ga, v.agg0, v.nrm, am, seg, M, S, ga_norm, v.cnt, v.den,
                                  v.dcd);
  seg_pool<kBf16Pools>(v.struc, ld, S, keys, ldk, seg, 0, M, G, true,
                       [&](int m) { return v.dcd[m] * am[m]; });
  __syncthreads();
}

// The gradients of the GA queries and keys of rows m0 .. m0 + rows of a
// packed slot, after seg_readout_backward, in place: q [rows, ldq] from gq
// to d gq, k [rows, ldk] from gk to d gk. kBf16Pools: the pooled values
// reach the rows rounded, as seg_readout_backward<kBf16, true> forms them.
// No barrier inside.
template <bool kBf16Pools = false>
__device__ inline void seg_query_key_grads(const SegVectors& v, float* q, int ldq, float* k,
                                           int ldk, const float* am, const int* seg, int m0,
                                           int rows, int G) {
  const int ld = v.ld;
  for (int i = threadIdx.x; i < rows * G; i += kThreads) {
    const int r = i / G, g = i - r * G, m = m0 + r, sg = seg[m];
    const float mm = am[m], mk = mm * k[r * ldk + g], mq = mm * q[r * ldq + g];
    const float qs = sg >= 0 ? operand<kBf16Pools>(v.qsum[sg * ld + g]) : 0.f;
    const float dq = sg >= 0 ? operand<kBf16Pools>(v.struc[sg * ld + g]) : 0.f;
    const float ds = sg >= 0 ? operand<kBf16Pools>(v.dstruc[sg * ld + g]) : 0.f;
    const float dcd = v.dcd[m];
    q[r * ldq + g] = mm * (-dcd * mk + dq);
    k[r * ldk + g] = mm * v.ga[m] * ds + mm * (dcd * qs - dcd * mq);
  }
}

// Two-pass LayerNorm (eps 1e-6) of one row of D <= 32 V values held by a
// warp, lane l holding elements l, l+32, ..., l + 32 (V - 1) (V = 4 in the
// builds of widths up to 128); gamma and beta of element type T (float or
// bfloat16).
template <typename T, int V>
__device__ __forceinline__ void warp_layer_norm(float (&v)[V], int D, const T* gamma,
                                                const T* beta, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (lane + 32 * i < D) s += v[i];
  const float mean = warp_sum(s) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (lane + 32 * i < D) {
      const float t = v[i] - mean;
      q += t * t;
    }
  const float inv = rsqrtf(warp_sum(q) / (float)D + 1e-6f);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int d = lane + 32 * i;
    if (d < D) v[i] = (v[i] - mean) * inv * to_float(gamma[d]) + to_float(beta[d]);
  }
}

// Arguments of the whole-model forwards (scann_forward.cu for molecules,
// scann_loop.cu for crystals).
struct ForwardArgs {
  // inputs of one padded batch
  const int* atomic;          // [B, M]     (feature "atomic")
  const float* feat;          // [B, M, F]  (feature "cgcnn")
  const float* atom_mask;     // [B, M]
  const int* nbr;             // [B, M, N]
  const float* nmask;         // [B, M, N]
  const float* nweight;       // [B, M, N]
  const float* ndist;         // [B, M, N]
  const float* ring;          // [B, M, 2]  (use_ring)
  const float* dist_centers;  // [K]
  const float* angle_centers; // [K]
  // embedding
  const float* embed;   // [n_atoms, E] lookup table, or [F, E] cgcnn kernel
  const float* bembed;  // [E] (cgcnn)
  const float* wring;   // [2, 10]
  const float* bring;   // [10]
  const float* wde;     // [E (+10), D]
  const float* bde;     // [D]
  const float* wnd;     // [K, D]  (g_update)
  const float* bnd;
  const float* wnw;     // [K, D]  (g_update)
  const float* bnw;
  // per-layer parameters stacked on a leading [L] axis
  const float* wfg;     // [L, 3D or K, D]
  const float* bfg;     // [L, D]
  const float* wk;      // [L, D, D]
  const float* bk;
  const float* wq;
  const float* bq;
  const float* ln_s;
  const float* ln_b;
  const float* lng_s;
  const float* lng_b;
  const float* wr1;
  const float* br1;
  const float* wr2;
  const float* br2;
  const float* rln_s;
  const float* rln_b;
  // readout
  const float* wal;     // [D, G]
  const float* bal;
  const float* wgq;     // [G, G]
  const float* bgq;
  const float* wgk;     // [G, G]
  const float* bgk;
  const float* wbf;     // [G, O]
  const float* bbf;
  const float* wp;      // [O, 1]
  const float* bp;      // [1]
  // scratch and outputs
  float* geo;           // [B, M, N, D]  (g_update)
  float* pred;          // [B]
  float* ga;            // [B, M]
  float* next_centers;  // [B, M, D]     (scann_loop.cu only)
  const int* seg;       // [B, M] segment of each row, -1 on padding (packed slots)
  // sizes and switches
  int B, M, N, D, H, E, K, G, O, L, F;
  int cgcnn, use_ring, g_update, ga_norm, mrelu;
  int chunk_atoms;      // atoms per geometry chunk (chunk rows = CA * N <= 64)
  int abuf_floats;      // floats of the chunk operand buffer
  int atom_block;       // atoms per per-atom product (scann_loop.cu only)
  int S;                // segments per slot (0: one structure per row block)
  float dk;             // hd ** -scale
  float rbf_width;      // squared Gaussian width (0.25)
  // training dropout (philox.cuh): masks keyed on (seed, mol_base + b)
  int dropout, attn_dropout;
  unsigned int seed, mol_base, drop_threshold, attn_threshold;
  float drop_scale, attn_scale;
};

// Fills ForwardArgs from the 49 pointers, 20 sizes, 4 scalars and 4
// random-stream words that kernels/scann_forward.py passes, in its order.
inline void unpack_forward_args(ForwardArgs& a, void* const* ptrs, const int* dims,
                                const float* scalars, const unsigned int* rng) {
  const void* const* p = ptrs;
  int i = 0;
  a.atomic = (const int*)p[i++];
  a.feat = (const float*)p[i++];
  a.atom_mask = (const float*)p[i++];
  a.nbr = (const int*)p[i++];
  const float** f[] = {
      &a.nmask, &a.nweight, &a.ndist, &a.ring, &a.dist_centers, &a.angle_centers,
      &a.embed, &a.bembed, &a.wring, &a.bring, &a.wde, &a.bde, &a.wnd, &a.bnd, &a.wnw, &a.bnw,
      &a.wfg, &a.bfg, &a.wk, &a.bk, &a.wq, &a.bq, &a.ln_s, &a.ln_b, &a.lng_s, &a.lng_b,
      &a.wr1, &a.br1, &a.wr2, &a.br2, &a.rln_s, &a.rln_b,
      &a.wal, &a.bal, &a.wgq, &a.bgq, &a.wgk, &a.bgk, &a.wbf, &a.bbf, &a.wp, &a.bp};
  for (const float** q : f) *q = (const float*)p[i++];
  a.geo = (float*)p[i++];
  a.pred = (float*)p[i++];
  a.ga = (float*)p[i++];
  a.next_centers = nullptr;

  a.B = dims[0]; a.M = dims[1]; a.N = dims[2]; a.D = dims[3]; a.H = dims[4];
  a.E = dims[5]; a.K = dims[6]; a.G = dims[7]; a.O = dims[8]; a.L = dims[9];
  a.F = dims[10];
  a.cgcnn = dims[11]; a.use_ring = dims[12]; a.g_update = dims[13];
  a.ga_norm = dims[14]; a.mrelu = dims[15];
  a.chunk_atoms = dims[16]; a.abuf_floats = dims[17];
  a.dropout = dims[18]; a.attn_dropout = dims[19];
  a.atom_block = 0;
  a.seg = nullptr;
  a.S = 0;
  a.dk = scalars[0];
  a.rbf_width = scalars[1];
  a.drop_scale = scalars[2];
  a.attn_scale = scalars[3];
  a.seed = rng[0]; a.mol_base = rng[1]; a.drop_threshold = rng[2]; a.attn_threshold = rng[3];
}

// The parameters of one LocalAttention layer, of element type T (float, or
// bfloat16 in the per-layer kernel).
template <typename T>
struct LayerWeightsT {
  const T* wfg;     // [3D, D] (SCANN+) or [K, D] (SCANN)
  const T* bfg;
  const T* wk;      // [D, D]
  const T* bk;
  const T* ln_s;
  const T* ln_b;
  const T* lng_s;   // geometry LayerNorm (SCANN+)
  const T* lng_b;
};
using LayerWeights = LayerWeightsT<float>;

// The LocalAttention parameters of layer l of the stacked [L, ...] arrays.
__device__ __forceinline__ LayerWeights layer_weights(const ForwardArgs& a, int l) {
  const size_t D = a.D, fg_in = a.g_update ? 3 * D : (size_t)a.K;
  LayerWeights w;
  w.wfg = a.wfg + l * fg_in * D;
  w.bfg = a.bfg + l * D;
  w.wk = a.wk + l * D * D;
  w.bk = a.bk + l * D;
  w.ln_s = a.ln_s + l * D;
  w.ln_b = a.ln_b + l * D;
  w.lng_s = a.g_update ? a.lng_s + l * D : nullptr;
  w.lng_b = a.g_update ? a.lng_b + l * D : nullptr;
  return w;
}

}  // namespace scann
