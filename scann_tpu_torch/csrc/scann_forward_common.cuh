// Building blocks of the forwards on the tensor cores: the LocalAttention of
// one chunk of (atom, neighbour) rows (fwd_chunk), which the two whole-model
// forwards (scann_forward.cu for molecules, scann_loop.cu for crystals) and
// the per-layer kernel (local_attention.cu) share, and for the whole-model
// forwards the staging of a chunk, the SCANN+ geometry embedding, the atom
// embedding and the ResidualNorm of a block of atoms.
//
// Products. Every row product is mma_gemm of scann_mma.cuh: split-TF32
// mma.sync m16n8k8 in three passes accumulated in f32 (within 2e-6 x max of a
// float64 product), the block's 8 warps splitting the output columns 16 each,
// so a weight element leaves L2 once per 32 rows. The chunk's operand buffers
// have row strides of 2D + 4 and D + 4 floats (4 mod 32), which keeps the
// fragment reads free of bank conflicts. #1, the tall #3 and the narrow #5
// past 128 columns take fwd_chunk_w32 instead: the same chunk with its products
// in the 32-column layout (mma_gemm_w32) on TF32 planes of the weights
// (RowPlanes), bit for bit the same outputs; the wide #3 and #5 past 128
// columns walk their atoms in the same layout (fwd_atom_wide_keys with kW32,
// sub-chunks of 32 rows).
//
// The serial tails of the chunk: energies and the softmax over N <= 64
// neighbours one warp per (atom, head) (lane n holds neighbours n and n + 32,
// reductions by shuffles in a fixed tree), which also folds the neighbour
// mask into the attention it stores; the context one thread per (atom,
// column) walking the neighbours in order (a wider list: fwd_atom_wide_keys,
// one atom's rows in sub-chunks with its energies [N, H] kept for
// wide_softmax of scann_mma.cuh and its keys kept for the context, which
// splits the neighbours into two halves over the block); the geometry
// LayerNorm four rows a warp with their shuffles interleaved; the staging in
// float4 (cp.async for the geometry). Every sum runs in a fixed order, so a
// launch repeats bit for bit.
//
// The bf16 operand mode (kBf16, model.dtype "bfloat16" in the whole-model
// forwards): every product through mma_gemm<true> (both operands rounded to
// bfloat16, one TF32 pass), and the operands the TPU kernels form as products
// but this code does not are rounded where they arise, as
// scann_tpu/kernels/scann_forward.py:_kernel and scann_loop.py:_fwd_kernel
// compute them: the gathered neighbour states (a one-hot product there), each
// q * k lane before the head sum of the energies (a product with the 0/1
// head map), the attention before the context sum (its expansion to lanes),
// the embedding row (a one-hot product) and the ring embedding's operands.
// The per-layer kernel runs with kBf16 off on tensors of element type T
// (float or bfloat16): it computes in f32 as the TPU kernel does with bf16
// inputs (scann_tpu/kernels/local_attention.py:139) and stores T.
//
// The chunk's buffers (fwd_chunk_floats):
//   sA [rows, 2D + 4]: columns [0, D) the geometry (SCANN+) or [0, K) the
//                      distance RBF (SCANN), columns [D, 2D) the neighbours'
//                      states, then their keys;
//   sU [rows, D + 4]:  u = cw + [geo | ns] @ Wfg[D:3D] + b, then the key input
//                      (ns * geo' or ns * filter);
//   sE [rows, H]:      the attention after its dropout, times the neighbour
//                      mask.

#pragma once

#include "philox.cuh"
#include "scann_mma.cuh"

namespace scann {

constexpr int kFwdMaxChunkRows = 64;   // N <= 64: one atom's neighbours fit a chunk
// the wide atom walk's sub-chunk in the 32-column layout (the wide builds
// past 128 columns): two operand buffers of it fit beside the rest at D =
// 256; past 256 columns (the *_d512 builds) 16, since two buffers of 32 rows
// take 263,168 bytes at D = 512
#ifdef SCANN_WIDTH_512
constexpr int kFwdWideW32Rows = 16;
#else
constexpr int kFwdWideW32Rows = 32;
#endif

// The sizes fwd_chunk reads: the whole-model forwards take them from their
// ForwardArgs (forward_chunk_dims), the per-layer kernel fills them itself.
struct ChunkDims {
  int N, D, H, K, g_update, attn_dropout;
  float dk;   // hd ** -scale
};

__device__ __forceinline__ ChunkDims forward_chunk_dims(const ForwardArgs& a) {
  return ChunkDims{a.N, a.D, a.H, a.K, a.g_update, a.attn_dropout, a.dk};
}

__host__ __device__ inline int fwd_chunk_floats(int rows, int D, int H) {
  return rows * (2 * D + 4) + rows * (D + 4) + round4(rows * H);
}

// warp_layer_norm (scann_common.cuh) of R rows at once, the same arithmetic
// on each, their shuffles interleaved; g and bt are the lane's values of
// gamma and beta (columns lane + 32 i), V of each (kLaneValues).
template <int R, int V>
__device__ __forceinline__ void warp_layer_norm_rows(float (&v)[R][V], int D, const float (&g)[V],
                                                     const float (&bt)[V], int lane) {
  float s[R], q[R], mean[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    s[j] = 0.f;
    q[j] = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (lane + 32 * i < D) s[j] += v[j][i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < R; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    mean[j] = s[j] / (float)D;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (lane + 32 * i < D) {
        const float t = v[j][i] - mean[j];
        q[j] += t * t;
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < R; ++j) q[j] += __shfl_xor_sync(0xffffffffu, q[j], o);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float inv = rsqrtf(q[j] / (float)D + 1e-6f);
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (lane + 32 * i < D) v[j][i] = (v[j][i] - mean[j]) * inv * g[i] + bt[i];
  }
}

// Stages rows [base, base + rows) of the structure for fwd_chunk: the SCANN+
// geometry from its global scratch geo_b [M * N, D] (written earlier by this
// block; all of a thread's copies in flight at once, past L1) or the distance
// RBF (pad columns up to a multiple of 4 zeroed), and the neighbours' states
// gathered as float4 from the centers cen [M, ldc] in shared memory, eight
// loads a thread before their stores (rounded to bfloat16 with kBf16). Ends
// with a barrier.
template <bool kBf16>
__device__ __forceinline__ void fwd_stage_chunk(const ForwardArgs& a, float* sA, const float* cen,
                                                int ldc, const int* nbr, const float* ndist,
                                                const float* geo_b, int base, int rows) {
  const int tid = threadIdx.x, D = a.D, K = a.K, lda = 2 * D + 4, q4 = D / 4;
  const int total = rows * q4;
  if (a.g_update) {
    for (int i = tid; i < total; i += kThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      cp_async16(sA + r * lda + c, geo_b + (size_t)(base + r) * D + c);
    }
  } else {
    const int k4 = round4(K);
    for (int i = tid; i < rows * k4; i += kThreads) {
      const int r = i / k4, k = i - r * k4;
      float v = 0.f;
      if (k < K) {
        const float t = ndist[base + r] - a.dist_centers[k];
        v = expf(-(t * t) / a.rbf_width);
      }
      sA[r * lda + k] = v;
    }
  }
  for (int i0 = tid; i0 < total; i0 += 8 * kThreads) {
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * kThreads, r = i / q4, c = (i - r * q4) * 4;
      if (i < total) {
        v[j] = *reinterpret_cast<const float4*>(cen + (size_t)nbr[base + r] * ldc + c);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * kThreads, r = i / q4, c = (i - r * q4) * 4;
      if (i < total) store4(sA + r * lda + D + c, operand4<kBf16>(v[j]));
    }
  }
  if (a.g_update) cp_async_wait_all();
  __syncthreads();
}

// The shared-memory barriers (mbarrier) that the copy engine signals: init
// with one arrival a phase; wait until the phase of the given parity has
// completed.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// orders this thread's earlier accesses to shared memory before the copy
// engine's later writes there
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// orders this thread's earlier writes to global memory before the copy
// engine's later reads there (a barrier between them carries the order to
// the thread that issues the copies)
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// before the memory of an mbarrier is used for anything else
__device__ __forceinline__ void mbar_inval(unsigned long long* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// fwd_stage_chunk for the tall and wide builds, by the copy engine, in two
// halves, so that the tall build stages a chunk while the one before it
// runs. fwd_stage_chunk_bulk issues one bulk copy (cp.async.bulk, through
// L2) a row for rows [base, base + rows): the neighbour's state gathered
// from the global centers cen [M, D] (its index from idx, a ring in shared
// memory the caller filled ahead), and the SCANN+ geometry from geo_b [M *
// N, D] or the SCANN distance RBF from the launch's table rbf [M * N,
// round4(K)]; bar counts their bytes (thread 0 sets them). The thread that
// issues a copy spends no registers on it. fwd_stage_chunk_wait waits for
// the phase of parity `parity` of bar and, where `ring`, for the thread's
// cp.async copies (the ring), rounds the neighbour states to bfloat16 (kBf16, as
// fwd_stage_chunk rounds them before its stores), fences this thread's
// accesses to shared memory before the next bulk copies and ends with a
// barrier. The staged values are fwd_stage_chunk's bit for bit. The caller
// fences (fence_proxy_async) every thread's earlier accesses to sA before
// the barrier that precedes the bulk copies.
__device__ __forceinline__ void fwd_stage_chunk_bulk(const ForwardArgs& a, float* sA,
                                                     const float* cen, const int* idx,
                                                     const float* geo_b, const float* rbf,
                                                     int base, int rows, unsigned long long* bar) {
  const int tid = threadIdx.x, D = a.D, lda = 2 * D + 4, k4 = round4(a.K);
  const unsigned own = (a.g_update ? D : k4) * 4;   // bytes of a row's own columns
  if (tid == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"((unsigned)rows * (D * 4 + own))
                 : "memory");
  for (int t = tid; t < 2 * rows; t += kThreads) {
    const int r = t < rows ? t : t - rows;
    const float* src = t < rows      ? cen + (size_t)idx[r] * D
                       : a.g_update ? geo_b + (size_t)(base + r) * D
                                    : rbf + (size_t)(base + r) * k4;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(sA + r * lda + (t < rows ? D : 0))),
        "l"(src), "r"(t < rows ? (unsigned)D * 4 : own), "r"(smem_addr(bar))
        : "memory");
  }
}

template <bool kBf16>
__device__ __forceinline__ void fwd_stage_chunk_wait(const ForwardArgs& a, float* sA, int rows,
                                                     unsigned long long* bar, unsigned parity,
                                                     bool ring = true) {
  mbar_wait(bar, parity);
  if (ring) cp_async_wait_all();
  if constexpr (kBf16) {
    const int tid = threadIdx.x, D = a.D, lda = 2 * D + 4, q4 = D / 4;
    for (int i = tid; i < rows * q4; i += kThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      float4* p = reinterpret_cast<float4*>(sA + r * lda + D + c);
      *p = operand4<true>(*p);
    }
  }
  fence_proxy_async();
  __syncthreads();
}

// The packed TF32 planes (tf32_planes of the wrappers, w32_plane_floats
// each) of one layer's products for the 32-column layout: cw = centers @
// Wfg[0:D] (SCANN+), the geometry or filter product's Wfg[D:3D] (SCANN+) or
// Wfg (SCANN), Wk and Wq, one after the other in that order.
struct RowPlanes {
  const float* cw;
  const float* fg;
  const float* k;
  const float* q;
};

// The planes of a layer whose packed planes start at p.
__device__ __forceinline__ RowPlanes row_planes(const float* p, int D, int K, int g_update) {
  RowPlanes r;
  r.cw = p;
  r.fg = g_update ? p + w32_plane_floats(D, D) : p;
  r.k = r.fg + w32_plane_floats(g_update ? 2 * D : K, D);
  r.q = r.k + w32_plane_floats(D, D);
  return r;
}

// The floats of one layer's packed planes (LocalAttention's four blocks).
__host__ __device__ inline size_t layer_plane_floats(int D, int K, int g_update) {
  return (g_update ? w32_plane_floats(D, D) + w32_plane_floats(2 * D, D)
                   : w32_plane_floats(K, D)) + 2 * w32_plane_floats(D, D);
}

// A row product in mma_gemm's layout (kW32 false: on W) or the 32-column
// one (on W's packed planes).
template <bool kW32, bool kBf16, typename T, typename Epi>
__device__ __forceinline__ void row_gemm(const float* A, int lda, int rows, int K, const T* W,
                                         const float* planes, int ldw, int nc, Epi epi) {
  if constexpr (kW32) {
    mma_gemm_w32<kBf16>(A, lda, rows, K, planes, nc, epi);
  } else {
    mma_gemm<kBf16>(A, lda, rows, K, W, ldw, nc, epi);
  }
}

// The row part of fwd_chunk (the same code, which fwd_chunk keeps inline)
// for a sub-chunk of `rows` staged rows of one atom's wide neighbour list:
// the SCANN+ geometry update (geo_out, or null, takes LN_g's output) or the
// SCANN filter, the key input in sU and the keys in the neighbour half of
// sA. sCW [atoms, ldq] holds the center terms, row r belonging to atom r /
// a.N, which is 0 for every row of a sub-chunk (rows < a.N). nweight and
// geo_out point at the first row. kW32: the products in the 32-column
// layout on the layer's packed planes pl (the wide builds past 128
// columns), else on W. Ends with a barrier.
template <bool kBf16 = false, bool kW32 = false, typename T>
__device__ __forceinline__ void fwd_chunk_rows(const ChunkDims& a, const LayerWeightsT<T>& w,
                                               int rows, float* sA, float* sU, const float* sCW,
                                               int ldq, const T* nweight, T* geo_out,
                                               const RowPlanes& pl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = a.N, D = a.D, lda = 2 * D + 4, ldu = D + 4;
  if (a.g_update) {
    // u = cw + [geo | ns] @ Wfg[D:3D] + b; geo' = LN_g(swish(u) + geo); kin = ns * geo'
    row_gemm<kW32, kBf16>(sA, lda, rows, 2 * D, w.wfg + (size_t)D * D, pl.fg, D, D,
                          [&](int r, int c, float4 v) {
      const float* cw = sCW + (r / N) * ldq + c;
      const T* b = w.bfg + c;
      store4(sU + r * ldu + c,
             make_float4(cw[0] + v.x + to_float(b[0]), cw[1] + v.y + to_float(b[1]),
                         cw[2] + v.z + to_float(b[2]), cw[3] + v.w + to_float(b[3])));
    });
    __syncthreads();
    float g[kLaneValues], bt[kLaneValues];
#pragma unroll
    for (int i = 0; i < kLaneValues; ++i) {
      const int d = lane + 32 * i;
      g[i] = d < D ? to_float(w.lng_s[d]) : 0.f;
      bt[i] = d < D ? to_float(w.lng_b[d]) : 0.f;
    }
    // four rows of the warp together: r0, r0 + kWarps, ...
    constexpr int kRows = 4;
    for (int r0 = warp; r0 < rows; r0 += kRows * kWarps) {
      float v[kRows][kLaneValues];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = r0 + j * kWarps;
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
          const int d = lane + 32 * i;
          v[j][i] = d < D && r < rows ? swishf(sU[r * ldu + d]) + sA[r * lda + d] : 0.f;
        }
      }
      warp_layer_norm_rows(v, D, g, bt, lane);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = r0 + j * kWarps;
        if (r >= rows) continue;
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            if (geo_out) geo_out[(size_t)r * D + d] = from_float<T>(v[j][i]);
            sU[r * ldu + d] = sA[r * lda + D + d] * v[j][i];
          }
        }
      }
    }
  } else {
    // kin = ns * (swish(rbf(d) @ Wfg + b) * weight)
    row_gemm<kW32, kBf16>(sA, lda, rows, a.K, w.wfg, pl.fg, D, D,
                          [&](int r, int c, float4 v) {
      const float* ns = sA + r * lda + D + c;
      const T* b = w.bfg + c;
      const float wt = to_float(nweight[r]);
      store4(sU + r * ldu + c,
             make_float4(ns[0] * (swishf(v.x + to_float(b[0])) * wt),
                         ns[1] * (swishf(v.y + to_float(b[1])) * wt),
                         ns[2] * (swishf(v.z + to_float(b[2])) * wt),
                         ns[3] * (swishf(v.w + to_float(b[3])) * wt)));
    });
  }
  __syncthreads();
  // key = kin @ Wk + bk, into the neighbour half of sA
  row_gemm<kW32, kBf16>(sU, ldu, rows, D, w.wk, pl.k, D, D,
                        [&](int r, int c, float4 v) {
    const T* b = w.bk + c;
    store4(sA + r * lda + D + c, make_float4(v.x + to_float(b[0]), v.y + to_float(b[1]),
                                             v.z + to_float(b[2]), v.w + to_float(b[3])));
  });
  __syncthreads();
}

// out = LN(ctx + query) of ca atoms whose rows of sQ [ca, ldq] hold ctx +
// query, one warp per atom (fwd_chunk's tail, for fwd_atom_wide_keys). Ends with a
// barrier.
template <typename T>
__device__ __forceinline__ void fwd_out_norm(const LayerWeightsT<T>& w, int ca, float* sQ,
                                             int ldq, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int at = warp; at < ca; at += kWarps) {
    float* row = sQ + at * ldq;
    float v[kLaneValues];
#pragma unroll
    for (int i = 0; i < kLaneValues; ++i) v[i] = lane + 32 * i < D ? row[lane + 32 * i] : 0.f;
    warp_layer_norm(v, D, w.ln_s, w.ln_b, lane);
#pragma unroll
    for (int i = 0; i < kLaneValues; ++i)
      if (lane + 32 * i < D) row[lane + 32 * i] = v[i];
  }
  __syncthreads();
}

// LocalAttention of one staged chunk of ca atoms x N neighbours (rows = ca * N
// <= 64), called by the whole block. sCW [ca, ldq] holds centers @ Wfg[0:D]
// of the chunk's atoms (SCANN+), sQ [ca, ldq] their queries; nmask and
// nweight point at the chunk's first row. Leaves LayerNorm(context + query)
// in sQ; geo_out [rows, D] (or null: the last layer) takes the updated
// geometry (SCANN+), attn_out [rows, H] (or null) the attention before the
// neighbour mask and the dropout; drop(atom, n, h) is the factor of the
// attention dropout. kBf16: the operand mode; T: the element type of the
// weights, masks and outputs. Ends with a barrier.
template <bool kW32, bool kBf16, typename T, typename Drop>
__device__ __forceinline__ void fwd_chunk_impl(const ChunkDims& a, const LayerWeightsT<T>& w,
                                               int ca, float* sA, float* sU, float* sE,
                                               const float* sCW, float* sQ, int ldq,
                                               const T* nmask, const T* nweight, T* geo_out,
                                               T* attn_out, Drop drop, const RowPlanes& pl) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, D = a.D, H = a.H, hd = D / H, lda = 2 * D + 4, ldu = D + 4;
  const int rows = ca * N;
  if (a.g_update) {
    // u = cw + [geo | ns] @ Wfg[D:3D] + b; geo' = LN_g(swish(u) + geo); kin = ns * geo'
    row_gemm<kW32, kBf16>(sA, lda, rows, 2 * D, w.wfg + (size_t)D * D, pl.fg, D, D,
                          [&](int r, int c, float4 v) {
      const float* cw = sCW + (r / N) * ldq + c;
      const T* b = w.bfg + c;
      store4(sU + r * ldu + c,
             make_float4(cw[0] + v.x + to_float(b[0]), cw[1] + v.y + to_float(b[1]),
                         cw[2] + v.z + to_float(b[2]), cw[3] + v.w + to_float(b[3])));
    });
    __syncthreads();
    float g[kLaneValues], bt[kLaneValues];
#pragma unroll
    for (int i = 0; i < kLaneValues; ++i) {
      const int d = lane + 32 * i;
      g[i] = d < D ? to_float(w.lng_s[d]) : 0.f;
      bt[i] = d < D ? to_float(w.lng_b[d]) : 0.f;
    }
    // four rows of the warp together: r0, r0 + kWarps, ...
    constexpr int kRows = 4;
    for (int r0 = warp; r0 < rows; r0 += kRows * kWarps) {
      float v[kRows][kLaneValues];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = r0 + j * kWarps;
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
          const int d = lane + 32 * i;
          v[j][i] = d < D && r < rows ? swishf(sU[r * ldu + d]) + sA[r * lda + d] : 0.f;
        }
      }
      warp_layer_norm_rows(v, D, g, bt, lane);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = r0 + j * kWarps;
        if (r >= rows) continue;
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            if (geo_out) geo_out[(size_t)r * D + d] = from_float<T>(v[j][i]);
            sU[r * ldu + d] = sA[r * lda + D + d] * v[j][i];
          }
        }
      }
    }
  } else {
    // kin = ns * (swish(rbf(d) @ Wfg + b) * weight)
    row_gemm<kW32, kBf16>(sA, lda, rows, a.K, w.wfg, pl.fg, D, D,
                          [&](int r, int c, float4 v) {
      const float* ns = sA + r * lda + D + c;
      const T* b = w.bfg + c;
      const float wt = to_float(nweight[r]);
      store4(sU + r * ldu + c,
             make_float4(ns[0] * (swishf(v.x + to_float(b[0])) * wt),
                         ns[1] * (swishf(v.y + to_float(b[1])) * wt),
                         ns[2] * (swishf(v.z + to_float(b[2])) * wt),
                         ns[3] * (swishf(v.w + to_float(b[3])) * wt)));
    });
  }
  __syncthreads();
  // key = kin @ Wk + bk, into the neighbour half of sA
  row_gemm<kW32, kBf16>(sU, ldu, rows, D, w.wk, pl.k, D, D,
                        [&](int r, int c, float4 v) {
    const T* b = w.bk + c;
    store4(sA + r * lda + D + c, make_float4(v.x + to_float(b[0]), v.y + to_float(b[1]),
                                             v.z + to_float(b[2]), v.w + to_float(b[3])));
  });
  __syncthreads();
  // energies (query * dk) . key - 1e9 (1 - nmask) and the max-shifted softmax
  // over the neighbours, one warp per (atom, head); stores attn * nmask. The
  // bf16 mode rounds each lane's product before the head sum and the
  // attention before the context.
  for (int i = warp; i < ca * H; i += kWarps) {
    const int at = i / H, h = i - at * H;
    const float* q = sQ + at * ldq + h * hd;
    float e[2], nm[2], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = lane + 32 * j;
      e[j] = -INFINITY;
      nm[j] = 0.f;
      if (n < N) {
        const int r = at * N + n;
        nm[j] = to_float(nmask[r]);
        const float* kk = sA + r * lda + D + h * hd;
        float s = 0.f;
        if (kBf16) {
          for (int t = 0; t < hd; ++t) s += bf16r((q[t] * a.dk) * kk[t]);
        } else if ((hd & 3) == 0) {
          for (int t = 0; t < hd; t += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(q + t);
            const float4 kv = *reinterpret_cast<const float4*>(kk + t);
            s = fmaf(qv.x * a.dk, kv.x, s);
            s = fmaf(qv.y * a.dk, kv.y, s);
            s = fmaf(qv.z * a.dk, kv.z, s);
            s = fmaf(qv.w * a.dk, kv.w, s);
          }
        } else {
          for (int t = 0; t < hd; ++t) s = fmaf(q[t] * a.dk, kk[t], s);
        }
        e[j] = s + (1.0f - nm[j]) * -1e9f;
      }
      mx = fmaxf(mx, e[j]);
    }
    mx = warp_max(mx);
    float p[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) p[j] = lane + 32 * j < N ? expf(e[j] - mx) : 0.f;
    const float tot = warp_sum(p[0] + p[1]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = lane + 32 * j;
      if (n < N) {
        const float pr = p[j] / tot;
        if (attn_out) attn_out[(size_t)(at * N + n) * H + h] = from_float<T>(pr);
        sE[(at * N + n) * H + h] = operand<kBf16>(a.attn_dropout ? pr * drop(at, n, h) : pr) * nm[j];
      }
    }
  }
  __syncthreads();
  // context = sum_n (attn * nmask) * key, added to the query
  for (int i = tid; i < ca * D; i += kThreads) {
    const int at = i / D, d = i - at * D;
    const float* e = sE + at * N * H + d / hd;
    const float* kk = sA + at * N * lda + D + d;
    float s = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) s += e[n * H] * kk[n * lda];
    sQ[at * ldq + d] = s + sQ[at * ldq + d];
  }
  __syncthreads();
  // out = LN(ctx + query), one warp per atom
  for (int at = warp; at < ca; at += kWarps) {
    float* row = sQ + at * ldq;
    float v[kLaneValues];
#pragma unroll
    for (int i = 0; i < kLaneValues; ++i) v[i] = lane + 32 * i < D ? row[lane + 32 * i] : 0.f;
    warp_layer_norm(v, D, w.ln_s, w.ln_b, lane);
#pragma unroll
    for (int i = 0; i < kLaneValues; ++i)
      if (lane + 32 * i < D) row[lane + 32 * i] = v[i];
  }
  __syncthreads();
}

template <bool kBf16 = false, typename T, typename Drop>
__device__ __forceinline__ void fwd_chunk(const ChunkDims& a, const LayerWeightsT<T>& w, int ca,
                                          float* sA, float* sU, float* sE, const float* sCW,
                                          float* sQ, int ldq, const T* nmask, const T* nweight,
                                          T* geo_out, T* attn_out, Drop drop) {
  fwd_chunk_impl<false, kBf16>(a, w, ca, sA, sU, sE, sCW, sQ, ldq, nmask, nweight, geo_out,
                               attn_out, drop, RowPlanes{});
}

// fwd_chunk with its row products in the 32-column layout (mma_gemm_w32) on
// the layer's packed TF32 planes pl: #1, the tall #3 and the narrow #5 past
// 128 columns. The same outputs, bit for bit.
template <bool kBf16 = false, typename T, typename Drop>
__device__ __forceinline__ void fwd_chunk_w32(const ChunkDims& a, const LayerWeightsT<T>& w,
                                              int ca, float* sA, float* sU, float* sE,
                                              const float* sCW, float* sQ, int ldq,
                                              const T* nmask, const T* nweight, T* geo_out,
                                              T* attn_out, Drop drop, const RowPlanes& pl) {
  fwd_chunk_impl<true, kBf16>(a, w, ca, sA, sU, sE, sCW, sQ, ldq, nmask, nweight, geo_out,
                              attn_out, drop, pl);
}

// The wide form of fwd_chunk for one atom whose N neighbours (64 < N <=
// kWideMaxN; past 128 columns in #3, and past 256 columns in #5 too, fewer)
// exceed a chunk: the atom walk of the wide builds of #3
// (scann_loop_wide.cu) and #5 (local_attention_wide.cu). Its rows go through
// fwd_chunk_rows in sub-chunks of at most kFwdMaxChunkRows (kW32, the wide
// builds past 128 columns: kFwdWideW32Rows, their products in the 32-column
// layout on the layer's packed planes pl), stage(n0, rows)
// staging rows [n0, n0 + rows) of the atom and returning the operand buffer
// that holds them (after a barrier); each sub-chunk's energies go into the
// atom's energy row sE [N, H] and its keys to keys [N, ldk], in shared
// memory where the plan holds them (smem_keys) or in the block's global
// scratch past that (read back past L1). Then wide_softmax over all N, which
// stores attn_out (null in #3, which stores no attention) and folds the
// dropout and the neighbour mask into sE, and the context, which splits the N
// neighbours into two halves over the block's threads (thread t: column t %
// D of half t / D, D <= 128), each half summed in order, then first half +
// second half + query; past 128 columns (kLaneValues 8) one thread a column
// sums all N in order, then + query (past 256, kLaneValues 16, a thread
// sums columns t and t + 256 so). sU [D] passes the second half's sums
// (the sub-chunk's product buffer, free by then). sCW and sQ are the atom's rows; nmask,
// nweight, geo_out and attn_out point at the atom's first row; drop(n, h)
// takes the neighbour's index in the atom. kBf16: the operand mode; T: the
// element type of the weights, masks and outputs. Ends with a barrier.
template <bool kBf16, bool kW32 = false, typename T, typename Stage, typename Drop>
__device__ __forceinline__ void fwd_atom_wide_keys(const ChunkDims& a, const LayerWeightsT<T>& w,
                                                   Stage stage, float* sU, float* sE,
                                                   const float* sCW, float* sQ, const T* nmask,
                                                   const T* nweight, T* geo_out, T* attn_out,
                                                   float* keys, int ldk, bool smem_keys,
                                                   Drop drop, const RowPlanes& pl = RowPlanes{}) {
  constexpr int kSub = kW32 ? kFwdWideW32Rows : kFwdMaxChunkRows;
  const int tid = threadIdx.x, N = a.N, D = a.D, H = a.H, hd = D / H, lda = 2 * D + 4;
  const int q4 = D / 4;
  for (int n0 = 0; n0 < N; n0 += kSub) {
    const int rows = min(kSub, N - n0);
    float* sA = stage(n0, rows);
    fwd_chunk_rows<kBf16, kW32>(a, w, rows, sA, sU, sCW, 0, nweight + n0,
                                geo_out ? geo_out + (size_t)n0 * D : nullptr, pl);
    warp_energies<kBf16>(sQ, sA + D, lda, nmask + n0, sE + n0 * H, rows, H, hd, a.dk);
    for (int i = tid; i < rows * q4; i += kThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      store4(keys + (size_t)(n0 + r) * ldk + c,
             *reinterpret_cast<const float4*>(sA + r * lda + D + c));
    }
    __syncthreads();
  }
  wide_softmax(sE, N, H, [&](int n, int h, float pr) {
    if (attn_out) attn_out[(size_t)n * H + h] = from_float<T>(pr);
    sE[n * H + h] = operand<kBf16>(a.attn_dropout ? pr * drop(n, h) : pr) * to_float(nmask[n]);
  });
  __syncthreads();
  if constexpr (kLaneValues > 8) {
    // widths past 256 (the *_d512 builds): the same sum, columns tid and
    // tid + 256
    for (int d = tid; d < D; d += kThreads) {
      const float* e = sE + d / hd;
      float s = 0.f;
      if (smem_keys) {
#pragma unroll 4
        for (int n = 0; n < N; ++n) s += e[n * H] * keys[n * ldk + d];
      } else {
#pragma unroll 8
        for (int n = 0; n < N; ++n) s += e[n * H] * __ldcg(keys + (size_t)n * ldk + d);
      }
      sQ[d] = s + sQ[d];
    }
    __syncthreads();
  } else if constexpr (kLaneValues > 4) {
    // widths past 128 (the *_d256 builds): one thread a column, over all N
    // neighbours in order, then + query; keys in L2 eight loads in flight
    // (1.3% of the wide #3 at D = 256 over four, on an NVIDIA H100 80GB HBM3
    // at 700 W)
    if (tid < D) {
      const float* e = sE + tid / hd;
      float s = 0.f;
      if (smem_keys) {
#pragma unroll 4
        for (int n = 0; n < N; ++n) s += e[n * H] * keys[n * ldk + tid];
      } else {
#pragma unroll 8
        for (int n = 0; n < N; ++n) s += e[n * H] * __ldcg(keys + (size_t)n * ldk + tid);
      }
      sQ[tid] = s + sQ[tid];
    }
    __syncthreads();
  } else {
    const int d = tid % D, part = tid / D, half = (N + 1) / 2;
    float s = 0.f;
    if (part < 2) {
      const int n1 = part ? N : half;
      const float* e = sE + d / hd;
      if (smem_keys) {
#pragma unroll 4
        for (int n = part ? half : 0; n < n1; ++n) s += e[n * H] * keys[n * ldk + d];
      } else {
#pragma unroll 4
        for (int n = part ? half : 0; n < n1; ++n) s += e[n * H] * __ldcg(keys + (size_t)n * ldk + d);
      }
      if (part == 1) sU[d] = s;
    }
    __syncthreads();
    if (tid < D) sQ[d] = (s + sU[d]) + sQ[d];
    __syncthreads();
  }
  fwd_out_norm(w, 1, sQ, 0, D);
}

// SCANN+ geometry embedding of atoms [m_lo, m_hi) of one structure, chunk by
// chunk of CA atoms into its global scratch geo_b [M * N, D]:
//   geo = swish(rbf(d) @ Wnd + bnd) * swish(rbf(w) @ Wnw + bnw).
// sA and sU are the chunk buffers; kBf16 the operand mode. Ends with a barrier.
template <bool kBf16>
__device__ __forceinline__ void fwd_embed_geometry(const ForwardArgs& a, float* sA, float* sU,
                                                   const float* ndist, const float* nweight,
                                                   float* geo_b, int m_lo, int m_hi) {
  const int tid = threadIdx.x, N = a.N, D = a.D, K = a.K, lda = 2 * D + 4, ldu = D + 4;
  const int k4 = round4(K);
  for (int m0 = m_lo; m0 < m_hi; m0 += a.chunk_atoms) {
    const int rows = min(a.chunk_atoms, m_hi - m0) * N, base = m0 * N;
    // [rbf(d) | rbf(w)] at columns 0 and D, pad columns zeroed
    for (int i = tid; i < rows * k4; i += kThreads) {
      const int r = i / k4, k = i - r * k4;
      float vd = 0.f, vw = 0.f;
      if (k < K) {
        const float t = ndist[base + r] - a.dist_centers[k];
        const float u = nweight[base + r] - a.angle_centers[k];
        vd = expf(-(t * t) / a.rbf_width);
        vw = expf(-(u * u) / a.rbf_width);
      }
      sA[r * lda + k] = vd;
      sA[r * lda + D + k] = vw;
    }
    __syncthreads();
    mma_gemm<kBf16>(sA, lda, rows, K, a.wnd, D, D, [&](int r, int c, float4 v) {
      store4(sU + r * ldu + c, make_float4(swishf(v.x + a.bnd[c]), swishf(v.y + a.bnd[c + 1]),
                                           swishf(v.z + a.bnd[c + 2]), swishf(v.w + a.bnd[c + 3])));
    });
    __syncthreads();
    mma_gemm<kBf16>(sA + D, lda, rows, K, a.wnw, D, D, [&](int r, int c, float4 v) {
      const float* de = sU + r * ldu + c;
      store4(geo_b + (size_t)(base + r) * D + c,
             make_float4(de[0] * swishf(v.x + a.bnw[c]), de[1] * swishf(v.y + a.bnw[c + 1]),
                         de[2] * swishf(v.z + a.bnw[c + 2]), de[3] * swishf(v.w + a.bnw[c + 3])));
    });
    __syncthreads();
  }
}

// The embedding operand of atoms [ab0, ab0 + ab) of structure b: sEmb [ab,
// lde] = [lookup or cgcnn dense | ring embedding | zeros up to lde]; sFeat
// [ab, ldf] stages the cgcnn features. The caller multiplies by Wde. kBf16:
// the operand mode (the looked-up row and the ring embedding's operands
// rounded). Ends with a barrier.
template <bool kBf16>
__device__ __forceinline__ void fwd_stage_embedding(const ForwardArgs& a, int b, int ab0, int ab,
                                                    float* sEmb, int lde, float* sFeat, int ldf) {
  const int tid = threadIdx.x, M = a.M, E = a.E, ke = E + (a.use_ring ? 10 : 0);
  if (a.cgcnn) {
    const int F = a.F;
    for (int i = tid; i < ab * ldf; i += kThreads) {
      const int m = i / ldf, f = i - m * ldf;
      sFeat[i] = f < F ? a.feat[((size_t)b * M + ab0 + m) * F + f] : 0.f;
    }
    __syncthreads();
    mma_gemm<kBf16>(sFeat, ldf, ab, F, a.embed, E, E, [&](int r, int c, float4 v) {
      store4(sEmb + r * lde + c, make_float4(v.x + a.bembed[c], v.y + a.bembed[c + 1],
                                             v.z + a.bembed[c + 2], v.w + a.bembed[c + 3]));
    });
  } else {
    for (int i = tid; i < ab * E; i += kThreads) {
      const int m = i / E, e = i - m * E;
      sEmb[m * lde + e] = operand<kBf16>(a.embed[(size_t)a.atomic[(size_t)b * M + ab0 + m] * E + e]);
    }
  }
  if (a.use_ring) {
    for (int i = tid; i < ab * 10; i += kThreads) {
      const int m = i / 10, j = i - m * 10;
      const float* ra = a.ring + ((size_t)b * M + ab0 + m) * 2;
      sEmb[m * lde + E + j] = operand<kBf16>(ra[0]) * operand<kBf16>(a.wring[j]) +
                              operand<kBf16>(ra[1]) * operand<kBf16>(a.wring[10 + j]) + a.bring[j];
    }
  }
  for (int i = tid; i < ab * (lde - ke); i += kThreads) {   // keep the pad columns finite
    const int m = i / (lde - ke), j = i - m * (lde - ke);
    sEmb[m * lde + ke + j] = 0.f;
  }
  __syncthreads();
}

// ResidualNorm of layer l for ab atoms whose attention outputs are sO [ab,
// ld]: next = LN(out + mask * (swish(out @ W1 + b1) @ W2 + b2)). sH1 and sH2
// [ab, ld] are scratch (sH2 may be the centers the block no longer needs);
// mask(c-quad) is the residual dropout of row r, and out(r, v) takes each
// finished row as a warp's kLaneValues values per lane (v[i] at column lane +
// 32 i).
// kBf16: the operand mode; kW32: the two products in the 32-column layout
// on the packed TF32 planes p1 and p2 of W1 and W2.
template <bool kBf16, bool kW32 = false, typename Mask, typename Out>
__device__ __forceinline__ void fwd_residual_norm(const ForwardArgs& a, int l, int ab,
                                                  const float* sO, float* sH1, float* sH2, int ld,
                                                  Mask mask, Out out, const float* p1 = nullptr,
                                                  const float* p2 = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, D = a.D;
  const float* br1 = a.br1 + (size_t)l * D;
  const float* br2 = a.br2 + (size_t)l * D;
  row_gemm<kW32, kBf16>(sO, ld, ab, D, a.wr1 + (size_t)l * D * D, p1, D, D,
                        [&](int r, int c, float4 v) {
    store4(sH1 + r * ld + c, make_float4(swishf(v.x + br1[c]), swishf(v.y + br1[c + 1]),
                                         swishf(v.z + br1[c + 2]), swishf(v.w + br1[c + 3])));
  });
  __syncthreads();
  row_gemm<kW32, kBf16>(sH1, ld, ab, D, a.wr2 + (size_t)l * D * D, p2, D, D,
                        [&](int r, int c, float4 v) {
    const float4 m = mask(r, c);
    store4(sH2 + r * ld + c, make_float4((v.x + br2[c]) * m.x, (v.y + br2[c + 1]) * m.y,
                                         (v.z + br2[c + 2]) * m.z, (v.w + br2[c + 3]) * m.w));
  });
  __syncthreads();
  for (int m = warp; m < ab; m += kWarps) {
    float v[kLaneValues];
#pragma unroll
    for (int i = 0; i < kLaneValues; ++i) {
      const int d = lane + 32 * i;
      v[i] = d < D ? sO[m * ld + d] + sH2[m * ld + d] : 0.f;
    }
    warp_layer_norm(v, D, a.rln_s + (size_t)l * D, a.rln_b + (size_t)l * D, lane);
    out(m, v);
  }
  __syncthreads();
}

}  // namespace scann
