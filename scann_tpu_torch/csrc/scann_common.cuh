// Building blocks shared by the port's kernels: blocks of kThreads threads,
// FP32 FMA products with the left operand in shared memory (the readouts'
// small products), warp-per-row LayerNorm, the argument block of the
// whole-model forwards and the parameters of one LocalAttention layer.

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
  // sizes and switches
  int B, M, N, D, H, E, K, G, O, L, F;
  int cgcnn, use_ring, g_update, ga_norm, mrelu;
  int chunk_atoms;      // atoms per geometry chunk (chunk rows = CA * N <= 64)
  int abuf_floats;      // floats of the chunk operand buffer
  int atom_block;       // atoms per per-atom product (scann_loop.cu only)
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
  a.dk = scalars[0];
  a.rbf_width = scalars[1];
  a.drop_scale = scalars[2];
  a.attn_scale = scalars[3];
  a.seed = rng[0]; a.mol_base = rng[1]; a.drop_threshold = rng[2]; a.attn_threshold = rng[3];
}

// The parameters of one LocalAttention layer.
struct LayerWeights {
  const float* wfg;     // [3D, D] (SCANN+) or [K, D] (SCANN)
  const float* bfg;
  const float* wk;      // [D, D]
  const float* bk;
  const float* ln_s;
  const float* ln_b;
  const float* lng_s;   // geometry LayerNorm (SCANN+)
  const float* lng_b;
};

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
