// Whole-model SCANN / SCANN+ forward for molecules, one CUDA block per
// molecule.
//
// Replaces the TPU kernel scann_tpu/kernels/scann_forward.py:_kernel (the
// Pallas whole-model forward):
// embedding (atomic-number lookup or cgcnn dense, optional ring concat),
// Gaussian RBF geometry (+ the SCANN+ geometry embedding), L x
// (LocalAttention + ResidualNorm), after_Lc, the GA readout and the
// property head (optional mrelu). Outputs pred [B] and ga [B, M], f32. For
// a packed batch (structure packing: S > 0 segments per slot, each row's
// segment in seg [B, M], -1 on padding) the readout runs per segment
// (seg_scores of scann_common.cuh, scann_forward.py:358-412) and pred is
// [B, S].
// With dropout on (training through scann_apply) it applies the embedding
// and residual masks and, under use_drop, the attention mask, drawn in
// place by the Philox of philox.cuh, so the backward kernel replays them;
// with dropout off it computes exactly what it computed without them.
//
// Bound. At the QM9 serving shape (B=128, M=32, N=16, L=7, D=128) the work
// is ~5.0e10 FLOP against a few MB of inputs and weights, so the kernel is
// bound by operations. The products run on the tensor cores in three TF32
// passes to keep f32 accuracy (scann_mma.cuh): ~0.31 ms at the H100 SXM's
// dense 495 TFLOP/s TF32, with the energies and context (1.2% of the FLOP,
// on the CUDA cores) at 67 TFLOP/s FP32.
//
// Design.
// - One block of 256 threads per molecule; the block loops over the layers
//   with __syncthreads() between phases. Layer l+1 gathers neighbour states
//   written by layer l of the same molecule, so no block waits on another,
//   and a QM9 batch of 128 fills 128 of the card's 132 SMs.
// - Per-atom state (centers, query, a scratch [M, D]) lives in shared
//   memory at a row stride of D + 4 floats; neighbour states are an index
//   gather from the centers there (the TPU kernel's one-hot matmul gather is
//   gone), and the atomic-number embedding is a row lookup.
// - The [M, N, D] SCANN+ geometry does not fit in shared memory at large
//   M, so it lives in a global scratch buffer (B*M*N*D floats, allocated by
//   the caller; 33.5 MB at the QM9 shape) and is streamed through shared
//   memory in chunks of CA atoms (CA*N <= 64 rows), each chunk's rows through
//   fwd_chunk of scann_forward_common.cuh: split-TF32 mma.sync products, one
//   warp per (atom, head) for the softmax, one thread per (atom, column) for
//   the context.
//
// Widths past 128 (D, G, O up to 256): scann_forward_d256.cu builds the
// kernel with SCANN_WIDTH_256, 8 values of a row a lane in the warp
// LayerNorms (kLaneValues of scann_common.cuh); the wrapper's plan halves
// the chunks to 32 rows (QM9 at D = 256) or 16 where 64 do not fit. That
// build (kW32) runs each layer's products, the chunk's row products
// (fwd_chunk_w32), cw, the query and the ResidualNorm's two, in the
// 32-column layout (mma_gemm_w32 of scann_mma.cuh: a warp owns 32 output
// columns, so each left-operand value is split once), on the packed TF32
// planes of the layers' Wfg, Wk, Wq, W1 and W2 that the wrapper makes
// (tf32_planes, launch pointer 50): those products are bound by instruction
// issue at 256 columns, and the layout spends fewer instructions on each
// tensor-core step, with mma_gemm's fragments and order of sums, so the
// outputs are the ones mma_gemm gives, bit for bit. It also spreads a
// molecule's atoms over a cluster of C blocks (up to kMaxForwardCluster,
// whole chunks a block; the wrapper takes the most whose B clusters the
// card runs at once), since one block a molecule leaves all but B of the
// 132 SMs idle: a lone molecule took nearly the time of a batch of 128.
// Each block keeps every atom's centers and writes its own atoms' new ones
// into every block of the cluster (distributed shared memory) between two
// cluster barriers a layer; rank 0 reads out. Only that build's kernel
// takes the planes and C, so the build of widths up to 128 is the one it
// was.
//
// Widths past 256 (D, G, O up to 512): scann_forward_d512.cu builds that
// kernel with SCANN_WIDTH_512 beside SCANN_WIDTH_256, 16 values of a row a
// lane, chunks of 16 rows (the plan's; 32 do not fit at D = 512). Three
// resident [M, max(D, G) + 4] arrays take 198,144 bytes at M = 32 and D =
// 512, more than the chunk leaves, so that build keeps the centers alone in
// shared memory, where every gather reads them (and the cluster shares
// them), and the query / attention output and the cw / ResidualNorm hidden
// rows of each molecule in global memory (L2), rows [B, 2, M, ldm] of
// launch pointer 51 (kL2Rows). A block reads and writes only its own atoms'
// rows there until rank 0's readout, which writes every row it reads, so
// no block reads another's, and a barrier of the block orders them. QM9 (M
// <= 32, N = 16) at D = 512 takes 171,680 bytes a block.
//
// bf16 operand mode (model.dtype "bfloat16"): a second instantiation of the
// kernel, kBf16, rounds the operands of every product to bfloat16 and sums in
// f32, where and as the TPU kernel's dots do (scann_forward_common.cuh);
// params, inputs, LayerNorm, softmax and swish stay f32. The packed readout's
// segment pools stay exact sums (the TPU kernel's mm_hi, l.375-379); its head
// products take the mode.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// given stream, synchronises nothing, allocates nothing, and returns the
// cudaGetLastError() code of the launch (or kErrSharedMemory / kErrShape).

#include <cooperative_groups.h>

#include "scann_forward_common.cuh"

namespace {

using namespace scann;
namespace cg = cooperative_groups;

using Args = ForwardArgs;   // scann_common.cuh

#ifdef SCANN_WIDTH_256
constexpr bool kW32 = true;
#define SCANN_FORWARD_TAKES_PLANES
#define SCANN_FORWARD_CLUSTER_TPARAM , bool kCluster
#ifdef SCANN_WIDTH_512
#define SCANN_FORWARD_D256_PARAMS , const float* planes, const int C, float* l2rows
#define SCANN_FORWARD_L2_ARG , l2rows
#else
#define SCANN_FORWARD_D256_PARAMS , const float* planes, const int C
#define SCANN_FORWARD_L2_ARG
#endif
#else
constexpr bool kW32 = false;
constexpr bool kCluster = false;
#define SCANN_FORWARD_CLUSTER_TPARAM
#define SCANN_FORWARD_D256_PARAMS
#endif
// the largest cluster of the build past 128 columns (blocks a molecule; past
// 8 a non-portable size the launcher opts into)
constexpr int kMaxForwardCluster = 16;

// the query and scratch rows in global memory (the build past 256 columns)
constexpr bool kL2Rows = kLaneValues > 8;

// Shared-memory plan, in floats: centers, query, scratch [M, ldm] each
// (ldm = max(D, G) + 4; kL2Rows: the centers alone, offQ and offW unused);
// the work region (a chunk's buffers, or the embedding's staging [M, lde +
// ldf]); readout vectors (per segment for a packed batch).
struct Plan {
  int ldm, rows, lde, ldf, work, offQ, offW, offWork, offMisc, total;
};

__host__ __device__ inline Plan make_plan(const Args& a) {
  Plan p;
  p.ldm = (a.D > a.G ? a.D : a.G) + 4;
  p.rows = a.chunk_atoms * a.N;
  p.lde = round4(a.E + (a.use_ring ? 10 : 0));
  p.ldf = a.cgcnn ? round4(a.F) : 0;
  const int chunk = fwd_chunk_floats(p.rows, a.D, a.H);
  const int embed = a.M * (p.lde + p.ldf);
  p.work = chunk > embed ? chunk : embed;
  p.offQ = a.M * p.ldm;
  p.offW = 2 * a.M * p.ldm;
  p.offWork = (kL2Rows ? 1 : 3) * a.M * p.ldm;
  p.offMisc = p.offWork + p.work;
  p.total = p.offMisc + 2 * p.ldm + round4(a.M) + round4(a.O);
  if (a.S) p.total = p.offMisc + seg_forward_floats(a.S, p.ldm, a.M, a.O);
  return p;
}

// one block per SM (its shared memory takes most of the SM), so the
// compiler may spend up to 255 registers a thread. The kW32 build also
// takes planes, the packed TF32 planes of each layer's products
// (row_planes' four blocks, then the ResidualNorm's W1 and W2), and C, the
// blocks of a molecule: kCluster, a cluster of C > 1, else one block (the
// code of one block a molecule, without the cluster's).
template <bool kBf16 SCANN_FORWARD_CLUSTER_TPARAM>
__global__ void __launch_bounds__(kThreads, 1)
scann_forward_kernel(const Args a SCANN_FORWARD_D256_PARAMS) {
#ifdef SCANN_FORWARD_TAKES_PLANES
  const int b = blockIdx.x / C;
#else
  const float* const planes = nullptr;   // read under kW32 only
  constexpr int C = 1;
#endif
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan P = make_plan(a);
#ifndef SCANN_FORWARD_TAKES_PLANES
  const int b = blockIdx.x;
#endif
  const int M = a.M, N = a.N, D = a.D, H = a.H, G = a.G, O = a.O;
  const int ldm = P.ldm, CA = a.chunk_atoms, lda = 2 * D + 4, ldu = D + 4;
  const unsigned int mol = a.mol_base + (unsigned int)b;
  // the [M, D] embedding and residual masks: quad (r, c..c+3) is one Philox
  // output, since D and c are multiples of 4
  auto mask4 = [&](int stream, int r, int c) {
    if (!a.dropout) return make_float4(1.f, 1.f, 1.f, 1.f);
    return scann_philox::mask_quad(a.seed, mol, stream, (unsigned)(r * D + c) >> 2,
                                   a.drop_threshold, a.drop_scale);
  };
  float* sC = smem;               // centers        [M, ldm]
#ifdef SCANN_WIDTH_512
  float* sQ = l2rows + (size_t)b * 2 * M * ldm;   // query / out [M, ldm], in L2
  float* sW = sQ + (size_t)M * ldm;               // cw, then the hidden [M, ldm], in L2
#else
  float* sQ = smem + P.offQ;      // query / out    [M, ldm]
  float* sW = smem + P.offW;      // cw, then the ResidualNorm hidden [M, ldm]
#endif
  float* work = smem + P.offWork;
  float* sA = work;                        // chunk operand [rows, 2D + 4]
  float* sU = sA + P.rows * lda;           // chunk product [rows, D + 4]
  float* sE = sU + P.rows * ldu;           // attention     [rows, H]
  float* sMisc = smem + P.offMisc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float* am = a.atom_mask + (size_t)b * M;
  const int* nbr = a.nbr + (size_t)b * M * N;
  const float* nmask = a.nmask + (size_t)b * M * N;
  const float* nweight = a.nweight + (size_t)b * M * N;
  const float* ndist = a.ndist + (size_t)b * M * N;
  float* geo_b = a.geo + (size_t)b * M * N * D;

  // ---- atom embedding -> centers = swish(emb @ Wde + bde) ----------------
  const int ke = a.E + (a.use_ring ? 10 : 0);
  fwd_stage_embedding<kBf16>(a, b, 0, M, work, P.lde, work + M * P.lde, P.ldf);
  mma_gemm<kBf16>(work, P.lde, M, ke, a.wde, D, D, [&](int r, int c, float4 v) {
    const float4 m = mask4(0, r, c);
    store4(sC + r * ldm + c,
           make_float4(swishf(v.x + a.bde[c]) * m.x, swishf(v.y + a.bde[c + 1]) * m.y,
                       swishf(v.z + a.bde[c + 2]) * m.z, swishf(v.w + a.bde[c + 3]) * m.w));
  });
  __syncthreads();

  if constexpr (kW32) {
    // ---- past 128 columns: the molecule's atoms over a cluster of C blocks
    // Block `rank` takes the atoms [m_lo, m_hi) of its share of the chunks
    // (whole chunks, at least one a block) and keeps the centers of all M
    // atoms, which the embedding gave every block alike; each layer gathers
    // from them, then every block writes its atoms' new centers into each
    // block of the cluster (distributed shared memory) between two cluster
    // barriers: after the last gather from this layer's centers, and
    // before the first gather from the next layer's. Every product, softmax
    // and LayerNorm is a row's or an atom's, so the outputs are the ones
    // one block a molecule gives, bit for bit. Rank 0 then reads out.
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = kCluster ? (int)cluster.block_rank() : 0;
    const int chunks = (M + CA - 1) / CA;
    const int m_lo = kCluster ? rank * chunks / C * CA : 0;
    const int m_hi = kCluster ? min(M, (rank + 1) * chunks / C * CA) : M;
    auto cluster_barrier = [&]() {
      if constexpr (kCluster) cluster.sync();
    };

    // ---- SCANN+ geometry embedding of the block's atoms -> global scratch
    if (a.g_update) fwd_embed_geometry<kBf16>(a, sA, sU, ndist, nweight, geo_b, m_lo, m_hi);

    // ---- L x (LocalAttention + ResidualNorm) -----------------------------
    for (int l = 0; l < a.L; ++l) {
      const LayerWeights w = layer_weights(a, l);
      const float* bq = a.bq + (size_t)l * D;
      // the layer's packed planes (LocalAttention's, then the ResidualNorm's
      // W1 and W2), made where they are used, so that no register holds them
      // across the layer
      auto layer_planes = [&]() {
        return planes + (layer_plane_floats(D, a.K, a.g_update) + 2 * w32_plane_floats(D, D)) * l;
      };

      // per-atom projections of the block's atoms: cw = centers @ Wfg[0:D]
      // (SCANN+), query
      {
        const RowPlanes pl = row_planes(layer_planes(), D, a.K, a.g_update);
        const float* cb = sC + m_lo * ldm;
        if (a.g_update)
          mma_gemm_w32<kBf16>(cb, ldm, m_hi - m_lo, D, pl.cw, D, [&](int r, int c, float4 v) {
            store4(sW + (m_lo + r) * ldm + c, v);
          });
        mma_gemm_w32<kBf16>(cb, ldm, m_hi - m_lo, D, pl.q, D, [&](int r, int c, float4 v) {
          store4(sQ + (m_lo + r) * ldm + c,
                 make_float4(v.x + bq[c], v.y + bq[c + 1], v.z + bq[c + 2], v.w + bq[c + 3]));
        });
      }
      __syncthreads();
      cluster_barrier();   // every block's centers of this layer are in place

      for (int m0 = m_lo; m0 < m_hi; m0 += CA) {
        const int ca = min(CA, m_hi - m0), base = m0 * N;
        fwd_stage_chunk<kBf16>(a, sA, sC, ldm, nbr, ndist, geo_b, base, ca * N);
        fwd_chunk_w32<kBf16, float>(forward_chunk_dims(a), w, ca, sA, sU, sE, sW + m0 * ldm,
                                    sQ + m0 * ldm, ldm, nmask + base, nweight + base,
                                    l + 1 < a.L ? geo_b + (size_t)base * D : nullptr, nullptr,
                                    [&](int at, int n, int h) {
                                      return scann_philox::mask_value(
                                          a.seed, mol, 1 + a.L + l,
                                          (unsigned)((base + at * N + n) * H + h),
                                          a.attn_threshold, a.attn_scale);
                                    },
                                    row_planes(layer_planes(), D, a.K, a.g_update));
      }
      cluster_barrier();   // no block gathers from this layer's centers any more

      // ResidualNorm of the block's atoms: centers = LN(out + swish(out @ W1 +
      // b1) @ W2 + b2); their centers of this layer take h2, and each new row
      // goes to every block of the cluster
      const float* r1 = layer_planes() + layer_plane_floats(D, a.K, a.g_update);
      fwd_residual_norm<kBf16, true>(
          a, l, m_hi - m_lo, sQ + m_lo * ldm, sW + m_lo * ldm, sC + m_lo * ldm, ldm,
          [&](int r, int c) { return mask4(1 + l, m_lo + r, c); },
          [&](int m, const float (&v)[kLaneValues]) {
            float* row = sC + (m_lo + m) * ldm;
#pragma unroll
            for (int i = 0; i < kLaneValues; ++i)
              if (lane + 32 * i < D) row[lane + 32 * i] = v[i];
            if constexpr (kCluster) {
              for (int r = 1; r < C; ++r) {   // the other blocks of the cluster
                float* dst = cluster.map_shared_rank(row, (rank + r) % C);
#pragma unroll
                for (int i = 0; i < kLaneValues; ++i)
                  if (lane + 32 * i < D) dst[lane + 32 * i] = v[i];
              }
            }
          },
          r1, r1 + w32_plane_floats(D, D));
    }
    // the last layer's centers in every block; the other blocks are done
    cluster_barrier();
    if (kCluster && rank != 0) return;
  } else {
    // ---- SCANN+ geometry embedding -> global scratch -----------------------
    if (a.g_update) fwd_embed_geometry<kBf16>(a, sA, sU, ndist, nweight, geo_b, 0, M);

    // ---- L x (LocalAttention + ResidualNorm) -------------------------------
    for (int l = 0; l < a.L; ++l) {
      const LayerWeights w = layer_weights(a, l);
      const float* wq = a.wq + (size_t)l * D * D;
      const float* bq = a.bq + (size_t)l * D;

      // per-atom projections: cw = centers @ Wfg[0:D] (SCANN+), query
      if (a.g_update)
        mma_gemm<kBf16>(sC, ldm, M, D, w.wfg, D, D,
                        [&](int r, int c, float4 v) { store4(sW + r * ldm + c, v); });
      mma_gemm<kBf16>(sC, ldm, M, D, wq, D, D, [&](int r, int c, float4 v) {
        store4(sQ + r * ldm + c, make_float4(v.x + bq[c], v.y + bq[c + 1], v.z + bq[c + 2], v.w + bq[c + 3]));
      });
      __syncthreads();

      for (int m0 = 0; m0 < M; m0 += CA) {
        const int ca = min(CA, M - m0), base = m0 * N;
        fwd_stage_chunk<kBf16>(a, sA, sC, ldm, nbr, ndist, geo_b, base, ca * N);
        fwd_chunk<kBf16, float>(forward_chunk_dims(a), w, ca, sA, sU, sE, sW + m0 * ldm, sQ + m0 * ldm, ldm,
                  nmask + base, nweight + base, l + 1 < a.L ? geo_b + (size_t)base * D : nullptr,
                  nullptr, [&](int at, int n, int h) {
                    return scann_philox::mask_value(
                        a.seed, mol, 1 + a.L + l, (unsigned)((base + at * N + n) * H + h),
                        a.attn_threshold, a.attn_scale);
                  });
      }

      // ResidualNorm: centers = LN(out + swish(out @ W1 + b1) @ W2 + b2); the
      // centers of this layer are no longer needed, so they take h2
      fwd_residual_norm<kBf16>(a, l, M, sQ, sW, sC, ldm,
                        [&](int r, int c) { return mask4(1 + l, r, c); },
                        [&](int m, const float (&v)[kLaneValues]) {
  #pragma unroll
                          for (int i = 0; i < kLaneValues; ++i)
                            if (lane + 32 * i < D) sC[m * ldm + lane + 32 * i] = v[i];
                        });
    }
  }

  // ---- readout: after_Lc, GA scores, pooled context, head ----------------
  mma_gemm<kBf16>(sC, ldm, M, D, a.wal, G, G, [&](int r, int c, float4 v) {
    store4(sW + r * ldm + c, make_float4(swishf(v.x + a.bal[c]), swishf(v.y + a.bal[c + 1]),
                                         swishf(v.z + a.bal[c + 2]), swishf(v.w + a.bal[c + 3])));
  });
  __syncthreads();
  mma_gemm<kBf16>(sW, ldm, M, G, a.wgq, G, G, [&](int r, int c, float4 v) {
    store4(sQ + r * ldm + c, make_float4(v.x + a.bgq[c], v.y + a.bgq[c + 1],
                                         v.z + a.bgq[c + 2], v.w + a.bgq[c + 3]));
  });
  mma_gemm<kBf16>(sW, ldm, M, G, a.wgk, G, G, [&](int r, int c, float4 v) {
    store4(sC + r * ldm + c, make_float4(v.x + a.bgk[c], v.y + a.bgk[c + 1],
                                         v.z + a.bgk[c + 2], v.w + a.bgk[c + 3]));
  });
  __syncthreads();
  if (a.S) {
    // a packed slot: the GA readout and the head per segment (scann_common.cuh)
    const int* sid = a.seg + (size_t)b * M;
    const SegVectors v = seg_vectors(sMisc, a.S, ldm, M, O, false);
    seg_queries(v, a.S, sQ, ldm, sC, ldm, am, sid, 0, M, G, true);
    __syncthreads();
    seg_readout_forward<kBf16, false>(v, sC, ldm, am, sid, M, a.S, G, O, a.ga_norm, a.wbf, a.bbf,
                                      a.wp, a.bp, a.mrelu, a.pred + (size_t)b * a.S);
    for (int m = tid; m < M; m += kThreads) a.ga[(size_t)b * M + m] = v.ga[m];
    return;
  }
  float* qsum = sMisc;                 // [G]  sum_m mask * gq
  float* struc = sMisc + ldm;          // [G]  pooled context
  float* score = sMisc + 2 * ldm;      // [M]  agg, then ga
  float* hid = score + round4(M);      // [O]
  for (int g = tid; g < G; g += kThreads) {
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += am[m] * sQ[m * ldm + g];
    qsum[g] = s;
  }
  __syncthreads();
  // agg_m = mask_m * ((mask_m k_m) . qsum - (mask_m k_m) . (mask_m q_m))
  for (int m = warp; m < M; m += kWarps) {
    const float mm = am[m];
    float cross = 0.f, diag = 0.f;
    for (int g = lane; g < G; g += 32) {
      const float mk = mm * sC[m * ldm + g];
      cross += mk * qsum[g];
      diag += mk * (mm * sQ[m * ldm + g]);
    }
    cross = warp_sum(cross);
    diag = warp_sum(diag);
    if (lane == 0) score[m] = mm * (cross - diag);
  }
  __syncthreads();
  if (warp == 0) {
    // M <= 64: lane holds atoms lane and lane + 32
    const bool v0 = lane < M, v1 = lane + 32 < M;
    float s0 = v0 ? score[lane] : 0.f, s1 = v1 ? score[lane + 32] : 0.f;
    if (a.ga_norm) {
      float nrm = sqrtf(warp_sum(s0 * s0 + s1 * s1));
      if (nrm == 0.f) nrm = 1.f;   // single-atom structure: zero sum
      s0 /= nrm;
      s1 /= nrm;
    }
    s0 = v0 ? s0 + (1.0f - am[lane]) * -1e9f : -INFINITY;
    s1 = v1 ? s1 + (1.0f - am[lane + 32]) * -1e9f : -INFINITY;
    const float mx = warp_max(fmaxf(s0, s1));
    const float e0 = v0 ? expf(s0 - mx) : 0.f, e1 = v1 ? expf(s1 - mx) : 0.f;
    const float tot = warp_sum(e0 + e1);
    if (v0) {
      score[lane] = e0 / tot;
      a.ga[(size_t)b * M + lane] = e0 / tot;
    }
    if (v1) {
      score[lane + 32] = e1 / tot;
      a.ga[(size_t)b * M + lane + 32] = e1 / tot;
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += am[m] * score[m] * sC[m * ldm + g];
    struc[g] = s;
  }
  __syncthreads();
  tile_gemm<kBf16>(struc, G, 1, G, a.wbf, O, O, [&](int r, int c, float4 v) {
    store4(hid + c, make_float4(swishf(v.x + a.bbf[c]), swishf(v.y + a.bbf[c + 1]),
                                swishf(v.z + a.bbf[c + 2]), swishf(v.w + a.bbf[c + 3])));
  });
  __syncthreads();
  if (warp == 0) {
    float p = 0.f;
    for (int o = lane; o < O; o += 32) p += operand<kBf16>(hid[o]) * operand<kBf16>(a.wp[o]);
    p = warp_sum(p) + a.bp[0];
    if (a.mrelu) p = fmaxf(p, 0.f);
    if (lane == 0) a.pred[b] = p;
  }
}

}  // namespace

// The 49 pointers, 20 sizes, 4 scalars and 4 random-stream words are those of
// unpack_forward_args (scann_common.cuh), followed by pointer 49, the segment
// ids [B, M] (null unless packed), size 20, the segments per slot S, and size
// 21, the bf16 operand mode (0 or 1); in the order
// scann_tpu_torch/kernels/scann_forward.py passes them. Size 17 (the chunk
// buffer) is the work region of make_plan. This file builds the kernels of
// widths up to 128; scann_forward_d256.cu includes it with SCANN_WIDTH_256
// defined and builds those of widths up to 256 (scann_forward_d256_launch),
// at the first launch of a wider model, which also take pointer 50, the
// packed TF32 planes of the layers' products ([L, n] of pack_params'
// "tf32_planes"; never null there), and size 22, the blocks a molecule C
// (1 to kMaxForwardCluster, at most one a chunk of atoms), and answer
// scann_forward_d256_max_clusters. scann_forward_d512.cu adds
// SCANN_WIDTH_512: the build of widths up to 512 (scann_forward_d512_*),
// which also takes pointer 51, the query and scratch rows [B, 2, M,
// max(D, G) + 4] (f32; never null there).
#if defined(SCANN_WIDTH_512)
#define SCANN_FORWARD_ENTRY(x) scann_forward_d512_##x
#elif defined(SCANN_WIDTH_256)
#define SCANN_FORWARD_ENTRY(x) scann_forward_d256_##x
#else
#define SCANN_FORWARD_ENTRY(x) scann_forward_##x
#endif

#ifdef SCANN_FORWARD_TAKES_PLANES
namespace {

// The kernel of the operand mode bf16 (0 or 1) for C blocks a molecule,
// with its launch attributes for `bytes` of shared memory (clusters past 8
// blocks are non-portable).
auto d256_kernel(int bf16, int C, int bytes, cudaError_t& err) {
  const auto kernel = C > 1 ? (bf16 ? scann_forward_kernel<true, true>
                                    : scann_forward_kernel<false, true>)
                            : (bf16 ? scann_forward_kernel<true, false>
                                    : scann_forward_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && C > 1)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return kernel;
}

// C blocks a molecule: B clusters of C (one block a molecule without a
// cluster at C = 1)
void d256_launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int B, int C,
                        int bytes, cudaStream_t s) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
}

}  // namespace

// How many clusters of `cluster` blocks with this shape's shared memory the
// card runs at once (cudaOccupancyMaxActiveClusters) in the kernel of the
// operand mode in size 21, or minus the CUDA error; the sizes are the
// launch's.
extern "C" int SCANN_FORWARD_ENTRY(max_clusters)(const int* dims, int cluster) {
  Args a = {};
  a.B = dims[0]; a.M = dims[1]; a.N = dims[2]; a.D = dims[3]; a.H = dims[4];
  a.E = dims[5]; a.G = dims[7]; a.O = dims[8]; a.F = dims[10];
  a.cgcnn = dims[11]; a.use_ring = dims[12]; a.chunk_atoms = dims[16];
  a.S = dims[20];
  if ((dims[21] & ~1) || cluster < 1 || cluster > kMaxForwardCluster || a.chunk_atoms < 1)
    return -(int)cudaErrorInvalidValue;
  const int bytes = make_plan(a).total * (int)sizeof(float);
  cudaError_t err;
  const auto kernel = d256_kernel(dims[21], cluster, bytes, err);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  if (cluster == 1) {   // no cluster: blocks a SM times the SMs
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, bytes);
    return err == cudaSuccess ? n * sms : -(int)err;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  d256_launch_config(cfg, attr, a.B, cluster, bytes, nullptr);
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
#endif

extern "C" int SCANN_FORWARD_ENTRY(launch)(void* const* ptrs, const int* dims, const float* scalars,
                                    const unsigned int* rng, void* stream) {
  Args a;
  unpack_forward_args(a, ptrs, dims, scalars, rng);
  a.seg = (const int*)ptrs[49];
  a.S = dims[20];
  const int bf16 = dims[21];
#ifdef SCANN_FORWARD_TAKES_PLANES
  const float* planes = (const float*)ptrs[50];
  const int C = dims[22];
  if (planes == nullptr || C < 1 || C > kMaxForwardCluster) return kErrShape;
#endif
#ifdef SCANN_WIDTH_512
  float* l2rows = (float*)ptrs[51];
  if (l2rows == nullptr) return kErrShape;
#endif
  if (a.S < 0 || a.S > kMaxSegments || (a.S > 0) != (a.seg != nullptr)) return kErrShape;
  if (bf16 & ~1) return kErrShape;

  if (a.M > 64 || a.M < 1 || a.N < 1 || a.chunk_atoms < 1 || a.chunk_atoms > a.M ||
      a.chunk_atoms * a.N > kFwdMaxChunkRows || a.D > kMaxWidth || a.G > kMaxWidth ||
      a.O > kMaxWidth || (a.D & 3) || (a.G & 3) || (a.O & 3) || (a.E & 3) || a.D % a.H || a.K > a.D)
    return kErrShape;
  const Plan plan = make_plan(a);
  if (a.abuf_floats != plan.work) return kErrShape;   // the wrapper's plan is this one
  const int bytes = plan.total * (int)sizeof(float);
  if (bytes > kMaxSharedBytes) return kErrSharedMemory;
#ifdef SCANN_FORWARD_TAKES_PLANES
  // at least one chunk of atoms a block
  if (C > (a.M + a.chunk_atoms - 1) / a.chunk_atoms) return kErrShape;
  cudaError_t err;
  const auto kernel = d256_kernel(bf16, C, bytes, err);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  d256_launch_config(cfg, attr, a.B, C, bytes, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, kernel, a, planes, C SCANN_FORWARD_L2_ARG);
  if (err != cudaSuccess) return (int)err;
#else
  const auto kernel = bf16 ? scann_forward_kernel<true> : scann_forward_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B, kThreads, bytes, (cudaStream_t)stream>>>(a);
#endif
  return (int)cudaGetLastError();
}

extern "C" const char* SCANN_FORWARD_ENTRY(error_string)(int code) {
  if (code == kErrSharedMemory) return "shared-memory plan exceeds 227 KB per block";
  if (code == kErrShape) return "shape outside what the kernel takes";
  return cudaGetErrorString((cudaError_t)code);
}
