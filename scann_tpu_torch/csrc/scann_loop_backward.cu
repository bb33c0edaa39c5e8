// Whole-model SCANN / SCANN+ backward for crystals: every parameter gradient
// of one batch, a cluster of CUDA blocks per structure, plus the reduction
// that sums the per-block gradients in a fixed order.
//
// Replaces the TPU kernel scann_tpu/kernels/scann_loop.py:_bwd_kernel (the
// Pallas loop backward) for unpacked batches. It computes what
// scann_backward.cu computes (the forward with the Philox training dropout of
// philox.cuh, pred, and the reverse walk: head and GA readout, then per layer
// from the last the ResidualNorm, the attention LayerNorm, the softmax on the
// pre-dropout probabilities, key and query, the SCANN+ geometry update or the
// SCANN filter, the neighbour gather's transpose; then the embedding and the
// SCANN+ geometry embedding), in cotangent mode (d pred [B], d ga [B, M]) or
// in one-shot training mode (targets in, the residual pred - t formed here,
// mrelu straight-through), for structures too large for that kernel's
// shared-memory plan: MP2018 at (M=96, N=32, L=9) and Pt/graphene at (M=128,
// N=32, L=11), D=128.
//
// Bound. loop_backward_flops (kernels/scann_loop.py) counts ~5.5e11 FLOP that
// the function needs per MP2018 training batch (B=64, M=96, N=32, L=9,
// D=128): bound by operations, ~8.2 ms at the H100 SXM's 67 TFLOP/s FP32
// peak (the products run on the tensor cores in three TF32 passes to keep f32
// accuracy, so that peak stays the yardstick). This schedule's recompute
// (loop_recompute_flops) comes on top and is not in the bound.
//
// Design.
// - Schedule: that of scann_backward.cu, exact f32. The forward pass stashes
//   in global scratch each layer's input centers [L + 1, M, D], its ctx +
//   query before the attention LayerNorm [L, M, D] and, for SCANN+, its input
//   geometry [L, M*N, D]; the reverse walk recomputes a layer's per-atom
//   activations from the two [M, D] stashes and its (atom, neighbour) rows
//   once, chunk by chunk, from the geometry stash. (The TPU kernel's selective
//   stash of neighbour states, keys, attention, u_pre and o1 is another
//   schedule of the same function; it is not ported.)
// - Products: split-TF32 mma.sync (scann_mma.cuh): each warp owns 16 output
//   columns, so a weight element leaves L2 once per chunk of rows; the chunk's
//   buffers have row strides of 2D + 4 and D + 4 floats, which keeps the
//   fragment reads free of bank conflicts. Weight gradients add into the
//   block's gradient row 16 bytes a thread, and the bias sums fall out of the
//   same fragments. Softmax over the neighbours and its backward run one warp
//   per (atom, head).
// - A cluster of C blocks per structure (C = 1, 2 or 4, chosen by the wrapper
//   from the batch size so that a batch of 64 fills 128 of the card's 132
//   SMs). The blocks split the structure's atoms into C contiguous ranges.
//   What crosses blocks: the new centers of a layer go to the global stash,
//   then a cluster barrier, then every block reloads all M rows; the readout's
//   first pass (three small products on [M, D]) runs in every block; in the
//   reverse walk each block scatters d(neighbour state) into its own [M, D]
//   buffer, and after a cluster barrier each block sums, for its own atoms,
//   the C partial rows in rank order through distributed shared memory.
// - Where the state lives. Only one [M, max(D, G)] buffer stays in shared
//   memory: the current centers in the forward pass (every atom's gather may
//   read any row), the GA keys in the readout, and in the reverse walk the
//   accumulating d(layer input), the target of the gather's transpose. Every
//   other per-atom tensor exists for one block of AB <= 32 atoms at a time
//   (five [AB, max(D, G)] slots plus a work region shared by the chunk of
//   rows, the per-atom recompute, the readout and the embedding). In the
//   reverse walk the gather reads the layer's input centers from the stash in
//   global memory, and d(layer output) passes from one layer to the one below
//   through a [B, M, D] global scratch. The plan is M * 512 bytes + 107 to
//   175 KB at D=128 (atom blocks of 8 to 32): M <= 106 with blocks of 32,
//   M <= 186 with blocks of 16, M <= 226 with blocks of 8, at N=32.
// - No sequential grid, no atomics: each block writes its share of the
//   gradients into its own row of a [B * C, P] scratch, added to from the
//   second atom block (or chunk) on by the same thread, and scann_reduce_rows
//   sums the rows in order. The gather's transpose is a scatter-add into the
//   shared d(layer input) in which every target element is added to by one
//   thread walking the rows in order. Bias and LayerNorm-parameter sums also
//   run in a fixed order. Gradients therefore repeat bit for bit from run to
//   run at one cluster size; two cluster sizes differ in the last bits.
// - Dropout masks are drawn where they are used, forward and reverse, keyed
//   as in scann_loop.cu and ops/dropout.py.
//
// Interface: a plain C function, loaded with ctypes. It launches both kernels
// on the given stream, synchronises nothing, allocates nothing, and returns
// the cudaGetLastError() code of the launches (or kErrSharedMemory / kErrShape).

#include <cooperative_groups.h>

#include "philox.cuh"
#include "scann_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace scann;

using Args = BackwardArgs;

constexpr int kMaxChunkRows = 32;
constexpr int kMaxAtomBlock = 32;
constexpr int kMaxCluster = 4;

// Shared-memory plan, in floats: the resident [M, wd] buffer; five per-block
// slots [AB, wd]; the work region (the readout keeps its vectors there, past
// one [AB, wd] buffer); per-warp LayerNorm partials and bias sums.
struct Plan {
  int wd, ABW, rows, lda, ldu, lde, ldf, work, offBlk, offWork, offPart, offAcc, total;
};

__host__ __device__ inline Plan make_plan(const Args& a) {
  Plan p;
  const int AB = a.atom_block;
  p.wd = a.D > a.G ? a.D : a.G;
  p.ABW = AB * p.wd;
  p.rows = a.chunk_atoms * a.N;
  p.lda = 2 * a.D + 4;
  p.ldu = a.D + 4;
  p.lde = round4(a.E + (a.use_ring ? 10 : 0));
  p.ldf = a.cgcnn ? round4(a.F) : 0;
  const int chunk = p.rows * p.lda + 3 * p.rows * p.ldu + 3 * round4(p.rows * a.H);
  const int atoms = 5 * p.ABW + round4(AB);     // the reverse walk's per-atom recompute
  const int embed = AB * (2 * p.lde + p.ldf) + p.ABW;
  const int readout = p.ABW + 4 * p.wd + 5 * round4(a.M) + 3 * round4(a.O) + 4;
  int w = chunk;
  w = atoms > w ? atoms : w;
  w = embed > w ? embed : w;
  w = readout > w ? readout : w;
  p.work = w;
  p.offBlk = a.M * p.wd;
  p.offWork = p.offBlk + 5 * p.ABW;
  p.offPart = p.offWork + w;
  p.offAcc = p.offPart + kWarps * 2 * p.wd;
  p.total = p.offAcc + 2 * p.wd;
  return p;
}

__global__ void __launch_bounds__(kThreads, 1)
scann_loop_backward_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan P = make_plan(a);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.cluster, rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const bool lead = rank == 0;
  const int M = a.M, N = a.N, D = a.D, H = a.H, K = a.K, G = a.G, O = a.O, L = a.L;
  const int wd = P.wd, ABW = P.ABW, hd = D / H, CA = a.chunk_atoms, AB = a.atom_block;
  const int R = M * N, lda = P.lda, ldu = P.ldu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned int mol = a.mol_base + (unsigned int)b;
  // this block's atoms: the rank-th of C contiguous ranges
  const int per = (M + C - 1) / C;
  const int m_lo = min(M, rank * per), m_hi = min(M, m_lo + per);

  float* sR = smem;                    // resident [M, wd]: centers / GA keys / d layer input
  float* sCb = smem + P.offBlk;        // the block's layer input centers   [AB, wd]
  float* sQ = sCb + ABW;               // query (forward: ctx + query, o1)
  float* sCW = sQ + ABW;               // centers @ Wfg[0:D] (SCANN+)
  float* sDQ = sCW + ABW;              // d ctx, then d query
  float* sDCW = sDQ + ABW;             // d cw (SCANN+)
  float* work = smem + P.offWork;
  float* sPart = smem + P.offPart;     // [kWarps][2][wd] LayerNorm partials
  float* sAcc = smem + P.offAcc;       // [2][wd] bias sums of a layer's rows
  // a chunk of (atom, neighbour) rows
  const int CR = P.rows;
  float* sA = work;                    // [CR, lda]: geometry or RBF | neighbour states
  float* sU = sA + CR * lda;           // [CR, ldu]: u_pre, then d u_pre
  float* sV = sU + CR * ldu;           // [CR, ldu]: key input, then d key input
  float* sW = sV + CR * ldu;           // [CR, ldu]: key, then d key, then d LN_g input
  float* sE = sW + CR * ldu;           // [CR, H]: attention (before dropout)
  float* sF = sE + round4(CR * H);     // [CR, H]: d attention
  float* sM = sF + round4(CR * H);     // [CR, H]: attention dropout mask

  const float* am = a.atom_mask + (size_t)b * M;
  const int* nbr = a.nbr + (size_t)b * R;
  const float* nmask = a.nmask + (size_t)b * R;
  const float* nweight = a.nweight + (size_t)b * R;
  const float* ndist = a.ndist + (size_t)b * R;
  float* c_st = a.c_stash + (size_t)b * (L + 1) * M * D;
  float* o_st = a.o_stash + (size_t)b * L * M * D;
  float* g_st = a.g_update ? a.g_stash + (size_t)b * L * R * D : nullptr;
  float* dgb = a.g_update ? a.dgeo + (size_t)b * R * D : nullptr;
  float* dcen = a.dcenters + (size_t)b * M * D;
  float* grow = a.grad_rows + (size_t)blockIdx.x * a.P;
  auto grad = [&](int g) { return grow + a.off[g]; };
  const int fg_in = a.g_update ? 3 * D : K;
  const int q4 = D / 4;

  // the [M, D] embedding and residual masks: quad (r, c..c+3) is one Philox
  // output, since D and c are multiples of 4
  auto mask4 = [&](int stream, int r, int c) {
    if (!a.dropout) return make_float4(1.f, 1.f, 1.f, 1.f);
    return scann_philox::mask_quad(a.seed, mol, stream, (unsigned)(r * D + c) >> 2,
                                   a.drop_threshold, a.drop_scale);
  };
  auto mask1 = [&](int stream, int r, int d) {
    if (!a.dropout) return 1.f;
    return scann_philox::mask_value(a.seed, mol, stream, (unsigned)(r * D + d),
                                    a.drop_threshold, a.drop_scale);
  };
  auto zero = [&](float* p, int n) {
    for (int i = tid; i < n; i += kThreads) p[i] = 0.f;
  };
  // rows [m0, m0 + n) of a global [M, D] array into a [n, wd] shared buffer
  auto load_rows = [&](float* dst, const float* src, int m0, int n) {
    for (int i = tid; i < n * q4; i += kThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      store4(dst + r * wd + c, *reinterpret_cast<const float4*>(src + (size_t)(m0 + r) * D + c));
    }
  };

  // a block without atoms (fewer atoms than blocks in the cluster) still owns
  // a gradient row: all zeros. It goes on to every cluster barrier below.
  if (m_lo >= m_hi)
    for (long long i = tid; i < a.P; i += kThreads) grow[i] = 0.f;

  // ---- a chunk of rows: stage, then recompute u_pre, key input, key, attention.
  // cen [M, ldc] holds the layer's input centers: the resident buffer in the
  // forward pass, the stash in global memory in the reverse walk.
  auto stage_chunk = [&](int l, int m0, int rows, const float* cen, int ldc) {
    const int base = m0 * N;
    if (a.g_update) {
      const float* g_in = g_st + ((size_t)l * R + base) * D;
      for (int i = tid; i < rows * q4; i += kThreads) {
        const int r = i / q4, c = (i - r * q4) * 4;
        store4(sA + r * lda + c, *reinterpret_cast<const float4*>(g_in + (size_t)r * D + c));
      }
    } else {
      for (int i = tid; i < rows * K; i += kThreads) {
        const int r = i / K, k = i - r * K;
        const float t = ndist[base + r] - a.dist_centers[k];
        sA[r * lda + k] = expf(-(t * t) / a.rbf_width);
      }
    }
    for (int i = tid; i < rows * q4; i += kThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      store4(sA + r * lda + D + c,
             *reinterpret_cast<const float4*>(cen + (size_t)nbr[base + r] * ldc + c));
    }
    if (a.attn_dropout) {
      for (int i = tid; i < rows * H; i += kThreads)
        sM[i] = scann_philox::mask_value(a.seed, mol, 1 + L + l, (unsigned)(base * H + i),
                                         a.attn_threshold, a.attn_scale);
    }
    __syncthreads();
  };

  // lm0: the chunk's first atom within its atom block
  auto row_forward = [&](int l, int m0, int lm0, int ca, bool write_g) {
    const int rows = ca * N, base = m0 * N;
    const float* wfg = a.wfg + (size_t)l * fg_in * D;
    const float* bfg = a.bfg + (size_t)l * D;
    const float* bk = a.bk + (size_t)l * D;
    if (a.g_update) {
      // u_pre = cw + [geo | ns] @ Wfg[D:3D] + b
      mma_gemm(sA, lda, rows, 2 * D, wfg + (size_t)D * D, D, D, [&](int r, int c, float4 v) {
        const float* cw = sCW + (lm0 + r / N) * wd + c;
        store4(sU + r * ldu + c, make_float4(cw[0] + v.x + bfg[c], cw[1] + v.y + bfg[c + 1],
                                             cw[2] + v.z + bfg[c + 2], cw[3] + v.w + bfg[c + 3]));
      });
      __syncthreads();
      const float* gs = a.lng_s + (size_t)l * D;
      const float* gb = a.lng_b + (size_t)l * D;
      float* g_out = write_g ? g_st + ((size_t)(l + 1) * R + base) * D : nullptr;
      for (int r = warp; r < rows; r += kWarps) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          v[i] = d < D ? swishf(sU[r * ldu + d]) + sA[r * lda + d] : 0.f;
        }
        float mean, inv;
        warp_ln_stats(v, D, lane, mean, inv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            const float g = (v[i] - mean) * inv * gs[d] + gb[d];
            if (write_g) g_out[(size_t)r * D + d] = g;
            sV[r * ldu + d] = sA[r * lda + D + d] * g;   // ns * geo'
          }
        }
      }
    } else {
      // geo_term = swish(rbf(d) @ Wfg + b) * weight
      mma_gemm(sA, lda, rows, K, wfg, D, D, [&](int r, int c, float4 v) {
        store4(sU + r * ldu + c,
               make_float4(v.x + bfg[c], v.y + bfg[c + 1], v.z + bfg[c + 2], v.w + bfg[c + 3]));
      });
      __syncthreads();
      for (int i = tid; i < rows * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        sV[r * ldu + d] = sA[r * lda + D + d] * (swishf(sU[r * ldu + d]) * nweight[base + r]);
      }
    }
    __syncthreads();
    // key = (ns * geo) @ Wk + bk
    mma_gemm(sV, ldu, rows, D, a.wk + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
      store4(sW + r * ldu + c,
             make_float4(v.x + bk[c], v.y + bk[c + 1], v.z + bk[c + 2], v.w + bk[c + 3]));
    });
    __syncthreads();
    warp_energy_softmax(sQ + lm0 * wd, wd, sW, ldu, nmask + base, sE, ca, N, H, hd, a.dk);
    __syncthreads();
  };

  // per-atom projections of the block's layer input cb [ab, wd]: query (and
  // cw for SCANN+); the caller synchronises
  auto project_atoms = [&](int l, const float* cb, int ab) {
    const float* wfg = a.wfg + (size_t)l * fg_in * D;
    const float* bq = a.bq + (size_t)l * D;
    if (a.g_update)
      mma_gemm(cb, wd, ab, D, wfg, D, D, [&](int r, int c, float4 v) { store4(sCW + r * wd + c, v); });
    mma_gemm(cb, wd, ab, D, a.wq + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
      store4(sQ + r * wd + c, make_float4(v.x + bq[c], v.y + bq[c + 1], v.z + bq[c + 2], v.w + bq[c + 3]));
    });
  };

  // per-warp LayerNorm partials -> the block's gradient row
  auto flush_ln = [&](float* gs, float* gb, bool accumulate) {
    for (int d = tid; d < D; d += kThreads) {
      float s0 = 0.f, s1 = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        s0 += sPart[(w * 2) * wd + d];
        s1 += sPart[(w * 2 + 1) * wd + d];
        sPart[(w * 2) * wd + d] = 0.f;
        sPart[(w * 2 + 1) * wd + d] = 0.f;
      }
      gs[d] = accumulate ? gs[d] + s0 : s0;
      gb[d] = accumulate ? gb[d] + s1 : s1;
    }
  };

  // ---- embedding staging of one atom block: sEmb [ab, lde] = [emb | ring_emb]
  const int ke = a.E + (a.use_ring ? 10 : 0);
  const int lde = P.lde, ldf = P.ldf;
  float* sEmb = work;
  float* sFeat = work + AB * lde;
  auto stage_embedding = [&](int ab0, int ab) {
    if (a.cgcnn) {
      const int F = a.F;
      for (int i = tid; i < ab * ldf; i += kThreads) {
        const int m = i / ldf, f = i - m * ldf;
        sFeat[i] = f < F ? a.feat[((size_t)b * M + ab0 + m) * F + f] : 0.f;
      }
      __syncthreads();
      const float* bemb = a.bembed;
      mma_gemm(sFeat, ldf, ab, F, a.embed, a.E, a.E, [&](int r, int c, float4 v) {
        store4(sEmb + r * lde + c,
               make_float4(v.x + bemb[c], v.y + bemb[c + 1], v.z + bemb[c + 2], v.w + bemb[c + 3]));
      });
    } else {
      for (int i = tid; i < ab * a.E; i += kThreads) {
        const int m = i / a.E, e = i - m * a.E;
        sEmb[m * lde + e] = a.embed[(size_t)a.atomic[(size_t)b * M + ab0 + m] * a.E + e];
      }
    }
    if (a.use_ring) {
      for (int i = tid; i < ab * 10; i += kThreads) {
        const int m = i / 10, j = i - m * 10;
        const float* ra = a.ring + ((size_t)b * M + ab0 + m) * 2;
        sEmb[m * lde + a.E + j] = ra[0] * a.wring[j] + ra[1] * a.wring[10 + j] + a.bring[j];
      }
    }
    for (int i = tid; i < ab * (lde - ke); i += kThreads) {   // keep the pad columns finite
      const int m = i / (lde - ke), j = i - m * (lde - ke);
      sEmb[m * lde + ke + j] = 0.f;
    }
    __syncthreads();
  };

  // the RBF expansions of a chunk's distances and angles, for the SCANN+
  // geometry embedding: sA [rows, lda] = [rbf(d) | rbf(w)]; the caller synchronises
  auto stage_rbf = [&](int base, int rows) {
    for (int i = tid; i < rows * K; i += kThreads) {
      const int r = i / K, k = i - r * K;
      const float t = ndist[base + r] - a.dist_centers[k];
      const float u = nweight[base + r] - a.angle_centers[k];
      sA[r * lda + k] = expf(-(t * t) / a.rbf_width);
      sA[r * lda + D + k] = expf(-(u * u) / a.rbf_width);
    }
  };
  // s_nd = rbf(d) @ Wnd + bnd -> sU, s_nw = rbf(w) @ Wnw + bnw -> sV; the caller synchronises
  auto geometry_products = [&](int rows) {
    mma_gemm(sA, lda, rows, K, a.wnd, D, D, [&](int r, int c, float4 v) {
      store4(sU + r * ldu + c, make_float4(v.x + a.bnd[c], v.y + a.bnd[c + 1],
                                           v.z + a.bnd[c + 2], v.w + a.bnd[c + 3]));
    });
    mma_gemm(sA + D, lda, rows, K, a.wnw, D, D, [&](int r, int c, float4 v) {
      store4(sV + r * ldu + c, make_float4(v.x + a.bnw[c], v.y + a.bnw[c + 1],
                                           v.z + a.bnw[c + 2], v.w + a.bnw[c + 3]));
    });
  };

  // ======================= forward, stashing layer inputs ===================
  for (int ab0 = m_lo; ab0 < m_hi; ab0 += AB) {
    const int ab = min(AB, m_hi - ab0);
    stage_embedding(ab0, ab);
    mma_gemm(sEmb, lde, ab, ke, a.wde, D, D, [&](int r, int c, float4 v) {
      const float4 m = mask4(0, ab0 + r, c);
      store4(c_st + (size_t)(ab0 + r) * D + c,
             make_float4(swishf(v.x + a.bde[c]) * m.x, swishf(v.y + a.bde[c + 1]) * m.y,
                         swishf(v.z + a.bde[c + 2]) * m.z, swishf(v.w + a.bde[c + 3]) * m.w));
    });
    __syncthreads();
  }

  // SCANN+ geometry embedding: geo_0 = swish(rbf(d) @ Wnd + bnd) * swish(rbf(w) @ Wnw + bnw)
  if (a.g_update) {
    for (int m0 = m_lo; m0 < m_hi; m0 += CA) {
      const int ca = min(CA, m_hi - m0), rows = ca * N, base = m0 * N;
      stage_rbf(base, rows);
      __syncthreads();
      geometry_products(rows);
      __syncthreads();
      for (int i = tid; i < rows * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        g_st[(size_t)base * D + i] = swishf(sU[r * ldu + d]) * swishf(sV[r * ldu + d]);
      }
      __syncthreads();
    }
  }
  // every block of the cluster has written its atoms' embeddings: take all M rows
  cluster.sync();
  load_rows(sR, c_st, 0, M);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const float* ls = a.ln_s + (size_t)l * D;
    const float* lb = a.ln_b + (size_t)l * D;
    const float* br1 = a.br1 + (size_t)l * D;
    const float* br2 = a.br2 + (size_t)l * D;
    const float* rs = a.rln_s + (size_t)l * D;
    const float* rb = a.rln_b + (size_t)l * D;
    float* c_next = c_st + (size_t)(l + 1) * M * D;
    float* sH1 = sDQ;                  // swish(o1 @ W1 + b1)
    float* sH2 = sDCW;                 // (h1 @ W2 + b2) * mask
    for (int ab0 = m_lo; ab0 < m_hi; ab0 += AB) {
      const int ab = min(AB, m_hi - ab0);
      project_atoms(l, sR + ab0 * wd, ab);
      __syncthreads();
      for (int m0 = ab0; m0 < ab0 + ab; m0 += CA) {
        const int ca = min(CA, ab0 + ab - m0), base = m0 * N, lm0 = m0 - ab0;
        stage_chunk(l, m0, ca * N, sR, wd);
        row_forward(l, m0, lm0, ca, l + 1 < L);
        // ctx = sum_n attn * mask * nmask * key, added to the query
        for (int i = tid; i < ca * D; i += kThreads) {
          const int at = i / D, d = i - at * D, h = d / hd;
          float s = 0.f;
          for (int n = 0; n < N; ++n) {
            const int r = at * N + n;
            const float p = a.attn_dropout ? sE[r * H + h] * sM[r * H + h] : sE[r * H + h];
            s += p * nmask[base + r] * sW[r * ldu + d];
          }
          sQ[(lm0 + at) * wd + d] = s + sQ[(lm0 + at) * wd + d];
        }
        __syncthreads();
      }
      // stash ctx + query, then o1 = LN(ctx + query)
      for (int m = warp; m < ab; m += kWarps) {
        float* row = sQ + m * wd;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          v[i] = d < D ? row[d] : 0.f;
          if (d < D) o_st[((size_t)l * M + ab0 + m) * D + d] = v[i];
        }
        warp_layer_norm(v, D, ls, lb, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (lane + 32 * i < D) row[lane + 32 * i] = v[i];
      }
      __syncthreads();
      // ResidualNorm: next = LN(o1 + mask * (swish(o1 @ W1 + b1) @ W2 + b2))
      mma_gemm(sQ, wd, ab, D, a.wr1 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
        store4(sH1 + r * wd + c, make_float4(swishf(v.x + br1[c]), swishf(v.y + br1[c + 1]),
                                             swishf(v.z + br1[c + 2]), swishf(v.w + br1[c + 3])));
      });
      __syncthreads();
      mma_gemm(sH1, wd, ab, D, a.wr2 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
        const float4 m = mask4(1 + l, ab0 + r, c);
        store4(sH2 + r * wd + c, make_float4((v.x + br2[c]) * m.x, (v.y + br2[c + 1]) * m.y,
                                             (v.z + br2[c + 2]) * m.z, (v.w + br2[c + 3]) * m.w));
      });
      __syncthreads();
      for (int m = warp; m < ab; m += kWarps) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          v[i] = d < D ? sQ[m * wd + d] + sH2[m * wd + d] : 0.f;
        }
        warp_layer_norm(v, D, rs, rb, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (lane + 32 * i < D) c_next[(size_t)(ab0 + m) * D + lane + 32 * i] = v[i];
      }
      __syncthreads();
    }
    // every atom of the structure has gathered from this layer's input and
    // every block has written its atoms' new centers: take all M rows
    cluster.sync();
    load_rows(sR, c_next, 0, M);
    __syncthreads();
  }

  // ======================= readout: forward and backward ====================
  const float* c_last = c_st + (size_t)L * M * D;
  {
    float* qsum = work + ABW;          // [wd] each; work[0, ABW) is pass 2's RE
    float* struc = qsum + wd;
    float* dstruc = struc + wd;
    float* dqsum = dstruc + wd;
    float* agg0 = dqsum + wd;          // [M] each
    float* ga = agg0 + round4(M);
    float* dga = ga + round4(M);
    float* dcd = dga + round4(M);
    float* diag = dcd + round4(M);
    float* sbf = diag + round4(M);     // [O] each
    float* sb = sbf + round4(O);
    float* dsbf = sb + round4(O);
    float* scal = dsbf + round4(O);    // [0] norm, [1] d pred
    // pass 1, block by block over all M atoms, in every block of the cluster
    // (the scores need every key): the GA keys take the place of the centers
    zero(qsum, G);
    for (int ab0 = 0; ab0 < M; ab0 += AB) {
      const int ab = min(AB, M - ab0);
      float* RB = sCb;                 // cg = swish(cL @ Wal + bal)
      float* RC = sQ;                  // gq
      mma_gemm(sR + ab0 * wd, wd, ab, D, a.wal, G, G, [&](int r, int c, float4 v) {
        store4(RB + r * wd + c, make_float4(swishf(v.x + a.bal[c]), swishf(v.y + a.bal[c + 1]),
                                            swishf(v.z + a.bal[c + 2]), swishf(v.w + a.bal[c + 3])));
      });
      __syncthreads();
      mma_gemm(RB, wd, ab, G, a.wgq, G, G, [&](int r, int c, float4 v) {
        store4(RC + r * wd + c, make_float4(v.x + a.bgq[c], v.y + a.bgq[c + 1],
                                            v.z + a.bgq[c + 2], v.w + a.bgq[c + 3]));
      });
      mma_gemm(RB, wd, ab, G, a.wgk, G, G, [&](int r, int c, float4 v) {
        store4(sR + (ab0 + r) * wd + c, make_float4(v.x + a.bgk[c], v.y + a.bgk[c + 1],
                                                    v.z + a.bgk[c + 2], v.w + a.bgk[c + 3]));
      });
      __syncthreads();
      for (int g = tid; g < G; g += kThreads) {
        float s = qsum[g];
        for (int m = 0; m < ab; ++m) s += am[ab0 + m] * RC[m * wd + g];
        qsum[g] = s;
      }
      for (int m = warp; m < ab; m += kWarps) {
        const float mm = am[ab0 + m];
        float dg = 0.f;
        for (int g = lane; g < G; g += 32)
          dg += (mm * sR[(ab0 + m) * wd + g]) * (mm * RC[m * wd + g]);
        dg = warp_sum(dg);
        if (lane == 0) diag[ab0 + m] = dg;
      }
      __syncthreads();
    }
    // agg_m = mask_m * ((mask_m k_m) . qsum - (mask_m k_m) . (mask_m q_m))
    for (int m = warp; m < M; m += kWarps) {
      const float mm = am[m];
      float cross = 0.f;
      for (int g = lane; g < G; g += 32) cross += (mm * sR[m * wd + g]) * qsum[g];
      cross = warp_sum(cross);
      if (lane == 0) agg0[m] = mm * (cross - diag[m]);
    }
    __syncthreads();
    if (warp == 0) {
      // lane holds atoms lane, lane + 32, ...
      float nrm = 1.f;
      if (a.ga_norm) {
        float sq = 0.f;
        for (int m = lane; m < M; m += 32) sq += agg0[m] * agg0[m];
        nrm = sqrtf(warp_sum(sq));
        if (nrm == 0.f) nrm = 1.f;     // single-atom structure: zero sum
      }
      float mx = -INFINITY;
      for (int m = lane; m < M; m += 32) {
        ga[m] = agg0[m] / nrm + (1.0f - am[m]) * -1e9f;
        mx = fmaxf(mx, ga[m]);
      }
      mx = warp_max(mx);
      float tot = 0.f;
      for (int m = lane; m < M; m += 32) {
        ga[m] = expf(ga[m] - mx);
        tot += ga[m];
      }
      tot = warp_sum(tot);
      for (int m = lane; m < M; m += 32) ga[m] /= tot;
      if (lane == 0) scal[0] = nrm;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      float s = 0.f;
      for (int m = 0; m < M; ++m) s += am[m] * ga[m] * sR[m * wd + g];
      struc[g] = s;
    }
    __syncthreads();
    tile_gemm(struc, G, 1, G, a.wbf, O, O, [&](int r, int c, float4 v) {
      const float4 s = make_float4(v.x + a.bbf[c], v.y + a.bbf[c + 1], v.z + a.bbf[c + 2],
                                   v.w + a.bbf[c + 3]);
      store4(sbf + c, s);
      store4(sb + c, make_float4(swishf(s.x), swishf(s.y), swishf(s.z), swishf(s.w)));
    });
    __syncthreads();
    if (warp == 0) {
      float p = 0.f;
      for (int o = lane; o < O; o += 32) p += sb[o] * a.wp[o];
      p = warp_sum(p) + a.bp[0];
      if (a.mrelu) p = fmaxf(p, 0.f);
      if (lane == 0) {
        if (lead) a.pred[b] = p;
        scal[1] = a.one_shot ? p - a.ct[b] : a.ct[b];   // straight-through mrelu
      }
    }
    __syncthreads();
    // the head's gradients belong to the structure, not to an atom: the
    // cluster's first block writes them, the others write zeros
    const float ctp = scal[1], nrm = scal[0], mine = lead ? 1.f : 0.f;
    if (tid == 0) grad(gBP)[0] = ctp * mine;
    for (int o = tid; o < O; o += kThreads) {
      grad(gWP)[o] = sb[o] * ctp * mine;
      dsbf[o] = ctp * a.wp[o] * swish_grad(sbf[o]);
    }
    __syncthreads();
    for (int i = tid; i < G * O; i += kThreads) {
      const int g = i / O, o = i - g * O;
      grad(gWBF)[i] = struc[g] * dsbf[o] * mine;
    }
    for (int o = tid; o < O; o += kThreads) grad(gBBF)[o] = dsbf[o] * mine;
    for (int g = tid; g < G; g += kThreads) {
      float s = 0.f;
      for (int o = 0; o < O; ++o) s += dsbf[o] * a.wbf[(size_t)g * O + o];
      dstruc[g] = s;
    }
    __syncthreads();
    for (int m = warp; m < M; m += kWarps) {
      float s = 0.f;
      for (int g = lane; g < G; g += 32) s += am[m] * sR[m * wd + g] * dstruc[g];
      s = warp_sum(s);
      if (lane == 0) dga[m] = s + (a.one_shot ? 0.f : a.ct_ga[(size_t)b * M + m]);
    }
    __syncthreads();
    if (warp == 0) {
      float s = 0.f;
      for (int m = lane; m < M; m += 32) s += ga[m] * dga[m];
      s = warp_sum(s);
      float inner = 0.f;
      for (int m = lane; m < M; m += 32) {
        dcd[m] = ga[m] * (dga[m] - s);   // softmax over the atoms
        inner += agg0[m] * dcd[m];
      }
      inner = warp_sum(inner);
      for (int m = lane; m < M; m += 32) {
        float da = dcd[m];
        if (a.ga_norm) da = da / nrm - agg0[m] * (inner / (nrm * nrm * nrm));
        dcd[m] = da * am[m];
      }
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      float s = 0.f;
      for (int m = 0; m < M; ++m) s += dcd[m] * (am[m] * sR[m * wd + g]);
      dqsum[g] = s;
    }
    __syncthreads();
    // pass 2, block by block over this block's atoms: recompute s_al, cg and gq
    // from the stashed last centers, then the gradients of the GA projections
    // and of after_Lc
    for (int ab0 = m_lo; ab0 < m_hi; ab0 += AB) {
      const int ab = min(AB, m_hi - ab0);
      const bool acc = ab0 > m_lo;
      float* cLb = sCb;                // the block's last centers
      float* RA = sQ;                  // s_al = cL @ Wal + bal
      float* RB = sCW;                 // cg = swish(s_al)
      float* RC = sDQ;                 // gq, then d gq
      float* RD = sR + ab0 * wd;       // gk, then d gk (in the resident buffer)
      float* RE = work;                // d cg, then d s_al
      load_rows(cLb, c_last, ab0, ab);
      __syncthreads();
      mma_gemm(cLb, wd, ab, D, a.wal, G, G, [&](int r, int c, float4 v) {
        const float4 s = make_float4(v.x + a.bal[c], v.y + a.bal[c + 1], v.z + a.bal[c + 2],
                                     v.w + a.bal[c + 3]);
        store4(RA + r * wd + c, s);
        store4(RB + r * wd + c, make_float4(swishf(s.x), swishf(s.y), swishf(s.z), swishf(s.w)));
      });
      __syncthreads();
      mma_gemm(RB, wd, ab, G, a.wgq, G, G, [&](int r, int c, float4 v) {
        store4(RC + r * wd + c, make_float4(v.x + a.bgq[c], v.y + a.bgq[c + 1],
                                            v.z + a.bgq[c + 2], v.w + a.bgq[c + 3]));
      });
      __syncthreads();
      for (int i = tid; i < ab * G; i += kThreads) {
        const int r = i / G, g = i - r * G, m = ab0 + r;
        const float mm = am[m], mk = mm * RD[r * wd + g], mq = mm * RC[r * wd + g];
        const float dmk = dcd[m] * qsum[g] - dcd[m] * mq;
        const float dmq = -dcd[m] * mk + dqsum[g];
        RC[r * wd + g] = mm * dmq;
        RD[r * wd + g] = mm * ga[m] * dstruc[g] + mm * dmk;
      }
      __syncthreads();
      mma_gemm_tA(RB, wd, RC, wd, ab, G, G, grad(gWGQ), G, acc, grad(gBGQ), acc);
      mma_gemm_tA(RB, wd, RD, wd, ab, G, G, grad(gWGK), G, acc, grad(gBGK), acc);
      mma_gemm_tB(RC, wd, ab, G, a.wgq, G, G, G, [&](int r, int c, float4 v) {
        store4(RE + r * wd + c, v);
      });
      __syncthreads();
      mma_gemm_tB(RD, wd, ab, G, a.wgk, G, G, G, [&](int r, int c, float4 v) {
        const float* e = RE + r * wd + c;
        const float* s = RA + r * wd + c;
        store4(RE + r * wd + c, make_float4((e[0] + v.x) * swish_grad(s[0]), (e[1] + v.y) * swish_grad(s[1]),
                                            (e[2] + v.z) * swish_grad(s[2]), (e[3] + v.w) * swish_grad(s[3])));
      });
      __syncthreads();
      mma_gemm_tA(cLb, wd, RE, wd, ab, D, G, grad(gWAL), G, acc, grad(gBAL), acc);
      mma_gemm_tB(RE, wd, ab, G, a.wal, G, D, D, [&](int r, int c, float4 v) {
        store4(dcen + (size_t)(ab0 + r) * D + c, v);
      });
      __syncthreads();
    }
  }

  // ======================= reverse walk over the layers =====================
  float* sDCN = sR;                    // d layer input, accumulated over the atom blocks
  // the gather's transpose: column d of the targets with index % np == part
  // belongs to thread part * D + d, which walks the chunk's rows in order
  const int np = kThreads / D > 0 ? kThreads / D : 1;
  const int sc_d = tid % D, sc_part = tid / D;
  zero(sPart, kWarps * 2 * wd);
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    const float* wfg = a.wfg + (size_t)l * fg_in * D;
    const float* wk = a.wk + (size_t)l * D * D;
    const float* lns = a.ln_s + (size_t)l * D;
    const float* rls = a.rln_s + (size_t)l * D;
    const float* br1 = a.br1 + (size_t)l * D;
    const float* br2 = a.br2 + (size_t)l * D;
    const float* c_in = c_st + (size_t)l * M * D;
    float* P0 = work;                  // ctx + query, then its x-hat
    float* P1 = work + ABW;            // o1
    float* P2 = work + 2 * ABW;        // s1 = o1 @ W1 + b1
    float* P3 = work + 3 * ABW;        // h1 = swish(s1), then d s1
    float* P4 = work + 4 * ABW;        // o1 + h2, then d h2
    float* P5 = sDCW;                  // d (o1 + h2), then d o1
    float* oinv = work + 5 * ABW;      // [AB] rsqrt(var + eps) of ctx + query
    zero(sDCN, M * wd);
    zero(sAcc, 2 * wd);
    __syncthreads();
    int ci = 0;                        // chunks of rows done in this layer
    for (int ab0 = m_lo; ab0 < m_hi; ab0 += AB) {
      const int ab = min(AB, m_hi - ab0);
      const bool acc = ab0 > m_lo;
      load_rows(P0, o_st + (size_t)l * M * D, ab0, ab);
      __syncthreads();
      // recompute o1 and the ResidualNorm
      for (int m = warp; m < ab; m += kWarps) {
        float v[4], mean, inv;
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = lane + 32 * i < D ? P0[m * wd + lane + 32 * i] : 0.f;
        warp_ln_stats(v, D, lane, mean, inv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            const float xh = (v[i] - mean) * inv;
            P0[m * wd + d] = xh;
            P1[m * wd + d] = xh * lns[d] + a.ln_b[(size_t)l * D + d];
          }
        }
        if (lane == 0) oinv[m] = inv;
      }
      __syncthreads();
      mma_gemm(P1, wd, ab, D, a.wr1 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
        const float4 s = make_float4(v.x + br1[c], v.y + br1[c + 1], v.z + br1[c + 2], v.w + br1[c + 3]);
        store4(P2 + r * wd + c, s);
        store4(P3 + r * wd + c, make_float4(swishf(s.x), swishf(s.y), swishf(s.z), swishf(s.w)));
      });
      __syncthreads();
      mma_gemm(P3, wd, ab, D, a.wr2 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
        const float4 m = mask4(1 + l, ab0 + r, c);
        const float* o1 = P1 + r * wd + c;
        store4(P4 + r * wd + c, make_float4(o1[0] + (v.x + br2[c]) * m.x, o1[1] + (v.y + br2[c + 1]) * m.y,
                                            o1[2] + (v.z + br2[c + 2]) * m.z, o1[3] + (v.w + br2[c + 3]) * m.w));
      });
      __syncthreads();
      // ResidualNorm's LayerNorm backward: P5 = d sum, P4 = d h2 = d sum * mask
      for (int m = warp; m < ab; m += kWarps) {
        float v[4], dy[4], xh[4], dx[4], mean, inv;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          v[i] = d < D ? P4[m * wd + d] : 0.f;
          dy[i] = d < D ? dcen[(size_t)(ab0 + m) * D + d] : 0.f;
        }
        warp_ln_stats(v, D, lane, mean, inv);
#pragma unroll
        for (int i = 0; i < 4; ++i) xh[i] = lane + 32 * i < D ? (v[i] - mean) * inv : 0.f;
        warp_ln_backward(xh, inv, dy, rls, D, lane, dx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            P5[m * wd + d] = dx[i];
            P4[m * wd + d] = dx[i] * mask1(1 + l, ab0 + m, d);
            sPart[(warp * 2) * wd + d] += dy[i] * xh[i];
            sPart[(warp * 2 + 1) * wd + d] += dy[i];
          }
        }
      }
      __syncthreads();
      flush_ln(grad(gRLNS) + (size_t)l * D, grad(gRLNB) + (size_t)l * D, acc);
      mma_gemm_tA(P3, wd, P4, wd, ab, D, D, grad(gWR2) + (size_t)l * D * D, D, acc,
                  grad(gBR2) + (size_t)l * D, acc);
      __syncthreads();
      mma_gemm_tB(P4, wd, ab, D, a.wr2 + (size_t)l * D * D, D, D, D, [&](int r, int c, float4 v) {
        const float* s = P2 + r * wd + c;
        store4(P3 + r * wd + c, make_float4(v.x * swish_grad(s[0]), v.y * swish_grad(s[1]),
                                            v.z * swish_grad(s[2]), v.w * swish_grad(s[3])));
      });
      __syncthreads();
      mma_gemm_tA(P1, wd, P3, wd, ab, D, D, grad(gWR1) + (size_t)l * D * D, D, acc,
                  grad(gBR1) + (size_t)l * D, acc);
      mma_gemm_tB(P3, wd, ab, D, a.wr1 + (size_t)l * D * D, D, D, D, [&](int r, int c, float4 v) {
        float* p = P5 + r * wd + c;
        store4(p, make_float4(p[0] + v.x, p[1] + v.y, p[2] + v.z, p[3] + v.w));
      });
      __syncthreads();
      // attention LayerNorm backward: d ctx = d query = LN'(d o1) -> sDQ
      for (int m = warp; m < ab; m += kWarps) {
        float dy[4], xh[4], dx[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          xh[i] = d < D ? P0[m * wd + d] : 0.f;
          dy[i] = d < D ? P5[m * wd + d] : 0.f;
        }
        warp_ln_backward(xh, oinv[m], dy, lns, D, lane, dx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            sDQ[m * wd + d] = dx[i];
            sPart[(warp * 2) * wd + d] += dy[i] * xh[i];
            sPart[(warp * 2 + 1) * wd + d] += dy[i];
          }
        }
      }
      load_rows(sCb, c_in, ab0, ab);
      __syncthreads();
      flush_ln(grad(gLNS) + (size_t)l * D, grad(gLNB) + (size_t)l * D, acc);
      project_atoms(l, sCb, ab);
      __syncthreads();

      // ---- the block's (atom, neighbour) rows, chunk by chunk ----------------
      for (int m0 = ab0; m0 < ab0 + ab; m0 += CA, ++ci) {
        const int ca = min(CA, ab0 + ab - m0), rows = ca * N, base = m0 * N, lm0 = m0 - ab0;
        stage_chunk(l, m0, rows, c_in, D);
        row_forward(l, m0, lm0, ca, false);
        // d attn = mask * nmask * sum_{d in head} d ctx * key, then the softmax
        // backward over the N neighbours, on the pre-dropout attention
        warp_softmax_backward(sDQ + lm0 * wd, wd, sW, ldu, nmask + base,
                              a.attn_dropout ? sM : nullptr, sE, sF, ca, N, H, hd);
        __syncthreads();
        // d key (in place of the key) and d query = d ctx + dk sum_n de key
        for (int i = tid; i < ca * D; i += kThreads) {
          const int at = i / D, d = i - at * D, h = d / hd, m = lm0 + at;
          const float dctx = sDQ[m * wd + d];
          const float qs = sQ[m * wd + d] * a.dk;
          float ex = 0.f;
          for (int n = 0; n < N; ++n) {
            const int r = at * N + n;
            const float de = sF[r * H + h];
            const float used = a.attn_dropout ? sE[r * H + h] * sM[r * H + h] : sE[r * H + h];
            ex += de * sW[r * ldu + d];
            sW[r * ldu + d] = dctx * used * nmask[base + r] + de * qs;
          }
          sDQ[m * wd + d] = dctx + ex * a.dk;
        }
        __syncthreads();
        // key = kin @ Wk + bk
        mma_gemm_tA(sV, ldu, sW, ldu, rows, D, D, grad(gWK) + (size_t)l * D * D, D, ci > 0, sAcc, true);
        __syncthreads();
        mma_gemm_tB(sW, ldu, rows, D, wk, D, D, D, [&](int r, int c, float4 v) { store4(sV + r * ldu + c, v); });
        __syncthreads();
        if (a.g_update) {
          // kin = ns * geo', geo' = LN_g(swish(u_pre) + geo)
          const float* gs = a.lng_s + (size_t)l * D;
          const float* gb = a.lng_b + (size_t)l * D;
          for (int r = warp; r < rows; r += kWarps) {
            float v[4], xh[4], dy[4], dx[4], mean, inv;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int d = lane + 32 * i;
              v[i] = d < D ? swishf(sU[r * ldu + d]) + sA[r * lda + d] : 0.f;
            }
            warp_ln_stats(v, D, lane, mean, inv);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int d = lane + 32 * i;
              xh[i] = d < D ? (v[i] - mean) * inv : 0.f;
              dy[i] = 0.f;
              if (d < D) {
                const float g = xh[i] * gs[d] + gb[d];
                const float dkin = sV[r * ldu + d], ns = sA[r * lda + D + d];
                sV[r * ldu + d] = dkin * g;   // d ns from the key input
                dy[i] = dkin * ns + (l + 1 < L ? dgb[(size_t)(base + r) * D + d] : 0.f);
              }
            }
            warp_ln_backward(xh, inv, dy, gs, D, lane, dx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int d = lane + 32 * i;
              if (d < D) {
                sW[r * ldu + d] = dx[i];                                  // d r (residual into geo)
                sU[r * ldu + d] = dx[i] * swish_grad(sU[r * ldu + d]);    // d u_pre
                sPart[(warp * 2) * wd + d] += dy[i] * xh[i];
                sPart[(warp * 2 + 1) * wd + d] += dy[i];
              }
            }
          }
        } else {
          for (int i = tid; i < rows * D; i += kThreads) {
            const int r = i / D, d = i - r * D;
            const float u = sU[r * ldu + d], w = nweight[base + r];
            const float dkin = sV[r * ldu + d];
            sV[r * ldu + d] = dkin * (swishf(u) * w);
            sU[r * ldu + d] = dkin * sA[r * lda + D + d] * w * swish_grad(u);
          }
        }
        __syncthreads();
        if (a.g_update) {
          mma_gemm_tA(sA, lda, sU, ldu, rows, 2 * D, D,
                      grad(gWFG) + (size_t)l * fg_in * D + (size_t)D * D, D, ci > 0, sAcc + wd, true);
          for (int i = tid; i < ca * D; i += kThreads) {
            const int at = i / D, d = i - at * D;
            float s = 0.f;
            for (int n = 0; n < N; ++n) s += sU[(at * N + n) * ldu + d];
            sDCW[(lm0 + at) * wd + d] = s;
          }
          // d geo_in = d r + d u_pre @ Wg^T;  d ns += d u_pre @ Wn^T
          float* dg_out = dgb + (size_t)base * D;
          mma_gemm_tB(sU, ldu, rows, D, wfg + (size_t)D * D, D, D, D, [&](int r, int c, float4 v) {
            const float* dr = sW + r * ldu + c;
            store4(dg_out + (size_t)r * D + c, make_float4(dr[0] + v.x, dr[1] + v.y, dr[2] + v.z, dr[3] + v.w));
          });
          mma_gemm_tB(sU, ldu, rows, D, wfg + (size_t)2 * D * D, D, D, D, [&](int r, int c, float4 v) {
            float* p = sV + r * ldu + c;
            store4(p, make_float4(p[0] + v.x, p[1] + v.y, p[2] + v.z, p[3] + v.w));
          });
        } else {
          mma_gemm_tA(sA, lda, sU, ldu, rows, K, D, grad(gWFG) + (size_t)l * fg_in * D, D, ci > 0,
                      sAcc + wd, true);
        }
        __syncthreads();
        // the gather's transpose: d centers[idx] += d ns, in row order
        if (sc_part < np)
          for (int r = 0; r < rows; ++r) {
            const int idx = nbr[base + r];
            if (idx % np == sc_part) sDCN[idx * wd + sc_d] += sV[r * ldu + sc_d];
          }
        __syncthreads();
      }

      // ---- per-atom gradients of the block -----------------------------------
      if (a.g_update) flush_ln(grad(gLNGS) + (size_t)l * D, grad(gLNGB) + (size_t)l * D, acc);
      mma_gemm_tA(sCb, wd, sDQ, wd, ab, D, D, grad(gWQ) + (size_t)l * D * D, D, acc,
                  grad(gBQ) + (size_t)l * D, acc);
      if (a.g_update)
        mma_gemm_tA(sCb, wd, sDCW, wd, ab, D, D, grad(gWFG) + (size_t)l * fg_in * D, D, acc);
      mma_gemm_tB(sDQ, wd, ab, D, a.wq + (size_t)l * D * D, D, D, D, [&](int r, int c, float4 v) {
        float* p = sDCN + (ab0 + r) * wd + c;
        store4(p, make_float4(p[0] + v.x, p[1] + v.y, p[2] + v.z, p[3] + v.w));
      });
      __syncthreads();
      if (a.g_update) {
        mma_gemm_tB(sDCW, wd, ab, D, wfg, D, D, D, [&](int r, int c, float4 v) {
          float* p = sDCN + (ab0 + r) * wd + c;
          store4(p, make_float4(p[0] + v.x, p[1] + v.y, p[2] + v.z, p[3] + v.w));
        });
      }
      __syncthreads();
    }
    for (int d = tid; d < D; d += kThreads) {
      grad(gBK)[(size_t)l * D + d] = sAcc[d];
      grad(gBFG)[(size_t)l * D + d] = sAcc[wd + d];
    }
    // d (this layer's input) is d (the output of the layer below): for this
    // block's atoms, the sum of the cluster's partial rows in rank order
    if (C > 1) cluster.sync();
    for (int i = tid; i < (m_hi - m_lo) * q4; i += kThreads) {
      const int m = m_lo + i / q4, c = (i % q4) * 4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < C; ++q) {
        const float* part = C > 1 ? cluster.map_shared_rank(sDCN, q) : sDCN;
        const float4 v = *reinterpret_cast<const float4*>(part + m * wd + c);
        s = q == 0 ? v : make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
      }
      store4(dcen + (size_t)m * D + c, s);
      store4(sDCN + m * wd + c, s);
    }
    if (C > 1) cluster.sync();
    __syncthreads();
  }

  // ======================= embedding backward ===============================
  for (int ab0 = m_lo; ab0 < m_hi; ab0 += AB) {
    const int ab = min(AB, m_hi - ab0);
    const bool acc = ab0 > m_lo;
    float* E1 = work + AB * (2 * lde + ldf);   // d s_de [AB, wd]
    float* E2 = work + AB * (lde + ldf);       // d emb  [AB, lde]
    stage_embedding(ab0, ab);
    mma_gemm(sEmb, lde, ab, ke, a.wde, D, D, [&](int r, int c, float4 v) {
      const float4 m = mask4(0, ab0 + r, c);
      const float* dc = sDCN + (ab0 + r) * wd + c;
      store4(E1 + r * wd + c,
             make_float4(dc[0] * m.x * swish_grad(v.x + a.bde[c]),
                         dc[1] * m.y * swish_grad(v.y + a.bde[c + 1]),
                         dc[2] * m.z * swish_grad(v.z + a.bde[c + 2]),
                         dc[3] * m.w * swish_grad(v.w + a.bde[c + 3])));
    });
    __syncthreads();
    mma_gemm_tA(sEmb, lde, E1, wd, ab, ke, D, grad(gWDE), D, acc, grad(gBDE), acc);
    mma_gemm_tB(E1, wd, ab, D, a.wde, D, lde, ke, [&](int r, int c, float4 v) {
      store4(E2 + r * lde + c, v);
    });
    __syncthreads();
    if (a.cgcnn) {
      mma_gemm_tA(sFeat, ldf, E2, lde, ab, a.F, a.E, grad(gEMBED), a.E, acc, grad(gBEMBED), acc);
    } else {
      // the one-hot embedding's transpose: scatter d emb into the rows of Z
      float* ge = grad(gEMBED);
      for (int e = tid; e < a.E; e += kThreads) {
        if (!acc)
          for (int z = 0; z < a.V; ++z) ge[(size_t)z * a.E + e] = 0.f;
        for (int m = 0; m < ab; ++m)
          ge[(size_t)a.atomic[(size_t)b * M + ab0 + m] * a.E + e] += E2[m * lde + e];
      }
    }
    if (a.use_ring) {
      for (int i = tid; i < 30; i += kThreads) {
        const int k = i / 10, j = i - k * 10;   // k == 2: the bias
        float s = 0.f;
        for (int m = 0; m < ab; ++m) {
          const float dr = E2[m * lde + a.E + j];
          s += k < 2 ? a.ring[((size_t)b * M + ab0 + m) * 2 + k] * dr : dr;
        }
        float* dst = k < 2 ? grad(gWRING) + k * 10 + j : grad(gBRING) + j;
        *dst = acc ? *dst + s : s;
      }
    }
    __syncthreads();
  }

  // ======================= SCANN+ geometry embedding backward ===============
  if (a.g_update) {
    int ci = 0;
    for (int m0 = m_lo; m0 < m_hi; m0 += CA, ++ci) {
      const int ca = min(CA, m_hi - m0), rows = ca * N, base = m0 * N;
      stage_rbf(base, rows);
      __syncthreads();
      geometry_products(rows);
      __syncthreads();
      for (int i = tid; i < rows * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        const float g = dgb[(size_t)base * D + i], snd = sU[r * ldu + d], snw = sV[r * ldu + d];
        sU[r * ldu + d] = g * swishf(snw) * swish_grad(snd);
        sV[r * ldu + d] = g * swishf(snd) * swish_grad(snw);
      }
      __syncthreads();
      mma_gemm_tA(sA, lda, sU, ldu, rows, K, D, grad(gWND), D, ci > 0, grad(gBND), ci > 0);
      mma_gemm_tA(sA + D, lda, sV, ldu, rows, K, D, grad(gWNW), D, ci > 0, grad(gBNW), ci > 0);
      __syncthreads();
    }
  }
}

// The sizes make_plan reads, from the wrapper's list of sizes.
void set_dims(Args& a, const int* dims) {
  a.B = dims[0]; a.M = dims[1]; a.N = dims[2]; a.D = dims[3]; a.H = dims[4];
  a.E = dims[5]; a.K = dims[6]; a.G = dims[7]; a.O = dims[8]; a.L = dims[9];
  a.F = dims[10]; a.cgcnn = dims[12]; a.use_ring = dims[13]; a.chunk_atoms = dims[18];
  a.atom_block = dims[21];
}

// The launch of C blocks per structure, shared by the launcher and the
// occupancy query.
void cluster_launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int B, int C,
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
  cfg.numAttrs = 1;
}

}  // namespace

extern "C" int scann_loop_backward_shared_bytes(const int* dims) {
  Args a = {};
  set_dims(a, dims);
  return make_plan(a).total * (int)sizeof(float);
}

// How many clusters of `cluster` blocks with this shape's shared memory the
// card runs at once (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int scann_loop_backward_max_clusters(const int* dims, int cluster) {
  Args a = {};
  set_dims(a, dims);
  const int bytes = make_plan(a).total * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(scann_loop_backward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch_config(cfg, attr, a.B, cluster, bytes, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, scann_loop_backward_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// The pointers, sizes, scalars, random-stream words and offsets are those of
// unpack_backward_args (scann_grad_common.cuh), followed by pointer 54, the
// d(layer output) scratch [B, M, D], size 21, the atom block, and size 22, the
// blocks per structure C (grad_rows is then [B * C, P]); in the order
// scann_tpu_torch/kernels/scann_loop.py passes them. Launches the backward
// kernel (a cluster of C blocks per structure) and the reduction of its
// gradient rows into out [P].
extern "C" int scann_loop_backward_launch(void* const* ptrs, const int* dims,
                                          const float* scalars, const unsigned int* rng,
                                          const long long* offsets, float* out, void* stream) {
  Args a;
  unpack_backward_args(a, ptrs, dims, scalars, rng, offsets);
  a.dcenters = (float*)ptrs[54];
  a.atom_block = dims[21];
  a.cluster = dims[22];
  if (a.M < 1 || a.N < 1 || a.L < 1 || a.chunk_atoms < 1 ||
      a.chunk_atoms * a.N > kMaxChunkRows || a.atom_block < 1 ||
      a.atom_block > kMaxAtomBlock || a.chunk_atoms > a.atom_block ||
      a.cluster < 1 || a.cluster > kMaxCluster ||
      a.D > 128 || a.G > 128 || a.O > 128 || (a.D & 3) || (a.G & 3) || (a.O & 3) || (a.E & 3) ||
      a.D % a.H || a.K > a.D || a.P <= 0)
    return kErrShape;
  const int bytes = make_plan(a).total * (int)sizeof(float);
  if (bytes > kMaxSharedBytes) return kErrSharedMemory;
  cudaError_t err = cudaFuncSetAttribute(scann_loop_backward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch_config(cfg, attr, a.B, a.cluster, bytes, s);
  err = cudaLaunchKernelEx(&cfg, scann_loop_backward_kernel, a);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce_rows(a.grad_rows, a.B * a.cluster, a.P, out, s);
}

extern "C" const char* scann_loop_backward_error_string(int code) {
  if (code == kErrSharedMemory) return "shared-memory plan exceeds 227 KB per block";
  if (code == kErrShape) return "shape outside what the kernel takes";
  return cudaGetErrorString((cudaError_t)code);
}
