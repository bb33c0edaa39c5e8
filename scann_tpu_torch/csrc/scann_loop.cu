// Whole-model SCANN / SCANN+ forward for crystals, a cluster of CUDA blocks
// per structure.
//
// Replaces the TPU kernel scann_tpu/kernels/scann_loop.py:_fwd_kernel (the
// Pallas loop forward). It computes what
// scann_forward.cu computes (embedding, Gaussian RBF geometry, L x
// (LocalAttention + ResidualNorm), after_Lc, the GA readout, the property
// head, the Philox dropout masks of philox.cuh), for structures too large for
// that kernel's shared-memory plan: MP2018 at (M=96, N=32, L=9) and Pt/graphene
// at (M=128, N=32, L=11), D=128. Outputs pred [B] and ga [B, M], f32; for
// a packed batch (S > 0 segments per slot, each row's segment in seg [B, M])
// the readout runs per segment (seg_scores of scann_common.cuh; the TPU
// kernel's scann_loop.py:367-395) and pred is [B, S].
//
// Bound. At the MP2018 serving shape (B=64, M=96, N=32, L=9, D=128) the
// products are ~1.85e11 FLOP. They run on the tensor cores in three TF32
// passes to keep f32 accuracy, so at the H100 SXM's dense 495 TFLOP/s TF32
// they take at least ~1.13 ms (the 0.5% that runs on the CUDA cores, the
// energies and context, counted at 67 TFLOP/s FP32). The SCANN+ geometry
// scratch [B, M*N, D] is 100 MB at that shape, twice the card's 50 MB of
// L2, so each layer reads
// and writes it in HBM: 1.8 GB over the 9 layers, ~0.55 ms at 3.35 TB/s,
// below the operations bound; loop_forward_bytes counts it.
//
// Design.
// - A cluster of C blocks per structure (C = 1, 2 or 4, chosen by the wrapper
//   from the batch size, so that a batch of 64 fills 128 of the card's 132
//   SMs). Each block owns a contiguous range of the structure's atoms; what
//   crosses blocks is the new centers of a layer: each block writes its
//   atoms' rows to a global scratch [B, M, D], then a cluster barrier, then
//   every block reloads all M rows, then a second barrier before the scratch
//   is written again.
// - Only the current centers [M, max(D, G)] stay in shared memory for the
//   whole layer, because every atom's gather may read any row of them. All
//   other per-atom state (query, cw, the ResidualNorm hidden) exists for one
//   block of AB <= 32 atoms at a time, in two slots of stride max(D, G) + 4.
//   The plan is M * 512 bytes + 108 to 133 KB at D=128 (atom blocks of 8 to
//   32): M <= 237 at N=32.
// - Within an atom block the (atom, neighbour) rows go through fwd_chunk
//   (scann_forward_common.cuh) in chunks of at most 64 rows: split-TF32
//   mma.sync products, the softmax one warp per (atom, head), the context
//   one thread per (atom, column); the SCANN+ geometry is streamed from and
//   to the global scratch.
// - Tall structures (N <= kFwdMaxChunkRows, M past that plan; the tall build,
//   scann_loop_tall.cu, both operand modes): the centers leave shared memory. A
//   layer's input centers sit in one half of a ping-pong global scratch [2, B,
//   M, D] (L2 holds it: 14 MB at B = 64, M = 428) and its new centers go to
//   the other half, so one cluster barrier a layer suffices: no block
//   writes the rows others still gather. The gather reads those rows past L1
//   (another SM wrote them, and this SM may hold a line of them from two
//   layers before); the per-atom projections and the readout's after_Lc
//   stage a block's rows into a slot first (cp.async, past L1 too); the GA
//   keys go to the block's own slice of a global [B * C, M, G] scratch. The
//   arithmetic and the order of every sum are the narrow build's, so at a
//   shape both builds take, with the same atom block and C, the outputs are
//   the same bits. The plan drops the M * 512 bytes: atom blocks of 32 for M
//   into the thousands.
// - Wide neighbour lists (64 < N <= 256; the wide build, scann_loop_wide.cu):
//   one atom at a time through fwd_atom_wide, its rows in sub-chunks of 64,
//   its energies [N, H] in shared memory (8 KiB at N = 256) for a softmax over
//   all N, its keys in a per-block global scratch [B * C, N, D] read back for
//   the context; the plan's chunk region is a sub-chunk's buffers and that
//   energy row, so M reaches 225-235 at D = 128 for every N up to 256.
// - The readout (after_Lc, GA queries and keys, the scores, the pooled
//   context, the head) runs over all M atoms in every block of the cluster,
//   in the same order, so every block has the scores; rank 0 writes pred and
//   each block the GA scores of its own atoms. Launches at one C repeat bit
//   for bit.
//
// bf16 operand mode (model.dtype "bfloat16"): a second instantiation, kBf16,
// rounds the operands of every product to bfloat16 and sums in f32 where and
// as the TPU kernel's dots do (scann_forward_common.cuh); every build (narrow,
// wide, tall) holds both instantiations and a launch picks one. The wide
// build's atom walk (fwd_atom_wide) rounds where fwd_chunk does: the gathered
// neighbour states as they are staged, each q * k lane before the head sum
// (warp_energies), the attention before the context; the context reads the
// unrounded keys back from the block's scratch, as fwd_chunk reads them from
// shared memory. Unlike the
// molecule kernel, the TPU loop kernel pools a packed slot's segments with
// bf16-mode products (scann_loop.py:367-395), so here the pools round their
// terms and pooled values too, and the softmax is shifted by each segment's
// own max rounded to bfloat16 (seg_scores<true>).
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// given stream, synchronises nothing, allocates nothing, and returns the
// cudaGetLastError() code of the launch (or kErrSharedMemory / kErrShape).

#include <cooperative_groups.h>

#include "scann_forward_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace scann;

constexpr int kMaxAtomBlock = 32;
constexpr int kMaxCluster = 4;

// The tall build (scann_loop_tall.cu defines SCANN_LOOP_TALL): the centers in
// global memory; every other build keeps them in shared memory.
#ifdef SCANN_LOOP_TALL
constexpr bool kTall = true;
#else
constexpr bool kTall = false;
#endif

// Shared-memory plan, in floats: centers [M, wd] (none in the tall build);
// two per-block slots [AB, wd + 4]; the work region: a chunk's buffers (wide:
// a sub-chunk's and the atom's energy row), the embedding's staging, the
// ResidualNorm's h2 [AB, wd + 4], or the readout's [AB, wd] block and
// vectors.
struct Plan {
  int wd, lds, rows, lde, ldf, work, offQ, offW, offWork, total;
};

template <bool kWide>
__host__ __device__ inline Plan make_plan(const ForwardArgs& a) {
  Plan p;
  const int AB = a.atom_block;
  p.wd = a.D > a.G ? a.D : a.G;
  p.lds = p.wd + 4;
  p.rows = kWide ? kFwdMaxChunkRows : a.chunk_atoms * a.N;
  p.lde = round4(a.E + (a.use_ring ? 10 : 0));
  p.ldf = a.cgcnn ? round4(a.F) : 0;
  int w = kWide ? fwd_wide_chunk_floats(a.N, a.D, a.H) : fwd_chunk_floats(p.rows, a.D, a.H);
  const int embed = AB * (p.lde + p.ldf);
  const int residual = AB * p.lds;
  const int readout = AB * p.wd + 2 * p.wd + 2 * round4(a.M) + round4(a.O);
  const int seg_readout = AB * p.wd + seg_forward_floats(a.S, p.wd, a.M, a.O);
  w = embed > w ? embed : w;
  w = residual > w ? residual : w;
  w = readout > w ? readout : w;
  if (a.S) w = seg_readout > w ? seg_readout : w;
  p.work = w;
  p.offQ = kTall ? 0 : a.M * p.wd;
  p.offW = p.offQ + AB * p.lds;
  p.offWork = p.offW + AB * p.lds;
  p.total = p.offWork + w;
  return p;
}

// The plan of either build, by N (host side).
inline Plan plan_of(const ForwardArgs& a) {
  return a.N > kFwdMaxChunkRows ? make_plan<true>(a) : make_plan<false>(a);
}

// kWide: N > kFwdMaxChunkRows (the wide build, scann_loop_wide.cu), one atom
// at a time through fwd_atom_wide with the block's keys in wide_keys [N, D]
// (global, one slice a block). kTall (the tall build): wide_keys is the GA
// key scratch [B * C, M, G], one slice a block, and a.next_centers the
// ping-pong centers [2, B, M, D].
template <bool kBf16, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
scann_loop_forward_kernel(const ForwardArgs a, const int C, float* wide_keys) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan P = make_plan<kWide>(a);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int M = a.M, N = a.N, D = a.D, H = a.H, G = a.G, O = a.O;
  const int wd = P.wd, lds = P.lds, CA = a.chunk_atoms, AB = a.atom_block;
  const int lda = 2 * D + 4, ldu = D + 4, q4 = D / 4;
  const unsigned int mol = a.mol_base + (unsigned int)b;
  // this block's atoms: the rank-th of C contiguous ranges
  const int per = (M + C - 1) / C;
  const int m_lo = min(M, rank * per), m_hi = min(M, m_lo + per);
  // the [M, D] embedding and residual masks: quad (r, c..c+3) is one Philox
  // output, since D and c are multiples of 4
  auto mask4 = [&](int stream, int r, int c) {
    if (!a.dropout) return make_float4(1.f, 1.f, 1.f, 1.f);
    return scann_philox::mask_quad(a.seed, mol, stream, (unsigned)(r * D + c) >> 2,
                                   a.drop_threshold, a.drop_scale);
  };
  // between the blocks of the cluster: every block's writes to the global
  // scratch are seen by every block after it
  auto cluster_barrier = [&]() {
    if (C > 1) cluster.sync();
    else __syncthreads();
  };
  float* sC = smem;               // centers / GA keys  [M, wd] (not tall)
  float* sQ = smem + P.offQ;      // query / out        [AB, lds]
  float* sW = smem + P.offW;      // cw, then h1        [AB, lds]
  float* work = smem + P.offWork;
  float* sA = work;                        // chunk operand [rows, 2D + 4]
  float* sU = sA + P.rows * lda;           // chunk product [rows, D + 4]
  float* sE = sU + P.rows * ldu;           // attention     [rows, H]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float* am = a.atom_mask + (size_t)b * M;
  const int* nbr = a.nbr + (size_t)b * M * N;
  const float* nmask = a.nmask + (size_t)b * M * N;
  const float* nweight = a.nweight + (size_t)b * M * N;
  const float* ndist = a.ndist + (size_t)b * M * N;
  float* geo_b = a.geo + (size_t)b * M * N * D;
  float* next_b = a.next_centers + (size_t)b * M * D;
  // tall: the centers of layer l's input, half l & 1 of the ping-pong scratch
  // (half 0 is next_b), and this block's GA keys
  auto centers_of = [&](int l) {
    return a.next_centers + ((size_t)(l & 1) * a.B + b) * M * D;
  };
  float* const keys_b = kTall ? wide_keys + (size_t)blockIdx.x * M * G : sC;
  const int ldk = kTall ? G : wd;
  // tall: rows [m0, m0 + n) of layer l's input centers into dst [n, ld], past
  // L1; the caller synchronises
  auto stage_rows = [&](float* dst, int ld, int l, int m0, int n) {
    const float* src = centers_of(l) + (size_t)m0 * D;
    for (int i = tid; i < n * q4; i += kThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      cp_async16(dst + r * ld + c, src + (size_t)r * D + c);
    }
    cp_async_wait_all();
  };
  // all M rows of the scratch into the centers, past L1 (the rows of the other
  // blocks were written on other SMs), every copy of a thread in flight at once
  auto load_centers = [&]() {
    for (int i = tid; i < M * q4; i += kThreads) {
      const int m = i / q4, c = (i - m * q4) * 4;
      cp_async16(sC + m * wd + c, next_b + (size_t)m * D + c);
    }
    cp_async_wait_all();
  };

  // ---- atom embedding of this block's atoms -> the scratch ----------------
  const int ke = a.E + (a.use_ring ? 10 : 0);
  for (int ab0 = m_lo; ab0 < m_hi; ab0 += AB) {
    const int ab = min(AB, m_hi - ab0);
    fwd_stage_embedding<kBf16>(a, b, ab0, ab, work, P.lde, work + AB * P.lde, P.ldf);
    mma_gemm<kBf16>(work, P.lde, ab, ke, a.wde, D, D, [&](int r, int c, float4 v) {
      const float4 m = mask4(0, ab0 + r, c);
      store4(next_b + (size_t)(ab0 + r) * D + c,
             make_float4(swishf(v.x + a.bde[c]) * m.x, swishf(v.y + a.bde[c + 1]) * m.y,
                         swishf(v.z + a.bde[c + 2]) * m.z, swishf(v.w + a.bde[c + 3]) * m.w));
    });
    __syncthreads();
  }

  // ---- SCANN+ geometry embedding of this block's atoms -> global scratch --
  if constexpr (kWide) {
    // row by row: rows [m_lo N, m_hi N) as atoms of one neighbour each, in
    // sub-chunks of kFwdMaxChunkRows
    ForwardArgs by_row = a;
    by_row.N = 1;
    by_row.chunk_atoms = kFwdMaxChunkRows;
    if (a.g_update)
      fwd_embed_geometry<kBf16>(by_row, sA, sU, ndist, nweight, geo_b, m_lo * N, m_hi * N);
  } else {
    if (a.g_update) fwd_embed_geometry<kBf16>(a, sA, sU, ndist, nweight, geo_b, m_lo, m_hi);
  }
  cluster_barrier();
  if constexpr (!kTall) {
    load_centers();
    cluster_barrier();
  }

  // ---- L x (LocalAttention + ResidualNorm) -------------------------------
  for (int l = 0; l < a.L; ++l) {
    const LayerWeights w = layer_weights(a, l);
    const float* wq = a.wq + (size_t)l * D * D;
    const float* bq = a.bq + (size_t)l * D;
    // the gather's rows: the resident centers, or (tall) the global ones
    const float* cen = kTall ? centers_of(l) : sC;
    const int ldc = kTall ? D : wd;
    float* out_b = kTall ? centers_of(l + 1) : next_b;

    for (int ab0 = m_lo; ab0 < m_hi; ab0 += AB) {
      const int ab = min(AB, m_hi - ab0);
      // per-atom projections of the block: cw = centers @ Wfg[0:D] (SCANN+),
      // query (tall: from the block's rows staged in the work region)
      const float* cb = sC + ab0 * wd;
      if constexpr (kTall) {
        stage_rows(work, wd, l, ab0, ab);
        __syncthreads();
        cb = work;
      }
      if (a.g_update)
        mma_gemm<kBf16>(cb, wd, ab, D, w.wfg, D, D,
                        [&](int r, int c, float4 v) { store4(sW + r * lds + c, v); });
      mma_gemm<kBf16>(cb, wd, ab, D, wq, D, D, [&](int r, int c, float4 v) {
        store4(sQ + r * lds + c,
               make_float4(v.x + bq[c], v.y + bq[c + 1], v.z + bq[c + 2], v.w + bq[c + 3]));
      });
      __syncthreads();

      if constexpr (kWide) {
        for (int m = ab0; m < ab0 + ab; ++m) {
          const int base = m * N;
          fwd_atom_wide<kBf16, float>(
              forward_chunk_dims(a), w,
              [&](int n0, int rows) {
                fwd_stage_chunk<kBf16>(a, sA, cen, ldc, nbr, ndist, geo_b, base + n0, rows);
              },
              sA, sU, sE, sW + (m - ab0) * lds, sQ + (m - ab0) * lds, nmask + base,
              nweight + base, l + 1 < a.L ? geo_b + (size_t)base * D : nullptr, nullptr,
              wide_keys + (size_t)blockIdx.x * N * D, [&](int n, int h) {
                return scann_philox::mask_value(a.seed, mol, 1 + a.L + l,
                                                (unsigned)((base + n) * H + h),
                                                a.attn_threshold, a.attn_scale);
              });
        }
      } else {
        for (int m0 = ab0; m0 < ab0 + ab; m0 += CA) {
          const int ca = min(CA, ab0 + ab - m0), base = m0 * N;
          fwd_stage_chunk<kBf16, kTall>(a, sA, cen, ldc, nbr, ndist, geo_b, base, ca * N);
          fwd_chunk<kBf16, float>(forward_chunk_dims(a), w, ca, sA, sU, sE, sW + (m0 - ab0) * lds,
                    sQ + (m0 - ab0) * lds, lds, nmask + base, nweight + base,
                    l + 1 < a.L ? geo_b + (size_t)base * D : nullptr, nullptr,
                    [&](int at, int n, int h) {
                      return scann_philox::mask_value(
                          a.seed, mol, 1 + a.L + l, (unsigned)((base + at * N + n) * H + h),
                          a.attn_threshold, a.attn_scale);
                    });
        }
      }

      // ResidualNorm of the block: next = LN(out + swish(out @ W1 + b1) @ W2 + b2)
      fwd_residual_norm<kBf16>(a, l, ab, sQ, sW, work, lds,
                        [&](int r, int c) { return mask4(1 + l, ab0 + r, c); },
                        [&](int m, const float (&v)[4]) {
#pragma unroll
                          for (int i = 0; i < 4; ++i)
                            if (lane + 32 * i < D)
                              out_b[(size_t)(ab0 + m) * D + lane + 32 * i] = v[i];
                        });
    }

    // every atom of the structure has gathered from this layer's input and
    // every block has written its atoms' new centers: take all M rows (tall:
    // the barrier alone; the next layer writes the other half)
    cluster_barrier();
    if constexpr (!kTall) {
      load_centers();
      cluster_barrier();
    }
  }

  // ---- readout: after_Lc, GA scores, pooled context, head ----------------
  // over all M atoms in every block, in the same order
  float* RB = work;                    // cg = swish(cL @ Wal + bal) of an atom block [AB, wd]
  float* qsum = work + AB * wd;        // [G]  sum_m mask * gq
  float* struc = qsum + wd;            // [G]  pooled context
  float* score = struc + wd;           // [M]  agg, then ga
  float* diag = score + round4(M);     // [M]  (mask k) . (mask q)
  float* hid = diag + round4(M);       // [O]
  // a packed slot: per-segment vectors past the block [AB, wd]
  const int S = a.S;
  const int* sid = S ? a.seg + (size_t)b * M : nullptr;
  const SegVectors v = seg_vectors(work + AB * wd, S, wd, M, O, false);
  if (!S)
    for (int g = tid; g < G; g += kThreads) qsum[g] = 0.f;
  for (int ab0 = 0; ab0 < M; ab0 += AB) {
    const int ab = min(AB, M - ab0);
    // the block's last centers (tall: staged into the free slot sW)
    const float* cl = sC + ab0 * wd;
    int ldl = wd;
    if constexpr (kTall) {
      stage_rows(sW, lds, a.L, ab0, ab);
      __syncthreads();
      cl = sW;
      ldl = lds;
    }
    mma_gemm<kBf16>(cl, ldl, ab, D, a.wal, G, G, [&](int r, int c, float4 v) {
      store4(RB + r * wd + c, make_float4(swishf(v.x + a.bal[c]), swishf(v.y + a.bal[c + 1]),
                                          swishf(v.z + a.bal[c + 2]), swishf(v.w + a.bal[c + 3])));
    });
    __syncthreads();
    // the block's GA queries, and its GA keys in place of its centers
    mma_gemm<kBf16>(RB, wd, ab, G, a.wgq, G, G, [&](int r, int c, float4 v) {
      store4(sQ + r * lds + c, make_float4(v.x + a.bgq[c], v.y + a.bgq[c + 1],
                                           v.z + a.bgq[c + 2], v.w + a.bgq[c + 3]));
    });
    mma_gemm<kBf16>(RB, wd, ab, G, a.wgk, G, G, [&](int r, int c, float4 v) {
      store4(keys_b + (ab0 + r) * ldk + c, make_float4(v.x + a.bgk[c], v.y + a.bgk[c + 1],
                                                       v.z + a.bgk[c + 2], v.w + a.bgk[c + 3]));
    });
    __syncthreads();
    if (S) {
      seg_queries<kBf16>(v, S, sQ, lds, keys_b, ldk, am, sid, ab0, ab, G, ab0 == 0);
    } else {
      for (int g = tid; g < G; g += kThreads) {
        float s = qsum[g];
        for (int m = 0; m < ab; ++m) s += am[ab0 + m] * sQ[m * lds + g];
        qsum[g] = s;
      }
      for (int m = warp; m < ab; m += kWarps) {
        const float mm = am[ab0 + m];
        float dg = 0.f;
        for (int g = lane; g < G; g += 32)
          dg += (mm * keys_b[(ab0 + m) * ldk + g]) * (mm * sQ[m * lds + g]);
        dg = warp_sum(dg);
        if (lane == 0) diag[ab0 + m] = dg;
      }
    }
    __syncthreads();
  }
  if (S) {
    seg_readout_forward<kBf16, kBf16>(v, keys_b, ldk, am, sid, M, S, G, O, a.ga_norm, a.wbf,
                                      a.bbf, a.wp, a.bp, a.mrelu,
                                      rank == 0 ? a.pred + (size_t)b * S : nullptr);
    for (int m = m_lo + tid; m < m_hi; m += kThreads) a.ga[(size_t)b * M + m] = v.ga[m];
    return;
  }
  // agg_m = mask_m * ((mask_m k_m) . qsum - (mask_m k_m) . (mask_m q_m))
  for (int m = warp; m < M; m += kWarps) {
    const float mm = am[m];
    float cross = 0.f;
    for (int g = lane; g < G; g += 32) cross += (mm * keys_b[m * ldk + g]) * qsum[g];
    cross = warp_sum(cross);
    if (lane == 0) score[m] = mm * (cross - diag[m]);
  }
  __syncthreads();
  if (warp == 0) {
    // lane holds atoms lane, lane + 32, ...
    if (a.ga_norm) {
      float sq = 0.f;
      for (int m = lane; m < M; m += 32) sq += score[m] * score[m];
      float nrm = sqrtf(warp_sum(sq));
      if (nrm == 0.f) nrm = 1.f;   // single-atom structure: zero sum
      for (int m = lane; m < M; m += 32) score[m] /= nrm;
    }
    float mx = -INFINITY;
    for (int m = lane; m < M; m += 32) {
      score[m] += (1.0f - am[m]) * -1e9f;
      mx = fmaxf(mx, score[m]);
    }
    mx = warp_max(mx);
    float tot = 0.f;
    for (int m = lane; m < M; m += 32) {
      score[m] = expf(score[m] - mx);
      tot += score[m];
    }
    tot = warp_sum(tot);
    for (int m = lane; m < M; m += 32) {
      score[m] /= tot;
      if (m >= m_lo && m < m_hi) a.ga[(size_t)b * M + m] = score[m];
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += am[m] * score[m] * keys_b[m * ldk + g];
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
    if (lane == 0 && rank == 0) a.pred[b] = p;
  }
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

// The sizes make_plan reads, from the wrapper's list of sizes.
void set_dims(ForwardArgs& a, const int* dims) {
  a.B = dims[0]; a.M = dims[1]; a.N = dims[2]; a.D = dims[3]; a.H = dims[4];
  a.E = dims[5]; a.K = dims[6]; a.G = dims[7]; a.O = dims[8]; a.L = dims[9];
  a.F = dims[10]; a.cgcnn = dims[11]; a.use_ring = dims[12]; a.chunk_atoms = dims[16];
  a.atom_block = dims[20];
  a.S = dims[21];
}

}  // namespace

#if !defined(SCANN_LOOP_WIDE) && !defined(SCANN_LOOP_TALL)
extern "C" int scann_loop_forward_shared_bytes(const int* dims) {
  ForwardArgs a = {};
  set_dims(a, dims);
  return plan_of(a).total * (int)sizeof(float);
}

#endif

// The pointers, sizes, scalars and random-stream words are those of
// unpack_forward_args (scann_common.cuh), followed by pointer 49, the
// next-centers scratch [B, M, D], pointer 50, the segment ids [B, M] (null
// unless packed), pointer 51, the wide key scratch [B * C, N, D] (the wide
// build), or the GA key scratch [B * C, M, G] (the tall build, whose
// pointer 49 is the ping-pong centers [2, B, M, D]), null in the narrow one,
// size 20, the atom block, size 21, the
// segments per slot S, size 22, the bf16 operand mode (0 or 1), and size 23,
// the blocks per structure C; in the order
// scann_tpu_torch/kernels/scann_loop.py passes them. Size 17 (the chunk
// buffer) is the work region of make_plan. This file builds the narrow
// kernels (N <= kFwdMaxChunkRows); scann_loop_wide.cu includes it with
// SCANN_LOOP_WIDE defined and builds the wide one
// (scann_loop_forward_wide_launch, scann_loop_forward_wide_max_clusters), at
// the first wide launch; scann_loop_tall.cu with SCANN_LOOP_TALL, the tall
// one (scann_loop_forward_tall_*, N <= kFwdMaxChunkRows), at the first tall
// launch. Each build takes both operand modes.
#if defined(SCANN_LOOP_WIDE)
#define SCANN_LOOP_ENTRY(x) scann_loop_forward_wide_##x
constexpr bool kWideBuild = true;
#elif defined(SCANN_LOOP_TALL)
#define SCANN_LOOP_ENTRY(x) scann_loop_forward_tall_##x
constexpr bool kWideBuild = false;
#else
#define SCANN_LOOP_ENTRY(x) scann_loop_forward_##x
constexpr bool kWideBuild = false;
#endif

// The kernel of this build in the operand mode bf16 (0 or 1).
static auto build_kernel(int bf16) {
  return bf16 ? scann_loop_forward_kernel<true, kWideBuild>
              : scann_loop_forward_kernel<false, kWideBuild>;
}

// How many clusters of `cluster` blocks with this shape's shared memory the
// card runs at once (cudaOccupancyMaxActiveClusters) in this build's kernel
// of the operand mode in size 22, or minus the CUDA error.
extern "C" int SCANN_LOOP_ENTRY(max_clusters)(const int* dims, int cluster) {
  ForwardArgs a = {};
  set_dims(a, dims);
  if (dims[22] & ~1) return -(int)cudaErrorInvalidValue;
  const auto kernel = build_kernel(dims[22]);
  const int bytes = make_plan<kWideBuild>(a).total * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch_config(cfg, attr, a.B, cluster, bytes, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

extern "C" int SCANN_LOOP_ENTRY(launch)(void* const* ptrs, const int* dims, const float* scalars,
                                        const unsigned int* rng, void* stream) {
  ForwardArgs a;
  unpack_forward_args(a, ptrs, dims, scalars, rng);
  a.next_centers = (float*)ptrs[49];
  a.seg = (const int*)ptrs[50];
  float* wide_keys = (float*)ptrs[51];
  a.atom_block = dims[20];
  a.S = dims[21];
  const int bf16 = dims[22];
  const int C = dims[23];
  if (a.S < 0 || a.S > kMaxSegments || (a.S > 0) != (a.seg != nullptr)) return kErrShape;
  if (bf16 & ~1) return kErrShape;
  // the wide build: kFwdMaxChunkRows < N <= kWideMaxN, one atom a chunk, its
  // key scratch; the tall one: its GA key scratch
  if ((a.N > kFwdMaxChunkRows) != kWideBuild ||
      (wide_keys != nullptr) != (kWideBuild || kTall) ||
      (kWideBuild && (a.N > kWideMaxN || a.chunk_atoms != 1)))
    return kErrShape;

  if (a.M < 1 || a.N < 1 || a.L < 1 || a.chunk_atoms < 1 ||
      (!kWideBuild && a.chunk_atoms * a.N > kFwdMaxChunkRows) || a.atom_block < 1 ||
      a.atom_block > kMaxAtomBlock || a.chunk_atoms > a.atom_block ||
      C < 1 || C > kMaxCluster ||
      a.D > 128 || a.G > 128 || a.O > 128 || (a.D & 3) || (a.G & 3) || (a.O & 3) || (a.E & 3) ||
      a.D % a.H || a.K > a.D)
    return kErrShape;
  const Plan plan = make_plan<kWideBuild>(a);
  if (a.abuf_floats != plan.work) return kErrShape;   // the wrapper's plan is this one
  const int bytes = plan.total * (int)sizeof(float);
  if (bytes > kMaxSharedBytes) return kErrSharedMemory;
  const auto kernel = build_kernel(bf16);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch_config(cfg, attr, a.B, C, bytes, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, kernel, a, C, wide_keys);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* SCANN_LOOP_ENTRY(error_string)(int code) {
  if (code == kErrSharedMemory) return "shared-memory plan exceeds 227 KB per block";
  if (code == kErrShape) return "shape outside what the kernel takes";
  return cudaGetErrorString((cudaError_t)code);
}
