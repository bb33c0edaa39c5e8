// Whole-model SCANN / SCANN+ forward for crystals, one CUDA block per
// structure.
//
// Replaces the TPU kernel scann_tpu/kernels/scann_loop.py:_fwd_kernel (the
// Pallas loop forward) for unpacked batches. It computes what
// scann_forward.cu computes (embedding, Gaussian RBF geometry, L x
// (LocalAttention + ResidualNorm), after_Lc, the GA readout, the property
// head, the Philox dropout masks of philox.cuh), for structures too large for
// that kernel's shared-memory plan: MP2018 at (M=96, N=32, L=9) and Pt/graphene
// at (M=128, N=32, L=11), D=128. Outputs pred [B] and ga [B, M], f32.
//
// Bound. At the MP2018 serving shape (B=64, M=96, N=32, L=9, D=128) the work
// is ~1.85e11 FLOP of FP32 FMA against ~100 MB of geometry scratch that stays
// in L2 and a few MB of inputs and weights: bound by operations, ~2.8 ms at
// the H100 SXM's 67 TFLOP/s FP32 peak.
//
// Design. What separates it from scann_forward.cu is where the per-structure
// state lives.
// - Only the current centers [M, D] stay in shared memory for the whole
//   layer, because every atom's gather may read any row of them. All other
//   per-atom state (query, cw, the ResidualNorm hidden) exists for one block
//   of AB <= 32 atoms at a time: the layer walks the atom blocks, and each
//   block's new centers go to a global scratch [B, M, D] (a few MB, in L2)
//   that is copied back into shared memory when the layer is done. The plan
//   is M * 520 bytes + 107 to 131 KB at D=128 (atom blocks of 8 to 32), so
//   M <= 232 fits the 227 KB of a block.
// - Within an atom block the (atom, neighbour) rows go through
//   attention_chunk (scann_common.cuh) in chunks of at most 64 rows, with the
//   SCANN+ geometry streamed from and to a global scratch [B, M, N, D].
// - The embedding and the readout walk the same atom blocks; the GA keys
//   overwrite the centers block by block, the query sum and the per-atom
//   diagonal terms accumulate in shared memory.
// - One block per structure needs no barrier across blocks (a layer's gather
//   reads only its own structure), but a batch of 64 structures fills only 64
//   of the card's 132 SMs.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// given stream, synchronises nothing, allocates nothing, and returns the
// cudaGetLastError() code of the launch (or kErrSharedMemory / kErrShape).

#include "philox.cuh"
#include "scann_common.cuh"

namespace {

using namespace scann;

constexpr int kMaxChunkRows = 64;
constexpr int kMaxAtomBlock = 32;

// Shared-memory plan, in floats: centers [M, wd]; query and scratch
// [AB, wd]; the chunk operand buffer A (also the embedding staging area);
// the chunk product buffer U; energies [rows, H]; readout vectors.
struct Plan {
  int wd, rows, offQ, offW, offA, offU, offE, offMisc, total;
};

__host__ __device__ inline Plan make_plan(const ForwardArgs& a) {
  Plan p;
  p.wd = a.D > a.G ? a.D : a.G;
  p.rows = a.chunk_atoms * a.N;
  const int urows = p.rows > a.atom_block ? p.rows : a.atom_block;
  p.offQ = a.M * p.wd;
  p.offW = p.offQ + a.atom_block * p.wd;
  p.offA = p.offW + a.atom_block * p.wd;
  p.offU = p.offA + a.abuf_floats;
  p.offE = p.offU + urows * a.D;
  p.offMisc = p.offE + round4(p.rows * a.H);
  p.total = p.offMisc + 2 * p.wd + 2 * round4(a.M) + round4(a.O);
  return p;
}

__global__ void __launch_bounds__(kThreads, 1)
scann_loop_forward_kernel(const ForwardArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan P = make_plan(a);
  const int b = blockIdx.x;
  const int M = a.M, N = a.N, D = a.D, H = a.H, K = a.K, G = a.G, O = a.O;
  const int wd = P.wd, CA = a.chunk_atoms, AB = a.atom_block;
  const unsigned int mol = a.mol_base + (unsigned int)b;
  // the [M, D] embedding and residual masks: quad (r, c..c+3) is one Philox
  // output, since D and c are multiples of 4
  auto drop_quad = [&](int stream, int r, int c, float4 v) {
    if (!a.dropout) return v;
    const float4 m = scann_philox::mask_quad(a.seed, mol, stream, (unsigned)(r * D + c) >> 2,
                                             a.drop_threshold, a.drop_scale);
    return make_float4(v.x * m.x, v.y * m.y, v.z * m.z, v.w * m.w);
  };
  float* sC = smem;               // centers        [M, wd]
  float* sQ = smem + P.offQ;      // query / out    [AB, wd]
  float* sW = smem + P.offW;      // scratch        [AB, wd]
  float* sA = smem + P.offA;      // chunk operand  [rows, 2D]: geometry | neighbours/key
  float* sU = smem + P.offU;      // chunk product  [rows, D]
  float* sE = smem + P.offE;      // energies       [rows, H]
  float* sMisc = smem + P.offMisc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float* am = a.atom_mask + (size_t)b * M;
  const int* nbr = a.nbr + (size_t)b * M * N;
  const float* nmask = a.nmask + (size_t)b * M * N;
  const float* nweight = a.nweight + (size_t)b * M * N;
  const float* ndist = a.ndist + (size_t)b * M * N;
  float* geo_b = a.geo + (size_t)b * M * N * D;
  float* next_b = a.next_centers + (size_t)b * M * D;

  // ---- atom embedding -> centers = swish(emb @ Wde + bde) ----------------
  const int ke = a.E + (a.use_ring ? 10 : 0);
  const int lde = round4(ke);
  float* sEmb = sA;                                   // [AB, lde]
  for (int ab0 = 0; ab0 < M; ab0 += AB) {
    const int ab = min(AB, M - ab0);
    if (a.cgcnn) {
      const int F = a.F, ldf = round4(F);
      float* sFeat = sA + AB * lde;                   // [AB, ldf]
      for (int i = tid; i < ab * F; i += kThreads) {
        const int m = i / F, f = i - m * F;
        sFeat[m * ldf + f] = a.feat[((size_t)b * M + ab0 + m) * F + f];
      }
      __syncthreads();
      const float* bemb = a.bembed;
      tile_gemm(sFeat, ldf, ab, F, a.embed, a.E, a.E, [&](int r, int c, float4 v) {
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
    __syncthreads();
    tile_gemm(sEmb, lde, ab, ke, a.wde, D, D, [&](int r, int c, float4 v) {
      store4(sC + (ab0 + r) * wd + c,
             drop_quad(0, ab0 + r, c,
                       make_float4(swishf(v.x + a.bde[c]), swishf(v.y + a.bde[c + 1]),
                                   swishf(v.z + a.bde[c + 2]), swishf(v.w + a.bde[c + 3]))));
    });
    __syncthreads();
  }

  // ---- SCANN+ geometry embedding -> global scratch -----------------------
  if (a.g_update) embed_geometry(a, sA, sU, ndist, nweight, geo_b);

  // ---- L x (LocalAttention + ResidualNorm) -------------------------------
  for (int l = 0; l < a.L; ++l) {
    const LayerWeights w = layer_weights(a, l);
    const float* wq = a.wq + (size_t)l * D * D;
    const float* bq = a.bq + (size_t)l * D;
    const float* br1 = a.br1 + (size_t)l * D;
    const float* br2 = a.br2 + (size_t)l * D;
    const float* rs = a.rln_s + (size_t)l * D;
    const float* rb = a.rln_b + (size_t)l * D;

    for (int ab0 = 0; ab0 < M; ab0 += AB) {
      const int ab = min(AB, M - ab0);
      // per-atom projections of the block: cw = centers @ Wfg[0:D] (SCANN+), query
      if (a.g_update) {
        tile_gemm(sC + ab0 * wd, wd, ab, D, w.wfg, D, D, [&](int r, int c, float4 v) {
          store4(sW + r * wd + c, v);
        });
      }
      tile_gemm(sC + ab0 * wd, wd, ab, D, wq, D, D, [&](int r, int c, float4 v) {
        store4(sQ + r * wd + c,
               make_float4(v.x + bq[c], v.y + bq[c + 1], v.z + bq[c + 2], v.w + bq[c + 3]));
      });
      __syncthreads();

      for (int m0 = ab0; m0 < ab0 + ab; m0 += CA) {
        const int ca = min(CA, ab0 + ab - m0), rows = ca * N, base = m0 * N;
        stage_chunk(a, sA, sC, wd, nbr, ndist, geo_b, base, rows);
        attention_chunk(ca, N, D, H, K, a.g_update != 0, sA, sU, sE,
                        sW + (m0 - ab0) * wd, sQ + (m0 - ab0) * wd, wd, nmask + base,
                        nweight + base, geo_b + (size_t)base * D, nullptr, w, a.dk,
                        a.attn_dropout != 0, [&](int at, int n, int h) {
                          return scann_philox::mask_value(
                              a.seed, mol, 1 + a.L + l, (unsigned)((base + at * N + n) * H + h),
                              a.attn_threshold, a.attn_scale);
                        });
      }

      // ResidualNorm of the block: next = LN(out + swish(out @ W1 + b1) @ W2 + b2)
      tile_gemm(sQ, wd, ab, D, a.wr1 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
        store4(sW + r * wd + c, make_float4(swishf(v.x + br1[c]), swishf(v.y + br1[c + 1]),
                                            swishf(v.z + br1[c + 2]), swishf(v.w + br1[c + 3])));
      });
      __syncthreads();
      tile_gemm(sW, wd, ab, D, a.wr2 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
        store4(sU + r * D + c,
               drop_quad(1 + l, ab0 + r, c, make_float4(v.x + br2[c], v.y + br2[c + 1],
                                                        v.z + br2[c + 2], v.w + br2[c + 3])));
      });
      __syncthreads();
      for (int m = warp; m < ab; m += kWarps) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          v[i] = (d < D) ? sQ[m * wd + d] + sU[m * D + d] : 0.f;
        }
        warp_layer_norm(v, D, rs, rb, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (lane + 32 * i < D) next_b[(size_t)(ab0 + m) * D + lane + 32 * i] = v[i];
      }
      __syncthreads();
    }

    // every atom has gathered from this layer's input: take the new centers
    const int q4 = D / 4;
    for (int i = tid; i < M * q4; i += kThreads) {
      const int m = i / q4, c = (i - m * q4) * 4;
      store4(sC + m * wd + c, *reinterpret_cast<const float4*>(next_b + (size_t)m * D + c));
    }
    __syncthreads();
  }

  // ---- readout: after_Lc, GA scores, pooled context, head ----------------
  float* qsum = sMisc;                 // [G]  sum_m mask * gq
  float* struc = sMisc + wd;           // [G]  pooled context
  float* score = sMisc + 2 * wd;       // [M]  agg, then ga
  float* diag = score + round4(M);     // [M]  (mask k) . (mask q)
  float* hid = diag + round4(M);       // [O]
  for (int g = tid; g < G; g += kThreads) qsum[g] = 0.f;
  for (int ab0 = 0; ab0 < M; ab0 += AB) {
    const int ab = min(AB, M - ab0);
    tile_gemm(sC + ab0 * wd, wd, ab, D, a.wal, G, G, [&](int r, int c, float4 v) {
      store4(sW + r * wd + c, make_float4(swishf(v.x + a.bal[c]), swishf(v.y + a.bal[c + 1]),
                                          swishf(v.z + a.bal[c + 2]), swishf(v.w + a.bal[c + 3])));
    });
    __syncthreads();
    // the block's GA queries, and its GA keys in place of its centers
    tile_gemm(sW, wd, ab, G, a.wgq, G, G, [&](int r, int c, float4 v) {
      store4(sQ + r * wd + c, make_float4(v.x + a.bgq[c], v.y + a.bgq[c + 1],
                                          v.z + a.bgq[c + 2], v.w + a.bgq[c + 3]));
    });
    tile_gemm(sW, wd, ab, G, a.wgk, G, G, [&](int r, int c, float4 v) {
      store4(sC + (ab0 + r) * wd + c, make_float4(v.x + a.bgk[c], v.y + a.bgk[c + 1],
                                                  v.z + a.bgk[c + 2], v.w + a.bgk[c + 3]));
    });
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      float s = qsum[g];
      for (int m = 0; m < ab; ++m) s += am[ab0 + m] * sQ[m * wd + g];
      qsum[g] = s;
    }
    for (int m = warp; m < ab; m += kWarps) {
      const float mm = am[ab0 + m];
      float dg = 0.f;
      for (int g = lane; g < G; g += 32)
        dg += (mm * sC[(ab0 + m) * wd + g]) * (mm * sQ[m * wd + g]);
      dg = warp_sum(dg);
      if (lane == 0) diag[ab0 + m] = dg;
    }
    __syncthreads();
  }
  // agg_m = mask_m * ((mask_m k_m) . qsum - (mask_m k_m) . (mask_m q_m))
  for (int m = warp; m < M; m += kWarps) {
    const float mm = am[m];
    float cross = 0.f;
    for (int g = lane; g < G; g += 32) cross += (mm * sC[m * wd + g]) * qsum[g];
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
      a.ga[(size_t)b * M + m] = score[m];
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += am[m] * score[m] * sC[m * wd + g];
    struc[g] = s;
  }
  __syncthreads();
  tile_gemm(struc, G, 1, G, a.wbf, O, O, [&](int r, int c, float4 v) {
    store4(hid + c, make_float4(swishf(v.x + a.bbf[c]), swishf(v.y + a.bbf[c + 1]),
                                swishf(v.z + a.bbf[c + 2]), swishf(v.w + a.bbf[c + 3])));
  });
  __syncthreads();
  if (warp == 0) {
    float p = 0.f;
    for (int o = lane; o < O; o += 32) p += hid[o] * a.wp[o];
    p = warp_sum(p) + a.bp[0];
    if (a.mrelu) p = fmaxf(p, 0.f);
    if (lane == 0) a.pred[b] = p;
  }
}

}  // namespace

// The pointers, sizes, scalars and random-stream words are those of
// unpack_forward_args (scann_common.cuh), followed by pointer 49, the
// next-centers scratch [B, M, D], and size 20, the atom block; in the order
// scann_tpu_torch/kernels/scann_loop.py passes them.
extern "C" int scann_loop_forward_launch(void* const* ptrs, const int* dims,
                                         const float* scalars, const unsigned int* rng,
                                         void* stream) {
  ForwardArgs a;
  unpack_forward_args(a, ptrs, dims, scalars, rng);
  a.next_centers = (float*)ptrs[49];
  a.atom_block = dims[20];

  if (a.M < 1 || a.N < 1 || a.chunk_atoms < 1 || a.chunk_atoms * a.N > kMaxChunkRows ||
      a.atom_block < 1 || a.atom_block > kMaxAtomBlock ||
      a.D > 128 || a.G > 128 || a.O > 128 || (a.D & 3) || (a.G & 3) || (a.O & 3) || (a.E & 3) ||
      a.D % a.H || a.K > a.D)
    return kErrShape;
  const int stage = round4(a.E + (a.use_ring ? 10 : 0)) + (a.cgcnn ? round4(a.F) : 0);
  if (a.abuf_floats < a.chunk_atoms * a.N * 2 * a.D || a.abuf_floats < a.atom_block * stage)
    return kErrShape;
  const int bytes = make_plan(a).total * (int)sizeof(float);
  if (bytes > kMaxSharedBytes) return kErrSharedMemory;
  cudaError_t err = cudaFuncSetAttribute(scann_loop_forward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  scann_loop_forward_kernel<<<a.B, kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* scann_loop_forward_error_string(int code) {
  if (code == kErrSharedMemory) return "shared-memory plan exceeds 227 KB per block";
  if (code == kErrShape) return "shape outside what the kernel takes";
  return cudaGetErrorString((cudaError_t)code);
}
