// Whole-model SCANN / SCANN+ forward for molecules, one CUDA block per
// molecule.
//
// Replaces the TPU kernel scann_tpu/kernels/scann_forward.py:_kernel (the
// Pallas whole-model forward) for unpacked batches:
// embedding (atomic-number lookup or cgcnn dense, optional ring concat),
// Gaussian RBF geometry (+ the SCANN+ geometry embedding), L x
// (LocalAttention + ResidualNorm), after_Lc, the GA readout and the
// property head (optional mrelu). Outputs pred [B] and ga [B, M], f32.
// With dropout on (training through scann_apply) it applies the embedding
// and residual masks and, under use_drop, the attention mask, drawn in
// place by the Philox of philox.cuh, so the backward kernel replays them;
// with dropout off it computes exactly what it computed without them.
//
// Bound. At the QM9 serving shape (B=128, M=32, N=16, L=7, D=128) the work
// is ~5.0e10 FLOP against a few MB of inputs and weights, so the kernel is
// bound by operations: all products are FP32 FMA loops on the CUDA cores
// (no tensor cores, no TF32), whose H100 SXM peak is ~67 TFLOP/s -> ~0.75 ms.
//
// Design.
// - One block of 256 threads per molecule; the block loops over the layers
//   with __syncthreads() between phases. Layer l+1 gathers neighbour states
//   written by layer l of the same molecule, so no block waits on another.
// - Per-atom state (centers, query, a scratch [M, D]) lives in shared
//   memory; neighbour states are an index gather from the centers there
//   (the TPU kernel's one-hot matmul gather is gone), per-head softmax
//   reductions loop over the hd lanes of each head (no 0/1 segment
//   matmuls), and the atomic-number embedding is a row lookup.
// - The [M, N, D] SCANN+ geometry does not fit in shared memory at large
//   M, so it lives in a global scratch buffer (B*M*N*D floats, allocated by
//   the caller; 33.5 MB at the QM9 shape, which L2 holds) and is streamed
//   through shared memory in chunks of CA atoms (CA*N <= 64 rows).
// - Every dense product is tile_gemm: A rows from shared memory, weights
//   read as float4 through the read-only cache (they total ~3.3 MB at QM9
//   width and stay in L2) one k-step ahead of use, each thread
//   accumulating an 8-row x 4-column tile with fmaf in K order.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// given stream, synchronises nothing, allocates nothing, and returns the
// cudaGetLastError() code of the launch (or kErrSharedMemory).

#include "philox.cuh"
#include "scann_common.cuh"

namespace {

using namespace scann;

constexpr int kMaxChunkRows = 64;

using Args = ForwardArgs;   // scann_common.cuh

// Shared-memory plan, in floats: centers, query, scratch [M, wd] each; the
// chunk operand buffer A (also the embedding staging area); the chunk
// product buffer U [rows, D]; energies [rows, H]; readout vectors.
struct Plan {
  int wd, rows, offQ, offW, offA, offU, offE, offMisc, total;
};

__host__ __device__ inline Plan make_plan(const Args& a) {
  Plan p;
  p.wd = a.D > a.G ? a.D : a.G;
  p.rows = a.chunk_atoms * a.N;
  p.offQ = a.M * p.wd;
  p.offW = 2 * a.M * p.wd;
  p.offA = 3 * a.M * p.wd;
  p.offU = p.offA + a.abuf_floats;
  p.offE = p.offU + p.rows * a.D;
  p.offMisc = p.offE + round4(p.rows * a.H);
  p.total = p.offMisc + 2 * p.wd + round4(a.M) + round4(a.O);
  return p;
}

// one block per SM (its shared memory takes most of the SM), so the
// compiler may spend up to 255 registers a thread: no spills
__global__ void __launch_bounds__(kThreads, 1)
scann_forward_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan P = make_plan(a);
  const int b = blockIdx.x;
  const int M = a.M, N = a.N, D = a.D, H = a.H, K = a.K, G = a.G, O = a.O;
  const int wd = P.wd, CA = a.chunk_atoms;
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
  float* sQ = smem + P.offQ;      // query / out    [M, wd]
  float* sW = smem + P.offW;      // scratch        [M, wd]
  float* sA = smem + P.offA;      // chunk operand  [rows, 2D]: geometry | neighbours/key
  float* sU = smem + P.offU;      // chunk product  [rows, D]
  float* sE = smem + P.offE;      // energies       [rows, H]
  float* sMisc = smem + P.offMisc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;

  const float* am = a.atom_mask + (size_t)b * M;
  const int* nbr = a.nbr + (size_t)b * M * N;
  const float* nmask = a.nmask + (size_t)b * M * N;
  const float* nweight = a.nweight + (size_t)b * M * N;
  const float* ndist = a.ndist + (size_t)b * M * N;
  float* geo_b = a.geo + (size_t)b * M * N * D;

  // ---- atom embedding -> centers = swish(emb @ Wde + bde) ----------------
  const int ke = a.E + (a.use_ring ? 10 : 0);
  const int lde = round4(ke);
  float* sEmb = sA;                                   // [M, lde]
  if (a.cgcnn) {
    const int F = a.F, ldf = round4(F);
    float* sFeat = sA + M * lde;                      // [M, ldf]
    for (int i = tid; i < M * F; i += kThreads) {
      const int m = i / F, f = i - m * F;
      sFeat[m * ldf + f] = a.feat[((size_t)b * M + m) * F + f];
    }
    __syncthreads();
    const float* bemb = a.bembed;
    tile_gemm(sFeat, ldf, M, F, a.embed, a.E, a.E, [&](int r, int c, float4 v) {
      store4(sEmb + r * lde + c,
             make_float4(v.x + bemb[c], v.y + bemb[c + 1], v.z + bemb[c + 2], v.w + bemb[c + 3]));
    });
  } else {
    for (int i = tid; i < M * a.E; i += kThreads) {
      const int m = i / a.E, e = i - m * a.E;
      sEmb[m * lde + e] = a.embed[(size_t)a.atomic[(size_t)b * M + m] * a.E + e];
    }
  }
  if (a.use_ring) {
    for (int i = tid; i < M * 10; i += kThreads) {
      const int m = i / 10, j = i - m * 10;
      const float r0 = a.ring[((size_t)b * M + m) * 2], r1 = a.ring[((size_t)b * M + m) * 2 + 1];
      sEmb[m * lde + a.E + j] = r0 * a.wring[j] + r1 * a.wring[10 + j] + a.bring[j];
    }
  }
  __syncthreads();
  tile_gemm(sEmb, lde, M, ke, a.wde, D, D, [&](int r, int c, float4 v) {
    store4(sC + r * wd + c,
           drop_quad(0, r, c,
                     make_float4(swishf(v.x + a.bde[c]), swishf(v.y + a.bde[c + 1]),
                                 swishf(v.z + a.bde[c + 2]), swishf(v.w + a.bde[c + 3]))));
  });
  __syncthreads();

  // ---- SCANN+ geometry embedding -> global scratch -----------------------
  if (a.g_update) embed_geometry(a, sA, sU, ndist, nweight, geo_b);

  // ---- L x (LocalAttention + ResidualNorm) -------------------------------
  for (int l = 0; l < a.L; ++l) {
    const LayerWeights w = layer_weights(a, l);
    const float* wq = a.wq + (size_t)l * D * D;
    const float* bq = a.bq + (size_t)l * D;

    // per-atom projections: cw = centers @ Wfg[0:D] (SCANN+), query
    if (a.g_update) {
      tile_gemm(sC, wd, M, D, w.wfg, D, D, [&](int r, int c, float4 v) {
        store4(sW + r * wd + c, v);
      });
    }
    tile_gemm(sC, wd, M, D, wq, D, D, [&](int r, int c, float4 v) {
      store4(sQ + r * wd + c, make_float4(v.x + bq[c], v.y + bq[c + 1], v.z + bq[c + 2], v.w + bq[c + 3]));
    });
    __syncthreads();

    for (int m0 = 0; m0 < M; m0 += CA) {
      const int ca = min(CA, M - m0), rows = ca * N, base = m0 * N;
      stage_chunk(a, sA, sC, wd, nbr, ndist, geo_b, base, rows);
      attention_chunk(ca, N, D, H, K, a.g_update != 0, sA, sU, sE, sW + m0 * wd, sQ + m0 * wd,
                      wd, nmask + base, nweight + base, geo_b + (size_t)base * D, nullptr, w,
                      a.dk, a.attn_dropout != 0, [&](int at, int n, int h) {
                        return scann_philox::mask_value(
                            a.seed, mol, 1 + a.L + l, (unsigned)((base + at * N + n) * H + h),
                            a.attn_threshold, a.attn_scale);
                      });
    }

    // ResidualNorm: centers = LN(out + swish(out @ W1 + b1) @ W2 + b2)
    const float* br1 = a.br1 + (size_t)l * D;
    const float* br2 = a.br2 + (size_t)l * D;
    tile_gemm(sQ, wd, M, D, a.wr1 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
      store4(sW + r * wd + c, make_float4(swishf(v.x + br1[c]), swishf(v.y + br1[c + 1]),
                                          swishf(v.z + br1[c + 2]), swishf(v.w + br1[c + 3])));
    });
    __syncthreads();
    tile_gemm(sW, wd, M, D, a.wr2 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
      store4(sC + r * wd + c,
             drop_quad(1 + l, r, c, make_float4(v.x + br2[c], v.y + br2[c + 1],
                                                v.z + br2[c + 2], v.w + br2[c + 3])));
    });
    __syncthreads();
    const float* rs = a.rln_s + (size_t)l * D;
    const float* rb = a.rln_b + (size_t)l * D;
    for (int m = warp; m < M; m += nwarps) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane + 32 * i;
        v[i] = (d < D) ? sQ[m * wd + d] + sC[m * wd + d] : 0.f;
      }
      warp_layer_norm(v, D, rs, rb, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (lane + 32 * i < D) sC[m * wd + lane + 32 * i] = v[i];
    }
    __syncthreads();
  }

  // ---- readout: after_Lc, GA scores, pooled context, head ----------------
  tile_gemm(sC, wd, M, D, a.wal, G, G, [&](int r, int c, float4 v) {
    store4(sW + r * wd + c, make_float4(swishf(v.x + a.bal[c]), swishf(v.y + a.bal[c + 1]),
                                        swishf(v.z + a.bal[c + 2]), swishf(v.w + a.bal[c + 3])));
  });
  __syncthreads();
  tile_gemm(sW, wd, M, G, a.wgq, G, G, [&](int r, int c, float4 v) {
    store4(sQ + r * wd + c, make_float4(v.x + a.bgq[c], v.y + a.bgq[c + 1],
                                        v.z + a.bgq[c + 2], v.w + a.bgq[c + 3]));
  });
  tile_gemm(sW, wd, M, G, a.wgk, G, G, [&](int r, int c, float4 v) {
    store4(sC + r * wd + c, make_float4(v.x + a.bgk[c], v.y + a.bgk[c + 1],
                                        v.z + a.bgk[c + 2], v.w + a.bgk[c + 3]));
  });
  __syncthreads();
  float* qsum = sMisc;                 // [G]  sum_m mask * gq
  float* struc = sMisc + wd;           // [G]  pooled context
  float* score = sMisc + 2 * wd;       // [M]  agg, then ga
  float* hid = score + round4(M);      // [O]
  for (int g = tid; g < G; g += kThreads) {
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += am[m] * sQ[m * wd + g];
    qsum[g] = s;
  }
  __syncthreads();
  // agg_m = mask_m * ((mask_m k_m) . qsum - (mask_m k_m) . (mask_m q_m))
  for (int m = warp; m < M; m += nwarps) {
    const float mm = am[m];
    float cross = 0.f, diag = 0.f;
    for (int g = lane; g < G; g += 32) {
      const float mk = mm * sC[m * wd + g];
      cross += mk * qsum[g];
      diag += mk * (mm * sQ[m * wd + g]);
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

// The 49 pointers, 20 sizes, 4 scalars and 4 random-stream words are those of
// unpack_forward_args (scann_common.cuh), in the order
// scann_tpu_torch/kernels/scann_forward.py passes them.
extern "C" int scann_forward_launch(void* const* ptrs, const int* dims, const float* scalars,
                                    const unsigned int* rng, void* stream) {
  Args a;
  unpack_forward_args(a, ptrs, dims, scalars, rng);

  if (a.M > 64 || a.M < 1 || a.chunk_atoms * a.N > kMaxChunkRows || a.D > 128 || a.G > 128 ||
      a.O > 128 || (a.D & 3) || (a.G & 3) || (a.O & 3) || (a.E & 3) || a.D % a.H || a.K > a.D)
    return kErrShape;
  const int bytes = make_plan(a).total * (int)sizeof(float);
  if (bytes > kMaxSharedBytes) return kErrSharedMemory;
  cudaError_t err = cudaFuncSetAttribute(scann_forward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  scann_forward_kernel<<<a.B, kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* scann_forward_error_string(int code) {
  if (code == kErrSharedMemory) return "shared-memory plan exceeds 227 KB per block";
  if (code == kErrShape) return "shape outside what the kernel takes";
  return cudaGetErrorString((cudaError_t)code);
}
