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

struct Args {
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
  // sizes and switches
  int B, M, N, D, H, E, K, G, O, L, F;
  int cgcnn, use_ring, g_update, ga_norm, mrelu;
  int chunk_atoms;      // atoms per geometry chunk (chunk rows = CA * N <= 64)
  int abuf_floats;      // floats of the chunk operand buffer
  float dk;             // hd ** -scale
  float rbf_width;      // squared Gaussian width (0.25)
  // training dropout (philox.cuh): masks keyed on (seed, mol_base + b)
  int dropout, attn_dropout;
  unsigned int seed, mol_base, drop_threshold, attn_threshold;
  float drop_scale, attn_scale;
};

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
  const int wd = P.wd, lda = 2 * D, hd = D / H, CA = a.chunk_atoms;
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
  // geo = swish(rbf(d) @ Wnd + bnd) * swish(rbf(w) @ Wnw + bnw)
  if (a.g_update) {
    for (int m0 = 0; m0 < M; m0 += CA) {
      const int ca = min(CA, M - m0), rows = ca * N, base = m0 * N;
      for (int i = tid; i < rows * K; i += kThreads) {
        const int r = i / K, k = i - r * K;
        const float t = ndist[base + r] - a.dist_centers[k];
        sA[r * lda + k] = expf(-(t * t) / a.rbf_width);
      }
      __syncthreads();
      tile_gemm(sA, lda, rows, K, a.wnd, D, D, [&](int r, int c, float4 v) {
        store4(sU + r * D + c, make_float4(v.x + a.bnd[c], v.y + a.bnd[c + 1],
                                           v.z + a.bnd[c + 2], v.w + a.bnd[c + 3]));
      });
      __syncthreads();
      for (int i = tid; i < rows * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        sA[r * lda + D + d] = swishf(sU[r * D + d]);  // d_emb; K <= D keeps it clear of the rbf
      }
      for (int i = tid; i < rows * K; i += kThreads) {
        const int r = i / K, k = i - r * K;
        const float t = nweight[base + r] - a.angle_centers[k];
        sA[r * lda + k] = expf(-(t * t) / a.rbf_width);
      }
      __syncthreads();
      tile_gemm(sA, lda, rows, K, a.wnw, D, D, [&](int r, int c, float4 v) {
        store4(sU + r * D + c, make_float4(v.x + a.bnw[c], v.y + a.bnw[c + 1],
                                           v.z + a.bnw[c + 2], v.w + a.bnw[c + 3]));
      });
      __syncthreads();
      for (int i = tid; i < rows * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        geo_b[(size_t)(base + r) * D + d] = sA[r * lda + D + d] * swishf(sU[r * D + d]);
      }
      __syncthreads();
    }
  }

  // ---- L x (LocalAttention + ResidualNorm) -------------------------------
  const int fg_in = a.g_update ? 3 * D : K;
  for (int l = 0; l < a.L; ++l) {
    const float* wfg = a.wfg + (size_t)l * fg_in * D;
    const float* bfg = a.bfg + (size_t)l * D;
    const float* wk = a.wk + (size_t)l * D * D;
    const float* bk = a.bk + (size_t)l * D;
    const float* wq = a.wq + (size_t)l * D * D;
    const float* bq = a.bq + (size_t)l * D;

    // per-atom projections: cw = centers @ Wfg[0:D] (SCANN+), query
    if (a.g_update) {
      tile_gemm(sC, wd, M, D, wfg, D, D, [&](int r, int c, float4 v) {
        store4(sW + r * wd + c, v);
      });
    }
    tile_gemm(sC, wd, M, D, wq, D, D, [&](int r, int c, float4 v) {
      store4(sQ + r * wd + c, make_float4(v.x + bq[c], v.y + bq[c + 1], v.z + bq[c + 2], v.w + bq[c + 3]));
    });
    __syncthreads();

    for (int m0 = 0; m0 < M; m0 += CA) {
      const int ca = min(CA, M - m0), rows = ca * N, base = m0 * N;
      // stage the geometry (SCANN+) or the distance RBF (SCANN), and the
      // gathered neighbour states
      if (a.g_update) {
        const int q4 = D / 4;
        for (int i = tid; i < rows * q4; i += kThreads) {
          const int r = i / q4, c = (i - r * q4) * 4;
          store4(sA + r * lda + c,
                 *reinterpret_cast<const float4*>(geo_b + (size_t)(base + r) * D + c));
        }
      } else {
        for (int i = tid; i < rows * K; i += kThreads) {
          const int r = i / K, k = i - r * K;
          const float t = ndist[base + r] - a.dist_centers[k];
          sA[r * lda + k] = expf(-(t * t) / a.rbf_width);
        }
      }
      for (int i = tid; i < rows * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        sA[r * lda + D + d] = sC[nbr[base + r] * wd + d];
      }
      __syncthreads();

      if (a.g_update) {
        // u = [geo | ns] @ Wfg[D:3D]; geo' = LN_g(swish(u + cw + b) + geo)
        tile_gemm(sA, lda, rows, 2 * D, wfg + (size_t)D * D, D, D, [&](int r, int c, float4 v) {
          store4(sU + r * D + c, v);
        });
        __syncthreads();
        const float* gs = a.lng_s + (size_t)l * D;
        const float* gb = a.lng_b + (size_t)l * D;
        for (int r = warp; r < rows; r += nwarps) {
          const int m = m0 + r / N;
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = lane + 32 * i;
            v[i] = 0.f;
            if (d < D) v[i] = swishf(sW[m * wd + d] + sU[r * D + d] + bfg[d]) + sA[r * lda + d];
          }
          warp_layer_norm(v, D, gs, gb, lane);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = lane + 32 * i;
            if (d < D) {
              geo_b[(size_t)(base + r) * D + d] = v[i];
              sU[r * D + d] = sA[r * lda + D + d] * v[i];   // ns * geo'
            }
          }
        }
      } else {
        // geo_term = swish(rbf(d) @ Wfg + b) * weight
        tile_gemm(sA, lda, rows, K, wfg, D, D, [&](int r, int c, float4 v) {
          store4(sU + r * D + c, v);
        });
        __syncthreads();
        for (int i = tid; i < rows * D; i += kThreads) {
          const int r = i / D, d = i - r * D;
          const float g = swishf(sU[r * D + d] + bfg[d]) * nweight[base + r];
          sU[r * D + d] = sA[r * lda + D + d] * g;           // ns * geo_term
        }
      }
      __syncthreads();

      // key = (ns * geo) @ Wk + bk, into the neighbour half of A
      tile_gemm(sU, D, rows, D, wk, D, D, [&](int r, int c, float4 v) {
        store4(sA + r * lda + D + c,
               make_float4(v.x + bk[c], v.y + bk[c + 1], v.z + bk[c + 2], v.w + bk[c + 3]));
      });
      __syncthreads();

      // per-head energies (query * dk) . key, masked with -1e9
      for (int i = tid; i < rows * H; i += kThreads) {
        const int r = i / H, h = i - r * H;
        const float* q = sQ + (m0 + r / N) * wd + h * hd;
        const float* kk = sA + r * lda + D + h * hd;
        float e = 0.f;
        for (int j = 0; j < hd; ++j) e = fmaf(q[j] * a.dk, kk[j], e);
        sE[r * H + h] = e + (1.0f - nmask[base + r]) * -1e9f;
      }
      __syncthreads();
      // max-shifted softmax over the N neighbours of each (atom, head)
      for (int i = tid; i < ca * H; i += kThreads) {
        const int at = i / H, h = i - at * H;
        float* e = sE + at * N * H + h;
        float mx = -INFINITY;
        for (int n = 0; n < N; ++n) mx = fmaxf(mx, e[n * H]);
        float s = 0.f;
        for (int n = 0; n < N; ++n) {
          const float t = expf(e[n * H] - mx);
          e[n * H] = t;
          s += t;
        }
        for (int n = 0; n < N; ++n) e[n * H] = e[n * H] / s;
        if (a.attn_dropout) {   // the context uses the dropped-out attention
          for (int n = 0; n < N; ++n)
            e[n * H] *= scann_philox::mask_value(
                a.seed, mol, 1 + a.L + l, (unsigned)((base + at * N + n) * H + h),
                a.attn_threshold, a.attn_scale);
        }
      }
      __syncthreads();
      // out = ctx + query, ctx = sum_n attn * nmask * key
      for (int i = tid; i < ca * D; i += kThreads) {
        const int at = i / D, d = i - at * D, h = d / hd;
        float s = 0.f;
        for (int n = 0; n < N; ++n) {
          const int r = at * N + n;
          s += sE[r * H + h] * nmask[base + r] * sA[r * lda + D + d];
        }
        sQ[(m0 + at) * wd + d] = s + sQ[(m0 + at) * wd + d];
      }
      __syncthreads();
      const float* ls = a.ln_s + (size_t)l * D;
      const float* lb = a.ln_b + (size_t)l * D;
      for (int at = warp; at < ca; at += nwarps) {
        float* row = sQ + (m0 + at) * wd;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = (lane + 32 * i < D) ? row[lane + 32 * i] : 0.f;
        warp_layer_norm(v, D, ls, lb, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (lane + 32 * i < D) row[lane + 32 * i] = v[i];
      }
      __syncthreads();
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

// The order of the 49 pointers, 20 sizes, 4 scalars and 4 random-stream words
// must match scann_tpu_torch/kernels/scann_forward.py.
extern "C" int scann_forward_shared_bytes(const int* dims) {
  Args a = {};
  a.B = dims[0]; a.M = dims[1]; a.N = dims[2]; a.D = dims[3]; a.H = dims[4];
  a.E = dims[5]; a.K = dims[6]; a.G = dims[7]; a.O = dims[8]; a.L = dims[9];
  a.F = dims[10]; a.chunk_atoms = dims[16]; a.abuf_floats = dims[17];
  return make_plan(a).total * (int)sizeof(float);
}

extern "C" int scann_forward_launch(void* const* ptrs, const int* dims, const float* scalars,
                                    const unsigned int* rng, void* stream) {
  Args a;
  const void* const* p = ptrs;
  int i = 0;
  a.atomic = (const int*)p[i++];
  a.feat = (const float*)p[i++];
  a.atom_mask = (const float*)p[i++];
  a.nbr = (const int*)p[i++];
  a.nmask = (const float*)p[i++];
  a.nweight = (const float*)p[i++];
  a.ndist = (const float*)p[i++];
  a.ring = (const float*)p[i++];
  a.dist_centers = (const float*)p[i++];
  a.angle_centers = (const float*)p[i++];
  a.embed = (const float*)p[i++];
  a.bembed = (const float*)p[i++];
  a.wring = (const float*)p[i++];
  a.bring = (const float*)p[i++];
  a.wde = (const float*)p[i++];
  a.bde = (const float*)p[i++];
  a.wnd = (const float*)p[i++];
  a.bnd = (const float*)p[i++];
  a.wnw = (const float*)p[i++];
  a.bnw = (const float*)p[i++];
  a.wfg = (const float*)p[i++];
  a.bfg = (const float*)p[i++];
  a.wk = (const float*)p[i++];
  a.bk = (const float*)p[i++];
  a.wq = (const float*)p[i++];
  a.bq = (const float*)p[i++];
  a.ln_s = (const float*)p[i++];
  a.ln_b = (const float*)p[i++];
  a.lng_s = (const float*)p[i++];
  a.lng_b = (const float*)p[i++];
  a.wr1 = (const float*)p[i++];
  a.br1 = (const float*)p[i++];
  a.wr2 = (const float*)p[i++];
  a.br2 = (const float*)p[i++];
  a.rln_s = (const float*)p[i++];
  a.rln_b = (const float*)p[i++];
  a.wal = (const float*)p[i++];
  a.bal = (const float*)p[i++];
  a.wgq = (const float*)p[i++];
  a.bgq = (const float*)p[i++];
  a.wgk = (const float*)p[i++];
  a.bgk = (const float*)p[i++];
  a.wbf = (const float*)p[i++];
  a.bbf = (const float*)p[i++];
  a.wp = (const float*)p[i++];
  a.bp = (const float*)p[i++];
  a.geo = (float*)p[i++];
  a.pred = (float*)p[i++];
  a.ga = (float*)p[i++];

  a.B = dims[0]; a.M = dims[1]; a.N = dims[2]; a.D = dims[3]; a.H = dims[4];
  a.E = dims[5]; a.K = dims[6]; a.G = dims[7]; a.O = dims[8]; a.L = dims[9];
  a.F = dims[10];
  a.cgcnn = dims[11]; a.use_ring = dims[12]; a.g_update = dims[13];
  a.ga_norm = dims[14]; a.mrelu = dims[15];
  a.chunk_atoms = dims[16]; a.abuf_floats = dims[17];
  a.dropout = dims[18]; a.attn_dropout = dims[19];
  a.dk = scalars[0];
  a.rbf_width = scalars[1];
  a.drop_scale = scalars[2];
  a.attn_scale = scalars[3];
  a.seed = rng[0]; a.mol_base = rng[1]; a.drop_threshold = rng[2]; a.attn_threshold = rng[3];

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
