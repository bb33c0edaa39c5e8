// Building blocks shared by the port's two backward kernels
// (scann_backward.cu for molecules, scann_loop_backward.cu for crystals): the
// order of the 36 gradients, the argument block, the LayerNorm backward of
// one row and the reduction of the per-block gradient rows. Their products
// are in scann_mma.cuh.

#pragma once

#include "scann_common.cuh"

namespace scann {

enum GradIndex {
  gEMBED, gBEMBED, gWRING, gBRING, gWDE, gBDE, gWND, gBND, gWNW, gBNW,
  gWFG, gBFG, gWK, gBK, gWQ, gBQ, gLNS, gLNB, gLNGS, gLNGB,
  gWR1, gBR1, gWR2, gBR2, gRLNS, gRLNB,
  gWAL, gBAL, gWGQ, gBGQ, gWGK, gBGK, gWBF, gBBF, gWP, gBP, kNumGrads
};

// Arguments of the whole-model backwards.
struct BackwardArgs {
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
  const float* ct;            // [B]: d pred, or the targets in one-shot mode
  const float* ct_ga;         // [B, M]: d ga (not read in one-shot mode)
  // parameters, as in scann_forward.cu
  const float* embed;
  const float* bembed;
  const float* wring;
  const float* bring;
  const float* wde;
  const float* bde;
  const float* wnd;
  const float* bnd;
  const float* wnw;
  const float* bnw;
  const float* wfg;
  const float* bfg;
  const float* wk;
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
  const float* wal;
  const float* bal;
  const float* wgq;
  const float* bgq;
  const float* wgk;
  const float* bgk;
  const float* wbf;
  const float* bbf;
  const float* wp;
  const float* bp;
  // scratch and outputs
  float* c_stash;             // [B, L, M, D]   layer inputs ([B, L + 1, M, D] in
                              //                scann_loop_backward.cu: the last centers too)
  float* o_stash;             // [B, L, M, D]   ctx + query before the LayerNorm
  float* g_stash;             // [B, L, M*N, D] geometry inputs (g_update)
  float* dgeo;                // [B, M*N, D]    d geometry (g_update)
  float* grad_rows;           // [B, P] ([B * cluster, P] in scann_loop_backward.cu)
  float* pred;                // [B]
  float* dcenters;            // [B, M, D]      d layer output (scann_loop_backward.cu only)
  long long P;                // floats of one gradient row
  int off[kNumGrads];         // offset of each gradient in a row (-1: absent)
  // sizes and switches
  int B, M, N, D, H, E, K, G, O, L, F, V;   // V: rows of the embedding table
  int cgcnn, use_ring, g_update, ga_norm, mrelu, one_shot;
  int chunk_atoms;            // atoms per chunk of rows (CA * N <= 32)
  int atom_block;             // atoms per per-atom product (scann_loop_backward.cu only)
  int cluster;                // blocks per structure (scann_loop_backward.cu only)
  int dropout, attn_dropout;
  unsigned int seed, mol_base, drop_threshold, attn_threshold;
  float drop_scale, attn_scale;
  float dk;                   // hd ** -scale
  float rbf_width;            // squared Gaussian width (0.25)
};

// Fills BackwardArgs from the 54 pointers, 21 sizes, 4 scalars, 4
// random-stream words and 37 offsets that kernels/scann_backward.py passes,
// in its order.
inline void unpack_backward_args(BackwardArgs& a, void* const* p, const int* dims,
                                 const float* scalars, const unsigned int* rng,
                                 const long long* offsets) {
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
  a.ct = (const float*)p[i++];
  a.ct_ga = (const float*)p[i++];
  const float** params[] = {
      &a.embed, &a.bembed, &a.wring, &a.bring, &a.wde, &a.bde, &a.wnd, &a.bnd, &a.wnw, &a.bnw,
      &a.wfg, &a.bfg, &a.wk, &a.bk, &a.wq, &a.bq, &a.ln_s, &a.ln_b, &a.lng_s, &a.lng_b,
      &a.wr1, &a.br1, &a.wr2, &a.br2, &a.rln_s, &a.rln_b,
      &a.wal, &a.bal, &a.wgq, &a.bgq, &a.wgk, &a.bgk, &a.wbf, &a.bbf, &a.wp, &a.bp};
  for (int j = 0; j < kNumGrads; ++j) *params[j] = (const float*)p[i++];
  a.c_stash = (float*)p[i++];
  a.o_stash = (float*)p[i++];
  a.g_stash = (float*)p[i++];
  a.dgeo = (float*)p[i++];
  a.grad_rows = (float*)p[i++];
  a.pred = (float*)p[i++];
  a.dcenters = nullptr;

  a.B = dims[0]; a.M = dims[1]; a.N = dims[2]; a.D = dims[3]; a.H = dims[4];
  a.E = dims[5]; a.K = dims[6]; a.G = dims[7]; a.O = dims[8]; a.L = dims[9];
  a.F = dims[10]; a.V = dims[11];
  a.cgcnn = dims[12]; a.use_ring = dims[13]; a.g_update = dims[14];
  a.ga_norm = dims[15]; a.mrelu = dims[16]; a.one_shot = dims[17];
  a.chunk_atoms = dims[18]; a.dropout = dims[19]; a.attn_dropout = dims[20];
  a.atom_block = 0;
  a.cluster = 1;
  a.dk = scalars[0];
  a.rbf_width = scalars[1];
  a.drop_scale = scalars[2];
  a.attn_scale = scalars[3];
  a.seed = rng[0]; a.mol_base = rng[1]; a.drop_threshold = rng[2]; a.attn_threshold = rng[3];
  a.P = offsets[kNumGrads];
  for (int j = 0; j < kNumGrads; ++j) a.off[j] = (int)offsets[j];
}

// LayerNorm statistics of one row held by a warp as in warp_layer_norm:
// the same two-pass mean and rsqrt(var + 1e-6), so a recomputed row
// normalises to the same bits.
__device__ __forceinline__ void warp_ln_stats(const float (&v)[4], int D, int lane,
                                              float& mean, float& inv) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane + 32 * i < D) s += v[i];
  mean = warp_sum(s) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane + 32 * i < D) {
      const float t = v[i] - mean;
      q += t * t;
    }
  inv = rsqrtf(warp_sum(q) / (float)D + 1e-6f);
}

// LayerNorm backward of one row: dx = inv (dxhat - mean(dxhat) - xhat
// mean(dxhat xhat)), dxhat = dy gamma.
__device__ __forceinline__ void warp_ln_backward(const float (&xhat)[4], float inv,
                                                 const float (&dy)[4], const float* gamma,
                                                 int D, int lane, float (&dx)[4]) {
  float dxh[4], s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = lane + 32 * i;
    dxh[i] = d < D ? dy[i] * gamma[d] : 0.f;
    s1 += dxh[i];
    s2 += dxh[i] * xhat[i];
  }
  const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
#pragma unroll
  for (int i = 0; i < 4; ++i) dx[i] = inv * (dxh[i] - m1 - xhat[i] * m2);
}

// out[p] = sum_b rows[b * P + p], b in order: the batch's gradients, the
// same from run to run.
static __global__ void scann_reduce_rows(const float* __restrict__ rows, int B, long long P,
                                  float* __restrict__ out) {
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += rows[(size_t)b * P + p];
    out[p] = s;
  }
}

// Launches scann_reduce_rows over the [B, P] rows into out [P].
inline int launch_reduce_rows(const float* rows, int B, long long P, float* out,
                              cudaStream_t s) {
  long long blocks = (P + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  scann_reduce_rows<<<(int)blocks, kThreads, 0, s>>>(rows, B, P, out);
  return (int)cudaGetLastError();
}

}  // namespace scann
