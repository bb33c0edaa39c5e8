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
  const int* seg;             // [B, M] segment of each row, -1 on padding (packed slots;
                              //                ct is then [B, S], pred [B, S])
  // the activation stash (kernels/*.py keep_acts_mode, loop_stash_mode): 0 runs
  // the recompute schedule and every st_* is null; 4 or 2 the element bytes of
  // the stash's big row buffers (f32, or bfloat16 rounded to nearest even)
  int stash;
  void* st_rows;              // [B, L, k, M*N, D]   the per-row tensors of a layer
  void* st_attn;              // [B, L, M*N, H]      attention before dropout
  float* st_ginv;             // [B, L, M*N]         LN_g's rsqrt(var + eps) (molecules, g_update)
  float* st_atoms;            // [B, L, k, M, D]     per-atom tensors
  float* st_inv;              // [B, L, 2, M]        LayerNorm rsqrt(var + eps) (molecules)
  long long P;                // floats of one gradient row
  int off[kNumGrads];         // offset of each gradient in a row (-1: absent)
  // sizes and switches
  int B, M, N, D, H, E, K, G, O, L, F, V;   // V: rows of the embedding table
  int cgcnn, use_ring, g_update, ga_norm, mrelu, one_shot;
  int chunk_atoms;            // atoms per chunk of rows (CA * N <= 32)
  int atom_block;             // atoms per per-atom product (scann_loop_backward.cu only)
  int cluster;                // blocks per structure (scann_loop_backward.cu only)
  int S;                      // segments per slot (0: one structure per row block)
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
  a.stash = 0;
  a.st_rows = a.st_attn = nullptr;
  a.st_ginv = a.st_atoms = a.st_inv = nullptr;

  a.B = dims[0]; a.M = dims[1]; a.N = dims[2]; a.D = dims[3]; a.H = dims[4];
  a.E = dims[5]; a.K = dims[6]; a.G = dims[7]; a.O = dims[8]; a.L = dims[9];
  a.F = dims[10]; a.V = dims[11];
  a.cgcnn = dims[12]; a.use_ring = dims[13]; a.g_update = dims[14];
  a.ga_norm = dims[15]; a.mrelu = dims[16]; a.one_shot = dims[17];
  a.chunk_atoms = dims[18]; a.dropout = dims[19]; a.attn_dropout = dims[20];
  a.atom_block = 0;
  a.cluster = 1;
  a.seg = nullptr;
  a.S = 0;
  a.dk = scalars[0];
  a.rbf_width = scalars[1];
  a.drop_scale = scalars[2];
  a.attn_scale = scalars[3];
  a.seed = rng[0]; a.mol_base = rng[1]; a.drop_threshold = rng[2]; a.attn_threshold = rng[3];
  a.P = offsets[kNumGrads];
  for (int j = 0; j < kNumGrads; ++j) a.off[j] = (int)offsets[j];
}

// The stash's elements: f32 (bytes 4) or bfloat16 (bytes 2), rounded to
// nearest even on the way in and widened on the way out; i is an element
// index, a multiple of 4 for the quads. Each is written once and read once,
// so the stores and loads are streaming ones (.cs), which leave L2 to the
// weights and gradient rows.
__device__ __forceinline__ void stash_put4(void* base, size_t i, float4 v, int bytes) {
  if (bytes == 2) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned int*>(&lo);
    u.y = *reinterpret_cast<const unsigned int*>(&hi);
    __stcs(reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + i), u);
  } else {
    __stcs(reinterpret_cast<float4*>(static_cast<float*>(base) + i), v);
  }
}

__device__ __forceinline__ float4 stash_get4(const void* base, size_t i, int bytes) {
  if (bytes == 2) {
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(base) + i));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return __ldcs(reinterpret_cast<const float4*>(static_cast<const float*>(base) + i));
}

__device__ __forceinline__ void stash_put(void* base, size_t i, float v, int bytes) {
  if (bytes == 2) static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(v);
  else __stcs(static_cast<float*>(base) + i, v);
}

__device__ __forceinline__ float stash_get(const void* base, size_t i, int bytes) {
  if (bytes == 2) return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  return static_cast<const float*>(base)[i];
}

// Copies from global to shared memory that do not pass through registers
// (cp.async, past L1; the forwards' staging uses them too): a chunk's loads
// are all in flight at once, and the thread waits for them with
// cp_async_wait_all before the block's barrier. 16 bytes need 16-byte
// aligned addresses on both sides.
__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// LayerNorm statistics of one row held by a warp as in warp_layer_norm
// (V values a lane: 4 in the builds of widths up to 128, kLaneValues = 8 in
// those past it, 16 in those past 256): the same two-pass mean and
// rsqrt(var + 1e-6), so a recomputed row normalises to the same bits.
template <int V>
__device__ __forceinline__ void warp_ln_stats(const float (&v)[V], int D, int lane,
                                              float& mean, float& inv) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (lane + 32 * i < D) s += v[i];
  mean = warp_sum(s) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (lane + 32 * i < D) {
      const float t = v[i] - mean;
      q += t * t;
    }
  inv = rsqrtf(warp_sum(q) / (float)D + 1e-6f);
}

// LayerNorm backward of one row (V values a lane, as warp_ln_stats): dx =
// inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat = dy gamma.
template <int V>
__device__ __forceinline__ void warp_ln_backward(const float (&xhat)[V], float inv,
                                                 const float (&dy)[V], const float* gamma,
                                                 int D, int lane, float (&dx)[V]) {
  float dxh[V], s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int d = lane + 32 * i;
    dxh[i] = d < D ? dy[i] * gamma[d] : 0.f;
    s1 += dxh[i];
    s2 += dxh[i] * xhat[i];
  }
  const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
#pragma unroll
  for (int i = 0; i < V; ++i) dx[i] = inv * (dxh[i] - m1 - xhat[i] * m2);
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
