// Whole-model SCANN / SCANN+ backward for molecules: every parameter
// gradient of one batch, one CUDA block per molecule, plus a second kernel
// that sums the per-molecule gradients in a fixed order.
//
// Replaces the TPU kernel scann_tpu/kernels/scann_backward.py:_kernel. Given
// the output cotangents (d pred [B], d ga [B, M]),
// or in one-shot training mode the targets (the residual pred - t is then
// formed here; mrelu is straight-through, so no gate), each block
// recomputes its molecule's forward with the training dropout of
// philox.cuh (the same masks the forward kernel and ops/dropout.py draw),
// emits pred, and walks the graph in reverse: the head and GA readout, then
// for each layer from the last the ResidualNorm, the attention LayerNorm,
// the attention softmax (on the pre-dropout probabilities, dattn times the
// attention mask, the context from the dropped-out ones), key and query,
// the SCANN+ geometry update or the SCANN filter, and the neighbour gather;
// then the embedding (one-hot, cgcnn, ring) and the SCANN+ neighbor_d /
// neighbor_w geometry embedding. For a packed batch (structure packing: S > 0
// segments per slot, each row's segment in seg [B, M], -1 on padding) d pred,
// the targets and pred are [B, S], and the readout and its backward run per
// segment (scann_common.cuh's seg_* routines; scann_backward.py:289-389): the
// one-shot residual of a segment without atoms is zeroed.
//
// Bound. backward_flops (kernels/scann_backward.py) counts the 1.50e11
// FLOP that the function needs per QM9 training batch (B=128, M=32, N=16,
// L=7, D=128): the forward, and the weight and input gradients of each
// forward product (no input gradient where the input is data). As three
// TF32 passes per product at the H100 SXM's dense 495 TFLOP/s TF32 (the
// energies and context on the CUDA cores at 67 TFLOP/s FP32) that is ~0.92
// ms, above the time the inputs, weights and gradients take to move at HBM
// rate, so the bound is set by operations. The recompute schedule adds
// 5.0e10 FLOP (recompute_flops), the keep-acts stash 1.1e9 and 2.6 GB of
// stash traffic at B=128; the bound counts neither.
//
// Design.
// - No sequential grid. The TPU adds every program's gradients into the
//   same output refs; GPU blocks run concurrently, so each block writes its
//   molecule's gradients into its own row of a [B, P] scratch (no atomics)
//   and scann_reduce_rows sums the rows in order b = 0..B-1: the result is
//   the same from run to run.
// - Stash. Each layer's inputs go to global scratch in the forward pass:
//   the centers [L, M, D] and, for SCANN+, the geometry [L, M*N, D] (~1.8 MB
//   per QM9 molecule, streamed through L2). Two schedules, a runtime argument
//   of the launch (a.stash):
//   - keep-acts (the TPU kernel's default, SCANN_TPU_UNROLL_STASH=1,
//     scann_backward.py:242-278; here wherever keep_acts_mode admits it): the
//     forward pass also keeps what the TPU kernel's acts dict holds, its
//     (atom, neighbour) rows chunk by chunk straight from the chunk buffers
//     and its per-atom tensors, and the reverse walk reads them back in
//     place of the gather, the row and per-atom products, the softmax and the
//     LayerNorm statistics. The attention after dropout is rebuilt from the
//     stashed attention and the mask replayed from Philox, the same product.
//     The f32 stash runs the recompute schedule's arithmetic on the same
//     values, so its gradients are the same bits; the bf16 stash
//     (SCANN_TPU_STASH_BF16) rounds the five row tensors of _BF16_KEYS;
//   - recompute (SCANN_TPU_UNROLL_STASH=0, or a shape whose stash exceeds the
//     budget): ctx + query [L, M, D] is kept, and the reverse walk recomputes
//     a layer's per-atom activations from it and from the centers, and its
//     rows chunk by chunk from the geometry stash (once, not twice).
// - The (atom, neighbour) rows go through shared memory in chunks of CA
//   whole atoms (CA*N <= 32 rows), so a softmax over N neighbours stays in
//   one chunk: one warp per (atom, head), lane n holding neighbour n. The
//   gradient of the geometry flows back through a global [M*N, D] buffer,
//   read and rewritten chunk by chunk.
// - Products (scann_mma.cuh): mma_gemm (x @ W), mma_gemm_tB (dy @ W^T) and
//   mma_gemm_tA (x^T dy for the weight gradients, with the bias sums from
//   the same fragments) run on the tensor cores as split-TF32 mma.sync,
//   three passes per tile, accumulated in f32. Each warp owns 16 output
//   columns, so a weight element leaves L2 once per chunk; the chunk's
//   buffers have row strides of 2D + 4 and D + 4 floats, which keeps the
//   fragment reads free of bank conflicts. Weight gradients are added into
//   the block's gradient row from the second chunk on, 16 bytes a thread,
//   by the same thread every time. None is a library call.
// - The gather's transpose is a scatter-add of d(neighbour state) into the
//   molecule's d(centers) in shared memory: every target element belongs to
//   one thread, which walks the chunk's rows in order; the one-hot
//   embedding's gradient is the same scatter into the rows of the atoms' Z.
//   Bias sums and the LayerNorm parameter gradients (per-warp partials
//   reduced in warp order) are also summed in a fixed order.
//
// bf16 operand mode (model.dtype "bfloat16"; scann_backward.py:661 bf16=):
// the kernel is a template on kBf16. Every product takes it (scann_mma.cuh:
// both operands rounded to bfloat16, one TF32 pass, the cotangent of a
// transposed product included), and so do the operands the TPU kernel forms
// as products and this one does not: in the forward recompute the gathered
// neighbour states, each q * k lane before the head sum, the attention
// before the context sum, the embedding row, the ring embedding's operands
// and the head; in the backward each d ctx * key lane before its head sum
// (warp_softmax_backward), d energy before its lane expansion, the attention
// in d key, d(neighbour state) before the gather's scatter-add, d emb before
// the one-hot embedding's scatter and the ring gradient's operands. Bias and
// LayerNorm-parameter gradients stay f32 sums of the unrounded cotangent;
// packed segments pool f32-exact, as scann_backward.py:296-300 does. This
// file builds the f32 instantiation; scann_backward_bf16.cu includes it with
// SCANN_BACKWARD_BF16 defined and builds the bf16 one in its own nvcc, so
// the two compile in parallel. The shared-memory plan is the same.
//
// Interface: a plain C function, loaded with ctypes. It launches both
// kernels on the given stream, synchronises nothing, allocates nothing,
// and returns the cudaGetLastError() code of the launches (or an own code).
// scann_mma_selftest_launch runs the three products of scann_mma.cuh on one
// block, for a check against a float64 product.

#include <type_traits>

#include "philox.cuh"
#ifndef SCANN_BACKWARD_BF16
#define SCANN_MMA_SELFTEST
#endif
#include "scann_mma.cuh"

namespace {

using namespace scann;

constexpr int kMaxChunkRows = 32;

using Args = BackwardArgs;

// Shared-memory plan, in floats. Seven [M, wd] per-atom buffers live for
// the whole walk; the work region is reused by each phase (chunk of rows,
// readout, a layer's per-atom recompute, the embedding); a small tail holds
// per-warp LayerNorm partials and bias sums.
struct Plan {
  int wd, MW, rows, lda, ldu, lde, ldf, work, offWork, offPart, offAcc, total;
};

__host__ __device__ inline Plan make_plan(const Args& a) {
  Plan p;
  p.wd = a.D > a.G ? a.D : a.G;
  p.MW = a.M * p.wd;
  p.rows = a.chunk_atoms * a.N;
  p.lda = 2 * a.D + 4;
  p.ldu = a.D + 4;
  p.lde = round4(a.E + (a.use_ring ? 10 : 0));
  p.ldf = a.cgcnn ? round4(a.F) : 0;
  const int chunk = p.rows * p.lda + 3 * p.rows * p.ldu + 3 * round4(p.rows * a.H);
  const int readout = 5 * p.MW + 4 * p.wd + 4 * round4(a.M) + 3 * round4(a.O) + 4;
  const int seg_readout = 5 * p.MW + seg_backward_floats(a.S, p.wd, a.M, a.O);
  const int layer = 6 * p.MW + round4(a.M);
  const int embed = 2 * a.M * p.lde + a.M * p.ldf + p.MW;
  int w = chunk;
  w = readout > w ? readout : w;
  if (a.S) w = seg_readout > w ? seg_readout : w;
  w = layer > w ? layer : w;
  w = embed > w ? embed : w;
  p.work = w;
  p.offWork = 7 * p.MW;
  p.offPart = p.offWork + w;
  p.offAcc = p.offPart + kWarps * 2 * p.wd;
  p.total = p.offAcc + 2 * p.wd;
  return p;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
scann_backward_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan P = make_plan(a);
  const int b = blockIdx.x;
  const int M = a.M, N = a.N, D = a.D, H = a.H, K = a.K, G = a.G, O = a.O, L = a.L;
  const int wd = P.wd, MW = P.MW, hd = D / H, CA = a.chunk_atoms, R = M * N;
  const int lda = P.lda, ldu = P.ldu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned int mol = a.mol_base + (unsigned int)b;

  // per-atom buffers, live for the whole walk
  float* sC = smem;                  // layer input centers        [M, wd]
  float* sDC = smem + MW;            // d layer output             [M, wd]
  float* sQ = smem + 2 * MW;         // query (forward: ctx + query, o1)
  float* sCW = smem + 3 * MW;        // centers @ Wfg[0:D] (SCANN+)
  float* sDQ = smem + 4 * MW;        // d ctx, then d query (forward: scratch)
  float* sDCW = smem + 5 * MW;       // d cw (SCANN+)
  float* sDCN = smem + 6 * MW;       // d layer input, accumulated
  float* work = smem + P.offWork;
  float* sPart = smem + P.offPart;   // [kWarps][2][wd] LayerNorm partials
  float* sAcc = smem + P.offAcc;     // [2][wd] bias sums
  // a chunk of (atom, neighbour) rows
  const int CR = P.rows;
  float* sA = work;                  // [CR, lda]: geometry or RBF | neighbour states
  float* sU = sA + CR * lda;         // [CR, ldu]: u_pre, then d u_pre
  float* sV = sU + CR * ldu;         // [CR, ldu]: key input, then d key input
  float* sW = sV + CR * ldu;         // [CR, ldu]: key, then d key, then d LN_g input
  float* sE = sW + CR * ldu;         // [CR, H]: attention (before dropout)
  float* sF = sE + round4(CR * H);   // [CR, H]: d attention
  float* sM = sF + round4(CR * H);   // [CR, H]: attention dropout mask

  const float* am = a.atom_mask + (size_t)b * M;
  const int* nbr = a.nbr + (size_t)b * R;
  const float* nmask = a.nmask + (size_t)b * R;
  const float* nweight = a.nweight + (size_t)b * R;
  const float* ndist = a.ndist + (size_t)b * R;
  float* c_st = a.c_stash + (size_t)b * L * M * D;
  float* o_st = a.o_stash + (size_t)b * L * M * D;
  float* g_st = a.g_update ? a.g_stash + (size_t)b * L * R * D : nullptr;
  float* dgb = a.g_update ? a.dgeo + (size_t)b * R * D : nullptr;
  float* grow = a.grad_rows + (size_t)b * a.P;
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

  // The keep-acts stash (a.stash 4 or 2: the element bytes of its row
  // buffers): the forward pass keeps what the TPU kernel's acts dict holds
  // (scann_backward.py:242-246). Rows [L, k, M*N, D]: 0 neighbour states, 1
  // u_pre, 2 key, 3 geo_term, 4 LN_g's x-hat (SCANN+); f32 always: the
  // attention [L, M*N, H] before dropout, LN_g's rsqrt [L, M*N] (SCANN+), the
  // per-atom tensors [L, 6, M, D] (0 query, 1 o1, 2 the attention LayerNorm's
  // x-hat, 3 s1, 4 h1, 5 the ResidualNorm's x-hat) and the two LayerNorms'
  // rsqrt [L, 2, M]. The bf16 stash (SCANN_TPU_STASH_BF16) rounds the row
  // buffers only, as _BF16_KEYS does (scann_backward.py:264-271).
  const int sb = a.stash;
  const int nk = a.g_update ? 5 : 4;
  const size_t lay_rows = (size_t)R * D;
  auto st_row = [&](int l, int k) { return (((size_t)b * L + l) * nk + k) * lay_rows; };
  auto st_atom = [&](int l, int k) { return a.st_atoms + (((size_t)b * L + l) * 6 + k) * M * D; };
  auto st_inv = [&](int l, int k) { return a.st_inv + (((size_t)b * L + l) * 2 + k) * M; };

  // ---- a chunk of rows: stage, then recompute u_pre, key input, key, attention
  // (`stashed`: stage the neighbour states, u_pre, keys and attention from the
  // stash instead)
  auto stage_chunk = [&](int l, int m0, int rows, bool stashed) {
    const int base = m0 * N;
    if (a.g_update) {
      const float* g_in = g_st + ((size_t)l * R + base) * D;
      for (int i = tid; i < rows * q4; i += kThreads) {
        const int r = i / q4, c = (i - r * q4) * 4;
        cp_async16(sA + r * lda + c, g_in + (size_t)r * D + c);
      }
    } else {
      for (int i = tid; i < rows * K; i += kThreads) {
        const int r = i / K, k = i - r * K;
        const float t = ndist[base + r] - a.dist_centers[k];
        sA[r * lda + k] = expf(-(t * t) / a.rbf_width);
      }
    }
    if (stashed) {
      for (int i = tid; i < rows * q4; i += kThreads) {
        const int r = i / q4, c = (i - r * q4) * 4;
        const size_t e = (size_t)(base + r) * D + c;
        if (sb == 4) {               // f32: straight into the chunk buffers
          const float* st = static_cast<const float*>(a.st_rows);
          cp_async16(sA + r * lda + D + c, st + st_row(l, 0) + e);
          cp_async16(sU + r * ldu + c, st + st_row(l, 1) + e);
          cp_async16(sW + r * ldu + c, st + st_row(l, 2) + e);
        } else {                     // bf16: widened on the way
          store4(sA + r * lda + D + c, stash_get4(a.st_rows, st_row(l, 0) + e, sb));
          store4(sU + r * ldu + c, stash_get4(a.st_rows, st_row(l, 1) + e, sb));
          store4(sW + r * ldu + c, stash_get4(a.st_rows, st_row(l, 2) + e, sb));
        }
      }
      const float* at = static_cast<const float*>(a.st_attn) + (((size_t)b * L + l) * R + base) * H;
      for (int i = tid; i < rows * H; i += kThreads) cp_async4(sE + i, at + i);
    } else {
      for (int i = tid; i < rows * q4; i += kThreads) {
        const int r = i / q4, c = (i - r * q4) * 4;
        store4(sA + r * lda + D + c,
               operand4<kBf16>(*reinterpret_cast<const float4*>(sC + nbr[base + r] * wd + c)));
      }
    }
    if (a.attn_dropout) {
      for (int i = tid; i < rows * H; i += kThreads)
        sM[i] = scann_philox::mask_value(a.seed, mol, 1 + L + l, (unsigned)(base * H + i),
                                         a.attn_threshold, a.attn_scale);
    }
    cp_async_wait_all();
    __syncthreads();
  };

  // `keep`: the forward pass with the stash, which also writes the chunk's rows
  // there; `stashed`: the reverse walk from the stash, which only forms the
  // key input ns * geo_term from the stashed rows
  auto row_forward = [&](int l, int m0, int ca, bool write_g, bool keep, bool stashed) {
    const int rows = ca * N, base = m0 * N;
    const float* wfg = a.wfg + (size_t)l * fg_in * D;
    const float* bfg = a.bfg + (size_t)l * D;
    const float* bk = a.bk + (size_t)l * D;
    if (stashed) {
      for (int i = tid; i < rows * q4; i += kThreads) {
        const int r = i / q4, c = (i - r * q4) * 4;
        const float4 g = stash_get4(a.st_rows, st_row(l, 3) + (size_t)(base + r) * D + c, sb);
        const float* ns = sA + r * lda + D + c;
        store4(sV + r * ldu + c, make_float4(ns[0] * g.x, ns[1] * g.y, ns[2] * g.z, ns[3] * g.w));
      }
      __syncthreads();
      return;
    }
    if (a.g_update) {
      // u_pre = cw + [geo | ns] @ Wfg[D:3D] + b
      mma_gemm<kBf16>(sA, lda, rows, 2 * D, wfg + (size_t)D * D, D, D, [&](int r, int c, float4 v) {
        const float* cw = sCW + (m0 + r / N) * wd + c;
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
            const float xh = (v[i] - mean) * inv;
            const float g = xh * gs[d] + gb[d];
            if (write_g) g_out[(size_t)r * D + d] = g;
            sV[r * ldu + d] = sA[r * lda + D + d] * g;   // ns * geo'
            if (keep) {
              stash_put(a.st_rows, st_row(l, 3) + (size_t)(base + r) * D + d, g, sb);
              stash_put(a.st_rows, st_row(l, 4) + (size_t)(base + r) * D + d, xh, sb);
            }
          }
        }
        if (keep && lane == 0) a.st_ginv[((size_t)b * L + l) * R + base + r] = inv;
      }
    } else {
      // geo_term = swish(rbf(d) @ Wfg + b) * weight
      mma_gemm<kBf16>(sA, lda, rows, K, wfg, D, D, [&](int r, int c, float4 v) {
        store4(sU + r * ldu + c,
               make_float4(v.x + bfg[c], v.y + bfg[c + 1], v.z + bfg[c + 2], v.w + bfg[c + 3]));
      });
      __syncthreads();
      for (int i = tid; i < rows * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        const float g = swishf(sU[r * ldu + d]) * nweight[base + r];
        sV[r * ldu + d] = sA[r * lda + D + d] * g;
        if (keep) stash_put(a.st_rows, st_row(l, 3) + (size_t)(base + r) * D + d, g, sb);
      }
    }
    __syncthreads();
    // key = (ns * geo) @ Wk + bk
    mma_gemm<kBf16>(sV, ldu, rows, D, a.wk + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
      store4(sW + r * ldu + c,
             make_float4(v.x + bk[c], v.y + bk[c + 1], v.z + bk[c + 2], v.w + bk[c + 3]));
    });
    __syncthreads();
    warp_energy_softmax<kBf16>(sQ + m0 * wd, wd, sW, ldu, nmask + base, sE, ca, N, H, hd, a.dk);
    __syncthreads();
    if (keep) {
      for (int i = tid; i < rows * q4; i += kThreads) {
        const int r = i / q4, c = (i - r * q4) * 4;
        const size_t e = (size_t)(base + r) * D + c;
        stash_put4(a.st_rows, st_row(l, 0) + e, *reinterpret_cast<const float4*>(sA + r * lda + D + c), sb);
        stash_put4(a.st_rows, st_row(l, 1) + e, *reinterpret_cast<const float4*>(sU + r * ldu + c), sb);
        stash_put4(a.st_rows, st_row(l, 2) + e, *reinterpret_cast<const float4*>(sW + r * ldu + c), sb);
      }
      float* at = static_cast<float*>(a.st_attn) + (((size_t)b * L + l) * R + base) * H;
      for (int i = tid; i < rows * H; i += kThreads) __stcs(at + i, sE[i]);
    }
  };

  // per-atom projections of a layer's input: query (and cw for SCANN+)
  auto project_atoms = [&](int l) {
    const float* wfg = a.wfg + (size_t)l * fg_in * D;
    const float* bq = a.bq + (size_t)l * D;
    if (a.g_update)
      mma_gemm<kBf16>(sC, wd, M, D, wfg, D, D, [&](int r, int c, float4 v) { store4(sCW + r * wd + c, v); });
    mma_gemm<kBf16>(sC, wd, M, D, a.wq + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
      store4(sQ + r * wd + c, make_float4(v.x + bq[c], v.y + bq[c + 1], v.z + bq[c + 2], v.w + bq[c + 3]));
    });
  };

  // ---- embedding staging: sEmb [M, lde] = [emb | ring_emb] ----------------
  const int ke = a.E + (a.use_ring ? 10 : 0);
  const int lde = P.lde, ldf = P.ldf;
  float* sEmb = work;
  float* sFeat = work + M * lde;
  auto stage_embedding = [&]() {
    if (a.cgcnn) {
      const int F = a.F;
      for (int i = tid; i < M * ldf; i += kThreads) {
        const int m = i / ldf, f = i - m * ldf;
        sFeat[i] = f < F ? a.feat[((size_t)b * M + m) * F + f] : 0.f;
      }
      __syncthreads();
      const float* bemb = a.bembed;
      mma_gemm<kBf16>(sFeat, ldf, M, F, a.embed, a.E, a.E, [&](int r, int c, float4 v) {
        store4(sEmb + r * lde + c,
               make_float4(v.x + bemb[c], v.y + bemb[c + 1], v.z + bemb[c + 2], v.w + bemb[c + 3]));
      });
    } else {
      for (int i = tid; i < M * a.E; i += kThreads) {
        const int m = i / a.E, e = i - m * a.E;
        sEmb[m * lde + e] = operand<kBf16>(a.embed[(size_t)a.atomic[(size_t)b * M + m] * a.E + e]);
      }
    }
    if (a.use_ring) {
      for (int i = tid; i < M * 10; i += kThreads) {
        const int m = i / 10, j = i - m * 10;
        const float r0 = a.ring[((size_t)b * M + m) * 2], r1 = a.ring[((size_t)b * M + m) * 2 + 1];
        sEmb[m * lde + a.E + j] = operand<kBf16>(r0) * operand<kBf16>(a.wring[j]) +
                                  operand<kBf16>(r1) * operand<kBf16>(a.wring[10 + j]) + a.bring[j];
      }
    }
    for (int i = tid; i < M * (lde - ke); i += kThreads) {   // keep the pad columns finite
      const int m = i / (lde - ke), j = i - m * (lde - ke);
      sEmb[m * lde + ke + j] = 0.f;
    }
    __syncthreads();
  };

  // ======================= forward, stashing layer inputs ===================
  stage_embedding();
  mma_gemm<kBf16>(sEmb, lde, M, ke, a.wde, D, D, [&](int r, int c, float4 v) {
    const float4 m = mask4(0, r, c);
    store4(sC + r * wd + c,
           make_float4(swishf(v.x + a.bde[c]) * m.x, swishf(v.y + a.bde[c + 1]) * m.y,
                       swishf(v.z + a.bde[c + 2]) * m.z, swishf(v.w + a.bde[c + 3]) * m.w));
  });
  __syncthreads();

  // SCANN+ geometry embedding: geo_0 = swish(rbf(d) @ Wnd + bnd) * swish(rbf(w) @ Wnw + bnw)
  if (a.g_update) {
    for (int m0 = 0; m0 < M; m0 += CA) {
      const int ca = min(CA, M - m0), rows = ca * N, base = m0 * N;
      for (int i = tid; i < rows * K; i += kThreads) {
        const int r = i / K, k = i - r * K;
        const float t = ndist[base + r] - a.dist_centers[k];
        const float u = nweight[base + r] - a.angle_centers[k];
        sA[r * lda + k] = expf(-(t * t) / a.rbf_width);
        sA[r * lda + D + k] = expf(-(u * u) / a.rbf_width);
      }
      __syncthreads();
      mma_gemm<kBf16>(sA, lda, rows, K, a.wnd, D, D, [&](int r, int c, float4 v) {
        store4(sU + r * ldu + c, make_float4(v.x + a.bnd[c], v.y + a.bnd[c + 1],
                                           v.z + a.bnd[c + 2], v.w + a.bnd[c + 3]));
      });
      mma_gemm<kBf16>(sA + D, lda, rows, K, a.wnw, D, D, [&](int r, int c, float4 v) {
        store4(sV + r * ldu + c, make_float4(v.x + a.bnw[c], v.y + a.bnw[c + 1],
                                           v.z + a.bnw[c + 2], v.w + a.bnw[c + 3]));
      });
      __syncthreads();
      for (int i = tid; i < rows * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        g_st[(size_t)base * D + i] = swishf(sU[r * ldu + d]) * swishf(sV[r * ldu + d]);
      }
      __syncthreads();
    }
  }

  for (int l = 0; l < L; ++l) {
    for (int i = tid; i < M * D; i += kThreads) {
      const int m = i / D, d = i - m * D;
      c_st[(size_t)l * M * D + i] = sC[m * wd + d];
    }
    project_atoms(l);
    __syncthreads();
    if (sb)
      for (int i = tid; i < M * q4; i += kThreads) {
        const int m = i / q4, c = (i - m * q4) * 4;
        store4(st_atom(l, 0) + m * D + c, *reinterpret_cast<const float4*>(sQ + m * wd + c));
      }
    for (int m0 = 0; m0 < M; m0 += CA) {
      const int ca = min(CA, M - m0), base = m0 * N;
      stage_chunk(l, m0, ca * N, false);
      row_forward(l, m0, ca, l + 1 < L, sb != 0, false);
      // ctx = sum_n attn * mask * nmask * key, added to the query
      for (int i = tid; i < ca * D; i += kThreads) {
        const int at = i / D, d = i - at * D, h = d / hd;
        float s = 0.f;
        for (int n = 0; n < N; ++n) {
          const int r = at * N + n;
          const float p = a.attn_dropout ? sE[r * H + h] * sM[r * H + h] : sE[r * H + h];
          s += operand<kBf16>(p) * nmask[base + r] * sW[r * ldu + d];
        }
        sQ[(m0 + at) * wd + d] = s + sQ[(m0 + at) * wd + d];
      }
      __syncthreads();
    }
    // stash ctx + query (the keep-acts stash: o1, its x-hat and rsqrt), then
    // o1 = LN(ctx + query)
    const float* ls = a.ln_s + (size_t)l * D;
    const float* lb = a.ln_b + (size_t)l * D;
    for (int m = warp; m < M; m += kWarps) {
      float* row = sQ + m * wd;
      float v[4], mean, inv;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane + 32 * i;
        v[i] = d < D ? row[d] : 0.f;
        if (d < D && !sb) o_st[((size_t)l * M + m) * D + d] = v[i];
      }
      warp_ln_stats(v, D, lane, mean, inv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float xh = (v[i] - mean) * inv;
          row[d] = xh * ls[d] + lb[d];
          if (sb) {
            st_atom(l, 1)[m * D + d] = row[d];
            st_atom(l, 2)[m * D + d] = xh;
          }
        }
      }
      if (sb && lane == 0) st_inv(l, 0)[m] = inv;
    }
    __syncthreads();
    // ResidualNorm: centers = LN(o1 + mask * (swish(o1 @ W1 + b1) @ W2 + b2))
    const float* br1 = a.br1 + (size_t)l * D;
    const float* br2 = a.br2 + (size_t)l * D;
    // (the keep-acts stash: s1 in sDCW, free in the forward pass, then both to the stash)
    mma_gemm<kBf16>(sQ, wd, M, D, a.wr1 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
      const float4 s = make_float4(v.x + br1[c], v.y + br1[c + 1], v.z + br1[c + 2], v.w + br1[c + 3]);
      store4(sDQ + r * wd + c, make_float4(swishf(s.x), swishf(s.y), swishf(s.z), swishf(s.w)));
      if (sb) store4(sDCW + r * wd + c, s);
    });
    __syncthreads();
    if (sb)
      for (int i = tid; i < M * q4; i += kThreads) {
        const int m = i / q4, c = (i - m * q4) * 4;
        __stcs(reinterpret_cast<float4*>(st_atom(l, 3) + m * D + c),
               *reinterpret_cast<const float4*>(sDCW + m * wd + c));
        __stcs(reinterpret_cast<float4*>(st_atom(l, 4) + m * D + c),
               *reinterpret_cast<const float4*>(sDQ + m * wd + c));
      }
    mma_gemm<kBf16>(sDQ, wd, M, D, a.wr2 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
      const float4 m = mask4(1 + l, r, c);
      store4(sC + r * wd + c, make_float4((v.x + br2[c]) * m.x, (v.y + br2[c + 1]) * m.y,
                                          (v.z + br2[c + 2]) * m.z, (v.w + br2[c + 3]) * m.w));
    });
    __syncthreads();
    const float* rs = a.rln_s + (size_t)l * D;
    const float* rb = a.rln_b + (size_t)l * D;
    for (int m = warp; m < M; m += kWarps) {
      float v[4], mean, inv;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane + 32 * i;
        v[i] = d < D ? sQ[m * wd + d] + sC[m * wd + d] : 0.f;
      }
      warp_ln_stats(v, D, lane, mean, inv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float xh = (v[i] - mean) * inv;
          sC[m * wd + d] = xh * rs[d] + rb[d];
          if (sb) st_atom(l, 5)[m * D + d] = xh;
        }
      }
      if (sb && lane == 0) st_inv(l, 1)[m] = inv;
    }
    __syncthreads();
  }

  // ======================= readout: forward and backward ====================
  {
    float* RA = work;              // s_al = cL @ Wal + bal
    float* RB = work + MW;         // cg = swish(s_al)
    float* RC = work + 2 * MW;     // gq, then d gq
    float* RD = work + 3 * MW;     // gk, then d gk
    float* RE = work + 4 * MW;     // d cg, then d s_al
    float* qsum = work + 5 * MW;   // [wd]
    float* struc = qsum + wd;
    float* dstruc = struc + wd;
    float* dqsum = dstruc + wd;
    float* agg0 = dqsum + wd;      // [M] each
    float* ga = agg0 + round4(M);
    float* dga = ga + round4(M);
    float* dcd = dga + round4(M);
    float* sbf = dcd + round4(M);  // [O] each
    float* sb = sbf + round4(O);
    float* dsbf = sb + round4(O);
    float* scal = dsbf + round4(O);   // [0] norm, [1] d pred
    mma_gemm<kBf16>(sC, wd, M, D, a.wal, G, G, [&](int r, int c, float4 v) {
      const float4 s = make_float4(v.x + a.bal[c], v.y + a.bal[c + 1], v.z + a.bal[c + 2],
                                   v.w + a.bal[c + 3]);
      store4(RA + r * wd + c, s);
      store4(RB + r * wd + c, make_float4(swishf(s.x), swishf(s.y), swishf(s.z), swishf(s.w)));
    });
    __syncthreads();
    mma_gemm<kBf16>(RB, wd, M, G, a.wgq, G, G, [&](int r, int c, float4 v) {
      store4(RC + r * wd + c, make_float4(v.x + a.bgq[c], v.y + a.bgq[c + 1],
                                          v.z + a.bgq[c + 2], v.w + a.bgq[c + 3]));
    });
    mma_gemm<kBf16>(RB, wd, M, G, a.wgk, G, G, [&](int r, int c, float4 v) {
      store4(RD + r * wd + c, make_float4(v.x + a.bgk[c], v.y + a.bgk[c + 1],
                                          v.z + a.bgk[c + 2], v.w + a.bgk[c + 3]));
    });
    __syncthreads();
    if (a.S) {
      // a packed slot: the readout and its backward per segment (scann_common.cuh)
      const int* sid = a.seg + (size_t)b * M;
      const SegVectors v = seg_vectors(work + 5 * MW, a.S, wd, M, O, true);
      seg_queries(v, a.S, RC, wd, RD, wd, am, sid, 0, M, G, true);
      __syncthreads();
      seg_readout_backward<kBf16>(v, RD, wd, am, sid, M, a.S, G, O, a.ga_norm, a.mrelu, a.one_shot,
                           a.ct + (size_t)b * a.S,
                           a.one_shot ? nullptr : a.ct_ga + (size_t)b * M, a.wbf, a.bbf, a.wp,
                           a.bp, a.pred + (size_t)b * a.S, 1.f, grad(gWP), grad(gBP),
                           grad(gWBF), grad(gBBF));
      seg_query_key_grads(v, RC, wd, RD, wd, am, sid, 0, M, G);
      __syncthreads();
    } else {
      for (int g = tid; g < G; g += kThreads) {
        float s = 0.f;
        for (int m = 0; m < M; ++m) s += am[m] * RC[m * wd + g];
        qsum[g] = s;
      }
      __syncthreads();
      for (int m = warp; m < M; m += kWarps) {
        const float mm = am[m];
        float cross = 0.f, diag = 0.f;
        for (int g = lane; g < G; g += 32) {
          const float mk = mm * RD[m * wd + g];
          cross += mk * qsum[g];
          diag += mk * (mm * RC[m * wd + g]);
        }
        cross = warp_sum(cross);
        diag = warp_sum(diag);
        if (lane == 0) agg0[m] = mm * (cross - diag);
      }
      __syncthreads();
      if (warp == 0) {
        // M <= 64: lane holds atoms lane and lane + 32
        const bool v0 = lane < M, v1 = lane + 32 < M;
        float s0 = v0 ? agg0[lane] : 0.f, s1 = v1 ? agg0[lane + 32] : 0.f;
        float nrm = 1.f;
        if (a.ga_norm) {
          nrm = sqrtf(warp_sum(s0 * s0 + s1 * s1));
          if (nrm == 0.f) nrm = 1.f;   // single-atom structure: zero sum
          s0 /= nrm;
          s1 /= nrm;
        }
        s0 = v0 ? s0 + (1.0f - am[lane]) * -1e9f : -INFINITY;
        s1 = v1 ? s1 + (1.0f - am[lane + 32]) * -1e9f : -INFINITY;
        const float mx = warp_max(fmaxf(s0, s1));
        const float e0 = v0 ? expf(s0 - mx) : 0.f, e1 = v1 ? expf(s1 - mx) : 0.f;
        const float tot = warp_sum(e0 + e1);
        if (v0) ga[lane] = e0 / tot;
        if (v1) ga[lane + 32] = e1 / tot;
        if (lane == 0) scal[0] = nrm;
      }
      __syncthreads();
      for (int g = tid; g < G; g += kThreads) {
        float s = 0.f;
        for (int m = 0; m < M; ++m) s += am[m] * ga[m] * RD[m * wd + g];
        struc[g] = s;
      }
      __syncthreads();
      tile_gemm<kBf16>(struc, G, 1, G, a.wbf, O, O, [&](int r, int c, float4 v) {
        const float4 s = make_float4(v.x + a.bbf[c], v.y + a.bbf[c + 1], v.z + a.bbf[c + 2],
                                     v.w + a.bbf[c + 3]);
        store4(sbf + c, s);
        store4(sb + c, make_float4(swishf(s.x), swishf(s.y), swishf(s.z), swishf(s.w)));
      });
      __syncthreads();
      if (warp == 0) {
        float p = 0.f;
        for (int o = lane; o < O; o += 32) p += operand<kBf16>(sb[o]) * operand<kBf16>(a.wp[o]);
        p = warp_sum(p) + a.bp[0];
        if (a.mrelu) p = fmaxf(p, 0.f);
        if (lane == 0) {
          a.pred[b] = p;
          scal[1] = a.one_shot ? p - a.ct[b] : a.ct[b];   // straight-through mrelu
        }
      }
      __syncthreads();
      // the head's gradient products (d pred rounded too in the bf16 mode)
      const float ctp = scal[1], nrm = scal[0], c = operand<kBf16>(ctp);
      if (tid == 0) grad(gBP)[0] = ctp;
      for (int o = tid; o < O; o += kThreads) {
        grad(gWP)[o] = operand<kBf16>(sb[o]) * c;
        dsbf[o] = c * operand<kBf16>(a.wp[o]) * swish_grad(sbf[o]);
      }
      __syncthreads();
      for (int i = tid; i < G * O; i += kThreads) {
        const int g = i / O, o = i - g * O;
        grad(gWBF)[i] = operand<kBf16>(struc[g]) * operand<kBf16>(dsbf[o]);
      }
      for (int o = tid; o < O; o += kThreads) grad(gBBF)[o] = dsbf[o];
      for (int g = tid; g < G; g += kThreads) {
        float s = 0.f;
        for (int o = 0; o < O; ++o)
          s += operand<kBf16>(dsbf[o]) * operand<kBf16>(a.wbf[(size_t)g * O + o]);
        dstruc[g] = s;
      }
      __syncthreads();
      for (int m = warp; m < M; m += kWarps) {
        float s = 0.f;
        for (int g = lane; g < G; g += 32) s += am[m] * RD[m * wd + g] * dstruc[g];
        s = warp_sum(s);
        if (lane == 0) dga[m] = s + (a.one_shot ? 0.f : a.ct_ga[(size_t)b * M + m]);
      }
      __syncthreads();
      if (warp == 0) {
        const bool v0 = lane < M, v1 = lane + 32 < M;
        const float g0 = v0 ? ga[lane] : 0.f, g1 = v1 ? ga[lane + 32] : 0.f;
        const float d0 = v0 ? dga[lane] : 0.f, d1 = v1 ? dga[lane + 32] : 0.f;
        const float s = warp_sum(g0 * d0 + g1 * d1);
        float da0 = g0 * (d0 - s), da1 = g1 * (d1 - s);   // softmax over the atoms
        if (a.ga_norm) {
          const float a0 = v0 ? agg0[lane] : 0.f, a1 = v1 ? agg0[lane + 32] : 0.f;
          const float inner = warp_sum(a0 * da0 + a1 * da1);
          da0 = da0 / nrm - a0 * (inner / (nrm * nrm * nrm));
          da1 = da1 / nrm - a1 * (inner / (nrm * nrm * nrm));
        }
        if (v0) dcd[lane] = da0 * am[lane];
        if (v1) dcd[lane + 32] = da1 * am[lane + 32];
      }
      __syncthreads();
      for (int g = tid; g < G; g += kThreads) {
        float s = 0.f;
        for (int m = 0; m < M; ++m) s += dcd[m] * (am[m] * RD[m * wd + g]);
        dqsum[g] = s;
      }
      __syncthreads();
      for (int i = tid; i < M * G; i += kThreads) {
        const int m = i / G, g = i - m * G;
        const float mm = am[m], mk = mm * RD[m * wd + g], mq = mm * RC[m * wd + g];
        const float dmk = dcd[m] * qsum[g] - dcd[m] * mq;
        const float dmq = -dcd[m] * mk + dqsum[g];
        RC[m * wd + g] = mm * dmq;
        RD[m * wd + g] = mm * ga[m] * dstruc[g] + mm * dmk;
      }
      __syncthreads();
    }
    mma_gemm_tA<kBf16>(RB, wd, RC, wd, M, G, G, grad(gWGQ), G, false, grad(gBGQ), false);
    mma_gemm_tA<kBf16>(RB, wd, RD, wd, M, G, G, grad(gWGK), G, false, grad(gBGK), false);
    mma_gemm_tB<kBf16>(RC, wd, M, G, a.wgq, G, G, G, [&](int r, int c, float4 v) {
      store4(RE + r * wd + c, v);
    });
    __syncthreads();
    mma_gemm_tB<kBf16>(RD, wd, M, G, a.wgk, G, G, G, [&](int r, int c, float4 v) {
      const float* e = RE + r * wd + c;
      const float* s = RA + r * wd + c;
      store4(RE + r * wd + c, make_float4((e[0] + v.x) * swish_grad(s[0]), (e[1] + v.y) * swish_grad(s[1]),
                                          (e[2] + v.z) * swish_grad(s[2]), (e[3] + v.w) * swish_grad(s[3])));
    });
    __syncthreads();
    mma_gemm_tA<kBf16>(sC, wd, RE, wd, M, D, G, grad(gWAL), G, false, grad(gBAL), false);
    mma_gemm_tB<kBf16>(RE, wd, M, G, a.wal, G, D, D, [&](int r, int c, float4 v) {
      store4(sDC + r * wd + c, v);
    });
    __syncthreads();
  }

  // ======================= reverse walk over the layers =====================
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
    float* P0 = work;              // ctx + query, then its x-hat
    float* P1 = work + MW;         // o1
    float* P2 = work + 2 * MW;     // s1 = o1 @ W1 + b1
    float* P3 = work + 3 * MW;     // h1 = swish(s1), then d s1
    float* P4 = work + 4 * MW;     // o1 + h2, then d h2
    float* P5 = work + 5 * MW;     // d (o1 + h2), then d o1
    float* oinv = work + 6 * MW;   // [M] rsqrt(var + eps) of ctx + query
    for (int i = tid; i < M * D; i += kThreads) {
      const int m = i / D, d = i - m * D;
      sC[m * wd + d] = c_st[(size_t)l * M * D + i];
      if (sb) {   // the layer's per-atom tensors from the stash
        sQ[m * wd + d] = st_atom(l, 0)[i];
        P1[m * wd + d] = st_atom(l, 1)[i];
        P0[m * wd + d] = st_atom(l, 2)[i];
        P2[m * wd + d] = st_atom(l, 3)[i];
        P3[m * wd + d] = st_atom(l, 4)[i];
      } else {
        P0[m * wd + d] = o_st[(size_t)l * M * D + i];
      }
    }
    if (sb)
      for (int m = tid; m < M; m += kThreads) oinv[m] = st_inv(l, 0)[m];
    __syncthreads();
    const float* br1 = a.br1 + (size_t)l * D;
    const float* br2 = a.br2 + (size_t)l * D;
    // recompute o1 and the ResidualNorm
    if (!sb) {
    for (int m = warp; m < M; m += kWarps) {
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
    mma_gemm<kBf16>(P1, wd, M, D, a.wr1 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
      const float4 s = make_float4(v.x + br1[c], v.y + br1[c + 1], v.z + br1[c + 2], v.w + br1[c + 3]);
      store4(P2 + r * wd + c, s);
      store4(P3 + r * wd + c, make_float4(swishf(s.x), swishf(s.y), swishf(s.z), swishf(s.w)));
    });
    __syncthreads();
    // o1 + h2 rounded as the forward pass rounds it: h2 = (x + b) * mask first
    // (__fmul_rn keeps the compiler from fusing it into the sum), so the
    // ResidualNorm's statistics are the forward's, as the keep-acts stash holds them
    mma_gemm<kBf16>(P3, wd, M, D, a.wr2 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
      const float4 m = mask4(1 + l, r, c);
      const float* o1 = P1 + r * wd + c;
      store4(P4 + r * wd + c, make_float4(o1[0] + __fmul_rn(v.x + br2[c], m.x),
                                          o1[1] + __fmul_rn(v.y + br2[c + 1], m.y),
                                          o1[2] + __fmul_rn(v.z + br2[c + 2], m.z),
                                          o1[3] + __fmul_rn(v.w + br2[c + 3], m.w)));
    });
    __syncthreads();
    }
    // ResidualNorm's LayerNorm backward: P5 = d sum, P4 = d h2 = d sum * mask
    // (its x-hat and rsqrt from the stash, or from o1 + h2)
    for (int m = warp; m < M; m += kWarps) {
      float v[4], dy[4], xh[4], dx[4], mean, inv;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane + 32 * i;
        v[i] = d < D ? (sb ? st_atom(l, 5)[m * D + d] : P4[m * wd + d]) : 0.f;
        dy[i] = d < D ? sDC[m * wd + d] : 0.f;
      }
      if (sb) {
        inv = st_inv(l, 1)[m];
#pragma unroll
        for (int i = 0; i < 4; ++i) xh[i] = v[i];
      } else {
        warp_ln_stats(v, D, lane, mean, inv);
#pragma unroll
        for (int i = 0; i < 4; ++i) xh[i] = lane + 32 * i < D ? (v[i] - mean) * inv : 0.f;
      }
      warp_ln_backward(xh, inv, dy, rls, D, lane, dx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          P5[m * wd + d] = dx[i];
          P4[m * wd + d] = dx[i] * mask1(1 + l, m, d);
          sPart[(warp * 2) * wd + d] += dy[i] * xh[i];
          sPart[(warp * 2 + 1) * wd + d] += dy[i];
        }
      }
    }
    __syncthreads();
    auto flush_ln = [&](float* gs, float* gb) {   // per-warp partials -> gradient row
      for (int d = tid; d < D; d += kThreads) {
        float s0 = 0.f, s1 = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          s0 += sPart[(w * 2) * wd + d];
          s1 += sPart[(w * 2 + 1) * wd + d];
          sPart[(w * 2) * wd + d] = 0.f;
          sPart[(w * 2 + 1) * wd + d] = 0.f;
        }
        gs[d] = s0;
        gb[d] = s1;
      }
    };
    flush_ln(grad(gRLNS) + (size_t)l * D, grad(gRLNB) + (size_t)l * D);
    mma_gemm_tA<kBf16>(P3, wd, P4, wd, M, D, D, grad(gWR2) + (size_t)l * D * D, D, false,
                grad(gBR2) + (size_t)l * D, false);
    __syncthreads();
    mma_gemm_tB<kBf16>(P4, wd, M, D, a.wr2 + (size_t)l * D * D, D, D, D, [&](int r, int c, float4 v) {
      const float* s = P2 + r * wd + c;
      store4(P3 + r * wd + c, make_float4(v.x * swish_grad(s[0]), v.y * swish_grad(s[1]),
                                          v.z * swish_grad(s[2]), v.w * swish_grad(s[3])));
    });
    __syncthreads();
    mma_gemm_tA<kBf16>(P1, wd, P3, wd, M, D, D, grad(gWR1) + (size_t)l * D * D, D, false,
                grad(gBR1) + (size_t)l * D, false);
    mma_gemm_tB<kBf16>(P3, wd, M, D, a.wr1 + (size_t)l * D * D, D, D, D, [&](int r, int c, float4 v) {
      float* p = P5 + r * wd + c;
      store4(p, make_float4(p[0] + v.x, p[1] + v.y, p[2] + v.z, p[3] + v.w));
    });
    __syncthreads();
    // attention LayerNorm backward: d ctx = d query = LN'(d o1) -> sDQ
    for (int m = warp; m < M; m += kWarps) {
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
    __syncthreads();
    flush_ln(grad(gLNS) + (size_t)l * D, grad(gLNB) + (size_t)l * D);
    if (!sb) project_atoms(l);   // the stash holds the query, and u_pre in place of cw
    zero(sDCW, MW);
    zero(sDCN, MW);
    zero(sAcc, 2 * wd);
    __syncthreads();

    // ---- the (atom, neighbour) rows, chunk by chunk ------------------------
    int ci = 0;
    for (int m0 = 0; m0 < M; m0 += CA, ++ci) {
      const int ca = min(CA, M - m0), rows = ca * N, base = m0 * N;
      stage_chunk(l, m0, rows, sb != 0);
      row_forward(l, m0, ca, false, false, sb != 0);
      // d attn = mask * nmask * sum_{d in head} d ctx * key, then the softmax
      // backward over the N neighbours, on the pre-dropout attention
      warp_softmax_backward<kBf16>(sDQ + m0 * wd, wd, sW, ldu, nmask + base,
                            a.attn_dropout ? sM : nullptr, sE, sF, ca, N, H, hd);
      __syncthreads();
      // d key (in place of the key) and d query = d ctx + dk sum_n de key
      for (int i = tid; i < ca * D; i += kThreads) {
        const int at = i / D, d = i - at * D, h = d / hd, m = m0 + at;
        const float dctx = sDQ[m * wd + d];
        const float qs = sQ[m * wd + d] * a.dk;
        float ex = 0.f;
        for (int n = 0; n < N; ++n) {
          const int r = at * N + n;
          const float de = sF[r * H + h];
          const float used =
              operand<kBf16>(a.attn_dropout ? sE[r * H + h] * sM[r * H + h] : sE[r * H + h]);
          ex += de * sW[r * ldu + d];
          sW[r * ldu + d] = dctx * used * nmask[base + r] + de * qs;
        }
        sDQ[m * wd + d] = dctx + ex * a.dk;
      }
      __syncthreads();
      // key = kin @ Wk + bk
      mma_gemm_tA<kBf16>(sV, ldu, sW, ldu, rows, D, D, grad(gWK) + (size_t)l * D * D, D, ci > 0, sAcc, true);
      __syncthreads();
      mma_gemm_tB<kBf16>(sW, ldu, rows, D, wk, D, D, D, [&](int r, int c, float4 v) { store4(sV + r * ldu + c, v); });
      __syncthreads();
      if (a.g_update) {
        // kin = ns * geo', geo' = LN_g(swish(u_pre) + geo); geo' and LN_g's
        // x-hat and rsqrt from the stash, or recomputed (one instantiation
        // each, so the recompute schedule's loop is free of the stash's code)
        const float* gs = a.lng_s + (size_t)l * D;
        const float* gb = a.lng_b + (size_t)l * D;
        auto lng_rows = [&](auto from_stash) {
          constexpr bool kStashed = decltype(from_stash)::value;
          for (int r = warp; r < rows; r += kWarps) {
            float v[4], xh[4], g[4], dy[4], dx[4], mean, inv;
            const size_t e = (size_t)(base + r) * D;
            if constexpr (kStashed) {
              inv = a.st_ginv[((size_t)b * L + l) * R + base + r];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int d = lane + 32 * i;
                xh[i] = d < D ? stash_get(a.st_rows, st_row(l, 4) + e + d, sb) : 0.f;
                g[i] = d < D ? stash_get(a.st_rows, st_row(l, 3) + e + d, sb) : 0.f;
              }
            } else {
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
                g[i] = d < D ? xh[i] * gs[d] + gb[d] : 0.f;
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int d = lane + 32 * i;
              dy[i] = 0.f;
              if (d < D) {
                const float dkin = sV[r * ldu + d], ns = sA[r * lda + D + d];
                sV[r * ldu + d] = dkin * g[i];   // d ns from the key input
                dy[i] = dkin * ns + (l + 1 < L ? dgb[(size_t)(base + r) * D + d] : 0.f);
              }
            }
            warp_ln_backward(xh, inv, dy, gs, D, lane, dx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int d = lane + 32 * i;
              if (d < D) {
                sW[r * ldu + d] = dx[i];                                // d r (residual into geo)
                sU[r * ldu + d] = dx[i] * swish_grad(sU[r * ldu + d]);    // d u_pre
                sPart[(warp * 2) * wd + d] += dy[i] * xh[i];
                sPart[(warp * 2 + 1) * wd + d] += dy[i];
              }
            }
          }
        };
        if (sb) lng_rows(std::true_type{});
        else lng_rows(std::false_type{});
      } else {
        for (int i = tid; i < rows * D; i += kThreads) {
          const int r = i / D, d = i - r * D;
          const float u = sU[r * ldu + d], w = nweight[base + r];
          const float dkin = sV[r * ldu + d];
          sV[r * ldu + d] = dkin * (sb ? stash_get(a.st_rows, st_row(l, 3) + (size_t)(base + r) * D + d, sb)
                                       : swishf(u) * w);
          sU[r * ldu + d] = dkin * sA[r * lda + D + d] * w * swish_grad(u);
        }
      }
      __syncthreads();
      if (a.g_update) {
        mma_gemm_tA<kBf16>(sA, lda, sU, ldu, rows, 2 * D, D,
                    grad(gWFG) + (size_t)l * fg_in * D + (size_t)D * D, D, ci > 0, sAcc + wd, true);
        for (int i = tid; i < ca * D; i += kThreads) {
          const int at = i / D, d = i - at * D;
          float s = 0.f;
          for (int n = 0; n < N; ++n) s += sU[(at * N + n) * ldu + d];
          sDCW[(m0 + at) * wd + d] = s;
        }
        // d geo_in = d r + d u_pre @ Wg^T;  d ns += d u_pre @ Wn^T
        float* dg_out = dgb + (size_t)base * D;
        mma_gemm_tB<kBf16>(sU, ldu, rows, D, wfg + (size_t)D * D, D, D, D, [&](int r, int c, float4 v) {
          const float* dr = sW + r * ldu + c;
          store4(dg_out + (size_t)r * D + c, make_float4(dr[0] + v.x, dr[1] + v.y, dr[2] + v.z, dr[3] + v.w));
        });
        mma_gemm_tB<kBf16>(sU, ldu, rows, D, wfg + (size_t)2 * D * D, D, D, D, [&](int r, int c, float4 v) {
          float* p = sV + r * ldu + c;
          store4(p, make_float4(p[0] + v.x, p[1] + v.y, p[2] + v.z, p[3] + v.w));
        });
      } else {
        mma_gemm_tA<kBf16>(sA, lda, sU, ldu, rows, K, D, grad(gWFG) + (size_t)l * fg_in * D, D, ci > 0,
                    sAcc + wd, true);
      }
      __syncthreads();
      // the gather's transpose: d centers[idx] += d ns, in row order
      if (sc_part < np)
        for (int r = 0; r < rows; ++r) {
          const int idx = nbr[base + r];
          if (idx % np == sc_part) sDCN[idx * wd + sc_d] += operand<kBf16>(sV[r * ldu + sc_d]);
        }
      __syncthreads();
    }

    // ---- per-atom gradients of the layer -----------------------------------
    if (a.g_update) flush_ln(grad(gLNGS) + (size_t)l * D, grad(gLNGB) + (size_t)l * D);
    for (int d = tid; d < D; d += kThreads) {
      grad(gBK)[(size_t)l * D + d] = sAcc[d];
      grad(gBFG)[(size_t)l * D + d] = sAcc[wd + d];
    }
    mma_gemm_tA<kBf16>(sC, wd, sDQ, wd, M, D, D, grad(gWQ) + (size_t)l * D * D, D, false,
                grad(gBQ) + (size_t)l * D, false);
    if (a.g_update)
      mma_gemm_tA<kBf16>(sC, wd, sDCW, wd, M, D, D, grad(gWFG) + (size_t)l * fg_in * D, D, false);
    mma_gemm_tB<kBf16>(sDQ, wd, M, D, a.wq + (size_t)l * D * D, D, D, D, [&](int r, int c, float4 v) {
      float* p = sDCN + r * wd + c;
      store4(p, make_float4(p[0] + v.x, p[1] + v.y, p[2] + v.z, p[3] + v.w));
    });
    __syncthreads();
    if (a.g_update) {
      mma_gemm_tB<kBf16>(sDCW, wd, M, D, wfg, D, D, D, [&](int r, int c, float4 v) {
        float* p = sDCN + r * wd + c;
        store4(p, make_float4(p[0] + v.x, p[1] + v.y, p[2] + v.z, p[3] + v.w));
      });
    }
    __syncthreads();
    float* t = sDC;
    sDC = sDCN;
    sDCN = t;
  }

  // ======================= embedding backward ===============================
  {
    float* E1 = work + 2 * M * lde + M * ldf;   // d s_de [M, wd]
    float* E2 = work + M * lde + M * ldf;       // d emb  [M, lde]
    stage_embedding();
    mma_gemm<kBf16>(sEmb, lde, M, ke, a.wde, D, D, [&](int r, int c, float4 v) {
      const float4 m = mask4(0, r, c);
      const float* dc = sDC + r * wd + c;
      store4(E1 + r * wd + c,
             make_float4(dc[0] * m.x * swish_grad(v.x + a.bde[c]),
                         dc[1] * m.y * swish_grad(v.y + a.bde[c + 1]),
                         dc[2] * m.z * swish_grad(v.z + a.bde[c + 2]),
                         dc[3] * m.w * swish_grad(v.w + a.bde[c + 3])));
    });
    __syncthreads();
    mma_gemm_tA<kBf16>(sEmb, lde, E1, wd, M, ke, D, grad(gWDE), D, false, grad(gBDE), false);
    mma_gemm_tB<kBf16>(E1, wd, M, D, a.wde, D, lde, ke, [&](int r, int c, float4 v) {
      store4(E2 + r * lde + c, v);
    });
    __syncthreads();
    if (a.cgcnn) {
      mma_gemm_tA<kBf16>(sFeat, ldf, E2, lde, M, a.F, a.E, grad(gEMBED), a.E, false, grad(gBEMBED), false);
    } else {
      // the one-hot embedding's transpose: scatter d emb into the rows of Z
      float* ge = grad(gEMBED);
      for (int e = tid; e < a.E; e += kThreads) {
        for (int z = 0; z < a.V; ++z) ge[(size_t)z * a.E + e] = 0.f;
        for (int m = 0; m < M; ++m)
          ge[(size_t)a.atomic[(size_t)b * M + m] * a.E + e] += operand<kBf16>(E2[m * lde + e]);
      }
    }
    if (a.use_ring) {
      for (int i = tid; i < 30; i += kThreads) {
        const int k = i / 10, j = i - k * 10;   // k == 2: the bias
        float s = 0.f;
        for (int m = 0; m < M; ++m) {
          const float dr = E2[m * lde + a.E + j];
          s += k < 2 ? operand<kBf16>(a.ring[((size_t)b * M + m) * 2 + k]) * operand<kBf16>(dr) : dr;
        }
        if (k < 2) grad(gWRING)[k * 10 + j] = s;
        else grad(gBRING)[j] = s;
      }
    }
    __syncthreads();
  }

  // ======================= SCANN+ geometry embedding backward ===============
  if (a.g_update) {
    int ci = 0;
    for (int m0 = 0; m0 < M; m0 += CA, ++ci) {
      const int ca = min(CA, M - m0), rows = ca * N, base = m0 * N;
      for (int i = tid; i < rows * K; i += kThreads) {
        const int r = i / K, k = i - r * K;
        const float t = ndist[base + r] - a.dist_centers[k];
        const float u = nweight[base + r] - a.angle_centers[k];
        sA[r * lda + k] = expf(-(t * t) / a.rbf_width);
        sA[r * lda + D + k] = expf(-(u * u) / a.rbf_width);
      }
      __syncthreads();
      mma_gemm<kBf16>(sA, lda, rows, K, a.wnd, D, D, [&](int r, int c, float4 v) {
        store4(sU + r * ldu + c, make_float4(v.x + a.bnd[c], v.y + a.bnd[c + 1],
                                           v.z + a.bnd[c + 2], v.w + a.bnd[c + 3]));
      });
      mma_gemm<kBf16>(sA + D, lda, rows, K, a.wnw, D, D, [&](int r, int c, float4 v) {
        store4(sV + r * ldu + c, make_float4(v.x + a.bnw[c], v.y + a.bnw[c + 1],
                                           v.z + a.bnw[c + 2], v.w + a.bnw[c + 3]));
      });
      __syncthreads();
      for (int i = tid; i < rows * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        const float g = dgb[(size_t)base * D + i], snd = sU[r * ldu + d], snw = sV[r * ldu + d];
        sU[r * ldu + d] = g * swishf(snw) * swish_grad(snd);
        sV[r * ldu + d] = g * swishf(snd) * swish_grad(snw);
      }
      __syncthreads();
      mma_gemm_tA<kBf16>(sA, lda, sU, ldu, rows, K, D, grad(gWND), D, ci > 0, grad(gBND), ci > 0);
      mma_gemm_tA<kBf16>(sA + D, lda, sV, ldu, rows, K, D, grad(gWNW), D, ci > 0, grad(gBNW), ci > 0);
      __syncthreads();
    }
  }
}

// Launches the backward kernel (one block per molecule) in the operand mode
// kBf16 and the reduction of its gradient rows into out [P]. Pointer 54 is
// the segment ids [B, M] (null unless packed), pointers 55-59 the keep-acts
// stash (rows [B, L, 4 or 5, M*N, D] in the stash's element type, attention
// [B, L, M*N, H], LN_g's rsqrt [B, L, M*N] (SCANN+), per-atom tensors [B, L,
// 6, M, D] and rsqrt [B, L, 2, M], all null in the recompute schedule), size
// 21 the segments per slot S and size 22 the stash's element bytes (0, 4 or
// 2).
template <bool kBf16>
int launch_backward(void* const* ptrs, const int* dims, const float* scalars,
                    const unsigned int* rng, const long long* offsets, float* out, void* stream) {
  Args a;
  unpack_backward_args(a, ptrs, dims, scalars, rng, offsets);
  a.seg = (const int*)ptrs[54];
  a.S = dims[21];
  a.stash = dims[22];
  a.st_rows = ptrs[55];
  a.st_attn = ptrs[56];
  a.st_ginv = (float*)ptrs[57];
  a.st_atoms = (float*)ptrs[58];
  a.st_inv = (float*)ptrs[59];
  if ((a.stash != 0 && a.stash != 4 && a.stash != 2) ||
      (a.stash != 0) != (a.st_rows && a.st_attn && a.st_atoms && a.st_inv) ||
      (a.stash != 0 && a.g_update) != (a.st_ginv != nullptr))
    return kErrShape;
  if (a.S < 0 || a.S > kMaxSegments || (a.S > 0) != (a.seg != nullptr)) return kErrShape;
  if (a.M > 64 || a.M < 1 || a.chunk_atoms < 1 || a.chunk_atoms * a.N > kMaxChunkRows ||
      a.D > 128 || a.G > 128 || a.O > 128 || (a.D & 3) || (a.G & 3) || (a.O & 3) || (a.E & 3) ||
      a.D % a.H || a.K > a.D || a.P <= 0)
    return kErrShape;
  const int bytes = make_plan(a).total * (int)sizeof(float);
  if (bytes > kMaxSharedBytes) return kErrSharedMemory;
  cudaError_t err = cudaFuncSetAttribute(scann_backward_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  scann_backward_kernel<kBf16><<<a.B, kThreads, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce_rows(a.grad_rows, a.B, a.P, out, s);
}

const char* error_string(int code) {
  if (code == kErrSharedMemory) return "shared-memory plan exceeds 227 KB per block";
  if (code == kErrShape) return "shape outside what the kernel takes";
  return cudaGetErrorString((cudaError_t)code);
}

}  // namespace

#ifndef SCANN_BACKWARD_BF16
extern "C" int scann_backward_shared_bytes(const int* dims) {
  Args a = {};
  a.B = dims[0]; a.M = dims[1]; a.N = dims[2]; a.D = dims[3]; a.H = dims[4];
  a.E = dims[5]; a.K = dims[6]; a.G = dims[7]; a.O = dims[8]; a.L = dims[9];
  a.F = dims[10]; a.cgcnn = dims[12]; a.use_ring = dims[13]; a.chunk_atoms = dims[18];
  a.S = dims[21];
  return make_plan(a).total * (int)sizeof(float);
}

extern "C" int scann_backward_launch(void* const* ptrs, const int* dims, const float* scalars,
                                     const unsigned int* rng, const long long* offsets,
                                     float* out, void* stream) {
  return launch_backward<false>(ptrs, dims, scalars, rng, offsets, out, stream);
}

extern "C" const char* scann_backward_error_string(int code) { return error_string(code); }

// ptrs: A [rows, K], W [K, nc], WT [nc, K], Y [rows, nc], then the outputs
// A @ W [rows, nc], A @ WT^T [rows, nc], 2 A^T Y [K, nc] and 2 colsum(Y) [nc];
// dims: rows, K, nc.
extern "C" int scann_mma_selftest_launch(void* const* ptrs, const int* dims, const float*,
                                         void* stream) {
  return launch_mma_selftest((const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2],
                             (const float*)ptrs[3], (float*)ptrs[4], (float*)ptrs[5],
                             (float*)ptrs[6], (float*)ptrs[7], dims[0], dims[1], dims[2],
                             (cudaStream_t)stream);
}

extern "C" const char* scann_mma_selftest_error_string(int code) { return error_string(code); }
#else
// The bf16 operand mode (scann_backward_bf16.cu), with the f32 build's
// arguments.
extern "C" int scann_backward_bf16_launch(void* const* ptrs, const int* dims,
                                          const float* scalars, const unsigned int* rng,
                                          const long long* offsets, float* out, void* stream) {
  return launch_backward<true>(ptrs, dims, scalars, rng, offsets, out, stream);
}

extern "C" const char* scann_backward_bf16_error_string(int code) { return error_string(code); }
#endif
