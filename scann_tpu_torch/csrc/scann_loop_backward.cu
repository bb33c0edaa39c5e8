// Whole-model SCANN / SCANN+ backward for crystals: every parameter gradient
// of one batch, a cluster of CUDA blocks per structure, plus the reduction
// that sums the per-block gradients in a fixed order.
//
// Replaces the TPU kernel scann_tpu/kernels/scann_loop.py:_bwd_kernel (the
// Pallas loop backward). It computes what
// scann_backward.cu computes (the forward with the Philox training dropout of
// philox.cuh, pred, and the reverse walk: head and GA readout, then per layer
// from the last the ResidualNorm, the attention LayerNorm, the softmax on the
// pre-dropout probabilities, key and query, the SCANN+ geometry update or the
// SCANN filter, the neighbour gather's transpose; then the embedding and the
// SCANN+ geometry embedding), in cotangent mode (d pred [B], d ga [B, M]) or
// in one-shot training mode (targets in, the residual pred - t formed here,
// mrelu straight-through), for structures too large for that kernel's
// shared-memory plan: MP2018 at (M=96, N=32, L=9) and Pt/graphene at (M=128,
// N=32, L=11), D=128. For a packed batch (S > 0 segments per slot, each row's
// segment in seg [B, M], -1 on padding) d pred, the targets and pred are
// [B, S] and the readout and its backward run per segment (scann_common.cuh's
// seg_* routines; the TPU kernel's scann_loop.py:630-700), in every block of
// the cluster as the unpacked readout does; the one-shot residual of a segment
// without atoms is zeroed.
//
// Bound. loop_backward_flops (kernels/scann_loop.py) counts ~5.5e11 FLOP that
// the function needs per MP2018 training batch (B=64, M=96, N=32, L=9,
// D=128): bound by operations, ~3.37 ms as three TF32 passes per product at
// the H100 SXM's dense 495 TFLOP/s TF32 (the energies and context on the
// CUDA cores at 67 TFLOP/s FP32). The recompute schedule's 1.8e11 FLOP of
// recompute (loop_recompute_flops), or the selective stash's 8.1e9 and 5.5
// GB of stash traffic, come on top and are not in the bound.
//
// Design.
// - Schedule. The forward pass stashes in global scratch each layer's input
//   centers [L + 1, M, D], its ctx + query before the attention LayerNorm
//   [L, M, D] and, for SCANN+, its input geometry [L, M*N, D]; the reverse
//   walk recomputes a layer's per-atom activations from the two [M, D]
//   stashes. Its (atom, neighbour) rows come, chunk by chunk, from one of two
//   schedules, a runtime argument of the launch (a.stash):
//   - the selective activation stash (scann_loop.py:597-622, 726-769; the
//     default wherever loop_stash_mode admits it): the forward pass also
//     writes each chunk's neighbour states, u_pre and keys [L, M*N, D] and
//     attention [L, M*N, H], straight from the chunk buffers, and the reverse
//     walk reads them back in the same chunk order in place of the gather,
//     the u_pre and key products and the energies' softmax; it rebuilds the
//     key input (SCANN+: LN_g of swish(u_pre) + the input geometry), the
//     query from the layer's input centers, and o1 and the attention
//     LayerNorm's statistics from the ctx + query stash. The f32 stash runs
//     the recompute schedule's arithmetic on the same values, so its
//     gradients are the same bits. The bf16 stash (SCANN_TPU_LOOP_STASH_BF16)
//     rounds the four row buffers to bfloat16 on the way in, and, as the TPU
//     kernel rebuilds ctx from the rounded attention and keys, the forward
//     stashes ctx + query from those rounded values and o1 itself [L, M, D] in
//     f32. Dropout masks are replayed from Philox, never stashed;
//   - the recompute schedule (SCANN_TPU_LOOP_STASH=0, or a shape whose stash
//     exceeds the budget): the rows once more from the gather, exact f32.
// - Products: split-TF32 mma.sync (scann_mma.cuh): each warp owns 16 output
//   columns, so a weight element leaves L2 once per chunk of rows; the chunk's
//   buffers have row strides of 2D + 4 and D + 4 floats, which keeps the
//   fragment reads free of bank conflicts. Weight gradients add into the
//   block's gradient row 16 bytes a thread, and the bias sums fall out of the
//   same fragments. Softmax over the neighbours and its backward run one warp
//   per (atom, head).
// - A cluster of C blocks per structure (C = 1, 2 or 4, chosen by the wrapper
//   from the batch size so that a batch of 64 fills 128 of the card's 132
//   SMs; up to 8 in the *_d256 builds, below). The blocks split the
//   structure's atoms into C contiguous ranges.
//   What crosses blocks: the new centers of a layer go to the global stash,
//   then a cluster barrier, then every block reloads all M rows; the readout's
//   first pass (three small products on [M, D]) runs in every block; in the
//   reverse walk each block scatters d(neighbour state) into its own [M, D]
//   buffer, and after a cluster barrier each block sums, for its own atoms,
//   the C partial rows in rank order through distributed shared memory.
// - Where the state lives (the narrow build; the tall and wide builds below
//   move the resident buffer to global memory). Only one [M, max(D, G)]
//   buffer stays in shared memory: the current centers in the forward pass (every atom's gather may
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
// - Tall structures (N <= kMaxChunkRows, M past that plan; the tall builds,
//   scann_loop_backward_tall.cu and _tall_bf16.cu, all three schedules): the
//   resident buffer leaves shared memory, each of its three roles for a
//   global home. The forward pass gathers from the layer-input stash, as the
//   reverse walk does (each layer's rows are written once, before the
//   barrier that precedes their reads), and stages a block's own rows into a
//   slot for its projections. The readout's GA keys go to the block's own
//   slice of a global scratch, d gk of pass 2 to a free slot. The reverse
//   walk's d(layer input) partial is the block's own global [M, D], scattered
//   into by the same threads in the same order, zeroed each layer; the
//   cluster sums the C partials in rank order, read past L1 (other SMs wrote
//   them, and this SM read them a layer before), into the d(layer output)
//   scratch, which the embedding backward reads in place of the resident
//   copy. The plan drops M * 512 bytes and spends them on chunks of up to
//   kTallChunkRows = 64 rows (two atoms at N = 32) with atom blocks of 16 at
//   D = 128 (32 at N = 24), for M into the thousands. What bounds the build
//   (clock64() marks, Pt/graphene and MP2018 at M = 322, N = 32) is latency
//   at 8 warps an SM, spread over the chunk's steps: the rows' forward
//   (staging, the u_pre and key products, the elementwise pass, the softmax)
//   takes ~45% of the recompute schedule's time in its two passes, the
//   weight gradients ~15%, the scatter ~10%, the rows' backward products,
//   the elementwise backward and the per-atom work most of the rest. So a
//   chunk of twice the rows pays each fixed cost once for 64 rows: each
//   mma_gemm_tA sums 64 rows in its accumulators before its
//   read-modify-write of the block's gradient row (half the gradient-row
//   traffic), a barrier waits once, the LayerNorm partials flush once.
//   Beside that, tall-only code (under kTall, so the other builds compile
//   as before): the gather loads four quads a thread before storing them,
//   tall_scatter overlaps the L2 round trips of 16 rows, the softmax passes
//   read the head's values as float4, and a weight gradient with few rows
//   (SCANN's [K, D] filter) spreads over all 8 warps (tall_gemm_tA). The
//   row products stay scann_mma.cuh's: a four-m-tile product (each weight
//   fragment for 64 rows) was faster at Pt/graphene but its registers
//   spilled and cost MP2018 10%. A row's products, activations and
//   cotangents are the narrow build's bits; the weight gradients, their
//   bias and LayerNorm-parameter sums, and the d(layer input) partials
//   (the per-atom adds come per block of 16) are summed in another order,
//   so they differ from the narrow build's in the last bits (within 1e-4 x
//   max in f32), and repeat bit for bit from run to run at one cluster size.
// - Wide neighbour lists (32 < N <= 256; the wide builds,
//   scann_loop_backward_wide.cu and _wide_bf16.cu, all three schedules): one
//   atom at a time, its rows in sub-chunks of kWideChunkRows = 64. The forward
//   pass keeps the atom's energies [N, H] in shared memory for a softmax over
//   all N (wide_softmax of scann_mma.cuh). The reverse walk runs the softmax
//   backward over all N, which needs sum_n p f before any row's p (f - s), so
//   it takes two passes over an atom: the first forms every row's attention
//   (recomputed from the energies, or staged from the stash) and d attention,
//   the second runs the rows' backward sub-chunk by sub-chunk, the d query's
//   sum over the neighbours carried from one sub-chunk to the next. A phase
//   split (clock64() marks, MP2018 (64, 80, 96) recompute) found the rows
//   formed three times there, ~51% of the time, with 32-row sub-chunks that
//   each paid the weight gradients' read-modify-write and the fixed costs.
//   So the resident buffer's three roles take the tall build's global
//   homes, so the plan does not grow with M (atom blocks of 16 up to N = 184
//   and 8 beyond at D = 128) and spends the shared memory on 64-row
//   sub-chunks; where one sub-chunk holds an atom's list (N <= 64) the
//   forward's context reads the keys from the chunk and the reverse walk's
//   second pass keeps the first pass's rows; past it the forward's keys go to
//   the block's rows of the atom in global memory, and the recompute
//   schedule's first pass keeps each sub-chunk's ns, u_pre and key there too
//   (L2), so that its second pass stages them as the f32 stash does instead
//   of forming them again: the reverse walk forms a row once in every
//   schedule (a stash's first pass stages only the keys and the attention).
//   What bounds the build now (the same split): latency at 8 warps an SM,
//   spread over the rows' forward in the forward pass and the reverse
//   walk's first pass (~38% at the recipe batch), the weight gradients
//   (~15%), the rows' backward products (~13%) and the elementwise backward
//   (~11%); the scatter into L2 (~4.5%, from ~3% into shared memory) and
//   the 16-atom blocks' per-atom work (2-4%, twice the 32-atom blocks') are
//   what the global homes cost. The context's key loads, eight in flight a
//   thread, measured no faster than the plain loop, which stays.
// - Widths past 128 (D, G, O up to 256; the *_d256 builds,
//   scann_loop_backward_tall_d256.cu, _wide_d256.cu and their _bf16 twins,
//   all three schedules): the tall and wide builds with SCANN_WIDTH_256, so
//   a warp's LayerNorm rows hold kLaneValues = 8 values a lane
//   (scann_common.cuh; warp_ln_stats and warp_ln_backward of
//   scann_grad_common.cuh take either), and the launcher takes widths up to
//   kMaxWidth. The narrow build, whose resident [M, max(D, G)] buffer
//   leaves no room at these widths, is not built for them: every N <= 32
//   takes the tall build, in chunks of 32 rows with atom blocks of 8 at D =
//   256 (the wrapper's plan, the first of 64, 32, 16 rows that fits), and
//   every N > 32 the wide one, in sub-chunks of the larger of kWideChunkRows
//   = 64 and 32 rows whose plan fits (build_plan: 64 at D = 136 with atom
//   blocks of 8, 32 with atom blocks of 4 at D = 256, (80, 96)). A 64-row
//   chunk cannot fit at D = 256: the reverse walk holds four [rows, D + 4]
//   buffers at once (ns, u_pre, kin, d key at gWK), 266 KB for 64 rows.
//   What bounds these builds (clock64() marks of block 0, NVIDIA H100 80GB
//   HBM3 at 700 W, MP2018 (64, 96, 32) with the f32 stash): the weight
//   gradients of the chunks' rows (gWK, gWFG) took 31% of the time, the
//   row products 19% in the reverse walk and 15% in the forward pass, the
//   per-atom work of the 8-atom blocks 10%, the LN_g backward 7%. A
//   gradient's products cost 1.6 x the same product into rows; with the adds
//   into the gradient row left out (a measurement only) the build took 24%
//   less, and with half of them 12% less: each block's gradient row of a
//   layer (768 KB at D = 256) misses L2 beside the 127 others, and a
//   block's adds held its later loads back. So past 128 columns every add
//   into a gradient row, a LayerNorm partial or a d(layer input) partial is
//   a reduction (red_add4 / red_add of scann_mma.cuh) that the warp does not
//   wait for (tall_gemm_tA, mma_gemm_tA, flush_ln, tall_scatter and the
//   per-atom d(layer input) adds, each under kD256): the same adds by the
//   same thread in the same order, so the same sums as a load, an add and
//   a store; and a launch takes up to kMaxCluster = 8 blocks a structure
//   (kernels/scann_loop.py backward_cluster: the largest C whose B clusters
//   the card runs at once), so a batch of 16 runs 96 blocks, not 64. Two
//   ways of fewer adds were measured and dropped: a chunk's operands kept
//   in L2 for the next chunk's products (one add for two chunks; the
//   products' reads from L2 cost what the adds saved) and pairs of blocks
//   sharing a chunk through distributed shared memory (the same; four
//   cluster barriers a chunk on top); so was a product that keeps 32
//   output columns a warp (it spilled). The arithmetic and its order are
//   the builds' of widths up to 128; those compile the same text
//   (kLaneValues 4), their adds the load-add-store they had.
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
// - bf16 operand mode (model.dtype "bfloat16"; scann_loop.py:1096 bf16=): the
//   kernel is a template on kBf16 and rounds where scann_backward.cu does
//   (its note lists the places); packed segments pool as bf16-mode
//   products with each segment's own max shift (seg_*<true> of
//   scann_common.cuh, scann_loop.py:636-714), as kernel #3 does. This file
//   builds the f32 instantiation; scann_loop_backward_bf16.cu includes it
//   with SCANN_LOOP_BACKWARD_BF16 defined and builds the bf16 one in its own
//   nvcc, so the two compile in parallel (the wide and tall builds the same
//   way, a source for each mode). The wide walk rounds where the narrow one
//   does: warp_energies<true> and warp_attention_grad<true> round each lane's
//   product before the head sum as warp_energy_softmax<true> and
//   warp_softmax_backward<true> do, wide_softmax_backward<true> rounds d
//   energy, and both passes over an atom's rows form the attention the
//   context uses as operand<kBf16>(attention x dropout) x mask, as the narrow
//   chunk does.
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
constexpr int kMaxCluster = kLaneValues > 4 ? 8 : 4;   // 8 in the *_d256 builds

// The tall build (scann_loop_backward_tall.cu defines
// SCANN_LOOP_BACKWARD_TALL): no resident [M, wd] buffer; every other build
// keeps it in shared memory.
#ifdef SCANN_LOOP_BACKWARD_TALL
constexpr bool kTall = true;
#else
constexpr bool kTall = false;
#endif

// The builds of widths past 128 (the *_d256 sources: SCANN_WIDTH_256).
constexpr bool kD256 = kLaneValues > 4;

// The tall build's chunk of (atom, neighbour) rows: up to 64 (two atoms at
// N = 32, four at N = 16, eight at N = 8), in the shared memory the resident
// buffer left. Past 128 columns (the *_d256 builds) the wrapper's plan takes
// the first of 64, 32 and 16 rows that fits: 32 at D = 256.
constexpr int kTallChunkRows = 64;

// The wide build's sub-chunk of one atom's (atom, neighbour) rows: 64, in the
// shared memory the resident buffer left (that buffer's roles take the tall
// build's global homes in the wide build too); at N <= 64 one sub-chunk holds
// the atom's whole list. Past 128 columns (the *_d256 builds) build_plan
// takes 64 where that plan fits a block (D = 136), else 32: 64 rows of
// [2D + 4] and three [D + 4] buffers do not fit at D = 256, so every wide
// N there takes more than one sub-chunk.
constexpr int kWideChunkRows = 64;

// The gather's transpose into the tall build's global d(layer input)
// partial [M, ldd] for one thread: column d of the targets with index % np ==
// part, dst[idx * ldd + d] += operand(src[r * lds + d]) for the chunk's rows r
// in order (nbr: their neighbour indices). Sixteen rows' targets are loaded
// at once, so their L2 latencies overlap; a target met again among the
// sixteen takes the running sum, so each element's additions are those of
// the one-row-at-a-time walk, in its order.
template <bool kBf16>
__device__ __forceinline__ void tall_scatter(float* dst, const int* nbr, const float* src,
                                             int lds, int ldd, int rows, int np, int part,
                                             int d) {
  if constexpr (kD256) {             // one reduction a row, in row order: nothing to wait for
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const int idx = __ldg(nbr + r);
      if (idx % np == part) red_add(dst + (size_t)idx * ldd + d, operand<kBf16>(src[r * lds + d]));
    }
    return;
  }
  constexpr int kGroup = 16;
#pragma unroll 1
  for (int r0 = 0; r0 < rows; r0 += kGroup) {
    int idx[kGroup];
    float v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      idx[j] = r0 + j < rows ? __ldg(nbr + r0 + j) : -1;
      if (idx[j] % np != part) idx[j] = -1;
      v[j] = idx[j] >= 0 ? dst[(size_t)idx[j] * ldd + d] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (idx[j] < 0) continue;
      float s = v[j];
#pragma unroll
      for (int i = 0; i < j; ++i)
        if (idx[i] == idx[j]) s = v[i];
      v[j] = s + operand<kBf16>(src[(r0 + j) * lds + d]);
      dst[(size_t)idx[j] * ldd + d] = v[j];
    }
  }
}

// mma_gemm_tA of scann_mma.cuh for the tall build's weight gradients of a
// chunk's rows: where the header's units of 32 rows x 64 columns of Gout
// would leave warps idle (a gradient with few rows, as SCANN's RBF filter
// [K, D] at K = 20: 2 units for 8 warps), units of 32 x 16 columns, so
// every warp takes one. Each element's sum (over the rows in order, then
// one addition into Gout; the column sums by the same tree) is the
// header's: the same bits.
template <bool kBf16>
__device__ __forceinline__ void tall_gemm_tA(const float* X, int ldx, const float* Y, int ldy,
                                             int rows, int I, int J, float* Gout, int ldg,
                                             bool accumulate, float* colsum, bool sum_accumulate) {
  if (((I + 31) >> 5) * ((J + 63) >> 6) >= kWarps) {
    mma_gemm_tA<kBf16>(X, ldx, Y, ldy, rows, I, J, Gout, ldg, accumulate, colsum, sum_accumulate);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int jgroups = (J + 15) >> 4;
#pragma unroll 1
  for (int u = warp; u < ((I + 31) >> 5) * jgroups; u += kWarps) {
    const int i0 = (u / jgroups) * 32, j0 = (u % jgroups) * 16, jc = j0 + 2 * g;
    const bool sums = colsum != nullptr && i0 == 0;
    float acc[2][2][4] = {}, cs[2] = {0.f, 0.f};
#pragma unroll 1
    for (int r0 = 0; r0 < rows; r0 += 8) {
      const int ra = r0 + 2 * t, rb = ra + 1;
      const bool va = ra < rows, vb = rb < rows;
      unsigned ahi[2][4], alo[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int ia = i0 + 16 * m + g, ib = ia + 8;
        const float x[4] = {va && ia < I ? X[ra * ldx + ia] : 0.f, va && ib < I ? X[ra * ldx + ib] : 0.f,
                            vb && ia < I ? X[rb * ldx + ia] : 0.f, vb && ib < I ? X[rb * ldx + ib] : 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kBf16) ahi[m][e] = bf16_bits(x[e]);
          else split_tf32(x[e], ahi[m][e], alo[m][e]);
        }
      }
      float2 ya = make_float2(0.f, 0.f), yb = ya;
      if (jc < J) {
        if (va) ya = *reinterpret_cast<const float2*>(Y + ra * ldy + jc);
        if (vb) yb = *reinterpret_cast<const float2*>(Y + rb * ldy + jc);
      }
      if (sums) {
        cs[0] += ya.x;
        cs[0] += yb.x;
        cs[1] += ya.y;
        cs[1] += yb.y;
      }
      if constexpr (kBf16) {
        const unsigned b0a = bf16_bits(ya.x), b0b = bf16_bits(yb.x);
        const unsigned b1a = bf16_bits(ya.y), b1b = bf16_bits(yb.y);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_tf32(acc[m][0], ahi[m], b0a, b0b);
          mma_tf32(acc[m][1], ahi[m], b1a, b1b);
        }
      } else {
        unsigned bhi[2][2], blo[2][2];
        split_tf32(ya.x, bhi[0][0], blo[0][0]);
        split_tf32(yb.x, bhi[0][1], blo[0][1]);
        split_tf32(ya.y, bhi[1][0], blo[1][0]);
        split_tf32(yb.y, bhi[1][1], blo[1][1]);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_3xtf32(acc[m][0], ahi[m], alo[m], bhi[0], blo[0]);
          mma_3xtf32(acc[m][1], ahi[m], alo[m], bhi[1], blo[1]);
        }
      }
    }
    const int jw = j0 + 4 * t;
    if constexpr (kD256) {           // reductions (red_add4), as mma_gemm_tA's
#pragma unroll
      for (int mh = 0; mh < 4; ++mh) {
        const int m = mh >> 1, h = mh & 1, i = i0 + 16 * m + g + 8 * h;
        if (jw < J && i < I) {
          const float4 v = make_float4(acc[m][0][2 * h], acc[m][1][2 * h], acc[m][0][2 * h + 1],
                                       acc[m][1][2 * h + 1]);
          if (accumulate) red_add4(Gout + (size_t)i * ldg + jw, v);
          else store4(Gout + (size_t)i * ldg + jw, make_float4(0.f + v.x, 0.f + v.y, 0.f + v.z,
                                                               0.f + v.w));
        }
      }
    } else {
    // add into the gradient row, the four quads' loads before their stores
    float4 prev[4];
#pragma unroll
    for (int mh = 0; mh < 4; ++mh) {
      const int i = i0 + 16 * (mh >> 1) + g + 8 * (mh & 1);
      prev[mh] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (accumulate && jw < J && i < I)
        prev[mh] = __ldcg(reinterpret_cast<const float4*>(Gout + (size_t)i * ldg + jw));
    }
#pragma unroll
    for (int mh = 0; mh < 4; ++mh) {
      const int m = mh >> 1, h = mh & 1, i = i0 + 16 * m + g + 8 * h;
      if (jw < J && i < I) {
        const float4 o = prev[mh];
        store4(Gout + (size_t)i * ldg + jw,
               make_float4(o.x + acc[m][0][2 * h], o.y + acc[m][1][2 * h],
                           o.z + acc[m][0][2 * h + 1], o.w + acc[m][1][2 * h + 1]));
      }
    }
    }
    if (sums) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float sum = cs[q];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (t == 0 && jc + q < J) colsum[jc + q] = sum_accumulate ? colsum[jc + q] + sum : sum;
      }
    }
  }
}

// warp_energy_softmax and warp_softmax_backward of scann_mma.cuh for the
// tall build's chunks (2 to 8 atoms, ca * H pairs of (atom, head) over 8
// warps): each lane's dot product over the head's hd values (a multiple of
// 4) reads its key row as float4 and its mask first, so the loads of a pair
// are in flight together; the sums run in the header's order.
template <bool kBf16>
__device__ __forceinline__ void tall_energy_softmax(const float* sQ, int ldq, const float* sKey,
                                                    int ldk, const float* nmask, float* sE,
                                                    int ca, int N, int H, int hd, float dk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < ca * H; i += kWarps) {
    const int at = i / H, h = i - at * H, r = at * N + lane;
    float e = -INFINITY;
    if (lane < N) {
      const float* q = sQ + at * ldq + h * hd;
      const float* kk = sKey + r * ldk + h * hd;
      const float nm = __ldg(nmask + r);
      e = 0.f;
#pragma unroll 4
      for (int j = 0; j < hd; j += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kk + j);
        const float4 q4 = *reinterpret_cast<const float4*>(q + j);
        if (kBf16) {
          e += bf16r((q4.x * dk) * k4.x);
          e += bf16r((q4.y * dk) * k4.y);
          e += bf16r((q4.z * dk) * k4.z);
          e += bf16r((q4.w * dk) * k4.w);
        } else {
          e = fmaf(q4.x * dk, k4.x, e);
          e = fmaf(q4.y * dk, k4.y, e);
          e = fmaf(q4.z * dk, k4.z, e);
          e = fmaf(q4.w * dk, k4.w, e);
        }
      }
      e += (1.0f - nm) * -1e9f;
    }
    const float mx = warp_max(e);
    const float p = lane < N ? expf(e - mx) : 0.f;
    const float sum = warp_sum(p);
    if (lane < N) sE[r * H + h] = p / sum;
  }
}

template <bool kBf16>
__device__ __forceinline__ void tall_softmax_backward(const float* sDCtx, int ldq,
                                                      const float* sKey, int ldk,
                                                      const float* nmask, const float* sDrop,
                                                      const float* sE, float* sF, int ca, int N,
                                                      int H, int hd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < ca * H; i += kWarps) {
    const int at = i / H, h = i - at * H, r = at * N + lane;
    float f = 0.f, p = 0.f;
    if (lane < N) {
      const float* dq = sDCtx + at * ldq + h * hd;
      const float* kk = sKey + r * ldk + h * hd;
      const float nm = __ldg(nmask + r), dr = sDrop ? sDrop[r * H + h] : 1.f;
      p = sE[r * H + h];
#pragma unroll 4
      for (int j = 0; j < hd; j += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kk + j);
        const float4 d4 = *reinterpret_cast<const float4*>(dq + j);
        if (kBf16) {
          f += bf16r(d4.x * k4.x);
          f += bf16r(d4.y * k4.y);
          f += bf16r(d4.z * k4.z);
          f += bf16r(d4.w * k4.w);
        } else {
          f = fmaf(d4.x, k4.x, f);
          f = fmaf(d4.y, k4.y, f);
          f = fmaf(d4.z, k4.z, f);
          f = fmaf(d4.w, k4.w, f);
        }
      }
      f *= nm;
      if (sDrop) f *= dr;
    }
    const float sum = warp_sum(p * f);
    if (lane < N) sF[r * H + h] = operand<kBf16>(p * (f - sum));
  }
}


// Shared-memory plan, in floats: the resident [M, wd] buffer (none in the
// tall and wide builds); five per-block
// slots [AB, wd]; the work region (the readout keeps its vectors there, past
// one [AB, wd] buffer); per-warp LayerNorm partials and bias sums. kWide:
// the chunk holds a sub-chunk of kWideChunkRows rows of one atom, the atom's
// attention and d attention [N, H] and the d query sum [wd].
struct Plan {
  int wd, ABW, rows, lda, ldu, lde, ldf, work, offBlk, offWork, offPart, offAcc, total;
};

template <bool kWide>
__host__ __device__ inline Plan make_plan(const Args& a, int wide_rows = kWideChunkRows) {
  Plan p;
  const int AB = a.atom_block;
  p.wd = a.D > a.G ? a.D : a.G;
  p.ABW = AB * p.wd;
  p.rows = kWide ? wide_rows : a.chunk_atoms * a.N;
  p.lda = 2 * a.D + 4;
  p.ldu = a.D + 4;
  p.lde = round4(a.E + (a.use_ring ? 10 : 0));
  p.ldf = a.cgcnn ? round4(a.F) : 0;
  const int chunk = kWide ? p.rows * p.lda + 3 * p.rows * p.ldu + 2 * round4(a.N * a.H) +
                                round4(p.rows * a.H) + p.wd
                          : p.rows * p.lda + 3 * p.rows * p.ldu + 3 * round4(p.rows * a.H);
  const int atoms = 5 * p.ABW + round4(AB);     // the reverse walk's per-atom recompute
  const int embed = AB * (2 * p.lde + p.ldf) + p.ABW;
  const int readout = p.ABW + 4 * p.wd + 5 * round4(a.M) + 3 * round4(a.O) + 4;
  const int seg_readout = p.ABW + seg_backward_floats(a.S, p.wd, a.M, a.O);
  int w = chunk;
  w = atoms > w ? atoms : w;
  w = embed > w ? embed : w;
  w = readout > w ? readout : w;
  if (a.S) w = seg_readout > w ? seg_readout : w;
  p.work = w;
  p.offBlk = kTall || kWide ? 0 : a.M * p.wd;
  p.offWork = p.offBlk + 5 * p.ABW;
  p.offPart = p.offWork + w;
  p.offAcc = p.offPart + kWarps * 2 * p.wd;
  p.total = p.offAcc + 2 * p.wd;
  return p;
}

// The plan a build launches: make_plan's, but past 128 columns (the *_d256
// builds) the wide sub-chunk is the larger of kWideChunkRows and half of it
// whose plan fits a block (64 rows at D = 136, 32 at D = 256).
template <bool kWide>
__host__ __device__ inline Plan build_plan(const Args& a) {
  if constexpr (kWide && kD256) {
    const Plan p = make_plan<kWide>(a);
    if (p.total * (int)sizeof(float) <= kMaxSharedBytes) return p;
    return make_plan<kWide>(a, kWideChunkRows / 2);
  } else {
    return make_plan<kWide>(a);
  }
}

// The plan of either build, by N (host side).
inline Plan plan_of(const Args& a) {
  return a.N > kMaxChunkRows ? make_plan<true>(a) : make_plan<false>(a);
}

// kWide: N > kMaxChunkRows (the wide build, scann_loop_backward_wide.cu), one
// atom at a time, its rows in sub-chunks of kWideChunkRows. kTall (the tall
// build) and kWide: wide_keys is the tall scratch [B * C, M, G + D], a slice a
// block: its GA keys [M, G], then its d(layer input) partial [M, D]; in the
// wide build the key scratch [B * C, N, D] follows it, the block's keys of
// one atom (global, one slice a block) for the forward pass's context where
// an atom's list takes more than one sub-chunk.
template <bool kBf16, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
scann_loop_backward_kernel(const Args a, float* wide_keys) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan P = build_plan<kWide>(a);
  // the resident buffer's three roles in global memory (the tall and wide builds)
  constexpr bool kHomes = kTall || kWide;
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
                                       // (not tall or wide)
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
  // wide: sE and sF point into the atom's rows [N, H] at the sub-chunk's first
  const int EH = kWide ? round4(N * H) : round4(CR * H);
  float* sE = sW + CR * ldu;           // [CR, H]: attention (before dropout)
  float* sF = sE + EH;                 // [CR, H]: d attention
  float* sM = sF + EH;                 // [CR, H]: attention dropout mask
  float* const sEa = sE;               // wide: the atom's attention [N, H]
  float* const sFa = sF;               // wide: the atom's d attention [N, H]
  float* const sEx = sM + round4(CR * H);   // wide: [wd] sum_n de key of the d query

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
  // tall and wide: the block's slice of the tall scratch, and where the
  // forward pass and the readout read what the resident buffer holds in the
  // other builds
  auto tall_slice = [&](int q) { return wide_keys + ((size_t)b * a.cluster + q) * M * (G + D); };
  float* const keys_b = kHomes ? tall_slice(rank) : sR;         // GA keys
  const int ldk = kHomes ? G : wd;
  // wide: past the tall scratch, the block's rows of one atom [3, N, D] (ns,
  // u_pre, key): the forward pass's context reads the keys, the recompute
  // schedule's second pass over an atom the three
  float* const arows = kWide ? wide_keys + (size_t)a.B * C * M * (G + D) + (size_t)blockIdx.x * 3 * N * D
                             : nullptr;
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

  // The activation stash (a.stash 4 or 2: the element bytes of its row
  // buffers): the forward pass writes each chunk's neighbour states, u_pre,
  // keys [L, M*N, D] and attention [L, M*N, H] (before dropout), and in the
  // bf16 stash o1 [L, M, D] in f32; the reverse walk reads them back.
  const int sb = a.stash;
  const size_t lay_rows = (size_t)R * D;
  auto st_row = [&](int l, int k) { return ((size_t)b * L + l) * 3 + k; };

  // ---- a chunk of rows: stage, then recompute u_pre, key input, key, attention.
  // cen [M, ldc] holds the layer's input centers: the resident buffer in the
  // forward pass, the stash in global memory in the reverse walk. With
  // `stashed` the neighbour states, u_pre, keys and attention come from the
  // activation stash instead.
  auto stage_chunk = [&](int l, int base, int rows, const float* cen, int ldc, bool stashed) {
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
    if (stashed && sb == 4) {        // f32: straight into the chunk buffers
      const float* st = static_cast<const float*>(a.st_rows);
      for (int i = tid; i < rows * q4; i += kThreads) {
        const int r = i / q4, c = (i - r * q4) * 4;
        const size_t e = (size_t)(base + r) * D + c;
        cp_async16(sA + r * lda + D + c, st + st_row(l, 0) * lay_rows + e);
        cp_async16(sU + r * ldu + c, st + st_row(l, 1) * lay_rows + e);
        cp_async16(sW + r * ldu + c, st + st_row(l, 2) * lay_rows + e);
      }
      const float* at = static_cast<const float*>(a.st_attn) + (((size_t)b * L + l) * R + base) * H;
      for (int i = tid; i < rows * H; i += kThreads) cp_async4(sE + i, at + i);
    } else if (stashed) {            // bf16: widened on the way
      for (int i = tid; i < rows * q4; i += kThreads) {
        const int r = i / q4, c = (i - r * q4) * 4;
        const size_t e = (size_t)(base + r) * D + c;
        store4(sA + r * lda + D + c, stash_get4(a.st_rows, st_row(l, 0) * lay_rows + e, sb));
        store4(sU + r * ldu + c, stash_get4(a.st_rows, st_row(l, 1) * lay_rows + e, sb));
        store4(sW + r * ldu + c, stash_get4(a.st_rows, st_row(l, 2) * lay_rows + e, sb));
      }
      for (int i = tid; i < rows * H; i += kThreads)
        sE[i] = stash_get(a.st_attn, (((size_t)b * L + l) * R + base) * H + i, sb);
    } else if constexpr (kHomes) {
      // the neighbours' centers from L2, four quads a thread in flight at once
      constexpr int kInFlight = 4;
      for (int i0 = tid; i0 < rows * q4; i0 += kInFlight * kThreads) {
        float4 v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int i = i0 + u * kThreads, r = i / q4, c = (i - r * q4) * 4;
          if (i < rows * q4)
            v[u] = __ldcg(reinterpret_cast<const float4*>(cen + (size_t)__ldg(nbr + base + r) * ldc + c));
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int i = i0 + u * kThreads, r = i / q4, c = (i - r * q4) * 4;
          if (i < rows * q4) store4(sA + r * lda + D + c, operand4<kBf16>(v[u]));
        }
      }
    } else {
      for (int i = tid; i < rows * q4; i += kThreads) {
        const int r = i / q4, c = (i - r * q4) * 4;
        store4(sA + r * lda + D + c,
               operand4<kBf16>(*reinterpret_cast<const float4*>(cen + (size_t)nbr[base + r] * ldc + c)));
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

  // the forward pass's writes of a chunk's rows into the stash (wide: the
  // atom's attention goes in once its softmax is done)
  auto stash_chunk = [&](int l, int base, int rows) {
    for (int i = tid; i < rows * q4; i += kThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      const size_t e = (size_t)(base + r) * D + c;
      stash_put4(a.st_rows, st_row(l, 0) * lay_rows + e,
                 *reinterpret_cast<const float4*>(sA + r * lda + D + c), sb);
      stash_put4(a.st_rows, st_row(l, 1) * lay_rows + e,
                 *reinterpret_cast<const float4*>(sU + r * ldu + c), sb);
      stash_put4(a.st_rows, st_row(l, 2) * lay_rows + e,
                 *reinterpret_cast<const float4*>(sW + r * ldu + c), sb);
    }
    if constexpr (!kWide)
      for (int i = tid; i < rows * H; i += kThreads)
        stash_put(a.st_attn, (((size_t)b * L + l) * R + base) * H + i, sE[i], sb);
  };

  // wide, the recompute schedule at N > kWideChunkRows: the first pass over an
  // atom keeps each sub-chunk's ns, u_pre and key (rows n0..) in the block's
  // rows of the atom, and the second pass stages them back as the f32 stash
  // stages its rows (the geometry and the dropout mask as stage_chunk has
  // them), so a row's products are formed once in the reverse walk, not twice
  auto keep_rows = [&](int n0, int rows) {
    for (int i = tid; i < rows * q4; i += kThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      float* dst = arows + (size_t)(n0 + r) * D + c;
      store4(dst, *reinterpret_cast<const float4*>(sA + r * lda + D + c));
      store4(dst + (size_t)N * D, *reinterpret_cast<const float4*>(sU + r * ldu + c));
      store4(dst + (size_t)2 * N * D, *reinterpret_cast<const float4*>(sW + r * ldu + c));
    }
  };
  auto stage_kept = [&](int l, int base, int n0, int rows) {
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
    for (int i = tid; i < rows * q4; i += kThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      const float* src = arows + (size_t)(n0 + r) * D + c;
      cp_async16(sA + r * lda + D + c, src);
      cp_async16(sU + r * ldu + c, src + (size_t)N * D);
      cp_async16(sW + r * ldu + c, src + (size_t)2 * N * D);
    }
    if (a.attn_dropout) {
      for (int i = tid; i < rows * H; i += kThreads)
        sM[i] = scann_philox::mask_value(a.seed, mol, 1 + L + l, (unsigned)(base * H + i),
                                         a.attn_threshold, a.attn_scale);
    }
    cp_async_wait_all();
    __syncthreads();
  };

  // wide, a stash at N > kWideChunkRows: the first pass over an atom stages
  // only what the d attention needs, a sub-chunk's keys and attention (and
  // the dropout mask); the second pass stages all its rows
  auto stage_keys = [&](int l, int base, int rows) {
    if (sb == 4) {
      const float* st = static_cast<const float*>(a.st_rows);
      for (int i = tid; i < rows * q4; i += kThreads) {
        const int r = i / q4, c = (i - r * q4) * 4;
        cp_async16(sW + r * ldu + c, st + st_row(l, 2) * lay_rows + (size_t)(base + r) * D + c);
      }
      const float* at = static_cast<const float*>(a.st_attn) + (((size_t)b * L + l) * R + base) * H;
      for (int i = tid; i < rows * H; i += kThreads) cp_async4(sE + i, at + i);
    } else {
      for (int i = tid; i < rows * q4; i += kThreads) {
        const int r = i / q4, c = (i - r * q4) * 4;
        store4(sW + r * ldu + c, stash_get4(a.st_rows, st_row(l, 2) * lay_rows + (size_t)(base + r) * D + c, sb));
      }
      for (int i = tid; i < rows * H; i += kThreads)
        sE[i] = stash_get(a.st_attn, (((size_t)b * L + l) * R + base) * H + i, sb);
    }
    if (a.attn_dropout) {
      for (int i = tid; i < rows * H; i += kThreads)
        sM[i] = scann_philox::mask_value(a.seed, mol, 1 + L + l, (unsigned)(base * H + i),
                                         a.attn_threshold, a.attn_scale);
    }
    cp_async_wait_all();
    __syncthreads();
  };

  // lm0: the chunk's first atom within its atom block; `stashed`: u_pre, the
  // keys and the attention were staged from the stash, and only the key input
  // (SCANN+: the LN_g rebuild from u_pre and the input geometry) is computed.
  // base: the chunk's first row; wide: `rows` rows of one atom (rows < N, so
  // r / N is 0), and no softmax
  auto row_forward = [&](int l, int base, int lm0, int ca, int rows, bool write_g,
                         bool stashed) {
    const float* wfg = a.wfg + (size_t)l * fg_in * D;
    const float* bfg = a.bfg + (size_t)l * D;
    const float* bk = a.bk + (size_t)l * D;
    if (a.g_update) {
      // u_pre = cw + [geo | ns] @ Wfg[D:3D] + b
      if (!stashed) {
        mma_gemm<kBf16>(sA, lda, rows, 2 * D, wfg + (size_t)D * D, D, D, [&](int r, int c, float4 v) {
          const float* cw = sCW + (lm0 + r / N) * wd + c;
          store4(sU + r * ldu + c, make_float4(cw[0] + v.x + bfg[c], cw[1] + v.y + bfg[c + 1],
                                               cw[2] + v.z + bfg[c + 2], cw[3] + v.w + bfg[c + 3]));
        });
        __syncthreads();
      }
      const float* gs = a.lng_s + (size_t)l * D;
      const float* gb = a.lng_b + (size_t)l * D;
      float* g_out = write_g ? g_st + ((size_t)(l + 1) * R + base) * D : nullptr;
      for (int r = warp; r < rows; r += kWarps) {
        float v[kLaneValues];
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
          const int d = lane + 32 * i;
          v[i] = d < D ? swishf(sU[r * ldu + d]) + sA[r * lda + d] : 0.f;
        }
        float mean, inv;
        warp_ln_stats(v, D, lane, mean, inv);
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
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
      if (!stashed) {
        mma_gemm<kBf16>(sA, lda, rows, K, wfg, D, D, [&](int r, int c, float4 v) {
          store4(sU + r * ldu + c,
                 make_float4(v.x + bfg[c], v.y + bfg[c + 1], v.z + bfg[c + 2], v.w + bfg[c + 3]));
        });
        __syncthreads();
      }
      for (int i = tid; i < rows * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        sV[r * ldu + d] = sA[r * lda + D + d] * (swishf(sU[r * ldu + d]) * nweight[base + r]);
      }
    }
    __syncthreads();
    if (stashed) return;
    // key = (ns * geo) @ Wk + bk
    mma_gemm<kBf16>(sV, ldu, rows, D, a.wk + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
      store4(sW + r * ldu + c,
             make_float4(v.x + bk[c], v.y + bk[c + 1], v.z + bk[c + 2], v.w + bk[c + 3]));
    });
    __syncthreads();
    if constexpr (kTall) {
      if (hd % 4 == 0)
        tall_energy_softmax<kBf16>(sQ + lm0 * wd, wd, sW, ldu, nmask + base, sE, ca, N, H, hd,
                                   a.dk);
      else
        warp_energy_softmax<kBf16>(sQ + lm0 * wd, wd, sW, ldu, nmask + base, sE, ca, N, H, hd,
                                   a.dk);
      __syncthreads();
    } else if constexpr (!kWide) {
      warp_energy_softmax<kBf16>(sQ + lm0 * wd, wd, sW, ldu, nmask + base, sE, ca, N, H, hd, a.dk);
      __syncthreads();
    }
  };

  // per-atom projections of the block's layer input cb [ab, wd]: query (and
  // cw for SCANN+, unless `cw` is false: the stash holds u_pre); the caller
  // synchronises
  auto project_atoms = [&](int l, const float* cb, int ab, bool cw) {
    const float* wfg = a.wfg + (size_t)l * fg_in * D;
    const float* bq = a.bq + (size_t)l * D;
    if (a.g_update && cw)
      mma_gemm<kBf16>(cb, wd, ab, D, wfg, D, D, [&](int r, int c, float4 v) { store4(sCW + r * wd + c, v); });
    mma_gemm<kBf16>(cb, wd, ab, D, a.wq + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
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
      if constexpr (kD256) {
        if (accumulate) {
          red_add(gs + d, s0);
          red_add(gb + d, s1);
        } else {
          gs[d] = s0;
          gb[d] = s1;
        }
      } else {
        gs[d] = accumulate ? gs[d] + s0 : s0;
        gb[d] = accumulate ? gb[d] + s1 : s1;
      }
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
      mma_gemm<kBf16>(sFeat, ldf, ab, F, a.embed, a.E, a.E, [&](int r, int c, float4 v) {
        store4(sEmb + r * lde + c,
               make_float4(v.x + bemb[c], v.y + bemb[c + 1], v.z + bemb[c + 2], v.w + bemb[c + 3]));
      });
    } else {
      for (int i = tid; i < ab * a.E; i += kThreads) {
        const int m = i / a.E, e = i - m * a.E;
        sEmb[m * lde + e] = operand<kBf16>(a.embed[(size_t)a.atomic[(size_t)b * M + ab0 + m] * a.E + e]);
      }
    }
    if (a.use_ring) {
      for (int i = tid; i < ab * 10; i += kThreads) {
        const int m = i / 10, j = i - m * 10;
        const float* ra = a.ring + ((size_t)b * M + ab0 + m) * 2;
        sEmb[m * lde + a.E + j] = operand<kBf16>(ra[0]) * operand<kBf16>(a.wring[j]) +
                                  operand<kBf16>(ra[1]) * operand<kBf16>(a.wring[10 + j]) + a.bring[j];
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
    mma_gemm<kBf16>(sA, lda, rows, K, a.wnd, D, D, [&](int r, int c, float4 v) {
      store4(sU + r * ldu + c, make_float4(v.x + a.bnd[c], v.y + a.bnd[c + 1],
                                           v.z + a.bnd[c + 2], v.w + a.bnd[c + 3]));
    });
    mma_gemm<kBf16>(sA + D, lda, rows, K, a.wnw, D, D, [&](int r, int c, float4 v) {
      store4(sV + r * ldu + c, make_float4(v.x + a.bnw[c], v.y + a.bnw[c + 1],
                                           v.z + a.bnw[c + 2], v.w + a.bnw[c + 3]));
    });
  };

  // ======================= forward, stashing layer inputs ===================
  for (int ab0 = m_lo; ab0 < m_hi; ab0 += AB) {
    const int ab = min(AB, m_hi - ab0);
    stage_embedding(ab0, ab);
    mma_gemm<kBf16>(sEmb, lde, ab, ke, a.wde, D, D, [&](int r, int c, float4 v) {
      const float4 m = mask4(0, ab0 + r, c);
      store4(c_st + (size_t)(ab0 + r) * D + c,
             make_float4(swishf(v.x + a.bde[c]) * m.x, swishf(v.y + a.bde[c + 1]) * m.y,
                         swishf(v.z + a.bde[c + 2]) * m.z, swishf(v.w + a.bde[c + 3]) * m.w));
    });
    __syncthreads();
  }

  // SCANN+ geometry embedding: geo_0 = swish(rbf(d) @ Wnd + bnd) * swish(rbf(w) @ Wnw + bnw)
  // m0: the chunk's first atom (kWide: its first row, sub-chunks of CR rows)
  if (a.g_update) {
    for (int m0 = kWide ? m_lo * N : m_lo; m0 < (kWide ? m_hi * N : m_hi); m0 += kWide ? CR : CA) {
      const int ca = min(CA, m_hi - m0), rows = kWide ? min(CR, m_hi * N - m0) : ca * N,
                base = kWide ? m0 : m0 * N;
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
  // (tall and wide: the gather reads them from the stash)
  cluster.sync();
  if constexpr (!kHomes) load_rows(sR, c_st, 0, M);
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
    // the gather's rows: the resident centers, or (tall, wide) the layer-input stash
    const float* cen = kHomes ? c_st + (size_t)l * M * D : sR;
    const int ldc = kHomes ? D : wd;
    for (int ab0 = m_lo; ab0 < m_hi; ab0 += AB) {
      const int ab = min(AB, m_hi - ab0);
      if constexpr (kHomes) {
        load_rows(sCb, cen, ab0, ab);
        __syncthreads();
        project_atoms(l, sCb, ab, true);
      } else {
        project_atoms(l, sR + ab0 * wd, ab, true);
      }
      __syncthreads();
      for (int m0 = ab0; m0 < ab0 + ab; m0 += CA) {
        const int ca = min(CA, ab0 + ab - m0), base = m0 * N, lm0 = m0 - ab0;
        if constexpr (kWide) {
          // The forward pass over one atom's wide neighbour list (kWide): its rows in
          // sub-chunks, their energies into the atom's row sEa and, where the list
          // takes more than one sub-chunk, their keys to the block's key scratch in
          // global memory; the softmax over all N (its attention to the stash); then
          // ctx + query, the context summed over the N neighbours in order, as the
          // narrow chunk sums it, from the chunk's keys (one sub-chunk) or the
          // scratch's.
          const int m = m0, lm = lm0;
          const bool one = N <= CR;
          float* keys = arows + (size_t)2 * N * D;
          for (int n0 = 0; n0 < N; n0 += CR) {
            const int rows = min(CR, N - n0), rb = base + n0;
            stage_chunk(l, rb, rows, cen, ldc, false);
            row_forward(l, rb, lm, 1, rows, l + 1 < L, false);
            warp_energies<kBf16>(sQ + lm * wd, sW, ldu, nmask + rb, sEa + n0 * H, rows, H, hd, a.dk);
            if (!one)
              for (int i = tid; i < rows * q4; i += kThreads) {
                const int r = i / q4, c = (i - r * q4) * 4;
                store4(keys + (size_t)(n0 + r) * D + c, *reinterpret_cast<const float4*>(sW + r * ldu + c));
              }
            if (sb) stash_chunk(l, rb, rows);
            __syncthreads();
          }
          wide_softmax(sEa, N, H, [&](int n, int h, float p) { sEa[n * H + h] = p; });
          __syncthreads();
          // sFa: the attention as the context uses it; the bf16 stash's rebuilt
          // one (rounded attention) in place of sEa
          for (int i = tid; i < N * H; i += kThreads) {
            const float p = sEa[i], nm = nmask[base + i / H];
            if (sb) stash_put(a.st_attn, (((size_t)b * L + l) * R + base) * H + i, p, sb);
            const float dr = a.attn_dropout ? scann_philox::mask_value(a.seed, mol, 1 + L + l,
                                                                       (unsigned)(base * H + i),
                                                                       a.attn_threshold, a.attn_scale)
                                            : 1.f;
            sFa[i] = operand<kBf16>(a.attn_dropout ? p * dr : p) * nm;
            if (sb == 2) {
              const float e2 = bf16r(p);
              sEa[i] = operand<kBf16>(a.attn_dropout ? e2 * dr : e2) * nm;
            }
          }
          __syncthreads();
          for (int d = tid; d < D; d += kThreads) {
            const int h = d / hd;
            float s = 0.f, s2 = 0.f;
            if (one) {
              for (int n = 0; n < N; ++n) {
                const float k = sW[n * ldu + d];
                s += sFa[n * H + h] * k;
                if (sb == 2) s2 += sEa[n * H + h] * bf16r(k);
              }
            } else {
              for (int n = 0; n < N; ++n) {
                const float k = __ldcg(keys + (size_t)n * D + d);
                s += sFa[n * H + h] * k;
                if (sb == 2) s2 += sEa[n * H + h] * bf16r(k);
              }
            }
            if (sb == 2) o_st[((size_t)l * M + m) * D + d] = s2 + sQ[lm * wd + d];
            sQ[lm * wd + d] = s + sQ[lm * wd + d];
          }
          __syncthreads();
          continue;
        }
        stage_chunk(l, base, ca * N, cen, ldc, false);
        row_forward(l, base, lm0, ca, ca * N, l + 1 < L, false);
        if (sb) stash_chunk(l, base, ca * N);
        // ctx = sum_n attn * mask * nmask * key, added to the query. The bf16
        // stash's reverse walk takes the attention LayerNorm's statistics from
        // ctx + query rebuilt from the rounded attention and keys, as the TPU
        // kernel's acts_from_stash does (scann_loop.py:330-332): that sum goes
        // to the ctx + query stash in place of the exact one.
        for (int i = tid; i < ca * D; i += kThreads) {
          const int at = i / D, d = i - at * D, h = d / hd;
          float s = 0.f;
          for (int n = 0; n < N; ++n) {
            const int r = at * N + n;
            const float p = a.attn_dropout ? sE[r * H + h] * sM[r * H + h] : sE[r * H + h];
            s += operand<kBf16>(p) * nmask[base + r] * sW[r * ldu + d];
          }
          if (sb == 2) {
            float s2 = 0.f;
            for (int n = 0; n < N; ++n) {
              const int r = at * N + n;
              const float e2 = bf16r(sE[r * H + h]);
              const float p2 = a.attn_dropout ? e2 * sM[r * H + h] : e2;
              s2 += operand<kBf16>(p2) * nmask[base + r] * bf16r(sW[r * ldu + d]);
            }
            o_st[((size_t)l * M + m0 + at) * D + d] = s2 + sQ[(lm0 + at) * wd + d];
          }
          sQ[(lm0 + at) * wd + d] = s + sQ[(lm0 + at) * wd + d];
        }
        __syncthreads();
      }
      // stash ctx + query (the bf16 stash: the rebuilt one, above, and o1
      // itself), then o1 = LN(ctx + query)
      for (int m = warp; m < ab; m += kWarps) {
        float* row = sQ + m * wd;
        float v[kLaneValues];
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
          const int d = lane + 32 * i;
          v[i] = d < D ? row[d] : 0.f;
          if (d < D && sb != 2) o_st[((size_t)l * M + ab0 + m) * D + d] = v[i];
        }
        warp_layer_norm(v, D, ls, lb, lane);
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            row[d] = v[i];
            if (sb == 2) a.st_atoms[(((size_t)b * L + l) * M + ab0 + m) * D + d] = v[i];
          }
        }
      }
      __syncthreads();
      // ResidualNorm: next = LN(o1 + mask * (swish(o1 @ W1 + b1) @ W2 + b2))
      mma_gemm<kBf16>(sQ, wd, ab, D, a.wr1 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
        store4(sH1 + r * wd + c, make_float4(swishf(v.x + br1[c]), swishf(v.y + br1[c + 1]),
                                             swishf(v.z + br1[c + 2]), swishf(v.w + br1[c + 3])));
      });
      __syncthreads();
      mma_gemm<kBf16>(sH1, wd, ab, D, a.wr2 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
        const float4 m = mask4(1 + l, ab0 + r, c);
        store4(sH2 + r * wd + c, make_float4((v.x + br2[c]) * m.x, (v.y + br2[c + 1]) * m.y,
                                             (v.z + br2[c + 2]) * m.z, (v.w + br2[c + 3]) * m.w));
      });
      __syncthreads();
      for (int m = warp; m < ab; m += kWarps) {
        float v[kLaneValues];
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
          const int d = lane + 32 * i;
          v[i] = d < D ? sQ[m * wd + d] + sH2[m * wd + d] : 0.f;
        }
        warp_layer_norm(v, D, rs, rb, lane);
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i)
          if (lane + 32 * i < D) c_next[(size_t)(ab0 + m) * D + lane + 32 * i] = v[i];
      }
      __syncthreads();
    }
    // every atom of the structure has gathered from this layer's input and
    // every block has written its atoms' new centers: take all M rows
    cluster.sync();
    if constexpr (!kHomes) load_rows(sR, c_next, 0, M);
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
    // a packed slot: per-segment vectors past the block [AB, wd]
    const int S = a.S;
    const int* sid = S ? a.seg + (size_t)b * M : nullptr;
    const SegVectors v = seg_vectors(work + ABW, S, wd, M, O, true);
    // pass 1, block by block over all M atoms, in every block of the cluster
    // (the scores need every key): the GA keys take the place of the centers
    if (!S) zero(qsum, G);
    for (int ab0 = 0; ab0 < M; ab0 += AB) {
      const int ab = min(AB, M - ab0);
      float* RB = sCb;                 // cg = swish(cL @ Wal + bal)
      float* RC = sQ;                  // gq
      const float* cl = sR + ab0 * wd; // the last centers (tall, wide: staged into sCW)
      if constexpr (kHomes) {
        load_rows(sCW, c_last, ab0, ab);
        __syncthreads();
        cl = sCW;
      }
      mma_gemm<kBf16>(cl, wd, ab, D, a.wal, G, G, [&](int r, int c, float4 v) {
        store4(RB + r * wd + c, make_float4(swishf(v.x + a.bal[c]), swishf(v.y + a.bal[c + 1]),
                                            swishf(v.z + a.bal[c + 2]), swishf(v.w + a.bal[c + 3])));
      });
      __syncthreads();
      mma_gemm<kBf16>(RB, wd, ab, G, a.wgq, G, G, [&](int r, int c, float4 v) {
        store4(RC + r * wd + c, make_float4(v.x + a.bgq[c], v.y + a.bgq[c + 1],
                                            v.z + a.bgq[c + 2], v.w + a.bgq[c + 3]));
      });
      mma_gemm<kBf16>(RB, wd, ab, G, a.wgk, G, G, [&](int r, int c, float4 v) {
        store4(keys_b + (ab0 + r) * ldk + c, make_float4(v.x + a.bgk[c], v.y + a.bgk[c + 1],
                                                         v.z + a.bgk[c + 2], v.w + a.bgk[c + 3]));
      });
      __syncthreads();
      if (S) {
        seg_queries<kBf16>(v, S, RC, wd, keys_b, ldk, am, sid, ab0, ab, G, ab0 == 0);
      } else {
        for (int g = tid; g < G; g += kThreads) {
          float s = qsum[g];
          for (int m = 0; m < ab; ++m) s += am[ab0 + m] * RC[m * wd + g];
          qsum[g] = s;
        }
        for (int m = warp; m < ab; m += kWarps) {
          const float mm = am[ab0 + m];
          float dg = 0.f;
          for (int g = lane; g < G; g += 32)
            dg += (mm * keys_b[(ab0 + m) * ldk + g]) * (mm * RC[m * wd + g]);
          dg = warp_sum(dg);
          if (lane == 0) diag[ab0 + m] = dg;
        }
      }
      __syncthreads();
    }
    if (S) {
      // the head's gradients belong to the slot, not to an atom: the
      // cluster's first block writes them, the others write zeros
      seg_readout_backward<kBf16, kBf16>(v, keys_b, ldk, am, sid, M, S, G, O, a.ga_norm,
                                         a.mrelu, a.one_shot,
                           a.ct + (size_t)b * S, a.one_shot ? nullptr : a.ct_ga + (size_t)b * M,
                           a.wbf, a.bbf, a.wp, a.bp, lead ? a.pred + (size_t)b * S : nullptr,
                           lead ? 1.f : 0.f, grad(gWP), grad(gBP), grad(gWBF), grad(gBBF));
    } else {
      // agg_m = mask_m * ((mask_m k_m) . qsum - (mask_m k_m) . (mask_m q_m))
      for (int m = warp; m < M; m += kWarps) {
        const float mm = am[m];
        float cross = 0.f;
        for (int g = lane; g < G; g += 32) cross += (mm * keys_b[m * ldk + g]) * qsum[g];
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
        for (int m = 0; m < M; ++m) s += am[m] * ga[m] * keys_b[m * ldk + g];
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
          if (lead) a.pred[b] = p;
          scal[1] = a.one_shot ? p - a.ct[b] : a.ct[b];   // straight-through mrelu
        }
      }
      __syncthreads();
      // the head's gradients belong to the structure, not to an atom: the
      // cluster's first block writes them, the others write zeros
      // (d pred rounded too in the bf16 mode)
      const float ctp = scal[1], nrm = scal[0], mine = lead ? 1.f : 0.f, c = operand<kBf16>(ctp);
      if (tid == 0) grad(gBP)[0] = ctp * mine;
      for (int o = tid; o < O; o += kThreads) {
        grad(gWP)[o] = operand<kBf16>(sb[o]) * c * mine;
        dsbf[o] = c * operand<kBf16>(a.wp[o]) * swish_grad(sbf[o]);
      }
      __syncthreads();
      for (int i = tid; i < G * O; i += kThreads) {
        const int g = i / O, o = i - g * O;
        grad(gWBF)[i] = operand<kBf16>(struc[g]) * operand<kBf16>(dsbf[o]) * mine;
      }
      for (int o = tid; o < O; o += kThreads) grad(gBBF)[o] = dsbf[o] * mine;
      for (int g = tid; g < G; g += kThreads) {
        float s = 0.f;
        for (int o = 0; o < O; ++o)
          s += operand<kBf16>(dsbf[o]) * operand<kBf16>(a.wbf[(size_t)g * O + o]);
        dstruc[g] = s;
      }
      __syncthreads();
      for (int m = warp; m < M; m += kWarps) {
        float s = 0.f;
        for (int g = lane; g < G; g += 32) s += am[m] * keys_b[m * ldk + g] * dstruc[g];
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
        for (int m = 0; m < M; ++m) s += dcd[m] * (am[m] * keys_b[m * ldk + g]);
        dqsum[g] = s;
      }
      __syncthreads();
    }
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
      if constexpr (kHomes) {          // gk from the block's keys into the free slot sDCW
        RD = sDCW;
        const int g4 = G / 4;
        for (int i = tid; i < ab * g4; i += kThreads) {
          const int r = i / g4, c = (i - r * g4) * 4;
          store4(RD + r * wd + c, *reinterpret_cast<const float4*>(keys_b + (ab0 + r) * ldk + c));
        }
      }
      __syncthreads();
      mma_gemm<kBf16>(cLb, wd, ab, D, a.wal, G, G, [&](int r, int c, float4 v) {
        const float4 s = make_float4(v.x + a.bal[c], v.y + a.bal[c + 1], v.z + a.bal[c + 2],
                                     v.w + a.bal[c + 3]);
        store4(RA + r * wd + c, s);
        store4(RB + r * wd + c, make_float4(swishf(s.x), swishf(s.y), swishf(s.z), swishf(s.w)));
      });
      __syncthreads();
      mma_gemm<kBf16>(RB, wd, ab, G, a.wgq, G, G, [&](int r, int c, float4 v) {
        store4(RC + r * wd + c, make_float4(v.x + a.bgq[c], v.y + a.bgq[c + 1],
                                            v.z + a.bgq[c + 2], v.w + a.bgq[c + 3]));
      });
      __syncthreads();
      if (S) {
        seg_query_key_grads<kBf16>(v, RC, wd, RD, wd, am, sid, ab0, ab, G);
      } else {
        for (int i = tid; i < ab * G; i += kThreads) {
          const int r = i / G, g = i - r * G, m = ab0 + r;
          const float mm = am[m], mk = mm * RD[r * wd + g], mq = mm * RC[r * wd + g];
          const float dmk = dcd[m] * qsum[g] - dcd[m] * mq;
          const float dmq = -dcd[m] * mk + dqsum[g];
          RC[r * wd + g] = mm * dmq;
          RD[r * wd + g] = mm * ga[m] * dstruc[g] + mm * dmk;
        }
      }
      __syncthreads();
      mma_gemm_tA<kBf16>(RB, wd, RC, wd, ab, G, G, grad(gWGQ), G, acc, grad(gBGQ), acc);
      mma_gemm_tA<kBf16>(RB, wd, RD, wd, ab, G, G, grad(gWGK), G, acc, grad(gBGK), acc);
      mma_gemm_tB<kBf16>(RC, wd, ab, G, a.wgq, G, G, G, [&](int r, int c, float4 v) {
        store4(RE + r * wd + c, v);
      });
      __syncthreads();
      mma_gemm_tB<kBf16>(RD, wd, ab, G, a.wgk, G, G, G, [&](int r, int c, float4 v) {
        const float* e = RE + r * wd + c;
        const float* s = RA + r * wd + c;
        store4(RE + r * wd + c, make_float4((e[0] + v.x) * swish_grad(s[0]), (e[1] + v.y) * swish_grad(s[1]),
                                            (e[2] + v.z) * swish_grad(s[2]), (e[3] + v.w) * swish_grad(s[3])));
      });
      __syncthreads();
      mma_gemm_tA<kBf16>(cLb, wd, RE, wd, ab, D, G, grad(gWAL), G, acc, grad(gBAL), acc);
      mma_gemm_tB<kBf16>(RE, wd, ab, G, a.wal, G, D, D, [&](int r, int c, float4 v) {
        store4(dcen + (size_t)(ab0 + r) * D + c, v);
      });
      __syncthreads();
    }
  }

  // ======================= reverse walk over the layers =====================
  // d layer input, accumulated over the atom blocks (tall, wide: the block's global partial)
  float* sDCN = kHomes ? tall_slice(rank) + (size_t)M * G : sR;
  const int ldn = kHomes ? D : wd;
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
    zero(sDCN, M * ldn);
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
        float v[kLaneValues], mean, inv;
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) v[i] = lane + 32 * i < D ? P0[m * wd + lane + 32 * i] : 0.f;
        warp_ln_stats(v, D, lane, mean, inv);
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            const float xh = (v[i] - mean) * inv;
            P0[m * wd + d] = xh;
            P1[m * wd + d] = sb == 2 ? a.st_atoms[(((size_t)b * L + l) * M + ab0 + m) * D + d]
                                     : xh * lns[d] + a.ln_b[(size_t)l * D + d];
          }
        }
        if (lane == 0) oinv[m] = inv;
      }
      __syncthreads();
      mma_gemm<kBf16>(P1, wd, ab, D, a.wr1 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
        const float4 s = make_float4(v.x + br1[c], v.y + br1[c + 1], v.z + br1[c + 2], v.w + br1[c + 3]);
        store4(P2 + r * wd + c, s);
        store4(P3 + r * wd + c, make_float4(swishf(s.x), swishf(s.y), swishf(s.z), swishf(s.w)));
      });
      __syncthreads();
      mma_gemm<kBf16>(P3, wd, ab, D, a.wr2 + (size_t)l * D * D, D, D, [&](int r, int c, float4 v) {
        const float4 m = mask4(1 + l, ab0 + r, c);
        const float* o1 = P1 + r * wd + c;
        store4(P4 + r * wd + c, make_float4(o1[0] + (v.x + br2[c]) * m.x, o1[1] + (v.y + br2[c + 1]) * m.y,
                                            o1[2] + (v.z + br2[c + 2]) * m.z, o1[3] + (v.w + br2[c + 3]) * m.w));
      });
      __syncthreads();
      // ResidualNorm's LayerNorm backward: P5 = d sum, P4 = d h2 = d sum * mask
      for (int m = warp; m < ab; m += kWarps) {
        float v[kLaneValues], dy[kLaneValues], xh[kLaneValues], dx[kLaneValues], mean, inv;
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
          const int d = lane + 32 * i;
          v[i] = d < D ? P4[m * wd + d] : 0.f;
          dy[i] = d < D ? dcen[(size_t)(ab0 + m) * D + d] : 0.f;
        }
        warp_ln_stats(v, D, lane, mean, inv);
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) xh[i] = lane + 32 * i < D ? (v[i] - mean) * inv : 0.f;
        warp_ln_backward(xh, inv, dy, rls, D, lane, dx);
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
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
      mma_gemm_tA<kBf16>(P3, wd, P4, wd, ab, D, D, grad(gWR2) + (size_t)l * D * D, D, acc,
                  grad(gBR2) + (size_t)l * D, acc);
      __syncthreads();
      mma_gemm_tB<kBf16>(P4, wd, ab, D, a.wr2 + (size_t)l * D * D, D, D, D, [&](int r, int c, float4 v) {
        const float* s = P2 + r * wd + c;
        store4(P3 + r * wd + c, make_float4(v.x * swish_grad(s[0]), v.y * swish_grad(s[1]),
                                            v.z * swish_grad(s[2]), v.w * swish_grad(s[3])));
      });
      __syncthreads();
      mma_gemm_tA<kBf16>(P1, wd, P3, wd, ab, D, D, grad(gWR1) + (size_t)l * D * D, D, acc,
                  grad(gBR1) + (size_t)l * D, acc);
      mma_gemm_tB<kBf16>(P3, wd, ab, D, a.wr1 + (size_t)l * D * D, D, D, D, [&](int r, int c, float4 v) {
        float* p = P5 + r * wd + c;
        store4(p, make_float4(p[0] + v.x, p[1] + v.y, p[2] + v.z, p[3] + v.w));
      });
      __syncthreads();
      // attention LayerNorm backward: d ctx = d query = LN'(d o1) -> sDQ
      for (int m = warp; m < ab; m += kWarps) {
        float dy[kLaneValues], xh[kLaneValues], dx[kLaneValues];
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
          const int d = lane + 32 * i;
          xh[i] = d < D ? P0[m * wd + d] : 0.f;
          dy[i] = d < D ? P5[m * wd + d] : 0.f;
        }
        warp_ln_backward(xh, oinv[m], dy, lns, D, lane, dx);
#pragma unroll
        for (int i = 0; i < kLaneValues; ++i) {
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
      project_atoms(l, sCb, ab, sb == 0);
      __syncthreads();

      // ---- the block's (atom, neighbour) rows, chunk by chunk ----------------
      // (wide: atom by atom, the attention and its backward over all N first,
      // then the rows' backward sub-chunk by sub-chunk)
      for (int m0 = ab0; m0 < ab0 + ab; m0 += CA) {
        const int ca = min(CA, ab0 + ab - m0), lm0 = m0 - ab0;
        // wide: one pass over the atom where one sub-chunk holds its list
        const bool one = kWide && N <= CR;
        if constexpr (kWide) {
          // The reverse walk's first pass over one atom's wide neighbour list (kWide):
          // the attention of every row (recomputed: each sub-chunk's energies, then
          // the softmax over all N, the forward pass's arithmetic on the same values;
          // stashed: staged) and its d attention f, then the softmax backward over all
          // N into sFa, which the second pass, the rows' backward sub-chunk by
          // sub-chunk, reads. Where one sub-chunk holds the list (N <= kWideChunkRows)
          // the second pass keeps the rows of the first (the stash: with the key
          // input rebuilt) in place of staging and forming them again; past it
          // the recompute schedule's second pass stages the first pass's rows
          // from the block's rows of the atom (keep_rows, stage_kept) and, as the
          // stashes do, rebuilds only the key input.
          const int base = m0 * N, lm = lm0;
          for (int n0 = 0; n0 < N; n0 += CR) {
            const int rows = min(CR, N - n0), rb = base + n0;
            sE = sEa + n0 * H;
            if (sb && !one) stage_keys(l, rb, rows);
            else stage_chunk(l, rb, rows, c_in, D, sb != 0);
            if (!sb) {
              row_forward(l, rb, lm, 1, rows, false, false);
              warp_energies<kBf16>(sQ + lm * wd, sW, ldu, nmask + rb, sE, rows, H, hd, a.dk);
              if (!one) keep_rows(n0, rows);
            } else if (one) {
              row_forward(l, rb, lm, 1, rows, false, true);
            }
            warp_attention_grad<kBf16>(sDQ + lm * wd, sW, ldu, nmask + rb,
                                       a.attn_dropout ? sM : nullptr, sFa + n0 * H, rows, H, hd);
            __syncthreads();
          }
          if (!sb) {
            wide_softmax(sEa, N, H, [&](int n, int h, float p) { sEa[n * H + h] = p; });
            __syncthreads();
          }
          wide_softmax_backward<kBf16>(sEa, sFa, N, H);
          __syncthreads();
        }
        for (int n0 = 0; n0 < (kWide ? N : 1); n0 += kWide ? CR : 1, ++ci) {
          const int rows = kWide ? min(CR, N - n0) : ca * N, base = m0 * N + n0;
          if constexpr (kWide) {
            sE = sEa + n0 * H;
            sF = sFa + n0 * H;
            if (!one && !sb) {
              stage_kept(l, base, n0, rows);
              row_forward(l, base, lm0, ca, rows, false, true);
            } else if (!one) {
              stage_chunk(l, base, rows, c_in, D, true);
              row_forward(l, base, lm0, ca, rows, false, true);
            }
          } else {
            stage_chunk(l, base, rows, c_in, D, sb != 0);
            row_forward(l, base, lm0, ca, rows, false, sb != 0);
          }
          if constexpr (kTall) {
            if (hd % 4 == 0)
              tall_softmax_backward<kBf16>(sDQ + lm0 * wd, wd, sW, ldu, nmask + base,
                                           a.attn_dropout ? sM : nullptr, sE, sF, ca, N, H, hd);
            else
              warp_softmax_backward<kBf16>(sDQ + lm0 * wd, wd, sW, ldu, nmask + base,
                                           a.attn_dropout ? sM : nullptr, sE, sF, ca, N, H, hd);
            __syncthreads();
          } else if constexpr (!kWide) {
            // d attn = mask * nmask * sum_{d in head} d ctx * key, then the softmax
            // backward over the N neighbours, on the pre-dropout attention
            warp_softmax_backward<kBf16>(sDQ + lm0 * wd, wd, sW, ldu, nmask + base,
                                  a.attn_dropout ? sM : nullptr, sE, sF, ca, N, H, hd);
            __syncthreads();
          }
          // d key (in place of the key) and d query = d ctx + dk sum_n de key
          // (wide: the sum carried in sEx from sub-chunk to sub-chunk)
          for (int i = tid; i < ca * D; i += kThreads) {
            const int at = i / D, d = i - at * D, h = d / hd, m = lm0 + at;
            const float dctx = sDQ[m * wd + d];
            const float qs = sQ[m * wd + d] * a.dk;
            float ex = kWide && n0 > 0 ? sEx[d] : 0.f;
            for (int n = 0; n < (kWide ? rows : N); ++n) {
              const int r = at * N + n;
              const float de = sF[r * H + h];
              const float used =
                  operand<kBf16>(a.attn_dropout ? sE[r * H + h] * sM[r * H + h] : sE[r * H + h]);
              ex += de * sW[r * ldu + d];
              sW[r * ldu + d] = dctx * used * nmask[base + r] + de * qs;
            }
            if constexpr (kWide) sEx[d] = ex;
            else sDQ[m * wd + d] = dctx + ex * a.dk;
          }
          __syncthreads();
          // key = kin @ Wk + bk
          mma_gemm_tA<kBf16>(sV, ldu, sW, ldu, rows, D, D, grad(gWK) + (size_t)l * D * D, D, ci > 0, sAcc, true);
          __syncthreads();
          mma_gemm_tB<kBf16>(sW, ldu, rows, D, wk, D, D, D, [&](int r, int c, float4 v) { store4(sV + r * ldu + c, v); });
          __syncthreads();
          if (a.g_update) {
            // kin = ns * geo', geo' = LN_g(swish(u_pre) + geo)
            const float* gs = a.lng_s + (size_t)l * D;
            const float* gb = a.lng_b + (size_t)l * D;
            for (int r = warp; r < rows; r += kWarps) {
              float v[kLaneValues], xh[kLaneValues], dy[kLaneValues], dx[kLaneValues], mean, inv;
#pragma unroll
              for (int i = 0; i < kLaneValues; ++i) {
                const int d = lane + 32 * i;
                v[i] = d < D ? swishf(sU[r * ldu + d]) + sA[r * lda + d] : 0.f;
              }
              warp_ln_stats(v, D, lane, mean, inv);
#pragma unroll
              for (int i = 0; i < kLaneValues; ++i) {
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
              for (int i = 0; i < kLaneValues; ++i) {
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
            mma_gemm_tA<kBf16>(sA, lda, sU, ldu, rows, 2 * D, D,
                        grad(gWFG) + (size_t)l * fg_in * D + (size_t)D * D, D, ci > 0, sAcc + wd, true);
            for (int i = tid; i < ca * D; i += kThreads) {
              const int at = i / D, d = i - at * D;
              float s = kWide && n0 > 0 ? sDCW[(lm0 + at) * wd + d] : 0.f;
              for (int n = 0; n < (kWide ? rows : N); ++n) s += sU[(at * N + n) * ldu + d];
              sDCW[(lm0 + at) * wd + d] = s;
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
          } else if constexpr (kHomes) {
            tall_gemm_tA<kBf16>(sA, lda, sU, ldu, rows, K, D, grad(gWFG) + (size_t)l * fg_in * D, D,
                                ci > 0, sAcc + wd, true);
          } else {
            mma_gemm_tA<kBf16>(sA, lda, sU, ldu, rows, K, D, grad(gWFG) + (size_t)l * fg_in * D, D, ci > 0,
                        sAcc + wd, true);
          }
          __syncthreads();
          // the gather's transpose: d centers[idx] += d ns, in row order
          // (tall, wide: the partial in global memory, 16 rows' targets loaded at once)
          if constexpr (kHomes) {
            if (sc_part < np)
              tall_scatter<kBf16>(sDCN, nbr + base, sV, ldu, ldn, rows, np, sc_part, sc_d);
          } else if (sc_part < np)
            for (int r = 0; r < rows; ++r) {
              const int idx = nbr[base + r];
              if (idx % np == sc_part) sDCN[idx * ldn + sc_d] += operand<kBf16>(sV[r * ldu + sc_d]);
            }
          __syncthreads();
        }
        if constexpr (kWide) {
          for (int d = tid; d < D; d += kThreads)
            sDQ[lm0 * wd + d] = sDQ[lm0 * wd + d] + sEx[d] * a.dk;
          __syncthreads();
        }
      }

      // ---- per-atom gradients of the block -----------------------------------
      if (a.g_update) flush_ln(grad(gLNGS) + (size_t)l * D, grad(gLNGB) + (size_t)l * D, acc);
      mma_gemm_tA<kBf16>(sCb, wd, sDQ, wd, ab, D, D, grad(gWQ) + (size_t)l * D * D, D, acc,
                  grad(gBQ) + (size_t)l * D, acc);
      if (a.g_update)
        mma_gemm_tA<kBf16>(sCb, wd, sDCW, wd, ab, D, D, grad(gWFG) + (size_t)l * fg_in * D, D, acc);
      mma_gemm_tB<kBf16>(sDQ, wd, ab, D, a.wq + (size_t)l * D * D, D, D, D, [&](int r, int c, float4 v) {
        float* p = sDCN + (ab0 + r) * ldn + c;
        if constexpr (kD256) red_add4(p, v);
        else store4(p, make_float4(p[0] + v.x, p[1] + v.y, p[2] + v.z, p[3] + v.w));
      });
      __syncthreads();
      if (a.g_update) {
        mma_gemm_tB<kBf16>(sDCW, wd, ab, D, wfg, D, D, D, [&](int r, int c, float4 v) {
          float* p = sDCN + (ab0 + r) * ldn + c;
          if constexpr (kD256) red_add4(p, v);
          else store4(p, make_float4(p[0] + v.x, p[1] + v.y, p[2] + v.z, p[3] + v.w));
        });
      }
      __syncthreads();
    }
    for (int d = tid; d < D; d += kThreads) {
      grad(gBK)[(size_t)l * D + d] = sAcc[d];
      grad(gBFG)[(size_t)l * D + d] = sAcc[wd + d];
    }
    // d (this layer's input) is d (the output of the layer below): for this
    // block's atoms, the sum of the cluster's partial rows in rank order (tall,
    // wide: the partials in global memory, past L1; the sum to dcen alone)
    if (C > 1) cluster.sync();
    for (int i = tid; i < (m_hi - m_lo) * q4; i += kThreads) {
      const int m = m_lo + i / q4, c = (i % q4) * 4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < C; ++q) {
        float4 v;
        if constexpr (kHomes) {
          v = __ldcg(reinterpret_cast<const float4*>(tall_slice(q) + (size_t)M * G + m * D + c));
        } else {
          const float* part = C > 1 ? cluster.map_shared_rank(sDCN, q) : sDCN;
          v = *reinterpret_cast<const float4*>(part + m * wd + c);
        }
        s = q == 0 ? v : make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
      }
      store4(dcen + (size_t)m * D + c, s);
      if constexpr (!kHomes) store4(sDCN + m * wd + c, s);
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
    mma_gemm<kBf16>(sEmb, lde, ab, ke, a.wde, D, D, [&](int r, int c, float4 v) {
      const float4 m = mask4(0, ab0 + r, c);
      const float* dc = kHomes ? dcen + (size_t)(ab0 + r) * D + c : sDCN + (ab0 + r) * wd + c;
      store4(E1 + r * wd + c,
             make_float4(dc[0] * m.x * swish_grad(v.x + a.bde[c]),
                         dc[1] * m.y * swish_grad(v.y + a.bde[c + 1]),
                         dc[2] * m.z * swish_grad(v.z + a.bde[c + 2]),
                         dc[3] * m.w * swish_grad(v.w + a.bde[c + 3])));
    });
    __syncthreads();
    mma_gemm_tA<kBf16>(sEmb, lde, E1, wd, ab, ke, D, grad(gWDE), D, acc, grad(gBDE), acc);
    mma_gemm_tB<kBf16>(E1, wd, ab, D, a.wde, D, lde, ke, [&](int r, int c, float4 v) {
      store4(E2 + r * lde + c, v);
    });
    __syncthreads();
    if (a.cgcnn) {
      mma_gemm_tA<kBf16>(sFeat, ldf, E2, lde, ab, a.F, a.E, grad(gEMBED), a.E, acc, grad(gBEMBED), acc);
    } else {
      // the one-hot embedding's transpose: scatter d emb into the rows of Z
      float* ge = grad(gEMBED);
      for (int e = tid; e < a.E; e += kThreads) {
        if (!acc)
          for (int z = 0; z < a.V; ++z) ge[(size_t)z * a.E + e] = 0.f;
        for (int m = 0; m < ab; ++m)
          ge[(size_t)a.atomic[(size_t)b * M + ab0 + m] * a.E + e] += operand<kBf16>(E2[m * lde + e]);
      }
    }
    if (a.use_ring) {
      for (int i = tid; i < 30; i += kThreads) {
        const int k = i / 10, j = i - k * 10;   // k == 2: the bias
        float s = 0.f;
        for (int m = 0; m < ab; ++m) {
          const float dr = E2[m * lde + a.E + j];
          s += k < 2 ? operand<kBf16>(a.ring[((size_t)b * M + ab0 + m) * 2 + k]) * operand<kBf16>(dr)
                     : dr;
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
    for (int m0 = kWide ? m_lo * N : m_lo; m0 < (kWide ? m_hi * N : m_hi);
         m0 += kWide ? CR : CA, ++ci) {
      const int ca = min(CA, m_hi - m0), rows = kWide ? min(CR, m_hi * N - m0) : ca * N,
                base = kWide ? m0 : m0 * N;
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
      mma_gemm_tA<kBf16>(sA, lda, sU, ldu, rows, K, D, grad(gWND), D, ci > 0, grad(gBND), ci > 0);
      mma_gemm_tA<kBf16>(sA + D, lda, sV, ldu, rows, K, D, grad(gWNW), D, ci > 0, grad(gBNW), ci > 0);
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
  a.S = dims[22];
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

// The pointers, sizes, scalars, random-stream words and offsets are those of
// unpack_backward_args (scann_grad_common.cuh), followed by pointer 54, the
// d(layer output) scratch [B, M, D], pointer 55, the segment ids [B, M] (null
// unless packed), pointers 56-58, the activation stash's rows [B, L, 3, M*N,
// D], attention [B, L, M*N, H] (both null in the recompute schedule) and o1
// [B, L, M, D] (f32; the bf16 stash only), size 21, the atom block, size 22,
// the segments per slot S, size 23, the blocks per structure C (grad_rows is
// then [B * C, P]), and size 24, the stash's element bytes (0, 4 or 2); in
// the order scann_tpu_torch/kernels/scann_loop.py passes them, and pointer
// 59, the tall scratch [B * C, M, G + D] (the tall build; the wide build: with
// the key scratch [B * C, N, D] right after it), null in the narrow builds.
// Launches the
// backward kernel in the operand mode kBf16 (a cluster
// of C blocks per structure; kWide: N > kMaxChunkRows) and the reduction of
// its gradient rows into out [P].
template <bool kBf16, bool kWide>
int launch_backward(void* const* ptrs, const int* dims, const float* scalars,
                    const unsigned int* rng, const long long* offsets, float* out, void* stream) {
  Args a;
  unpack_backward_args(a, ptrs, dims, scalars, rng, offsets);
  a.dcenters = (float*)ptrs[54];
  a.seg = (const int*)ptrs[55];
  a.atom_block = dims[21];
  a.S = dims[22];
  a.cluster = dims[23];
  a.stash = dims[24];
  a.st_rows = ptrs[56];
  a.st_attn = ptrs[57];
  a.st_atoms = (float*)ptrs[58];
  float* wide_keys = (float*)ptrs[59];
  // the wide build: kMaxChunkRows < N <= kWideMaxN, one atom a chunk; the
  // wide and tall builds: their scratch
  if ((a.N > kMaxChunkRows) != kWide || (wide_keys != nullptr) != (kWide || kTall) ||
      (kWide && (a.N > kWideMaxN || a.chunk_atoms != 1)))
    return kErrShape;
  if ((a.stash != 0 && a.stash != 4 && a.stash != 2) ||
      (a.stash != 0) != (a.st_rows != nullptr && a.st_attn != nullptr) ||
      (a.stash == 2) != (a.st_atoms != nullptr))
    return kErrShape;
  if (a.S < 0 || a.S > kMaxSegments || (a.S > 0) != (a.seg != nullptr)) return kErrShape;
  if (a.M < 1 || a.N < 1 || a.L < 1 || a.chunk_atoms < 1 ||
      (!kWide && a.chunk_atoms * a.N > (kTall ? kTallChunkRows : kMaxChunkRows)) ||
      a.atom_block < 1 ||
      a.atom_block > kMaxAtomBlock || a.chunk_atoms > a.atom_block ||
      a.cluster < 1 || a.cluster > kMaxCluster ||
      a.D > kMaxWidth || a.G > kMaxWidth || a.O > kMaxWidth ||
      (a.D & 3) || (a.G & 3) || (a.O & 3) || (a.E & 3) || a.D % a.H || a.K > a.D || a.P <= 0)
    return kErrShape;
  const int bytes = build_plan<kWide>(a).total * (int)sizeof(float);
  if (bytes > kMaxSharedBytes) return kErrSharedMemory;
  cudaError_t err = cudaFuncSetAttribute(scann_loop_backward_kernel<kBf16, kWide>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch_config(cfg, attr, a.B, a.cluster, bytes, s);
  err = cudaLaunchKernelEx(&cfg, scann_loop_backward_kernel<kBf16, kWide>, a, wide_keys);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce_rows(a.grad_rows, a.B * a.cluster, a.P, out, s);
}

const char* error_string(int code) {
  if (code == kErrSharedMemory) return "shared-memory plan exceeds 227 KB per block";
  if (code == kErrShape) return "shape outside what the kernel takes";
  return cudaGetErrorString((cudaError_t)code);
}

// How many clusters of `cluster` blocks with this shape's shared memory the
// card runs at once (cudaOccupancyMaxActiveClusters) in the kernel of the
// operand mode kBf16 of the narrow or the wide build, or minus the CUDA error.
template <bool kBf16, bool kWide>
int max_clusters(const int* dims, int cluster) {
  Args a = {};
  set_dims(a, dims);
  const int bytes = build_plan<kWide>(a).total * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(scann_loop_backward_kernel<kBf16, kWide>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch_config(cfg, attr, a.B, cluster, bytes, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, scann_loop_backward_kernel<kBf16, kWide>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// Ten builds of this file, each its own library (so that nvcc compiles them
// in parallel) with its own entry points: the f32 narrow one (no define), the
// bf16 one (scann_loop_backward_bf16.cu: SCANN_LOOP_BACKWARD_BF16), the wide
// ones (scann_loop_backward_wide.cu, _wide_bf16.cu: SCANN_LOOP_BACKWARD_WIDE)
// and the tall ones (scann_loop_backward_tall.cu, _tall_bf16.cu:
// SCANN_LOOP_BACKWARD_TALL), and the wide and tall ones of widths up to 256
// (scann_loop_backward_{wide,tall}_d256.cu and their _bf16 twins:
// SCANN_WIDTH_256 as well), each with <name>_launch, <name>_error_string and
// <name>_max_clusters, the launcher taking the f32 narrow build's arguments.
#if defined(SCANN_LOOP_BACKWARD_BF16)
constexpr bool kBf16Build = true;
#else
constexpr bool kBf16Build = false;
#endif
#if defined(SCANN_LOOP_BACKWARD_WIDE)
constexpr bool kWideBuild = true;
#else
constexpr bool kWideBuild = false;
#endif
#if defined(SCANN_WIDTH_256) && defined(SCANN_LOOP_BACKWARD_WIDE) && \
    defined(SCANN_LOOP_BACKWARD_BF16)
#define SCANN_LOOP_BACKWARD_ENTRY(x) scann_loop_backward_wide_d256_bf16_##x
#elif defined(SCANN_WIDTH_256) && defined(SCANN_LOOP_BACKWARD_WIDE)
#define SCANN_LOOP_BACKWARD_ENTRY(x) scann_loop_backward_wide_d256_##x
#elif defined(SCANN_WIDTH_256) && defined(SCANN_LOOP_BACKWARD_TALL) && \
    defined(SCANN_LOOP_BACKWARD_BF16)
#define SCANN_LOOP_BACKWARD_ENTRY(x) scann_loop_backward_tall_d256_bf16_##x
#elif defined(SCANN_WIDTH_256) && defined(SCANN_LOOP_BACKWARD_TALL)
#define SCANN_LOOP_BACKWARD_ENTRY(x) scann_loop_backward_tall_d256_##x
#elif defined(SCANN_LOOP_BACKWARD_WIDE) && defined(SCANN_LOOP_BACKWARD_BF16)
#define SCANN_LOOP_BACKWARD_ENTRY(x) scann_loop_backward_wide_bf16_##x
#elif defined(SCANN_LOOP_BACKWARD_WIDE)
#define SCANN_LOOP_BACKWARD_ENTRY(x) scann_loop_backward_wide_##x
#elif defined(SCANN_LOOP_BACKWARD_TALL) && defined(SCANN_LOOP_BACKWARD_BF16)
#define SCANN_LOOP_BACKWARD_ENTRY(x) scann_loop_backward_tall_bf16_##x
#elif defined(SCANN_LOOP_BACKWARD_TALL)
#define SCANN_LOOP_BACKWARD_ENTRY(x) scann_loop_backward_tall_##x
#elif defined(SCANN_LOOP_BACKWARD_BF16)
#define SCANN_LOOP_BACKWARD_ENTRY(x) scann_loop_backward_bf16_##x
#else
#define SCANN_LOOP_BACKWARD_ENTRY(x) scann_loop_backward_##x

extern "C" int scann_loop_backward_shared_bytes(const int* dims) {
  Args a = {};
  set_dims(a, dims);
  return plan_of(a).total * (int)sizeof(float);
}
#endif

extern "C" int SCANN_LOOP_BACKWARD_ENTRY(max_clusters)(const int* dims, int cluster) {
  return max_clusters<kBf16Build, kWideBuild>(dims, cluster);
}

extern "C" int SCANN_LOOP_BACKWARD_ENTRY(launch)(void* const* ptrs, const int* dims,
                                                 const float* scalars, const unsigned int* rng,
                                                 const long long* offsets, float* out,
                                                 void* stream) {
  return launch_backward<kBf16Build, kWideBuild>(ptrs, dims, scalars, rng, offsets, out, stream);
}

extern "C" const char* SCANN_LOOP_BACKWARD_ENTRY(error_string)(int code) {
  return error_string(code);
}
