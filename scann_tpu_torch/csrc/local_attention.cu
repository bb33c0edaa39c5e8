// One LocalAttention layer (SCANN+ or SCANN), forward, for structures of any
// size: one CUDA block per (structure, block of atoms).
//
// Replaces the TPU kernel scann_tpu/kernels/local_attention.py:_kernel (the
// Pallas per-layer kernel): neighbour gather -> SCANN+ geometry update or
// SCANN distance filter -> key and query projections -> per-head masked
// softmax over the N neighbours -> masked context sum -> + query ->
// LayerNorm. Outputs out [B, M, D], the updated geometry [B, M, N, D]
// (SCANN+) and the attention [B, M, N, H] before the neighbour mask. The
// eager model runs the rest of the network around it, for shapes and
// configurations the whole-model kernels refuse. Its tensors are all f32 or
// all bfloat16 (model.dtype "bfloat16": the TPU kernel on bf16 inputs,
// local_attention.py:139-205): a bfloat16 instantiation reads them, computes
// in f32 exactly as the f32 one does and stores its outputs as bfloat16.
//
// Bound. At one MP2018 layer (B=64, M=96, N=32, D=128, SCANN+) the layer is
// ~1.98e10 FLOP, 99.5% of it row products. They run on the tensor cores in
// three TF32 passes to keep f32 accuracy (scann_mma.cuh): ~0.12 ms at the
// H100 SXM's dense 495 TFLOP/s TF32, with the energies and context (1.0e8
// FLOP) at 67 TFLOP/s FP32. The layer reads and writes the geometry once each
// (2 x 100 MB) beside ~10 MB of other tensors, ~0.06 ms at 3.35 TB/s: bound
// by operations. The wide build's timed shapes (N = 96, M = 48 or 96): 4.58e8
// FLOP at (1, 48, 96), 0.0028 ms; 7.34e9 at (8, 96, 96), 0.0448 ms; 5.87e10
// at (64, 96, 96), 0.3584 ms; each by operations (the bytes: 0.0016, 0.0238,
// 0.1893 ms).
//
// Design.
// - The launch plan (make_plan) picks the atom block AB of {64, 48, 32, 16}
//   with the fewest atoms per SM: a block takes a whole SM (its shared memory
//   and 255 registers a thread), so the B * ceil(M / AB) blocks run in
//   ceil(B * ceil(M / AB) / n_sm) waves of AB atoms each. MP2018 (64, 96, 32)
//   gets AB = 48, 128 blocks in one wave; (8, 256, 32) AB = 16, 128 blocks.
// - The previous layer's centers are read from global memory (3 MB at
//   MP2018, resident in L2), so nothing limits M and a block needs no other
//   block. A block writes only its own atoms' rows, so a launch repeats bit
//   for bit.
// - A block stages its atoms' centers and forms their queries and, for
//   SCANN+, the center term cw = centers @ Wfg[0:D] with mma_gemm (split-TF32
//   mma.sync), then sends its (atom, neighbour) rows through fwd_chunk
//   (scann_forward_common.cuh, shared with the whole-model forwards) in
//   chunks of at most 64 rows: the products on the tensor cores, the softmax
//   one warp per (atom, head), the context one thread per (atom, column). A
//   chunk's geometry (or its distance RBF) and its neighbours' states,
//   gathered from the centers in global memory, arrive by cp.async.
// - Wide neighbour lists (64 < N <= 256, the wide build of
//   local_attention_wide.cu, wide_block): one atom at a time through
//   fwd_atom_wide_keys, the atom walk the wide #3 shares, its rows in
//   sub-chunks of 64. An atom is already 2-4 sub-chunks of work, so the plan
//   (make_wide_plan) takes its atom block from {16, 8, 4, 2, 1} by the waves'
//   cost, ceil(blocks / n_sm) x (20 AB + 3): a block's head (its atoms' cw
//   and query products, which read Wfg[0:D] and Wq from L2 whatever the
//   block's atoms) costs about 0.15 of an atom. AB = 1 at (1, 48, 96) (48
//   blocks, not 3 of 16), 2 at (8, 96, 96) (384 blocks, not 48), 16 at
//   (64, 96, 96). The atom's energies [N, H] stay in shared memory for
//   wide_softmax over all N, its keys [N, D] too where the plan holds them
//   (at D = 128: N <= 237 at AB = 1, 208 at AB = 16), else in a per-block
//   global scratch [blocks, N, D] read back past L1; the context splits the
//   N neighbours into two halves over the block's 256 threads (thread t:
//   column t % D of half t / D), each summed in neighbour order, then first
//   half + second half + query. Staging: each atom's neighbour indices go
//   into a ring in shared memory one atom ahead (cp.async), so no staging
//   waits on an index load; where the plan holds a second operand buffer (at
//   D = 128: N <= 116 at AB = 1, 88 at AB = 16) the next sub-chunk, or the
//   next atom's first, is staged into it as soon as this one has landed, and
//   the first one while the block forms its queries. f32 rows arrive by
//   cp.async behind the products; bfloat16 rows (and an RBF whose K is not a
//   multiple of 4) are loaded, converted to f32 and stored, in the open. On
//   bfloat16 tensors the plan takes the smallest layout instead (one buffer,
//   the keys in the scratch): the L1 beside it holds the bf16 weights of the
//   row products, which their 32-row passes read again; on an H100 that is
//   ~10% faster at (64, 96, 96) than the f32 layout, and the keys in shared
//   memory and the second buffer buy no time there.
// - Past 128 columns, the narrow build (local_attention_d256.cu, d256_block):
//   chunks of at most 32 rows (kD256ChunkRows: one atom at N = 32, an atom
//   alone past it), so that two operand buffers fit beside the slots of 16
//   atoms at D = 256 (199,680 B; 232,448 B with the bf16 raw area): the
//   next chunk is staged by cp.async while this one runs, the first while
//   the block forms its queries; bfloat16 rows land in a raw area and are
//   converted once the chunk is done (one buffer, staged in the open, where
//   two do not fit: N past 32 at D = 256). MP2018 (64, 96, 32) takes 16
//   atoms a block (384 blocks, 2.9 waves; 48 atoms with one buffer cost the
//   same waves and lose the tie). Every product, the head's too, is
//   mma_gemm_w32 (scann_mma.cuh) on packed TF32 planes of Wfg, Wk and Wq
//   that the wrapper splits once (kernels/local_attention.py layer_planes;
//   f32 on bfloat16 tensors too, where lo is zero), so the outputs are the
//   parent layout's bits whatever the plan.
// - Past 128 columns, the wide build (local_attention_wide_d256.cu,
//   wide_d256_block): the same walk in the 32-column layout on the same
//   planes, each atom's rows in sub-chunks of 32 in two operand buffers (at
//   D = 256 what one buffer of 64 rows took), the next sub-chunk, or the
//   next atom's first, staged behind the products as d256_block stages
//   (bfloat16 rows through the raw area); the keys in L2 at D = 256 (they
//   fit beside two buffers only to N = 61 there).
// - Limits: D a multiple of 4 up to 128 (a warp's LayerNorm holds 4 values a
//   lane), N <= 256 (the narrow build N <= 64), K <= D, D % H == 0. The
//   *_d256 builds (SCANN_WIDTH_256: 8 values a lane) take D up to 256, the
//   narrow one with atom blocks down to 8 and the wide one's context one
//   thread a column over all N.
// - Past 256 columns (local_attention_d512.cu, local_attention_wide_d512.cu:
//   SCANN_WIDTH_512 beside SCANN_WIDTH_256, 16 values a lane, D up to 512):
//   d256_block and wide_d256_block with chunks and sub-chunks of 16 rows
//   (kD256ChunkRows, kFwdWideW32Rows), since one operand buffer of 32 rows
//   is 131,584 bytes at D = 512; so the narrow build takes N <= 16
//   (kNarrowMaxN: an atom's list within a chunk) and the wide one N > 16,
//   with atom blocks down to 4 in the narrow plan; the keys in L2, the
//   context a thread's two columns over all N.
//
// Summation orders (a launch repeats bit for bit): every product as
// mma_gemm sums (scann_mma.cuh); the energies over the head's lanes in
// order; the softmax lane by lane, then warp_sum's fixed tree; the narrow
// context over the chunk's neighbours in order; the wide context over each
// half in order, then the halves in order; the LayerNorms as
// warp_layer_norm.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// given stream, synchronises nothing, allocates nothing, and returns the
// cudaGetLastError() code of the launch (or kErrSharedMemory / kErrShape).

#include "scann_forward_common.cuh"

namespace {

using namespace scann;

// Past 128 columns (the *_d256 builds) a chunk of 64 rows and the slots of
// 16 atoms outgrow a block's shared memory (at D = 256, N = 32), so the
// narrow plan also takes blocks of 8 atoms there.
#if defined(SCANN_WIDTH_512)
constexpr int kAtomBlocks[] = {64, 48, 32, 16, 8, 4};
#elif defined(SCANN_WIDTH_256)
constexpr int kAtomBlocks[] = {64, 48, 32, 16, 8};
#else
constexpr int kAtomBlocks[] = {64, 48, 32, 16};
#endif

// The kernel's tensors, of element type T (float or bfloat16).
template <typename T>
struct Args {
  const T* centers;       // [B, M, D]
  const int* nbr;         // [B, M, N]
  const T* geometry;      // [B, M, N, D] (SCANN+) or [B, M, N, K] (SCANN)
  const T* nmask;         // [B, M, N]
  const T* nweight;       // [B, M, N]    (SCANN)
  const T* wq;            // [D, D]
  const T* bq;
  LayerWeightsT<T> w;
  T* out;                 // [B, M, D]
  T* geo_out;             // [B, M, N, D] (SCANN+)
  T* attn;                // [B, M, N, H]
  // the builds past 128 columns: the packed TF32 planes of Wfg, Wk and Wq
  // (layer_plane_floats, tf32_planes of the wrapper); null elsewhere
  const float* planes;
  int B, M, N, D, H, K, g_update, atom_block, chunk_atoms;
  float dk;               // hd ** -scale
};

// Shared-memory plan of one atom block, in floats: the queries (then the
// outputs) and, for SCANN+, cw [AB, D + 4] each; the work region, which
// holds the block's centers [AB, D + 4] for the per-atom products and then a
// chunk's buffers (fwd_chunk_floats).
struct Plan {
  int atom_block, chunk_atoms, work, total;
};

inline Plan plan_for(int AB, int N, int D, int H, int g_update) {
  Plan p;
  p.atom_block = AB;
  const int fit = kFwdMaxChunkRows / N;
  p.chunk_atoms = fit < 1 ? 1 : fit < AB ? fit : AB;
  const int chunk = fwd_chunk_floats(p.chunk_atoms * N, D, H);
  const int centers = AB * (D + 4);
  p.work = chunk > centers ? chunk : centers;
  p.total = (g_update ? 2 : 1) * AB * (D + 4) + p.work;
  return p;
}

// The atom block of kAtomBlocks whose plan fits a block's shared memory with
// the fewest atoms per SM, ceil(blocks / n_sm) * AB (the larger block where
// two tie); atom_block 0 if none fits.
inline Plan make_plan(int B, int M, int N, int D, int H, int g_update, int n_sm) {
  Plan best = {0, 0, 0, 0};
  long long best_cost = -1;
  for (int AB : kAtomBlocks) {
    const Plan p = plan_for(AB, N, D, H, g_update);
    if (p.total * (int)sizeof(float) > kMaxSharedBytes) continue;
    const long long blocks = (long long)B * ((M + AB - 1) / AB);
    const long long cost = (blocks + n_sm - 1) / n_sm * AB;
    if (best_cost < 0 || cost < best_cost) {
      best = p;
      best_cost = cost;
    }
  }
  return best;
}

// The narrow build past 128 columns (local_attention_d256.cu): chunks of at
// most 32 rows (one atom at N = 32; an atom of N rows past 32), so that two
// operand buffers fit beside the slots of 16 atoms at D = 256: the next chunk
// is staged into one while this one runs in the other. On bfloat16 tensors a
// raw area [rows, 2D] of bfloat16 takes the next chunk's rows by cp.async,
// converted into the free buffer once this chunk is done. Where two buffers
// (and the raw area) do not fit, one buffer staged in the open, as the
// builds up to 128 columns stage. The front holds the block's centers for
// the head products, then a chunk's product and attention.
#ifdef SCANN_WIDTH_512
constexpr int kD256ChunkRows = 16;   // past 256 columns
#else
constexpr int kD256ChunkRows = 32;
#endif
// The largest N of the narrow build: an atom's list within a chunk
// (kFwdMaxChunkRows; past 256 columns kD256ChunkRows), the wide build taking
// the rest.
constexpr int kNarrowMaxN = kLaneValues > 8 ? kD256ChunkRows : kFwdMaxChunkRows;

struct D256Plan {
  int atom_block, chunk_atoms, buffers, offA, offA1, offR, work, total;
};

__host__ __device__ inline D256Plan d256_plan_for(int AB, int N, int D, int H, int g_update,
                                                  int bf16) {
  D256Plan p;
  p.atom_block = AB;
  const int fit = kD256ChunkRows / N;
  p.chunk_atoms = fit < 1 ? 1 : fit < AB ? fit : AB;
  const int rows = p.chunk_atoms * N;
  const int chunk = rows * (D + 4) + round4(rows * H), centers = AB * (D + 4);
  const int front = chunk > centers ? chunk : centers;
  const int slots = (g_update ? 2 : 1) * AB * (D + 4), buf = rows * (2 * D + 4);
  p.buffers = 2;
  p.offA = front;
  p.offA1 = front + buf;
  p.offR = front + 2 * buf;
  p.work = p.offR + (bf16 ? rows * D : 0);
  p.total = slots + p.work;
  if (p.total * (int)sizeof(float) > kMaxSharedBytes) {
    p.buffers = 1;
    p.offA1 = p.offA;
    p.offR = p.work = front + buf;
    p.total = slots + p.work;
  }
  return p;
}

// make_plan of the narrow build past 128 columns: kAtomBlocks by the same
// cost, each with d256_plan_for's layout; where two cost the same, the one
// with two operand buffers (its staging hides behind the products), then the
// larger block.
inline D256Plan make_d256_plan(int B, int M, int N, int D, int H, int g_update, int bf16,
                               int n_sm) {
  D256Plan best = {0, 0, 0, 0, 0, 0, 0, 0};
  long long best_cost = -1;
  for (int AB : kAtomBlocks) {
    const D256Plan p = d256_plan_for(AB, N, D, H, g_update, bf16);
    if (p.total * (int)sizeof(float) > kMaxSharedBytes) continue;
    const long long blocks = (long long)B * ((M + AB - 1) / AB);
    const long long cost = (blocks + n_sm - 1) / n_sm * AB;
    if (best_cost < 0 || cost < best_cost || (cost == best_cost && p.buffers > best.buffers)) {
      best = p;
      best_cost = cost;
    }
  }
  return best;
}

// The wide build's atom blocks and the cost of its plan's waves: an atom of N
// > kFwdMaxChunkRows neighbours is 2-4 sub-chunks of work already, so the
// blocks go down to one atom; a block's head (its atoms' centers staged, and
// their cw and query products: an m16 tile each, which reads Wfg[0:D] and
// Wq from L2 whatever the block's atoms) costs about 0.15 of an atom's rows
// (~18k of ~120k cycles on an H100 at N = 96, D = 128), so a wave of AB
// atoms costs kWideAtomCost * AB + kWideHeadCost.
constexpr int kWideAtomBlocks[] = {16, 8, 4, 2, 1};
constexpr int kWideAtomCost = 20;
constexpr int kWideHeadCost = 3;

// Shared-memory plan of the wide build, in floats: the queries and cw [AB, D
// + 4] as in Plan, then the work region: the front (the block's centers [AB,
// D + 4] for the per-atom products, then a sub-chunk's product [64, D + 4]
// and the atom's energy row [N, H]), `buffers` operand buffers [64, 2D + 4]
// (offA, offA1: the same where there is one), the index ring [2][N] (two
// atoms' neighbour indices; round4(2N) floats, so what follows stays 16-byte
// aligned at an odd N) and, with smem_keys, the atom's keys [N, D].
struct WidePlan {
  int atom_block, buffers, smem_keys, offA, offA1, offI, offK, total;
};

__host__ __device__ inline WidePlan wide_plan_for(int AB, int N, int D, int H, int g_update,
                                                  int smem_keys, int buffers) {
  WidePlan p;
  p.atom_block = AB;
  p.buffers = buffers;
  p.smem_keys = smem_keys;
  const int front = kFwdMaxChunkRows * (D + 4) + round4(N * H);
  const int centers = AB * (D + 4);
  p.offA = front > centers ? front : centers;
  p.offA1 = p.offA + (buffers - 1) * kFwdMaxChunkRows * (2 * D + 4);
  p.offI = p.offA + buffers * kFwdMaxChunkRows * (2 * D + 4);
  p.offK = p.offI + round4(2 * N);
  p.total = (g_update ? 2 : 1) * AB * (D + 4) + p.offK + (smem_keys ? N * D : 0);
  return p;
}

// The layout of a wide block of AB atoms: on f32 tensors the keys in shared
// memory where they fit beside one operand buffer, and a second buffer where
// that fits too; on bfloat16 tensors (bf16) the smallest layout, one buffer
// and the keys in L2, so that the L1 beside it (~124 KB at D = 128) holds
// the bf16 weights of the row products (Wfg[D:3D] and Wk, 96 KB), which
// their 32-row passes read again (f32 weights, 192 KB, never fit);
// atom_block 0 if nothing fits.
__host__ __device__ inline WidePlan wide_block_plan(int AB, int N, int D, int H, int g_update,
                                                    int bf16) {
  WidePlan p = {0, 0, 0, 0, 0, 0, 0, 0};
  // layouts i = 0-3: {smem_keys, buffers} = {1, 2}, {1, 1}, {0, 2}, {0, 1}
  for (int i = bf16 ? 3 : 0; i < 4; ++i) {
    const WidePlan q = wide_plan_for(AB, N, D, H, g_update, i < 2, 2 - (i & 1));
    if (q.total * (int)sizeof(float) <= kMaxSharedBytes) return q;
  }
  return p;
}

// make_plan for the wide build: the atom block of kWideAtomBlocks whose waves
// cost least, ceil(blocks / n_sm) * (kWideAtomCost * AB + kWideHeadCost),
// the smaller block where two tie.
inline WidePlan make_wide_plan(int B, int M, int N, int D, int H, int g_update, int bf16,
                               int n_sm) {
  WidePlan best = {0, 0, 0, 0, 0, 0, 0, 0};
  long long best_cost = -1;
  for (int AB : kWideAtomBlocks) {
    const WidePlan p = wide_block_plan(AB, N, D, H, g_update, bf16);
    if (p.atom_block == 0) continue;
    const long long blocks = (long long)B * ((M + AB - 1) / AB);
    const long long cost = (blocks + n_sm - 1) / n_sm * (kWideAtomCost * AB + kWideHeadCost);
    if (best_cost < 0 || cost <= best_cost) {
      best = p;
      best_cost = cost;
    }
  }
  return best;
}

// Four consecutive bfloat16 values (8-byte aligned) as f32.
__device__ __forceinline__ float4 load4_bf16(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// 4 floats (16 bytes) from global to shared memory: cp.async for f32, a load
// and a conversion for bfloat16.
__device__ __forceinline__ void stage4(float* dst, const float* src) { cp_async16(dst, src); }
__device__ __forceinline__ void stage4(float* dst, const __nv_bfloat16* src) {
  store4(dst, load4_bf16(src));
}

// Stages the chunk's rows [0, rows) into sA for fwd_chunk: columns [0, D) the
// SCANN+ geometry from geo [rows, D], or columns [0, round4(K)) the distance
// RBF from geo [rows, K] with the pad columns zeroed (mma_gemm reads them);
// columns [D, 2D) the neighbours' states gathered from the structure's
// centers cen [M, D] in global memory. All copies of a thread are in flight
// at once (cp.async, past L1; bfloat16 is loaded and converted); a K that is
// not a multiple of 4 leaves the RBF rows unaligned, so they are loaded.
// Ends with a barrier.
template <typename T>
__device__ __forceinline__ void stage_chunk(const Args<T>& a, float* sA, const T* cen,
                                            const int* nbr, const T* geo, int rows) {
  const int tid = threadIdx.x, D = a.D, K = a.K, lda = 2 * D + 4, q4 = D / 4;
  if (a.g_update) {
    for (int i = tid; i < rows * q4; i += kThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      stage4(sA + r * lda + c, geo + (size_t)r * D + c);
    }
  } else if ((K & 3) == 0) {
    const int k4 = K / 4;
    for (int i = tid; i < rows * k4; i += kThreads) {
      const int r = i / k4, k = (i - r * k4) * 4;
      stage4(sA + r * lda + k, geo + (size_t)r * K + k);
    }
  } else {
    const int kp = round4(K);
    for (int i = tid; i < rows * kp; i += kThreads) {
      const int r = i / kp, k = i - r * kp;
      sA[r * lda + k] = k < K ? to_float(__ldg(geo + (size_t)r * K + k)) : 0.f;
    }
  }
  for (int i = tid; i < rows * q4; i += kThreads) {
    const int r = i / q4, c = (i - r * q4) * 4;
    stage4(sA + r * lda + D + c, cen + (size_t)__ldg(nbr + r) * D + c);
  }
  cp_async_wait_all();
  __syncthreads();
}

// stage_chunk for the wide build, without its wait: rows [0, rows) of one
// atom's sub-chunk into sA, the neighbours' indices read from idx (the index
// ring in shared memory, filled an atom ahead). f32 rows go by cp.async and
// land while the caller works (it waits with cp_async_wait_all and a
// barrier); bfloat16 rows, and an RBF whose K is not a multiple of 4, are
// loaded, converted and stored here, four loads of a thread in flight. The
// staged values are stage_chunk's; the copy keeps the narrow build's code as
// it was.
template <typename T>
__device__ __forceinline__ void stage_wide(const Args<T>& a, float* sA, const T* cen,
                                           const int* idx, const T* geo, int rows) {
  const int tid = threadIdx.x, D = a.D, K = a.K, lda = 2 * D + 4, q4 = D / 4;
  if (a.g_update) {
#pragma unroll 4
    for (int i = tid; i < rows * q4; i += kThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      stage4(sA + r * lda + c, geo + (size_t)r * D + c);
    }
  } else if ((K & 3) == 0) {
    const int k4 = K / 4;
#pragma unroll 4
    for (int i = tid; i < rows * k4; i += kThreads) {
      const int r = i / k4, k = (i - r * k4) * 4;
      stage4(sA + r * lda + k, geo + (size_t)r * K + k);
    }
  } else {
    const int kp = round4(K);
    for (int i = tid; i < rows * kp; i += kThreads) {
      const int r = i / kp, k = i - r * kp;
      sA[r * lda + k] = k < K ? to_float(__ldg(geo + (size_t)r * K + k)) : 0.f;
    }
  }
#pragma unroll 4
  for (int i = tid; i < rows * q4; i += kThreads) {
    const int r = i / q4, c = (i - r * q4) * 4;
    stage4(sA + r * lda + D + c, cen + (size_t)idx[r] * D + c);
  }
}

// The wide build's block (N > kFwdMaxChunkRows): ab atoms of one structure on
// wide_block_plan's layout, one atom at a time through fwd_atom_wide_keys.
// wide_keys [blocks, N, D] (f32) is the key scratch where the keys are not in
// shared memory, else null. The block's sub-chunks j = 0, 1, ... (atom ab0 +
// j / S, rows from 64 (j % S), S sub-chunks an atom) are staged in order:
// sub-chunk 0 while the block forms its queries; with two buffers (f32),
// sub-chunk j + 1 into the other one once sub-chunk j has landed, so that it
// arrives while j runs; with one, sub-chunk j when its turn comes.
template <typename T>
__device__ __forceinline__ void wide_block(const Args<T>& a, float* wide_keys) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = a.N, D = a.D, H = a.H, M = a.M, AB = a.atom_block;
  const int lds = D + 4, q4 = D / 4, G = a.g_update ? D : a.K, tid = threadIdx.x;
  const WidePlan P = wide_block_plan(AB, N, D, H, a.g_update, sizeof(T) != sizeof(float));
  float* sQ = smem;                                    // query, then out   [AB, D + 4]
  float* sW = sQ + AB * lds;                           // cw (SCANN+)       [AB, D + 4]
  float* work = sW + (a.g_update ? AB * lds : 0);
  float* sU = work;                      // centers, then the sub-chunk product [64, D + 4]
  float* sE = sU + kFwdMaxChunkRows * lds;             // the atom's energies [N, H]
  float* const buf0 = work + P.offA;                   // operand buffers [64, 2D + 4]
  float* const buf1 = work + P.offA1;
  auto buf = [&](int j) { return (j & 1) ? buf1 : buf0; };
  int* ring = reinterpret_cast<int*>(work + P.offI);   // neighbour indices [2][N]
  float* keys = P.smem_keys ? work + P.offK : wide_keys + (size_t)blockIdx.x * N * D;
  const int blocks_per_structure = (M + AB - 1) / AB;
  const int b = blockIdx.x / blocks_per_structure;
  const int ab0 = (blockIdx.x - b * blocks_per_structure) * AB, ab = min(AB, M - ab0);
  const ChunkDims cd = {N, D, H, a.K, a.g_update, 0, a.dk};

  const T* centers_b = a.centers + (size_t)b * M * D;
  const int* nbr = a.nbr + (size_t)b * M * N;
  const T* geometry = a.geometry + (size_t)b * M * N * G;
  const T* nmask = a.nmask + (size_t)b * M * N;
  const T* nweight = a.nweight + (size_t)b * M * N;
  T* geo_out = a.geo_out + (size_t)b * M * N * D;
  T* attn = a.attn + (size_t)b * M * N * H;

  // atom m's neighbour indices into its slot of the ring, as copies in flight
  auto fetch_ring = [&](int m) {
    if (m < ab0 + ab)
      for (int i = tid; i < N; i += kThreads)
        cp_async4(reinterpret_cast<float*>(ring + ((m - ab0) & 1) * N + i),
                  nbr + (size_t)m * N + i);
  };
  const int S = (N + kFwdMaxChunkRows - 1) / kFwdMaxChunkRows;
  auto issue = [&](int j) {   // sub-chunk j into buffer j & 1
    if (j >= ab * S) return;
    const int at = j / S, n0 = (j - at * S) * kFwdMaxChunkRows;
    stage_wide(a, buf(j), centers_b, ring + (at & 1) * N + n0,
               geometry + ((size_t)(ab0 + at) * N + n0) * G, min(kFwdMaxChunkRows, N - n0));
  };
  int next = 0;   // the sub-chunk the walk takes next
  auto stage = [&](int, int) {
    const int j = next++;
    if (P.buffers == 1 && j > 0) issue(j);
    cp_async_wait_all();
    __syncthreads();
    if (P.buffers == 2) issue(j + 1);
    return buf(j);
  };

  // the block's centers and the first atom's indices, then sub-chunk 0 in
  // flight while the block forms cw = centers @ Wfg[0:D] (SCANN+) and the query
  fetch_ring(ab0);
  for (int i = tid; i < ab * q4; i += kThreads) {
    const int m = i / q4, c = (i - m * q4) * 4;
    stage4(sU + m * lds + c, centers_b + (size_t)(ab0 + m) * D + c);
  }
  cp_async_wait_all();
  __syncthreads();
  issue(0);
  if (a.g_update)
    mma_gemm(sU, lds, ab, D, a.w.wfg, D, D,
             [&](int r, int c, float4 v) { store4(sW + r * lds + c, v); });
  mma_gemm(sU, lds, ab, D, a.wq, D, D, [&](int r, int c, float4 v) {
    const T* bq = a.bq + c;
    store4(sQ + r * lds + c, make_float4(v.x + to_float(bq[0]), v.y + to_float(bq[1]),
                                         v.z + to_float(bq[2]), v.w + to_float(bq[3])));
  });
  __syncthreads();

  for (int m = ab0; m < ab0 + ab; ++m) {
    const size_t base = (size_t)m * N;
    fetch_ring(m + 1);   // waited for with this atom's first sub-chunk
    fwd_atom_wide_keys<false>(cd, a.w, stage, sU, sE, sW + (m - ab0) * lds, sQ + (m - ab0) * lds,
                              nmask + base, nweight + base,
                              a.g_update ? geo_out + base * D : nullptr, attn + base * H, keys, D,
                              P.smem_keys != 0, [](int, int) { return 1.0f; });
  }

  for (int i = tid; i < ab * q4; i += kThreads) {
    const int m = i / q4, c = (i - m * q4) * 4;
    T* o = a.out + ((size_t)b * M + ab0 + m) * D + c;
    const float* v = sQ + m * lds + c;
    if constexpr (sizeof(T) == sizeof(float)) {
      store4(reinterpret_cast<float*>(o), *reinterpret_cast<const float4*>(v));
    } else {
      __nv_bfloat162 q[2] = {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
      *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(q);
    }
  }
}

#ifdef SCANN_WIDTH_256
// 8 bytes from global to shared memory (cp.async, through L1)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

// The builds past 128 columns on bfloat16 tensors: a chunk's rows [0, rows)
// as they are, into the raw area [rows, 2D] (the geometry's G columns at 0,
// a multiple of 4, the neighbours' states at D), by cp.async, without a
// wait. The neighbours' indices from nbr in global memory, or (kRing, the
// wide build) from the index ring in shared memory.
template <bool kRing = false>
__device__ __forceinline__ void stage_raw(const Args<__nv_bfloat16>& a, __nv_bfloat16* raw,
                                          const __nv_bfloat16* cen, const int* nbr,
                                          const __nv_bfloat16* geo, int rows) {
  const int tid = threadIdx.x, D = a.D, G = a.g_update ? D : a.K, g4 = G / 4, q4 = D / 4;
  for (int i = tid; i < rows * g4; i += kThreads) {
    const int r = i / g4, c = (i - r * g4) * 4;
    cp_async8(raw + r * 2 * D + c, geo + (size_t)r * G + c);
  }
  for (int i = tid; i < rows * q4; i += kThreads) {
    const int r = i / q4, c = (i - r * q4) * 4;
    const int n = kRing ? nbr[r] : __ldg(nbr + r);
    cp_async8(raw + r * 2 * D + D + c, cen + (size_t)n * D + c);
  }
}

// The raw area's rows as f32 into the operand buffer sA, as stage_chunk
// converts them. The caller synchronises before and after.
__device__ __forceinline__ void convert_raw(const Args<__nv_bfloat16>& a,
                                            const __nv_bfloat16* raw, float* sA, int rows) {
  const int tid = threadIdx.x, D = a.D, G = a.g_update ? D : a.K, g4 = G / 4, q4 = D / 4;
  const int n = g4 + q4, lda = 2 * D + 4;
  for (int i = tid; i < rows * n; i += kThreads) {
    const int r = i / n, q = i - r * n, c = q < g4 ? 4 * q : D + 4 * (q - g4);
    const uint2 u = *reinterpret_cast<const uint2*>(raw + r * 2 * D + c);
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    store4(sA + r * lda + c, make_float4(x.x, x.y, y.x, y.y));
  }
}

// The narrow build's block past 128 columns (local_attention_d256.cu), on
// d256_plan_for's layout: the block's centers staged into the front, chunk 0
// in flight while the block forms cw (SCANN+) and the queries, then chunk j
// runs in buffer j & 1 while chunk j + 1 is staged into the other (f32 rows
// by cp.async straight into it; bfloat16 rows into the raw area, converted
// once chunk j is done; in the open where the plan has one buffer or an RBF
// of K not a multiple of 4 is staged from bfloat16). Every product is
// mma_gemm_w32 on the packed TF32 planes a.planes, so the outputs are those
// of the builds up to 128 columns bit for bit.
template <typename T>
__device__ __forceinline__ void d256_block(const Args<T>& a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr bool kRaw = sizeof(T) != sizeof(float);
  const int N = a.N, D = a.D, H = a.H, M = a.M, AB = a.atom_block, CA = a.chunk_atoms;
  const int lds = D + 4, q4 = D / 4, G = a.g_update ? D : a.K, tid = threadIdx.x;
  const D256Plan P = d256_plan_for(AB, N, D, H, a.g_update, kRaw);
  float* sQ = smem;                                    // query, then out   [AB, D + 4]
  float* sW = sQ + AB * lds;                           // cw (SCANN+)       [AB, D + 4]
  float* work = sW + (a.g_update ? AB * lds : 0);
  float* sU = work;                     // the centers, then the chunk product [rows, D + 4]
  float* sE = sU + CA * N * lds;                       // attention         [rows, H]
  float* const buf0 = work + P.offA;                   // operand buffers   [rows, 2D + 4]
  float* const buf1 = work + P.offA1;
  auto buf = [&](int j) { return (j & 1) ? buf1 : buf0; };
  const int blocks_per_structure = (M + AB - 1) / AB;
  const int b = blockIdx.x / blocks_per_structure;
  const int ab0 = (blockIdx.x - b * blocks_per_structure) * AB, ab = min(AB, M - ab0);
  const ChunkDims cd = {N, D, H, a.K, a.g_update, 0, a.dk};
  const RowPlanes pl = row_planes(a.planes, D, a.K, a.g_update);

  const T* centers_b = a.centers + (size_t)b * M * D;
  const int* nbr = a.nbr + (size_t)b * M * N;
  const T* geometry = a.geometry + (size_t)b * M * N * G;
  const T* nmask = a.nmask + (size_t)b * M * N;
  const T* nweight = a.nweight + (size_t)b * M * N;
  T* geo_out = a.geo_out + (size_t)b * M * N * D;
  T* attn = a.attn + (size_t)b * M * N * H;

  const int chunks = (ab + CA - 1) / CA;
  const bool in_open = P.buffers == 1 || (kRaw && !a.g_update && (a.K & 3));
  auto rows_of = [&](int j) { return min(CA, ab0 + ab - (ab0 + j * CA)) * N; };
  auto base_of = [&](int j) { return (size_t)(ab0 + j * CA) * N; };
  auto issue = [&](int j) {   // chunk j on its way, unless it is staged in the open
    if (in_open || j >= chunks) return;
    const size_t base = base_of(j);
    if constexpr (kRaw)
      stage_raw(a, reinterpret_cast<__nv_bfloat16*>(work + P.offR), centers_b, nbr + base,
                geometry + base * G, rows_of(j));
    else
      stage_wide(a, buf(j), centers_b, nbr + base, geometry + base * G, rows_of(j));
  };
  auto land = [&](int j) {    // chunk j in buffer j & 1, after a barrier
    const size_t base = base_of(j);
    if (in_open) {
      stage_chunk(a, buf(j), centers_b, nbr + base, geometry + base * G, rows_of(j));
      return;
    }
    cp_async_wait_all();
    __syncthreads();
    if constexpr (kRaw) {
      convert_raw(a, reinterpret_cast<const __nv_bfloat16*>(work + P.offR), buf(j), rows_of(j));
      __syncthreads();
    }
  };

  // the block's centers, then chunk 0 in flight while the block forms cw =
  // centers @ Wfg[0:D] (SCANN+) and the query
  for (int i = tid; i < ab * q4; i += kThreads) {
    const int m = i / q4, c = (i - m * q4) * 4;
    stage4(sU + m * lds + c, centers_b + (size_t)(ab0 + m) * D + c);
  }
  cp_async_wait_all();
  __syncthreads();
  issue(0);
  if (a.g_update)
    mma_gemm_w32<false>(sU, lds, ab, D, pl.cw, D,
                        [&](int r, int c, float4 v) { store4(sW + r * lds + c, v); });
  mma_gemm_w32<false>(sU, lds, ab, D, pl.q, D, [&](int r, int c, float4 v) {
    const T* bq = a.bq + c;
    store4(sQ + r * lds + c, make_float4(v.x + to_float(bq[0]), v.y + to_float(bq[1]),
                                         v.z + to_float(bq[2]), v.w + to_float(bq[3])));
  });
  land(0);

  for (int j = 0; j < chunks; ++j) {
    const int m0 = ab0 + j * CA, ca = min(CA, ab0 + ab - m0);
    const size_t base = base_of(j);
    issue(j + 1);
    fwd_chunk_w32(cd, a.w, ca, buf(j), sU, sE, sW + (m0 - ab0) * lds, sQ + (m0 - ab0) * lds, lds,
                  nmask + base, nweight + base, a.g_update ? geo_out + base * D : nullptr,
                  attn + base * H, [](int, int, int) { return 1.0f; }, pl);
    if (j + 1 < chunks) land(j + 1);
  }

  for (int i = tid; i < ab * q4; i += kThreads) {
    const int m = i / q4, c = (i - m * q4) * 4;
    T* o = a.out + ((size_t)b * M + ab0 + m) * D + c;
    const float* v = sQ + m * lds + c;
    if constexpr (sizeof(T) == sizeof(float)) {
      store4(reinterpret_cast<float*>(o), *reinterpret_cast<const float4*>(v));
    } else {
      __nv_bfloat162 q[2] = {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
      *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(q);
    }
  }
}

// The wide build past 128 columns (local_attention_wide_d256.cu): each
// atom's rows in sub-chunks of kFwdWideW32Rows (the atom walk's; 32, as
// kD256ChunkRows) in two operand buffers [32, 2D + 4], the next sub-chunk,
// or the next atom's first, staged while this one runs (f32 rows by
// cp.async straight into the free buffer; bfloat16 rows into a raw area
// [32, 2D] of bfloat16, converted once this one is done). Shared memory, in
// floats: the queries and cw [AB, D + 4] as in Plan, then the work region:
// the front (the block's centers [AB, D + 4] for the head, then a
// sub-chunk's product [32, D + 4] and the atom's energies [N, H]), the
// buffers (offA, offA1), the raw area (offR, bfloat16 only), the index ring
// [2][N] (offI; round4(2N) floats) and, with smem_keys, the atom's keys [N,
// D] (offK). Two buffers of 32 rows take the floats of WidePlan's one of 64
// and its front 32 x (D + 4) fewer, more than the raw area, so this plan
// fits wherever WidePlan's one-buffer layouts fit. The weights' TF32 planes
// replace the L1 the builds up to 128 columns left for the bf16 weights, so
// the f32 and bfloat16 plans are one layout, the raw area aside.
struct WideD256Plan {
  int atom_block, smem_keys, offA, offA1, offR, offI, offK, total;
};

__host__ __device__ inline WideD256Plan wide_d256_plan_for(int AB, int N, int D, int H,
                                                           int g_update, int bf16,
                                                           int smem_keys) {
  WideD256Plan p;
  p.atom_block = AB;
  p.smem_keys = smem_keys;
  const int rows = kFwdWideW32Rows, buf = rows * (2 * D + 4);
  const int front = rows * (D + 4) + round4(N * H), centers = AB * (D + 4);
  p.offA = front > centers ? front : centers;
  p.offA1 = p.offA + buf;
  p.offR = p.offA1 + buf;
  p.offI = p.offR + (bf16 ? rows * D : 0);
  p.offK = p.offI + round4(2 * N);
  p.total = (g_update ? 2 : 1) * AB * (D + 4) + p.offK + (smem_keys ? N * D : 0);
  return p;
}

// The layout of a wide block of AB atoms past 128 columns: the keys in
// shared memory where they fit, else in L2; atom_block 0 if nothing fits.
__host__ __device__ inline WideD256Plan wide_d256_block_plan(int AB, int N, int D, int H,
                                                             int g_update, int bf16) {
  for (int keys = 1; keys >= 0; --keys) {
    const WideD256Plan q = wide_d256_plan_for(AB, N, D, H, g_update, bf16, keys);
    if (q.total * (int)sizeof(float) <= kMaxSharedBytes) return q;
  }
  return WideD256Plan{0, 0, 0, 0, 0, 0, 0, 0};
}

// make_wide_plan past 128 columns: the same atom blocks and cost, each with
// wide_d256_block_plan's layout.
inline WideD256Plan make_wide_d256_plan(int B, int M, int N, int D, int H, int g_update,
                                        int bf16, int n_sm) {
  WideD256Plan best = {0, 0, 0, 0, 0, 0, 0, 0};
  long long best_cost = -1;
  for (int AB : kWideAtomBlocks) {
    const WideD256Plan p = wide_d256_block_plan(AB, N, D, H, g_update, bf16);
    if (p.atom_block == 0) continue;
    const long long blocks = (long long)B * ((M + AB - 1) / AB);
    const long long cost = (blocks + n_sm - 1) / n_sm * (kWideAtomCost * AB + kWideHeadCost);
    if (best_cost < 0 || cost <= best_cost) {
      best = p;
      best_cost = cost;
    }
  }
  return best;
}

// The wide build's block past 128 columns, on wide_d256_block_plan's layout:
// ab atoms one at a time through fwd_atom_wide_keys in the 32-column layout
// (its sub-chunks of 32 rows, every product mma_gemm_w32 on the packed TF32
// planes a.planes, the head's too), so the outputs are those of the builds
// up to 128 columns bit for bit. The block's sub-chunks j = 0, 1, ... (atom
// ab0 + j / S, rows from 32 (j % S), S sub-chunks an atom) run in buffer j &
// 1: sub-chunk 0 is staged while the block forms its queries, sub-chunk j + 1
// once sub-chunk j has landed, so that it arrives while j runs (in_open:
// sub-chunk j when its turn comes).
template <typename T>
__device__ __forceinline__ void wide_d256_block(const Args<T>& a, float* wide_keys) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr bool kRaw = sizeof(T) != sizeof(float);
  constexpr int R = kFwdWideW32Rows;
  const int N = a.N, D = a.D, H = a.H, M = a.M, AB = a.atom_block;
  const int lds = D + 4, q4 = D / 4, G = a.g_update ? D : a.K, tid = threadIdx.x;
  const WideD256Plan P = wide_d256_block_plan(AB, N, D, H, a.g_update, kRaw);
  float* sQ = smem;                                    // query, then out   [AB, D + 4]
  float* sW = sQ + AB * lds;                           // cw (SCANN+)       [AB, D + 4]
  float* work = sW + (a.g_update ? AB * lds : 0);
  float* sU = work;                      // centers, then the sub-chunk product [32, D + 4]
  float* sE = sU + R * lds;                            // the atom's energies [N, H]
  float* const buf0 = work + P.offA;                   // operand buffers [32, 2D + 4]
  float* const buf1 = work + P.offA1;
  auto buf = [&](int j) { return (j & 1) ? buf1 : buf0; };
  int* ring = reinterpret_cast<int*>(work + P.offI);   // neighbour indices [2][N]
  float* keys = P.smem_keys ? work + P.offK : wide_keys + (size_t)blockIdx.x * N * D;
  const int blocks_per_structure = (M + AB - 1) / AB;
  const int b = blockIdx.x / blocks_per_structure;
  const int ab0 = (blockIdx.x - b * blocks_per_structure) * AB, ab = min(AB, M - ab0);
  const ChunkDims cd = {N, D, H, a.K, a.g_update, 0, a.dk};
  const RowPlanes pl = row_planes(a.planes, D, a.K, a.g_update);

  const T* centers_b = a.centers + (size_t)b * M * D;
  const int* nbr = a.nbr + (size_t)b * M * N;
  const T* geometry = a.geometry + (size_t)b * M * N * G;
  const T* nmask = a.nmask + (size_t)b * M * N;
  const T* nweight = a.nweight + (size_t)b * M * N;
  T* geo_out = a.geo_out + (size_t)b * M * N * D;
  T* attn = a.attn + (size_t)b * M * N * H;

  // atom m's neighbour indices into its slot of the ring, as copies in flight
  auto fetch_ring = [&](int m) {
    if (m < ab0 + ab)
      for (int i = tid; i < N; i += kThreads)
        cp_async4(reinterpret_cast<float*>(ring + ((m - ab0) & 1) * N + i),
                  nbr + (size_t)m * N + i);
  };
  const int S = (N + R - 1) / R;
  // bfloat16 rows of an RBF whose K is not a multiple of 4 are staged in the
  // open (stage_raw copies 4 values at a time)
  const bool in_open = kRaw && !a.g_update && (a.K & 3);
  auto idx_of = [&](int j) { return ring + ((j / S) & 1) * N + (j % S) * R; };
  auto geo_of = [&](int j) { return geometry + ((size_t)(ab0 + j / S) * N + (j % S) * R) * G; };
  auto rows_of = [&](int j) { return min(R, N - (j % S) * R); };
  auto issue = [&](int j) {   // sub-chunk j on its way, unless it is staged in the open
    if (in_open || j >= ab * S) return;
    if constexpr (kRaw)
      stage_raw<true>(a, reinterpret_cast<__nv_bfloat16*>(work + P.offR), centers_b, idx_of(j),
                      geo_of(j), rows_of(j));
    else
      stage_wide(a, buf(j), centers_b, idx_of(j), geo_of(j), rows_of(j));
  };
  auto land = [&](int j) {    // sub-chunk j in buffer j & 1, after a barrier
    if (in_open) stage_wide(a, buf(j), centers_b, idx_of(j), geo_of(j), rows_of(j));
    cp_async_wait_all();
    __syncthreads();
    if constexpr (kRaw) {
      if (!in_open) {
        convert_raw(a, reinterpret_cast<const __nv_bfloat16*>(work + P.offR), buf(j), rows_of(j));
        __syncthreads();
      }
    }
  };
  // sub-chunk j for the walk, sub-chunk j + 1 on its way; with an atom's
  // first sub-chunk the next atom's indices, which the next land waits for
  // (S >= 2: N > R, at D <= 256 N > 64 and past 256 N > 16), before any
  // staging reads them
  int next = 0;   // the sub-chunk the walk takes next
  auto stage = [&](int, int) {
    const int j = next++;
    land(j);
    issue(j + 1);
    if (j % S == 0) fetch_ring(ab0 + j / S + 1);
    return buf(j);
  };

  // the block's centers and the first atom's indices, then sub-chunk 0 in
  // flight while the block forms cw = centers @ Wfg[0:D] (SCANN+) and the query
  fetch_ring(ab0);
  for (int i = tid; i < ab * q4; i += kThreads) {
    const int m = i / q4, c = (i - m * q4) * 4;
    stage4(sU + m * lds + c, centers_b + (size_t)(ab0 + m) * D + c);
  }
  cp_async_wait_all();
  __syncthreads();
  issue(0);
  if (a.g_update)
    mma_gemm_w32<false>(sU, lds, ab, D, pl.cw, D,
                        [&](int r, int c, float4 v) { store4(sW + r * lds + c, v); });
  mma_gemm_w32<false>(sU, lds, ab, D, pl.q, D, [&](int r, int c, float4 v) {
    const T* bq = a.bq + c;
    store4(sQ + r * lds + c, make_float4(v.x + to_float(bq[0]), v.y + to_float(bq[1]),
                                         v.z + to_float(bq[2]), v.w + to_float(bq[3])));
  });
  __syncthreads();

  for (int m = ab0; m < ab0 + ab; ++m) {
    const size_t base = (size_t)m * N;
    fwd_atom_wide_keys<false, true>(cd, a.w, stage, sU, sE, sW + (m - ab0) * lds,
                                    sQ + (m - ab0) * lds, nmask + base, nweight + base,
                                    a.g_update ? geo_out + base * D : nullptr, attn + base * H,
                                    keys, D, P.smem_keys != 0, [](int, int) { return 1.0f; }, pl);
  }

  for (int i = tid; i < ab * q4; i += kThreads) {
    const int m = i / q4, c = (i - m * q4) * 4;
    T* o = a.out + ((size_t)b * M + ab0 + m) * D + c;
    const float* v = sQ + m * lds + c;
    if constexpr (sizeof(T) == sizeof(float)) {
      store4(reinterpret_cast<float*>(o), *reinterpret_cast<const float4*>(v));
    } else {
      __nv_bfloat162 q[2] = {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
      *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(q);
    }
  }
}
#endif  // SCANN_WIDTH_256

// one block per SM (its shared memory takes most of the SM), so the compiler
// may spend up to 255 registers a thread. kWide: N > kFwdMaxChunkRows, the
// wide build (local_attention_wide.cu), wide_block.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
local_attention_kernel(const Args<T> a, float* wide_keys) {
  if constexpr (kWide) {
#ifdef SCANN_WIDTH_256
    wide_d256_block(a, wide_keys);   // the wide build past 128 columns
#else
    wide_block(a, wide_keys);
#endif
  } else if constexpr (kLaneValues > 4) {   // the narrow build past 128 columns
#ifdef SCANN_WIDTH_256
    d256_block(a);
#endif
  } else {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int N = a.N, D = a.D, H = a.H, M = a.M, AB = a.atom_block, CA = a.chunk_atoms;
    const int lds = D + 4, rows_max = CA * N, q4 = D / 4;
    float* sQ = smem;                                    // query, then out   [AB, D + 4]
    float* sW = sQ + AB * lds;                           // cw (SCANN+)       [AB, D + 4]
    float* work = sW + (a.g_update ? AB * lds : 0);      // centers, then:
    float* sA = work;                                    // chunk operand     [rows, 2D + 4]
    float* sU = sA + rows_max * (2 * D + 4);             // chunk product     [rows, D + 4]
    float* sE = sU + rows_max * (D + 4);                 // attention         [rows, H]
    const int tid = threadIdx.x;
    const int blocks_per_structure = (M + AB - 1) / AB;
    const int b = blockIdx.x / blocks_per_structure;
    const int ab0 = (blockIdx.x - b * blocks_per_structure) * AB, ab = min(AB, M - ab0);
    const ChunkDims cd = {N, D, H, a.K, a.g_update, 0, a.dk};

    const T* centers_b = a.centers + (size_t)b * M * D;
    const int* nbr = a.nbr + (size_t)b * M * N;
    const T* geometry = a.geometry + (size_t)b * M * N * (a.g_update ? D : a.K);
    const T* nmask = a.nmask + (size_t)b * M * N;
    const T* nweight = a.nweight + (size_t)b * M * N;
    T* geo_out = a.geo_out + (size_t)b * M * N * D;
    T* attn = a.attn + (size_t)b * M * N * H;

    // the block's centers, then cw = centers @ Wfg[0:D] (SCANN+) and the query
    for (int i = tid; i < ab * q4; i += kThreads) {
      const int m = i / q4, c = (i - m * q4) * 4;
      stage4(work + m * lds + c, centers_b + (size_t)(ab0 + m) * D + c);
    }
    cp_async_wait_all();
    __syncthreads();
    if (a.g_update)
      mma_gemm(work, lds, ab, D, a.w.wfg, D, D,
               [&](int r, int c, float4 v) { store4(sW + r * lds + c, v); });
    mma_gemm(work, lds, ab, D, a.wq, D, D, [&](int r, int c, float4 v) {
      const T* bq = a.bq + c;
      store4(sQ + r * lds + c, make_float4(v.x + to_float(bq[0]), v.y + to_float(bq[1]),
                                           v.z + to_float(bq[2]), v.w + to_float(bq[3])));
    });
    __syncthreads();

    for (int m0 = ab0; m0 < ab0 + ab; m0 += CA) {
      const int ca = min(CA, ab0 + ab - m0), base = m0 * N;
      stage_chunk(a, sA, centers_b, nbr + base,
                  geometry + (size_t)base * (a.g_update ? D : a.K), ca * N);
      fwd_chunk(cd, a.w, ca, sA, sU, sE, sW + (m0 - ab0) * lds, sQ + (m0 - ab0) * lds, lds,
                nmask + base, nweight + base, a.g_update ? geo_out + (size_t)base * D : nullptr,
                attn + (size_t)base * H, [](int, int, int) { return 1.0f; });
    }

    for (int i = tid; i < ab * q4; i += kThreads) {
      const int m = i / q4, c = (i - m * q4) * 4;
      T* o = a.out + ((size_t)b * M + ab0 + m) * D + c;
      const float* v = sQ + m * lds + c;
      if constexpr (sizeof(T) == sizeof(float)) {
        store4(reinterpret_cast<float*>(o), *reinterpret_cast<const float4*>(v));
      } else {
        __nv_bfloat162 q[2] = {__floats2bfloat162_rn(v[0], v[1]),
                               __floats2bfloat162_rn(v[2], v[3])};
        *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(q);
      }
    }
  }
}

template <typename T, bool kWide>
int launch(void* const* ptrs, const int* dims, const float* scalars, cudaStream_t stream) {
  Args<T> a;
  int i = 0;
  a.centers = (const T*)ptrs[i++];
  a.nbr = (const int*)ptrs[i++];
  a.geometry = (const T*)ptrs[i++];
  a.nmask = (const T*)ptrs[i++];
  a.nweight = (const T*)ptrs[i++];
  a.w.wfg = (const T*)ptrs[i++];
  a.w.bfg = (const T*)ptrs[i++];
  a.w.wk = (const T*)ptrs[i++];
  a.w.bk = (const T*)ptrs[i++];
  a.wq = (const T*)ptrs[i++];
  a.bq = (const T*)ptrs[i++];
  a.w.ln_s = (const T*)ptrs[i++];
  a.w.ln_b = (const T*)ptrs[i++];
  a.w.lng_s = (const T*)ptrs[i++];
  a.w.lng_b = (const T*)ptrs[i++];
  a.out = (T*)ptrs[i++];
  a.geo_out = (T*)ptrs[i++];
  a.attn = (T*)ptrs[i++];
  float* wide_keys = (float*)ptrs[i++];
  // only the builds past 128 columns take pointer 19, their planes
  constexpr bool kNarrowD256 = !kWide && kLaneValues > 4;
  a.planes = kLaneValues > 4 ? (const float*)ptrs[i++] : nullptr;
  a.B = dims[0]; a.M = dims[1]; a.N = dims[2]; a.D = dims[3]; a.H = dims[4]; a.K = dims[5];
  a.g_update = dims[6];
  const int n_sm = dims[7];
  a.atom_block = dims[8]; a.chunk_atoms = dims[9];
  a.dk = scalars[0];

  // the narrow build takes N <= kNarrowMaxN, the wide one the rest
  if (a.B < 1 || a.M < 1 || a.N < 1 || (a.N > kNarrowMaxN) != kWide ||
      a.N > kWideMaxN || (!kWide && wide_keys != nullptr) || a.D < 4 || a.D > kMaxWidth ||
      (a.D & 3) || a.H < 1 || a.D % a.H || a.K < 1 || a.K > a.D || n_sm < 1)
    return kErrShape;
  int bytes;
  if constexpr (kWide) {
#ifdef SCANN_WIDTH_256
    const WideD256Plan plan = make_wide_d256_plan(a.B, a.M, a.N, a.D, a.H, a.g_update,
                                                  sizeof(T) != sizeof(float), n_sm);
    if (a.planes == nullptr) return kErrShape;
#else
    const WidePlan plan = make_wide_plan(a.B, a.M, a.N, a.D, a.H, a.g_update,
                                                sizeof(T) != sizeof(float), n_sm);
#endif
    if (plan.atom_block == 0) return kErrSharedMemory;
    bytes = plan.total * (int)sizeof(float);
    // the wrapper's plan is this one, with a key scratch where the keys are
    // not in shared memory
    if (a.atom_block != plan.atom_block || a.chunk_atoms != 1 || dims[10] != bytes ||
        (wide_keys == nullptr) != (plan.smem_keys != 0))
      return kErrShape;
  } else if constexpr (kNarrowD256) {
    const D256Plan plan = make_d256_plan(a.B, a.M, a.N, a.D, a.H, a.g_update,
                                         sizeof(T) != sizeof(float), n_sm);
    if (plan.atom_block == 0) return kErrSharedMemory;
    bytes = plan.total * (int)sizeof(float);
    // the wrapper's plan is this one, with the weights' TF32 planes
    if (a.atom_block != plan.atom_block || a.chunk_atoms != plan.chunk_atoms ||
        dims[10] != bytes || a.planes == nullptr)
      return kErrShape;
  } else {
    const Plan plan = make_plan(a.B, a.M, a.N, a.D, a.H, a.g_update, n_sm);
    if (plan.atom_block == 0) return kErrSharedMemory;
    bytes = plan.total * (int)sizeof(float);
    // the wrapper's plan is this one
    if (a.atom_block != plan.atom_block || a.chunk_atoms != plan.chunk_atoms || dims[10] != bytes)
      return kErrShape;
  }
  const long long blocks = (long long)a.B * ((a.M + a.atom_block - 1) / a.atom_block);
  if (blocks > 0x7fffffffLL) return kErrShape;
  cudaError_t err = cudaFuncSetAttribute(local_attention_kernel<T, kWide>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  local_attention_kernel<T, kWide><<<(unsigned)blocks, kThreads, bytes, stream>>>(a, wide_keys);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: centers, neighbours, geometry, mask, weight, Wfg, bfg, Wk, bk, Wq,
// bq, ln scale, ln bias, ln_g scale, ln_g bias, out, geo_out, attn, the wide
// key scratch [blocks, N, D] (f32; null in the narrow build, and in the wide
// one where its plan keeps the keys in shared memory), in the builds past
// 128 columns the packed TF32 planes of Wfg, Wk and Wq (f32,
// layer_plane_floats; no other build takes a pointer 19) (every other
// float tensor f32 for local_attention_launch, bfloat16 for
// local_attention_bf16_launch);
// dims: B, M, N, D, H, K, g_update, the card's SM count, and the wrapper's
// plan: atom block, atoms per chunk (1 in the wide build), shared bytes per
// block; scalars: dk.
// The order must match scann_tpu_torch/kernels/local_attention.py. This
// file builds the narrow kernels (N <= kFwdMaxChunkRows);
// local_attention_wide.cu includes it with SCANN_LOCAL_ATTENTION_WIDE defined
// and builds the wide ones (local_attention_wide_launch,
// local_attention_wide_bf16_launch), at the first wide launch.
// local_attention_d256.cu and local_attention_wide_d256.cu add
// SCANN_WIDTH_256: the builds of widths up to 256 (local_attention_d256_*,
// local_attention_wide_d256_*), at the first launch of a wider model;
// local_attention_d512.cu and local_attention_wide_d512.cu SCANN_WIDTH_512
// too: those of widths up to 512 (local_attention_d512_*,
// local_attention_wide_d512_*; the narrow one N <= 16), with the same
// pointers and sizes.
#if defined(SCANN_WIDTH_512) && defined(SCANN_LOCAL_ATTENTION_WIDE)
#define SCANN_LA_F32(x) local_attention_wide_d512_##x
#define SCANN_LA_BF16(x) local_attention_wide_d512_bf16_##x
constexpr bool kWideBuild = true;
#elif defined(SCANN_WIDTH_512)
#define SCANN_LA_F32(x) local_attention_d512_##x
#define SCANN_LA_BF16(x) local_attention_d512_bf16_##x
constexpr bool kWideBuild = false;
#elif defined(SCANN_WIDTH_256) && defined(SCANN_LOCAL_ATTENTION_WIDE)
#define SCANN_LA_F32(x) local_attention_wide_d256_##x
#define SCANN_LA_BF16(x) local_attention_wide_d256_bf16_##x
constexpr bool kWideBuild = true;
#elif defined(SCANN_WIDTH_256)
#define SCANN_LA_F32(x) local_attention_d256_##x
#define SCANN_LA_BF16(x) local_attention_d256_bf16_##x
constexpr bool kWideBuild = false;
#elif !defined(SCANN_LOCAL_ATTENTION_WIDE)
#define SCANN_LA_F32(x) local_attention_##x
#define SCANN_LA_BF16(x) local_attention_bf16_##x
constexpr bool kWideBuild = false;
#else
#define SCANN_LA_F32(x) local_attention_wide_##x
#define SCANN_LA_BF16(x) local_attention_wide_bf16_##x
constexpr bool kWideBuild = true;
#endif

extern "C" int SCANN_LA_F32(launch)(void* const* ptrs, const int* dims, const float* scalars,
                                   void* stream) {
  return launch<float, kWideBuild>(ptrs, dims, scalars, (cudaStream_t)stream);
}

extern "C" int SCANN_LA_BF16(launch)(void* const* ptrs, const int* dims, const float* scalars,
                                    void* stream) {
  return launch<__nv_bfloat16, kWideBuild>(ptrs, dims, scalars, (cudaStream_t)stream);
}

extern "C" const char* SCANN_LA_F32(error_string)(int code) {
  if (code == kErrSharedMemory) return "shared-memory plan exceeds 227 KB per block";
  if (code == kErrShape) return "shape outside what the kernel takes, or a plan not the kernel's";
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* SCANN_LA_BF16(error_string)(int code) {
  return SCANN_LA_F32(error_string)(code);
}
