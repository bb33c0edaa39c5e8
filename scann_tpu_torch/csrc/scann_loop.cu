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
// - A cluster of C blocks per structure. Each block owns a contiguous range
//   of the structure's atoms; what crosses blocks is the new centers of a
//   layer. The narrow build takes C = 1, 2 or 4, chosen by the wrapper from
//   the batch size (a batch of 64 fills 128 of the card's 132 SMs); each
//   block writes its atoms' rows to a global scratch [B, M, D], then a
//   cluster barrier, then every block reloads all M rows, then a second
//   barrier before the scratch is written again. The tall and wide builds
//   take C up to 16 (kMaxL2Cluster; past 8 a non-portable size the launch
//   opts into): the wrapper takes the largest C whose B clusters the card
//   runs at once, so a lone structure runs on 16 SMs, not 4.
// - Narrow build: only the current centers [M, max(D, G)] stay in shared
//   memory for the whole layer, because every atom's gather may read any row
//   of them. All other per-atom state (query, cw, the ResidualNorm hidden)
//   exists for one block of AB <= 32 atoms at a time, in two slots of stride
//   max(D, G) + 4. The plan is M * 512 bytes + 108 to 133 KB at D=128 (atom
//   blocks of 8 to 32): M <= 237 at N=32.
// - Within an atom block the (atom, neighbour) rows go through fwd_chunk
//   (scann_forward_common.cuh) in chunks of at most 64 rows: split-TF32
//   mma.sync products, the softmax one warp per (atom, head), the context
//   one thread per (atom, column); the SCANN+ geometry is streamed from and
//   to the global scratch.
// - Tall structures (N <= kFwdMaxChunkRows, M past that plan; the tall build,
//   scann_loop_tall.cu) and wide neighbour lists (64 < N <= 256; the wide
//   build, scann_loop_wide.cu), both operand modes: the centers live in
//   global memory (L2; l2_plan). A layer's input centers sit in one half of a
//   ping-pong scratch [2, B, M, D] (14 MB at B = 64, M = 428) and its new
//   centers go to the other half, so one cluster barrier a layer suffices:
//   no block writes the rows others still gather. The gather reads those
//   rows by bulk copies through L2 (another SM wrote them); the per-atom
//   projections and the readout stage a block's rows past L1 (__ldcg). The
//   bulk copies read in the async proxy what ordinary stores wrote in the
//   same launch (the centers, the SCANN+ geometry, SCANN's RBF table), so
//   every thread fences its global writes to the async proxy
//   (fence.proxy.async.global) before the cluster barrier that ends the
//   embedding and each layer: one fence a layer. Each
//   chunk's neighbour indices (and SCANN distances) are copied into a small
//   ring in shared memory one chunk (tall) or one atom (wide) ahead, so the
//   staging never waits on an index load. The tall build stages each chunk
//   into one of two operand buffers while the chunk before it runs in the
//   other (fwd_stage_chunk_bulk / _wait: one bulk copy a row, by the copy
//   engine, its completion on an mbarrier); its arithmetic and the order
//   of every sum are the narrow build's, so at a shape both take the
//   outputs are the same bits. Its plan does not grow with M but for the
//   readout's vectors: atom blocks of 32 for M into the thousands.
// - The wide build walks one atom at a time (fwd_atom_wide_keys), its rows
//   in sub-chunks of 64 (of 32 past 128 columns, below), its energies [N, H]
//   in shared memory for a softmax
//   over all N, its keys in shared memory [N, D] where the plan holds them
//   (N <= 200 at D = 128), else in a per-block global scratch [B * C, N,
//   D]; the context splits the N neighbours into two halves over the
//   block's 256 threads and adds the halves in order. Its plan does not
//   grow with M either.
// - Widths past 128 (D, G, O up to 256): scann_loop_tall_d256.cu and
//   scann_loop_wide_d256.cu build the tall and wide kernels with
//   SCANN_WIDTH_256 (8 values of a row a lane in the warp LayerNorms,
//   kLaneValues of scann_common.cuh); the wrapper halves the tall build's
//   chunks to 32 rows where 64 do not fit, and the wide build takes N >
//   kTallMaxN = 32 there. Their arithmetic is the builds' of widths up to
//   128 but for the wide context, one thread a column over all N. Both
//   (kW32) run their row products, their cw and query products and their
//   ResidualNorm in the 32-column layout (mma_gemm_w32 of scann_mma.cuh: a
//   warp owns 32 output columns, so a 256-column row is one pass and each
//   left operand value is split once), on packed TF32 planes of each layer's
//   Wfg, Wk, Wq, W1 and W2 split once by the wrapper (planes, kernel
//   argument 4; the bf16 mode reads their bfloat16 plane); the operands and
//   order of sums are mma_gemm's, so their outputs are the same bits. The
//   products are bound by instruction issue there (a phase split on an H100:
//   70% of the time, and 4 integer ops in place of each mma.sync made it
//   slower), and the layout issues fewer of them per mma. The wide one
//   walks each atom in sub-chunks of 32 rows (kWideRows) in two operand
//   buffers, the next sub-chunk, or the next atom's first, staged by bulk
//   copies while this one runs (two buffers of 64 rows do not fit at D =
//   256); 32 rows a pass is what every product took anyway (two m-tiles),
//   and the sub-chunk changes no sum, so its outputs are the same bits.
// - Widths past 256 (D, G, O up to 512): scann_loop_tall_d512.cu and
//   scann_loop_wide_d512.cu, the same two kernels with SCANN_WIDTH_512 (16
//   values a lane): the tall build takes N <= kTallMaxN = 16 in chunks of
//   16 rows, the wide one N > 16 in sub-chunks of 16 (kFwdWideW32Rows), two
//   buffers each (at D = 512 the wide build takes MP2018 (96, 32) with atom
//   blocks of 16 in 231,952 bytes and (80, 96) with 8 in 201,488); the wide
//   context a thread's two columns over all N. The centers, the wide atom's
//   keys and the readout rows live in L2 as at 256.
// - The readout: the narrow build runs after_Lc, the GA queries and keys,
//   the scores, the pooled context and the head over all M atoms in every
//   block of the cluster, in the same order. In the tall and wide builds
//   each block forms after_Lc and the GA keys and queries of its own atoms
//   into the structure's readout rows [B, M, 2G] (global), then one cluster
//   barrier, then every block takes the queries' sums, the scores and the
//   pooled context over all M in atom order, the narrow build's order. Rank
//   0 writes pred and each block the GA scores of its own atoms. Launches at
//   one C repeat bit for bit.
//
// bf16 operand mode (model.dtype "bfloat16"): a second instantiation, kBf16,
// rounds the operands of every product to bfloat16 and sums in f32 where and
// as the TPU kernel's dots do (scann_forward_common.cuh); every build (narrow,
// wide, tall) holds both instantiations and a launch picks one. The wide
// build's atom walk (fwd_atom_wide_keys) rounds where fwd_chunk does: the
// gathered neighbour states once they land, each q * k lane before the head
// sum (warp_energies), the attention before the context; the context reads
// the unrounded keys, as fwd_chunk reads them. Unlike the
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
// the tall and wide builds take clusters of up to 16 blocks (past 8, a
// non-portable size the launch opts into), to fill the card at small batches
constexpr int kMaxL2Cluster = 16;
// The largest N of the narrow and tall builds, the wide build taking the
// rest: a chunk's rows (kFwdMaxChunkRows) up to 128 columns; past 128 (the
// *_d256 builds) 32, since two tall operand buffers of more rows do not fit
// a block's shared memory at D = 256, so the wide build takes N > 32 there;
// past 256 (the *_d512 builds) 16, the rows of two buffers that fit at D =
// 512 (the wide build's sub-chunks, kFwdWideW32Rows, are 16 rows there too).
constexpr int kTallMaxN = kLaneValues > 8 ? 16 : kLaneValues > 4 ? 32 : kFwdMaxChunkRows;

// The tall build (scann_loop_tall.cu defines SCANN_LOOP_TALL): the centers in
// global memory; every other build keeps them in shared memory.
#ifdef SCANN_LOOP_TALL
constexpr bool kTall = true;
#else
constexpr bool kTall = false;
#endif
// The tall and wide builds past 128 columns (scann_loop_tall_d256.cu,
// scann_loop_wide_d256.cu) run their row and per-atom products in the
// 32-column layout (mma_gemm_w32), on the packed TF32 planes of each layer's
// Wfg, Wk, Wq, W1 and W2 that the wrapper makes (tf32_planes), in both
// operand modes; only their kernels take them as a fourth argument, so every
// other build's kernel is the one it was. The wide one walks its atoms in
// sub-chunks of kFwdWideW32Rows rows in two operand buffers (kWideRows,
// kWideBuffers): the next sub-chunk is staged while this one runs.
#if defined(SCANN_WIDTH_256) && (defined(SCANN_LOOP_TALL) || defined(SCANN_LOOP_WIDE))
constexpr bool kW32 = true;
#define SCANN_LOOP_TAKES_PLANES
#define SCANN_LOOP_PLANES_PARAM , const float* planes
#define SCANN_LOOP_PLANES_ARG , planes
#else
constexpr bool kW32 = false;
#define SCANN_LOOP_PLANES_PARAM
#define SCANN_LOOP_PLANES_ARG
#endif
// the wide build's sub-chunk rows and operand buffers
constexpr int kWideRows = kW32 ? kFwdWideW32Rows : kFwdMaxChunkRows;
constexpr int kWideBuffers = kW32 ? 2 : 1;

// Shared-memory plan, in floats: centers [M, wd] (none in the tall and wide
// builds, l2_plan); two per-block slots [AB, wd + 4]; the work region: a
// chunk's buffers, the embedding's staging, the ResidualNorm's h2 [AB, wd +
// 4], or the readout's [AB, wd] block and vectors.
struct Plan {
  int wd, lds, rows, lde, ldf, work, offQ, offW, offWork, total;
};

// The tall and wide builds' plan: Plan's sizes, and where in the work region
// the chunk operand buffers, the index ring and the wide atom's keys sit
// (smem_keys: whether the keys are in shared memory).
struct L2Plan {
  Plan p;
  int offA, offA1, offI, offK, smem_keys;
};

// The plan of the tall and wide builds, whose centers live in global memory
// (L2): the two slots, then the work region. In a layer the work region
// holds the front, max(rows x (D + 4) + attention, AB x (wd + 4)) (a chunk's
// product and attention, the wide atom's energy row [N, H] in place of the
// attention; between chunks the ResidualNorm's h2 and the rows the per-atom
// projections read), then the chunk operand buffers [rows, 2D + 4] (two in
// the tall build: the next chunk is staged into one while the other runs; in
// the wide build kWideBuffers of kWideRows rows: one of 64 up to 128
// columns, two of 32 past them), the index ring [2][n] (two slots of a
// chunk's rows, n = rows, or of a wide atom's N: the neighbour indices,
// copied in a chunk or an atom ahead of their staging; round4(2n) floats, so
// that what follows stays 16-byte aligned at an odd n), the operand buffers'
// two mbarriers (4
// floats) and, in the wide build with smem_keys, the atom's keys [N, D].
// Outside the layers it holds the embedding's staging or the readout's
// block and vectors.
template <bool kWide>
__host__ __device__ inline L2Plan l2_plan(const ForwardArgs& a, bool smem_keys) {
  L2Plan q;
  Plan& p = q.p;
  const int AB = a.atom_block;
  p.wd = a.D > a.G ? a.D : a.G;
  p.lds = p.wd + 4;
  p.rows = kWide ? kWideRows : a.chunk_atoms * a.N;
  p.lde = round4(a.E + (a.use_ring ? 10 : 0));
  p.ldf = a.cgcnn ? round4(a.F) : 0;
  const int att = round4(kWide ? a.N * a.H : p.rows * a.H);
  int front = p.rows * (a.D + 4) + att;
  front = AB * p.lds > front ? AB * p.lds : front;
  q.offA = front;
  q.offA1 = front + p.rows * (2 * a.D + 4);
  q.offI = front + (kWide ? kWideBuffers : 2) * p.rows * (2 * a.D + 4);
  // the ring rounded up to 4 floats: the keys take 16-byte stores at any N
  q.offK = q.offI + round4(2 * (kWide ? a.N : p.rows)) + 4;
  q.smem_keys = kWide && smem_keys;
  int w = q.offK + (q.smem_keys ? a.N * a.D : 0);
  const int embed = AB * (p.lde + p.ldf);
  const int readout = AB * p.wd + 2 * p.wd + 2 * round4(a.M) + round4(a.O);
  const int seg_readout = AB * p.wd + seg_forward_floats(a.S, p.wd, a.M, a.O);
  w = embed > w ? embed : w;
  w = readout > w ? readout : w;
  if (a.S) w = seg_readout > w ? seg_readout : w;
  p.work = w;
  p.offQ = 0;
  p.offW = AB * p.lds;
  p.offWork = 2 * AB * p.lds;
  p.total = p.offWork + w;
  return q;
}

// The plan a tall or wide launch runs: the wide build keeps the atom's keys
// in shared memory where they fit.
template <bool kWide>
__host__ __device__ inline L2Plan make_l2_plan(const ForwardArgs& a) {
  const L2Plan q = l2_plan<kWide>(a, true);
  if (!kWide || q.p.total * (int)sizeof(float) <= kMaxSharedBytes) return q;
  return l2_plan<kWide>(a, false);
}

template <bool kWide>
__host__ __device__ inline Plan make_plan(const ForwardArgs& a) {
  if constexpr (kTall || kWide) {
    return make_l2_plan<kWide>(a).p;
  } else {
    Plan p;
    const int AB = a.atom_block;
    p.wd = a.D > a.G ? a.D : a.G;
    p.lds = p.wd + 4;
    p.rows = a.chunk_atoms * a.N;
    p.lde = round4(a.E + (a.use_ring ? 10 : 0));
    p.ldf = a.cgcnn ? round4(a.F) : 0;
    int w = fwd_chunk_floats(p.rows, a.D, a.H);
    const int embed = AB * (p.lde + p.ldf);
    const int residual = AB * p.lds;
    const int readout = AB * p.wd + 2 * p.wd + 2 * round4(a.M) + round4(a.O);
    const int seg_readout = AB * p.wd + seg_forward_floats(a.S, p.wd, a.M, a.O);
    w = embed > w ? embed : w;
    w = residual > w ? residual : w;
    w = readout > w ? readout : w;
    if (a.S) w = seg_readout > w ? seg_readout : w;
    p.work = w;
    p.offQ = a.M * p.wd;
    p.offW = p.offQ + AB * p.lds;
    p.offWork = p.offW + AB * p.lds;
    p.total = p.offWork + w;
    return p;
  }
}

// The plan of either build, by N (host side).
inline Plan plan_of(const ForwardArgs& a) {
  return a.N > kFwdMaxChunkRows ? make_plan<true>(a) : make_plan<false>(a);
}

// kWide: N > kFwdMaxChunkRows (the wide build, scann_loop_wide.cu), one atom
// at a time. kL2 (the tall and the wide builds): a.next_centers is the
// ping-pong centers [2, B, M, D] and l2 the readout's rows [B, M, 2G] (each
// atom's GA keys, then its GA queries, written by the block that owns the
// atom), followed in the wide build whose plan keeps the atom's keys out of
// shared memory by each block's keys [B * C, N, D]; null in the narrow build.
// planes: the kW32 build's packed TF32 planes of each layer's products
// (row_planes' four blocks, then the ResidualNorm's W1 and W2); null
// elsewhere.
template <bool kBf16, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
scann_loop_forward_kernel(const ForwardArgs a, const int C, float* l2 SCANN_LOOP_PLANES_PARAM) {
  constexpr bool kL2 = kTall || kWide;
#ifndef SCANN_LOOP_TAKES_PLANES
  const float* const planes = nullptr;   // read under kW32 only
#endif
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
  float* sC = smem;               // centers / GA keys  [M, wd] (narrow)
  float* sQ = smem + P.offQ;      // query / out        [AB, lds]
  float* sW = smem + P.offW;      // cw, then h1        [AB, lds]
  float* work = smem + P.offWork;
  float* sA = work;                        // chunk operand [rows, 2D + 4]
  float* sU = sA + P.rows * lda;           // chunk product [rows, D + 4]
  float* sE = sU + P.rows * ldu;           // attention     [rows, H]
  float* sA1 = nullptr;        // tall, wide past 128 columns: the second operand buffer
  int* ring = nullptr;         // the index ring [2][ring_n]
  unsigned long long* bars = nullptr;   // the operand buffers' mbarriers [2]
  // SCANN: the distance RBF of the structure's rows [M * N, round4(K)], a
  // table the launch's geometry scratch holds (SCANN has no geometry), each
  // block's rows computed once for all layers
  float* rbf_b = nullptr;
  float* atom_keys = nullptr;  // wide: the atom's keys [N, D]
  bool smem_keys = false;      // wide: in shared memory, else in l2
  const int ring_n = kWide ? N : P.rows;
  if constexpr (kL2) {   // the front of the work region, then the operand buffers
    const L2Plan Q = make_l2_plan<kWide>(a);
    sU = work;
    sE = sU + P.rows * ldu;
    sA = work + Q.offA;
    if constexpr (kTall || (kWide && kWideBuffers == 2)) sA1 = work + Q.offA1;
    ring = reinterpret_cast<int*>(work + Q.offI);
    bars = reinterpret_cast<unsigned long long*>(ring + 2 * ring_n);
    if (!a.g_update) rbf_b = a.geo + (size_t)b * M * N * round4(a.K);
    smem_keys = Q.smem_keys;
    atom_keys = smem_keys ? work + Q.offK
                          : l2 + (size_t)a.B * M * 2 * G + (size_t)blockIdx.x * N * D;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float* am = a.atom_mask + (size_t)b * M;
  const int* nbr = a.nbr + (size_t)b * M * N;
  const float* nmask = a.nmask + (size_t)b * M * N;
  const float* nweight = a.nweight + (size_t)b * M * N;
  const float* ndist = a.ndist + (size_t)b * M * N;
  float* geo_b = a.geo + (size_t)b * M * N * D;
  float* next_b = a.next_centers + (size_t)b * M * D;
  // kL2: the centers of layer l's input, half l & 1 of the ping-pong scratch
  // (half 0 is next_b); the structure's readout rows
  auto centers_of = [&](int l) {
    return a.next_centers + ((size_t)(l & 1) * a.B + b) * M * D;
  };
  const int ldr = 2 * G;
  float* const rows_b = kL2 ? l2 + (size_t)b * M * ldr : nullptr;
  float* const keys_b = kL2 ? rows_b : sC;
  const int ldk = kL2 ? ldr : wd;
  // kL2: the neighbour indices of rows [base, base + n) into slot s of the
  // index ring, as copies in flight (cp.async); the caller waits for them
  // before the staging that reads them
  auto ring_idx = [&](int slot) { return ring + slot * ring_n; };
  auto fetch_ring = [&](int slot, int base, int n) {
    for (int i = tid; i < n; i += kThreads)
      cp_async4(reinterpret_cast<float*>(ring_idx(slot) + i), nbr + base + i);
  };

  // kL2: rows [m0, m0 + n) of layer l's input centers into dst [n, ld], read
  // past L1 (other SMs wrote them); the caller synchronises
  auto stage_rows = [&](float* dst, int ld, int l, int m0, int n) {
    const float* src = centers_of(l) + (size_t)m0 * D;
    for (int i = tid; i < n * q4; i += kThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      store4(dst + r * ld + c, __ldcg(reinterpret_cast<const float4*>(src + (size_t)r * D + c)));
    }
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

  if constexpr (kL2) {   // the mbarriers outlive every use of the work region before the readout
    if (tid == 0) {
      mbar_init(bars);
      mbar_init(bars + 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  unsigned phases = 0;   // bit k: the parity of buffer k's mbarrier's next phase

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
    // sub-chunks of kWideRows
    ForwardArgs by_row = a;
    by_row.N = 1;
    by_row.chunk_atoms = kWideRows;
    if (a.g_update)
      fwd_embed_geometry<kBf16>(by_row, sA, sU, ndist, nweight, geo_b, m_lo * N, m_hi * N);
  } else {
    if (a.g_update) fwd_embed_geometry<kBf16>(a, sA, sU, ndist, nweight, geo_b, m_lo, m_hi);
  }
  if constexpr (kL2) {
    if (!a.g_update) {   // SCANN: the RBF table of this block's rows, as fwd_stage_chunk forms it
      float* rbf_c = work;   // the RBF centers (the work region is free here)
      for (int k = tid; k < a.K; k += kThreads) rbf_c[k] = a.dist_centers[k];
      __syncthreads();
      const int k4 = round4(a.K);
      const size_t n = (size_t)(m_hi - m_lo) * N * k4;
#pragma unroll 4
      for (size_t i = tid; i < n; i += kThreads) {
        const int r = m_lo * N + (int)(i / k4), k = (int)(i % k4);
        float v = 0.f;
        if (k < a.K) {
          const float t = ndist[r] - rbf_c[k];
          v = expf(-(t * t) / a.rbf_width);
        }
        rbf_b[(size_t)r * k4 + k] = v;
      }
    }
    fence_proxy_async_global();   // the centers, geometry and RBF table, before the bulk reads
  }
  cluster_barrier();
  if constexpr (!kL2) {
    load_centers();
    cluster_barrier();
  }

  // ---- L x (LocalAttention + ResidualNorm) -------------------------------
  for (int l = 0; l < a.L; ++l) {
    const LayerWeights w = layer_weights(a, l);
    const float* wq = a.wq + (size_t)l * D * D;
    const float* bq = a.bq + (size_t)l * D;
    // the gather's rows: the resident centers, or (kL2) the global ones
    const float* cen = kL2 ? centers_of(l) : sC;
    const int ldc = kL2 ? D : wd;
    float* out_b = kL2 ? centers_of(l + 1) : next_b;
    // kW32: the layer's packed planes (LocalAttention's, then the
    // ResidualNorm's W1 and W2), made where they are used, so that no
    // register holds them across the layer
    auto layer_planes = [&]() {
      return planes + (layer_plane_floats(D, a.K, a.g_update) + 2 * w32_plane_floats(D, D)) * l;
    };
    // tall: the layer's chunks run in order, each staged into one of two
    // operand buffers while the chunk before it runs in the other, from the
    // indices the ring took in one chunk earlier. The first chunk is staged
    // now (the layer's input centers are complete only after the barrier
    // that ended the layer before). next_chunk(m0) is the chunk after the one
    // at m0: the next of its atom block, else the first of the next block.
    int cur = 0;
    auto chunk_buf = [&](int i) { return i ? sA1 : sA; };
    auto chunk_atoms = [&](int m0) {
      return min(CA, min(m_lo + ((m0 - m_lo) / AB + 1) * AB, m_hi) - m0);
    };
    auto next_chunk = [&](int m0) { return m0 + chunk_atoms(m0); };
    auto wide_atom_ring = [&](int m) {   // wide: atom m's indices, slot (m - m_lo) & 1
      if (m < m_hi) fetch_ring((m - m_lo) & 1, m * N, N);
    };
    // stage rows [base, base + rows) into buffer k, their indices at idx; wait for them
    auto stage = [&](int k, const int* idx, int base, int rows) {
      fwd_stage_chunk_bulk(a, chunk_buf(k), cen, idx, geo_b, rbf_b, base, rows, bars + k);
    };
    auto wait = [&](int k, int rows, bool ring = true) {
      fwd_stage_chunk_wait<kBf16>(a, chunk_buf(k), rows, bars + k, (phases >> k) & 1u, ring);
      phases ^= 1u << k;
    };
    if constexpr (kTall) {
      if (m_lo < m_hi) {
        const int m1 = next_chunk(m_lo);
        fetch_ring(0, m_lo * N, chunk_atoms(m_lo) * N);
        if (m1 < m_hi) fetch_ring(1, m1 * N, chunk_atoms(m1) * N);
        cp_async_wait_all();
        fence_proxy_async();   // the buffers' last writers: the geometry, the last layer
        __syncthreads();
        stage(0, ring_idx(0), m_lo * N, chunk_atoms(m_lo) * N);
        wait(0, chunk_atoms(m_lo) * N);
      }
    }
    // wide past 128 columns (kW32): the layer's sub-chunks j = 0, 1, ... of
    // the block's atoms (atom m_lo + j / per_atom, rows from kWideRows (j %
    // per_atom)) in order, sub-chunk j in buffer j & 1, staged while sub-chunk
    // j - 1 runs: sub-chunk 0 now, each later one once the walk has waited
    // for the one before it (one barrier a sub-chunk: every thread fences its
    // accesses to the buffer sub-chunk j - 1 took before the barrier of that
    // wait, and the copies into it are issued after it)
    const int per_atom = (N + kWideRows - 1) / kWideRows;
    const int subs = (m_hi - m_lo) * per_atom;
    int wj = 0;
    auto wide_rows = [&](int j) { return min(kWideRows, N - (j % per_atom) * kWideRows); };
    auto wide_issue = [&](int j) {
      if (j >= subs) return;
      const int at = j / per_atom, n0 = (j - at * per_atom) * kWideRows;
      stage(j & 1, ring_idx(at & 1) + n0, (m_lo + at) * N + n0, wide_rows(j));
    };
    if constexpr (kWide) {
      wide_atom_ring(m_lo);
      cp_async_wait_all();
      // the buffers' last users: the geometry embedding, the last layer
      if constexpr (kW32) fence_proxy_async();
      __syncthreads();
      if constexpr (kW32) wide_issue(0);
    }

    for (int ab0 = m_lo; ab0 < m_hi; ab0 += AB) {
      const int ab = min(AB, m_hi - ab0);
      // per-atom projections of the block: cw = centers @ Wfg[0:D] (SCANN+),
      // query (kL2: from the block's rows staged into the front of the work
      // region)
      const float* cb = sC + ab0 * wd;
      if constexpr (kL2) {
        stage_rows(work, wd, l, ab0, ab);
        __syncthreads();
        cb = work;
      }
      if constexpr (kW32) {
        const RowPlanes pl = row_planes(layer_planes(), D, a.K, a.g_update);
        if (a.g_update)
          mma_gemm_w32<kBf16>(cb, wd, ab, D, pl.cw, D,
                              [&](int r, int c, float4 v) { store4(sW + r * lds + c, v); });
        mma_gemm_w32<kBf16>(cb, wd, ab, D, pl.q, D, [&](int r, int c, float4 v) {
          store4(sQ + r * lds + c,
                 make_float4(v.x + bq[c], v.y + bq[c + 1], v.z + bq[c + 2], v.w + bq[c + 3]));
        });
      } else {
        if (a.g_update)
          mma_gemm<kBf16>(cb, wd, ab, D, w.wfg, D, D,
                          [&](int r, int c, float4 v) { store4(sW + r * lds + c, v); });
        mma_gemm<kBf16>(cb, wd, ab, D, wq, D, D, [&](int r, int c, float4 v) {
          store4(sQ + r * lds + c,
                 make_float4(v.x + bq[c], v.y + bq[c + 1], v.z + bq[c + 2], v.w + bq[c + 3]));
        });
      }
      __syncthreads();

      if constexpr (kWide && kW32) {
        for (int m = ab0; m < ab0 + ab; ++m) {
          const int base = m * N;
          // the next atom's indices, waited for where the staging of its
          // first sub-chunk is issued
          wide_atom_ring(m + 1);
          fwd_atom_wide_keys<kBf16, true>(
              forward_chunk_dims(a), w,
              [&](int, int rows) {
                const int j = wj++;
                wait(j & 1, rows, (j + 1) % per_atom == 0);
                wide_issue(j + 1);
                return chunk_buf(j & 1);
              },
              sU, sE, sW + (m - ab0) * lds, sQ + (m - ab0) * lds, nmask + base,
              nweight + base, l + 1 < a.L ? geo_b + (size_t)base * D : nullptr,
              static_cast<float*>(nullptr), atom_keys, D, smem_keys,
              [&](int n, int h) {
                return scann_philox::mask_value(a.seed, mol, 1 + a.L + l,
                                                (unsigned)((base + n) * H + h),
                                                a.attn_threshold, a.attn_scale);
              },
              row_planes(layer_planes(), D, a.K, a.g_update));
        }
      } else if constexpr (kWide) {
        for (int m = ab0; m < ab0 + ab; ++m) {
          const int base = m * N, slot = (m - m_lo) & 1;
          // the next atom's indices, waited for with this atom's first staging
          wide_atom_ring(m + 1);
          fwd_atom_wide_keys<kBf16>(
              forward_chunk_dims(a), w,
              [&](int n0, int rows) {
                fence_proxy_async();   // the last sub-chunk's accesses to sA
                __syncthreads();
                stage(0, ring_idx(slot) + n0, base + n0, rows);
                wait(0, rows);
                return sA;
              },
              sU, sE, sW + (m - ab0) * lds, sQ + (m - ab0) * lds, nmask + base,
              nweight + base, l + 1 < a.L ? geo_b + (size_t)base * D : nullptr,
              static_cast<float*>(nullptr), atom_keys, D, smem_keys, [&](int n, int h) {
                return scann_philox::mask_value(a.seed, mol, 1 + a.L + l,
                                                (unsigned)((base + n) * H + h),
                                                a.attn_threshold, a.attn_scale);
              });
        }
      } else if constexpr (kTall) {
        for (int m0 = ab0; m0 < ab0 + ab; m0 += CA) {
          const int ca = min(CA, ab0 + ab - m0), base = m0 * N;
          // the next chunk, staged from its slot while this one runs; the
          // indices of the one after it into this chunk's slot
          const int n0 = next_chunk(m0), n1 = n0 < m_hi ? next_chunk(n0) : m_hi;
          if (n1 < m_hi) fetch_ring(cur, n1 * N, chunk_atoms(n1) * N);
          if (n0 < m_hi) stage(cur ^ 1, ring_idx(cur ^ 1), n0 * N, chunk_atoms(n0) * N);
          if constexpr (kW32)
            fwd_chunk_w32<kBf16, float>(
                forward_chunk_dims(a), w, ca, chunk_buf(cur), sU, sE, sW + (m0 - ab0) * lds,
                sQ + (m0 - ab0) * lds, lds, nmask + base, nweight + base,
                l + 1 < a.L ? geo_b + (size_t)base * D : nullptr, nullptr,
                [&](int at, int n, int h) {
                  return scann_philox::mask_value(
                      a.seed, mol, 1 + a.L + l, (unsigned)((base + at * N + n) * H + h),
                      a.attn_threshold, a.attn_scale);
                },
                row_planes(layer_planes(), D, a.K, a.g_update));
          else
            fwd_chunk<kBf16, float>(forward_chunk_dims(a), w, ca, chunk_buf(cur), sU, sE,
                      sW + (m0 - ab0) * lds, sQ + (m0 - ab0) * lds, lds, nmask + base,
                      nweight + base, l + 1 < a.L ? geo_b + (size_t)base * D : nullptr, nullptr,
                      [&](int at, int n, int h) {
                        return scann_philox::mask_value(
                            a.seed, mol, 1 + a.L + l, (unsigned)((base + at * N + n) * H + h),
                            a.attn_threshold, a.attn_scale);
                      });
          if (n0 < m_hi) wait(cur ^ 1, chunk_atoms(n0) * N);
          cur ^= 1;
        }
      } else {
        for (int m0 = ab0; m0 < ab0 + ab; m0 += CA) {
          const int ca = min(CA, ab0 + ab - m0), base = m0 * N;
          fwd_stage_chunk<kBf16>(a, sA, cen, ldc, nbr, ndist, geo_b, base, ca * N);
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
      if constexpr (kW32) {
        const float* r1 = layer_planes() + layer_plane_floats(D, a.K, a.g_update);
        fwd_residual_norm<kBf16, true>(
            a, l, ab, sQ, sW, work, lds, [&](int r, int c) { return mask4(1 + l, ab0 + r, c); },
            [&](int m, const float (&v)[kLaneValues]) {
#pragma unroll
              for (int i = 0; i < kLaneValues; ++i)
                if (lane + 32 * i < D) out_b[(size_t)(ab0 + m) * D + lane + 32 * i] = v[i];
            },
            r1, r1 + w32_plane_floats(D, D));
      } else {
        fwd_residual_norm<kBf16>(a, l, ab, sQ, sW, work, lds,
                          [&](int r, int c) { return mask4(1 + l, ab0 + r, c); },
                          [&](int m, const float (&v)[kLaneValues]) {
#pragma unroll
                            for (int i = 0; i < kLaneValues; ++i)
                              if (lane + 32 * i < D)
                                out_b[(size_t)(ab0 + m) * D + lane + 32 * i] = v[i];
                          });
      }
    }

    // every atom of the structure has gathered from this layer's input and
    // every block has written its atoms' new centers: take all M rows (kL2:
    // the barrier alone, after the fence that orders this layer's centers
    // and geometry before the next layer's bulk reads; the next layer writes
    // the other half)
    if constexpr (kL2) fence_proxy_async_global();
    cluster_barrier();
    if constexpr (!kL2) {
      load_centers();
      cluster_barrier();
    }
  }
  if constexpr (kL2) {   // the readout may take the mbarriers' memory
    if (tid == 0) {
      mbar_inval(bars);
      mbar_inval(bars + 1);
    }
    __syncthreads();
  }

  // ---- readout: after_Lc, GA scores, pooled context, head ----------------
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
  if constexpr (kL2) {
    // each block: after_Lc, the GA keys and queries of its own atoms into the
    // structure's readout rows; then one barrier, and every block takes the
    // sums over all M atoms in atom order, as the narrow build does
    for (int ab0 = m_lo; ab0 < m_hi; ab0 += AB) {
      const int ab = min(AB, m_hi - ab0);
      stage_rows(sW, lds, a.L, ab0, ab);
      __syncthreads();
      mma_gemm<kBf16>(sW, lds, ab, D, a.wal, G, G, [&](int r, int c, float4 v) {
        store4(RB + r * wd + c, make_float4(swishf(v.x + a.bal[c]), swishf(v.y + a.bal[c + 1]),
                                            swishf(v.z + a.bal[c + 2]), swishf(v.w + a.bal[c + 3])));
      });
      __syncthreads();
      mma_gemm<kBf16>(RB, wd, ab, G, a.wgq, G, G, [&](int r, int c, float4 v) {
        store4(rows_b + (size_t)(ab0 + r) * ldr + G + c,
               make_float4(v.x + a.bgq[c], v.y + a.bgq[c + 1], v.z + a.bgq[c + 2],
                           v.w + a.bgq[c + 3]));
      });
      mma_gemm<kBf16>(RB, wd, ab, G, a.wgk, G, G, [&](int r, int c, float4 v) {
        store4(rows_b + (size_t)(ab0 + r) * ldr + c,
               make_float4(v.x + a.bgk[c], v.y + a.bgk[c + 1], v.z + a.bgk[c + 2],
                           v.w + a.bgk[c + 3]));
      });
      __syncthreads();
    }
    cluster_barrier();
    const float* gq = rows_b + G;
    if (S) {
      seg_queries<kBf16>(v, S, gq, ldr, keys_b, ldk, am, sid, 0, M, G, true);
    } else {
      for (int g = tid; g < G; g += kThreads) {
        float s = 0.f;
        for (int m = 0; m < M; ++m) s += am[m] * gq[(size_t)m * ldr + g];
        qsum[g] = s;
      }
      for (int m = warp; m < M; m += kWarps) {
        const float mm = am[m];
        float dg = 0.f;
        for (int g = lane; g < G; g += 32)
          dg += (mm * keys_b[(size_t)m * ldk + g]) * (mm * gq[(size_t)m * ldr + g]);
        dg = warp_sum(dg);
        if (lane == 0) diag[m] = dg;
      }
    }
    __syncthreads();
  } else {
    // over all M atoms in every block, in the same order
    if (!S)
      for (int g = tid; g < G; g += kThreads) qsum[g] = 0.f;
    for (int ab0 = 0; ab0 < M; ab0 += AB) {
      const int ab = min(AB, M - ab0);
      const float* cl = sC + ab0 * wd;
      int ldl = wd;
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
// next-centers scratch [B, M, D] (the tall and wide builds: the ping-pong
// centers [2, B, M, D]), pointer 50, the segment ids [B, M] (null unless
// packed), pointer 51, the tall and wide builds' readout rows [B, M, 2G]
// (the wide build's per-block keys [B * C, N, D] right after them where its
// plan keeps the keys out of shared memory), null in the narrow one,
// in the tall and wide builds past 128 columns pointer 52, the packed TF32
// planes of the layers' Wfg, Wk, Wq, W1 and W2 (no other build takes a
// pointer 52),
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
// scann_loop_tall_d256.cu and scann_loop_wide_d256.cu add SCANN_WIDTH_256:
// the tall and wide builds of widths up to 256 (scann_loop_forward_tall_d256_*,
// scann_loop_forward_wide_d256_*), at the first launch of a wider model;
// scann_loop_tall_d512.cu and scann_loop_wide_d512.cu add SCANN_WIDTH_512
// too: those of widths up to 512 (scann_loop_forward_tall_d512_*,
// scann_loop_forward_wide_d512_*), with the same pointers and sizes.
#if defined(SCANN_LOOP_WIDE) && defined(SCANN_WIDTH_512)
#define SCANN_LOOP_ENTRY(x) scann_loop_forward_wide_d512_##x
constexpr bool kWideBuild = true;
#elif defined(SCANN_LOOP_TALL) && defined(SCANN_WIDTH_512)
#define SCANN_LOOP_ENTRY(x) scann_loop_forward_tall_d512_##x
constexpr bool kWideBuild = false;
#elif defined(SCANN_LOOP_WIDE) && defined(SCANN_WIDTH_256)
#define SCANN_LOOP_ENTRY(x) scann_loop_forward_wide_d256_##x
constexpr bool kWideBuild = true;
#elif defined(SCANN_LOOP_TALL) && defined(SCANN_WIDTH_256)
#define SCANN_LOOP_ENTRY(x) scann_loop_forward_tall_d256_##x
constexpr bool kWideBuild = false;
#elif defined(SCANN_LOOP_WIDE)
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

// The largest cluster this build launches; the tall and wide builds opt into
// the non-portable sizes past 8.
constexpr int kBuildMaxCluster = (kWideBuild || kTall) ? kMaxL2Cluster : kMaxCluster;

static cudaError_t set_kernel_attributes(const void* kernel, int bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && kBuildMaxCluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// How many clusters of `cluster` blocks with this shape's shared memory the
// card runs at once (cudaOccupancyMaxActiveClusters) in this build's kernel
// of the operand mode in size 22, or minus the CUDA error.
extern "C" int SCANN_LOOP_ENTRY(max_clusters)(const int* dims, int cluster) {
  ForwardArgs a = {};
  set_dims(a, dims);
  if (dims[22] & ~1) return -(int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kBuildMaxCluster) return -(int)cudaErrorInvalidValue;
  const auto kernel = build_kernel(dims[22]);
  const int bytes = make_plan<kWideBuild>(a).total * (int)sizeof(float);
  cudaError_t err = set_kernel_attributes((const void*)kernel, bytes);
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
  float* l2 = (float*)ptrs[51];
#ifdef SCANN_LOOP_TAKES_PLANES
  const float* planes = (const float*)ptrs[52];
  if (planes == nullptr) return kErrShape;
#endif
  a.atom_block = dims[20];
  a.S = dims[21];
  const int bf16 = dims[22];
  const int C = dims[23];
  if (a.S < 0 || a.S > kMaxSegments || (a.S > 0) != (a.seg != nullptr)) return kErrShape;
  if (bf16 & ~1) return kErrShape;
  // the wide build: kTallMaxN < N <= kWideMaxN, one atom a chunk; the
  // tall and wide builds: their readout rows
  if ((a.N > kTallMaxN) != kWideBuild || (l2 != nullptr) != (kWideBuild || kTall) ||
      (kWideBuild && (a.N > kWideMaxN || a.chunk_atoms != 1)))
    return kErrShape;

  if (a.M < 1 || a.N < 1 || a.L < 1 || a.chunk_atoms < 1 ||
      (!kWideBuild && a.chunk_atoms * a.N > kFwdMaxChunkRows) || a.atom_block < 1 ||
      a.atom_block > kMaxAtomBlock || a.chunk_atoms > a.atom_block ||
      C < 1 || C > kBuildMaxCluster ||
      a.D > kMaxWidth || a.G > kMaxWidth || a.O > kMaxWidth ||
      (a.D & 3) || (a.G & 3) || (a.O & 3) || (a.E & 3) || a.D % a.H || a.K > a.D)
    return kErrShape;
  const Plan plan = make_plan<kWideBuild>(a);
  if (a.abuf_floats != plan.work) return kErrShape;   // the wrapper's plan is this one
  const int bytes = plan.total * (int)sizeof(float);
  if (bytes > kMaxSharedBytes) return kErrSharedMemory;
  const auto kernel = build_kernel(bf16);
  cudaError_t err = set_kernel_attributes((const void*)kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch_config(cfg, attr, a.B, C, bytes, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, kernel, a, C, l2 SCANN_LOOP_PLANES_ARG);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* SCANN_LOOP_ENTRY(error_string)(int code) {
  if (code == kErrSharedMemory) return "shared-memory plan exceeds 227 KB per block";
  if (code == kErrShape) return "shape outside what the kernel takes";
  return cudaGetErrorString((cudaError_t)code);
}
