// One LocalAttention layer (SCANN+ or SCANN), forward, for structures of any
// size: one CUDA block per (structure, block of atoms).
//
// Replaces the TPU kernel scann_tpu/kernels/local_attention.py:_kernel (the
// Pallas per-layer kernel): neighbour gather -> SCANN+ geometry update or
// SCANN distance filter -> key and query projections -> per-head masked
// softmax over the N neighbours -> masked context sum -> + query ->
// LayerNorm. Outputs out [B, M, D], the updated geometry [B, M, N, D]
// (SCANN+) and the attention [B, M, N, H], f32. The eager model runs the
// rest of the network around it, for shapes and configurations the
// whole-model kernels refuse.
//
// Bound. At one MP2018 layer (B=64, M=96, N=32, D=128) the layer is ~2.0e10
// FLOP of FP32 FMA; it reads and writes the geometry once each (2 x 100 MB)
// beside ~10 MB of other tensors. At the H100 SXM's 67 TFLOP/s and 3.35 TB/s
// that is ~0.30 ms of operations against ~0.06 ms of bytes: bound by
// operations.
//
// Design.
// - The previous layer's centers are read from global memory (a few MB, in
//   L2), so nothing limits M: the grid tiles the atoms, AB = 32 to a block,
//   and a block needs no other block.
// - A block stages its atoms' centers, forms their queries (and the SCANN+
//   center term cw) once, then sends its (atom, neighbour) rows through
//   attention_chunk (scann_common.cuh) in chunks of at most 64 rows: the
//   gather is an index read, the per-head reductions loop over a head's lanes.
// - Limits: D a multiple of 4 up to 128 (a warp's LayerNorm holds 4 values a
//   lane, a thread's tile is 4 columns), N <= 64 (one atom's neighbours must
//   fit a chunk), K <= D, D % H == 0.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// given stream, synchronises nothing, allocates nothing, and returns the
// cudaGetLastError() code of the launch (or kErrSharedMemory / kErrShape).

#include "scann_common.cuh"

namespace {

using namespace scann;

constexpr int kMaxChunkRows = 64;
constexpr int kAtomBlock = 32;

struct Args {
  const float* centers;   // [B, M, D]
  const int* nbr;         // [B, M, N]
  const float* geometry;  // [B, M, N, D] (SCANN+) or [B, M, N, K] (SCANN)
  const float* nmask;     // [B, M, N]
  const float* nweight;   // [B, M, N]    (SCANN)
  const float* wq;        // [D, D]
  const float* bq;
  LayerWeights w;
  float* out;             // [B, M, D]
  float* geo_out;         // [B, M, N, D] (SCANN+)
  float* attn;            // [B, M, N, H]
  int B, M, N, D, H, K, g_update, chunk_atoms;
  float dk;               // hd ** -scale
};

// Shared memory, in floats: the block's centers, queries and center terms
// [AB, D] each, the chunk operand [rows, 2D], the chunk product [rows, D],
// the energies [rows, H].
__host__ __device__ inline int shared_floats(const Args& a) {
  const int rows = a.chunk_atoms * a.N;
  return 3 * kAtomBlock * a.D + rows * 3 * a.D + round4(rows * a.H);
}

__global__ void __launch_bounds__(kThreads, 1)
local_attention_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = a.N, D = a.D, H = a.H, K = a.K, M = a.M, CA = a.chunk_atoms;
  const int rows_max = CA * N, lda = 2 * D, q4 = D / 4;
  float* sC = smem;                          // centers of the block  [AB, D]
  float* sQ = sC + kAtomBlock * D;           // query / out           [AB, D]
  float* sW = sQ + kAtomBlock * D;           // cw                    [AB, D]
  float* sA = sW + kAtomBlock * D;           // chunk operand         [rows, 2D]
  float* sU = sA + rows_max * lda;           // chunk product         [rows, D]
  float* sE = sU + rows_max * D;             // energies              [rows, H]
  const int tid = threadIdx.x;
  const int b = blockIdx.y, ab0 = blockIdx.x * kAtomBlock;
  const int ab = min(kAtomBlock, M - ab0);
  const int gk = a.g_update ? D : K;         // width of a geometry row

  const float* centers_b = a.centers + (size_t)b * M * D;
  const int* nbr = a.nbr + (size_t)b * M * N;
  const float* geometry = a.geometry + (size_t)b * M * N * gk;
  const float* nmask = a.nmask + (size_t)b * M * N;
  const float* nweight = a.nweight + (size_t)b * M * N;
  float* geo_out = a.geo_out + (size_t)b * M * N * D;
  float* attn = a.attn + (size_t)b * M * N * H;

  for (int i = tid; i < ab * q4; i += kThreads) {
    const int m = i / q4, c = (i - m * q4) * 4;
    store4(sC + m * D + c, __ldg(reinterpret_cast<const float4*>(
                               centers_b + (size_t)(ab0 + m) * D + c)));
  }
  __syncthreads();
  if (a.g_update) {
    tile_gemm(sC, D, ab, D, a.w.wfg, D, D, [&](int r, int c, float4 v) {
      store4(sW + r * D + c, v);
    });
  }
  tile_gemm(sC, D, ab, D, a.wq, D, D, [&](int r, int c, float4 v) {
    store4(sQ + r * D + c, make_float4(v.x + a.bq[c], v.y + a.bq[c + 1], v.z + a.bq[c + 2],
                                       v.w + a.bq[c + 3]));
  });
  __syncthreads();

  for (int m0 = ab0; m0 < ab0 + ab; m0 += CA) {
    const int ca = min(CA, ab0 + ab - m0), rows = ca * N, base = m0 * N;
    if (a.g_update) {
      for (int i = tid; i < rows * q4; i += kThreads) {
        const int r = i / q4, c = (i - r * q4) * 4;
        store4(sA + r * lda + c, __ldg(reinterpret_cast<const float4*>(
                                     geometry + (size_t)(base + r) * D + c)));
      }
    } else {
      for (int i = tid; i < rows * K; i += kThreads) {
        const int r = i / K, k = i - r * K;
        sA[r * lda + k] = geometry[(size_t)(base + r) * K + k];
      }
    }
    for (int i = tid; i < rows * q4; i += kThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      store4(sA + r * lda + D + c, __ldg(reinterpret_cast<const float4*>(
                                       centers_b + (size_t)nbr[base + r] * D + c)));
    }
    __syncthreads();
    attention_chunk(ca, N, D, H, K, a.g_update != 0, sA, sU, sE, sW + (m0 - ab0) * D,
                    sQ + (m0 - ab0) * D, D, nmask + base, nweight + base,
                    geo_out + (size_t)base * D, attn + (size_t)base * H, a.w, a.dk, false,
                    [](int, int, int) { return 1.0f; });
  }

  for (int i = tid; i < ab * q4; i += kThreads) {
    const int m = i / q4, c = (i - m * q4) * 4;
    store4(a.out + ((size_t)b * M + ab0 + m) * D + c,
           *reinterpret_cast<const float4*>(sQ + m * D + c));
  }
}

}  // namespace

// ptrs: centers, neighbours, geometry, mask, weight, Wfg, bfg, Wk, bk, Wq,
// bq, ln scale, ln bias, ln_g scale, ln_g bias, out, geo_out, attn;
// dims: B, M, N, D, H, K, g_update, chunk_atoms; scalars: dk. The order
// must match scann_tpu_torch/kernels/local_attention.py.
extern "C" int local_attention_launch(void* const* ptrs, const int* dims, const float* scalars,
                                      void* stream) {
  Args a;
  int i = 0;
  a.centers = (const float*)ptrs[i++];
  a.nbr = (const int*)ptrs[i++];
  a.geometry = (const float*)ptrs[i++];
  a.nmask = (const float*)ptrs[i++];
  a.nweight = (const float*)ptrs[i++];
  a.w.wfg = (const float*)ptrs[i++];
  a.w.bfg = (const float*)ptrs[i++];
  a.w.wk = (const float*)ptrs[i++];
  a.w.bk = (const float*)ptrs[i++];
  a.wq = (const float*)ptrs[i++];
  a.bq = (const float*)ptrs[i++];
  a.w.ln_s = (const float*)ptrs[i++];
  a.w.ln_b = (const float*)ptrs[i++];
  a.w.lng_s = (const float*)ptrs[i++];
  a.w.lng_b = (const float*)ptrs[i++];
  a.out = (float*)ptrs[i++];
  a.geo_out = (float*)ptrs[i++];
  a.attn = (float*)ptrs[i++];
  a.B = dims[0]; a.M = dims[1]; a.N = dims[2]; a.D = dims[3]; a.H = dims[4]; a.K = dims[5];
  a.g_update = dims[6]; a.chunk_atoms = dims[7];
  a.dk = scalars[0];

  if (a.B < 1 || a.B > 65535 || a.M < 1 || a.N < 1 || a.chunk_atoms < 1 ||
      a.chunk_atoms * a.N > kMaxChunkRows || a.D > 128 || (a.D & 3) || a.D % a.H ||
      a.K < 1 || a.K > a.D)
    return kErrShape;
  const int bytes = shared_floats(a) * (int)sizeof(float);
  if (bytes > kMaxSharedBytes) return kErrSharedMemory;
  cudaError_t err = cudaFuncSetAttribute(local_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.M + kAtomBlock - 1) / kAtomBlock, a.B);
  local_attention_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* local_attention_error_string(int code) {
  if (code == kErrSharedMemory) return "shared-memory plan exceeds 227 KB per block";
  if (code == kErrShape) return "shape outside what the kernel takes";
  return cudaGetErrorString((cudaError_t)code);
}
