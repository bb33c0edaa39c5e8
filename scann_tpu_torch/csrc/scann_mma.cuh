// Products of the two backward kernels (scann_backward.cu, scann_loop_backward.cu)
// on the tensor cores at f32 accuracy, and the warp-wide softmax passes of a
// chunk of (atom, neighbour) rows.
//
// Split TF32 ("3xTF32"). A warp-level mma.sync m16n8k8 takes TF32 operands
// (10 mantissa bits) and accumulates in f32. Each f32 operand is split into
// hi = tf32(x) and lo = tf32(x - hi), and a tile is the sum of three
// products, a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first; the term
// left out, a_lo b_lo, is 2^-22 of the product. This is the card's
// counterpart of a multi-pass f32 product on a matrix unit, and keeps the
// kernels within the tolerances they had with FP32 FMA loops.
//
// Layout of the row products (mma_gemm, mma_gemm_tB). The block's 8 warps
// split the output columns, 16 to a warp, so each weight element is fetched
// from global memory by one warp, once per product, straight into B
// fragments, 32 k-values ahead of the products that use them. Every warp
// walks all the rows (32 at a time: two m-tiles) and reads the left operand
// from shared memory as float4; a row stride of 4 mod 8 floats keeps those reads
// free of bank conflicts. Within a step of 32 k-values lane (g, t) owns the 8
// consecutive k-values 8t..8t+7 of both operands (the sum over k does not
// care which lane holds which k), and the warp's two n-tiles interleave their
// columns (tile j holds columns 2g + j), so a lane ends with 4 consecutive
// output columns of rows g and g + 8 and hands them to the epilogue as one
// float4, as tile_gemm does.
//
// The 32-column layout (mma_gemm_w32), taken by every forward build past 128
// columns (#1, the tall and wide #3, the narrow and wide #5), whose row
// products are bound by instruction issue: a warp owns 32 output columns,
// four n-tiles (tile j holds columns 4g + j), so at 256 columns the 8 warps
// cover a row in one pass and each A value is read from shared memory and
// split once a k-step, not once for every 16 columns. Its weights come as
// TF32 planes split once where the launch packs them (tf32_planes of the
// wrappers: hi = w rounded to TF32, lo = w - hi, so hi + lo == w, and w
// rounded to bfloat16 for the bf16 operand mode), in the order the lanes
// read them: a lane loads its 4 columns of one k-value as one float4 a
// plane, with one pointer step a half, no bounds checks (zero padding) and
// no other address arithmetic; k-values 2 and 3 of the next 16 load while
// this half's first m16n8k8 step runs, 0 and 1 into the registers that step
// frees. The lane hands lo over as split_tf32 does (its bits + 0x1000), and
// each half's partial starts from a zero accumulator as mma_gemm's does, so
// every fragment, and every sum in its order, is mma_gemm's bit for bit. A
// lane ends with 8 consecutive columns of rows g and g + 8: two float4s
// each. Its accumulators and partials take 64 registers a thread, 32 more
// than mma_gemm's, so the tall #3 spills more of the pointers it keeps
// across a chunk (PERF.md §6), none inside the loop.
//
// The bf16 operand mode (kBf16 of mma_gemm and mma_gemm_tB; the whole-model
// forwards at model.dtype "bfloat16", scann_tpu/kernels/dots.py): each
// operand element is rounded to bfloat16 (bf16r) and a tile is ONE TF32 pass.
// A bfloat16 value is exact in TF32 and the product of two is exact in f32,
// so the pass computes the bf16 product with f32 accumulation. (Native
// m16n8k16 bf16 fragments would halve the passes' operand traffic; that is
// speed work, not a change of the result.)
//
// Weight gradients (mma_gemm_tA, x^T dy, depth = the rows of a chunk): the
// warps split the 32-row x 64-column output tiles; each thread adds its sums
// into the block's gradient row as float4 (16 bytes a thread, 64 bytes a
// quad), the same thread for the same element at every call, so the sums
// repeat from run to run; in the backward kernel's builds of widths past
// 128 each add is a reduction the warp does not wait for (red_add4). The
// column sums of dy (the bias gradient) fall out of the same fragments. In
// the bf16 operand mode the backward kernels round
// the cotangent too, as the TPU kernels' transposed products do
// (scann_tpu/kernels/scann_backward.py:359-530): mma_gemm_tA<true> rounds
// both x and dy and makes one pass, while its column sums stay the sums of
// the unrounded dy, and mma_gemm_tB<true> rounds dy and W.

#pragma once

#include "scann_grad_common.cuh"

namespace scann {

// x = hi + lo, hi and lo rounded to TF32 (to nearest, ties away from zero)
// as cvt.rna.tf32.f32 rounds a finite value: add half a TF32 ulp to the bits
// and drop the 13 low mantissa bits. The instruction itself compiles to this
// plus a test for NaN and infinity on each value (7 instructions a split,
// measured in the SASS); without the test a split is 4, and a NaN or an
// infinity still comes out as a NaN. The tensor core ignores the 13 low bits
// of an operand, so lo is handed over with them still set.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a b (mma_tf32 into a zero accumulator, without zeroing c first)
__device__ __forceinline__ void mma_tf32_first(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                               unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// The bits of x rounded to bfloat16: a TF32 operand that is exact.
__device__ __forceinline__ unsigned bf16_bits(float x) { return __float_as_uint(bf16r(x)); }

// c += a b at f32 accuracy: three TF32 passes, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&ahi)[4],
                                           const unsigned (&alo)[4], const unsigned (&bhi)[2],
                                           const unsigned (&blo)[2]) {
  mma_tf32(c, alo, bhi[0], bhi[1]);
  mma_tf32(c, ahi, blo[0], blo[1]);
  mma_tf32(c, ahi, bhi[0], bhi[1]);
}

// dst[0..3] += v without reading dst back (a RED.ADD, fire and forget): the
// backward kernels of widths past 128 add their weight gradients, LayerNorm
// partials and d(layer input) partials this way. Every element is added to
// by one thread, in program order, so the sums and their order are those of
// a load, an add and a store; the warp goes on without waiting for L2. (The
// reduction flushes a subnormal sum to zero.)
__device__ __forceinline__ void red_add4(float* dst, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(dst), v);
}
__device__ __forceinline__ void red_add(float* dst, float v) { atomicAdd(dst, v); }

constexpr int kMmaMTiles = 2;      // m-tiles of 16 rows a warp holds at once
constexpr int kMmaStage = 32;      // k-values per step of the B prefetch

// Two consecutive weights as f32 (p 8-byte aligned for float, 4-byte for bfloat16).
__device__ __forceinline__ float2 ldg_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// Four consecutive values of a row of W, those at k >= K read as zero. p is
// 16-byte aligned wherever all four are inside.
__device__ __forceinline__ float4 load4_guarded(const float* p, int k, int K) {
  if (k + 4 <= K) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k < K) v.x = p[0];
  if (k + 1 < K) v.y = p[1];
  if (k + 2 < K) v.z = p[2];
  return v;
}

// The shared body of mma_gemm (kTransB false: W[k * ldw + n], of element
// type TW, float or bfloat16) and mma_gemm_tB (kTransB true: W[n * ldw + k],
// float, rows n >= nvalid read as zero); kBf16 the operand mode above. The
// tensor cores add into their accumulator with truncation, so every 16
// k-values (6 mma, 2 in the bf16 mode) start from a zero accumulator and
// join the running sum by a rounded FP32 addition.
template <bool kTransB, bool kBf16, typename TW, typename Epi>
__device__ __forceinline__ void mma_gemm_body(const float* A, int lda, int rows, int K,
                                              const TW* __restrict__ W, int ldw, int nc,
                                              int nvalid, Epi epi) {
  static_assert(!kTransB || sizeof(TW) == sizeof(float), "mma_gemm_tB reads float weights");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int n0 = warp * 16; n0 < nc; n0 += kWarps * 16) {
    const int na = n0 + 2 * g;       // the lane's B columns: na (tile 0), na + 1 (tile 1)

    // the lane's 8 k-values of both tiles for the step at ks: b[j][i] = B[ks + 8t + i][na + j]
    auto load_b = [&](int ks, float (&b)[2][8]) {
      const int k0 = ks + 8 * t;
      if constexpr (kTransB) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float4 lo4 = make_float4(0.f, 0.f, 0.f, 0.f), hi4 = lo4;
          if (na + j < nvalid && na + j < nc) {
            const float* p = W + (size_t)(na + j) * ldw + k0;
            if (k0 + 8 <= K) {
              lo4 = __ldg(reinterpret_cast<const float4*>(p));
              hi4 = __ldg(reinterpret_cast<const float4*>(p + 4));
            } else {
              lo4 = load4_guarded(p, k0, K);
              hi4 = load4_guarded(p + 4, k0 + 4, K);
            }
          }
          b[j][0] = lo4.x; b[j][1] = lo4.y; b[j][2] = lo4.z; b[j][3] = lo4.w;
          b[j][4] = hi4.x; b[j][5] = hi4.y; b[j][6] = hi4.z; b[j][7] = hi4.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float2 v = make_float2(0.f, 0.f);
          if (k0 + i < K && na < nc)   // nc is even, so na + 1 < nc too
            v = ldg_pair(W + (size_t)(k0 + i) * ldw + na);
          b[0][i] = v.x;
          b[1][i] = v.y;
        }
      }
    };

    // up to 32 rows at a time (two m-tiles); taller operands take another pass
#pragma unroll 1
    for (int m0 = 0; m0 < rows; m0 += 16 * kMmaMTiles) {
      float acc[kMmaMTiles][2][4];
#pragma unroll
      for (int mt = 0; mt < kMmaMTiles; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
      float bcur[2][8], bnext[2][8];
      load_b(0, bcur);
#pragma unroll 1
      for (int ks = 0; ks < K; ks += kMmaStage) {
        const bool more = ks + kMmaStage < K;
        if (more) load_b(ks + kMmaStage, bnext);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kc = ks + 8 * t + 4 * half;
          // the lane's 4 k-values of rows g and g + 8 of every m-tile
          float4 av[kMmaMTiles][2];
          float part[kMmaMTiles][2][4];
#pragma unroll
          for (int mt = 0; mt < kMmaMTiles; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = m0 + mt * 16 + g + 8 * h;
              av[mt][h] = r < rows && kc < K ? *reinterpret_cast<const float4*>(A + r * lda + kc)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) part[mt][j][i] = 0.f;
          }
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            // one m16n8k8 step: k-slot t is the lane's value 2 kk, slot t + 4 its value 2 kk + 1
            if constexpr (kBf16) {
              unsigned b[2][2];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                b[j][0] = bf16_bits(bcur[j][4 * half + 2 * kk]);
                b[j][1] = bf16_bits(bcur[j][4 * half + 2 * kk + 1]);
              }
#pragma unroll
              for (int mt = 0; mt < kMmaMTiles; ++mt) {
                const float4 r0 = av[mt][0], r1 = av[mt][1];
                const unsigned a[4] = {bf16_bits(kk ? r0.z : r0.x), bf16_bits(kk ? r1.z : r1.x),
                                       bf16_bits(kk ? r0.w : r0.y), bf16_bits(kk ? r1.w : r1.y)};
                mma_tf32(part[mt][0], a, b[0][0], b[0][1]);
                mma_tf32(part[mt][1], a, b[1][0], b[1][1]);
              }
              continue;
            }
            unsigned bhi[2][2], blo[2][2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              split_tf32(bcur[j][4 * half + 2 * kk], bhi[j][0], blo[j][0]);
              split_tf32(bcur[j][4 * half + 2 * kk + 1], bhi[j][1], blo[j][1]);
            }
#pragma unroll
            for (int mt = 0; mt < kMmaMTiles; ++mt) {
              const float4 r0 = av[mt][0], r1 = av[mt][1];
              unsigned ahi[4], alo[4];
              split_tf32(kk ? r0.z : r0.x, ahi[0], alo[0]);
              split_tf32(kk ? r1.z : r1.x, ahi[1], alo[1]);
              split_tf32(kk ? r0.w : r0.y, ahi[2], alo[2]);
              split_tf32(kk ? r1.w : r1.y, ahi[3], alo[3]);
              mma_3xtf32(part[mt][0], ahi, alo, bhi[0], blo[0]);
              mma_3xtf32(part[mt][1], ahi, alo, bhi[1], blo[1]);
            }
          }
#pragma unroll
          for (int mt = 0; mt < kMmaMTiles; ++mt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[mt][j][i] += part[mt][j][i];
        }
        if (more) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 8; ++i) bcur[j][i] = bnext[j][i];
        }
      }
      // tile j, fragment column 2t (+1) is output column n0 + 4t + j (+2)
      const int c = n0 + 4 * t;
      if (c < nc) {
#pragma unroll
        for (int mt = 0; mt < kMmaMTiles; ++mt) {
          const int r = m0 + mt * 16 + g;
          if (r < rows)
            epi(r, c, make_float4(acc[mt][0][0], acc[mt][1][0], acc[mt][0][1], acc[mt][1][1]));
          if (r + 8 < rows)
            epi(r + 8, c, make_float4(acc[mt][0][2], acc[mt][1][2], acc[mt][0][3], acc[mt][1][3]));
        }
      }
    }
  }
}

// out[r][c] = sum_k A[r * lda + k] * W[k * ldw + c] for r < rows, c < nc (a
// multiple of 4), any K. A lives in shared memory, 16-byte aligned, lda a
// multiple of 4 and at least K rounded up to 4, with finite values in the
// columns between K and that; W in global memory (ldw a multiple of 4), float or
// bfloat16. Every finished quad goes to epi(row, col, value). No barrier
// inside: the caller synchronises before reading the results. kBf16: the
// bf16 operand mode.
template <bool kBf16 = false, typename TW, typename Epi>
__device__ __forceinline__ void mma_gemm(const float* A, int lda, int rows, int K,
                                         const TW* __restrict__ W, int ldw, int nc, Epi epi) {
  mma_gemm_body<false, kBf16>(A, lda, rows, K, W, ldw, nc, nc, epi);
}

// out[r][c] = sum_k A[r * lda + k] * W[c * ldw + k]: a product with the
// transpose of W, whose rows are read as float4. Rows c >= nvalid of W read
// as zero. kBf16: the bf16 operand mode.
template <bool kBf16 = false, typename Epi>
__device__ __forceinline__ void mma_gemm_tB(const float* A, int lda, int rows, int K,
                                            const float* __restrict__ W, int ldw, int nc,
                                            int nvalid, Epi epi) {
  mma_gemm_body<true, kBf16>(A, lda, rows, K, W, ldw, nc, nvalid, epi);
}

__device__ __forceinline__ float pick4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The packed TF32 planes of one weight W [R, nc] (kernels/scann_forward.py
// tf32_planes), in the order mma_gemm_w32 reads them: for each group of 32
// output columns and each half s of each step of 32 k-values (R and nc
// padded with zeros to multiples of 32), kW32Quads float4s a lane: q = 4p +
// i is plane p's row k = 32 (s / 2) + 8t + 4 (s % 2) + i at the lane's 4
// columns 32 G + 4g .. + 3, where plane 0 is hi = W rounded to TF32, plane 1
// lo = W - hi and plane 2 W rounded to bfloat16 (the bf16 operand mode's B
// operand); the lanes' float4s of one q lie side by side, so a load is 512
// contiguous bytes and a lane's next half is one pointer step on.
constexpr int kW32Quads = 12;
constexpr int kW32Block = kW32Quads * 32 * 4;   // floats of one half of one column group

__host__ __device__ inline size_t w32_plane_floats(int R, int nc) {
  return (size_t)((nc + 31) / 32) * 2 * ((R + 31) / 32) * kW32Block;
}

// mma_gemm in the 32-column layout above: out[r][c] = sum_k A[r * lda + k] *
// W[k][c] for r < rows, c < nc (a multiple of 4), K <= R, W given as its
// packed planes P, with mma_gemm's operands, passes and order of sums, so
// the outputs are its bits (kBf16: the bf16 operand mode, one pass on
// plane 2). A lives in shared memory as mma_gemm's. epi(r, c, v) takes each
// finished quad; no barrier inside.
template <bool kBf16, typename Epi>
__device__ __forceinline__ void mma_gemm_w32(const float* A, int lda, int rows, int K,
                                             const float* __restrict__ P, int nc, Epi epi) {
  constexpr int kNt = 4;   // n-tiles a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  // mma_gemm's halves of each step of 32 k-values, in its order: in half s
  // lane t holds k-values kc..kc+3, kc = 32 (s / 2) + 8t + 4 (s % 2)
  const int steps = 2 * ((K + kMmaStage - 1) / kMmaStage);
  const bool whole = (K & (kMmaStage - 1)) == 0;   // no k-value of A past K
#pragma unroll 1
  for (int n0 = warp * 8 * kNt; n0 < nc; n0 += kWarps * 8 * kNt) {
    // the lane's float4s of the column group, half 0
    const float4* pg = reinterpret_cast<const float4*>(P) +
                       (size_t)(n0 / 32) * steps * (kW32Block / 4) + lane;
    // k-value i of half s into bh, bl (hi and lo; kBf16: the bf16 plane)
    auto load_b = [&](int s, int i, float4& bh, float4& bl) {
      const float4* p = pg + (size_t)s * (kW32Block / 4);
      if constexpr (kBf16) {
        bh = __ldg(p + (8 + i) * 32);
      } else {
        bh = __ldg(p + i * 32);
        bl = __ldg(p + (4 + i) * 32);
      }
    };
    // up to 32 rows at a time (two m-tiles); taller operands take another pass
#pragma unroll 1
    for (int m0 = 0; m0 < rows; m0 += 16 * kMmaMTiles) {
      float acc[kMmaMTiles][kNt][4];
#pragma unroll
      for (int mt = 0; mt < kMmaMTiles; ++mt)
#pragma unroll
        for (int j = 0; j < kNt; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
      // the lane's row g at its k-value 8t; rows g + 8 i lie 8 i lda on
      const float* a0 = A + (m0 + g) * lda + 8 * t;
      const int live = rows - m0 - g;   // row g + 8 i is in the operand where 8 i < live
      // the current half's weights, and k-values 2 and 3 of the next half,
      // which load a half and a half ahead; its k-values 0 and 1 load into
      // the registers k-values 0 and 1 of this half free, once its first
      // m16n8k8 step is done
      float4 bh[4], bl[4], th[2], tl[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_b(0, i, bh[i], bl[i]);
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
        const int ko = (s >> 1) * kMmaStage + 4 * (s & 1);   // kc - 8t
        const bool more = s + 1 < steps;
        if (more) {
          load_b(s + 1, 2, th[0], tl[0]);
          load_b(s + 1, 3, th[1], tl[1]);
        }
        // the half's products into a partial that starts from zero, then the
        // partial into the sum
        float part[kMmaMTiles][kNt][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          // the lane's k-values 2 kk, 2 kk + 1 of rows g and g + 8 of each m-tile
          float2 av[kMmaMTiles][2];
#pragma unroll
          for (int mt = 0; mt < kMmaMTiles; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              av[mt][h] = 16 * mt + 8 * h < live && (whole || ko + 8 * t < K)
                              ? *reinterpret_cast<const float2*>(a0 + (16 * mt + 8 * h) * lda +
                                                                 ko + 2 * kk)
                              : make_float2(0.f, 0.f);
          // one m16n8k8 step: k-slot t is the lane's value 2 kk, slot t + 4 its value 2 kk + 1
          if constexpr (kBf16) {
            unsigned b[kNt][2];
#pragma unroll
            for (int j = 0; j < kNt; ++j) {
              b[j][0] = __float_as_uint(pick4(bh[2 * kk], j));
              b[j][1] = __float_as_uint(pick4(bh[2 * kk + 1], j));
            }
#pragma unroll
            for (int mt = 0; mt < kMmaMTiles; ++mt) {
              const float2 r0 = av[mt][0], r1 = av[mt][1];
              const unsigned a[4] = {bf16_bits(r0.x), bf16_bits(r1.x), bf16_bits(r0.y),
                                     bf16_bits(r1.y)};
#pragma unroll
              for (int j = 0; j < kNt; ++j) {
                if (kk == 0) mma_tf32_first(part[mt][j], a, b[j][0], b[j][1]);
                else mma_tf32(part[mt][j], a, b[j][0], b[j][1]);
              }
            }
          } else {
            unsigned bhi[kNt][2], blo[kNt][2];
#pragma unroll
            for (int j = 0; j < kNt; ++j) {
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                bhi[j][q] = __float_as_uint(pick4(bh[2 * kk + q], j));
                blo[j][q] = __float_as_uint(pick4(bl[2 * kk + q], j)) + 0x1000u;
              }
            }
#pragma unroll
            for (int mt = 0; mt < kMmaMTiles; ++mt) {
              const float2 r0 = av[mt][0], r1 = av[mt][1];
              unsigned ahi[4], alo[4];
              split_tf32(r0.x, ahi[0], alo[0]);
              split_tf32(r1.x, ahi[1], alo[1]);
              split_tf32(r0.y, ahi[2], alo[2]);
              split_tf32(r1.y, ahi[3], alo[3]);
#pragma unroll
              for (int j = 0; j < kNt; ++j) {
                // mma_3xtf32, the first pass of the half into a zero partial
                if (kk == 0) mma_tf32_first(part[mt][j], alo, bhi[j][0], bhi[j][1]);
                else mma_tf32(part[mt][j], alo, bhi[j][0], bhi[j][1]);
                mma_tf32(part[mt][j], ahi, blo[j][0], blo[j][1]);
                mma_tf32(part[mt][j], ahi, bhi[j][0], bhi[j][1]);
              }
            }
          }
          if (kk == 0 && more) {
            load_b(s + 1, 0, bh[0], bl[0]);
            load_b(s + 1, 1, bh[1], bl[1]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMmaMTiles; ++mt)
#pragma unroll
          for (int j = 0; j < kNt; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][j][i] += part[mt][j][i];
        if (more) {
          bh[2] = th[0];
          bh[3] = th[1];
          bl[2] = tl[0];
          bl[3] = tl[1];
        }
      }
      // tile j, fragment column 2t (+1) is output column n0 + 8t + j (+4)
      const int c = n0 + 8 * t;
#pragma unroll
      for (int mt = 0; mt < kMmaMTiles; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + mt * 16 + g + 8 * h;
          if (r >= rows) continue;
          if (c < nc)
            epi(r, c, make_float4(acc[mt][0][2 * h], acc[mt][1][2 * h], acc[mt][2][2 * h],
                                  acc[mt][3][2 * h]));
          if (c + 4 < nc)
            epi(r, c + 4, make_float4(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1],
                                      acc[mt][2][2 * h + 1], acc[mt][3][2 * h + 1]));
        }
      }
    }
  }
}

// Gout[i * ldg + j] (+)= sum_{r < rows} X[r * ldx + i] * Y[r * ldy + j] for
// i < I, j < J (J a multiple of 4): a weight gradient x^T dy. X and Y live
// in shared memory (ldy a multiple of 4); Gout is the block's own gradient
// row in global memory (16-byte aligned, ldg a multiple of 4), overwritten
// when accumulate is false. With colsum, colsum[j] (+)= sum_r Y[r * ldy + j]
// as well (sum_accumulate): the bias gradient that goes with Gout. kBf16:
// the bf16 operand mode (X and Y rounded, one TF32 pass; colsum unrounded).
template <bool kBf16 = false>
__device__ __forceinline__ void mma_gemm_tA(const float* X, int ldx, const float* Y, int ldy,
                                            int rows, int I, int J, float* Gout, int ldg,
                                            bool accumulate, float* colsum = nullptr,
                                            bool sum_accumulate = false) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  // a warp's unit of work: 32 rows x 64 columns of Gout (two m-tiles share the split of Y)
  const int ipairs = (I + 31) >> 5, jgroups = (J + 63) >> 6;
#pragma unroll 1
  for (int u = warp; u < ipairs * jgroups; u += kWarps) {
    const int i0 = (u / jgroups) * 32, j0 = (u % jgroups) * 64;
    const bool sums = colsum != nullptr && i0 == 0;
    float acc[2][8][4];
    float cs[4][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][p][i] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) cs[p][0] = cs[p][1] = 0.f;
#pragma unroll 1
    for (int r0 = 0; r0 < rows; r0 += 8) {
      // k-slot t is row r0 + 2t, slot t + 4 row r0 + 2t + 1
      const int ra = r0 + 2 * t, rb = ra + 1;
      const bool va = ra < rows, vb = rb < rows;
      unsigned ahi[2][4], alo[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int ia = i0 + 16 * m + g, ib = ia + 8;
        if constexpr (kBf16) {
          ahi[m][0] = bf16_bits(va && ia < I ? X[ra * ldx + ia] : 0.f);
          ahi[m][1] = bf16_bits(va && ib < I ? X[ra * ldx + ib] : 0.f);
          ahi[m][2] = bf16_bits(vb && ia < I ? X[rb * ldx + ia] : 0.f);
          ahi[m][3] = bf16_bits(vb && ib < I ? X[rb * ldx + ib] : 0.f);
        } else {
          split_tf32(va && ia < I ? X[ra * ldx + ia] : 0.f, ahi[m][0], alo[m][0]);
          split_tf32(va && ib < I ? X[ra * ldx + ib] : 0.f, ahi[m][1], alo[m][1]);
          split_tf32(vb && ia < I ? X[rb * ldx + ia] : 0.f, ahi[m][2], alo[m][2]);
          split_tf32(vb && ib < I ? X[rb * ldx + ib] : 0.f, ahi[m][3], alo[m][3]);
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // a pair of n-tiles over 16 columns: tile jj holds columns 2g + jj
        const int jc = j0 + 16 * p + 2 * g;
        float2 ya = make_float2(0.f, 0.f), yb = ya;
        if (jc < J) {
          if (va) ya = *reinterpret_cast<const float2*>(Y + ra * ldy + jc);
          if (vb) yb = *reinterpret_cast<const float2*>(Y + rb * ldy + jc);
        }
        if (sums) {
          cs[p][0] += ya.x;
          cs[p][0] += yb.x;
          cs[p][1] += ya.y;
          cs[p][1] += yb.y;
        }
        if constexpr (kBf16) {
          const unsigned b0a = bf16_bits(ya.x), b0b = bf16_bits(yb.x);
          const unsigned b1a = bf16_bits(ya.y), b1b = bf16_bits(yb.y);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_tf32(acc[m][2 * p], ahi[m], b0a, b0b);
            mma_tf32(acc[m][2 * p + 1], ahi[m], b1a, b1b);
          }
        } else {
          unsigned bhi[2][2], blo[2][2];
          split_tf32(ya.x, bhi[0][0], blo[0][0]);
          split_tf32(yb.x, bhi[0][1], blo[0][1]);
          split_tf32(ya.y, bhi[1][0], blo[1][0]);
          split_tf32(yb.y, bhi[1][1], blo[1][1]);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_3xtf32(acc[m][2 * p], ahi[m], alo[m], bhi[0], blo[0]);
            mma_3xtf32(acc[m][2 * p + 1], ahi[m], alo[m], bhi[1], blo[1]);
          }
        }
      }
    }
    if constexpr (kLaneValues > 4) {
      // the builds of widths past 128: each quad goes in as a reduction
      // (red_add4), so the warp does not wait for the row's old values
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int jw = j0 + 16 * p + 4 * t;
#pragma unroll
        for (int mh = 0; mh < 4; ++mh) {
          const int m = mh >> 1, h = mh & 1, i = i0 + 16 * m + g + 8 * h;
          if (jw < J && i < I) {
            const float4 v = make_float4(acc[m][2 * p][2 * h], acc[m][2 * p + 1][2 * h],
                                         acc[m][2 * p][2 * h + 1], acc[m][2 * p + 1][2 * h + 1]);
            if (accumulate) red_add4(Gout + (size_t)i * ldg + jw, v);
            else store4(Gout + (size_t)i * ldg + jw, make_float4(0.f + v.x, 0.f + v.y, 0.f + v.z,
                                                                 0.f + v.w));
          }
        }
      }
    } else {
    // add into the gradient row, 8 quads at a time: all the loads of a batch
    // are started before its first store, so they wait for L2 together
#pragma unroll
    for (int pp = 0; pp < 4; pp += 2) {
      float4 prev[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int jw = j0 + 16 * (pp + q) + 4 * t;
#pragma unroll
        for (int mh = 0; mh < 4; ++mh) {
          const int i = i0 + 16 * (mh >> 1) + g + 8 * (mh & 1);
          prev[q][mh] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (accumulate && jw < J && i < I)
            prev[q][mh] = __ldcg(reinterpret_cast<const float4*>(Gout + (size_t)i * ldg + jw));
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p = pp + q, jw = j0 + 16 * p + 4 * t;
#pragma unroll
        for (int mh = 0; mh < 4; ++mh) {
          const int m = mh >> 1, h = mh & 1;
          const int i = i0 + 16 * m + g + 8 * h;
          if (jw < J && i < I) {
            const float4 o = prev[q][mh];
            store4(Gout + (size_t)i * ldg + jw,
                   make_float4(o.x + acc[m][2 * p][2 * h], o.y + acc[m][2 * p + 1][2 * h],
                               o.z + acc[m][2 * p][2 * h + 1], o.w + acc[m][2 * p + 1][2 * h + 1]));
          }
        }
      }
    }
    }
    if (sums) {
      // the 4 lanes of a quad hold the rows' slices of columns jc, jc + 1: a fixed tree
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float s = cs[p][q];
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          const int j = j0 + 16 * p + 2 * g + q;
          if (t == 0 && j < J) colsum[j] = sum_accumulate ? colsum[j] + s : s;
        }
      }
    }
  }
}

// Energies and max-shifted softmax of one chunk, one warp per (atom, head),
// lane n holding neighbour n (N <= 32):
//   e[n] = sum_j (q[j] * dk) * key[n][j] - 1e9 (1 - nmask[n]),  sE[(at N + n) H + h] = softmax_n e.
// sQ [ca, ldq] are the chunk's queries, sKey [ca N, ldk] its keys, nmask
// points at the chunk's first row. kBf16: each product rounded to bfloat16
// before the head sum (the TPU kernels' product with the 0/1 head map), as
// the forwards' fwd_chunk rounds it. The caller synchronises.
template <bool kBf16 = false>
__device__ __forceinline__ void warp_energy_softmax(const float* sQ, int ldq, const float* sKey,
                                                    int ldk, const float* nmask, float* sE, int ca,
                                                    int N, int H, int hd, float dk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < ca * H; i += kWarps) {
    const int at = i / H, h = i - at * H, r = at * N + lane;
    float e = -INFINITY;
    if (lane < N) {
      const float* q = sQ + at * ldq + h * hd;
      const float* kk = sKey + r * ldk + h * hd;
      e = 0.f;
      if (kBf16) {
        for (int j = 0; j < hd; ++j) e += bf16r((q[j] * dk) * kk[j]);
      } else {
        for (int j = 0; j < hd; ++j) e = fmaf(q[j] * dk, kk[j], e);
      }
      e += (1.0f - nmask[r]) * -1e9f;
    }
    const float mx = warp_max(e);
    const float p = lane < N ? expf(e - mx) : 0.f;
    const float s = warp_sum(p);
    if (lane < N) sE[r * H + h] = p / s;
  }
}

// d attention and the softmax backward of one chunk, one warp per (atom,
// head), on the attention before dropout sE:
//   f[n] = nmask[n] * drop[n] * sum_j dctx[j] * key[n][j],  sF[..] = p[n] (f[n] - sum_n p f).
// sDrop (or null) is the attention dropout mask [ca N, H]. kBf16: each
// product dctx * key rounded before the head sum, and sF rounded (the TPU
// kernels expand d energy to lanes as a bf16-mode product,
// scann_backward.py:446-452). The caller synchronises.
template <bool kBf16 = false>
__device__ __forceinline__ void warp_softmax_backward(const float* sDCtx, int ldq,
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
      if (kBf16) {
        for (int j = 0; j < hd; ++j) f += bf16r(dq[j] * kk[j]);
      } else {
        for (int j = 0; j < hd; ++j) f = fmaf(dq[j], kk[j], f);
      }
      f *= nmask[r];
      if (sDrop) f *= sDrop[r * H + h];
      p = sE[r * H + h];
    }
    const float s = warp_sum(p * f);
    if (lane < N) sF[r * H + h] = operand<kBf16>(p * (f - s));
  }
}

// ---- wide neighbour lists ---------------------------------------------------
// Where one atom's N neighbours exceed a chunk of rows (the wide instantiations
// of kernels #3, #4 and #5, N <= kWideMaxN), its rows go through the chunk
// code in sub-chunks, and the softmax over all N runs from an energy row
// [N, H] kept in shared memory: every energy of the atom first, then one warp
// per head over all N, lane n holding neighbours n, n + 32, ... (at most
// kWideMaxN / 32 a lane). The sums run lane by lane in that order, then
// across the warp in warp_sum's fixed tree (kernels.local_attention.
// wide_softmax mirrors the arithmetic in PyTorch). A wholly masked sub-chunk
// cannot shift the max (the max runs over all N at once), and an atom whose
// neighbours are all masked gets the plain version's near-uniform softmax.
constexpr int kWideMaxN = 256;
constexpr int kWideLane = kWideMaxN / 32;

// Energies of `rows` rows of one atom, one warp per head, lane r holding rows
// r, r + 32, ...: e[r] = sum_j (q[j] * dk) * key[r][j] - 1e9 (1 - nmask[r])
// into sEn[r H + h], with the arithmetic of warp_energy_softmax (kBf16: each
// product rounded before the head sum). q is the atom's query row, sKey
// [rows, ldk] the rows' keys, nmask the rows' mask. The caller synchronises.
template <bool kBf16, typename T>
__device__ __forceinline__ void warp_energies(const float* q, const float* sKey, int ldk,
                                              const T* nmask, float* sEn, int rows, int H, int hd,
                                              float dk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = warp; h < H; h += kWarps)
    for (int r = lane; r < rows; r += 32) {
      const float* qh = q + h * hd;
      const float* kk = sKey + r * ldk + h * hd;
      float e = 0.f;
      if (kBf16) {
        for (int j = 0; j < hd; ++j) e += bf16r((qh[j] * dk) * kk[j]);
      } else {
        for (int j = 0; j < hd; ++j) e = fmaf(qh[j] * dk, kk[j], e);
      }
      sEn[r * H + h] = e + (1.0f - to_float(nmask[r])) * -1e9f;
    }
}

// The max-shifted softmax over the N energies sEn [N, H] of one atom, one
// warp per head; out(n, h, p) takes each probability (before dropout and the
// neighbour mask). The caller synchronises.
template <typename Out>
__device__ __forceinline__ void wide_softmax(const float* sEn, int N, int H, Out out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = warp; h < H; h += kWarps) {
    float e[kWideLane], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kWideLane; ++j) {
      const int n = lane + 32 * j;
      e[j] = n < N ? sEn[n * H + h] : -INFINITY;
      mx = fmaxf(mx, e[j]);
    }
    mx = warp_max(mx);
    float tot = 0.f;
#pragma unroll
    for (int j = 0; j < kWideLane; ++j) {
      e[j] = lane + 32 * j < N ? expf(e[j] - mx) : 0.f;
      tot += e[j];
    }
    tot = warp_sum(tot);
#pragma unroll
    for (int j = 0; j < kWideLane; ++j)
      if (lane + 32 * j < N) out(lane + 32 * j, h, e[j] / tot);
  }
}

// d attention of `rows` rows of one atom, one warp per head, lane r holding
// rows r, r + 32, ...: sF[r H + h] = nmask[r] * drop[r] * sum_j dctx[j] *
// key[r][j] (warp_softmax_backward's f; kBf16: each product rounded). dctx is
// the atom's d ctx row, sDrop (or null) the rows' attention dropout mask. The
// caller synchronises.
template <bool kBf16>
__device__ __forceinline__ void warp_attention_grad(const float* dctx, const float* sKey, int ldk,
                                                    const float* nmask, const float* sDrop,
                                                    float* sF, int rows, int H, int hd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = warp; h < H; h += kWarps)
    for (int r = lane; r < rows; r += 32) {
      const float* dq = dctx + h * hd;
      const float* kk = sKey + r * ldk + h * hd;
      float f = 0.f;
      if (kBf16) {
        for (int j = 0; j < hd; ++j) f += bf16r(dq[j] * kk[j]);
      } else {
        for (int j = 0; j < hd; ++j) f = fmaf(dq[j], kk[j], f);
      }
      f *= nmask[r];
      if (sDrop) f *= sDrop[r * H + h];
      sF[r * H + h] = f;
    }
}

// The softmax backward over all N neighbours of one atom, one warp per head,
// from its attention sP [N, H] (before dropout) and d attention sF [N, H]:
// sF[n H + h] = p[n] (f[n] - sum_n p f), the sum lane by lane as in
// wide_softmax. The caller synchronises.
template <bool kBf16>
__device__ __forceinline__ void wide_softmax_backward(const float* sP, float* sF, int N, int H) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = warp; h < H; h += kWarps) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kWideLane; ++j) {
      const int n = lane + 32 * j;
      if (n < N) s += sP[n * H + h] * sF[n * H + h];
    }
    s = warp_sum(s);
#pragma unroll
    for (int j = 0; j < kWideLane; ++j) {
      const int n = lane + 32 * j;
      if (n < N) sF[n * H + h] = operand<kBf16>(sP[n * H + h] * (sF[n * H + h] - s));
    }
  }
}

#ifdef SCANN_MMA_SELFTEST
// One block multiplies A [rows, K] by W [K, nc] (mma_gemm), by WT [nc, K]
// transposed (mma_gemm_tB), and forms A^T Y with Y [rows, nc] and Y's column
// sums (mma_gemm_tA, twice: overwrite, then accumulate, so out_ta holds
// twice the product), through shared memory with the kernels' padded strides.
static __global__ void __launch_bounds__(kThreads, 1)
mma_selftest_kernel(const float* A, const float* W, const float* WT, const float* Y,
                    float* out_g, float* out_tb, float* out_ta, float* out_sum, int rows, int K,
                    int nc) {
  extern __shared__ float4 selftest_smem4[];
  float* sA = reinterpret_cast<float*>(selftest_smem4);
  const int lda = round4(K) + 4, ldy = nc + 4;
  float* sY = sA + rows * lda;
  for (int i = threadIdx.x; i < rows * K; i += kThreads) sA[(i / K) * lda + i % K] = A[i];
  for (int i = threadIdx.x; i < rows * nc; i += kThreads) sY[(i / nc) * ldy + i % nc] = Y[i];
  __syncthreads();
  mma_gemm(sA, lda, rows, K, W, nc, nc,
           [&](int r, int c, float4 v) { store4(out_g + (size_t)r * nc + c, v); });
  mma_gemm_tB(sA, lda, rows, K, WT, K, nc, nc,
              [&](int r, int c, float4 v) { store4(out_tb + (size_t)r * nc + c, v); });
  mma_gemm_tA(sA, lda, sY, ldy, rows, K, nc, out_ta, nc, false, out_sum, false);
  __syncthreads();
  mma_gemm_tA(sA, lda, sY, ldy, rows, K, nc, out_ta, nc, true, out_sum, true);
}

inline int launch_mma_selftest(const float* A, const float* W, const float* WT, const float* Y,
                               float* out_g, float* out_tb, float* out_ta, float* out_sum,
                               int rows, int K, int nc, cudaStream_t s) {
  if (rows < 1 || rows > 64 || K < 4 || (K & 3) || nc < 4 || (nc & 3)) return kErrShape;
  const int bytes = (rows * (round4(K) + 4) + rows * (nc + 4)) * (int)sizeof(float);
  if (bytes > kMaxSharedBytes) return kErrSharedMemory;
  cudaError_t err = cudaFuncSetAttribute(mma_selftest_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  mma_selftest_kernel<<<1, kThreads, bytes, s>>>(A, W, WT, Y, out_g, out_tb, out_ta, out_sum,
                                                 rows, K, nc);
  return (int)cudaGetLastError();
}
#endif  // SCANN_MMA_SELFTEST

}  // namespace scann
