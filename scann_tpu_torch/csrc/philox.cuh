// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11), written out by hand so that the CUDA kernels and the PyTorch
// version in scann_tpu_torch/ops/dropout.py draw bit-identical dropout masks.
//
// A mask element is keyed on (seed, global molecule index) and counted by
// (element index / 4, stream, 0, 0); it takes word (element index % 4) of the
// output and is kept when that word is below uint32(keep * (2^32 - 1)).
// Streams: 0 is the embedding mask, 1 + l the residual mask of layer l and
// 1 + L + l the attention mask of layer l. A mask therefore depends only on
// (seed, molecule, stream, element), never on how a batch is tiled.

#pragma once

#include <stdint.h>

namespace scann_philox {

struct U4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ U4 philox4x32_10(U4 c, uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

// The four consecutive mask words of elements 4*quad .. 4*quad+3 of one
// stream of one molecule.
__device__ __forceinline__ U4 mask_words(uint32_t seed, uint32_t mol, uint32_t stream,
                                         uint32_t quad) {
  return philox4x32_10(U4{quad, stream, 0u, 0u}, seed, mol);
}

__device__ __forceinline__ uint32_t word_of(const U4& u, int i) {
  return i == 0 ? u.x : (i == 1 ? u.y : (i == 2 ? u.z : u.w));
}

// The scaled mask value (0 or 1 / keep) of one element.
__device__ __forceinline__ float mask_value(uint32_t seed, uint32_t mol, uint32_t stream,
                                            uint32_t elem, uint32_t threshold, float scale) {
  const U4 u = mask_words(seed, mol, stream, elem >> 2);
  return word_of(u, elem & 3) < threshold ? scale : 0.f;
}

// The scaled mask values of the four elements 4*quad .. 4*quad+3.
__device__ __forceinline__ float4 mask_quad(uint32_t seed, uint32_t mol, uint32_t stream,
                                            uint32_t quad, uint32_t threshold, float scale) {
  const U4 u = mask_words(seed, mol, stream, quad);
  return make_float4(u.x < threshold ? scale : 0.f, u.y < threshold ? scale : 0.f,
                     u.z < threshold ? scale : 0.f, u.w < threshold ? scale : 0.f);
}

}  // namespace scann_philox
