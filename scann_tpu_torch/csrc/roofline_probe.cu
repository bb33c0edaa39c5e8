// Probes of the card's achievable rates, for utils/roofline.py
// (measure_device_rates): the counterpart of the jnp op chains of
// scann_tpu/utils/roofline.py:69 measure_device_rates. Not a port of a TPU
// kernel: the JAX probes are chains that XLA fuses into one loop, and in
// eager PyTorch every op of such a chain would be a kernel of its own that
// streams its operand through HBM, so the chains are written here.
//
// Five probes, each a kernel with a plain C launcher:
//   - roofline_fma:    CHAINS independent dependent chains y = y * a + b a
//                      thread (one FP32 FMA each step) on the CUDA cores;
//   - roofline_exp:    the same with y = expf(-y), the expf the port's
//                      kernels call (one special-function instruction each);
//   - roofline_mma:    MMA_CHAINS dependent chains of
//                      mma.sync.aligned.m16n8k8 TF32 products a warp, from
//                      registers: the instruction of csrc/scann_mma.cuh;
//   - roofline_mma_bf16: the same chains of mma.sync.aligned.m16n8k16 with
//                      bfloat16 operands, the card's dense BF16 rate (the
//                      bound of the kernels' bf16 operand mode);
//   - roofline_stream: x = x * a + b over a buffer (a grid-stride loop, four
//                      float4s a thread in flight), each element read and
//                      written once a pass.
// The caller launches each at two depths and takes the difference of the
// times (the JAX module's two-depth difference): it cancels the launch, the
// store of the result and any fixed cost. Values stay finite and away from
// denormals (y = y*0.999 + 1e-3 stays near 1, exp(-y) converges to 0.567).
// The chains' results are stored, so the compiler keeps every step.
//
// Each launcher returns cudaGetLastError() after the launch (0 on success)
// and launches on the stream it is given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAINS = 8;      // independent chains a thread (fma, exp)
constexpr int UNROLL = 16;     // steps of every chain per loop iteration
constexpr int MMA_CHAINS = 8;  // independent accumulators a warp (mma)
constexpr int MMA_UNROLL = 4;

__global__ void fma_chain(float* out, int iters, float a, float b) {
  float y[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) y[c] = 0.5f + 1e-3f * (threadIdx.x & 31) + 0.1f * c;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) y[c] = fmaf(y[c], a, b);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += y[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void exp_chain(float* out, int iters) {
  float y[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) y[c] = 0.5f + 1e-3f * (threadIdx.x & 31) + 0.1f * c;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) y[c] = expf(-y[c]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += y[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__global__ void mma_chain(float* out, int iters) {
  const int lane = threadIdx.x & 31;
  unsigned a[4], b[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = to_tf32(1e-3f * (lane + j));
#pragma unroll
  for (int j = 0; j < 2; ++j) b[j] = to_tf32(1e-3f * (lane - j));
  float acc[MMA_CHAINS][4];
#pragma unroll
  for (int c = 0; c < MMA_CHAINS; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < MMA_UNROLL; ++u) {
#pragma unroll
      for (int c = 0; c < MMA_CHAINS; ++c)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < MMA_CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ __forceinline__ unsigned to_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__global__ void mma_bf16_chain(float* out, int iters) {
  const int lane = threadIdx.x & 31;
  unsigned a[4], b[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = to_bf16x2(1e-3f * (lane + j), 1e-3f * (lane - j));
#pragma unroll
  for (int j = 0; j < 2; ++j) b[j] = to_bf16x2(1e-3f * (lane - j), 1e-3f * (lane + j));
  float acc[MMA_CHAINS][4];
#pragma unroll
  for (int c = 0; c < MMA_CHAINS; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < MMA_UNROLL; ++u) {
#pragma unroll
      for (int c = 0; c < MMA_CHAINS; ++c)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < MMA_CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// Four float4s a thread in flight per step of the grid-stride loop: the
// loads of a step are issued before its stores.
constexpr int STREAM_UNROLL = 4;

__global__ void stream_pass(float4* x, int64_t n4, float a, float b) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += STREAM_UNROLL * stride) {
    float4 v[STREAM_UNROLL];
#pragma unroll
    for (int u = 0; u < STREAM_UNROLL; ++u)
      if (i + u * stride < n4) v[u] = x[i + u * stride];
#pragma unroll
    for (int u = 0; u < STREAM_UNROLL; ++u) {
      v[u].x = fmaf(v[u].x, a, b);
      v[u].y = fmaf(v[u].y, a, b);
      v[u].z = fmaf(v[u].z, a, b);
      v[u].w = fmaf(v[u].w, a, b);
    }
#pragma unroll
    for (int u = 0; u < STREAM_UNROLL; ++u)
      if (i + u * stride < n4) x[i + u * stride] = v[u];
  }
}

}  // namespace

extern "C" {

// The chain constants, for the caller's operation counts: [CHAINS, UNROLL,
// MMA_CHAINS, MMA_UNROLL].
void roofline_shape(int* shape) {
  shape[0] = CHAINS;
  shape[1] = UNROLL;
  shape[2] = MMA_CHAINS;
  shape[3] = MMA_UNROLL;
}

// out: blocks * threads floats. threads a multiple of 32.
int roofline_fma(float* out, int blocks, int threads, int iters, float a, float b,
                 cudaStream_t stream) {
  fma_chain<<<blocks, threads, 0, stream>>>(out, iters, a, b);
  return (int)cudaGetLastError();
}

int roofline_exp(float* out, int blocks, int threads, int iters, cudaStream_t stream) {
  exp_chain<<<blocks, threads, 0, stream>>>(out, iters);
  return (int)cudaGetLastError();
}

int roofline_mma(float* out, int blocks, int threads, int iters, cudaStream_t stream) {
  mma_chain<<<blocks, threads, 0, stream>>>(out, iters);
  return (int)cudaGetLastError();
}

int roofline_mma_bf16(float* out, int blocks, int threads, int iters, cudaStream_t stream) {
  mma_bf16_chain<<<blocks, threads, 0, stream>>>(out, iters);
  return (int)cudaGetLastError();
}

// x: n4 float4s (16-byte aligned).
int roofline_stream(float* x, long long n4, int blocks, int threads, float a, float b,
                    cudaStream_t stream) {
  stream_pass<<<blocks, threads, 0, stream>>>(reinterpret_cast<float4*>(x), (int64_t)n4, a, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
