// Shared device code of the QSGD kernels (qsgd.cu, bitpack.cu): the per-row
// max-abs scale and the stochastic-rounding code of one element.
//
// Bit-exactness with the reference: the code is
//     q = floor(x / max(scale, 1e-30) * levels + u)
// evaluated left to right with one IEEE round-to-nearest per operation,
// written with the _rn intrinsics so that no multiply-add is contracted
// into an FMA (the build passes -fmad=false as well).  The float -> int8
// conversion saturates to [-128, 127], as XLA's convert does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Max of |x[lo:hi)| over the whole block; every thread gets the result.
// blockDim.x must be a multiple of 32 and at most 1024.
__device__ __forceinline__ float block_absmax(const float* __restrict__ x,
                                              long long lo, long long hi) {
  __shared__ float warp_max[32];
  float m = 0.0f;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    m = fmaxf(m, fabsf(x[i]));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    m = lane < nwarps ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == 0) warp_max[0] = m;
  }
  __syncthreads();
  return warp_max[0];
}

// One element's QSGD code; ``s`` is max(scale, 1e-30).
__device__ __forceinline__ int qsgd_code(float x, float u, float s,
                                         float levels) {
  const float y = __fmul_rn(__fdiv_rn(x, s), levels);
  float q = floorf(__fadd_rn(y, u));
  q = fminf(fmaxf(q, -128.0f), 127.0f);
  return (int)q;
}

}  // namespace repro
