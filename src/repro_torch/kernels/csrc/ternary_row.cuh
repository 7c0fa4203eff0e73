// Shared device code of the ternarize kernels (ternary.cu, bitpack.cu):
// one element's ternary code and the warp reductions of the per-row
// partial sums.
//
//     keep = |x| >= t,   code = sign(x) * keep,   psum += |x| * keep,
//     pcnt += keep
//
// sign(+-0) is 0, so a negative zero codes 0 (as jnp.sign(-0.0) * keep
// does); a copysign-style sign would give -1.  Pad lanes past n are read as
// +0.0, so they code 0 for any threshold and are counted in pcnt exactly
// when t <= 0, as the reference's zero-padded rows are.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kRowWarps = 8;   // one warp per row, 8 rows per 256-thread block

__device__ __forceinline__ int tern_code(float v, float t, float* psum,
                                         int* pcnt) {
  const float m = fabsf(v);
  if (m >= t) {
    *psum = __fadd_rn(*psum, m);
    *pcnt += 1;
    return (v > 0.0f) - (v < 0.0f);
  }
  return 0;
}

// x[i .. i+3] with lanes past n read as 0; a 16-byte load when the four
// lie inside the vector and ``aligned`` (x + i on a 16-byte boundary).
__device__ __forceinline__ float4 load4(const float* __restrict__ x,
                                        long long i, long long n,
                                        bool aligned) {
  if (aligned && i + 4 <= n) {
    return *reinterpret_cast<const float4*>(x + i);
  }
  float4 v;
  v.x = i < n ? x[i] : 0.0f;
  v.y = i + 1 < n ? x[i + 1] : 0.0f;
  v.z = i + 2 < n ? x[i + 2] : 0.0f;
  v.w = i + 3 < n ? x[i + 3] : 0.0f;
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Lane 0 of the row's warp writes the row's partial sums.
__device__ __forceinline__ void store_partials(float s, int c, long long row,
                                               float* __restrict__ psum,
                                               float* __restrict__ pcnt) {
  s = warp_sum(s);
  c = warp_sum(c);
  if ((threadIdx.x & 31) == 0) {
    psum[row] = s;
    pcnt[row] = (float)c;
  }
}

}  // namespace repro
