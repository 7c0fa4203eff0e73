// QSGD stochastic uniform quantization with a per-row max-abs scale:
//     scale_r = max_i |x_ri|,   q = floor(x / max(scale_r, 1e-30) * L + u)
// with L = 2^(bits-1) - 1 and the uniforms u given as an input.
//
// Replaces the TPU kernel src/repro/kernels/qsgd.py qsgd_quantize_blocked
// (pl.pallas_call at :41).  The Pallas version takes 8 rows of a padded
// (nb, block) matrix per grid step.  Here one CUDA block owns one logical
// row of ``blk`` elements of the flat vector (the last row may be short):
// a shared-memory max-reduce, then the elementwise pass.  Lanes past n are
// the payload's pad lanes and are written as code 0, so the int8 payload is
// the full (nb, blk) matrix of the reference.
//
// Bound: bytes.  Reads x and u (8 B per element) and writes the int8 code
// (1 B) plus one f32 scale per row: about 9 B per element, 9 n / 3.35 TB/s
// on an H100 SXM.  The second read of x in the elementwise pass hits L1/L2
// (a row is at most 8 KB), so device memory sees each input once.
#include "qsgd_row.cuh"

namespace {

__global__ void qsgd_quantize_rows(const float* __restrict__ x,
                                   const float* __restrict__ u,
                                   int8_t* __restrict__ q,
                                   float* __restrict__ scale, long long n,
                                   int blk, float levels) {
  const long long row = blockIdx.x;
  const long long lo = row * blk;
  const long long hi = lo + blk < n ? lo + blk : n;
  const float smax = repro::block_absmax(x, lo, hi);
  const float s = fmaxf(smax, 1e-30f);
  for (int j = threadIdx.x; j < blk; j += blockDim.x) {
    const long long i = lo + j;
    q[i] = i < n ? (int8_t)repro::qsgd_code(x[i], u[i], s, levels) : 0;
  }
  if (threadIdx.x == 0) scale[row] = smax;
}

}  // namespace

// x, u: n floats; q: nb * blk int8; scale: nb floats, nb = ceil(n / blk).
extern "C" int repro_qsgd_quantize(const void* x, const void* u, void* q,
                                   void* scale, long long n, int blk,
                                   int levels, void* stream) {
  if (n <= 0) return 0;
  const long long nb = (n + blk - 1) / blk;
  qsgd_quantize_rows<<<(unsigned)nb, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<int8_t*>(q), static_cast<float*>(scale), n, blk,
      (float)levels);
  return (int)cudaGetLastError();
}
