// Fused QSGD quantize + nibble pack (bits <= 4): the codes of qsgd.cu,
// packed two per byte, low nibble first (byte j of a row holds codes 2j and
// 2j+1 as (c0 & 15) | (c1 & 15) << 4), plus the per-row f32 scale.
//
// Replaces the TPU kernel src/repro/kernels/bitpack.py qsgd_pack_blocked
// (pl.pallas_call at :116).  As in qsgd.cu, one CUDA block owns one logical
// row of ``blk`` (even) elements of the flat vector; each thread writes one
// byte from two codes, so the int8 codes never reach device memory.  Pad
// lanes past n pack as code 0, which makes the flat bytes equal the
// reference's wire_format.pack4 of the staged codes.
//
// Bound: bytes.  Reads x and u (8 B per element), writes half a byte per
// element plus one f32 scale per row: about 8.5 B per element,
// 8.5 n / 3.35 TB/s on an H100 SXM.
#include "qsgd_row.cuh"

namespace {

__global__ void qsgd_pack_rows(const float* __restrict__ x,
                               const float* __restrict__ u,
                               uint8_t* __restrict__ packed,
                               float* __restrict__ scale, long long n,
                               int blk, float levels) {
  const long long row = blockIdx.x;
  const long long lo = row * blk;
  const long long hi = lo + blk < n ? lo + blk : n;
  const float smax = repro::block_absmax(x, lo, hi);
  const float s = fmaxf(smax, 1e-30f);
  const int half = blk / 2;
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    const long long i0 = lo + 2 * (long long)j;
    const long long i1 = i0 + 1;
    const int c0 = i0 < n ? repro::qsgd_code(x[i0], u[i0], s, levels) : 0;
    const int c1 = i1 < n ? repro::qsgd_code(x[i1], u[i1], s, levels) : 0;
    packed[row * half + j] = (uint8_t)((c0 & 15) | ((c1 & 15) << 4));
  }
  if (threadIdx.x == 0) scale[row] = smax;
}

}  // namespace

// x, u: n floats; packed: nb * blk / 2 bytes; scale: nb floats,
// nb = ceil(n / blk); blk must be even.
extern "C" int repro_qsgd_pack(const void* x, const void* u, void* packed,
                               void* scale, long long n, int blk, int levels,
                               void* stream) {
  if (n <= 0) return 0;
  if (blk % 2) return (int)cudaErrorInvalidValue;
  const long long nb = (n + blk - 1) / blk;
  qsgd_pack_rows<<<(unsigned)nb, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<uint8_t*>(packed), static_cast<float*>(scale), n, blk,
      (float)levels);
  return (int)cudaGetLastError();
}
