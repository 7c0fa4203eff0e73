// STC ternarization with the partial sums of mu, in one pass over a flat
// f32 vector cut into logical rows of ``blk`` elements:
//     code = sign(x) * (|x| >= t)   int8, (nb, blk), pad lanes 0
//     psum[r] = sum_row |x| * keep,  pcnt[r] = sum_row keep   f32, (nb,)
// The caller finishes mu = sum(psum) / sum(pcnt).
//
// Replaces the TPU kernel src/repro/kernels/ternary.py ternarize_blocked
// (pl.pallas_call at :43).  The Pallas version takes (8, 2048) tiles of a
// matrix padded to the TPU's 8-row grid.  Here one warp owns one logical
// row (8 rows per 256-thread block, the TPU tile's row count): each lane
// walks the row in float4 chunks (16-byte loads, char4 stores), and the
// row's psum and pcnt are two warp shuffle reductions, with no shared
// memory or block barrier.  Rows past the last logical one do not exist.
// A ragged or unaligned layout takes the scalar loop.
//
// Bound: bytes.  Reads x (4 B per element) and writes the int8 code (1 B)
// plus two f32 per row: about 5 B per element, 5 n / 3.35 TB/s on an H100
// SXM.  The threshold is read from device memory, so the top-k that
// produces it needs no host sync.  psum is summed in another order than
// the reference's (bounded-ULP); codes and pcnt are exact.
#include "ternary_row.cuh"

namespace {

__global__ void ternarize_rows(const float* __restrict__ x,
                               const float* __restrict__ t,
                               int8_t* __restrict__ code,
                               float* __restrict__ psum,
                               float* __restrict__ pcnt, long long n,
                               int blk, long long nb, bool vec) {
  const long long row =
      (long long)blockIdx.x * repro::kRowWarps + (threadIdx.x >> 5);
  if (row >= nb) return;
  const int lane = threadIdx.x & 31;
  const float thr = __ldg(t);
  const long long lo = row * blk;
  float s = 0.0f;
  int c = 0;
  if (vec) {
    for (int q = lane; q < blk / 4; q += 32) {
      const long long i = lo + 4LL * q;
      const float4 v = repro::load4(x, i, n, true);
      char4 o;
      o.x = (signed char)repro::tern_code(v.x, thr, &s, &c);
      o.y = (signed char)repro::tern_code(v.y, thr, &s, &c);
      o.z = (signed char)repro::tern_code(v.z, thr, &s, &c);
      o.w = (signed char)repro::tern_code(v.w, thr, &s, &c);
      *reinterpret_cast<char4*>(code + i) = o;
    }
  } else {
    for (int j = lane; j < blk; j += 32) {
      const long long i = lo + j;
      const float v = i < n ? x[i] : 0.0f;
      code[i] = (int8_t)repro::tern_code(v, thr, &s, &c);
    }
  }
  repro::store_partials(s, c, row, psum, pcnt);
}

}  // namespace

// x: n floats; t: one float in device memory; code: nb * blk int8;
// psum, pcnt: nb floats, nb = ceil(n / blk).  Returns cudaGetLastError().
extern "C" int repro_ternarize(const void* x, const void* t, void* code,
                               void* psum, void* pcnt, long long n, int blk,
                               void* stream) {
  if (n <= 0) return 0;
  const long long nb = (n + blk - 1) / blk;
  const bool vec = blk % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(code) & 3) == 0;
  const long long grid = (nb + repro::kRowWarps - 1) / repro::kRowWarps;
  ternarize_rows<<<(unsigned)grid, 32 * repro::kRowWarps, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(t),
      static_cast<int8_t*>(code), static_cast<float*>(psum),
      static_cast<float*>(pcnt), n, blk, nb, vec);
  return (int)cudaGetLastError();
}
