// The bit-packing kernels: the QSGD and ternarize passes fused with their
// pack, and the standalone pack and unpack of int8 code matrices.  Byte
// layout (src/repro/compress/wire_format.py): little-endian fields within a
// byte, byte j of a row holding codes per*j .. per*j + per-1 (per = 4 codes
// of 2 bits, or 2 of 4 bits), two's-complement fields.  Each row's length is
// a multiple of ``per``, so the flat bytes of the packed rows equal the
// flat packing of the flat codes.
//
// * qsgd_pack_rows replaces src/repro/kernels/bitpack.py qsgd_pack_blocked
//   (pl.pallas_call at :116): the codes of qsgd.cu, packed two per byte as
//   (c0 & 15) | (c1 & 15) << 4, plus the per-row f32 scale.  As in qsgd.cu,
//   one CUDA block owns one logical row of ``blk`` (even) elements; each
//   thread writes one byte from two codes, so the int8 codes never reach
//   device memory.  Pad lanes past n pack as code 0.  Bound: bytes, reads x
//   and u (8 B per element), writes half a byte per element plus one f32
//   per row, about 8.5 B per element.
// * ternarize_pack_rows replaces bitpack.py ternarize_pack_blocked
//   (pl.pallas_call at :77): the ternarize pass of ternary.cu with its codes
//   packed four per byte ((code & 3) << 2j), one warp per logical row, one
//   float4 in and one byte out per lane step.  Pad lanes are x = 0, code 0,
//   so they pack as zero bits for any threshold.  Bound: bytes, 4 B in and
//   0.25 B out per element plus 8 B per row, about 4.25 B per element.
// * pack_codes_words / unpack_codes_words replace bitpack.py
//   pack_codes_blocked (:146) and unpack_codes_blocked (:166).  They are
//   elementwise over the flat buffers (the row structure only fixes the
//   shape): one thread per 4 packed bytes, which is 16 codes at 2 bits
//   (one 16-byte load or store of codes) or 8 codes at 4 bits (8 bytes),
//   with a byte-wise tail.  Unpack sign-extends each field as
//   ((u + off) & mask) - off.  Bound: bytes, 1 B of codes and bits/8 B of
//   packed data per code: 1.25 B per code at 2 bits, 1.5 B at 4 bits.
//
// Bytes over the H100 SXM's 3.35 TB/s give each kernel's bound.
#include "qsgd_row.cuh"
#include "ternary_row.cuh"

#include <type_traits>

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

__global__ void ternarize_pack_rows(const float* __restrict__ x,
                                    const float* __restrict__ t,
                                    uint8_t* __restrict__ packed,
                                    float* __restrict__ psum,
                                    float* __restrict__ pcnt, long long n,
                                    int blk, long long nb, bool aligned) {
  const long long row =
      (long long)blockIdx.x * repro::kRowWarps + (threadIdx.x >> 5);
  if (row >= nb) return;
  const int lane = threadIdx.x & 31;
  const float thr = __ldg(t);
  const long long lo = row * blk;
  const int quads = blk / 4;
  float s = 0.0f;
  int c = 0;
  for (int q = lane; q < quads; q += 32) {
    const float4 v = repro::load4(x, lo + 4LL * q, n, aligned);
    const int c0 = repro::tern_code(v.x, thr, &s, &c);
    const int c1 = repro::tern_code(v.y, thr, &s, &c);
    const int c2 = repro::tern_code(v.z, thr, &s, &c);
    const int c3 = repro::tern_code(v.w, thr, &s, &c);
    packed[row * quads + q] = (uint8_t)((c0 & 3) | ((c1 & 3) << 2) |
                                        ((c2 & 3) << 4) | ((c3 & 3) << 6));
  }
  repro::store_partials(s, c, row, psum, pcnt);
}

// One packed byte from the BITS-bit fields of codes[0 .. 8 / BITS).
template <int BITS>
__device__ __forceinline__ uint32_t pack_byte(const int8_t* codes) {
  constexpr uint32_t kMask = (1u << BITS) - 1;
  uint32_t b = 0;
#pragma unroll
  for (int j = 0; j < 8 / BITS; ++j) {
    b |= ((uint32_t)(uint8_t)codes[j] & kMask) << (j * BITS);
  }
  return b;
}

// Field j of ``byte``, sign-extended: ((u + off) & mask) - off.
template <int BITS>
__device__ __forceinline__ int8_t unpack_field(uint32_t byte, int j) {
  constexpr int kMask = (1 << BITS) - 1;
  constexpr int kOff = 1 << (BITS - 1);
  const int u = (int)(byte >> (j * BITS)) & kMask;
  return (int8_t)(((u + kOff) & kMask) - kOff);
}

// 4 * 8 / BITS codes: one 16-byte vector at 2 bits, 8 bytes at 4 bits.
template <int BITS>
struct CodeVec {
  using type = typename std::conditional<BITS == 2, int4, int2>::type;
};

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 resident blocks per SM

long long blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

template <int BITS>
__global__ void pack_codes_words(const int8_t* __restrict__ codes,
                                 uint8_t* __restrict__ packed,
                                 long long nbytes, bool aligned) {
  constexpr int kPer = 8 / BITS;
  using Vec = typename CodeVec<BITS>::type;
  const long long words = (nbytes + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < words; w += stride) {
    const long long b0 = 4 * w;
    if (aligned && b0 + 4 <= nbytes) {
      union {
        Vec v;
        int8_t c[4 * kPer];
      } in;
      in.v = *reinterpret_cast<const Vec*>(codes + b0 * kPer);
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        word |= pack_byte<BITS>(in.c + k * kPer) << (8 * k);
      }
      *reinterpret_cast<uint32_t*>(packed + b0) = word;
    } else {
      for (long long b = b0; b < b0 + 4 && b < nbytes; ++b) {
        packed[b] = (uint8_t)pack_byte<BITS>(codes + b * kPer);
      }
    }
  }
}

template <int BITS>
__global__ void unpack_codes_words(const uint8_t* __restrict__ packed,
                                   int8_t* __restrict__ codes,
                                   long long nbytes, bool aligned) {
  constexpr int kPer = 8 / BITS;
  using Vec = typename CodeVec<BITS>::type;
  const long long words = (nbytes + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < words; w += stride) {
    const long long b0 = 4 * w;
    if (aligned && b0 + 4 <= nbytes) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(packed + b0);
      union {
        Vec v;
        int8_t c[4 * kPer];
      } out;
#pragma unroll
      for (int m = 0; m < 4 * kPer; ++m) {
        out.c[m] = unpack_field<BITS>(word >> (8 * (m / kPer)), m % kPer);
      }
      *reinterpret_cast<Vec*>(codes + b0 * kPer) = out.v;
    } else {
      for (long long b = b0; b < b0 + 4 && b < nbytes; ++b) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          codes[b * kPer + j] = unpack_field<BITS>(packed[b], j);
        }
      }
    }
  }
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

// x: n floats; t: one float in device memory; packed: nb * blk / 4 bytes;
// psum, pcnt: nb floats, nb = ceil(n / blk); blk must be a multiple of 4.
extern "C" int repro_ternarize_pack(const void* x, const void* t,
                                    void* packed, void* psum, void* pcnt,
                                    long long n, int blk, void* stream) {
  if (n <= 0) return 0;
  if (blk % 4) return (int)cudaErrorInvalidValue;
  const long long nb = (n + blk - 1) / blk;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long grid = (nb + repro::kRowWarps - 1) / repro::kRowWarps;
  ternarize_pack_rows<<<(unsigned)grid, 32 * repro::kRowWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(t),
      static_cast<uint8_t*>(packed), static_cast<float*>(psum),
      static_cast<float*>(pcnt), n, blk, nb, aligned);
  return (int)cudaGetLastError();
}

// codes: nbytes * 8 / bits int8; packed: nbytes; bits 2 or 4.
extern "C" int repro_pack_codes(const void* codes, void* packed,
                                long long nbytes, int bits, void* stream) {
  if (bits != 2 && bits != 4) return (int)cudaErrorInvalidValue;
  if (nbytes <= 0) return 0;
  const uintptr_t need = bits == 2 ? 15 : 7;
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) & need) == 0 &&
                       (reinterpret_cast<uintptr_t>(packed) & 3) == 0;
  const unsigned grid = (unsigned)blocks_for((nbytes + 3) / 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  uint8_t* p = static_cast<uint8_t*>(packed);
  if (bits == 2) {
    pack_codes_words<2><<<grid, kThreads, 0, s>>>(c, p, nbytes, aligned);
  } else {
    pack_codes_words<4><<<grid, kThreads, 0, s>>>(c, p, nbytes, aligned);
  }
  return (int)cudaGetLastError();
}

// packed: nbytes; codes: nbytes * 8 / bits int8; bits 2 or 4.
extern "C" int repro_unpack_codes(const void* packed, void* codes,
                                  long long nbytes, int bits, void* stream) {
  if (bits != 2 && bits != 4) return (int)cudaErrorInvalidValue;
  if (nbytes <= 0) return 0;
  const uintptr_t need = bits == 2 ? 15 : 7;
  const bool aligned = (reinterpret_cast<uintptr_t>(packed) & 3) == 0 &&
                       (reinterpret_cast<uintptr_t>(codes) & need) == 0;
  const unsigned grid = (unsigned)blocks_for((nbytes + 3) / 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  int8_t* c = static_cast<int8_t*>(codes);
  if (bits == 2) {
    unpack_codes_words<2><<<grid, kThreads, 0, s>>>(p, c, nbytes, aligned);
  } else {
    unpack_codes_words<4><<<grid, kThreads, 0, s>>>(p, c, nbytes, aligned);
  }
  return (int)cudaGetLastError();
}
