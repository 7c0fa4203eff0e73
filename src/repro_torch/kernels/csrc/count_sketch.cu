// Count sketch of a flat f32 vector x (n,):
//     S[j, h_j(i)] += s_j(i) * x_i      for every sketch row j < rows,
// with the multiplicative hash over Z/2^32
//     ab = a_j * i + b_j  (uint32, wrapping),
//     h_j(i) = ab % cols,  s_j(i) = +1 if (ab / cols) is even, else -1,
// where i is the element's flat index.  S is (rows, cols) f32, row-major.
//
// Replaces the TPU kernel src/repro/kernels/count_sketch.py count_sketch
// (pl.pallas_call at :58).  The TPU has no fast scatter, so the Pallas
// version turns each (row, 1024-element chunk) into a one-hot matmul on
// the MXU and reads x once per row.  This kernel scatters instead:
//
//  * one CTA takes a contiguous range of x and reads it once (float4 loads
//    when x is 16-byte aligned, a scalar tail otherwise); every element
//    runs all the rows' hashes from registers, the parameters being kernel
//    arguments;
//  * each CTA adds into its own rows x cols partial sketch in shared
//    memory with shared-memory atomics (5 x 4096 x 4 B = 80 KB by default,
//    above 48 KB by the dynamic shared-memory opt-in).  A sketch that does
//    not fit in one CTA's shared memory is done in groups of rows and, for
//    very wide rows, in column tiles, one launch each;
//  * each CTA writes its partial to a scratch buffer [grid, rows, cols],
//    and a second kernel sums the partials in CTA order, so no global
//    float atomics are used.  A range small enough for one CTA writes S
//    directly.  The order of the shared-memory atomics inside a CTA still
//    varies, so S agrees with a sequential sum to a bounded number of ULPs
//    (DESIGN.md §6), as the reference's kernel does;
//  * when cols is a power of two (every leaf of 40,960 elements or more
//    gets 4096 columns), the bucket and the sign bit come from a mask and
//    a shift instead of an integer division.
//
// Bound: per element, 4 B of x read once (plus 4 B per bucket of S
// written), so 4 n + 4 rows cols bytes over 3.35 TB/s; and rows hashes per
// element, each about 6 INT32 operations (multiply-add, mask, shift, sign
// flip, address) and one shared-memory atomic.  At rows = 5 the integer
// work is the larger of the two on an H100 SXM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxRows = 8;                 // hash rows per launch
constexpr long long kMinPerCta = 16384;     // elements a CTA takes at least
constexpr int kReduceThreads = 256;

struct HashRows {
  unsigned a[kMaxRows];
  unsigned b[kMaxRows];
};

template <bool kPow2, bool kTiled>
__device__ __forceinline__ void add_element(float* sm, float v, unsigned i,
                                            const HashRows& hp, int rg,
                                            unsigned cw, unsigned c0,
                                            unsigned cols, unsigned shift) {
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < rg) {
      const unsigned ab = hp.a[j] * i + hp.b[j];
      unsigned h, q;
      if (kPow2) {
        h = ab & (cols - 1u);
        q = ab >> shift;
      } else {
        h = ab % cols;
        q = ab / cols;
      }
      // s * x for s = +-1: flip the sign bit where q is odd
      const float sv = __int_as_float(__float_as_int(v) ^ ((q & 1u) << 31));
      if (kTiled) {
        const unsigned hc = h - c0;
        if (hc < cw) atomicAdd(sm + j * cw + hc, sv);
      } else {
        atomicAdd(sm + j * cw + h, sv);
      }
    }
  }
}

// One CTA: elements [blockIdx.x * span, min(n, (blockIdx.x + 1) * span)),
// rows [0, rg) of the group, columns [c0, c0 + cw) of the tile.  Writes
// its partial (rg, cw) to out + blockIdx.x * cta_stride, rows row_stride
// apart.
template <bool kPow2, bool kTiled>
__global__ void __launch_bounds__(kThreads)
    count_sketch_partial(const float* __restrict__ x, HashRows hp,
                         float* __restrict__ out, long long n, long long span,
                         int rg, unsigned cw, unsigned c0, unsigned cols,
                         unsigned shift, long long cta_stride,
                         long long row_stride, bool vec) {
  extern __shared__ float sm[];
  const int tile = rg * (int)cw;
  for (int t = threadIdx.x; t < tile; t += kThreads) sm[t] = 0.0f;
  __syncthreads();

  const long long lo = (long long)blockIdx.x * span;
  const long long hi = lo + span < n ? lo + span : n;
  long long tail = lo;
  if (vec) {
    // span is a multiple of 4, so every CTA starts on a float4
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long q1 = hi >> 2;
    for (long long q = (lo >> 2) + threadIdx.x; q < q1; q += kThreads) {
      const float4 v = __ldg(x4 + q);
      const unsigned i = (unsigned)(q << 2);
      add_element<kPow2, kTiled>(sm, v.x, i, hp, rg, cw, c0, cols, shift);
      add_element<kPow2, kTiled>(sm, v.y, i + 1u, hp, rg, cw, c0, cols,
                                 shift);
      add_element<kPow2, kTiled>(sm, v.z, i + 2u, hp, rg, cw, c0, cols,
                                 shift);
      add_element<kPow2, kTiled>(sm, v.w, i + 3u, hp, rg, cw, c0, cols,
                                 shift);
    }
    tail = q1 << 2 > lo ? q1 << 2 : lo;
  }
  for (long long e = tail + threadIdx.x; e < hi; e += kThreads) {
    add_element<kPow2, kTiled>(sm, __ldg(x + e), (unsigned)e, hp, rg, cw, c0,
                               cols, shift);
  }
  __syncthreads();

  float* o = out + (long long)blockIdx.x * cta_stride;
  for (int t = threadIdx.x; t < tile; t += kThreads) {
    const int j = t / (int)cw;
    o[j * row_stride + (t - j * (int)cw)] = sm[t];
  }
}

// S[j, c] = sum over g in CTA order of part[g, j, c], for the (rg, cw)
// block of S at ``s`` (rows ``cols`` apart).
__global__ void count_sketch_reduce(const float* __restrict__ part,
                                    float* __restrict__ s, int grid, int rg,
                                    int cw, int cols) {
  const int tile = rg * cw;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= tile) return;
  float acc = 0.0f;
#pragma unroll 16
  for (int g = 0; g < grid; ++g) acc += __ldg(part + (long long)g * tile + t);
  const int j = t / cw;
  s[(long long)j * cols + (t - j * cw)] = acc;
}

typedef void (*PartialFn)(const float*, HashRows, float*, long long,
                          long long, int, unsigned, unsigned, unsigned,
                          unsigned, long long, long long, bool);

struct Plan {
  int rg;            // rows per launch
  int cw;            // columns per launch
  int grid;          // CTAs per launch
  long long span;    // elements per CTA, a multiple of 4
  unsigned shift;    // log2(cols) when cols is a power of two
  PartialFn fn;
};

cudaError_t make_plan(long long n, int rows, int cols, Plan* p) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err) return err;
  const long long floats = optin / 4;
  p->cw = (int)(cols < floats ? cols : floats);
  long long rg = floats / p->cw;
  if (rg > kMaxRows) rg = kMaxRows;
  if (rg > rows) rg = rows;
  p->rg = (int)(rg < 1 ? 1 : rg);
  const bool pow2 = (cols & (cols - 1)) == 0;
  const bool tiled = p->cw < cols;
  p->shift = 0;
  while (pow2 && (1 << p->shift) < cols) ++p->shift;
  p->fn = pow2 ? (tiled ? count_sketch_partial<true, true>
                        : count_sketch_partial<true, false>)
               : (tiled ? count_sketch_partial<false, true>
                        : count_sketch_partial<false, false>);
  const int smem = p->rg * p->cw * (int)sizeof(float);
  err = cudaFuncSetAttribute((const void*)p->fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)p->fn, kThreads, (size_t)smem);
  if (err) return err;
  if (per_sm < 1) per_sm = 1;
  long long want = 4LL * p->rg * p->cw;
  if (want < kMinPerCta) want = kMinPerCta;
  long long grid = (n + want - 1) / want;
  const long long cap = (long long)per_sm * sms;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  p->span = (((n + grid - 1) / grid) + 3) / 4 * 4;
  p->grid = (int)((n + p->span - 1) / p->span);
  return cudaSuccess;
}

}  // namespace

// The scratch the launch below needs, in floats (0 when one CTA covers x).
// Returns a cudaError_t.
extern "C" int repro_count_sketch_scratch(long long n, int rows, int cols,
                                          long long* floats) {
  Plan p;
  const cudaError_t err = make_plan(n, rows, cols, &p);
  if (err) return (int)err;
  *floats = p.grid > 1 ? (long long)p.grid * p.rg * p.cw : 0;
  return 0;
}

// x: n floats on the device; a, b: the rows' hash parameters in HOST
// memory; S: rows * cols floats on the device (every entry written);
// scratch: ``repro_count_sketch_scratch`` floats.  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_count_sketch(const void* x, const unsigned* a,
                                  const unsigned* b, void* S, void* scratch,
                                  long long scratch_floats, long long n,
                                  int rows, int cols, void* stream) {
  if (n <= 0 || rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(n, rows, cols, &p);
  if (err) return (int)err;
  if (p.grid > 1 && scratch_floats < (long long)p.grid * p.rg * p.cw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* sf = static_cast<float*>(S);
  float* part = static_cast<float*>(scratch);
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (int r0 = 0; r0 < rows; r0 += p.rg) {
    const int rg = rows - r0 < p.rg ? rows - r0 : p.rg;
    HashRows hp = {};
    for (int j = 0; j < rg; ++j) {
      hp.a[j] = a[r0 + j];
      hp.b[j] = b[r0 + j];
    }
    for (int c0 = 0; c0 < cols; c0 += p.cw) {
      const int cw = cols - c0 < p.cw ? cols - c0 : p.cw;
      float* dst = sf + (long long)r0 * cols + c0;
      const bool direct = p.grid == 1;
      p.fn<<<p.grid, kThreads, (size_t)rg * cw * sizeof(float), st>>>(
          xf, hp, direct ? dst : part, n, p.span, rg, (unsigned)cw,
          (unsigned)c0, (unsigned)cols, p.shift,
          direct ? 0LL : (long long)rg * cw, direct ? (long long)cols : cw,
          vec);
      err = cudaGetLastError();
      if (err) return (int)err;
      if (!direct) {
        const int blocks = (rg * cw + kReduceThreads - 1) / kReduceThreads;
        count_sketch_reduce<<<blocks, kReduceThreads, 0, st>>>(
            part, dst, p.grid, rg, cw, cols);
        err = cudaGetLastError();
        if (err) return (int)err;
      }
    }
  }
  return (int)cudaGetLastError();
}
