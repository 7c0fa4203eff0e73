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
// the MXU and reads x once per row.  This file has two paths, chosen by
// the width:
//
// Power-of-two cols (every leaf of 40,960 elements or more gets 4096
// columns): the fold path, with no hashing of x and no atomics.  With
// cols = 2^c and P = 2 cols, the bucket is the low c bits of ab and the
// sign is bit c, and the low c + 1 bits of a_j i + b_j depend only on
// i mod P.  So every element with the same residue r = i mod P lands in
// the same bucket with the same sign in every row, and
//     y[r] = sum_m x[r + P m]                 (x as rows of P, column sums)
//     S[j, h] = y[p+] - y[p-],   p+ = a_j^-1 (h - b_j) mod P,  p- = p+ ^ cols
// (a_j is odd, so r -> a_j r + b_j mod P is a permutation: p+ is the one
// residue with bucket h and sign +1, and adding cols to it adds a_j cols
// = cols mod P to the hash, which flips the sign and keeps the bucket).
//
//  * count_sketch_fold reads x once, coalesced, as rows of P floats: a
//    thread owns 4 adjacent columns (float4 loads when x is 16-byte
//    aligned and P >= 4, scalar loads otherwise), sums its slab of rows in
//    row order in registers (8 row loads in flight), and writes one
//    partial of P floats per slab.  The grid is the column blocks times
//    as many slabs as fill about 4 CTAs per SM (66 slabs at w_up);
//  * the partials are stored residue-major (a residue's slab sums
//    contiguous), so count_sketch_unfold, one thread per output (j, h),
//    reads the sums of p+ and p- as float4s (in slab-major order each
//    gathered 4-byte value would cost a 32-byte sector); it adds them in
//    slab order and writes S[j, h], so every entry is written, in a fixed
//    order: two launches on one input are bit-identical.  a_j^-1 mod 2^32
//    comes from the host;
//  * one fold serves every row; any power-of-two width up to 2^30 runs
//    without tiles.
// Bound: 4 n + 4 rows cols bytes over 3.35 TB/s; the unfold reads
// 2 rows cols slabs floats of partials from L2.
//
// Other widths: the scatter path.
//  * one CTA takes a contiguous range of x and reads it once (float4 loads
//    when x is 16-byte aligned, a scalar tail otherwise); every element
//    runs all the rows' hashes from registers, the parameters being kernel
//    arguments;
//  * each CTA adds into its own rows x cols partial sketch in shared
//    memory with shared-memory atomics (5 x 3276 x 4 B = 64 KB at the
//    widest adapted width, above 48 KB by the dynamic shared-memory
//    opt-in).  A sketch that does not fit in one CTA's shared memory is
//    done in groups of rows and, for very wide rows, in column tiles, one
//    launch each;
//  * each CTA writes its partial to a scratch buffer [grid, rows, cols],
//    and a second kernel sums the partials in CTA order, so no global
//    float atomics are used.  A range small enough for one CTA writes S
//    directly.  The order of the shared-memory atomics inside a CTA still
//    varies, so S agrees with a sequential sum to a bounded number of ULPs
//    (DESIGN.md §6), as the reference's kernel does.
// Bound: 4 n + 4 rows cols bytes, and rows hashes per element, each about
// 6 INT32 operations (multiply-add, division, sign flip, address) and one
// shared-memory atomic (a compare-and-swap loop on sm_90a).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the scatter path
constexpr int kThreads = 512;
constexpr int kMaxRows = 8;                 // hash rows per launch
constexpr long long kMinPerCta = 4096;      // elements a CTA takes at least
constexpr int kReduceThreads = 256;

// the fold path
constexpr int kFoldThreads = 256;           // 4 columns each
constexpr int kFoldCols = 4 * kFoldThreads; // columns per CTA
constexpr int kFoldCtasPerSm = 4;
constexpr long long kFoldMinRows = 16;      // rows a slab takes at least
constexpr int kFoldBatch = 8;               // row loads in flight a thread
constexpr int kUnfoldThreads = 256;
constexpr int kUnfoldRows = 256;            // sketch rows per unfold launch

struct HashRows {
  unsigned a[kMaxRows];
  unsigned b[kMaxRows];
};

// a_j^-1 mod 2^32 and b_j of the rows one unfold launch writes
struct InvRows {
  unsigned ainv[kUnfoldRows];
  unsigned b[kUnfoldRows];
};

// ---------------------------------------------------------------------------
// the fold path
// ---------------------------------------------------------------------------

// Columns [c, c + 4) of the row of P floats at x + off (w of them exist).
template <bool kVec>
__device__ __forceinline__ float4 row4(const float* __restrict__ x,
                                       long long off, int w) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(x + off));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  v.x = __ldg(x + off);
  if (w > 1) v.y = __ldg(x + off + 1);
  if (w > 2) v.z = __ldg(x + off + 2);
  if (w > 3) v.w = __ldg(x + off + 3);
  return v;
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// CTA (bx, s): columns [bx * kFoldCols, +kFoldCols) of rows
// [s * slab_rows, (s + 1) * slab_rows) of x viewed as rows of P floats
// (the last row ragged); writes the column sums, in row order, to
// part[column, s].  The partials are residue-major, sp floats a residue
// (the slabs rounded up to 4, the pad never written), so the unfold reads
// each residue's slab sums as float4s.
template <bool kVec>
__global__ void __launch_bounds__(kFoldThreads)
    count_sketch_fold(const float* __restrict__ x, float* __restrict__ part,
                      long long n, unsigned P, long long slab_rows, int sp) {
  const unsigned c = (blockIdx.x * (unsigned)kFoldThreads + threadIdx.x) * 4u;
  if (c >= P) return;
  const int w = P - c < 4u ? (int)(P - c) : 4;
  const long long full = n / P;               // rows with all P columns
  const long long rows = (n + P - 1) / P;
  const long long r0 = (long long)blockIdx.y * slab_rows;
  const long long r1 = r0 + slab_rows < rows ? r0 + slab_rows : rows;
  const long long rf = r1 < full ? r1 : full;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  long long r = r0;
  for (; r + kFoldBatch <= rf; r += kFoldBatch) {
    float4 v[kFoldBatch];
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k)
      v[k] = row4<kVec>(x, (r + k) * (long long)P + c, w);
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) add4(acc, v[k]);
  }
  for (; r < rf; ++r) add4(acc, row4<kVec>(x, r * (long long)P + c, w));
  if (r < r1) {                               // the ragged last row
    const long long off = r * (long long)P + c;
    const long long left = n - off;
    if (left > 0) acc.x += __ldg(x + off);
    if (left > 1 && w > 1) acc.y += __ldg(x + off + 1);
    if (left > 2 && w > 2) acc.z += __ldg(x + off + 2);
    if (left > 3 && w > 3) acc.w += __ldg(x + off + 3);
  }
  float* o = part + (long long)c * sp + blockIdx.y;
  o[0] = acc.x;
  if (w > 1) o[sp] = acc.y;
  if (w > 2) o[2 * sp] = acc.z;
  if (w > 3) o[3 * sp] = acc.w;
}

// Thread (h, j): S[j, h] = y[p+] - y[p-], y a residue's slab sums added
// in slab order (the lanes of the last float4 past ``slabs`` are pad).
__global__ void __launch_bounds__(kUnfoldThreads)
    count_sketch_unfold(const float* __restrict__ part, float* __restrict__ s,
                        InvRows hp, int slabs, unsigned cols) {
  const unsigned h = blockIdx.x * (unsigned)kUnfoldThreads + threadIdx.x;
  if (h >= cols) return;
  const int j = blockIdx.y;
  const unsigned P = 2u * cols;
  const unsigned pp = (hp.ainv[j] * (h - hp.b[j])) & (P - 1u);
  const unsigned pm = pp ^ cols;
  const int sp = (slabs + 3) & ~3;
  const float4* up = reinterpret_cast<const float4*>(part + (long long)pp * sp);
  const float4* um = reinterpret_cast<const float4*>(part + (long long)pm * sp);
  float yp = 0.0f, ym = 0.0f;
  const int full = slabs / 4;
#pragma unroll 4
  for (int g = 0; g < full; ++g) {
    const float4 u = __ldg(up + g), v = __ldg(um + g);
    yp += u.x;
    yp += u.y;
    yp += u.z;
    yp += u.w;
    ym += v.x;
    ym += v.y;
    ym += v.z;
    ym += v.w;
  }
  const int rem = slabs - 4 * full;
  if (rem) {
    const float4 u = __ldg(up + full), v = __ldg(um + full);
    yp += u.x;
    ym += v.x;
    if (rem > 1) {
      yp += u.y;
      ym += v.y;
    }
    if (rem > 2) {
      yp += u.z;
      ym += v.z;
    }
  }
  s[(long long)j * cols + h] = yp - ym;
}

// ---------------------------------------------------------------------------
// the scatter path
// ---------------------------------------------------------------------------

template <bool kTiled>
__device__ __forceinline__ void add_element(float* sm, float v, unsigned i,
                                            const HashRows& hp, int rg,
                                            unsigned cw, unsigned c0,
                                            unsigned cols) {
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < rg) {
      const unsigned ab = hp.a[j] * i + hp.b[j];
      const unsigned h = ab % cols;
      const unsigned q = ab / cols;
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
template <bool kTiled>
__global__ void __launch_bounds__(kThreads)
    count_sketch_partial(const float* __restrict__ x, HashRows hp,
                         float* __restrict__ out, long long n, long long span,
                         int rg, unsigned cw, unsigned c0, unsigned cols,
                         long long cta_stride, long long row_stride,
                         bool vec) {
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
      add_element<kTiled>(sm, v.x, i, hp, rg, cw, c0, cols);
      add_element<kTiled>(sm, v.y, i + 1u, hp, rg, cw, c0, cols);
      add_element<kTiled>(sm, v.z, i + 2u, hp, rg, cw, c0, cols);
      add_element<kTiled>(sm, v.w, i + 3u, hp, rg, cw, c0, cols);
    }
    tail = q1 << 2 > lo ? q1 << 2 : lo;
  }
  for (long long e = tail + threadIdx.x; e < hi; e += kThreads) {
    add_element<kTiled>(sm, __ldg(x + e), (unsigned)e, hp, rg, cw, c0, cols);
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
                          long long, long long, bool);

struct Plan {
  bool fold;         // the power-of-two path
  // fold path
  unsigned P;        // 2 cols
  int blocks;        // column blocks
  int slabs;         // row slabs
  int sp;            // floats a residue's partials take: slabs, rounded up
  long long slab_rows;
  // scatter path
  int rg;            // rows per launch
  int cw;            // columns per launch
  int grid;          // CTAs per launch
  long long span;    // elements per CTA, a multiple of 4
  PartialFn fn;
};

long long scratch_floats(const Plan& p) {
  if (p.fold) return (long long)p.sp * p.P;
  return p.grid > 1 ? (long long)p.grid * p.rg * p.cw : 0;
}

// min_span: the least elements a scatter-path CTA takes (0: kMinPerCta,
// which gives a paper_lm leaf of 32,768 elements 8 CTAs and the reduce;
// one CTA per such leaf, at least max(4 rg cw, 16384) elements a CTA,
// was slower: PERF.md §6).
cudaError_t make_plan(long long n, int rows, int cols, long long min_span,
                      Plan* p) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  p->fold = (cols & (cols - 1)) == 0;
  if (p->fold) {
    p->P = 2u * (unsigned)cols;
    const long long xrows = (n + p->P - 1) / p->P;
    p->blocks = (int)((p->P + kFoldCols - 1) / kFoldCols);
    long long slabs = (long long)kFoldCtasPerSm * sms / p->blocks;
    const long long by_rows = (xrows + kFoldMinRows - 1) / kFoldMinRows;
    if (slabs > by_rows) slabs = by_rows;
    if (slabs < 1) slabs = 1;
    p->slab_rows = (xrows + slabs - 1) / slabs;
    p->slabs = (int)((xrows + p->slab_rows - 1) / p->slab_rows);
    p->sp = (p->slabs + 3) & ~3;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err) return err;
  const long long floats = optin / 4;
  p->cw = (int)(cols < floats ? cols : floats);
  long long rg = floats / p->cw;
  if (rg > kMaxRows) rg = kMaxRows;
  if (rg > rows) rg = rows;
  p->rg = (int)(rg < 1 ? 1 : rg);
  p->fn = p->cw < cols ? count_sketch_partial<true>
                       : count_sketch_partial<false>;
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
  const long long want = min_span > 0 ? min_span : kMinPerCta;
  long long grid = (n + want - 1) / want;
  const long long cap = (long long)per_sm * sms;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  p->span = (((n + grid - 1) / grid) + 3) / 4 * 4;
  p->grid = (int)((n + p->span - 1) / p->span);
  return cudaSuccess;
}

cudaError_t launch_fold(const Plan& p, const float* x, const unsigned* ainv,
                        const unsigned* b, float* s, float* part, long long n,
                        int rows, int cols, cudaStream_t st) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && p.P >= 4;
  const dim3 grid(p.blocks, p.slabs);
  if (vec)
    count_sketch_fold<true><<<grid, kFoldThreads, 0, st>>>(
        x, part, n, p.P, p.slab_rows, p.sp);
  else
    count_sketch_fold<false><<<grid, kFoldThreads, 0, st>>>(
        x, part, n, p.P, p.slab_rows, p.sp);
  cudaError_t err = cudaGetLastError();
  if (err) return err;
  for (int r0 = 0; r0 < rows; r0 += kUnfoldRows) {
    const int rg = rows - r0 < kUnfoldRows ? rows - r0 : kUnfoldRows;
    InvRows hp = {};
    for (int j = 0; j < rg; ++j) {
      hp.ainv[j] = ainv[r0 + j];
      hp.b[j] = b[r0 + j];
    }
    const dim3 ugrid((unsigned)((cols + kUnfoldThreads - 1) / kUnfoldThreads),
                     rg);
    count_sketch_unfold<<<ugrid, kUnfoldThreads, 0, st>>>(
        part, s + (long long)r0 * cols, hp, p.slabs, (unsigned)cols);
    err = cudaGetLastError();
    if (err) return err;
  }
  return cudaSuccess;
}

cudaError_t launch_scatter(const Plan& p, const float* x, const unsigned* a,
                           const unsigned* b, float* sf, float* part,
                           long long n, int rows, int cols, cudaStream_t st) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  cudaError_t err;
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
          x, hp, direct ? dst : part, n, p.span, rg, (unsigned)cw,
          (unsigned)c0, (unsigned)cols, direct ? 0LL : (long long)rg * cw,
          direct ? (long long)cols : cw, vec);
      err = cudaGetLastError();
      if (err) return err;
      if (!direct) {
        const int blocks = (rg * cw + kReduceThreads - 1) / kReduceThreads;
        count_sketch_reduce<<<blocks, kReduceThreads, 0, st>>>(
            part, dst, p.grid, rg, cw, cols);
        err = cudaGetLastError();
        if (err) return err;
      }
    }
  }
  return cudaSuccess;
}

}  // namespace

// The scratch the launch below needs, in floats, and the path it takes
// (*fold = 1 for the power-of-two path).  Returns a cudaError_t.
extern "C" int repro_count_sketch_scratch(long long n, int rows, int cols,
                                          long long min_span,
                                          long long* floats, int* fold) {
  Plan p;
  const cudaError_t err = make_plan(n, rows, cols, min_span, &p);
  if (err) return (int)err;
  *floats = scratch_floats(p);
  *fold = p.fold ? 1 : 0;
  return 0;
}

// x: n floats on the device; a, b: the rows' hash parameters and ainv
// their multipliers' inverses mod 2^32 (read on the power-of-two path
// only; every a odd there), all in HOST memory; S: rows * cols floats on
// the device (every entry written); scratch:
// ``repro_count_sketch_scratch`` floats.  Returns cudaGetLastError()
// after the launches.
extern "C" int repro_count_sketch(const void* x, const unsigned* a,
                                  const unsigned* b, const unsigned* ainv,
                                  void* S, void* scratch,
                                  long long scratch_len, long long n,
                                  int rows, int cols, long long min_span,
                                  void* stream) {
  if (n <= 0 || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(n, rows, cols, min_span, &p);
  if (err) return (int)err;
  if (scratch_len < scratch_floats(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* sf = static_cast<float*>(S);
  float* part = static_cast<float*>(scratch);
  err = p.fold ? launch_fold(p, xf, ainv, b, sf, part, n, rows, cols, st)
               : launch_scatter(p, xf, a, b, sf, part, n, rows, cols, st);
  if (err) return (int)err;
  return (int)cudaGetLastError();
}
