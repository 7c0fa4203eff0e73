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
// Other widths: the scatter path, one launch of thread-block clusters.
//  * the host (kernels/count_sketch.py scatter_plan) cuts x into
//    clusters * C contiguous ranges of ``span`` elements (a multiple of 4),
//    C = 16 CTAs a cluster where the card holds a cluster of 16 at the
//    launch's shared memory, else 8; every n below 65,536 is one cluster
//    (a paper_lm leaf of 32,768 elements: 16 CTAs of 2,048);
//  * each CTA zeroes its own rows x cols partial sketch in shared memory
//    (5 x 3276 x 4 B = 64 KB at the widest adapted width, above 48 KB by
//    the dynamic shared-memory opt-in), reads its range of x once (float4
//    loads when x is 16-byte aligned, a scalar tail otherwise) and adds
//    every element into every row with a shared-memory atomicAdd.  The
//    hash divides by the runtime width without a division: q = ab / cols
//    by a multiply-high with the host's constant (Granlund and Montgomery,
//    "Division by invariant integers using multiplication", PLDI 1994,
//    Fig. 4.1, exact for every uint32 ab), h = ab - q cols, sign q & 1;
//  * after a cluster barrier, CTA rank r sums column slice r of all C
//    partials in rank order, read through distributed shared memory, and
//    writes it straight into S; a second barrier keeps every partial alive
//    until the other CTAs have read it.  With more than one cluster (n of
//    65,536 and more) the slices go to scratch [clusters, rows, cols] and
//    count_sketch_reduce sums them in cluster order;
//  * a sketch larger than the opt-in shared memory, or of more than 8
//    rows, runs in groups of rows and column tiles, one launch each.
// The order of the shared-memory atomics inside a CTA varies, so S agrees
// with a sequential sum to a bounded number of ULPs (DESIGN.md §6), as the
// reference's kernel does.
// Bound: 4 n + 4 rows cols bytes, and rows hashes per element, each about
// 6 INT32 operations (multiply-add, multiply-high, shifts, sign flip,
// address) and one shared-memory atomic.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// the scatter path (its plan, span and cluster count come from the host)
constexpr int kThreads = 512;
constexpr int kMaxRows = 8;                 // hash rows per launch
constexpr int kReduceThreads = 256;

// the fold path
constexpr int kFoldThreads = 256;           // 4 columns each
constexpr int kFoldCols = 4 * kFoldThreads; // columns per CTA
constexpr int kFoldCtasPerSm = 4;
constexpr long long kFoldMinRows = 16;      // rows a slab takes at least
constexpr int kFoldBatch = 8;               // row loads in flight a thread
constexpr int kUnfoldThreads = 256;
constexpr int kUnfoldRows = 256;            // sketch rows per unfold launch

// the hash rows of one scatter launch and the width's division constants:
// q = (t + ((ab - t) >> sh1)) >> sh2 with t = umulhi(magic, ab)
struct HashRows {
  unsigned a[kMaxRows];
  unsigned b[kMaxRows];
  unsigned magic;
  unsigned sh1;
  unsigned sh2;
  unsigned cols;
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
                                            unsigned cw, unsigned c0) {
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < rg) {
      const unsigned ab = hp.a[j] * i + hp.b[j];
      const unsigned t = __umulhi(hp.magic, ab);
      const unsigned q = (t + ((ab - t) >> hp.sh1)) >> hp.sh2;
      const unsigned h = ab - q * hp.cols;
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

// One CTA of a cluster of kCluster: elements [blockIdx.x * span,
// min(n, (blockIdx.x + 1) * span)), rows [0, rg) of the group, columns
// [c0, c0 + cw) of the tile, summed into a partial (rg, cw) in shared
// memory.  Then rank r sums columns [r sc, min(cw, (r + 1) sc)), sc =
// ceil(cw / kCluster), of the cluster's kCluster partials in rank order
// and writes them to out + (blockIdx.x / kCluster) * cluster_stride, rows
// row_stride apart.
template <int kCluster, bool kTiled>
__global__ void __launch_bounds__(kThreads)
    count_sketch_scatter(const float* __restrict__ x, HashRows hp,
                         float* __restrict__ out, long long n, long long span,
                         int rg, unsigned cw, unsigned c0,
                         long long cluster_stride, long long row_stride,
                         bool vec) {
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
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
      add_element<kTiled>(sm, v.x, i, hp, rg, cw, c0);
      add_element<kTiled>(sm, v.y, i + 1u, hp, rg, cw, c0);
      add_element<kTiled>(sm, v.z, i + 2u, hp, rg, cw, c0);
      add_element<kTiled>(sm, v.w, i + 3u, hp, rg, cw, c0);
    }
    tail = q1 << 2 > lo ? q1 << 2 : lo;
  }
  for (long long e = tail + threadIdx.x; e < hi; e += kThreads) {
    add_element<kTiled>(sm, __ldg(x + e), (unsigned)e, hp, rg, cw, c0);
  }
  // every partial of the cluster complete and visible to the others
  cluster.sync();

  const unsigned rank = cluster.block_rank();
  const unsigned sc = (cw + kCluster - 1) / kCluster;
  const unsigned m0 = rank * sc < cw ? rank * sc : cw;
  const unsigned w = (m0 + sc < cw ? m0 + sc : cw) - m0;
  const float* part[kCluster];
#pragma unroll
  for (int k = 0; k < kCluster; ++k) part[k] = cluster.map_shared_rank(sm, k);
  float* o = out + (long long)(blockIdx.x / kCluster) * cluster_stride;
  const int items = rg * (int)w;
  for (int u = threadIdx.x; u < items; u += kThreads) {
    const int j = u / (int)w;
    const unsigned c = m0 + (unsigned)(u - j * (int)w);
    const int t = j * (int)cw + (int)c;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kCluster; ++k) acc += part[k][t];
    o[j * row_stride + c] = acc;
  }
  // no CTA exits (and frees its shared memory) before the others read it
  cluster.sync();
}

// S[j, c] = sum over g in cluster order of part[g, j, c], for the (rg, cw)
// block of S at ``s`` (rows ``cols`` apart).
__global__ void count_sketch_reduce(const float* __restrict__ part,
                                    float* __restrict__ s, int clusters,
                                    int rg, int cw, int cols) {
  const int tile = rg * cw;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= tile) return;
  float acc = 0.0f;
#pragma unroll 16
  for (int g = 0; g < clusters; ++g)
    acc += __ldg(part + (long long)g * tile + t);
  const int j = t / cw;
  s[(long long)j * cols + (t - j * cw)] = acc;
}

typedef void (*ScatterFn)(const float*, HashRows, float*, long long,
                          long long, int, unsigned, unsigned, long long,
                          long long, bool);

ScatterFn scatter_fn(int cluster, bool tiled) {
  if (cluster == 16)
    return tiled ? count_sketch_scatter<16, true>
                 : count_sketch_scatter<16, false>;
  return tiled ? count_sketch_scatter<8, true> : count_sketch_scatter<8, false>;
}

struct FoldPlan {
  unsigned P;        // 2 cols
  int blocks;        // column blocks
  int slabs;         // row slabs
  int sp;            // floats a residue's partials take: slabs, rounded up
  long long slab_rows;
};

cudaError_t fold_plan(long long n, int cols, FoldPlan* p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
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

cudaError_t launch_fold(const FoldPlan& p, const float* x,
                        const unsigned* ainv, const unsigned* b, float* s,
                        float* part, long long n, int rows, int cols,
                        cudaStream_t st) {
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

}  // namespace

// The fold path's scratch for n elements at a power-of-two ``cols``, in
// floats.  Returns a cudaError_t.
extern "C" int repro_count_sketch_fold_scratch(long long n, int cols,
                                               long long* floats) {
  if (n <= 0 || cols <= 0 || (cols & (cols - 1)))
    return (int)cudaErrorInvalidValue;
  FoldPlan p;
  const cudaError_t err = fold_plan(n, cols, &p);
  if (err) return (int)err;
  *floats = (long long)p.sp * p.P;
  return 0;
}

// The fold path.  x: n floats on the device; b: the rows' hash offsets and
// ainv their multipliers' inverses mod 2^32 (every a odd), in HOST memory;
// S: rows * cols floats on the device (every entry written); scratch:
// ``repro_count_sketch_fold_scratch`` floats.  Returns cudaGetLastError()
// after the launches.
extern "C" int repro_count_sketch_fold(const void* x, const unsigned* b,
                                       const unsigned* ainv, void* S,
                                       void* scratch, long long scratch_len,
                                       long long n, int rows, int cols,
                                       void* stream) {
  if (n <= 0 || rows <= 0 || cols <= 0 || (cols & (cols - 1)))
    return (int)cudaErrorInvalidValue;
  FoldPlan p;
  cudaError_t err = fold_plan(n, cols, &p);
  if (err) return (int)err;
  if (scratch_len < (long long)p.sp * p.P) return (int)cudaErrorInvalidValue;
  err = launch_fold(p, static_cast<const float*>(x), ainv, b,
                    static_cast<float*>(S), static_cast<float*>(scratch), n,
                    rows, cols, static_cast<cudaStream_t>(stream));
  if (err) return (int)err;
  return (int)cudaGetLastError();
}

// Once a device: lets the scatter kernels take the device's opt-in shared
// memory and the 16-CTA clusters (a non-portable size); *optin gets that
// shared memory in bytes.
extern "C" int repro_count_sketch_setup(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return (int)err;
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err) return (int)err;
  const int sizes[] = {8, 16};
  const bool tilings[] = {false, true};
  for (int cluster : sizes) {
    for (bool tiled : tilings) {
      const void* fn = (const void*)scatter_fn(cluster, tiled);
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *optin);
      if (err) return (int)err;
      if (cluster > 8) {
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err) return (int)err;
      }
    }
  }
  return 0;
}

// The cluster size for a scatter launch whose CTAs take ``smem`` bytes of
// shared memory: 16 where the card holds one such cluster at once, else 8.
// *active gets the clusters of that size the card holds at once.
extern "C" int repro_count_sketch_cluster(int smem, int tiled, int* cluster,
                                          int* active) {
  const int sizes[] = {16, 8};
  for (int c : sizes) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int num = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &num, (const void*)scatter_fn(c, tiled != 0), &cfg);
    if (err) {
      cudaGetLastError();  // not sticky: clear it for the launch checks
      if (c == 8) return (int)err;
      continue;
    }
    if (num >= 1) {
      *cluster = c;
      *active = num;
      return 0;
    }
  }
  return (int)cudaErrorInvalidConfiguration;
}

// The scatter path, as kernels/count_sketch.py scatter_plan cuts it: row
// groups of ``rg`` rows and column tiles of ``cw`` columns, each one launch
// of ``clusters`` clusters of ``cluster`` CTAs, a CTA hashing ``span``
// elements (a multiple of 4).  x: n floats on the device; a, b: the rows'
// hash parameters in HOST memory; (magic, sh1, sh2): the division by cols;
// S: rows * cols floats on the device (every entry written); scratch:
// clusters * rg * cw floats when clusters > 1 (then each group and tile
// adds a count_sketch_reduce launch), else unused.  Returns
// cudaGetLastError() after the launches; a refused cluster launch is an
// error, never a fallback.
extern "C" int repro_count_sketch_scatter(
    const void* x, const unsigned* a, const unsigned* b, void* S,
    void* scratch, long long n, int rows, int cols, int rg, int cw,
    long long span, int cluster, int clusters, unsigned magic, int sh1,
    int sh2, void* stream) {
  if (n <= 0 || rows <= 0 || cols <= 0 || rg < 1 || rg > kMaxRows ||
      cw < 1 || cw > cols || span <= 0 || span % 4 ||
      (cluster != 8 && cluster != 16) || clusters < 1 ||
      (long long)clusters * cluster * span < n ||
      (clusters > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* sf = static_cast<float*>(S);
  float* part = static_cast<float*>(scratch);
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const ScatterFn fn = scatter_fn(cluster, cw < cols);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaError_t err;
  for (int r0 = 0; r0 < rows; r0 += rg) {
    const int g = rows - r0 < rg ? rows - r0 : rg;
    HashRows hp = {};
    for (int j = 0; j < g; ++j) {
      hp.a[j] = a[r0 + j];
      hp.b[j] = b[r0 + j];
    }
    hp.magic = magic;
    hp.sh1 = (unsigned)sh1;
    hp.sh2 = (unsigned)sh2;
    hp.cols = (unsigned)cols;
    for (int c0 = 0; c0 < cols; c0 += cw) {
      const int w = cols - c0 < cw ? cols - c0 : cw;
      float* dst = sf + (long long)r0 * cols + c0;
      const bool direct = clusters == 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3((unsigned)(clusters * cluster));
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = (size_t)g * w * sizeof(float);
      cfg.stream = st;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelEx(
          &cfg, fn, xf, hp, direct ? dst : part, n, span, g, (unsigned)w,
          (unsigned)c0, direct ? 0LL : (long long)g * w,
          direct ? (long long)cols : (long long)w, vec);
      if (err) return (int)err;
      err = cudaGetLastError();
      if (err) return (int)err;
      if (!direct) {
        const int blocks = (g * w + kReduceThreads - 1) / kReduceThreads;
        count_sketch_reduce<<<blocks, kReduceThreads, 0, st>>>(
            part, dst, clusters, g, w, cols);
        err = cudaGetLastError();
        if (err) return (int)err;
      }
    }
  }
  return (int)cudaGetLastError();
}
