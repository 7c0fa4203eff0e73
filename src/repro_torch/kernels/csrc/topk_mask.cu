// Threshold sparsify with the error-feedback residual, in one pass over a
// flat f32 vector:  kept = x * (|x| >= t),  resid = x - kept.
//
// Replaces the TPU kernel src/repro/kernels/topk_mask.py
// threshold_sparsify_blocked (pl.pallas_call at :36).  The Pallas version
// walks (8, 2048) tiles of a vector padded to the TPU's 8-row grid; that
// padding is a TPU tiling artefact, so this kernel works on the flat n: a
// grid-stride loop over float4 chunks (16-byte loads and stores) and a
// masked scalar tail.
//
// Bound: bytes.  Each element reads x once (4 B) and writes kept and resid
// (8 B): 12 B per element, 12 n / 3.35 TB/s on an H100 SXM.  No arithmetic
// beyond one compare and one subtract.  The threshold is read from device
// memory, so the top-k sort that produces it needs no host sync.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void sparsify1(float v, float t, float* k,
                                          float* r) {
  const float kv = fabsf(v) >= t ? v : 0.0f;
  *k = kv;
  *r = __fsub_rn(v, kv);
}

__global__ void threshold_sparsify_vec4(const float4* __restrict__ x,
                                        const float* __restrict__ t,
                                        float4* __restrict__ kept,
                                        float4* __restrict__ resid,
                                        long long n4) {
  const float thr = __ldg(t);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 v = x[i];
    float4 k, r;
    sparsify1(v.x, thr, &k.x, &r.x);
    sparsify1(v.y, thr, &k.y, &r.y);
    sparsify1(v.z, thr, &k.z, &r.z);
    sparsify1(v.w, thr, &k.w, &r.w);
    kept[i] = k;
    resid[i] = r;
  }
}

__global__ void threshold_sparsify_scalar(const float* __restrict__ x,
                                          const float* __restrict__ t,
                                          float* __restrict__ kept,
                                          float* __restrict__ resid,
                                          long long start, long long n) {
  const float thr = __ldg(t);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = start + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    sparsify1(x[i], thr, &kept[i], &resid[i]);
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 resident blocks per SM

long long blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

// x, kept, resid: n floats; t: one float in device memory.  Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int repro_threshold_sparsify(const void* x, const void* t,
                                        void* kept, void* resid, long long n,
                                        void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(kept) |
        reinterpret_cast<uintptr_t>(resid)) & 15) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  if (n4 > 0) {
    threshold_sparsify_vec4<<<(unsigned)blocks_for(n4), kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const float*>(t),
        static_cast<float4*>(kept), static_cast<float4*>(resid), n4);
  }
  const long long rest = n - 4 * n4;
  if (rest > 0) {
    threshold_sparsify_scalar<<<(unsigned)blocks_for(rest), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(t),
        static_cast<float*>(kept), static_cast<float*>(resid), 4 * n4, n);
  }
  return (int)cudaGetLastError();
}
