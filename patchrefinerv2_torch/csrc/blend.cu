// K7: tile blending into the three float32 canvases (mosaic, sum_wp, sum_w)
// and the final average.
//
// Replaces patchrefinerv2_tpu/ops/blend.py:54 `TileBlender.add_pass` (a
// lax.scan of dynamic_update_slice over the patches, one patch after the
// other) and :113 `finalize`.
//
// add_pass: patches overlap inside an m2 chunk, so a thread per patch pixel
// would race on the canvas. This kernel stays deterministic without atomics:
// one thread per canvas pixel loops over the chunk's patches in order and,
// for each patch that covers the pixel, adds p * mask * valid to sum_wp and
// mask * valid to sum_w, and writes p to the mosaic where the patch is an
// init patch. The sums are taken in patch order, the order of the
// reference's scan, so the result does not depend on scheduling. It is
// bound by bytes (the covered part of the canvases is read and written once,
// each prediction and the mask read once); a pixel that no patch covers
// costs only the loop over the patch starts, which sit in L1.
//
// finalize: elementwise where(sum_w > 0, sum_wp / max(sum_w, 1e-12), mosaic).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__global__ void blend_add_kernel(float* __restrict__ mosaic, float* __restrict__ swp,
                                 float* __restrict__ sw, const T* __restrict__ preds,
                                 const float* __restrict__ mask, const int* __restrict__ starts,
                                 const float* __restrict__ valid, const float* __restrict__ initv,
                                 int n, int64_t h, int64_t w, int64_t RH, int64_t RW) {
  const int64_t total = RH * RW;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += step) {
    const int64_t y = idx / RW;
    const int64_t x = idx % RW;
    bool touched = false;
    float a = 0.0f, b = 0.0f, mo = 0.0f;
    for (int k = 0; k < n; ++k) {
      const int64_t r = y - __ldg(starts + 2 * k);
      const int64_t q = x - __ldg(starts + 2 * k + 1);
      if (r < 0 || r >= h || q < 0 || q >= w) continue;
      if (!touched) {
        a = swp[idx];
        b = sw[idx];
        mo = mosaic[idx];
        touched = true;
      }
      const float p = ld(preds + ((int64_t)k * h + r) * w + q);
      const float m = __fmul_rn(__ldg(mask + r * w + q), __ldg(valid + k));
      a = __fadd_rn(a, __fmul_rn(p, m));
      b = __fadd_rn(b, m);
      if (__ldg(initv + k) > 0.0f) mo = p;
    }
    if (touched) {
      swp[idx] = a;
      sw[idx] = b;
      mosaic[idx] = mo;
    }
  }
}

__global__ void blend_finalize_kernel(const float* __restrict__ mosaic,
                                      const float* __restrict__ swp,
                                      const float* __restrict__ sw, float* __restrict__ out,
                                      int64_t total) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += step) {
    const float b = sw[idx];
    out[idx] = b > 0.0f ? __fdiv_rn(swp[idx], fmaxf(b, 1e-12f)) : mosaic[idx];
  }
}

int blocks_for(int64_t total, int threads) {
  int64_t b = (total + threads - 1) / threads;
  const int64_t cap = 132 * 32;
  return (int)(b < cap ? b : cap);
}

}  // namespace

extern "C" int prv2_blend_add(void* mosaic, void* swp, void* sw, const void* preds,
                              const void* mask, const void* starts, const void* valid,
                              const void* initv, long long n, long long h, long long w,
                              long long RH, long long RW, int dtype, void* stream) {
  const int64_t total = (int64_t)RH * RW;
  if (total == 0 || n == 0) return 0;
  const int threads = 256;
  const int blocks = blocks_for(total, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    blend_add_kernel<float><<<blocks, threads, 0, s>>>(
        (float*)mosaic, (float*)swp, (float*)sw, (const float*)preds, (const float*)mask,
        (const int*)starts, (const float*)valid, (const float*)initv, (int)n, h, w, RH, RW);
  } else if (dtype == 1) {
    blend_add_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (float*)mosaic, (float*)swp, (float*)sw, (const __nv_bfloat16*)preds,
        (const float*)mask, (const int*)starts, (const float*)valid, (const float*)initv, (int)n,
        h, w, RH, RW);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int prv2_blend_finalize(const void* mosaic, const void* swp, const void* sw,
                                   void* out, long long total, int dtype, void* stream) {
  if (total == 0) return 0;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  blend_finalize_kernel<<<blocks_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)mosaic, (const float*)swp, (const float*)sw, (float*)out, total);
  return (int)cudaGetLastError();
}
