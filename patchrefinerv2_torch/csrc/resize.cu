// K2: F.interpolate-exact resize (bilinear with align_corners on or off,
// nearest) and the fused crop + resize of raw patches, NHWC.
//
// Replaces patchrefinerv2_tpu/ops/resize.py:214 `resize` (dense
// interpolation matrices contracted on the MXU, `resize_matrix` :106) and
// models/tiling.py:229 `crop_resize_patches` (a dynamic_slice per patch,
// then the two matrix contractions).
//
// On Hopper the work is a gather: every output element reads at most 2x2
// input elements. It is bound by bytes (each input read once, each output
// written once; ~6 flops per output element). The design: one thread per
// output element with channels fastest, so a warp reads neighbouring
// channels of the same source pixels and the loads coalesce; the per-axis
// taps (two source indices and two weights per output row and column) are
// computed once on the host in float32 exactly as the reference's
// `_resize_matrix_np` computes its weights and passed in as four small
// tables, which stay in L1. The crop entry reads the raw frame directly at
// each patch's start, so no cropped copy is ever written; a crop reaching
// outside the H x W frame gives zeros instead of a read outside it.
//
// Sum order: the H taps are combined first, then the W taps, as the
// reference contracts the H matrix first. Accumulation is float32 for
// bfloat16 inputs too.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// x: source of H rows of W*C elements, batch b at x + b * batch_stride.
// starts: (n, 2) [h, w] crop origins added to the tap indices, or null.
template <typename T>
__global__ void resize_kernel(const T* __restrict__ x, T* __restrict__ y,
                              const int* __restrict__ iy, const float* __restrict__ wy,
                              const int* __restrict__ ix, const float* __restrict__ wx,
                              const int* __restrict__ starts, int64_t n, int64_t H,
                              int64_t W, int64_t C, int64_t OH, int64_t OW,
                              int64_t batch_stride) {
  const int64_t total = n * OH * OW * C;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += step) {
    const int64_t c = idx % C;
    int64_t t = idx / C;
    const int64_t p = t % OW;
    t /= OW;
    const int64_t o = t % OH;
    const int64_t b = t / OH;
    int64_t oy = 0, ox = 0;
    if (starts != nullptr) {
      oy = starts[2 * b];
      ox = starts[2 * b + 1];
    }
    const int64_t y0 = oy + iy[o], y1 = oy + iy[OH + o];
    const int64_t x0 = ox + ix[p], x1 = ox + ix[OW + p];
    if (y0 < 0 || y1 >= H || x0 < 0 || x1 >= W) {
      st(y + idx, 0.0f);
      continue;
    }
    const float a0 = wy[o], a1 = wy[OH + o];
    const float b0 = wx[p], b1 = wx[OW + p];
    const T* src = x + b * batch_stride + c;
    const int64_t rs = W * C;
    const float v0 = a0 * ld(src + y0 * rs + x0 * C) + a1 * ld(src + y1 * rs + x0 * C);
    const float v1 = a0 * ld(src + y0 * rs + x1 * C) + a1 * ld(src + y1 * rs + x1 * C);
    st(y + idx, b0 * v0 + b1 * v1);
  }
}

int blocks_for(int64_t total, int threads) {
  int64_t b = (total + threads - 1) / threads;
  const int64_t cap = 132 * 32;  // grid-stride beyond 32 blocks per SM
  return (int)(b < cap ? b : cap);
}

}  // namespace

extern "C" int prv2_resize(const void* x, void* y, const void* iy, const void* wy,
                           const void* ix, const void* wx, const void* starts,
                           long long n, long long H, long long W, long long C, long long OH,
                           long long OW, long long batch_stride, int dtype, void* stream) {
  const int64_t total = (int64_t)n * OH * OW * C;
  if (total == 0) return 0;
  const int threads = 256;
  const int blocks = blocks_for(total, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    resize_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)x, (float*)y, (const int*)iy, (const float*)wy, (const int*)ix,
        (const float*)wx, (const int*)starts, n, H, W, C, OH, OW, batch_stride);
  } else if (dtype == 1) {
    resize_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, (const int*)iy, (const float*)wy,
        (const int*)ix, (const float*)wx, (const int*)starts, n, H, W, C, OH, OW, batch_stride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
