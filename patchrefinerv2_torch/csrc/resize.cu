// K2: F.interpolate-exact resize (bilinear with align_corners on or off,
// nearest, bicubic with an optional explicit scale factor) and the fused
// crop + resize of raw patches, NHWC.
//
// Replaces patchrefinerv2_tpu/ops/resize.py:214 `resize` (dense
// interpolation matrices contracted on the MXU, `resize_matrix` :106,
// `_resize_matrix_np` :29) and models/tiling.py:229 `crop_resize_patches`
// (a dynamic_slice per patch, then the two matrix contractions).
//
// On Hopper the work is a gather: every output element reads at most
// NTAP x NTAP input elements (2 x 2 for bilinear and nearest, 4 x 4 for
// bicubic). It is bound by bytes (each input read once, each output written
// once). The design: one thread per output element with channels fastest,
// so a warp reads neighbouring channels of the same source pixels and the
// loads coalesce; the per-axis taps (NTAP source indices and weights per
// output row and column, clamped at the borders, bicubic with torch's
// A = -0.75) are computed once on the host in float32 exactly as the
// reference's `_resize_matrix_np` computes its weights and passed in as
// four small tables, which stay in L1. The crop entry reads the raw frame
// directly at each patch's start, so no cropped copy is ever written; a
// crop reaching outside the H x W frame gives zeros instead of a read
// outside it.
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
// iy, wy: (NTAP, OH) taps of the rows; ix, wx: (NTAP, OW) of the columns.
// starts: (n, 2) [h, w] crop origins added to the tap indices, or null.
template <typename T, int NTAP>
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
    const T* src = x + b * batch_stride + c;
    const int64_t rs = W * C;
    if constexpr (NTAP == 2) {  // written out: the loop below ran slower here on the H100
      const int64_t y0 = oy + iy[o], y1 = oy + iy[OH + o];
      const int64_t x0 = ox + ix[p], x1 = ox + ix[OW + p];
      if (y0 < 0 || y1 >= H || x0 < 0 || x1 >= W) {
        st(y + idx, 0.0f);
        continue;
      }
      const float a0 = wy[o], a1 = wy[OH + o];
      const float b0 = wx[p], b1 = wx[OW + p];
      const float v0 = a0 * ld(src + y0 * rs + x0 * C) + a1 * ld(src + y1 * rs + x0 * C);
      const float v1 = a0 * ld(src + y0 * rs + x1 * C) + a1 * ld(src + y1 * rs + x1 * C);
      st(y + idx, b0 * v0 + b1 * v1);
    } else {
      // taps are ordered, so the first and the last bound them all
      if (oy + iy[o] < 0 || oy + iy[(NTAP - 1) * OH + o] >= H || ox + ix[p] < 0 ||
          ox + ix[(NTAP - 1) * OW + p] >= W) {
        st(y + idx, 0.0f);
        continue;
      }
      float acc = 0.0f;
#pragma unroll
      for (int tx = 0; tx < NTAP; ++tx) {
        const int64_t xc = (ox + ix[tx * OW + p]) * C;
        float v = 0.0f;
#pragma unroll
        for (int ty = 0; ty < NTAP; ++ty)
          v += wy[ty * OH + o] * ld(src + (oy + iy[ty * OH + o]) * rs + xc);
        acc += wx[tx * OW + p] * v;
      }
      st(y + idx, acc);
    }
  }
}

int blocks_for(int64_t total, int threads) {
  int64_t b = (total + threads - 1) / threads;
  const int64_t cap = 132 * 32;  // grid-stride beyond 32 blocks per SM
  return (int)(b < cap ? b : cap);
}

template <typename T>
int launch(const void* x, void* y, const void* iy, const void* wy, const void* ix, const void* wx,
           const void* starts, int64_t n, int64_t H, int64_t W, int64_t C, int64_t OH, int64_t OW,
           int64_t batch_stride, int taps, cudaStream_t s) {
  const int64_t total = n * OH * OW * C;
  const int threads = 256;
  const int blocks = blocks_for(total, threads);
  if (taps == 2) {
    resize_kernel<T, 2><<<blocks, threads, 0, s>>>(
        (const T*)x, (T*)y, (const int*)iy, (const float*)wy, (const int*)ix, (const float*)wx,
        (const int*)starts, n, H, W, C, OH, OW, batch_stride);
  } else if (taps == 4) {
    resize_kernel<T, 4><<<blocks, threads, 0, s>>>(
        (const T*)x, (T*)y, (const int*)iy, (const float*)wy, (const int*)ix, (const float*)wx,
        (const int*)starts, n, H, W, C, OH, OW, batch_stride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int prv2_resize(const void* x, void* y, const void* iy, const void* wy,
                           const void* ix, const void* wx, const void* starts,
                           long long n, long long H, long long W, long long C, long long OH,
                           long long OW, long long batch_stride, long long taps, int dtype,
                           void* stream) {
  if ((int64_t)n * OH * OW * C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, y, iy, wy, ix, wx, starts, n, H, W, C, OH, OW, batch_stride,
                         (int)taps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, iy, wy, ix, wx, starts, n, H, W, C, OH, OW, batch_stride,
                                 (int)taps, s);
  return (int)cudaErrorInvalidValue;
}
