// K1: torchvision roi_align(aligned=True) with sampling_ratio 1, NHWC.
//
// Replaces patchrefinerv2_tpu/ops/roi_align.py:86 `roi_align_mxu`, which
// builds per-box one-hot interpolation matrices and contracts them with the
// feature map on the MXU (and :129 `roi_align_gather`, whose sampling_ratio
// > 1 is not needed: every call site uses 1).
//
// On Hopper this is a direct gather: output (n, i, j, c) is the 2-tap x
// 2-tap bilinear sample of feature map box_idx[n] at
//   y = y1 + (i + 0.5) * (y2 - y1) / OH,  x = x1 + (j + 0.5) * (x2 - x1) / OW,
// with box coordinates box * spatial_scale - 0.5 and torchvision's border
// rule (a sample with y < -1 or y > H gives 0, otherwise the coordinate is
// clamped into [0, H - 1]). It is bound by bytes: each output element reads
// four feature elements and does ~10 flops. The design: one thread per
// output element with channels fastest, so a warp's loads of the four taps
// coalesce over neighbouring channels; the per-element coordinate arithmetic
// is recomputed in registers (cheaper than a table) with rounded, unfused
// float32 operations so that it gives the same coordinates as the plain
// version. Taps along H are combined first, then along W, the order of the
// reference's two contractions; accumulation is float32 for bfloat16 too.
// A box index outside [0, B) gives zeros instead of a read outside the maps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The two taps and weights of coordinate v on an axis of n samples.
__device__ __forceinline__ void taps(float v, int64_t n, int64_t* i0, int64_t* i1,
                                     float* w0, float* w1) {
  const bool valid = (v >= -1.0f) && (v <= (float)n);
  const float vc = fminf(fmaxf(v, 0.0f), (float)(n - 1));
  const float fl = floorf(vc);
  const float fr = __fsub_rn(vc, fl);
  *i0 = (int64_t)fl;
  *i1 = *i0 + 1 < n ? *i0 + 1 : n - 1;
  *w0 = valid ? __fsub_rn(1.0f, fr) : 0.0f;
  *w1 = valid ? fr : 0.0f;
}

__device__ __forceinline__ float coord(float lo, float hi, int64_t i, int64_t n) {
  const float bin = __fdiv_rn(__fsub_rn(hi, lo), (float)n);
  return __fadd_rn(lo, __fmul_rn(__fadd_rn((float)i, 0.5f), bin));
}

template <typename T>
__global__ void roi_align_kernel(const T* __restrict__ f, const float* __restrict__ boxes,
                                 const int* __restrict__ bidx, T* __restrict__ out, int64_t N,
                                 int64_t B, int64_t H, int64_t W, int64_t C, int64_t OH,
                                 int64_t OW, float scale) {
  const int64_t total = N * OH * OW * C;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += step) {
    const int64_t c = idx % C;
    int64_t t = idx / C;
    const int64_t j = t % OW;
    t /= OW;
    const int64_t i = t % OH;
    const int64_t n = t / OH;
    const int64_t bi = __ldg(bidx + n);
    if (bi < 0 || bi >= B) {
      st(out + idx, 0.0f);
      continue;
    }
    const float* bx = boxes + 4 * n;
    const float x1 = __fsub_rn(__fmul_rn(__ldg(bx + 0), scale), 0.5f);
    const float y1 = __fsub_rn(__fmul_rn(__ldg(bx + 1), scale), 0.5f);
    const float x2 = __fsub_rn(__fmul_rn(__ldg(bx + 2), scale), 0.5f);
    const float y2 = __fsub_rn(__fmul_rn(__ldg(bx + 3), scale), 0.5f);
    int64_t ya, yb, xa, xb;
    float ay0, ay1, ax0, ax1;
    taps(coord(y1, y2, i, OH), H, &ya, &yb, &ay0, &ay1);
    taps(coord(x1, x2, j, OW), W, &xa, &xb, &ax0, &ax1);
    const T* fb = f + bi * H * W * C + c;
    const float v0 = ay0 * ld(fb + (ya * W + xa) * C) + ay1 * ld(fb + (yb * W + xa) * C);
    const float v1 = ay0 * ld(fb + (ya * W + xb) * C) + ay1 * ld(fb + (yb * W + xb) * C);
    st(out + idx, ax0 * v0 + ax1 * v1);
  }
}

int blocks_for(int64_t total, int threads) {
  int64_t b = (total + threads - 1) / threads;
  const int64_t cap = 132 * 32;
  return (int)(b < cap ? b : cap);
}

}  // namespace

extern "C" int prv2_roi_align(const void* f, const void* boxes, const void* bidx, void* out,
                              long long N, long long B, long long H, long long W, long long C,
                              long long OH, long long OW, float scale, int dtype, void* stream) {
  const int64_t total = (int64_t)N * OH * OW * C;
  if (total == 0) return 0;
  const int threads = 256;
  const int blocks = blocks_for(total, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    roi_align_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)f, (const float*)boxes, (const int*)bidx, (float*)out, N, B, H, W, C, OH,
        OW, scale);
  } else if (dtype == 1) {
    roi_align_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)f, (const float*)boxes, (const int*)bidx, (__nv_bfloat16*)out, N, B,
        H, W, C, OH, OW, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
