// K11: canny non-maximum suppression, bilinear-interpolated over the four
// gradient sectors (skimage.feature.canny's NMS).
//
// Replaces patchrefinerv2_tpu/ops/canny.py:14 `canny_nms`, which the JAX
// package evaluates in float64 numpy on the host for the boundary metrics
// (evaluation/metrics.py:107) and in float32 in the training-loss graph.
//
// A 2-D stencil: a block of 32x8 threads stages its 34x10 tile of the
// magnitude, with a one-pixel halo that reads 0 outside the map (the
// reference's zero pad), in shared memory; each thread then picks its
// pixel's sector from the signs and sizes of the two gradients and compares
// the magnitude with the two neighbours interpolated along the gradient. The
// arithmetic is the reference's, operation for operation and in its operand
// order, with round-to-nearest intrinsics so that no multiply-add is
// contracted: in float64 the mask equals the plain version's bit for bit. It
// is bound by bytes (three maps read once, one byte a pixel written); the
// halo's re-reads hit shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

template <typename T>
struct Op;

template <>
struct Op<float> {
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
};

template <>
struct Op<double> {
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
};

template <typename T>
__global__ void canny_nms_kernel(const T* __restrict__ isobel, const T* __restrict__ jsobel,
                                 const T* __restrict__ mag, uint8_t* __restrict__ out, int64_t H,
                                 int64_t W) {
  using O = Op<T>;
  __shared__ T tile[TY + 2][TX + 2];
  const int64_t plane = H * W;
  const T* m = mag + (int64_t)blockIdx.z * plane;
  const int64_t x0 = (int64_t)blockIdx.x * TX, y0 = (int64_t)blockIdx.y * TY;
  for (int k = threadIdx.y * TX + threadIdx.x; k < (TY + 2) * (TX + 2); k += TX * TY) {
    const int64_t y = y0 + k / (TX + 2) - 1, x = x0 + k % (TX + 2) - 1;
    tile[k / (TX + 2)][k % (TX + 2)] =
        (y >= 0 && y < H && x >= 0 && x < W) ? __ldg(m + y * W + x) : T(0);
  }
  __syncthreads();
  const int64_t y = y0 + threadIdx.y, x = x0 + threadIdx.x;
  if (y >= H || x >= W) return;
  const int64_t idx = (int64_t)blockIdx.z * plane + y * W + x;
  const T gi = __ldg(isobel + idx), gj = __ldg(jsobel + idx);
  const T ai = O::abs(gi), aj = O::abs(gj);
  const int d = O::mul(gi, gj) >= T(0) ? 1 : -1;  // same sign: the +diagonal
  const int cy = threadIdx.y + 1, cx = threadIdx.x + 1;
  const T eps = T(1e-12);
  T w, p_diag, p_axis, m_diag, m_axis;
  if (aj >= ai) {  // mostly horizontal: the right/left neighbours and their diagonals
    w = O::div(ai, O::add(aj, eps));
    p_diag = tile[cy + d][cx + 1];
    p_axis = tile[cy][cx + 1];
    m_diag = tile[cy - d][cx - 1];
    m_axis = tile[cy][cx - 1];
  } else {  // mostly vertical: the lower/upper neighbours and their diagonals
    w = O::div(aj, O::add(ai, eps));
    p_diag = tile[cy + 1][cx + d];
    p_axis = tile[cy + 1][cx];
    m_diag = tile[cy - 1][cx - d];
    m_axis = tile[cy - 1][cx];
  }
  const T rest = O::sub(T(1), w);
  const T c_plus = O::add(O::mul(p_diag, w), O::mul(p_axis, rest));
  const T c_minus = O::add(O::mul(m_diag, w), O::mul(m_axis, rest));
  const T c = tile[cy][cx];
  out[idx] = (c >= c_plus && c >= c_minus) ? 1 : 0;
}

}  // namespace

// dtype: 0 float32, 1 float64. out: one byte (0/1) a pixel, (B, H, W).
extern "C" int prv2_canny_nms(const void* isobel, const void* jsobel, const void* mag, void* out,
                              long long B, long long H, long long W, int dtype, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(TX, TY);
  const dim3 grid((unsigned)((W + TX - 1) / TX), (unsigned)((H + TY - 1) / TY), (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    canny_nms_kernel<float><<<grid, block, 0, s>>>((const float*)isobel, (const float*)jsobel,
                                                   (const float*)mag, (uint8_t*)out, H, W);
  } else if (dtype == 1) {
    canny_nms_kernel<double><<<grid, block, 0, s>>>((const double*)isobel, (const double*)jsobel,
                                                    (const double*)mag, (uint8_t*)out, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
