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
// clamped into [0, H - 1]). Taps along H are combined first, then along W,
// the order of the reference's two contractions; accumulation is float32.
// A box index outside [0, B) gives zeros instead of a read outside the maps.
//
// Bound: bytes, the output's writes (each box's crop at the level's full
// size: ~744 MB for the 7 levels of a flagship chunk of 16 boxes; the maps
// are read from L2 after the first box). The design:
// - one block per (box, band of output rows), the band sized by the host
//   (ops/roi_align.py `launch_plan`) to ~32 KB of output;
// - the taps computed once: the band's y taps and the row's OW x taps in
//   shared memory, by the rounded, unfused operations of the plain version
//   (`_axis_taps`), so that both give the same taps;
// - 32-bit index arithmetic inside a box; only the box's base offsets are
//   64-bit;
// - 16-byte vectors: along the channels (8 bfloat16 or 4 float32 of one
//   pixel, mode CHANNELS) wherever C and the addresses allow it, along the
//   columns for a 1-channel map (V consecutive outputs of a row, mode
//   COLUMNS), else one element a thread (mode SCALAR);
// - the bilinear sum in float32 with __fmul_rn / __fadd_rn, the plain
//   version's separately rounded products and sums (bit for bit).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;
enum { MODE_SCALAR = 0, MODE_CHANNELS = 1, MODE_COLUMNS = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// V = 16 / sizeof(T) consecutive elements as float32, and back
template <typename T> struct Vec {
  static constexpr int V = 16 / sizeof(T);
  float x[V];
  __device__ __forceinline__ void load(const T* p) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = to_f(e[k]);
  }
  __device__ __forceinline__ void store(T* p) const {
    alignas(16) T e[V];
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = from_f<T>(x[k]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
  }
};

// The taps of sample i of n on an axis of `size` samples between lo and
// hi: indices i0, i1 and weights w0, w1 (zero outside [-1, size])
struct Taps {
  int i0, i1;
  float w0, w1;
};
__device__ __forceinline__ Taps taps(float lo, float hi, int i, int n, int size) {
  const float bin = __fdiv_rn(__fsub_rn(hi, lo), (float)n);
  const float v = __fadd_rn(lo, __fmul_rn(__fadd_rn((float)i, 0.5f), bin));
  const bool valid = v >= -1.0f && v <= (float)size;
  const float vc = fminf(fmaxf(v, 0.0f), (float)(size - 1));
  const float fl = floorf(vc), fr = __fsub_rn(vc, fl);
  Taps t;
  t.i0 = (int)fl;
  t.i1 = t.i0 + 1 < size ? t.i0 + 1 : size - 1;
  t.w0 = valid ? __fsub_rn(1.0f, fr) : 0.0f;
  t.w1 = valid ? fr : 0.0f;
  return t;
}

// (ay0 * a + ay1 * b) along H, then ax0 * (.) + ax1 * (.) along W
__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

template <typename T, int MODE>
__global__ void __launch_bounds__(NT) roi_align_kernel(const T* __restrict__ f, const float* __restrict__ boxes,
                                                       const int* __restrict__ bidx, T* __restrict__ out, int B,
                                                       int H, int W, int C, int OH, int OW, int band, float scale) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  Taps* xt = reinterpret_cast<Taps*>(smem);  // [OW]
  Taps* yt = xt + OW;                         // [band]
  const int n = blockIdx.y, r0 = blockIdx.x * band;
  const int rows = min(band, OH - r0);
  const int row_elems = OW * C;
  T* o = out + ((int64_t)n * OH + r0) * row_elems;
  const int bi = __ldg(bidx + n);
  if (bi < 0 || bi >= B) {
    for (int e = threadIdx.x; e < rows * row_elems; e += NT) o[e] = from_f<T>(0.f);
    return;
  }
  const float x1 = __fsub_rn(__fmul_rn(__ldg(boxes + 4 * n + 0), scale), 0.5f);
  const float y1 = __fsub_rn(__fmul_rn(__ldg(boxes + 4 * n + 1), scale), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(__ldg(boxes + 4 * n + 2), scale), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(__ldg(boxes + 4 * n + 3), scale), 0.5f);
  for (int j = threadIdx.x; j < OW; j += NT) xt[j] = taps(x1, x2, j, OW, W);
  for (int r = threadIdx.x; r < rows; r += NT) yt[r] = taps(y1, y2, r0 + r, OH, H);
  __syncthreads();
  const T* fb = f + (int64_t)bi * H * W * C;
  if constexpr (MODE == MODE_CHANNELS) {
    // a thread: V channels of one output pixel; a warp's lanes neighbouring
    // vectors of a pixel row
    const int cv = C / V, per_row = OW * cv;
    for (int e = threadIdx.x; e < rows * per_row; e += NT) {
      const int r = e / per_row, q = e - r * per_row, j = q / cv, c = (q - j * cv) * V;
      const Taps ty = yt[r], tx = xt[j];
      Vec<T> a, b, s, t;
      a.load(fb + (ty.i0 * W + tx.i0) * C + c);
      b.load(fb + (ty.i1 * W + tx.i0) * C + c);
      s.load(fb + (ty.i0 * W + tx.i1) * C + c);
      t.load(fb + (ty.i1 * W + tx.i1) * C + c);
#pragma unroll
      for (int k = 0; k < V; ++k)
        a.x[k] = lerp2(tx.w0, lerp2(ty.w0, a.x[k], ty.w1, b.x[k]), tx.w1, lerp2(ty.w0, s.x[k], ty.w1, t.x[k]));
      a.store(o + r * row_elems + j * C + c);
    }
  } else if constexpr (MODE == MODE_COLUMNS) {
    // C == 1: a thread V consecutive outputs of a row
    const int per_row = OW / V;
    for (int e = threadIdx.x; e < rows * per_row; e += NT) {
      const int r = e / per_row, j0 = (e - r * per_row) * V;
      const Taps ty = yt[r];
      const T* ra = fb + ty.i0 * W;
      const T* rb = fb + ty.i1 * W;
      Vec<T> v;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const Taps tx = xt[j0 + k];
        v.x[k] = lerp2(tx.w0, lerp2(ty.w0, to_f(ra[tx.i0]), ty.w1, to_f(rb[tx.i0])), tx.w1,
                       lerp2(ty.w0, to_f(ra[tx.i1]), ty.w1, to_f(rb[tx.i1])));
      }
      v.store(o + r * OW + j0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * row_elems; e += NT) {
      const int r = e / row_elems, q = e - r * row_elems, j = q / C, c = q - j * C;
      const Taps ty = yt[r], tx = xt[j];
      const float v0 = lerp2(ty.w0, to_f(fb[(ty.i0 * W + tx.i0) * C + c]), ty.w1, to_f(fb[(ty.i1 * W + tx.i0) * C + c]));
      const float v1 = lerp2(ty.w0, to_f(fb[(ty.i0 * W + tx.i1) * C + c]), ty.w1, to_f(fb[(ty.i1 * W + tx.i1) * C + c]));
      o[e] = from_f<T>(lerp2(tx.w0, v0, tx.w1, v1));
    }
  }
}

template <typename T>
int launch(const void* f, const float* boxes, const int* bidx, void* out, int N, int B, int H, int W, int C,
           int OH, int OW, int band, int mode, float scale, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(f) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (mode == MODE_CHANNELS && !(aligned && C % V == 0)) return (int)cudaErrorInvalidValue;
  if (mode == MODE_COLUMNS && !(aligned && C == 1 && OW % V == 0)) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)(OW + band) * sizeof(Taps);
  auto kern = mode == MODE_CHANNELS ? roi_align_kernel<T, MODE_CHANNELS>
              : mode == MODE_COLUMNS ? roi_align_kernel<T, MODE_COLUMNS>
                                     : roi_align_kernel<T, MODE_SCALAR>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((OH + band - 1) / band), (unsigned)N);
  kern<<<grid, NT, bytes, s>>>(static_cast<const T*>(f), boxes, bidx, static_cast<T*>(out), B, H, W, C, OH, OW,
                               band, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// f: (B, H, W, C) contiguous; boxes: float32 (N, 4); bidx: int32 (N,); out:
// (N, OH, OW, C). band: output rows a block; mode: 0 one element a thread,
// 1 16-byte channel vectors (C a multiple of 16 / itemsize), 2 16-byte
// column vectors (C == 1, OW a multiple of 16 / itemsize), both with 16-byte
// aligned f and out: ops/roi_align.py `launch_plan`. dtype: 0 float32, 1
// bfloat16.
extern "C" int prv2_roi_align(const void* f, const void* boxes, const void* bidx, void* out,
                              long long N, long long B, long long H, long long W, long long C,
                              long long OH, long long OW, long long band, long long mode, float scale,
                              int dtype, void* stream) {
  if (N * OH * OW * C == 0) return 0;
  // 32-bit offsets inside a box's map and a band's rows
  if (H * W * C >= (1ll << 31) || OH * OW * C >= (1ll << 31) || band < 1 || N > 65535 || mode < 0 ||
      mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  const int* bi = static_cast<const int*>(bidx);
  if (dtype == 0)
    return launch<float>(f, bx, bi, out, (int)N, (int)B, (int)H, (int)W, (int)C, (int)OH, (int)OW, (int)band,
                         (int)mode, scale, s);
  if (dtype == 1)
    return launch<bf16>(f, bx, bi, out, (int)N, (int)B, (int)H, (int)W, (int)C, (int)OH, (int)OW, (int)band,
                        (int)mode, scale, s);
  return (int)cudaErrorInvalidValue;
}
