// K11: canny non-maximum suppression, bilinear-interpolated over the four
// gradient sectors (skimage.feature.canny's NMS), with a mask mode that also
// applies the callers' epilogue in the same launch.
//
// Replaces patchrefinerv2_tpu/ops/canny.py:14 `canny_nms`, which the JAX
// package evaluates in float64 numpy on the host for the boundary metrics
// (evaluation/metrics.py:107-110) and in float32 in the training loss's
// graph (models/losses_extra.py:125-128). The mask mode computes what both
// callers do next: `lm & region & (magnitude > 0)`, then `>= low` and
// `>= high`, with the region the 1-pixel interior (from the indices, no
// read) or a given byte mask; it writes the low and the high mask.
//
// What bounds it: three maps read (12 or 24 bytes a pixel) and one or two
// bytes written. At the training loss's (4, 384, 512) the maps (9.4 MB) sit
// in L2, where the Sobel convolutions have just written them, so a kernel
// that waits on one round trip after another is bound by that chain of
// latencies, not by the bytes.
//
// The design: a register-strip stencil with no shared memory and no block
// barrier. A thread owns V = 4 consecutive pixels of a row, loaded as 16-byte
// vectors (two in float64); a warp covers a column strip of 32 * V pixels and
// walks R rows down it, keeping the magnitude rows y - 1, y and y + 1 in
// registers as a rolling window and loading row y + 2 and the gradients of
// row y + 1 one row ahead, so that each thread has several loads in flight.
// A pixel's left and right neighbours come from the adjacent lanes by
// __shfl_up_sync / __shfl_down_sync (called by all 32 lanes, never under a
// lane-divergent branch); at the strip's two outer columns lanes 0 and 31
// each load one scalar a row, 0 outside the map as the reference's zero pad.
// Each thread stores its V mask bytes as one 4-byte word. Rows wider than a
// multiple of V or not 16-byte aligned take the scalar path of the same
// kernel (VEC = false: one element at a time, each bounds-checked). The
// wrapper (ops/canny.py `canny_nms_plan`) picks R from the shape so that the
// grid holds enough warps to fill the card.
//
// The arithmetic is the reference's, operation for operation and in its
// operand order, with round-to-nearest intrinsics so that no multiply-add is
// contracted: in float64 the masks equal the plain version's bit for bit.
// The two sectors' weights differ only in which absolute gradient is the
// numerator, so one division serves both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int V = 4;              // pixels a thread
constexpr int LANES = 32;         // threads a warp
constexpr int STRIP = V * LANES;  // pixels a warp's column strip
constexpr int WARPS = 4;          // warps a block, each walking its own strip
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Op;

template <>
struct Op<float> {
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  // v[0..3] = p[0..3]: one 16-byte load
  static __device__ __forceinline__ void load4(const float* p, float (&v)[V]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
};

template <>
struct Op<double> {
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  // v[0..3] = p[0..3]: two 16-byte loads
  static __device__ __forceinline__ void load4(const double* p, double (&v)[V]) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
};

// v[i] = row[x + i], 0 where the row is outside the map (ok false) or x + i
// is not below W. VEC: W is a multiple of V and the row 16-byte aligned, so
// a thread's V pixels lie all inside the row or all outside it.
template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const T* row, bool ok, int64_t x, int64_t W, T (&v)[V]) {
  if (VEC) {
    if (ok && x < W) {
      Op<T>::load4(row + x, v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = T(0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = (ok && x + i < W) ? __ldg(row + x + i) : T(0);
  }
}

template <bool VEC>
__device__ __forceinline__ void load_bytes(const uint8_t* row, int64_t x, int64_t W, uint8_t (&v)[V]) {
  if (VEC) {
    const uint32_t q = x < W ? __ldg(reinterpret_cast<const unsigned int*>(row + x)) : 0u;
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = (uint8_t)(q >> (8 * i));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = x + i < W ? __ldg(row + x + i) : (uint8_t)0;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_bytes(uint8_t* row, int64_t x, int64_t W, const bool (&b)[V]) {
  if (VEC) {
    if (x < W) {
      uint32_t q = 0;
#pragma unroll
      for (int i = 0; i < V; ++i) q |= (uint32_t)b[i] << (8 * i);
      *reinterpret_cast<uint32_t*>(row + x) = q;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (x + i < W) row[x + i] = b[i];
  }
}

// A magnitude row as the thread loads it: its V pixels and, lanes 0 and 31
// only, the pixel just outside the strip on their side (0 elsewhere).
template <typename T>
struct Raw {
  T v[V];
  T edge;
};

template <typename T, bool VEC>
__device__ __forceinline__ Raw<T> load_raw(const T* plane, int64_t y, int64_t H, int64_t W,
                                           int64_t xs, int64_t x, int lane) {
  Raw<T> r;
  const bool ok = y >= 0 && y < H;
  const T* row = plane + (ok ? y : 0) * W;
  load_row<T, VEC>(row, ok, x, W, r.v);
  const int64_t xe = lane == 0 ? xs - 1 : xs + STRIP;
  r.edge = (ok && (lane == 0 || lane == LANES - 1) && xe >= 0 && xe < W) ? __ldg(row + xe) : T(0);
  return r;
}

// The window row of a raw row: m[0] the pixel left of the thread's V, m[1..V]
// its own, m[V + 1] the pixel right of them. Every lane shuffles.
template <typename T>
__device__ __forceinline__ void window_row(const Raw<T>& r, int lane, T (&m)[V + 2]) {
  T left = __shfl_up_sync(FULL, r.v[V - 1], 1);
  T right = __shfl_down_sync(FULL, r.v[0], 1);
  if (lane == 0) left = r.edge;
  if (lane == LANES - 1) right = r.edge;
  m[0] = left;
#pragma unroll
  for (int i = 0; i < V; ++i) m[i + 1] = r.v[i];
  m[V + 1] = right;
}

// MODE 0: the local-maxima mask into out. MODE 1 (the interior) and 2 (the
// byte mask `region`): out = low, out_high = high.
template <typename T, bool VEC, int R, int MODE>
__global__ void __launch_bounds__(WARPS * LANES)
    canny_nms_kernel(const T* __restrict__ isobel, const T* __restrict__ jsobel,
                     const T* __restrict__ mag, const uint8_t* __restrict__ region,
                     uint8_t* __restrict__ out, uint8_t* __restrict__ out_high, int64_t H, int64_t W,
                     int64_t strips, int64_t bands, int64_t tasks, double lo_d, double hi_d) {
  using O = Op<T>;
  const int lane = threadIdx.x % LANES;
  const int64_t task = (int64_t)blockIdx.x * WARPS + threadIdx.x / LANES;
  if (task >= tasks) return;  // a whole warp: its task is past the last
  const int64_t cs = task % strips, band = (task / strips) % bands, b = task / (strips * bands);
  const int64_t xs = cs * STRIP, x = xs + (int64_t)lane * V, y0 = band * R;
  const int64_t base = b * H * W;
  const T* mp = mag + base;
  const T lo = T(lo_d), hi = T(hi_d), eps = T(1e-12);

  T up[V + 2], mid[V + 2], gi[V], gj[V];
  window_row(load_raw<T, VEC>(mp, y0 - 1, H, W, xs, x, lane), lane, up);
  window_row(load_raw<T, VEC>(mp, y0, H, W, xs, x, lane), lane, mid);
  Raw<T> next = load_raw<T, VEC>(mp, y0 + 1, H, W, xs, x, lane);
  load_row<T, VEC>(isobel + base + y0 * W, true, x, W, gi);
  load_row<T, VEC>(jsobel + base + y0 * W, true, x, W, gj);

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t y = y0 + r;
    if (y >= H) break;  // the whole warp: y is the same on every lane
    // one row ahead: the magnitude row y + 2 and the gradients of row y + 1
    Raw<T> ahead;
    T gi2[V], gj2[V];
    if (r + 1 < R) {
      ahead = load_raw<T, VEC>(mp, y + 2, H, W, xs, x, lane);
      const bool ok = y + 1 < H;
      load_row<T, VEC>(isobel + base + (ok ? y + 1 : 0) * W, ok, x, W, gi2);
      load_row<T, VEC>(jsobel + base + (ok ? y + 1 : 0) * W, ok, x, W, gj2);
    }
    T dn[V + 2];
    window_row(next, lane, dn);
    uint8_t rg[V];
    if (MODE == 2) load_bytes<VEC>(region + base + y * W, x, W, rg);

    bool lm[V], hm[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const T c = mid[i + 1];
      const T ai = O::abs(gi[i]), aj = O::abs(gj[i]);
      const bool same = O::mul(gi[i], gj[i]) >= T(0);  // the +diagonal
      const bool horiz = aj >= ai;  // mostly horizontal: the right/left neighbours
      const T w = O::div(horiz ? ai : aj, O::add(horiz ? aj : ai, eps));
      T p_diag, p_axis, m_diag, m_axis;
      if (horiz) {
        p_diag = same ? dn[i + 2] : up[i + 2];
        p_axis = mid[i + 2];
        m_diag = same ? up[i] : dn[i];
        m_axis = mid[i];
      } else {  // mostly vertical: the lower/upper neighbours
        p_diag = same ? dn[i + 2] : dn[i];
        p_axis = dn[i + 1];
        m_diag = same ? up[i] : up[i + 2];
        m_axis = up[i + 1];
      }
      const T rest = O::sub(T(1), w);
      const T c_plus = O::add(O::mul(p_diag, w), O::mul(p_axis, rest));
      const T c_minus = O::add(O::mul(m_diag, w), O::mul(m_axis, rest));
      const bool is_max = c >= c_plus && c >= c_minus;
      if (MODE == 0) {
        lm[i] = is_max;
      } else {
        const int64_t xi = x + i;
        const bool in_region =
            MODE == 1 ? (y >= 1 && y + 1 < H && xi >= 1 && xi + 1 < W) : rg[i] != 0;
        const bool keep = is_max && in_region && c > T(0);
        lm[i] = keep && c >= lo;
        hm[i] = keep && c >= hi;
      }
    }
    store_bytes<VEC>(out + base + y * W, x, W, lm);
    if (MODE != 0) store_bytes<VEC>(out_high + base + y * W, x, W, hm);

    if (r + 1 < R) {
#pragma unroll
      for (int i = 0; i < V + 2; ++i) up[i] = mid[i], mid[i] = dn[i];
#pragma unroll
      for (int i = 0; i < V; ++i) gi[i] = gi2[i], gj[i] = gj2[i];
      next = ahead;
    }
  }
}

template <typename T, bool VEC, int R>
int launch_mode(const void* isobel, const void* jsobel, const void* mag, const void* region,
                void* out, void* out_high, int64_t H, int64_t W, int64_t strips, int64_t bands,
                int64_t tasks, int mode, double lo, double hi, cudaStream_t s) {
  const dim3 grid((unsigned)((tasks + WARPS - 1) / WARPS)), block(WARPS * LANES);
  const T* gi = (const T*)isobel;
  const T* gj = (const T*)jsobel;
  const T* m = (const T*)mag;
  const uint8_t* rg = (const uint8_t*)region;
  uint8_t *o = (uint8_t*)out, *oh = (uint8_t*)out_high;
  if (mode == 0) {
    canny_nms_kernel<T, VEC, R, 0><<<grid, block, 0, s>>>(gi, gj, m, rg, o, oh, H, W, strips, bands,
                                                          tasks, lo, hi);
  } else if (mode == 1) {
    canny_nms_kernel<T, VEC, R, 1><<<grid, block, 0, s>>>(gi, gj, m, rg, o, oh, H, W, strips, bands,
                                                          tasks, lo, hi);
  } else if (mode == 2) {
    canny_nms_kernel<T, VEC, R, 2><<<grid, block, 0, s>>>(gi, gj, m, rg, o, oh, H, W, strips, bands,
                                                          tasks, lo, hi);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_rows(int rows, const void* isobel, const void* jsobel, const void* mag,
                const void* region, void* out, void* out_high, int64_t B, int64_t H, int64_t W,
                int mode, double lo, double hi, cudaStream_t s) {
  const int64_t strips = (W + STRIP - 1) / STRIP, bands = (H + rows - 1) / rows;
  const int64_t tasks = B * strips * bands;
  if ((tasks + WARPS - 1) / WARPS > 0x7fffffff) return (int)cudaErrorInvalidValue;
#define PRV2_NMS_ROWS(R)                                                                        \
  if (rows == R)                                                                                \
    return launch_mode<T, VEC, R>(isobel, jsobel, mag, region, out, out_high, H, W, strips, bands, \
                                  tasks, mode, lo, hi, s);
  PRV2_NMS_ROWS(4)
  PRV2_NMS_ROWS(8)
#undef PRV2_NMS_ROWS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 float64. rows: R, 4 or 8. vec: 1 for the
// vector path (W a multiple of 4, every map and mask 16-byte aligned; the
// wrapper checks), 0 for the scalar path. mode: 0 the local-maxima mask
// into out; 1 the low and high masks over the 1-pixel interior into out and
// out_high; 2 the same over the byte mask region. Masks: one byte (0/1) a
// pixel, (B, H, W).
extern "C" int prv2_canny_nms(const void* isobel, const void* jsobel, const void* mag,
                              const void* region, void* out, void* out_high, long long B,
                              long long H, long long W, long long rows, long long vec,
                              long long mode, double lo, double hi, int dtype, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return vec ? launch_rows<float, true>(rows, isobel, jsobel, mag, region, out, out_high, B, H, W,
                                          mode, lo, hi, s)
               : launch_rows<float, false>(rows, isobel, jsobel, mag, region, out, out_high, B, H,
                                           W, mode, lo, hi, s);
  }
  if (dtype == 1) {
    return vec ? launch_rows<double, true>(rows, isobel, jsobel, mag, region, out, out_high, B, H,
                                           W, mode, lo, hi, s)
               : launch_rows<double, false>(rows, isobel, jsobel, mag, region, out, out_high, B, H,
                                            W, mode, lo, hi, s);
  }
  return (int)cudaErrorInvalidValue;
}
