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
// once): the feature upsamples move ~2 GB a chunk (0.6 ms at 3.35 TB/s),
// four fifths of it the output. So what matters is wide, coalesced
// accesses and little index arithmetic per byte. The design:
//   - one block per (image, output row) segment: the row taps (NTAP source
//     rows and weights, clamped at the borders) are block-uniform and read
//     once; index math is 32-bit within an image (the largest image of any
//     call, 384 x 512 x 256 elements, is far below 2^31) and the 64-bit
//     image offset is computed once a block; there is no grid cap;
//   - the channel path (C * sizeof(T) a multiple of 4, 8 or 16 bytes that
//     the source pointer's alignment allows): each thread takes V channels
//     of one output pixel, the widest of 16, 8 or 4 bytes, so the 256-, 128-
//     and 64-channel feature upsamples make four 16-byte loads and one
//     16-byte store a thread;
//   - the run path (every other width: the single-channel predictions,
//     canvases and metric maps, the 3-channel crop, unaligned views): a
//     block computes a segment of 256 x 16 bytes of a row, one element a
//     thread at a time so that the tap and source reads coalesce, into
//     shared memory, and each thread then stores a run of 16 consecutive
//     bytes of it as one vector where the output rows allow;
//   - nearest, whose two taps of an axis always name one source index,
//     loads each value once (a template case, so no branch guards a load);
//     the arithmetic stays w0 * v + w1 * v, so the output equals the plain
//     version's bit for bit and inf and NaN propagate as there;
//   - the per-axis taps are computed once on the host in float32 exactly
//     as the reference's `_resize_matrix_np` computes its weights and
//     passed in as four small tables (bicubic with torch's A = -0.75).
// The crop entry reads the raw frame in place at each patch's start, so no
// cropped copy is written; a crop reaching outside the H x W frame gives
// zeros where a tap falls outside it instead of a read outside it.
//
// Sum order: the H taps are combined first, then the W taps, as the
// reference contracts the H matrix first. Accumulation is float32 for
// bfloat16 inputs too.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// V elements from an address aligned to V * sizeof(T) bytes, as floats
template <int V>
__device__ __forceinline__ void load(const float* p, float (&f)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = t.x, f[1] = t.y, f[2] = t.z, f[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    f[0] = t.x, f[1] = t.y;
  } else {
    static_assert(V == 1, "float vectors of 1, 2 or 4");
    f[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load(const bf16* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = __bfloat162float(p[0]);
  } else {
    static_assert(V == 2 || V == 4 || V == 8, "bfloat16 vectors of 1, 2, 4 or 8");
    uint32_t w[V / 2];
    if constexpr (V == 8) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
    } else if constexpr (V == 4) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = t.x, w[1] = t.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    }
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      f[2 * j] = t.x, f[2 * j + 1] = t.y;
    }
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&f)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {
    static_assert(V == 1, "float vectors of 1, 2 or 4");
    p[0] = f[0];
  }
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    p[0] = __float2bfloat16_rn(f[0]);
  } else {
    uint32_t w[V / 2];
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&t);
    }
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      static_assert(V == 2, "bfloat16 vectors of 1, 2, 4 or 8");
      *reinterpret_cast<uint32_t*>(p) = w[0];
    }
  }
}

struct Geo {
  int H, W, C, OH, OW;   // source rows, columns, channels; output rows, columns
  int64_t batch_stride;  // elements between source images (0: crops of one frame)
};

// The NTAP taps of output index i of an axis, packed on the host as
// NTAP source indices then NTAP float32 weights (their bits), 8 NTAP bytes
// an index: one 16-byte load for bilinear and nearest, two for bicubic.
template <int NTAP>
__device__ __forceinline__ void taps(const int4* __restrict__ t, int i, int (&idx)[NTAP],
                                     float (&w)[NTAP]) {
  if constexpr (NTAP == 2) {
    const int4 a = __ldg(t + i);
    idx[0] = a.x, idx[1] = a.y, w[0] = __int_as_float(a.z), w[1] = __int_as_float(a.w);
  } else {
    static_assert(NTAP == 4, "2 or 4 taps");
    const int4 a = __ldg(t + 2 * i), b = __ldg(t + 2 * i + 1);
    idx[0] = a.x, idx[1] = a.y, idx[2] = a.z, idx[3] = a.w;
    w[0] = __int_as_float(b.x), w[1] = __int_as_float(b.y);
    w[2] = __int_as_float(b.z), w[3] = __int_as_float(b.w);
  }
}

// One output row's block-uniform part: its NTAP source rows (crop origin
// added; row 0 where one falls outside the source, which then gives zeros)
// and weights, and the crop's column origin.
template <int NTAP>
struct Row {
  int ys[NTAP];
  float ay[NTAP];
  bool in;
  int ox;
};

// V channels [c, c + V) of output pixel p of the row, into out; zeros where
// a tap falls outside the source (crops only). No branch guards a load: an
// outside tap reads element 0 and its output is replaced by 0, so the loads
// of neighbouring calls can be in flight together.
template <typename T, int NTAP, int V, bool NEAREST>
__device__ __forceinline__ void interp(const T* __restrict__ src, const Geo& g, const Row<NTAP>& row,
                                       const int4* __restrict__ tx, int p, int c, float (&out)[V]) {
  const int rs = g.W * g.C;
  int xs[NTAP];
  float bx[NTAP];
  taps<NTAP>(tx, p, xs, bx);
#pragma unroll
  for (int t = 0; t < NTAP; ++t) xs[t] += row.ox;
  // taps are ordered, so the first and the last bound them all
  const bool ok = row.in && xs[0] >= 0 && xs[NTAP - 1] < g.W;
  if (!ok)
#pragma unroll
    for (int t = 0; t < NTAP; ++t) xs[t] = 0;
  if constexpr (NTAP == 2) {
    const float a0 = row.ay[0], a1 = row.ay[1];
    float v00[V], v10[V], v01[V], v11[V];
    load<V>(src + row.ys[0] * rs + xs[0] * g.C + c, v00);
    if constexpr (NEAREST) {  // both taps of each axis name one source index
#pragma unroll
      for (int e = 0; e < V; ++e) v10[e] = v01[e] = v11[e] = v00[e];
    } else {
      load<V>(src + row.ys[1] * rs + xs[0] * g.C + c, v10);
      load<V>(src + row.ys[0] * rs + xs[1] * g.C + c, v01);
      load<V>(src + row.ys[1] * rs + xs[1] * g.C + c, v11);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float u0 = a0 * v00[e] + a1 * v10[e];
      const float u1 = a0 * v01[e] + a1 * v11[e];
      out[e] = ok ? bx[0] * u0 + bx[1] * u1 : 0.0f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = 0.0f;
#pragma unroll
    for (int kx = 0; kx < NTAP; ++kx) {
      float u[V];
#pragma unroll
      for (int e = 0; e < V; ++e) u[e] = 0.0f;
#pragma unroll
      for (int ky = 0; ky < NTAP; ++ky) {
        float t[V];
        load<V>(src + row.ys[ky] * rs + xs[kx] * g.C + c, t);
#pragma unroll
        for (int e = 0; e < V; ++e) u[e] += row.ay[ky] * t[e];
      }
#pragma unroll
      for (int e = 0; e < V; ++e) out[e] += bx[kx] * u[e];
    }
    if (!ok)
#pragma unroll
      for (int e = 0; e < V; ++e) out[e] = 0.0f;
  }
}

// x: source images of H rows of W * C elements, image b at x + b * batch_stride.
// ty: (OH) packed taps of the rows, tx: (OW) of the columns (see taps).
// starts: (n, 2) [h, w] crop origins added to the tap indices, or null.
// Block (blockIdx.x, o, b) covers a segment of output row o of image b.
// V > 0: the channel path, V channels of one pixel a thread (C % V == 0,
// V-element aligned source and output); V == 0: the run path, a segment of
// blockDim x R elements of the row (R = 16 bytes' worth), stored R
// consecutive ones a thread, as one vector when vstore (output rows a
// multiple of 16 bytes).
template <typename T, int NTAP, int V, bool NEAREST>
__global__ void __launch_bounds__(256) resize_row_kernel(
    const T* __restrict__ x, T* __restrict__ y, const int4* __restrict__ ty,
    const int4* __restrict__ tx, const int* __restrict__ starts, Geo g, bool vstore) {
  const int o = blockIdx.y, b = blockIdx.z;
  Row<NTAP> row;
  int oy = 0;
  row.ox = 0;
  if (starts != nullptr) {
    oy = __ldg(starts + 2 * b);
    row.ox = __ldg(starts + 2 * b + 1);
  }
  taps<NTAP>(ty, o, row.ys, row.ay);
#pragma unroll
  for (int t = 0; t < NTAP; ++t) row.ys[t] += oy;
  row.in = row.ys[0] >= 0 && row.ys[NTAP - 1] < g.H;
  if (!row.in)
#pragma unroll
    for (int t = 0; t < NTAP; ++t) row.ys[t] = 0;
  const T* src = x + (int64_t)b * g.batch_stride;
  T* dst = y + ((int64_t)b * g.OH + o) * g.OW * g.C;
  if constexpr (V > 0) {
    const int u = blockIdx.x * blockDim.x + threadIdx.x, cv = g.C / V;
    if (u >= g.OW * cv) return;
    const int p = u / cv, c = (u - p * cv) * V;
    float out[V];
    interp<T, NTAP, V, NEAREST>(src, g, row, tx, p, c, out);
    store<V>(dst + p * g.C + c, out);
  } else {
    // the segment's elements one a thread at a time (neighbouring threads
    // on neighbouring elements: coalesced taps and gathers) into shared
    // memory in T, then R consecutive ones a thread to the output
    constexpr int R = 16 / sizeof(T);
    __shared__ __align__(16) unsigned char stage_bytes[256 * 16];
    T* stage = reinterpret_cast<T*>(stage_bytes);
    const int n = g.OW * g.C, seg0 = blockIdx.x * blockDim.x * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r * blockDim.x + threadIdx.x, e = min(seg0 + i, n - 1);
      const int p = g.C == 1 ? e : e / g.C;
      float t[1];
      interp<T, NTAP, 1, NEAREST>(src, g, row, tx, p, e - p * g.C, t);
      store<1>(stage + i, t);
    }
    __syncthreads();
    const int e0 = seg0 + threadIdx.x * R;
    if (vstore && e0 + R <= n) {
      *reinterpret_cast<uint4*>(dst + e0) = *reinterpret_cast<const uint4*>(stage + threadIdx.x * R);
    } else {
      for (int r = 0; r < R && e0 + r < n; ++r) dst[e0 + r] = stage[threadIdx.x * R + r];
    }
  }
}

template <typename T, int NTAP, int V, bool NEAREST>
int launch_v(const void* x, void* y, const void* ty, const void* tx, const void* starts, int n,
             const Geo& g, bool vstore, cudaStream_t s) {
  const int64_t units = V > 0 ? (int64_t)g.OW * (g.C / V)
                              : ((int64_t)g.OW * g.C + 16 / sizeof(T) - 1) / (16 / sizeof(T));
  const int threads = units >= 256 ? 256 : (int)((units + 31) / 32 * 32);
  const int64_t segs = (units + threads - 1) / threads;
  if (segs > 0x7fffffff || g.OH > 65535 || n > 65535) return (int)cudaErrorInvalidValue;
  resize_row_kernel<T, NTAP, V, NEAREST><<<dim3((unsigned)segs, g.OH, n), threads, 0, s>>>(
      (const T*)x, (T*)y, (const int4*)ty, (const int4*)tx, (const int*)starts, g, vstore);
  return (int)cudaGetLastError();
}

template <typename T, int NTAP, bool NEAREST>
int launch_taps(int vec, const void* x, void* y, const void* ty, const void* tx,
                const void* starts, int n, const Geo& g, bool vstore, cudaStream_t s) {
  if (vec == 0) return launch_v<T, NTAP, 0, NEAREST>(x, y, ty, tx, starts, n, g, vstore, s);
  if (vec == 2) return launch_v<T, NTAP, 2, NEAREST>(x, y, ty, tx, starts, n, g, vstore, s);
  if (vec == 4) return launch_v<T, NTAP, 4, NEAREST>(x, y, ty, tx, starts, n, g, vstore, s);
  if constexpr (sizeof(T) == 2)
    if (vec == 8) return launch_v<T, NTAP, 8, NEAREST>(x, y, ty, tx, starts, n, g, vstore, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(int taps, int vec, const void* x, void* y, const void* ty, const void* tx,
           const void* starts, int n, const Geo& g, bool vstore, cudaStream_t s) {
  if (vec > 0 && g.C % vec != 0) return (int)cudaErrorInvalidValue;
  if (taps == 1) return launch_taps<T, 2, true>(vec, x, y, ty, tx, starts, n, g, vstore, s);
  if (taps == 2) return launch_taps<T, 2, false>(vec, x, y, ty, tx, starts, n, g, vstore, s);
  if (taps == 4) return launch_taps<T, 4, false>(vec, x, y, ty, tx, starts, n, g, vstore, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ty, tx: the packed taps of the rows and columns, (OH, 2 NTAP) and
// (OW, 2 NTAP) int32 with 16-byte aligned rows; taps: the distinct source
// taps an axis, 1 for nearest (its two packed taps name one index), 2 for
// bilinear, 4 for bicubic. vec: channels a thread in
// the channel path (4, 8 or 16 bytes' worth), 0 for the run path; vstore:
// the run path stores 16 bytes at a time. The caller guarantees the
// alignments that vec and vstore need.
extern "C" int prv2_resize(const void* x, void* y, const void* ty, const void* tx,
                           const void* starts, long long n, long long H, long long W, long long C,
                           long long OH, long long OW, long long batch_stride, long long taps,
                           long long vec, long long vstore, int dtype, void* stream) {
  if (n * OH * OW * C == 0) return 0;
  if (H * W * C >= (1LL << 31) || OW * C >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const Geo g{(int)H, (int)W, (int)C, (int)OH, (int)OW, (int64_t)batch_stride};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>((int)taps, (int)vec, x, y, ty, tx, starts, (int)n, g, vstore != 0, s);
  if (dtype == 1)
    return launch<bf16>((int)taps, (int)vec, x, y, ty, tx, starts, (int)n, g, vstore != 0, s);
  return (int)cudaErrorInvalidValue;
}
