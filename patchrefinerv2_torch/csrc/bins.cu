// K8: the ZoeDepth bins head's per-pixel math, with the bilinear
// align-corners resize of the bin centres taken in.
//
// Replaces patchrefinerv2_tpu/models/backbones/zoedepth.py:
//   - attractor_kernel: the attractor layers (exp_attractor :39,
//     inv_attractor :44, AttractorLayerUnnormed :117-132,
//     AttractorLayerNormed :149-170) together with the resize of the
//     previous centres to the layer's size, `_interp(b_prev, ...)` at :124
//     and :159;
//   - log_binomial_kernel: log_binom :173 and ConditionalLogBinomial
//     :186-217 from the softplus `pt` on, together with the expectation over
//     the last centres resized to the output, `_interp(b_centers, ...)` at
//     :375-376.
// The TPU version resized the centres with dense interpolation matrices and
// then ran the per-pixel math as XLA fusions over (pixels, na, nb) and
// (pixels, K) intermediates; here each kernel gathers its four bilinear taps
// (the packed per-axis taps of ops/resize, combined in csrc/resize.cu's
// order: the rows first, then the columns, rounded once to the input dtype)
// and keeps everything else in registers and shared memory, so neither the
// upsampled centres nor the (na, nb) differences nor the K probabilities
// are written.
//
// attractor_kernel. Its work is small (the flagship's four levels hold 768,
// 3072, 12288 and 49152 pixels of 64 bins, with 16, 8, 4 and 1
// attractors): the bound of the fused function (each input read once and
// the output written once, or its operations at the float32 rate) is
// ~0.08-2.4 us a level in bfloat16, and a launch is bound by latency and
// instructions. The design:
//   - no index is divided: the grid is (row segments, rows, images) and a
//     block (lanes, pixels), from the host's launch plan
//     (ops/bins.launch_plan), which gives every level a full wave of blocks
//     (>= 132) and shares a thread's fixed work (taps, addresses) among 2
//     bins (a bf16x2 or float2 pair), or among 16 bytes of bins at the
//     levels with threads to spare;
//   - a pixel's bins lie on consecutive lanes: the four taps are gathered
//     and b_new stored in coalesced 4-, 8- or 16-byte accesses, and each of
//     the pixel's attractor values is one load that serves all its lanes;
//   - the attractor math is the JAX layers', every elementwise step rounded
//     to the input dtype and the sum over the attractors in float32, with
//     round-to-nearest intrinsics so that no step is contracted. In
//     bfloat16 the steps run on bf16x2 pairs (a product or sum of two
//     bfloat16 values rounded once to bfloat16 is the float32 step rounded
//     to it) and the quotient is a fast division, which rounds to the same
//     bfloat16 (see pull_bf16): a third fewer instructions than float32
//     steps and their roundings. A mean over a power of two of attractors
//     is the product with its reciprocal (the same number);
//   - normed layers scale their centres into a per-pixel row of shared
//     memory (padded with NaN, which sorts last as in torch.sort), sort it
//     with a bitonic network over the block and clip. No configuration
//     uses normed centres: this path is right, not fast.
//
// log_binomial_kernel. At the flagship shape (384x512 pixels, 64 bins, the
// centres at 192x256) it reads 6.3 MB of centres and writes 0.4 MB of
// depth: ~2.5 us of bytes; the function's ~17 operations a (pixel, bin),
// the resize's with them, take ~3.2 us at the float32 rate. The kernel
// issues several instructions for each of them (the division's remainder
// step, expf's range reduction, the taps), so it is bound by its
// instructions (utils/sass.py counts them from the SASS). The design:
//   - one thread a pixel, a block a segment of 128 pixels of an output row;
//   - pass 1 (the logits and their max) needs only the pixel's pt, so it
//     runs first, the log-binomial table read as kernel parameters;
//   - then the block resizes the centres it needs along H once (its one or
//     two source rows over its column range, read with coalesced 16-byte
//     loads) into shared memory as float32, rows padded by 16 bytes so that
//     the threads' reads of neighbouring columns fall in different banks;
//     in pass 2 each thread combines its two columns and rounds the
//     centres to T a pair at a time;
//   - the logits y_k / t stay in registers (K = 64; any other K recomputes
//     them in a second pass, the max then taken as max(y) / t, which is the
//     same number since a correctly rounded division by t > 0 keeps order);
//   - the division by t is correctly rounded, as the plain version's (with
//     logits up to ~600 and t down to 0.0212, one ulp of y / t moves a
//     probability by up to ~2e-3): the reciprocal rounded to nearest and
//     one remainder step (Markstein), exact while y / t and its remainder
//     are normal floats, which logits of clamped probabilities over K <=
//     1024 bins keep;
//   - the softmax's exponentials with expf, as PyTorch's CUDA ops compute
//     them; sum(e) and sum(e * c) accumulate in float32 and one division
//     gives the depth, where the plain version normalises every probability
//     first: a few float32 roundings apart, far inside its 1e-4 bar.
// Measured against their plain versions and bounds: PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float ALPHA = 300.0f;  // attractor.py's jit-script default, whatever the config says
constexpr float P_EPS = 1e-4f;

// x rounded to T and widened back: the JAX layers round every step to it
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<bf16>(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// x[0 .. V) rounded to T in place, two at a time: one packed conversion
// (cvt.rn.bf16x2.f32) for a pair costs a quarter of two single ones
template <typename T, int V>
__device__ __forceinline__ void rnd_v(float (&x)[V]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j + 1 < V; j += 2) {
      const float2 f = __bfloat1622float2(__floats2bfloat162_rn(x[j], x[j + 1]));
      x[j] = f.x, x[j + 1] = f.y;
    }
    if constexpr (V % 2 == 1) x[V - 1] = rnd<T>(x[V - 1]);
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// V consecutive elements (V * sizeof(T) bytes, as aligned) as floats, and back
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
    static_assert(V == 2 || V == 8, "bfloat16 vectors of 1, 2 or 8");
    uint32_t w[V / 2];
    if constexpr (V == 8) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
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
    static_assert(V == 2 || V == 8, "bfloat16 vectors of 1, 2 or 8");
    uint32_t w[V / 2];
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&t);
    }
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    }
  }
}

// 16 bytes of elements as floats (8 bf16 or 4 float)
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = t.x, f[1] = t.y, f[2] = t.z, f[3] = t.w;
}

__device__ __forceinline__ void load16(const bf16* p, float (&f)[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned int w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    f[2 * j] = u.x, f[2 * j + 1] = u.y;
  }
}

// w0 * v0 + w1 * v1 in float32, written as csrc/resize.cu writes it, so
// that the compiler forms it as there
__device__ __forceinline__ float lerp2(float w0, float v0, float w1, float v1) {
  return w0 * v0 + w1 * v1;
}

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.sort's order: NaN after everything
__device__ __forceinline__ bool greater(float u, float w) {
  return u > w || (isnan(u) && !isnan(w));
}

// One axis tap of an output index: source indices i0 <= i1 and weights
struct Tap {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Tap tap_of(const int4* __restrict__ t, int i) {
  const int4 a = __ldg(t + i);
  return Tap{a.x, a.y, __int_as_float(a.z), __int_as_float(a.w)};
}

// ---------------------------------------------------------------- attractors

struct AttractorArgs {
  const void* a;       // (B, H, W, na)
  const void* b_prev;  // (B, h, w, nb)
  void* b_new;         // (B, H, W, nb)
  void* centers;       // (B, H, W, nb), normed layers only
  const int4* ty;      // (H) packed row taps, null where (h, w) == (H, W)
  const int4* tx;      // (W) packed column taps
  int H, W, h, w, na, nb;
  int groups;  // lane groups a thread walks: ceil(nb / V / blockDim.x)
  int np;      // normed: a pixel's sort row, a power of two >= nb
  int mean;    // kind "mean" (else "sum")
  float rna;   // 1 / na where na is a power of two (the mean is then that product), else 0
  float lo, hi, span;  // min_depth, max_depth, max_depth - min_depth
};

// One attractor's pull on V bins, acc += dist(a - b) (zoedepth.py:39-56,
// alpha 300, gamma 2), every step rounded to T
template <typename T, bool INV, int V>
__device__ __forceinline__ void pull(float a, const float (&b)[V], float (&acc)[V]) {
  float dx[V], t[V];
#pragma unroll
  for (int v = 0; v < V; ++v) dx[v] = __fsub_rn(a, b[v]);
  rnd_v<T>(dx);
  if constexpr (INV) {
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = __fmul_rn(dx[v], dx[v]);
    rnd_v<T>(t);
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = __fmul_rn(t[v], ALPHA);
    rnd_v<T>(t);
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = __fadd_rn(1.0f, t[v]);
    rnd_v<T>(t);
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = __fdiv_rn(dx[v], t[v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = __fmul_rn(fabsf(dx[v]), fabsf(dx[v]));
    rnd_v<T>(t);
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = __fmul_rn(t[v], -ALPHA);
    rnd_v<T>(t);
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = expf(t[v]);
    rnd_v<T>(t);
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = __fmul_rn(t[v], dx[v]);
  }
  rnd_v<T>(t);
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] += t[v];
}

// The same for bfloat16 pairs: the bins' centres b2, every step but the
// quotient and the exponential on packed bfloat16 (a product or sum of two
// bfloat16 values rounded once to bfloat16, as the float32 step rounded to
// it gives). The quotient m1 / m2 of two 8-bit significands is never a
// bfloat16 rounding midpoint (its odd 9-bit significand would have to
// divide m1 < 256) and lies at least 1 / (511 x 255) from one, far more than
// the 2 ulps (2^-22) of __fdividef: the fast division rounds to the
// bfloat16 that the correctly rounded one does.
template <bool INV, int V>
__device__ __forceinline__ void pull_bf16(float a, const __nv_bfloat162 (&b2)[V / 2], float (&acc)[V]) {
  const __nv_bfloat162 a2 = __float2bfloat162_rn(a);
  const __nv_bfloat162 alpha = __float2bfloat162_rn(INV ? ALPHA : -ALPHA);
#pragma unroll
  for (int j = 0; j < V / 2; ++j) {
    const __nv_bfloat162 dx = __hsub2(a2, b2[j]);
    // _rn: no product is contracted with the sum that follows it
    const __nv_bfloat162 t = __hmul2_rn(__hmul2_rn(dx, dx), alpha);
    __nv_bfloat162 q;
    if constexpr (INV) {
      const float2 d = __bfloat1622float2(dx);
      const float2 n = __bfloat1622float2(__hadd2(__float2bfloat162_rn(1.0f), t));
      q = __floats2bfloat162_rn(__fdividef(d.x, n.x), __fdividef(d.y, n.y));
    } else {
      const float2 e = __bfloat1622float2(t);
      q = __hmul2_rn(__floats2bfloat162_rn(expf(e.x), expf(e.y)), dx);
    }
    const float2 f = __bfloat1622float2(q);
    acc[2 * j] += f.x, acc[2 * j + 1] += f.y;
  }
}

// The centres of bins [k0, k0 + V) at output pixel (y, x) with row tap r,
// resized from the source image src (or read there when the sizes agree)
template <typename T, int V>
__device__ __forceinline__ void centre(const T* __restrict__ src, const AttractorArgs& g,
                                       const Tap& r, int y, int x, int k0, float (&b)[V]) {
  if (g.ty == nullptr) {
    load<V>(src + ((int64_t)y * g.w + x) * g.nb + k0, b);
    return;
  }
  const Tap c = tap_of(g.tx, x);
  float v00[V], v10[V], v01[V], v11[V];
  load<V>(src + ((int64_t)r.i0 * g.w + c.i0) * g.nb + k0, v00);
  load<V>(src + ((int64_t)r.i1 * g.w + c.i0) * g.nb + k0, v10);
  load<V>(src + ((int64_t)r.i0 * g.w + c.i1) * g.nb + k0, v01);
  load<V>(src + ((int64_t)r.i1 * g.w + c.i1) * g.nb + k0, v11);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float u0 = lerp2(r.w0, v00[v], r.w1, v10[v]);
    const float u1 = lerp2(r.w0, v01[v], r.w1, v11[v]);
    b[v] = lerp2(c.w0, u0, c.w1, u1);
  }
  rnd_v<T>(b);
}

// Grid (ceil(W / blockDim.y), H, B); block (lanes, pixels): thread (lane,
// j) takes bins [(lane + i blockDim.x) V, + V) of output pixel (blockIdx.x
// blockDim.y + j) of row blockIdx.y of image blockIdx.z, for i < groups.
template <typename T, int V, bool INV, bool NORMED>
__global__ void __launch_bounds__(256) attractor_kernel(AttractorArgs g) {
  extern __shared__ float ss[];  // normed: pix x np scaled centres to sort
  const int tpp = blockDim.x, pix = blockDim.y, lane = threadIdx.x, j = threadIdx.y;
  const int x = blockIdx.x * pix + j, y = blockIdx.y;
  const bool valid = x < g.W;
  const int64_t p = ((int64_t)blockIdx.z * g.H + y) * g.W + x;
  const T* ap = static_cast<const T*>(g.a) + p * g.na;
  const T* src = static_cast<const T*>(g.b_prev) + (int64_t)blockIdx.z * g.h * g.w * g.nb;
  T* bn_out = static_cast<T*>(g.b_new) + p * g.nb;
  const Tap r = g.ty == nullptr ? Tap{y, y, 1.0f, 0.0f} : tap_of(g.ty, y);

  for (int gi = 0; gi < g.groups; ++gi) {
    const int k0 = (lane + gi * tpp) * V;
    const bool active = valid && k0 < g.nb;
    if (active) {
      float b[V], acc[V], bn[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.0f;
      centre<T, V>(src, g, r, y, x, k0, b);
      // the pixel's attractor values: one load serves all its lanes
      if constexpr (sizeof(T) == 2 && V % 2 == 0) {
        __nv_bfloat162 b2[V / 2];
#pragma unroll
        for (int v = 0; v < V / 2; ++v) b2[v] = __floats2bfloat162_rn(b[2 * v], b[2 * v + 1]);
#pragma unroll 4
        for (int i = 0; i < g.na; ++i) pull_bf16<INV, V>(to_f(__ldg(ap + i)), b2, acc);
      } else {
#pragma unroll 4
        for (int i = 0; i < g.na; ++i) pull<T, INV, V>(to_f(__ldg(ap + i)), b, acc);
      }
#pragma unroll
      for (int v = 0; v < V; ++v)
        bn[v] = !g.mean ? acc[v]
                : g.rna > 0.0f ? __fmul_rn(acc[v], g.rna)
                               // the float64 quotient rounds to the float32 one (53 >= 2 x 24 + 2)
                               : __double2float_rn(__ddiv_rn(acc[v], (double)g.na));
      rnd_v<T>(bn);
#pragma unroll
      for (int v = 0; v < V; ++v) bn[v] = __fadd_rn(b[v], bn[v]);
      rnd_v<T>(bn);
      store<V>(bn_out + k0, bn);
      if constexpr (NORMED) {
        float c[V];
#pragma unroll
        for (int v = 0; v < V; ++v) c[v] = __fmul_rn(bn[v], g.span);
        rnd_v<T>(c);
#pragma unroll
        for (int v = 0; v < V; ++v) c[v] = __fadd_rn(c[v], g.lo);
        rnd_v<T>(c);
#pragma unroll
        for (int v = 0; v < V; ++v) ss[j * g.np + k0 + v] = c[v];
      }
    }
  }
  if constexpr (NORMED) {
    // the rows' padding (and the rows of pixels past the end) sort last
    const int tid = j * tpp + lane, threads = tpp * pix;
    for (int e = tid; e < pix * g.np; e += threads) {
      const int jj = e / g.np, k = e - jj * g.np;
      if (k >= g.nb || blockIdx.x * pix + jj >= g.W) ss[e] = __int_as_float(0x7fc00000);
    }
    __syncthreads();
    // bitonic sort of every row, ascending
    const int half = g.np / 2;
    for (int size = 2; size <= g.np; size <<= 1) {
      for (int stride = size / 2; stride > 0; stride >>= 1) {
        for (int e = tid; e < pix * half; e += threads) {
          const int jj = e / half, i = e - jj * half;
          const int lo = (i / stride) * 2 * stride + i % stride, hi = lo + stride;
          float* s = ss + jj * g.np;
          const float u = s[lo], w = s[hi];
          if (greater(u, w) == ((lo & size) == 0)) s[lo] = w, s[hi] = u;
        }
        __syncthreads();
      }
    }
    T* cn_out = static_cast<T*>(g.centers) + p * g.nb;
    for (int gi = 0; gi < g.groups; ++gi) {
      const int k0 = (lane + gi * tpp) * V;
      if (!valid || k0 >= g.nb) continue;
      float c[V];
#pragma unroll
      for (int v = 0; v < V; ++v) c[v] = clampf(ss[j * g.np + k0 + v], g.lo, g.hi);
      store<V>(cn_out + k0, c);
    }
  }
}

template <typename T, int V, bool INV>
int launch_attractor(const AttractorArgs& g, int B, int tpp, int pix, int normed, cudaStream_t s) {
  const size_t smem = normed ? sizeof(float) * pix * g.np : 0;
  if (pix * tpp > 256 || smem > 48 * 1024 || g.H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((g.W + pix - 1) / pix), (unsigned)g.H, (unsigned)B), block(tpp, pix);
  if (normed)
    attractor_kernel<T, V, INV, true><<<grid, block, smem, s>>>(g);
  else
    attractor_kernel<T, V, INV, false><<<grid, block, smem, s>>>(g);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_attractor_v(const AttractorArgs& g, int B, int tpp, int pix, int inv, int normed,
                       cudaStream_t s) {
  if (g.nb % V != 0) return (int)cudaErrorInvalidValue;
  return inv ? launch_attractor<T, V, true>(g, B, tpp, pix, normed, s)
             : launch_attractor<T, V, false>(g, B, tpp, pix, normed, s);
}

template <typename T>
int launch_attractor_t(const AttractorArgs& g, int B, int vec, int tpp, int pix, int inv, int normed,
                       cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);  // 16 bytes
  if (vec == VW) return launch_attractor_v<T, VW>(g, B, tpp, pix, inv, normed, s);
  if (vec == 2) return launch_attractor_v<T, 2>(g, B, tpp, pix, inv, normed, s);
  if (vec == 1) return launch_attractor_v<T, 1>(g, B, tpp, pix, inv, normed, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- log-binomial

constexpr int KR = 64;  // the K whose logits a thread keeps in registers

struct LogBinomialArgs {
  const void* pt;       // (B, H, W, 4) softplus output
  const void* centers;  // (B, h, w, K)
  const float* lb;      // (K) log_binom(K - 1, k), float32, in device memory
  void* out;            // (B, H, W, 1)
  const int4* ty;       // (H) packed row taps, null where (h, w) == (H, W)
  const int4* tx;       // (W) packed column taps
  int H, W, h, w, K;
  float min_temp, span;  // min_temp, max_temp - min_temp
  float lbk[KR];        // K = KR: the table as kernel parameters, read as operands
};

// y / t correctly rounded from rt = 1 / t rounded to nearest: q within an
// ulp, its remainder exact by an fma, one correction (Markstein)
__device__ __forceinline__ float quot(float y, float t, float rt) {
  const float q = __fmul_rn(y, rt);
  return __fmaf_rn(__fmaf_rn(-q, t, y), rt, q);
}

// Block: a segment of blockDim.x output pixels of row blockIdx.y of image
// blockIdx.z, one a thread. STAGED: the segment's centres, resized along H,
// lie in shared memory as float32 over the segment's source columns (K a
// multiple of 16 bytes' elements); else each thread gathers its taps from
// device memory. KT: K when it is 64, the logits then kept in registers; 0
// for any K. RESIZE: the centres are resized (else read at the pixel).
template <typename T, int KT, bool STAGED, bool RESIZE>
__global__ void __launch_bounds__(128) log_binomial_kernel(LogBinomialArgs g) {
  extern __shared__ float su[];  // STAGED: columns x stride floats
  const int K = KT > 0 ? KT : g.K, stride = K + 4;
  const int bw = blockDim.x, x0 = blockIdx.x * bw, y = blockIdx.y, x = x0 + threadIdx.x;
  const bool valid = x < g.W;
  const T* C = static_cast<const T*>(g.centers) + (int64_t)blockIdx.z * g.h * g.w * K;
  const int64_t pix = ((int64_t)blockIdx.z * g.H + y) * g.W + min(x, g.W - 1);

  // p and t (zoedepth.py:204-210), in float32
  const T* q = static_cast<const T*>(g.pt) + pix * 4;
  float f[4];
  if constexpr (sizeof(T) == 4) {
    load16(reinterpret_cast<const float*>(q), f);
  } else {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(q));
    const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
    f[0] = u.x, f[1] = u.y, f[2] = v.x, f[3] = v.y;
  }
  const float p0 = __fadd_rn(f[0], P_EPS), p1 = __fadd_rn(f[1], P_EPS);
  const float t0 = __fadd_rn(f[2], P_EPS), t1 = __fadd_rn(f[3], P_EPS);
  const float p = clampf(__fdiv_rn(p0, __fadd_rn(p0, p1)), 1e-4f, 1.0f);
  const float t = __fadd_rn(__fmul_rn(__fdiv_rn(t0, __fadd_rn(t0, t1)), g.span), g.min_temp);
  const float lp = logf(p), lq = logf(clampf(__fsub_rn(1.0f, p), 1e-4f, 1.0f));
  const float rt = __frcp_rn(t);
  auto logit = [&](int k) {
    const float lb = KT > 0 ? g.lbk[k] : __ldg(g.lb + k);
    return __fadd_rn(__fadd_rn(lb, __fmul_rn((float)k, lp)), __fmul_rn((float)(K - 1 - k), lq));
  };
  // pass 1, before the centres are needed: the logits y_k / t (kept at K =
  // KR) and their max
  float z[KT > 0 ? KT : 1];
  float m = -INFINITY;
  if constexpr (KT > 0) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      z[k] = quot(logit(k), t, rt);
      m = fmaxf(m, z[k]);
    }
  } else {
    for (int k = 0; k < K; ++k) m = fmaxf(m, logit(k));
    m = quot(m, t, rt);
  }

  // the rows' taps, and the block's source columns
  Tap r{y, y, 1.0f, 0.0f};
  int clo = x0;
  const int xlast = min(x0 + bw, g.W) - 1;
  int chi = xlast;
  if constexpr (RESIZE) {
    r = tap_of(g.ty, y);
    clo = tap_of(g.tx, x0).i0;
    chi = tap_of(g.tx, xlast).i1;
  }
  if constexpr (STAGED) {
    constexpr int VE = 16 / sizeof(T);
    const int per = K / VE, units = (chi - clo + 1) * per;
    const T* row0 = C + ((int64_t)r.i0 * g.w + clo) * K;
    const T* row1 = C + ((int64_t)r.i1 * g.w + clo) * K;
#pragma unroll 4
    for (int u = threadIdx.x; u < units; u += bw) {
      const int col = u / per, k = (u - col * per) * VE;
      float v0[VE];
      load16(row0 + col * K + k, v0);
      if constexpr (RESIZE) {
        float v1[VE];
        load16(row1 + col * K + k, v1);
#pragma unroll
        for (int e = 0; e < VE; ++e) v0[e] = lerp2(r.w0, v0[e], r.w1, v1[e]);
      }
      float4* d = reinterpret_cast<float4*>(su + col * stride + k);
#pragma unroll
      for (int e = 0; e < VE / 4; ++e) d[e] = make_float4(v0[4 * e], v0[4 * e + 1], v0[4 * e + 2], v0[4 * e + 3]);
    }
    __syncthreads();
  }
  if (!valid) return;

  // the pixel's centres of bins k and k + 1: its two staged columns
  // combined, or its four taps gathered; rounded to T as a pair
  Tap c{x - clo, x - clo, 1.0f, 0.0f};
  if constexpr (RESIZE) {
    c = tap_of(g.tx, x);
    if constexpr (STAGED) c.i0 -= clo, c.i1 -= clo;
  }
  auto centre = [&](int k) {
    if constexpr (STAGED) {
      const float u0 = su[c.i0 * stride + k];
      if constexpr (RESIZE) return lerp2(c.w0, u0, c.w1, su[c.i1 * stride + k]);
      return u0;
    } else {
      if constexpr (!RESIZE) return to_f(C[((int64_t)y * g.w + x) * K + k]);
      const float u0 = lerp2(r.w0, to_f(C[((int64_t)r.i0 * g.w + c.i0) * K + k]), r.w1,
                             to_f(C[((int64_t)r.i1 * g.w + c.i0) * K + k]));
      const float u1 = lerp2(r.w0, to_f(C[((int64_t)r.i0 * g.w + c.i1) * K + k]), r.w1,
                             to_f(C[((int64_t)r.i1 * g.w + c.i1) * K + k]));
      return lerp2(c.w0, u0, c.w1, u1);
    }
  };
  auto centres = [&](int k, float (&cc)[2]) {
    cc[0] = centre(k);
    cc[1] = k + 1 < K ? centre(k + 1) : 0.0f;
    if constexpr (RESIZE) rnd_v<T>(cc);
  };

  // pass 2: the exponentials, their sum and the sum of their products with
  // the centres
  float se = 0.0f, sc = 0.0f;
  if constexpr (KT > 0) {
#pragma unroll
    for (int k = 0; k < KT; k += 2) {
      float cc[2];
      centres(k, cc);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float e = expf(__fsub_rn(z[k + i], m));
        se += e;
        sc = fmaf(e, cc[i], sc);
      }
    }
  } else {
    for (int k = 0; k < K; k += 2) {
      float cc[2];
      centres(k, cc);
      for (int i = 0; i < 2 && k + i < K; ++i) {
        const float e = expf(__fsub_rn(quot(logit(k + i), t, rt), m));
        se += e;
        sc = fmaf(e, cc[i], sc);
      }
    }
  }
  static_cast<T*>(g.out)[pix] = from_f<T>(__fdiv_rn(sc, se));
}

template <typename T, int KT, bool STAGED>
int launch_log_binomial(const LogBinomialArgs& g, int B, int bw, int cols, cudaStream_t s) {
  const size_t smem = STAGED ? sizeof(float) * cols * (g.K + 4) : 0;
  if (smem > 48 * 1024 || bw > 128 || g.H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((g.W + bw - 1) / bw), (unsigned)g.H, (unsigned)B);
  if (g.ty != nullptr)
    log_binomial_kernel<T, KT, STAGED, true><<<grid, bw, smem, s>>>(g);
  else
    log_binomial_kernel<T, KT, STAGED, false><<<grid, bw, smem, s>>>(g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_log_binomial_t(const LogBinomialArgs& g, int B, int bw, int cols, int staged, cudaStream_t s) {
  if (staged && g.K % (16 / (int)sizeof(T)) != 0) return (int)cudaErrorInvalidValue;
  if (g.K == KR)
    return staged ? launch_log_binomial<T, KR, true>(g, B, bw, cols, s)
                  : launch_log_binomial<T, KR, false>(g, B, bw, cols, s);
  return staged ? launch_log_binomial<T, 0, true>(g, B, bw, cols, s)
                : launch_log_binomial<T, 0, false>(g, B, bw, cols, s);
}

}  // namespace

// a (B, H, W, na), b_prev (B, h, w, nb), b_new and centers (B, H, W, nb),
// ty (H, 4) and tx (W, 4) the packed align-corners bilinear taps of h -> H
// and w -> W (both null when the sizes agree). vec, tpp, pix, groups, np:
// ops/bins.launch_plan's; the caller guarantees the alignment that vec
// needs (b_prev vec elements aligned; nb a multiple of vec).
extern "C" int prv2_attractor(const void* a, const void* b_prev, void* b_new, void* centers,
                              const void* ty, const void* tx, long long B, long long H, long long W,
                              long long h, long long w, long long na, long long nb, long long vec,
                              long long tpp, long long pix, long long groups, long long np,
                              long long inv, long long mean, long long normed, float lo,
                              float hi, float span, int dtype, void* stream) {
  if (B * H * W == 0 || nb == 0) return 0;
  if (h * w * nb >= (1LL << 31) || H * W >= (1LL << 31) || na < 1) return (int)cudaErrorInvalidValue;
  if ((ty == nullptr) != (tx == nullptr) || (ty == nullptr && (h != H || w != W)))
    return (int)cudaErrorInvalidValue;
  if (normed && (np < nb || (np & (np - 1)) != 0)) return (int)cudaErrorInvalidValue;
  if (tpp * groups * vec < nb) return (int)cudaErrorInvalidValue;
  const AttractorArgs g{a, b_prev, b_new, centers, (const int4*)ty, (const int4*)tx, (int)H, (int)W,
                        (int)h, (int)w, (int)na, (int)nb, (int)groups, (int)np, (int)mean,
                        (na & (na - 1)) == 0 ? 1.0f / (float)na : 0.0f, lo, hi, span};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_attractor_t<float>(g, (int)B, (int)vec, (int)tpp, (int)pix, (int)inv, (int)normed, s);
  if (dtype == 1)
    return launch_attractor_t<bf16>(g, (int)B, (int)vec, (int)tpp, (int)pix, (int)inv, (int)normed, s);
  return (int)cudaErrorInvalidValue;
}

// pt (B, H, W, 4), centers (B, h, w, K), lb (K) float32 in device memory and
// lb_host the same in host memory, out (B, H, W, 1); ty, tx as for
// prv2_attractor. bw: pixels (threads) a block; staged, cols:
// ops/bins.log_binomial_plan's (staged needs K a multiple of 16 bytes'
// elements and 16-byte aligned centres; pt is read 4 elements at a time).
extern "C" int prv2_log_binomial(const void* pt, const void* centers, const void* lb,
                                 const void* lb_host, void* out, const void* ty, const void* tx,
                                 long long B, long long H, long long W, long long h, long long w,
                                 long long K, long long bw, long long staged, long long cols,
                                 float min_temp, float span, int dtype, void* stream) {
  if (B * H * W == 0) return 0;
  if (K < 1 || h * w * K >= (1LL << 31) || H * W >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if ((ty == nullptr) != (tx == nullptr) || (ty == nullptr && (h != H || w != W)))
    return (int)cudaErrorInvalidValue;
  LogBinomialArgs g{pt, centers, (const float*)lb, out, (const int4*)ty, (const int4*)tx,
                    (int)H, (int)W, (int)h, (int)w, (int)K, min_temp, span, {}};
  if (K == KR)
    for (int k = 0; k < KR; ++k) g.lbk[k] = static_cast<const float*>(lb_host)[k];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_log_binomial_t<float>(g, (int)B, (int)bw, (int)cols, (int)staged, s);
  if (dtype == 1) return launch_log_binomial_t<bf16>(g, (int)B, (int)bw, (int)cols, (int)staged, s);
  return (int)cudaErrorInvalidValue;
}
