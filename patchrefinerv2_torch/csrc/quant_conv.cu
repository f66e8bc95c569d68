// K10: the int8 SAME convolution
//   y = relu?(f32(conv_int32(q(relu?(cat(parts))), kq)) * scale + bias (+ residual))
// on NHWC maps, with q(x) = clip(round_half_even(x / sx[c]), -127, 127).
//
// Replaces patchrefinerv2_tpu/ops/quant.py:130 `quant_conv_same` (one
// activation scale: the wrapper repeats it per channel and passes
// scale = sx * sw), :154 `quant_conv_same_perchan` (a scale per input
// channel, folded into the weights: scale = swc) and both serving branches
// of :218 `conv_dispatch`, the calibrated one and the dynamic one (no
// calibration: the activation scale is the input's live abs-max / 127), at
// its plain `qamax` sites and at the space-to-depth `head` sites. On the TPU
// the int8 products ran on the MXU at twice its bf16 rate; on Hopper the
// same trade is int8 wgmma at 1979 TOP/s.
//
// The head sites. The reference runs them on space-to-depth maps with
// expanded kernels (ops/s2d.py), a TPU lane trick; here they run in the
// plain layout. `qsd` (ops/s2d.py conv_down_expanded, then a ReLU) is the
// plain 3x3 SAME conv with a ReLU after the rounding (`relu_out`). The head
// GatedConvUnit's 3x3 convs with per-channel scales are "phased": the
// reference's per-channel scales of an s2d map are per (pixel phase,
// channel), ph(h, w) = 2 * (h % 2) + (w % 2), so a pixel quantizes with the
// scale row of its own phase, and the weights and dequant scales (folded
// from the scales of the input phases each tap reads) are those of the
// output pixel's phase:
//   q[n,h,w,c]   = clip(rne(x[n,h,w,c] / sx[ph(h,w)][c]), -127, 127)
//   acc[n,h,w,o] = sum q[n,h+du-1,w+dv-1,c] * kq[ph(h,w)][o,c,du,dv]
//   y            = f32(acc) * scale[ph(h,w)][o] + bias[o]
//
// Bound: operations at the 12 plain-layout sites the main paths select (a
// 3x3 over 194 to 512 input channels at 96x128 to 384x512 pixels: 2 * P * 9
// * Cin * Cout int8 operations against 1979 TOP/s, 0.07-0.94 ms a 16-patch
// chunk); bytes at the head sites of 32 (flagship) and 128 (DA2) channels
// at full resolution, where the input, the residual and the output are
// read and written once (0.18-0.96 ms a chunk in bfloat16). At the int8
// rate a 256-pixel x 128-channel tile's products take ~1.3 us per 32 input
// channels, against ~50 KB of halo and weights: the design keeps a ring of
// TMA loads ahead of wgmma and takes the epilogue off the tensor cores'
// path.
//
// 1. `quantize_kernel`: a warp takes 32 consecutive pixels of a row for one
//    group of 16 channels (a block's 8 warps neighbouring groups, so a
//    pixel's row is read once from device memory), reads the parts in
//    place (16-byte loads where a part's rows allow; no concatenation in
//    device memory), applies the ReLU and quantizes with the true
//    quotient's rounding (`quantize1`: the product with the scale's
//    reciprocal, and __fdiv_rn where that product lies near a half-integer),
//    rounds half to even, clips to +-127 and writes the int8 scratch `xq`
//    as 16-byte cells [n][h][c / 16][plane][x][16], the channels
//    zero-padded to a multiple of 32 (one k32 step). One plane at a plain
//    site; at a phased site the two column-parity planes (pixel (h, 2x +
//    plane)), an odd W padded by a zero column, so that the pixels of one
//    output phase in a row are contiguous.
// 2. `qconv_wgmma_kernel`: an implicit GEMM on `wgmma.mma_async
//    m64nNk32.s32.s8.s8`, one persistent block an SM walking tiles of 4
//    output rows by 64 pixels (phased: by 64 pixels of each column phase,
//    all four phases from one halo) by N output channels, N per site from
//    the host's launch plan (ops/quant.py `launch_plan`: 128, 80 or 32; an
//    integer wgmma takes no N of 72, so Cout 322 runs as 128 + 128 + 80,
//    the flagship head as 32). Warp-specialised, 3 warpgroups:
//    - one producer thread keeps a ring of 2-4 stages (one k32 step each)
//      full under full/empty mbarriers: the halo of the tile's rows by one
//      TMA tensor map over `xq` in 8-byte elements (rows of 1 KB), whose
//      box starts at (x0 - 1, y0 - 1), TMA filling the zeros outside the
//      image: the SAME padding, with no bounds test; and the N tile's
//      weights for every tap (and phase) by one bulk copy of a contiguous
//      block (a tensor-map box of 16-byte rows left the first version
//      bound by TMA's row rate, at a fifth of the int8 peak);
//    - two consumer warpgroups of 2 m64 runs (phased: 4) each. Both
//      operands are K-major without swizzle, the channel halves (16 bytes)
//      planes of core matrices, so the A operand of tap (du, dv) is the
//      halo at row r + du, column dv (phased: the plane and column the
//      tap's input phase reads): the same tile under a shifted
//      descriptor, 16-byte aligned for any shift, with no im2col copy.
//      The int32 sums are exact. Dequantized from the accumulators
//      (warp w of a warpgroup holds rows 16w + g and 16w + g + 8, columns
//      8j + 2 tig): __int2float_rn, __fmul_rn by the channel's scale (the
//      phase's), __fadd_rn of the bias (explicit _rn, so nvcc cannot
//      contract them into an FMA), one rounding to T, into output tiles
//      in shared memory; where the rows are 16-byte units the residual's
//      runs have arrived there by TMA (a stride-2 traversal for a phased
//      run) and the consumers add it, round again as the reference's
//      `quant_conv(...) + x` does, and apply the ReLU;
//    - three epilogue warps write the output tiles out (16-byte stores, or
//      pairs; there the residual and the ReLU for rows of other widths)
//      while the consumers run the next tile's products. Ragged rows,
//      runs and channels are masked there.
// 3. Dynamic mode: `absmax_kernel` reads the parts in place (the ReLU
//    applied) and folds each block's max into one float32 on the device with
//    an integer atomicMax on its bits (every value is >= 0), then
//    `scales_kernel` forms sx = max(amax, 1e-8) * f32(1/127) and
//    scale[o] = sx * sw[o] there, as the reference computes them under jit.
//    No value goes back to the host. The quantize and the product follow
//    unchanged.
//
// The quantize pass writes and the product reads an int8 copy of the input;
// fusing the quantize into the staging is later work.

#include <cuda.h>  // CUtensorMap; the encoder comes through cudaGetDriverEntryPoint (no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KC = 32;      // input channels (bytes) a k32 step
constexpr int RUN = 64;     // output pixels of one m64 run
constexpr int ROWS = 4;     // output rows a tile
constexpr int NT = 384;     // warpgroup 0: the producer warp and 3 epilogue warps; 1 and 2: the consumers
constexpr int EPI = 96;     // the epilogue threads
constexpr int MAXP = 4;
constexpr int SMEM_MAX = 232448;
constexpr int BAR_BYTES = 256;  // the ring's full and empty barriers (up to 8 stages), the output tiles'

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// two elements of T in one load or store
template <typename T> struct PairOf;
template <> struct PairOf<float> {
  typedef float2 type;
};
template <> struct PairOf<bf16> {
  typedef __nv_bfloat162 type;
};
template <typename T> using Pair = typename PairOf<T>::type;
template <typename T> __device__ __forceinline__ Pair<T> to_pair(float a, float b);
template <> __device__ __forceinline__ float2 to_pair<float>(float a, float b) { return make_float2(a, b); }
template <> __device__ __forceinline__ __nv_bfloat162 to_pair<bf16>(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}
// shared-memory pair accesses, volatile among themselves (and the barriers)
// but with no memory clobber: global loads may move across them
template <typename T> __device__ __forceinline__ Pair<T> lds_pair(uint32_t addr);
template <> __device__ __forceinline__ float2 lds_pair<float>(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat162 lds_pair<bf16>(uint32_t addr) {
  uint32_t u;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(u) : "r"(addr));
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}
__device__ __forceinline__ void sts_pair(uint32_t addr, float2 v) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v.x), "f"(v.y));
}
__device__ __forceinline__ void sts_pair(uint32_t addr, __nv_bfloat162 v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(*reinterpret_cast<uint32_t*>(&v)));
}

struct QArgs {
  const void* part[MAXP];
  int pc[MAXP];    // channels of each part
  int poff[MAXP];  // first channel of each part in the concatenation
  int vec[MAXP];   // channels a load of the part's rows takes: 8 (16 bytes for bfloat16), 2 or 1
  int nparts, cin, cin_pad, relu_in, phased, H, W, W2;
  const float* sx;  // (cin,), or (4, cin) by pixel phase when phased
  int8_t* xq;       // [n][h][cin_pad / 16][plane][x][16]
  int64_t P;        // pixels
};

// ---------------------------------------------------------------- quantize
__device__ __forceinline__ void load8(const float* p, float x[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p), v = *reinterpret_cast<const float4*>(p + 4);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w; x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
}
__device__ __forceinline__ void load8(const bf16* p, float x[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ void load2(const float* p, float x[2]) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  x[0] = u.x;
  x[1] = u.y;
}
__device__ __forceinline__ void load2(const bf16* p, float x[2]) {
  const __nv_bfloat162 u = *reinterpret_cast<const __nv_bfloat162*>(p);
  x[0] = __bfloat162float(u.x);
  x[1] = __bfloat162float(u.y);
}

// The part that holds channel c: its rows, its width, c's offset in it and
// whether its rows take 16-byte loads (constant indices only, so the
// arguments stay in registers)
template <typename T> struct Loc {
  const T* src;
  int pc, off, vec;
};
template <typename T> __device__ __forceinline__ Loc<T> locate(const QArgs& a, int c) {
  Loc<T> l = {static_cast<const T*>(a.part[0]), a.pc[0], c, a.vec[0]};
#pragma unroll
  for (int s = 1; s < MAXP; ++s)
    if (s < a.nparts && c >= a.poff[s])
      l = {static_cast<const T*>(a.part[s]), a.pc[s], c - a.poff[s], a.vec[s]};
  return l;
}

// The 8 channels c0 .. c0 + 7 of pixel p as float32, zeros past cin: the
// widest loads the part's rows allow where the group lies in one part (8
// channels, 2, or 1 at a time)
template <typename T> __device__ __forceinline__ void load_group(const QArgs& a, int c0, int64_t p, float x[8]) {
  const Loc<T> g = locate<T>(a, c0);
  const bool in_one = g.off + 8 <= g.pc;
  if (in_one && g.vec == 8) {
    load8(g.src + p * g.pc + g.off, x);
  } else if (in_one && g.vec == 2) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) load2(g.src + p * g.pc + g.off + j, x + j);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j >= a.cin) {
        x[j] = 0.f;
        continue;
      }
      const Loc<T> l = locate<T>(a, c0 + j);
      x[j] = to_f(l.src[p * l.pc + l.off]);
    }
  }
}

// q = clip(rne(v / s), -127, 127) with the true quotient's rounding: the
// product with inv = 1 / s is within 2^-22 |v / s| of the rounded quotient,
// so it rounds to the same integer unless it lies within 2^-20 of its value
// from a half-integer; there (ties, NaN, inf) the division decides
__device__ __forceinline__ int quantize1(float v, float s, float inv) {
  const float y = __fmul_rn(v, inv), r = rintf(y);
  const float q = fabsf(y - r) < 0.5f - fabsf(y) * 9.5367431640625e-07f ? r : __fdiv_rn(v, s);
  return min(max(__float2int_rn(q), -127), 127);
}

// A warp writes 32 consecutive 16-byte cells of xq, one a lane: one row of
// 32 slots (columns x of one plane of one image row) for one group of 16
// channels c0 = 16 g, cell = (((n * H + h) * cin_pad / 16 + g) * PL +
// plane) * xw + x. A block's 8 warps take neighbouring (row, g) items, so
// the groups of a pixel are read together and its input row is read once
// from device memory. A plain slot is pixel (h, x); a phased one pixel (h,
// 2x + plane), an odd W's last column of plane 1 a zero cell. The scales
// (and their reciprocals) of every channel, by pixel phase when phased,
// wait in shared memory.
template <typename T, bool PHASED>
__global__ void __launch_bounds__(256) quantize_kernel(const QArgs a) {
  constexpr int PL = PHASED ? 2 : 1;
  extern __shared__ __align__(16) float s_sx[];  // [phase][cin_pad], then the reciprocals
  const int cp = a.cin_pad, g16 = cp / 16, xw = PHASED ? a.W2 : a.W, strips_x = (xw + 31) / 32;
  float* s_inv = s_sx + (PHASED ? 4 : 1) * cp;
  for (int i = threadIdx.x; i < (PHASED ? 4 : 1) * cp; i += 256) {
    const int r = i / cp, c = i % cp;
    const float v = c < a.cin ? a.sx[r * a.cin + c] : 1.f;
    s_sx[i] = v;
    s_inv[i] = __frcp_rn(v);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t items = a.P / a.W * PL * strips_x * g16;  // ((n, h, plane, strip), g)
  for (int64_t it = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5); it < items; it += (int64_t)gridDim.x * 8) {
    const int g = (int)(it % g16), c0 = 16 * g;
    const int64_t row = it / g16;  // (n, h, plane, strip)
    const int x = (int)(row % strips_x) * 32 + lane;
    const int64_t r = row / strips_x;
    const int plane = PHASED ? (int)(r & 1) : 0;
    const int64_t nh = PHASED ? r >> 1 : r;
    if (x >= xw) continue;
    const int w = PHASED ? 2 * x + plane : x;
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
    if (w < a.W) {
      const int64_t p = nh * a.W + w;
      // the pixel's phase 2 * (h % 2) + (w % 2) picks its scale row
      const int ph = PHASED ? (int)(nh % a.H & 1) * 2 + (w & 1) : 0;
      // the group's 16 scales and reciprocals, 16-byte loads
      alignas(16) float sx[16], inv[16];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        reinterpret_cast<float4*>(sx)[k] = reinterpret_cast<const float4*>(s_sx + ph * cp + c0)[k];
        reinterpret_cast<float4*>(inv)[k] = reinterpret_cast<const float4*>(s_inv + ph * cp + c0)[k];
      }
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        float v[8];
        load_group<T>(a, c0 + 8 * h8, p, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float u = a.relu_in ? fmaxf(v[j], 0.f) : v[j];
          const int q = quantize1(u, sx[8 * h8 + j], inv[8 * h8 + j]);
          packed[2 * h8 + (j >> 2)] |= (uint32_t)(q & 0xff) << (8 * (j & 3));
        }
      }
    }
    const int64_t cell = ((nh * g16 + g) * PL + plane) * xw + x;
    *reinterpret_cast<uint4*>(a.xq + cell * 16) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// ---------------------------------------------------------------- dynamic scales
// max over the parts of |x| (of max(x, 0) with the ReLU), as float32 bits in
// *amax, which the caller zeroes first. 16-byte loads where a part allows.
template <typename T>
__global__ void __launch_bounds__(256) absmax_kernel(const QArgs a, float* amax) {
  constexpr int V = 16 / sizeof(T);
  float m = 0.f;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x, nt = (int64_t)gridDim.x * blockDim.x;
  for (int s = 0; s < a.nparts; ++s) {
    const T* src = static_cast<const T*>(a.part[s]);
    const int64_t n = a.P * a.pc[s];
    int64_t done = 0;
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      done = n / V * V;
      for (int64_t i = tid * V; i < done; i += nt * V) {
        const uint4 u = *reinterpret_cast<const uint4*>(src + i);
        const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int j = 0; j < V; ++j) m = fmaxf(m, a.relu_in ? to_f(h[j]) : fabsf(to_f(h[j])));
      }
    }
    for (int64_t i = done + tid; i < n; i += nt) m = fmaxf(m, a.relu_in ? to_f(src[i]) : fabsf(to_f(src[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float wmax[8];
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, wmax[w]);
    // m >= 0 (m starts at +0), so its bits order as integers
    atomicMax(reinterpret_cast<int*>(amax), __float_as_int(m));
  }
}

// sx = max(amax, 1e-8) * f32(1 / 127) for every input channel and
// scale[o] = sx * sw[o]: the reference's _quantize_per_tensor scale (its
// `/ 127.0` compiled to a product with the reciprocal) and `sx * sw`
__global__ void scales_kernel(const float* amax, const float* sw, float* sx, float* scale, int cin,
                              int cout) {
  const float s = __fmul_rn(fmaxf(*amax, (float)1e-8), (float)(1.0 / 127.0));
  for (int c = threadIdx.x; c < cin; c += blockDim.x) sx[c] = s;
  for (int o = threadIdx.x; o < cout; o += blockDim.x) scale[o] = __fmul_rn(s, sw[o]);
}

// ---------------------------------------------------------------- product
using namespace hopper;

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// d (N / 2 int32 a thread) += A (64 x 32 int8) * B (32 x N int8)
template <int N> __device__ __forceinline__ void wgmma(int* d, uint64_t a, uint64_t b);
template <> __device__ __forceinline__ void wgmma<8>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {%0, %1, %2, %3}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma<32>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma<80>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma<128>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// The shapes of one tile: K (3 or 1), PHASED (the head's four pixel phases
// from one halo), N output channels
template <int K, bool PHASED, int N> struct Geo {
  static constexpr int PL = PHASED ? 2 : 1;    // planes of the halo: the column parities
  static constexpr int PH = PHASED ? 4 : 1;    // weight phases a stage holds
  static constexpr int TAPS = K * K;
  static constexpr int HR = ROWS + K - 1;      // halo rows
  static constexpr int HC = RUN + K - 1;       // halo columns of a plane
  static constexpr int RUNS = PHASED ? 4 : 2;  // m64 runs of a consumer warpgroup
  static constexpr uint32_t A_BOX = HR * 2 * PL * HC * 16;  // the halo: [row][half][plane][column][16]
  static constexpr uint32_t A_LBO = PL * HC * 16;           // from one channel half to the other
  static constexpr uint32_t B_LBO = TAPS * N * 16;          // the weights: [phase][half][tap][n][16]
  static constexpr uint32_t B_BYTES = PH * 2 * B_LBO;
  static constexpr uint32_t A_PAD = up128(A_BOX);          // the weights' offset in a stage
  static constexpr uint32_t STAGE = A_PAD + B_BYTES;
  static constexpr uint32_t TX = A_BOX + B_BYTES;           // the bytes a stage's two loads bring
  static_assert(N % 8 == 0 && N <= 256 && B_BYTES % 128 == 0, "tile");
};

// A consumer's output tiles in shared memory, [run][m][n] in T: rows of N
// elements, bfloat16 rows padded by 8 elements so that the pairs a warp
// reads and writes (rows g, columns 2 tig) fall in distinct banks
// (float32's padding would not fit beside a ring of two 128-channel
// stages). The residual's TMA box is a row as wide as the padded one.
template <typename T, int K, bool PHASED, int N> struct Out {
  static constexpr int ROW = N + (sizeof(T) == 2 ? 8 : 0);  // elements of a row
  static constexpr uint32_t PITCH = ROW * sizeof(T);
  static constexpr uint32_t BYTES = Geo<K, PHASED, N>::RUNS * RUN * PITCH;
};

struct CArgs {
  const float* scale;  // [phase][cout]
  const void* bias;    // (cout,) or null
  const void* res;     // (N, H, W, cout) or null
  void* y;             // (N, H, W, cout)
  const int8_t* w;     // this launch's N tiles: [tile][chunk][phase][half][tap][N][16]
  int H, W, cout, nchunk, n0, ntiles, tiles_x, tiles_y, stages, relu_out;
  int vec;             // cout % 8 == 0 and 16-byte aligned rows: a thread's 8 outputs in 16-byte units
  int pairs;           // cout even, the scales 8-byte and the bias 2-element aligned: pair loads
  int64_t tiles;       // the launch's tiles: blocks of pixels x N tiles
};

// xmap: `xq` in 8-byte elements as (x: 2 * xw, plane, half: 2 * nchunk, y:
// H, n), box (2 * HC, PL, 2, HR, 1). Shared memory: the barriers, the ring
// of stages, each the halo [row][half][plane][column][16] and the N tile's
// weights [phase][half][tap][n][16] of one k32 step, then each consumer's
// output tiles. Persistent: a block walks tiles blockIdx.x, + gridDim.x, ...
// The producer runs ahead into the next tile while the consumers finish
// one; the consumers leave a tile's dequantized outputs in their output
// tiles and go on to the next tile's products while the epilogue warps
// write the tile out.
template <typename T, int K, bool PHASED, int N, bool RELU>
__global__ void __launch_bounds__(NT, 1)
    qconv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap rmap,
                       const CArgs a) {
  using G = Geo<K, PHASED, N>;
  using O = Out<T, K, PHASED, N>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // full[s] at +8s and empty[s] at +64+8s; the output tiles' full[cw] at
  // +128+8cw, free[cw] at +144+8cw and residual[cw] at +160+8cw
  const uint32_t bars = (smem_addr(smem_raw) + 127) & ~127u;
  const uint32_t ring = bars + BAR_BYTES;
  unsigned char* outs = smem_raw + (ring + a.stages * G::STAGE - smem_addr(smem_raw));
  const int stages = a.stages;
  const int64_t per_n = (int64_t)a.tiles_x * a.tiles_y;  // pixel tiles of one image
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);       // the producer's expect_tx, then the bytes
      mbar_init(bars + 64 + 8 * s, 8);  // one arrival per consumer warp
    }
    for (int cw = 0; cw < 2; ++cw) {
      mbar_init(bars + 128 + 8 * cw, 128);  // every consumer thread
      mbar_init(bars + 144 + 8 * cw, EPI);  // every epilogue thread
      mbar_init(bars + 160 + 8 * cw, 1);    // the residual's expect_tx, then the bytes
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // tile t: image n, rows y0 .. y0 + 3, runs from pixel (phased: plane
  // column) c0, output channels nb ..
  struct Tile {
    int n, y0, c0, nt;
  };
  auto tile_of = [&](int64_t t) {
    const int64_t pt = t / a.ntiles;
    const int tr = (int)(pt % per_n);
    return Tile{(int)(pt / per_n), tr / a.tiles_x * ROWS, tr % a.tiles_x * RUN, (int)(t % a.ntiles)};
  };
  // consumer cw's run r: its row, and its first pixel and stride in x
  // (phased: tile row 2cw + r / 2, column phase dj = r % 2, pixels
  // 2 (c0 + m) + dj)
  auto run_y = [&](const Tile& tl, int cw, int r) { return tl.y0 + 2 * cw + (PHASED ? r / 2 : r); };
  auto run_x = [&](const Tile& tl, int r) { return PHASED ? 2 * tl.c0 + r % 2 : tl.c0; };

  // with a.vec and a residual, its runs arrive by TMA in the output tiles,
  // issued by the first epilogue thread once they are free
  const bool tma_res = a.vec && a.res != nullptr;
  auto load_residual = [&](int64_t t, int cw) {
    const Tile tl = tile_of(t);
    const uint32_t bar = bars + 160 + 8 * cw, dst = smem_addr(outs + cw * O::BYTES);
    mbar_expect_tx(bar, O::BYTES);
    for (int r = 0; r < G::RUNS; ++r)
      tma_load_4d(dst + r * RUN * O::PITCH, &rmap, bar, a.n0 + tl.nt * N, run_x(tl, r), run_y(tl, cw, r), tl.n);
  };

  if (wg == 0) {
    if (threadIdx.x == 0) {  // the producer: one thread keeps the ring full
      int it = 0;
      for (int64_t t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const Tile tl = tile_of(t);
        const int8_t* wt = a.w + (int64_t)tl.nt * a.nchunk * G::B_BYTES;
        for (int ch = 0; ch < a.nchunk; ++ch, ++it) {
          const int s = it % stages;
          if (it >= stages) mbar_wait(bars + 64 + 8 * s, (it / stages - 1) & 1);
          const uint32_t full = bars + 8 * s, st = ring + s * G::STAGE;
          mbar_expect_tx(full, G::TX);
          // the halo from (c0 - 1, y0 - 1), both channel halves; TMA fills
          // zeros outside the map
          tma_load_5d(st, &xmap, full, 2 * (tl.c0 - K / 2), 0, 2 * ch, tl.y0 - K / 2, tl.n);
          bulk_load(st + G::A_PAD, wt + (int64_t)ch * G::B_BYTES, G::B_BYTES, full);
        }
      }
    } else if (threadIdx.x >= 32) {
      // the epilogue warps write a consumer's output tile out, 8 channels a
      // thread (a pixel's row in whole 16-byte units where cout allows).
      // Where the residual arrived by TMA the consumers have finished the
      // values; else here: the residual's add and a second rounding, as
      // the reference's `quant_conv(...) + x` rounds, then the ReLU after
      // the rounding (`relu(quant_conv(...))`, exact: it only clears the
      // negative ones)
      const int e = threadIdx.x - 32;
      const T* res = static_cast<const T*>(a.res);
      T* y = static_cast<T*>(a.y);
      if (tma_res && e == 0)
        for (int cw = 0; cw < 2; ++cw) load_residual(blockIdx.x, cw);
      int tile = 0;
      for (int64_t t = blockIdx.x; t < a.tiles; t += gridDim.x, ++tile) {
        const Tile tl = tile_of(t);
        const int nb = a.n0 + tl.nt * N;
        for (int cw = 0; cw < 2; ++cw) {
          mbar_wait(bars + 128 + 8 * cw, tile & 1);
          const unsigned char* stg = outs + cw * O::BYTES;
#pragma unroll 4
          for (int i = e; i < G::RUNS * RUN * (N / 8); i += EPI) {
            const int r = i / (RUN * (N / 8)), m = i / (N / 8) % RUN, c8 = i % (N / 8);
            const int iy = run_y(tl, cw, r), ix = run_x(tl, r) + (PHASED ? 2 : 1) * m, c = nb + 8 * c8;
            if (iy >= a.H || ix >= a.W || c >= a.cout) continue;
            alignas(16) T o[8];
            const unsigned char* src = stg + (r * RUN + m) * O::PITCH + c8 * 8 * sizeof(T);
#pragma unroll
            for (int k = 0; k < (int)sizeof(o) / 16; ++k)
              reinterpret_cast<uint4*>(o)[k] = reinterpret_cast<const uint4*>(src)[k];
            const int64_t at = (((int64_t)tl.n * a.H + iy) * a.W + ix) * a.cout + c;
            if (a.vec) {  // then cout % 8 == 0: all 8, finished
#pragma unroll
              for (int k = 0; k < (int)sizeof(o) / 16; ++k)
                reinterpret_cast<uint4*>(y + at)[k] = reinterpret_cast<const uint4*>(o)[k];
            } else {
              const int cnt = a.cout - c < 8 ? a.cout - c : 8;
              for (int k = 0; k < cnt; ++k) {
                if (res != nullptr) o[k] = from_f<T>(__fadd_rn(to_f(o[k]), to_f(res[at + k])));
                if (RELU) o[k] = from_f<T>(fmaxf(to_f(o[k]), 0.f));
              }
              if (a.cout % 2 == 0) {  // pairs: 2-element aligned (c and cout even)
                for (int k = 0; k < cnt; k += 2) {
                  if constexpr (sizeof(T) == 2) {
                    __nv_bfloat162 v2;
                    v2.x = o[k];
                    v2.y = o[k + 1];
                    *reinterpret_cast<__nv_bfloat162*>(y + at + k) = v2;
                  } else {
                    *reinterpret_cast<float2*>(y + at + k) = make_float2(to_f(o[k]), to_f(o[k + 1]));
                  }
                }
              } else {
                for (int k = 0; k < cnt; ++k) y[at + k] = o[k];
              }
            }
          }
          if (tma_res) {  // the next tile's residual, once every thread has read this one
            fence_async_smem();
            named_sync(1, EPI);
            if (e == 0 && t + gridDim.x < a.tiles) load_residual(t + gridDim.x, cw);
          }
          mbar_arrive(bars + 144 + 8 * cw);
        }
      }
    }
    return;
  }

  const int cw = wg - 1;  // consumer 0 takes the tile's rows 0 and 1, consumer 1 rows 2 and 3
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, tig = lane & 3;
  const T* bias = static_cast<const T*>(a.bias);
  const uint32_t stg_addr = smem_addr(outs + cw * O::BYTES);
  int acc[G::RUNS][N / 2];
  int it = 0, tile = 0;
  for (int64_t t = blockIdx.x; t < a.tiles; t += gridDim.x, ++tile) {
    const Tile tl = tile_of(t);
    const int nb = a.n0 + tl.nt * N;
#pragma unroll
    for (int r = 0; r < G::RUNS; ++r)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[r][i] = 0;
    for (int ch = 0; ch < a.nchunk; ++ch, ++it) {
      const int s = it % stages;
      mbar_wait(bars + 8 * s, (it / stages) & 1);
      const uint32_t st = ring + s * G::STAGE, wst = st + G::A_PAD;
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < G::TAPS; ++tap) {
        const int du = tap / K, dv = tap % K;
#pragma unroll
        for (int r = 0; r < G::RUNS; ++r) {
          // run r: plain, tile row 2cw + r; phased, tile row 2cw + r / 2
          // (row parity r / 2, y0 being a multiple of 4) at column phase
          // dj = r % 2, pixels x = 2 (c0 + m) + dj. Tap (du, dv) reads input
          // column 2 (c0 + m) + dj + dv - 1: plane (dj + dv - 1) mod 2,
          // halo column m + 1 + (dj + dv - 1 - plane) / 2
          const int row = PHASED ? 2 * cw + r / 2 : 2 * cw + r;
          const int dj = r % 2, plane = PHASED ? (dj + dv + 1) & 1 : 0;
          const int col = PHASED ? 1 + (dj + dv - 1 - plane) / 2 : dv;
          const int ph = PHASED ? 2 * (r / 2) + dj : 0;
          const uint64_t da = desc(st + (((row + du) * 2 * G::PL + plane) * G::HC + col) * 16, G::A_LBO);
          const uint64_t db = desc(wst + (ph * 2 * G::TAPS + tap) * N * 16, G::B_LBO);
          wgmma<N>(acc[r], da, db);
        }
      }
      wgmma_commit();
      // the step's products are done: its stage may be refilled (waiting
      // for one group in flight instead measured a few percent slower, a
      // stage less of the ring being ahead)
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(bars + 64 + 8 * s);
    }

    // dequantize from the accumulators into the output tiles, once the
    // epilogue warps are done with the last tile's: warp w of the
    // warpgroup holds rows m = 16w + g and 16w + g + 8 of each run,
    // columns 8j + 2 tig, + 1. __int2float_rn, __fmul_rn by the channel's
    // scale (the phase's), __fadd_rn of the bias (explicit _rn, so nvcc
    // cannot contract them into an FMA), one rounding to T
    // with a.vec the residual's add and a second rounding, as the
    // reference's `quant_conv(...) + x` rounds, and the ReLU after the
    // rounding (`relu(quant_conv(...))`, exact: it only clears the negative
    // ones) here too, the residual read from the output tile
    if (tma_res)
      mbar_wait(bars + 160 + 8 * cw, tile & 1);
    else if (tile > 0)
      mbar_wait(bars + 144 + 8 * cw, (tile - 1) & 1);
    // Each column pair's scales and bias are loaded once for every run and
    // row (two-element loads where cout is even and the rows aligned:
    // a.pairs), and its residual pairs all
    // before its first store. The output tiles are written and read through
    // st.shared / ld.shared, which nvcc need not order against the global
    // loads of the scales, so that those of every column overlap (through a
    // generic pointer each column's loads waited on the last column's
    // stores: half of the tile's time at the 256-wide sites)
    constexpr int NSC = PHASED ? 4 : 1;  // scale rows: a phased run's are its phase's
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = nb + 8 * j + 2 * tig;
      float bv[2] = {0.f, 0.f}, sv[NSC][2];
      if (a.pairs && c < a.cout) {
        if (bias != nullptr) {
          const Pair<T> b2 = *reinterpret_cast<const Pair<T>*>(bias + c);
          bv[0] = to_f(b2.x);
          bv[1] = to_f(b2.y);
        }
#pragma unroll
        for (int k = 0; k < NSC; ++k) {
          const float2 s2 = *reinterpret_cast<const float2*>(a.scale + k * a.cout + c);
          sv[k][0] = s2.x;
          sv[k][1] = s2.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = c + e < a.cout;
          if (bias != nullptr && in) bv[e] = to_f(bias[c + e]);
#pragma unroll
          for (int k = 0; k < NSC; ++k) sv[k][e] = in ? a.scale[k * a.cout + c + e] : 0.f;
        }
      }
      uint32_t dst[G::RUNS][2];
      Pair<T> rp[G::RUNS][2];
#pragma unroll
      for (int r = 0; r < G::RUNS; ++r)
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          dst[r][hlf] = stg_addr + (r * RUN + 16 * w + g + 8 * hlf) * O::PITCH + (8 * j + 2 * tig) * sizeof(T);
          if (tma_res) rp[r][hlf] = lds_pair<T>(dst[r][hlf]);
        }
#pragma unroll
      for (int r = 0; r < G::RUNS; ++r)
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const float* sc = sv[PHASED ? 2 * (r / 2) + r % 2 : 0];
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = __fmul_rn(__int2float_rn(acc[r][4 * j + 2 * hlf + e]), sc[e]);
            if (bias != nullptr) v[e] = __fadd_rn(v[e], bv[e]);
          }
          // the pair rounded by one conversion (bfloat16: cvt.rn.bf16x2.f32)
          Pair<T> o = to_pair<T>(v[0], v[1]);
          if (tma_res)
            o = to_pair<T>(__fadd_rn(to_f(o.x), to_f(rp[r][hlf].x)), __fadd_rn(to_f(o.y), to_f(rp[r][hlf].y)));
          if (RELU && a.vec) o = to_pair<T>(fmaxf(to_f(o.x), 0.f), fmaxf(to_f(o.y), 0.f));
          sts_pair(dst[r][hlf], o);
        }
    }
    mbar_arrive(bars + 128 + 8 * cw);
  }
}

// ---------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, without linking libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// One launch of the product over ntiles N tiles from output channel c.n0,
// whose weights start at w. xw: the columns of a plane (W, or W2 when
// phased)
template <typename T, int K, bool PHASED, int N, bool RELU>
int launch(CArgs c, const int8_t* xq, const int8_t* w, int nbatch, int cin_pad, int xw, int ntiles, int sms,
           cudaStream_t stream) {
  using G = Geo<K, PHASED, N>;
  // 128: aligning the dynamic base; then the barriers, the ring and the
  // consumers' output tiles
  const unsigned bytes = 128 + BAR_BYTES + c.stages * G::STAGE + 2 * Out<T, K, PHASED, N>::BYTES;
  if (c.stages < 1 || c.stages > 8 || bytes > SMEM_MAX || ntiles < 1) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  c.w = w;
  c.ntiles = ntiles;
  c.tiles_x = (xw + RUN - 1) / RUN;
  c.tiles_y = (c.H + ROWS - 1) / ROWS;
  c.tiles = (int64_t)nbatch * c.tiles_x * c.tiles_y * ntiles;
  CUtensorMap xmap, rmap = {};
  const cuuint64_t row = (cuuint64_t)xw * 16;  // bytes of a plane's row of one channel half
  const cuuint64_t xdim[5] = {(cuuint64_t)xw * 2, (cuuint64_t)G::PL, (cuuint64_t)cin_pad / 16, (cuuint64_t)c.H,
                              (cuuint64_t)nbatch};
  const cuuint64_t xstr[4] = {row, G::PL * row, (cuuint64_t)cin_pad / 16 * G::PL * row,
                              (cuuint64_t)c.H * (cin_pad / 16) * G::PL * row};
  const cuuint32_t xbox[5] = {2 * G::HC, (cuuint32_t)G::PL, 2, (cuuint32_t)G::HR, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUresult r = enc(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT64, 5, const_cast<int8_t*>(xq), xdim, xstr, xbox, ones,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  if (c.vec && c.res != nullptr) {
    // the residual as (c: cout, x: W, y: H, n), one run a box: a padded
    // output tile row of channels (those past cout zeros) by RUN pixels at
    // stride PL (a phased run is one column phase)
    using O = Out<T, K, PHASED, N>;
    const cuuint64_t es = sizeof(T), rdim[4] = {(cuuint64_t)c.cout, (cuuint64_t)c.W, (cuuint64_t)c.H, (cuuint64_t)nbatch};
    const cuuint64_t rstr[3] = {c.cout * es, (cuuint64_t)c.W * c.cout * es, (cuuint64_t)c.H * c.W * c.cout * es};
    const cuuint32_t rbox[4] = {(cuuint32_t)O::ROW, (cuuint32_t)(RUN * G::PL), 1, 1};
    const cuuint32_t rstride[4] = {1, (cuuint32_t)G::PL, 1, 1};
    r = enc(&rmap, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(c.res), rdim, rstr, rbox, rstride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  auto kern = qconv_wgmma_kernel<T, K, PHASED, N, RELU>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = c.tiles < sms ? c.tiles : sms;  // one block an SM, persistent
  kern<<<(unsigned)blocks, NT, bytes, stream>>>(xmap, rmap, c);
  return (int)cudaGetLastError();
}

// the N tiles the kernel is built for: plain 128, 80, 32, 8; phased 32, 8 (an
// integer wgmma takes N 8, 16, 24 or a multiple of 16)
template <typename T, int K, bool PHASED, bool RELU>
int launch_n(const CArgs& c, int n, const int8_t* xq, const int8_t* w, int nbatch, int cin_pad, int xw,
             int ntiles, int sms, cudaStream_t s) {
  if (n == 8) return launch<T, K, PHASED, 8, RELU>(c, xq, w, nbatch, cin_pad, xw, ntiles, sms, s);
  if (n == 32) return launch<T, K, PHASED, 32, RELU>(c, xq, w, nbatch, cin_pad, xw, ntiles, sms, s);
  if constexpr (!PHASED) {
    if (n == 80) return launch<T, K, PHASED, 80, RELU>(c, xq, w, nbatch, cin_pad, xw, ntiles, sms, s);
    if (n == 128) return launch<T, K, PHASED, 128, RELU>(c, xq, w, nbatch, cin_pad, xw, ntiles, sms, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The ReLU after the rounding is built for the plain 3x3 (the `qsd` site)
template <typename T>
int launch_conv(const CArgs& c, int k, int phased, int relu, int n, const int8_t* xq, const int8_t* w,
                int nbatch, int cin_pad, int xw, int ntiles, int sms, cudaStream_t s) {
  if (phased) return launch_n<T, 3, true, false>(c, n, xq, w, nbatch, cin_pad, xw, ntiles, sms, s);
  if (k == 1) return launch_n<T, 1, false, false>(c, n, xq, w, nbatch, cin_pad, xw, ntiles, sms, s);
  return relu ? launch_n<T, 3, false, true>(c, n, xq, w, nbatch, cin_pad, xw, ntiles, sms, s)
              : launch_n<T, 3, false, false>(c, n, xq, w, nbatch, cin_pad, xw, ntiles, sms, s);
}

// The launch plan's segments of N tiles (ops/quant.py `launch_plan`): up
// to two, (N, tiles, stages) each, the second from output channel N * tiles
// of the first
struct Plan {
  int n[2], tiles[2], stages[2];
};

// sw, amax: null, or the dynamic mode (sw the weights' scales, amax one
// float32 of scratch; q.sx and c.scale are then written here)
template <typename T>
int run(const QArgs& q, CArgs c, const Plan& pl, const int8_t* w, int nbatch, int k, const float* sw,
        float* amax, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err;
  if (amax != nullptr) {
    err = cudaMemsetAsync(amax, 0, sizeof(float), stream);
    if (err != cudaSuccess) return (int)err;
    int64_t n = 0;
    for (int s = 0; s < q.nparts; ++s) n += q.P * q.pc[s];
    const int64_t blocks = (n / (16 / sizeof(T)) + 255) / 256, cap = (int64_t)sms * 8;
    absmax_kernel<T><<<(unsigned)(blocks < 1 ? 1 : blocks < cap ? blocks : cap), 256, 0, stream>>>(q, amax);
    scales_kernel<<<1, 256, 0, stream>>>(amax, sw, const_cast<float*>(q.sx), const_cast<float*>(c.scale),
                                         q.cin, c.cout);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t strips = q.P / q.W * (q.phased ? 2 : 1) * (((q.phased ? q.W2 : q.W) + 31) / 32);
  const int64_t want = (strips * (q.cin_pad / 16) + 7) / 8, cap = (int64_t)sms * 8;  // 8 blocks an SM, grid-stride beyond
  const unsigned qgrid = (unsigned)(want < cap ? want : cap);
  const size_t qsmem = (size_t)(q.phased ? 4 : 1) * q.cin_pad * 2 * sizeof(float);
  auto quant = q.phased ? quantize_kernel<T, true> : quantize_kernel<T, false>;
  if (qsmem > 48 * 1024) {
    err = cudaFuncSetAttribute(quant, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)qsmem);
    if (err != cudaSuccess) return (int)err;
  }
  quant<<<qgrid, 256, qsmem, stream>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int xw = q.phased ? q.W2 : q.W;
  const int taps = k * k, phases = q.phased ? 4 : 1;
  for (int i = 0; i < 2 && pl.tiles[i] > 0; ++i) {
    c.n0 = i == 0 ? 0 : pl.n[0] * pl.tiles[0];
    c.stages = pl.stages[i];
    // the segment's weights follow those of the n0 channels before it
    const int8_t* ws = w + (int64_t)c.n0 * c.nchunk * phases * 2 * taps * 16;
    const int rc = launch_conv<T>(c, k, q.phased, c.relu_out, pl.n[i], q.xq, ws, nbatch, q.cin_pad, xw,
                                  pl.tiles[i], sms, stream);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

// p0..p3: the NHWC parts (c_i channels each, c_i = 0 for an absent part),
// contiguous; sx: float32 (sum c_i,) activation scales, (4, sum c_i) by
// pixel phase when phased; w: the int8 weights as ops/quant.py
// `format_weight` lays them out, for each N tile of the plan in turn
// [ceil(cin / 32)][phase][2][k * k][N][16] (one phase unless phased; the two
// 16-channel halves of each 32-channel step), zero past cin and cout;
// scale: float32 (cout,), (4, cout) when phased; bias, res: null when
// absent, else in the parts' dtype; xq: int8 scratch of
// [N][H][ceil(cin / 32) * 2][plane][x][16] (one plane of W columns, or two
// of ceil(W / 2) when phased); y: (N, H, W, cout). phased: k must be 3.
// relu_out: k 3, not phased. Dynamic mode: sw, the weights' float32
// (cout,) scales, and amax, one float32 of scratch; sx and scale are then
// scratch that the call fills (null sw and amax otherwise). The plan: n_a,
// tiles_a, stages_a, then n_b, tiles_b, stages_b (tiles_b 0 for one
// segment), as ops/quant.py `launch_plan` makes it. dtype: 0 float32, 1
// bfloat16.
extern "C" int prv2_quant_conv(const void* p0, const void* p1, const void* p2, const void* p3,
                               const void* sx, const void* w, const void* scale, const void* bias,
                               const void* res, void* xq, void* y, const void* sw, void* amax,
                               long long N, long long H, long long W, long long c0, long long c1,
                               long long c2, long long c3, long long cout, long long k,
                               long long relu_in, long long relu_out, long long phased, long long n_a,
                               long long tiles_a, long long stages_a, long long n_b, long long tiles_b,
                               long long stages_b, int dtype, void* stream) {
  if (N * H * W == 0) return 0;
  if (cout < 1 || (k != 1 && k != 3) || (phased && (k != 3 || amax != nullptr)) ||
      (relu_out && (phased || k != 3)) || (sw == nullptr) != (amax == nullptr))
    return (int)cudaErrorInvalidValue;
  // the plan must cover the output channels, its last tile holding the last one
  const long long covered = n_a * tiles_a + (tiles_b > 0 ? n_b * tiles_b : 0);
  const long long last = tiles_b > 0 ? n_b : n_a;
  if (tiles_a < 1 || tiles_b < 0 || covered < cout || covered - last >= cout) return (int)cudaErrorInvalidValue;
  QArgs q = {};
  const void* ps[MAXP] = {p0, p1, p2, p3};
  const long long cs[MAXP] = {c0, c1, c2, c3};
  for (int i = 0; i < MAXP; ++i) {
    if (cs[i] <= 0) break;
    q.part[q.nparts] = ps[i];
    q.pc[q.nparts] = (int)cs[i];
    q.poff[q.nparts] = q.cin;
    q.cin += (int)cs[i];
    ++q.nparts;
  }
  if (q.nparts == 0) return (int)cudaErrorInvalidValue;
  const size_t es = dtype == 0 ? 4 : 2;
  for (int i = 0; i < q.nparts; ++i) {
    const uintptr_t base = reinterpret_cast<uintptr_t>(q.part[i]);
    // a group's offset in its part, c0 - poff, must keep the loads aligned too
    q.vec[i] = q.pc[i] % 8 == 0 && q.poff[i] % 8 == 0 && base % 16 == 0 ? 8
               : q.pc[i] % 2 == 0 && q.poff[i] % 2 == 0 && base % (2 * es) == 0 ? 2
                                                                                 : 1;
  }
  q.cin_pad = (q.cin + KC - 1) / KC * KC;
  q.relu_in = (int)relu_in;
  q.phased = (int)phased;
  q.H = (int)H;
  q.W = (int)W;
  q.W2 = (int)((W + 1) / 2);
  q.sx = static_cast<const float*>(sx);
  q.xq = static_cast<int8_t*>(xq);
  q.P = N * H * W;
  CArgs c = {};
  c.scale = static_cast<const float*>(scale);
  c.bias = bias;
  c.res = res;
  c.y = y;
  c.H = (int)H;
  c.W = (int)W;
  c.cout = (int)cout;
  c.nchunk = q.cin_pad / KC;
  c.relu_out = (int)relu_out;
  // a thread's 8 outputs in whole 16-byte units
  c.vec = cout % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 && reinterpret_cast<uintptr_t>(res) % 16 == 0;
  c.pairs = cout % 2 == 0 && reinterpret_cast<uintptr_t>(scale) % 8 == 0 &&
            reinterpret_cast<uintptr_t>(bias) % (2 * es) == 0;
  const Plan pl = {{(int)n_a, (int)n_b}, {(int)tiles_a, (int)tiles_b}, {(int)stages_a, (int)stages_b}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* swf = static_cast<const float*>(sw);
  float* am = static_cast<float*>(amax);
  if (dtype == 0) return run<float>(q, c, pl, wq, (int)N, (int)k, swf, am, s);
  if (dtype == 1) return run<bf16>(q, c, pl, wq, (int)N, (int)k, swf, am, s);
  return (int)cudaErrorInvalidValue;
}
