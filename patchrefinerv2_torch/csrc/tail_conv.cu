// K9: the fusion head's full-resolution, low-channel convolutions (the tail)
//   y = act(LN(conv_k(relu?(cat(parts))) + bias + residual))
// on NHWC maps: up to 4 input parts of one spatial size, each with its own
// channel count, read in place (no concatenation in device memory); a 3x3
// SAME or 1x1 convolution with Cout <= 128; then, each optional and in this
// order, a per-channel bias, a residual add (N, H, W, Cout), a LayerNorm over
// the Cout channels of each pixel (eps, the fast variance
// max(E[x^2] - mean^2, 0), float32 statistics) and an activation (ReLU, or
// GELU: tanh form for bfloat16, erf form for float32). Every step runs in
// float32 and the result is rounded once.
//
// Replaces patchrefinerv2_tpu/ops/s2d.py:114 `s2d_same_kernel` (with
// `split`, over the parts of a concatenation), :139 `s2d_down_kernel` /
// :190 `conv_s2d_down` (the segment's entry conv), :156 `s2d_1x1_kernel`
// and :198 `layer_norm_s2d`: the TPU ran the tail in space-to-depth form so
// that 32 channels fill its 128-wide lanes. That re-layout is exact, so the
// function is a plain convolution with fused epilogues.
//
// Bound: bytes at the flagship's widths (Cin <= 98, Cout <= 32: each input
// read once and the output written once, ~0.06-0.3 ms a 16-patch chunk);
// operations at DA2's 128-wide sites (2 * P * 9 * Cin * Cout, ~1.9 TFLOP for
// the 256 -> 128 fusion conv); the flagship's 128 -> 32 `output_conv2` sits
// at the balance. Two kernels; ops/tail_conv.py `launch_plan` picks one and
// its shapes.
//
// bfloat16 with Cout > 8: `tail_wgmma_kernel`, a persistent,
// warp-specialised implicit GEMM on `wgmma.mma_async m64nNk16.f32.bf16`,
// N = Cout padded to 32 or 128, one block an SM walking tiles of ROWS
// output rows by 64 pixels by all N channels (so the LayerNorm needs no
// second pass):
// - producer warpgroups (two at N 32, one at N 128) keep a ring of stages
//   full under full / empty mbarriers, one k-step (16 input channels of the
//   concatenation) a stage: thread 0 brings the k-step's weights, one
//   contiguous block, by a bulk copy; the producers stage the tile's halo
//   as 16-byte cells [halo row][channel half][halo column][8 channels],
//   neighbouring threads on neighbouring bytes of a pixel: a cell of a part
//   whose rows allow it by one 16-byte cp.async, of a part with 4-byte
//   aligned rows (the 98-channel stage: 196-byte pixels) by four 4-byte
//   ones, zero-filled outside the image (the SAME padding); a cell that
//   straddles parts or ends past Cin (the 1-channel depth maps) through
//   registers, and the cells past Cin as zeros. TMA is not used for the
//   halo: its box rows would be 16 bytes, a row rate that held K10's first
//   version to a fifth of its peak, and the ragged parts' pixel strides are
//   not the multiples of 16 bytes it needs;
// - two consumer warpgroups, RUNS m64 runs each (a run is one tile row of
//   64 pixels; 2 at N 128, 4 at N 32), the operands K-major without
//   swizzle (core matrices of 8 rows by 16 bytes), so that the A operand of
//   tap (du, dv) is the halo at row + du, column + dv, with no im2col copy.
//   At N 128 both operands come from shared memory by descriptor (75% of
//   the tensor peak in the products); at N 32 A comes from registers
//   (ldmatrix), each halo row loaded once per column shift for the up to 3
//   runs that read it, the ReLU prologue applied there;
// - the epilogue in registers from the accumulators: bias, the residual
//   (brought into the consumer's output tile by cp.async while the
//   products run), the LayerNorm over the quad of lanes that holds a
//   pixel's N channels (two shuffles), the activation (GELU's tanh by
//   tanh.approx), one rounding, into the output tile in shared memory; then
//   the warpgroup writes the tile out in 16-byte units while the producers
//   fill the next tile's stages.
//
// float32 (CUDA-core FMAs: the tensor cores would round float32 inputs to
// TF32) and bfloat16 with Cout <= 8 (mma.sync: a wgmma of N 8 is
// issue-bound): `tail_conv_kernel`, a persistent block walks tiles of
// output pixels (16 x 16, or 8 x 16 at Cout_pad 128) with all of their
// output channels; for each chunk of 32 input channels it stages the tile's
// halo of every part in shared memory with cp.async (zeros outside the
// image and past the last channel) and the chunk's weights as
// [tap][channel][Cout_pad] (all chunks once per block when they fit); the
// accumulators go through a float32 tile in shared memory to the epilogue.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int MAXP = 4;  // input parts

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float gelu_tanh(float x) {
  // tanh.approx (MUFU.TANH, max relative error ~2^-11): the bfloat16 result
  // keeps 8 bits, and tanhf's ~20 instructions made the LayerNorm + GELU
  // sites' epilogue as long as their products
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  return 0.5f * x * (1.f + t);
}
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// global -> shared without a register round trip; zero-filled when !valid
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// ================================================================ CUDA cores and mma.sync
constexpr int TW = 16;                  // output tile columns (one m16 fragment)
constexpr int NWARPS = 8, NT = NWARPS * 32;
constexpr int KC = 32;                  // input channels per chunk
constexpr unsigned RESIDENT_BYTES = 113 * 1024;  // all weights staged once if they fit (2 blocks/SM)


struct Args {
  const void* part[MAXP];
  int pc[MAXP];    // channels of each part
  int poff[MAXP];  // first channel of each part in the concatenation
  int nparts, cin;
  const void* w;     // [nchunk][K * K][KC][Cout_pad], zero-padded
  const void* bias;  // (Cout,) or null
  const void* res;   // (N, H, W, Cout) or null
  const void* ln_g;  // (Cout,) LayerNorm scale, or null (no LayerNorm)
  const void* ln_b;
  void* y;           // (N, H, W, Cout)
  int N, H, W, cout, nchunk, relu_in, act, resident;
  float eps;
  unsigned h_off, o_off;  // shared-memory offsets of the halo and the output tile (weights at 0)
};

// Tile rows and row strides (elements). bfloat16 rows are 16-byte multiples
// for ldmatrix and conflict-free (80 bytes for the halo, (Cout_pad + 8) * 2
// for the weights); the float32 halo row is odd (the FMA loop reads a column).
template <typename T, int CP> struct Cfg {
  static constexpr bool BF = sizeof(T) == 2;
  static constexpr int TH = CP == 128 ? 8 : 16, TM = TH * TW;
  static constexpr int LDA = KC + (BF ? 8 : 1), LDW = CP + (BF ? 8 : 0), LDO = CP + 4;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// the same, to a generic pointer into shared memory
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) { cp16(smem_addr(dst), src, valid); }
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) { cp4(smem_addr(dst), src, valid); }

// ---------------------------------------------------------------- staging
// The halo of one part's channels [lo, lo + L) into the halo rows at
// channel d0, in units of BYTES, zeros outside the image: cp.async for 16-
// and 4-byte units (all of a thread's copies in flight at once), a plain
// load for 2-byte ones. float32 rows (odd strides) take 4-byte copies.
template <typename T, int K, int CP, int BYTES>
__device__ __forceinline__ void stage_part(const Args& a, const T* src, int C, int L, T* Hs, int d0,
                                           int n, int y0, int x0) {
  constexpr int R = K / 2, HW = TW + K - 1, HP = (Cfg<T, CP>::TH + K - 1) * HW;
  constexpr int LDA = Cfg<T, CP>::LDA, V = BYTES / sizeof(T);
  const int U = L / V;
  for (int e = threadIdx.x; e < HP * U; e += NT) {
    const int hp = e / U, u = e - hp * U;
    const int iy = y0 + hp / HW - R, ix = x0 + hp % HW - R;
    const bool in = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
    const T* s = in ? src + (((int64_t)n * a.H + iy) * a.W + ix) * C + u * V : src;
    T* d = Hs + hp * LDA + d0 + u * V;
    if constexpr (BYTES == 16 && sizeof(T) == 2) {
      cp16(d, s, in);
    } else if constexpr (BYTES >= 4) {
#pragma unroll
      for (int j = 0; j < BYTES / 4; ++j) cp4(d + j * 4 / sizeof(T), s + j * 4 / sizeof(T), in);
    } else {
      *d = in ? *s : from_f<T>(0.f);
    }
  }
}

// Channels [ch * KC, ch * KC + KC) of the concatenated parts over the tile's
// halo, each part's rows with the widest load they allow.
template <typename T, int K, int CP>
__device__ __forceinline__ void stage_halo(const Args& a, T* Hs, int n, int y0, int x0, int ch) {
  constexpr int HP = (Cfg<T, CP>::TH + K - 1) * (TW + K - 1), LDA = Cfg<T, CP>::LDA;
  constexpr int V16 = 16 / sizeof(T), V4 = 4 / sizeof(T);
  const int c0 = ch * KC;
  for (int i = 0; i < a.nparts; ++i) {
    const int lo = max(c0, a.poff[i]), hi = min(c0 + KC, a.poff[i] + a.pc[i]);
    if (lo >= hi) continue;
    const T* src = static_cast<const T*>(a.part[i]) + (lo - a.poff[i]);
    const int C = a.pc[i], L = hi - lo, d0 = lo - c0;
    const uintptr_t base = reinterpret_cast<uintptr_t>(src);
    if (C % V16 == 0 && L % V16 == 0 && d0 % V16 == 0 && base % 16 == 0)
      stage_part<T, K, CP, 16>(a, src, C, L, Hs, d0, n, y0, x0);
    else if (C % V4 == 0 && L % V4 == 0 && d0 % V4 == 0 && base % 4 == 0)
      stage_part<T, K, CP, 4>(a, src, C, L, Hs, d0, n, y0, x0);
    else
      stage_part<T, K, CP, sizeof(T)>(a, src, C, L, Hs, d0, n, y0, x0);
  }
  const int filled = min(KC, a.cin - c0), pad = KC - filled;  // zeros past the last channel
  for (int e = threadIdx.x; e < HP * pad; e += NT) {
    const int hp = e / pad;
    Hs[hp * LDA + filled + e - hp * pad] = from_f<T>(0.f);
  }
}

// Chunks [ch0, ch1) of the weights, [K * K * KC][CP] each in device memory,
// into rows of LDW.
template <typename T, int K, int CP>
__device__ __forceinline__ void stage_w(const Args& a, T* Ws, int ch0, int ch1) {
  constexpr int ROWS = K * K * KC, LDW = Cfg<T, CP>::LDW, VEC = 16 / sizeof(T), VPR = CP / VEC;
  const T* src = static_cast<const T*>(a.w) + (int64_t)ch0 * ROWS * CP;
  for (int e = threadIdx.x; e < (ch1 - ch0) * ROWS * VPR; e += NT) {
    const int r = e / VPR, v = e - r * VPR;
    cp16(Ws + r * LDW + v * VEC, src + r * CP + v * VEC, true);
  }
}

// ---------------------------------------------------------------- products
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t relu2(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hmax2(h, __float2bfloat162_rn(0.f));
  return *reinterpret_cast<uint32_t*>(&h);
}

template <typename T, int K, int CP> struct Core;

// bfloat16 (Cout <= 8, CP 8: above it the wgmma kernel runs): tensor cores.
// A (16 pixels x 16 channels) rows are halo pixels; B (16 channels x 8
// outputs) from the [tap][channel][output] weights with ldmatrix.trans.
// Each warp WM m16 fragments (tile rows) by the one n8 fragment. kmax: the
// chunk's channels that hold data, rounded up to 16 (the k-steps past it
// only hold zeros and are skipped).
template <int K, int CP> struct Core<bf16, K, CP> {
  static_assert(CP == 8, "bfloat16 takes this kernel at Cout <= 8");
  static constexpr int WM = 2, WN = 1, WARPS_M = 8;
  float acc[WM][WN][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  __device__ __forceinline__ void chunk(const bf16* Hs, const bf16* Ws, int kmax, bool relu_in) {
    constexpr int HW = TW + K - 1, LDA = Cfg<bf16, CP>::LDA, LDW = Cfg<bf16, CP>::LDW;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp % WARPS_M, wn = warp / WARPS_M;
#pragma unroll 1
    for (int tap = 0; tap < K * K; ++tap) {
      const int du = tap / K, dv = tap % K;
#pragma unroll
      for (int ks = 0; ks < KC; ks += 16) {
        if (ks >= kmax) break;
        uint32_t af[WM][4], bfr[WN][2];
#pragma unroll
        for (int mi = 0; mi < WM; ++mi) {
          const int ty = wm * WM + mi;
          ldsm_x4(af[mi], Hs + ((ty + du) * HW + dv + (lane & 15)) * LDA + ks + (lane >> 4) * 8);
          if (relu_in)
#pragma unroll
            for (int e = 0; e < 4; ++e) af[mi][e] = relu2(af[mi][e]);
        }
        const bf16* wrow = Ws + (tap * KC + ks) * LDW;
        ldsm_x2_t(bfr[0], wrow + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDW + wn * 8);
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
#pragma unroll
          for (int nj = 0; nj < WN; ++nj) mma_bf16(acc[mi][nj], af[mi], bfr[nj]);
      }
    }
  }

  __device__ __forceinline__ void store(float* Os) const {
    constexpr int LDO = Cfg<bf16, CP>::LDO;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp % WARPS_M, wn = warp / WARPS_M, g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int nj = 0; nj < WN; ++nj) {
        const int row = (wm * WM + mi) * 16 + g, col = (wn * WN + nj) * 8 + 2 * tig;
        *reinterpret_cast<float2*>(Os + row * LDO + col) = make_float2(acc[mi][nj][0], acc[mi][nj][1]);
        *reinterpret_cast<float2*>(Os + (row + 8) * LDO + col) =
            make_float2(acc[mi][nj][2], acc[mi][nj][3]);
      }
  }
};

// float32: CUDA-core FMAs, each thread RP consecutive pixels of a tile row
// by QC consecutive output channels.
template <int K, int CP> struct Core<float, K, CP> {
  static constexpr int QC = CP == 128 ? 8 : 4, NCG = CP / QC, RP = Cfg<float, CP>::TM * NCG / NT;
  float acc[RP][QC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < QC; ++q) acc[r][q] = 0.f;
  }

  __device__ __forceinline__ void chunk(const float* Hs, const float* Ws, int kmax, bool relu_in) {
    constexpr int HW = TW + K - 1, LDA = Cfg<float, CP>::LDA, LDW = Cfg<float, CP>::LDW;
    const int cg = threadIdx.x % NCG, m0 = (threadIdx.x / NCG) * RP;
    const int ty = m0 / TW, tx = m0 % TW;
#pragma unroll 1
    for (int tap = 0; tap < K * K; ++tap) {
      const int du = tap / K, dv = tap % K;
      const float* hrow = Hs + ((ty + du) * HW + tx + dv) * LDA;
      const float* wrow = Ws + tap * KC * LDW + cg * QC;
#pragma unroll 4
      for (int c = 0; c < kmax; ++c) {
        float wv[QC];
#pragma unroll
        for (int q = 0; q < QC; q += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(wrow + c * LDW + q);
          wv[q] = w4.x;
          wv[q + 1] = w4.y;
          wv[q + 2] = w4.z;
          wv[q + 3] = w4.w;
        }
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float h = relu_in ? fmaxf(hrow[r * LDA + c], 0.f) : hrow[r * LDA + c];
#pragma unroll
          for (int q = 0; q < QC; ++q) acc[r][q] = fmaf(h, wv[q], acc[r][q]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* Os) const {
    constexpr int LDO = Cfg<float, CP>::LDO;
    const int cg = threadIdx.x % NCG, m0 = (threadIdx.x / NCG) * RP;
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < QC; ++q) Os[(m0 + r) * LDO + cg * QC + q] = acc[r][q];
  }
};

// ---------------------------------------------------------------- epilogue

// 8 consecutive elements (16-byte aligned) to / from float registers
template <typename T> __device__ __forceinline__ void load8(const T* p, float x[8]) {
  alignas(16) T v[8];
#pragma unroll
  for (int j = 0; j < 8; j += 16 / sizeof(T))
    *reinterpret_cast<uint4*>(v + j) = *reinterpret_cast<const uint4*>(p + j);
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = to_f(v[j]);
}
template <typename T> __device__ __forceinline__ void store8(T* p, const float x[8]) {
  alignas(16) T v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = from_f<T>(x[j]);
#pragma unroll
  for (int j = 0; j < 8; j += 16 / sizeof(T))
    *reinterpret_cast<uint4*>(p + j) = *reinterpret_cast<const uint4*>(v + j);
}

// bias, residual, LayerNorm, activation and the store, LPR lanes per pixel
// (8 channels each).
template <typename T, int CP>
__device__ __forceinline__ void epilogue(const Args& a, const float* Os, int n, int y0, int x0) {
  constexpr int TM = Cfg<T, CP>::TM, LDO = Cfg<T, CP>::LDO, LPR = CP / 8, RPB = NT / LPR;
  const int c0 = (threadIdx.x % LPR) * 8, cout = a.cout;
  const T* bias = static_cast<const T*>(a.bias);
  const T* res = static_cast<const T*>(a.res);
  const T* g = static_cast<const T*>(a.ln_g);
  const T* b = static_cast<const T*>(a.ln_b);
  T* y = static_cast<T*>(a.y);
  // whole rows of 8 channels: vector loads and stores (y comes from the allocator)
  const bool full = cout == CP, res_vec = full && reinterpret_cast<uintptr_t>(res) % 16 == 0;
  for (int m = threadIdx.x / LPR; m < TM; m += RPB) {
    const int iy = y0 + m / TW, ix = x0 + m % TW;
    const bool valid = iy < a.H && ix < a.W;
    const int64_t p = ((int64_t)n * a.H + iy) * a.W + ix;
    float v[8], r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = Os[m * LDO + c0 + j];
      r[j] = 0.f;
    }
    if (res != nullptr && valid) {
      if (res_vec) {
        load8(res + p * cout + c0, r);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c0 + j < cout) r[j] = to_f(res[p * cout + c0 + j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < cout) v[j] += (bias != nullptr ? to_f(bias[c0 + j]) : 0.f) + r[j];
    if (g != nullptr) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + j < cout) {
          s1 += v[j];
          s2 += v[j] * v[j];
        }
#pragma unroll
      for (int off = LPR / 2; off > 0; off /= 2) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      const float mean = s1 / cout;
      const float rstd = rsqrtf(fmaxf(s2 / cout - mean * mean, 0.f) + a.eps);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + j < cout) v[j] = (v[j] - mean) * (rstd * to_f(g[c0 + j])) + to_f(b[c0 + j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (a.act == ACT_RELU) v[j] = fmaxf(v[j], 0.f);
      else if (a.act == ACT_GELU) v[j] = sizeof(T) == 2 ? gelu_tanh(v[j]) : gelu_erf(v[j]);
    }
    if (!valid) continue;
    T* dst = y + p * cout + c0;
    if (full) {
      store8(dst, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + j < cout) dst[j] = from_f<T>(v[j]);
    }
  }
}

// ---------------------------------------------------------------- kernel
template <typename T, int K, int CP>
__global__ void __launch_bounds__(NT) tail_conv_kernel(const Args a) {
  constexpr int TH = Cfg<T, CP>::TH, WCHUNK = K * K * KC * Cfg<T, CP>::LDW;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ws = reinterpret_cast<T*>(smem);
  T* Hs = reinterpret_cast<T*>(smem + a.h_off);
  float* Os = reinterpret_cast<float*>(smem + a.o_off);
  const int tiles_x = (a.W + TW - 1) / TW, tiles_y = (a.H + TH - 1) / TH;
  const int64_t per_image = (int64_t)tiles_x * tiles_y, tiles = per_image * a.N;
  if (a.resident) stage_w<T, K, CP>(a, Ws, 0, a.nchunk);
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n = (int)(t / per_image), r = (int)(t % per_image);
    const int y0 = (r / tiles_x) * TH, x0 = (r % tiles_x) * TW;
    Core<T, K, CP> core;
    core.zero();
    for (int ch = 0; ch < a.nchunk; ++ch) {
      __syncthreads();  // the previous chunk's (or tile's) shared memory is free
      stage_halo<T, K, CP>(a, Hs, n, y0, x0, ch);
      if (!a.resident) stage_w<T, K, CP>(a, Ws, ch, ch + 1);
      cp_wait_all();
      __syncthreads();
      const int kmax = min(KC, (a.cin - ch * KC + 15) / 16 * 16);
      core.chunk(Hs, Ws + (a.resident ? ch * WCHUNK : 0), kmax, a.relu_in);
    }
    __syncthreads();  // the output tile overlays the halo (and the weights)
    core.store(Os);
    __syncthreads();
    epilogue<T, CP>(a, Os, n, y0, x0);
  }
}

constexpr unsigned up128z(size_t b) { return (unsigned)((b + 127) / 128 * 128); }

template <typename T, int K, int CP>
int launch_mma(Args a, cudaStream_t stream) {
  using C = Cfg<T, CP>;
  constexpr int HP = (C::TH + K - 1) * (TW + K - 1);
  constexpr unsigned wb = up128z((size_t)K * K * KC * C::LDW * sizeof(T));
  constexpr unsigned hb = up128z((size_t)HP * C::LDA * sizeof(T));
  constexpr unsigned ob = up128z((size_t)C::TM * C::LDO * sizeof(float));
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // resident: [all weights][halo, then the output tile over it]; else [one
  // chunk of weights][halo], then the output tile over both
  const unsigned w_all = wb * a.nchunk, h_or_o = hb > ob ? hb : ob;
  a.resident = w_all + h_or_o <= RESIDENT_BYTES;
  a.h_off = a.resident ? w_all : wb;
  a.o_off = a.resident ? w_all : 0;
  const unsigned bytes = a.resident ? w_all + h_or_o : (wb + hb > ob ? wb + hb : ob);
  if (bytes > (unsigned)optin) return (int)cudaErrorInvalidValue;
  auto kern = tail_conv_kernel<T, K, CP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (int64_t)a.N * ((a.H + C::TH - 1) / C::TH) * ((a.W + TW - 1) / TW);
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(tiles < cap ? tiles : cap);
  kern<<<blocks, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// float32 at every Cout_pad; bfloat16 at Cout <= 8 only (CP 8), where
// wgmma's N 8 products are issue-bound and this kernel is the faster
template <typename T>
int dispatch_mma(const Args& a, int k, cudaStream_t s) {
  const int cp = a.cout <= 8 ? 8 : (a.cout <= 32 ? 32 : 128);
  if constexpr (sizeof(T) == 2) {
    if (cp != 8) return (int)cudaErrorInvalidValue;
    return k == 3 ? launch_mma<T, 3, 8>(a, s) : launch_mma<T, 1, 8>(a, s);
  } else {
    if (k == 3) {
      if (cp == 8) return launch_mma<T, 3, 8>(a, s);
      if (cp == 32) return launch_mma<T, 3, 32>(a, s);
      return launch_mma<T, 3, 128>(a, s);
    }
    if (cp == 8) return launch_mma<T, 1, 8>(a, s);
    if (cp == 32) return launch_mma<T, 1, 32>(a, s);
    return launch_mma<T, 1, 128>(a, s);
  }
}

// ================================================================ bfloat16
constexpr int RUN = 64;        // output pixels of an m64 run: one tile row
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;
// [align 128][full[8], empty[8]: 128 B][bias, LN scale, LN bias: 3 x 128 float32][ring]
constexpr uint32_t BAR_BYTES = 128, PARAM_BYTES = 3 * 128 * 4, FIXED = 128 + BAR_BYTES + PARAM_BYTES;

// The shapes of one tile: K (3 or 1), N output channels, RUNS runs a
// consumer warpgroup. A stage (one k-step of 16 input channels): the halo's
// cells [row][half][column][16 B] (a half: 8 of the k-step's channels),
// then the weights [half][tap][n][16 B].
template <int K, int N, int RUNS> struct Geo {
  static constexpr int ROWS = 2 * RUNS, TAPS = K * K;
  static constexpr int HR = ROWS + K - 1, HC = RUN + K - 1;
  static constexpr int CELLS = HR * 2 * HC;
  static constexpr uint32_t A_LBO = HC * 16;        // from one channel half to the other
  static constexpr uint32_t B_LBO = TAPS * N * 16;
  static constexpr uint32_t B_BYTES = 2 * B_LBO;
  static constexpr uint32_t A_PAD = up128(CELLS * 16);  // the weights' offset in a stage
  static constexpr uint32_t STAGE = A_PAD + B_BYTES;
  static_assert(N % 8 == 0 && N <= 128 && B_BYTES % 16 == 0, "tile");
};

struct WArgs {
  const bf16* part[MAXP];
  int pc[MAXP], poff[MAXP];
  int vec[MAXP];  // channels a load of the part's rows takes: 8 (16 bytes), 2 (4 bytes) or 1
  int nparts, cin, nk, relu_in, act, cout;  // nk: k-steps of 16 channels
  const bf16* w;  // [nk][2][K * K][N][8], zero past cin and cout
  const bf16 *bias, *res, *ln_g, *ln_b;
  bf16* y;
  int H, W, tiles_x, stages;
  int64_t per_n, tiles;
  float eps;
};

// d (N / 2 float32 a thread) += A (64 x 16 bfloat16) * B (16 x N bfloat16),
// both K-major descriptors (N 128)
template <int N> __device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b);
template <> __device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// the same with A (the m64 x k16 tile, this warp's 16 rows as the
// m16n8k16 fragment: rows g and g + 8, channels 2 tig and + 8) in registers
// (N 32)
template <int N> __device__ __forceinline__ void wgmma_bf16_ra(float* d, const uint32_t* a, uint64_t b);
template <> __device__ __forceinline__ void wgmma_bf16_ra<32>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// the arrival on `bar` once this thread's cp.asyncs so far have landed
__device__ __forceinline__ void cp_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

// How a cell of the k-step's channel half [c0, c0 + 8) is staged
enum { CELL_ZERO = 0, CELL_CP16, CELL_CP4, CELL_ELEM };
struct Half {
  const bf16* src;  // the half's first channel in its part's first pixel
  int pc, mode;
};
// The part that holds channel c (constant indices only, so the arguments
// stay in the parameter space): its rows, width, first channel and vector
struct Part {
  const bf16* src;
  int pc, poff, vec;
};
__device__ __forceinline__ Part part_of(const WArgs& a, int c) {
  Part p = {a.part[0], a.pc[0], a.poff[0], a.vec[0]};
#pragma unroll
  for (int s = 1; s < MAXP; ++s)
    if (s < a.nparts && c >= a.poff[s]) p = Part{a.part[s], a.pc[s], a.poff[s], a.vec[s]};
  return p;
}
__device__ __forceinline__ Half half_of(const WArgs& a, int c0) {
  if (c0 >= a.cin) return Half{a.part[0], 0, CELL_ZERO};
  const Part p = part_of(a, c0);
  const int off = c0 - p.poff;
  const bool in_one = off + 8 <= p.pc;
  const int mode = !in_one ? CELL_ELEM : p.vec == 8 ? CELL_CP16 : p.vec == 2 ? CELL_CP4 : CELL_ELEM;
  return Half{p.src + off, p.pc, mode};
}

// channel c of pixel p (zero past cin), through its part
__device__ __forceinline__ bf16 element(const WArgs& a, int c, int64_t p) {
  if (c >= a.cin) return __float2bfloat16_rn(0.f);
  const Part q = part_of(a, c);
  return q.src[p * q.pc + c - q.poff];
}

// One cell: the 8 channels of half h at pixel (iy, ix) of image n
__device__ __forceinline__ void stage_cell(const WArgs& a, const Half& h, int c0, uint32_t dst, int n, int iy,
                                           int ix) {
  const bool in = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
  const int64_t p = in ? ((int64_t)n * a.H + iy) * a.W + ix : 0;
  const bf16* s = h.src + p * h.pc;
  switch (h.mode) {
    case CELL_CP16:
      cp16(dst, s, in);
      return;
    case CELL_CP4:
#pragma unroll
      for (int j = 0; j < 4; ++j) cp4(dst + 4 * j, s + 2 * j, in);
      return;
    default:
      break;
  }
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (in && h.mode == CELL_ELEM) {
    alignas(16) bf16 e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = element(a, c0 + j, p);
    v = *reinterpret_cast<const uint4*>(e);
  }
  sts128(dst, v);
}

// A consumer warpgroup's output tile in shared memory: RUNS * 64 pixel rows
// of N bfloat16, each row padded by 16 bytes so that the fragment pairs a
// warp writes (rows g, columns 2 tig) fall in distinct banks.
template <int N, int RUNS> struct OutTile {
  static constexpr uint32_t PITCH = N * 2 + 16;
  static constexpr uint32_t BYTES = RUNS * RUN * PITCH;
};

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// The epilogue of one consumer warpgroup from its accumulators: bias,
// residual, LayerNorm (LN), activation (ACT), one rounding, into the output
// tile `out`. Warp w4 holds rows m = 16 w4 + g and + 8 of each run, columns
// 8j + 2 tig and + 1; a pixel's N channels lie in the quad of lanes 4g ..
// 4g + 3. The residual (`res`) waits in the output tile, each thread reading
// the pair it then overwrites. Past cout the
// parameters, the accumulators (zero weights) and the residual are zeros,
// so the padded columns need no test and add nothing to the LayerNorm's
// sums; the copy-out skips them. The act and LN cases are separate
// instantiations, each a few instructions an element.
template <int N, int RUNS, int ACT, bool LN>
__device__ __forceinline__ void epilogue_regs(const WArgs& a, float (&acc)[RUNS][N / 2], const float* prm, uint32_t out,
                                              bool res) {
  using O = OutTile<N, RUNS>;
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int r = 0; r < RUNS; ++r)
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const uint32_t row = out + (r * RUN + 16 * w4 + g + 8 * hlf) * O::PITCH + 4 * tig;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(prm + 8 * j + 2 * tig);
        float v0 = acc[r][4 * j + 2 * hlf] + b.x, v1 = acc[r][4 * j + 2 * hlf + 1] + b.y;
        if (res) {
          const uint32_t u = lds32(row + 16 * j);
          const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(&u);
          v0 += __low2float(r2);
          v1 += __high2float(r2);
        }
        if (LN) {  // a second pass normalises
          acc[r][4 * j + 2 * hlf] = v0;
          acc[r][4 * j + 2 * hlf + 1] = v1;
          s1 += v0 + v1;
          s2 += v0 * v0 + v1 * v1;
        } else {
          if (ACT == ACT_RELU) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          } else if (ACT == ACT_GELU) {
            v0 = gelu_tanh(v0);
            v1 = gelu_tanh(v1);
          }
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
          sts32(row + 16 * j, *reinterpret_cast<const uint32_t*>(&h2));
        }
      }
      if (!LN) continue;
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
      const float mean = s1 / a.cout, rstd = rsqrtf(fmaxf(s2 / a.cout - mean * mean, 0.f) + a.eps);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c = 8 * j + 2 * tig;
        const float2 gg = *reinterpret_cast<const float2*>(prm + 128 + c);
        const float2 bb = *reinterpret_cast<const float2*>(prm + 256 + c);
        float o[2] = {(acc[r][4 * j + 2 * hlf] - mean) * (rstd * gg.x) + bb.x,
                      (acc[r][4 * j + 2 * hlf + 1] - mean) * (rstd * gg.y) + bb.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (ACT == ACT_RELU) o[e] = fmaxf(o[e], 0.f);
          if (ACT == ACT_GELU) o[e] = gelu_tanh(o[e]);
        }
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(o[0], o[1]);
        sts32(row + 16 * j, *reinterpret_cast<const uint32_t*>(&h2));
      }
    }
}

// The output tile's pixel rows (pixels x0 .. x0 + 63 of rows y0 .. y0 + RUNS
// - 1 of image n) to or from device memory by the warpgroup's 128 threads.
// `vec` (cout == N, 16-byte aligned rows): neighbouring threads on
// neighbouring 16-byte units of a row, the residual in by cp.async;
// else one element a thread, the residual in by plain loads, zeros past
// cout and outside the map.
template <int N, int RUNS, bool TO_TILE>
__device__ __forceinline__ void tile_copy(const WArgs& a, uint32_t out, bool vec, int n, int y0, int x0) {
  using O = OutTile<N, RUNS>;
  const int t = threadIdx.x & 127;
  if (vec) {
    for (int i = t; i < RUNS * RUN * (N / 8); i += 128) {
      const int row = i / (N / 8), c8 = i % (N / 8), iy = y0 + row / RUN, ix = x0 + row % RUN;
      if (iy >= a.H || ix >= a.W) continue;
      const int64_t at = (((int64_t)n * a.H + iy) * a.W + ix) * N + 8 * c8;
      const uint32_t sm = out + row * O::PITCH + 16 * c8;
      if (TO_TILE)
        cp16(sm, a.res + at, true);
      else
        *reinterpret_cast<uint4*>(a.y + at) = lds128(sm);
    }
  } else if (TO_TILE) {
    for (int i = t; i < RUNS * RUN * N / 2; i += 128) {
      const int row = i / (N / 2), c = 2 * (i % (N / 2)), iy = y0 + row / RUN, ix = x0 + row % RUN;
      const bool in = iy < a.H && ix < a.W;
      const int64_t at = (((int64_t)n * a.H + iy) * a.W + ix) * a.cout + c;
      const float v0 = in && c < a.cout ? __bfloat162float(a.res[at]) : 0.f;
      const float v1 = in && c + 1 < a.cout ? __bfloat162float(a.res[at + 1]) : 0.f;
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
      sts32(out + row * O::PITCH + 2 * c, *reinterpret_cast<const uint32_t*>(&h2));
    }
  } else {
    for (int i = t; i < RUNS * RUN * a.cout; i += 128) {
      const int row = i / a.cout, c = i - row * a.cout, iy = y0 + row / RUN, ix = x0 + row % RUN;
      if (iy >= a.H || ix >= a.W) continue;
      const uint32_t u = lds32(out + row * O::PITCH + (c & ~1) * 2);
      const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&u);
      a.y[(((int64_t)n * a.H + iy) * a.W + ix) * a.cout + c] = c & 1 ? h2.y : h2.x;
    }
  }
}

// Shared memory: the barriers (full[s] at +8s, empty[s] at +64+8s), the
// epilogue's parameters, the ring, the consumers' output tiles. The halo
// goes by cp.async (and registers), the weights by one bulk copy a k-step.
// Persistent: a block walks tiles blockIdx.x, + gridDim.x, ...; tile t is
// image t / per_n, rows y0 .. y0 + ROWS - 1, pixels x0 .. x0 + 63.
template <int K, int N, int RUNS, int PWG>
__global__ void __launch_bounds__(128 * (PWG + 2), 1) tail_wgmma_kernel(const WArgs a) {
  constexpr int PRODUCERS = 128 * PWG, WNT = PRODUCERS + 256;  // PWG producer warpgroups, then two consumers
  using G = Geo<K, N, RUNS>;
  using O = OutTile<N, RUNS>;
  // N 32: A from registers (ldmatrix), B from shared memory; N 128: both
  // from shared memory (its accumulators leave no registers for A)
  constexpr bool AREG = N == 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 127) & ~127u;
  const uint32_t bars = base, ring = base + BAR_BYTES + PARAM_BYTES;
  const uint32_t outs = ring + a.stages * G::STAGE;
  float* prm = reinterpret_cast<float*>(smem_raw + (base + BAR_BYTES - smem_addr(smem_raw)));
  const int stages = a.stages, wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, PRODUCERS + 1);  // each producer's arrival, the weights' expect_tx
      mbar_init(bars + 64 + 8 * s, 8);         // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the bias and the LayerNorm's scale and bias in float32, zeros past cout
  for (int i = threadIdx.x; i < 3 * N; i += WNT) {
    const bf16* v = i < N ? a.bias : i < 2 * N ? a.ln_g : a.ln_b;
    const int c = i % N;
    prm[(i / N) * 128 + c] = v != nullptr && c < a.cout ? __bfloat162float(v[c]) : 0.f;
  }
  __syncthreads();
  auto origin = [&](int64_t t, int& n, int& y0, int& x0) {
    n = (int)(t / a.per_n);
    const int tr = (int)(t % a.per_n);
    y0 = tr / a.tiles_x * G::ROWS;
    x0 = tr % a.tiles_x * RUN;
  };

  if (wg < PWG) {  // the producers
    const int tid = threadIdx.x;
    int it = 0;
    for (int64_t t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      int n, y0, x0;
      origin(t, n, y0, x0);
      for (int ks = 0; ks < a.nk; ++ks, ++it) {
        const int s = it % stages;
        if (it >= stages) mbar_wait(bars + 64 + 8 * s, (it / stages - 1) & 1);
        const uint32_t full = bars + 8 * s, st = ring + s * G::STAGE;
        if (tid == 0) {
          mbar_expect_tx(full, G::B_BYTES);
          bulk_load(st + G::A_PAD, a.w + (int64_t)ks * (G::B_BYTES / 2), G::B_BYTES, full);
        }
        const Half h0 = half_of(a, 16 * ks), h1 = half_of(a, 16 * ks + 8);
        if (h0.mode == CELL_CP4 && h1.mode == CELL_CP4) {
          // 4-byte units, neighbouring threads on neighbouring words of a
          // pixel's 32 bytes: (row, column, half, word), word fastest
          for (int e = tid; e < 4 * G::CELLS; e += PRODUCERS) {
            const int wd = e & 3, hh = (e >> 2) & 1, px = e >> 3, hy = px / G::HC, hx = px - hy * G::HC;
            const int iy = y0 + hy - K / 2, ix = x0 + hx - K / 2;
            const bool in = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
            const Half& h = hh ? h1 : h0;
            const bf16* src = h.src + (in ? ((int64_t)n * a.H + iy) * a.W + ix : 0) * h.pc + 2 * wd;
            cp4(st + ((hy * 2 + hh) * G::HC + hx) * 16 + 4 * wd, src, in);
          }
        } else {
          // cells (row, column, half), half fastest: a pixel's 32 bytes by two neighbouring threads
          for (int e = tid; e < G::CELLS; e += PRODUCERS) {
            const int hh = e & 1, px = e >> 1, hy = px / G::HC, hx = px - hy * G::HC;
            stage_cell(a, hh ? h1 : h0, 16 * ks + 8 * hh, st + ((hy * 2 + hh) * G::HC + hx) * 16, n,
                       y0 + hy - K / 2, x0 + hx - K / 2);
          }
        }
        // the arrival once this thread's cp.asyncs have landed (at once for
        // cells that went through registers); the consumers fence
        cp_arrive(full);
      }
    }
    return;
  }

  const int cw = wg - PWG;  // consumer cw takes the tile's rows cw * RUNS ..
  const int lane = threadIdx.x & 31;
  const uint32_t out = outs + cw * O::BYTES;
  // the residual and the output through the tile in 16-byte units; the
  // residual waits in the tile (cp.async while the products run, or plain
  // loads after them)
  const bool vec = a.cout == N && reinterpret_cast<uintptr_t>(a.y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.res) % 16 == 0;
  const bool res = a.res != nullptr, res_async = res && vec;
  float acc[RUNS][N / 2];
  int it = 0;
  for (int64_t t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    int n, y0, x0;
    origin(t, n, y0, x0);
    named_sync(2 + cw, 128);  // the last tile's copy-out has read the output tile
    if (res_async) {  // the residual into the output tile while the products run
      tile_copy<N, RUNS, true>(a, out, true, n, y0 + cw * RUNS, x0);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
#pragma unroll
    for (int r = 0; r < RUNS; ++r)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[r][i] = 0.f;
    for (int ks = 0; ks < a.nk; ++ks, ++it) {
      const int s = it % stages;
      mbar_wait(bars + 8 * s, (it / stages) & 1);
      const uint32_t st = ring + s * G::STAGE, wst = st + G::A_PAD;
      if constexpr (!AREG) {  // (with A in registers ldmatrix reads the cells)
        if (a.relu_in) {
          // the ReLU prologue in place, the two consumers half the cells
          // each, then every cell relu'd before either multiplies
          for (int e = threadIdx.x - PRODUCERS; e < G::CELLS; e += 256) {
            const uint4 v = lds128(st + e * 16);
            sts128(st + e * 16, make_uint4(relu2(v.x), relu2(v.y), relu2(v.z), relu2(v.w)));
          }
          fence_async_smem();
          named_sync(1, 256);
        } else {
          fence_async_smem();  // the producers' cells, seen by the async proxy
        }
      }
      if constexpr (AREG) {
        // A in registers: each halo row R of this consumer's RUNS + K - 1
        // is loaded once per column shift dv (ldmatrix, the ReLU prologue
        // applied there) and feeds the K runs r = R - du that read it; the
        // fragments are double-buffered by row, a row's products one
        // commit group, so a buffer is reloaded once its group is done
        const int w4 = (threadIdx.x >> 5) & 3;
        const uint32_t arow = st + ((lane >> 4) * G::HC + 16 * w4 + (lane & 15)) * 16;
        uint32_t af[2][K][4];
#pragma unroll
        for (int R = 0; R < RUNS + K - 1; ++R) {
          if (R >= 2) wgmma_wait<1>();
#pragma unroll
          for (int dv = 0; dv < K; ++dv) {
            ldsm_x4(af[R & 1][dv], arow + ((cw * RUNS + R) * 2 * G::HC + dv) * 16);
            if (a.relu_in)
#pragma unroll
              for (int q = 0; q < 4; ++q) af[R & 1][dv][q] = relu2(af[R & 1][dv][q]);
          }
          wgmma_fence();
#pragma unroll
          for (int dv = 0; dv < K; ++dv)
#pragma unroll
            for (int du = 0; du < K; ++du) {
              const int r = R - du;
              if (r >= 0 && r < RUNS)
                wgmma_bf16_ra<N>(acc[r], af[R & 1][dv], desc(wst + (du * K + dv) * N * 16, G::B_LBO));
            }
          wgmma_commit();
        }
      } else {
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < G::TAPS; ++tap) {
          const int du = tap / K, dv = tap % K;
          const uint64_t db = desc(wst + tap * N * 16, G::B_LBO);
#pragma unroll
          for (int r = 0; r < RUNS; ++r) {
            const int row = cw * RUNS + r;
            wgmma_bf16<N>(acc[r], desc(st + ((row + du) * 2 * G::HC + dv) * 16, G::A_LBO), db);
          }
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(bars + 64 + 8 * s);
    }
    if (res_async)
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    else if (res)
      tile_copy<N, RUNS, true>(a, out, false, n, y0 + cw * RUNS, x0);
    named_sync(2 + cw, 128);  // the residual has landed in the tile
    switch (a.act * 2 + (a.ln_g != nullptr)) {
      case ACT_NONE * 2: epilogue_regs<N, RUNS, ACT_NONE, false>(a, acc, prm, out, res); break;
      case ACT_RELU * 2: epilogue_regs<N, RUNS, ACT_RELU, false>(a, acc, prm, out, res); break;
      case ACT_GELU * 2: epilogue_regs<N, RUNS, ACT_GELU, false>(a, acc, prm, out, res); break;
      case ACT_NONE * 2 + 1: epilogue_regs<N, RUNS, ACT_NONE, true>(a, acc, prm, out, res); break;
      case ACT_RELU * 2 + 1: epilogue_regs<N, RUNS, ACT_RELU, true>(a, acc, prm, out, res); break;
      default: epilogue_regs<N, RUNS, ACT_GELU, true>(a, acc, prm, out, res); break;
    }
    named_sync(2 + cw, 128);  // the tile is written
    tile_copy<N, RUNS, false>(a, out, vec, n, y0 + cw * RUNS, x0);
  }
}

template <int K, int N, int RUNS, int PWG>
int launch_wgmma(WArgs a, cudaStream_t stream) {
  using G = Geo<K, N, RUNS>;
  const unsigned bytes = FIXED + a.stages * G::STAGE + 2 * OutTile<N, RUNS>::BYTES;
  if (a.stages < 1 || a.stages > MAX_STAGES || bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  a.tiles_x = (a.W + RUN - 1) / RUN;
  a.per_n = (int64_t)a.tiles_x * ((a.H + G::ROWS - 1) / G::ROWS);
  a.tiles *= a.per_n;  // the caller set the batch
  auto kern = tail_wgmma_kernel<K, N, RUNS, PWG>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = a.tiles < sms ? a.tiles : sms;  // one block an SM, persistent
  kern<<<(unsigned)blocks, 128 * (PWG + 2), bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// the tiles the kernel is built for: N 128 with 2 runs a consumer (4-row
// tiles) and one producer warpgroup (the accumulators need the registers);
// N 32 with 4 runs (8-row tiles) and two producer warpgroups, whose
// cp.asyncs in flight are what the byte-bound sites need (Cout <= 8 takes
// the mma.sync kernel)
int dispatch_wgmma(const WArgs& a, int k, int n, int runs, int pwg, cudaStream_t s) {
  if (k == 3) {
    if (n == 128 && runs == 2 && pwg == 1) return launch_wgmma<3, 128, 2, 1>(a, s);
    if (n == 32 && runs == 4 && pwg == 2) return launch_wgmma<3, 32, 4, 2>(a, s);
  } else {
    if (n == 128 && runs == 2 && pwg == 1) return launch_wgmma<1, 128, 2, 1>(a, s);
    if (n == 32 && runs == 4 && pwg == 2) return launch_wgmma<1, 32, 4, 2>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// p0..p3: the NHWC parts (c_i channels each, c_i = 0 for an absent part),
// contiguous; w: the weights as ops/tail_conv.py `format_weight` lays them
// out for the dtype: float32 [ceil(cin / 32)][k * k][32][n_tile], bfloat16
// [ceil(cin / 16)][2][k * k][n_tile][8], zero-padded; bias, res, ln_g /
// ln_b: null when absent; y: (N, H, W, Cout) contiguous. act: 0 none, 1
// ReLU, 2 GELU. The plan (ops/tail_conv.py `launch_plan`): n_tile (8, 32 or
// 128, >= cout), and for bfloat16 the runs a consumer and the ring's
// stages. dtype: 0 float32, 1 bfloat16.
extern "C" int prv2_tail_conv(const void* p0, const void* p1, const void* p2, const void* p3,
                              const void* w, const void* bias, const void* res, const void* ln_g,
                              const void* ln_b, void* y, long long N, long long H, long long W,
                              long long c0, long long c1, long long c2, long long c3,
                              long long cout, long long k, long long relu_in, long long act,
                              long long n_tile, long long runs, long long producers, long long stages,
                              float eps, int dtype, void* stream) {
  if (N * H * W == 0) return 0;
  if (cout < 1 || cout > n_tile || (k != 1 && k != 3) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const void* ps[MAXP] = {p0, p1, p2, p3};
  const long long cs[MAXP] = {c0, c1, c2, c3};
  int nparts = 0, cin = 0, pc[MAXP] = {}, poff[MAXP] = {};
  const void* part[MAXP] = {};
  for (int i = 0; i < MAXP; ++i) {
    if (cs[i] <= 0) break;
    part[nparts] = ps[i];
    pc[nparts] = (int)cs[i];
    poff[nparts] = cin;
    cin += (int)cs[i];
    ++nparts;
  }
  if (nparts == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 || (dtype == 1 && runs == 0)) {  // the CUDA-core / mma.sync kernel
    Args a = {};
    for (int i = 0; i < nparts; ++i) {
      a.part[i] = part[i];
      a.pc[i] = pc[i];
      a.poff[i] = poff[i];
    }
    a.nparts = nparts;
    a.cin = cin;
    a.w = w;
    a.bias = bias;
    a.res = res;
    a.ln_g = ln_g;
    a.ln_b = ln_b;
    a.y = y;
    a.N = (int)N;
    a.H = (int)H;
    a.W = (int)W;
    a.cout = (int)cout;
    a.nchunk = (cin + KC - 1) / KC;
    a.relu_in = (int)relu_in;
    a.act = (int)act;
    a.eps = eps;
    if (n_tile != (cout <= 8 ? 8 : cout <= 32 ? 32 : 128)) return (int)cudaErrorInvalidValue;
    return dtype == 0 ? dispatch_mma<float>(a, (int)k, s) : dispatch_mma<bf16>(a, (int)k, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  WArgs a = {};
  for (int i = 0; i < nparts; ++i) {
    a.part[i] = static_cast<const bf16*>(part[i]);
    a.pc[i] = pc[i];
    a.poff[i] = poff[i];
    const uintptr_t b = reinterpret_cast<uintptr_t>(part[i]);
    // a half's offset in its part, c0 - poff, must keep the loads aligned too
    a.vec[i] = pc[i] % 8 == 0 && poff[i] % 8 == 0 && b % 16 == 0 ? 8
               : pc[i] % 2 == 0 && poff[i] % 2 == 0 && b % 4 == 0 ? 2
                                                                  : 1;
  }
  a.nparts = nparts;
  a.cin = cin;
  a.nk = (cin + 15) / 16;
  a.relu_in = (int)relu_in;
  a.act = (int)act;
  a.cout = (int)cout;
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const bf16*>(bias);
  a.res = static_cast<const bf16*>(res);
  a.ln_g = static_cast<const bf16*>(ln_g);
  a.ln_b = static_cast<const bf16*>(ln_b);
  a.y = static_cast<bf16*>(y);
  a.H = (int)H;
  a.W = (int)W;
  a.stages = (int)stages;
  a.tiles = N;  // times the tiles of an image, in launch_wgmma
  a.eps = eps;
  return dispatch_wgmma(a, (int)k, (int)n_tile, (int)runs, (int)producers, s);
}
