// K9: the fusion head's full-resolution, low-channel convolutions (the tail)
//   y = act(LN(conv_k(relu?(cat(parts))) + bias + residual))
// on NHWC maps: up to 4 input parts of one spatial size, each with its own
// channel count, read in place (no concatenation in device memory); a 3x3
// SAME or 1x1 convolution with Cout <= 128; then, each optional and in this
// order, a per-channel bias, a residual add (N, H, W, Cout), a LayerNorm over
// the Cout channels of each pixel (eps, the fast variance
// max(E[x^2] - mean^2, 0), float32 statistics) and an activation (ReLU, or
// GELU: tanh form for bfloat16, erf form for float32).
//
// Replaces patchrefinerv2_tpu/ops/s2d.py:114 `s2d_same_kernel` (with
// `split`, over the parts of a concatenation), :139 `s2d_down_kernel` /
// :190 `conv_s2d_down` (the segment's entry conv), :156 `s2d_1x1_kernel`
// and :198 `layer_norm_s2d`: the TPU ran the tail in space-to-depth form so
// that 32 channels fill its 128-wide lanes. That re-layout is exact, so the
// function is a plain convolution with fused epilogues; on Hopper C = 32 is
// no problem for the tensor cores, and what costs is cuDNN's padding of odd
// channel counts (33/34, 98, 1 output) and the concatenations.
//
// Bound: bytes at the flagship's widths (Cin <= 98, Cout <= 32: each input
// read once and the output written once, ~0.06-0.3 ms a 16-patch chunk);
// operations at DA2's 128-wide sites (2 * P * 9 * Cin * Cout, ~1.9 TFLOP for
// the 256 -> 128 fusion conv). The design: a persistent block walks over
// tiles of output pixels of one image (16 x 16, or 8 x 16 at Cout_pad 128),
// each with all of its output channels, so the LN epilogue needs no second
// pass. For each chunk of 32 input channels it stages the tile's halo of
// every part in shared memory (zeros outside the image and past the last
// channel, so ragged 1- and 98-channel parts are padded in shared memory
// only, and a neighbouring image is never read) and the chunk's weights as
// [tap][channel][Cout_pad]; when all chunks of weights fit beside the halo
// they are staged once for the whole block. The staging is cp.async, every
// copy of a chunk in flight at once, each part's rows with the widest copy
// they allow (16 bytes, 4 for even widths, else a plain 2-byte load).
// bfloat16 runs the products on the tensor cores (ldmatrix + mma.sync
// m16n8k16, float32 accumulators; one m16 fragment is 16 pixels of a tile
// row, so a tap is an offset of the fragment's row addresses; the ReLU
// prologue is applied to the fragments, and k-steps that only hold padding
// are skipped); float32 runs CUDA-core FMAs, since the tensor cores would
// round float32 inputs to TF32. The accumulators go through a float32 tile
// in shared memory, and the epilogue rounds once, at the store. Staging is
// not overlapped with the products inside a block (a two-stage ring
// measured slower: it halved the blocks per SM); wgmma/TMA and a register
// epilogue are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TW = 16;                  // output tile columns (one m16 fragment)
constexpr int NWARPS = 8, NT = NWARPS * 32;
constexpr int KC = 32;                  // input channels per chunk
constexpr int MAXP = 4;                 // input parts
constexpr unsigned RESIDENT_BYTES = 113 * 1024;  // all weights staged once if they fit (2 blocks/SM)

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// global -> shared without a register round trip; zero-filled when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

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
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// Per-warp share of the TM x CP output tile: WM m16 fragments (tile rows) by
// WN n8 fragments; WARPS_M warps along the rows. Two rows a warp reuse each
// B fragment twice.
template <int CP> struct Split;
template <> struct Split<8> { static constexpr int WM = 2, WN = 1, WARPS_M = 8; };
template <> struct Split<32> { static constexpr int WM = 2, WN = 4, WARPS_M = 8; };
template <> struct Split<128> { static constexpr int WM = 2, WN = 8, WARPS_M = 4; };

template <typename T, int K, int CP> struct Core;

// bfloat16: tensor cores. A (16 pixels x 16 channels) rows are halo pixels;
// B (16 channels x 8 outputs) from the [tap][channel][output] weights with
// ldmatrix.trans. kmax: the chunk's channels that hold data, rounded up to
// 16 (the k-steps past it only hold zeros and are skipped).
template <int K, int CP> struct Core<bf16, K, CP> {
  static constexpr int WM = Split<CP>::WM, WN = Split<CP>::WN, WARPS_M = Split<CP>::WARPS_M;
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
        if constexpr (WN == 1) {
          ldsm_x2_t(bfr[0], wrow + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDW + wn * 8);
        } else {
#pragma unroll
          for (int p = 0; p < WN / 2; ++p) {
            const int q = lane >> 3, n0 = (wn * WN + 2 * p) * 8;
            uint32_t t[4];
            ldsm_x4_t(t, wrow + ((q & 1) * 8 + (lane & 7)) * LDW + n0 + (q >> 1) * 8);
            bfr[2 * p][0] = t[0];
            bfr[2 * p][1] = t[1];
            bfr[2 * p + 1][0] = t[2];
            bfr[2 * p + 1][1] = t[3];
          }
        }
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
__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

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

constexpr unsigned up128(size_t b) { return (unsigned)((b + 127) / 128 * 128); }

template <typename T, int K, int CP>
int launch(Args a, cudaStream_t stream) {
  using C = Cfg<T, CP>;
  constexpr int HP = (C::TH + K - 1) * (TW + K - 1);
  constexpr unsigned wb = up128((size_t)K * K * KC * C::LDW * sizeof(T));
  constexpr unsigned hb = up128((size_t)HP * C::LDA * sizeof(T));
  constexpr unsigned ob = up128((size_t)C::TM * C::LDO * sizeof(float));
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

template <typename T>
int dispatch(const Args& a, int k, cudaStream_t s) {
  const int cp = a.cout <= 8 ? 8 : (a.cout <= 32 ? 32 : 128);
  if (k == 3) {
    if (cp == 8) return launch<T, 3, 8>(a, s);
    if (cp == 32) return launch<T, 3, 32>(a, s);
    return launch<T, 3, 128>(a, s);
  }
  if (cp == 8) return launch<T, 1, 8>(a, s);
  if (cp == 32) return launch<T, 1, 32>(a, s);
  return launch<T, 1, 128>(a, s);
}

}  // namespace

// p0..p3: the NHWC parts (c_i channels each, c_i = 0 for an absent part),
// contiguous; w: the weights formatted as [nchunk][k * k][32][Cout_pad]
// (Cout_pad = 8, 32 or 128 for Cout <= 8, 32, 128), zero-padded; bias,
// res, ln_g / ln_b: null when absent; y: (N, H, W, Cout) contiguous.
// act: 0 none, 1 ReLU, 2 GELU. dtype: 0 float32, 1 bfloat16.
extern "C" int prv2_tail_conv(const void* p0, const void* p1, const void* p2, const void* p3,
                              const void* w, const void* bias, const void* res, const void* ln_g,
                              const void* ln_b, void* y, long long N, long long H, long long W,
                              long long c0, long long c1, long long c2, long long c3,
                              long long cout, long long k, long long relu_in, long long act,
                              float eps, int dtype, void* stream) {
  if (N * H * W == 0) return 0;
  if (cout < 1 || cout > 128 || (k != 1 && k != 3) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  const void* ps[MAXP] = {p0, p1, p2, p3};
  const long long cs[MAXP] = {c0, c1, c2, c3};
  for (int i = 0; i < MAXP; ++i) {
    if (cs[i] <= 0) break;
    a.part[a.nparts] = ps[i];
    a.pc[a.nparts] = (int)cs[i];
    a.poff[a.nparts] = a.cin;
    a.cin += (int)cs[i];
    ++a.nparts;
  }
  if (a.nparts == 0) return (int)cudaErrorInvalidValue;
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
  a.nchunk = (a.cin + KC - 1) / KC;
  a.relu_in = (int)relu_in;
  a.act = (int)act;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, (int)k, s);
  if (dtype == 1) return dispatch<bf16>(a, (int)k, s);
  return (int)cudaErrorInvalidValue;
}
