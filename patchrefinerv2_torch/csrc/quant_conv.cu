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
// same trade is int8 mma on the tensor cores.
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
// read and written once (0.18-0.96 ms a chunk in bfloat16). The design:
//
// 1. `quantize_kernel`: a thread keeps a group of 8 channels (its scales in
//    registers) and walks the pixels, reading the parts in place (16-byte
//    loads where a part's rows allow; no concatenation in device memory),
//    applies the ReLU, divides
//    by the channel's scale with a true division (__fdiv_rn, never a
//    reciprocal), rounds half to even (__float2int_rn), clips to +-127 and
//    writes int8 NHWC with the channels zero-padded to a multiple of 32, so
//    every row of the product below is whole 16-byte copies.
// 2. `qconv_kernel`: an implicit GEMM. A block owns 16 x 16 output pixels of
//    one image by 128 output channels (32 where Cout <= 32, the flagship
//    head's width, so that no product is wasted on padding; with a single
//    chunk of input channels the block takes one stage of shared memory, so
//    that more blocks share an SM); for each chunk of 32 input channels it
//    stages the tile's int8 halo (zeros outside the image) and the chunk's
//    int8 weights [tap][128][32] in shared memory with cp.async (rows padded
//    to 48 bytes, so ldmatrix is free of bank conflicts), in two stages: the
//    next chunk is in flight while one is multiplied. 8 warps (4 along
//    the pixels by 2 along the channels, 64 x 64 each) run
//    mma.sync.m16n8k32 s8.s8 -> s32 over the taps: one m16 fragment is 16
//    pixels of a tile row, so a tap is an offset of the fragment's row
//    addresses. The 256-pixel tile halves the weight bytes each product
//    re-reads from L2 against a 128-pixel one (the traffic that bounded the
//    first version). The int32 sums are exact. The epilogue works on the
//    accumulator registers: __int2float_rn, __fmul_rn by the channel's
//    scale, __fadd_rn of the bias (explicit _rn so nvcc cannot contract
//    them into an FMA), one rounding to the output dtype, and with a
//    residual its add and a second rounding, as the reference's
//    `quant_conv(...) + x` rounds.
//
// 3. Phased sites: grid.z is the output phase (di, dj), and a block owns a
//    16 x 16 sub-lattice of one phase at stride 2 (output pixels
//    (y0 + 2 ty + di, x0 + 2 tx + dj)), so its weights and dequant scales are
//    uniform. Its halo is the dense 33 x 33 window the sub-lattice's taps
//    read; ldmatrix takes one row address a lane, so a fragment's 16 pixels
//    at stride 2 cost nothing extra. Nothing is re-laid out to
//    space-to-depth and no expanded kernel is served.
// 4. Dynamic mode: `absmax_kernel` reads the parts in place (the ReLU
//    applied) and folds each block's max into one float32 on the device with
//    an integer atomicMax on its bits (every value is >= 0), then
//    `scales_kernel` forms sx = max(amax, 1e-8) * f32(1/127) and
//    scale[o] = sx * sw[o] there, as the reference computes them under jit.
//    No value goes back to the host. The quantize and the product follow
//    unchanged.
//
// The quantize pass writes and the product reads an int8 copy of the input.
// wgmma with TMA and the quantize fused into the staging are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TW = 16, TH = 16;       // output tile: 16 rows of 16 pixels
constexpr int BN_PAD = 128;           // the weights' output channels are padded to this
constexpr int KC = 32;                // input channels (bytes) a chunk
constexpr int LDS = 48;               // shared row stride, bytes
constexpr int NT = 256;               // 8 warps
constexpr int MAXP = 4;

// A block's output channels (BN) and its 8 warps: WARPS_M along the tile's
// rows (WM m16 fragments, one tile row each) by 8 / WARPS_M along the
// channels (WN n8 blocks each); MINB blocks an SM at least
template <int BN_, int WARPS_M_, int WM_, int WN_, int MINB_> struct Tile {
  static constexpr int BN = BN_, WARPS_M = WARPS_M_, WM = WM_, WN = WN_, MINB = MINB_;
  static_assert(WARPS_M * WM == TH && NT / 32 / WARPS_M * WN * 8 == BN && WN % 2 == 0, "tile");
};
using Wide = Tile<128, 4, 4, 8, 1>;   // 128 output channels a block
// 32, the flagship head's width: a quarter of the products and of the
// staged weights of a 128-channel block, which wasted three quarters there
using Narrow = Tile<32, 8, 2, 4, 2>;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// every group but the STAGES - 1 newest has landed
template <int N> __device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct QArgs {
  const void* part[MAXP];
  int pc[MAXP];    // channels of each part
  int poff[MAXP];  // first channel of each part in the concatenation
  int vec[MAXP];   // channels a load of the part's rows takes: 8 (16 bytes for bfloat16), 2 or 1
  int nparts, cin, cin_pad, relu_in, phased, H, W;
  const float* sx;  // (cin,), or (4, cin) by pixel phase when phased
  int8_t* xq;       // (P, cin_pad)
  int64_t P;
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

// A block of 32 x 8 threads: threadIdx.x picks groups of 8 channels (its
// part, offset and scales found once), threadIdx.y and the grid stride walk
// the pixels. A pixel with fewer than 32 groups (cin_pad < 256) spreads a
// row of 32 lanes over 32 / groups pixels at once, so that the lanes of
// the 32- and 64-channel head sites are not idle. A group that lies in one
// part takes the widest loads the part's rows allow (8 channels, 2, or 1 at
// a time).
template <typename T, bool PHASED>
__global__ void __launch_bounds__(256) quantize_kernel(const QArgs a) {
  const int groups = a.cin_pad / 8, gw = groups < 32 ? groups : 32, sub = 32 / gw;
  const int lg = threadIdx.x % gw, lp = threadIdx.x / gw;
  if (lp >= sub) return;  // lanes left over where gw does not divide 32
  for (int c0 = lg * 8; c0 < a.cin_pad; c0 += gw * 8) {
    const Loc<T> g = locate<T>(a, c0);
    const bool in_one = g.off + 8 <= g.pc;  // the group lies in one part
    constexpr int ROWS = PHASED ? 4 : 1;
    float sxr[ROWS][8];  // the scale rows of the pixel phases
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) sxr[r][j] = c0 + j < a.cin ? a.sx[r * a.cin + c0 + j] : 1.f;
    for (int64_t p = ((int64_t)blockIdx.x * 8 + threadIdx.y) * sub + lp; p < a.P;
         p += (int64_t)gridDim.x * 8 * sub) {
      float sx[8];
      if constexpr (PHASED) {
        // the pixel's phase 2 * (h % 2) + (w % 2), p = (n * H + h) * W + w
        const int ph = (int)((p / a.W) % a.H & 1) * 2 + (int)(p % a.W & 1);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sx[j] = ph == 0 ? sxr[0][j] : ph == 1 ? sxr[1][j] : ph == 2 ? sxr[2][j] : sxr[3][j];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) sx[j] = sxr[0][j];
      }
      float x[8];
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
      uint32_t packed[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = a.relu_in ? fmaxf(x[j], 0.f) : x[j];
        const int r = min(max(__float2int_rn(__fdiv_rn(v, sx[j])), -127), 127);
        packed[j >> 2] |= (uint32_t)(r & 0xff) << (8 * (j & 3));
      }
      *reinterpret_cast<uint2*>(a.xq + p * a.cin_pad + c0) = make_uint2(packed[0], packed[1]);
    }
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
struct CArgs {
  const int8_t* xq;    // (N, H, W, cin_pad)
  const int8_t* w;     // [phase][nchunk][K * K][cout_pad][32], one phase unless phased
  const float* scale;  // [phase][cout]
  const void* bias;    // (cout,) or null
  const void* res;     // (N, H, W, cout) or null
  void* y;             // (N, H, W, cout)
  int N, H, W, cin_pad, cout, cout_pad, nchunk, relu_out;
};

constexpr unsigned up128(unsigned b) { return (b + 127) / 128 * 128; }
// one stage: the halo of a chunk, then its weights; STAGES of them
constexpr int STAGES = 2;  // three measured slower (one block an SM either way)
// S: the stride of a block's output pixels (2 at a phased site: one phase's
// sub-lattice); the halo is the dense window its taps read
template <int K, int S, int BN> struct Smem {
  static constexpr int HW = S * (TW - 1) + K, HP = (S * (TH - 1) + K) * HW;
  static constexpr unsigned halo = up128(HP * LDS), wts = up128(K * K * BN * LDS);
  static constexpr unsigned stage = halo + wts, bytes = STAGES * stage;
};

// cp.async of chunk `ch` (the tile's int8 halo, zeros outside the image, and
// the chunk's weights for the block's BN output channels) into one stage
// (hy, hx): the image pixel of the halo's first row and column; w: the
// weights of the block's phase
template <int K, int S, int BN>
__device__ __forceinline__ void stage_chunk(const CArgs& a, const int8_t* w, unsigned char* st, int ch,
                                            int n, int hy, int hx, int nb) {
  constexpr int HW = Smem<K, S, BN>::HW, HP = Smem<K, S, BN>::HP, TAPS = K * K;
  unsigned char* Hs = st;
  unsigned char* Ws = st + Smem<K, S, BN>::halo;
  for (int e = threadIdx.x; e < HP * 2; e += NT) {
    const int hp = e >> 1, half = e & 1;
    const int iy = hy + hp / HW, ix = hx + hp % HW;
    const bool in = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
    const int8_t* src =
        in ? a.xq + (((int64_t)n * a.H + iy) * a.W + ix) * a.cin_pad + ch * KC + half * 16 : a.xq;
    cp16(Hs + hp * LDS + half * 16, src, in);
  }
  for (int e = threadIdx.x; e < TAPS * BN * 2; e += NT) {
    const int row = e >> 1, half = e & 1, tap = row / BN, nn = row - tap * BN;
    const int8_t* src = w + (((int64_t)ch * TAPS + tap) * a.cout_pad + nb + nn) * KC + half * 16;
    cp16(Ws + row * LDS + half * 16, src, true);
  }
}

// RELU: the ReLU after the rounding, a template argument: a test of
// a.relu_out in the epilogue slowed the product at every site
template <typename T, int K, int S, class TL, bool RELU>
__global__ void __launch_bounds__(NT, TL::MINB) qconv_kernel(const CArgs a) {
  constexpr int BN = TL::BN, WARPS_M = TL::WARPS_M, WM = TL::WM, WN = TL::WN;
  constexpr int HW = Smem<K, S, BN>::HW, TAPS = K * K, STAGE = Smem<K, S, BN>::stage;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles_x = (a.W + S * TW - 1) / (S * TW), tiles_y = (a.H + S * TH - 1) / (S * TH);
  const int64_t t = blockIdx.x;
  const int n = (int)(t / ((int64_t)tiles_x * tiles_y));
  const int r = (int)(t - (int64_t)n * tiles_x * tiles_y);
  // the block's output pixels: (y0 + S * ty + di, x0 + S * tx + dj), phase
  // (di, dj) = blockIdx.z, and the phase's weights and dequant scales
  int y0 = (r / tiles_x) * TH * S, x0 = (r % tiles_x) * TW * S;
  const int8_t* w = a.w;
  const float* scale = a.scale;
  if constexpr (S == 2) {
    y0 += (int)blockIdx.z >> 1;
    x0 += (int)blockIdx.z & 1;
    w += (int64_t)blockIdx.z * a.nchunk * TAPS * a.cout_pad * KC;
    scale += (int64_t)blockIdx.z * a.cout;
  }
  const int hy = y0 - K / 2, hx = x0 - K / 2;
  const int nb = blockIdx.y * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;

  int acc[WM][WN][4];
#pragma unroll
  for (int mi = 0; mi < WM; ++mi)
#pragma unroll
    for (int nj = 0; nj < WN; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;

  // a ring of STAGES: chunks ch + 1 .. ch + STAGES - 1 are in flight while
  // chunk ch is multiplied
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < a.nchunk) stage_chunk<K, S, BN>(a, w, smem + c * STAGE, c, n, hy, hx, nb);
    cp_commit();
  }
  for (int ch = 0; ch < a.nchunk; ++ch) {
    const int next = ch + STAGES - 1;
    if (next < a.nchunk) stage_chunk<K, S, BN>(a, w, smem + (next % STAGES) * STAGE, next, n, hy, hx, nb);
    cp_commit();
    cp_wait_group<STAGES - 1>();  // chunk ch has landed
    __syncthreads();
    const unsigned char* Hs = smem + (ch % STAGES) * STAGE;
    const unsigned char* Ws = Hs + Smem<K, S, BN>::halo;
#pragma unroll 1
    for (int tap = 0; tap < TAPS; ++tap) {
      const int du = tap / K, dv = tap % K;
      uint32_t af[WM][4];
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) {
        const int ty = wm * WM + mi;
        ldsm_x4(af[mi], Hs + ((S * ty + du) * HW + S * (lane & 15) + dv) * LDS + (lane >> 4) * 16);
      }
#pragma unroll
      for (int p = 0; p < WN / 2; ++p) {
        // matrices: (n0..n0+7, k 0-15), (n0.., k 16-31), (n0+8.., k 0-15), (n0+8.., k 16-31)
        const int q = lane >> 3, row = wn * (WN * 8) + p * 16 + (q >> 1) * 8 + (lane & 7);
        uint32_t b[4];
        ldsm_x4(b, Ws + (tap * BN + row) * LDS + (q & 1) * 16);
#pragma unroll
        for (int mi = 0; mi < WM; ++mi) {
          mma_s8(acc[mi][2 * p], af[mi], b[0], b[1]);
          mma_s8(acc[mi][2 * p + 1], af[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage is read: a later iteration refills it
  }

  // epilogue from the accumulators: rows g and g + 8 of each m16 fragment
  // are pixels g and g + 8 of tile row ty; columns 2 * tig, 2 * tig + 1.
  // The ReLU after the rounding (`relu(quant_conv(...))`) keeps the value
  // exact: it only clears the negative ones
  const T* bias = static_cast<const T*>(a.bias);
  const T* res = static_cast<const T*>(a.res);
  T* y = static_cast<T*>(a.y);
  const int g = lane >> 2, tig = lane & 3;
  const bool pairs = (a.cout & 1) == 0;  // (c, c + 1) both valid and 2-element aligned
#pragma unroll
  for (int mi = 0; mi < WM; ++mi) {
    const int iy = y0 + S * (wm * WM + mi);
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const int ix = x0 + S * (g + hlf * 8);
      if (iy >= a.H || ix >= a.W) continue;
      const int64_t pix = ((int64_t)n * a.H + iy) * a.W + ix;
#pragma unroll
      for (int nj = 0; nj < WN; ++nj) {
        const int c = nb + wn * (WN * 8) + nj * 8 + 2 * tig;
        if (c >= a.cout) continue;
        T o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e >= a.cout) break;
          float v = __fmul_rn(__int2float_rn(acc[mi][nj][hlf * 2 + e]), scale[c + e]);
          if (bias != nullptr) v = __fadd_rn(v, to_f(bias[c + e]));
          o[e] = from_f<T>(v);
          if (res != nullptr) o[e] = from_f<T>(__fadd_rn(to_f(o[e]), to_f(res[pix * a.cout + c + e])));
          if constexpr (RELU) o[e] = from_f<T>(fmaxf(to_f(o[e]), 0.f));
        }
        T* dst = y + pix * a.cout + c;
        if (pairs) {
          if constexpr (sizeof(T) == 2) {
            __nv_bfloat162 v2;
            v2.x = o[0];
            v2.y = o[1];
            *reinterpret_cast<__nv_bfloat162*>(dst) = v2;
          } else {
            *reinterpret_cast<float2*>(dst) = make_float2(to_f(o[0]), to_f(o[1]));
          }
        } else {
          dst[0] = o[0];
          if (c + 1 < a.cout) dst[1] = o[1];
        }
      }
    }
  }
}

template <typename T, int K, int S, class TL, bool RELU>
int launch_conv(const CArgs& c, cudaStream_t stream) {
  using SM = Smem<K, S, TL::BN>;
  static_assert(SM::bytes <= 232448, "shared memory of one block");
  auto kern = qconv_kernel<T, K, S, TL, RELU>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SM::bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (int64_t)c.N * ((c.H + S * TH - 1) / (S * TH)) * ((c.W + S * TW - 1) / (S * TW));
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // a single chunk (32 input channels or fewer) needs one stage: the smaller
  // block lets more blocks share an SM, where nothing else hides the loads
  const unsigned bytes = (c.nchunk < STAGES ? c.nchunk : STAGES) * SM::stage;
  dim3 grid((unsigned)tiles, (unsigned)((c.cout + TL::BN - 1) / TL::BN), S == 2 ? 4u : 1u);
  kern<<<grid, NT, bytes, stream>>>(c);
  return (int)cudaGetLastError();
}

// the ReLU after the rounding is built for the plain 3x3 (the `qsd` site)
template <typename T, class TL>
int launch_conv(const CArgs& c, int k, int phased, cudaStream_t stream) {
  if (phased) return launch_conv<T, 3, 2, TL, false>(c, stream);
  if (k == 1) return launch_conv<T, 1, 1, TL, false>(c, stream);
  return c.relu_out ? launch_conv<T, 3, 1, TL, true>(c, stream) : launch_conv<T, 3, 1, TL, false>(c, stream);
}

// sw, amax: null, or the dynamic mode (sw the weights' scales, amax one
// float32 of scratch; q.sx and c.scale are then written here)
template <typename T>
int run(const QArgs& q, const CArgs& c, int k, const float* sw, float* amax, cudaStream_t stream) {
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
  const int groups = q.cin_pad / 8, sub = 32 / (groups < 32 ? groups : 32);
  const int64_t want = (q.P + 8 * sub - 1) / (8 * sub), cap = (int64_t)sms * 8;  // 8 blocks an SM, grid-stride beyond
  const dim3 qgrid((unsigned)(want < cap ? want : cap)), qblock(32, 8);
  if (q.phased)
    quantize_kernel<T, true><<<qgrid, qblock, 0, stream>>>(q);
  else
    quantize_kernel<T, false><<<qgrid, qblock, 0, stream>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return c.cout <= Narrow::BN ? launch_conv<T, Narrow>(c, k, q.phased, stream)
                              : launch_conv<T, Wide>(c, k, q.phased, stream);
}

}  // namespace

// p0..p3: the NHWC parts (c_i channels each, c_i = 0 for an absent part),
// contiguous; sx: float32 (sum c_i,) activation scales, (4, sum c_i) by
// pixel phase when phased; w: the int8 weights formatted as
// [phase][ceil(cin / 32)][k * k][cout_pad][32] (cout_pad = cout rounded up
// to 128, one phase unless phased), zero-padded; scale: float32 (cout,),
// (4, cout) when phased; bias, res: null when absent, else in the parts'
// dtype; xq: int8 scratch (N, H, W, cin rounded up to 32); y: (N, H, W,
// cout). phased: k must be 3. relu_out: k 3, not phased. Dynamic mode: sw,
// the weights' float32 (cout,)
// scales, and amax, one float32 of scratch; sx and scale are then scratch
// that the call fills (null sw and amax otherwise). dtype: 0 float32, 1
// bfloat16.
extern "C" int prv2_quant_conv(const void* p0, const void* p1, const void* p2, const void* p3,
                               const void* sx, const void* w, const void* scale, const void* bias,
                               const void* res, void* xq, void* y, const void* sw, void* amax,
                               long long N, long long H, long long W, long long c0, long long c1,
                               long long c2, long long c3, long long cout, long long k,
                               long long relu_in, long long relu_out, long long phased, int dtype,
                               void* stream) {
  if (N * H * W == 0) return 0;
  if (cout < 1 || (k != 1 && k != 3) || (phased && (k != 3 || amax != nullptr)) ||
      (relu_out && (phased || k != 3)) || (sw == nullptr) != (amax == nullptr))
    return (int)cudaErrorInvalidValue;
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
  q.sx = static_cast<const float*>(sx);
  q.xq = static_cast<int8_t*>(xq);
  q.P = N * H * W;
  CArgs c = {};
  c.xq = static_cast<const int8_t*>(xq);
  c.w = static_cast<const int8_t*>(w);
  c.scale = static_cast<const float*>(scale);
  c.bias = bias;
  c.res = res;
  c.y = y;
  c.N = (int)N;
  c.H = (int)H;
  c.W = (int)W;
  c.cin_pad = q.cin_pad;
  c.cout = (int)cout;
  c.cout_pad = (int)((cout + BN_PAD - 1) / BN_PAD * BN_PAD);
  c.nchunk = q.cin_pad / KC;
  c.relu_out = (int)relu_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* swf = static_cast<const float*>(sw);
  float* am = static_cast<float*>(amax);
  if (dtype == 0) return run<float>(q, c, (int)k, swf, am, s);
  if (dtype == 1) return run<bf16>(q, c, (int)k, swf, am, s);
  return (int)cudaErrorInvalidValue;
}
