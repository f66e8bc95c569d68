// K10: the int8 SAME convolution with static activation scales
//   y = f32(conv_int32(q(relu?(cat(parts))), kq)) * scale + bias (+ residual)
// on NHWC maps, with q(x) = clip(round_half_even(x / sx[c]), -127, 127).
//
// Replaces patchrefinerv2_tpu/ops/quant.py:130 `quant_conv_same` (one
// activation scale: the wrapper repeats it per channel and passes
// scale = sx * sw), :154 `quant_conv_same_perchan` (a scale per input
// channel, folded into the weights: scale = swc) and the serving branch of
// :218 `conv_dispatch`. On the TPU the int8 products ran on the MXU at twice
// its bf16 rate; on Hopper the same trade is int8 mma on the tensor cores.
//
// Bound: operations at every site the main paths select (a 3x3 over 194 to
// 512 input channels at 96x128 to 384x512 pixels: 2 * P * 9 * Cin * Cout
// int8 operations against 1979 TOP/s, 0.07-0.94 ms a 16-patch chunk). The
// design, two launches:
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
//    one image by 128 output channels; for each chunk of 32 input channels it
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
// The quantize pass writes and the product reads an int8 copy of the input.
// wgmma with TMA, and the quantize fused into the staging, are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TW = 16, TH = 16;       // output tile: 16 rows of 16 pixels
constexpr int BN = 128;               // output channels a block
constexpr int KC = 32;                // input channels (bytes) a chunk
constexpr int LDS = 48;               // shared row stride, bytes
constexpr int NT = 256;               // 8 warps
constexpr int WARPS_M = 4, WM = 4, WN = 8;  // a warp: 4 m16 rows x 8 n8 blocks
constexpr int MAXP = 4;

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
  int nparts, cin, cin_pad, relu_in;
  const float* sx;  // (cin,)
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
// the pixels. A group that lies in one part takes the widest loads the
// part's rows allow (8 channels, 2, or 1 at a time).
template <typename T>
__global__ void __launch_bounds__(256) quantize_kernel(const QArgs a) {
  for (int c0 = threadIdx.x * 8; c0 < a.cin_pad; c0 += 32 * 8) {
    const Loc<T> g = locate<T>(a, c0);
    const bool in_one = g.off + 8 <= g.pc;  // the group lies in one part
    float sx[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) sx[j] = c0 + j < a.cin ? a.sx[c0 + j] : 1.f;
    for (int64_t p = (int64_t)blockIdx.x * 8 + threadIdx.y; p < a.P; p += (int64_t)gridDim.x * 8) {
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

// ---------------------------------------------------------------- product
struct CArgs {
  const int8_t* xq;    // (N, H, W, cin_pad)
  const int8_t* w;     // [nchunk][K * K][cout_pad][32]
  const float* scale;  // (cout,)
  const void* bias;    // (cout,) or null
  const void* res;     // (N, H, W, cout) or null
  void* y;             // (N, H, W, cout)
  int N, H, W, cin_pad, cout, cout_pad, nchunk;
};

constexpr unsigned up128(unsigned b) { return (b + 127) / 128 * 128; }
// one stage: the halo of a chunk, then its weights; STAGES of them
constexpr int STAGES = 2;  // three measured slower (one block an SM either way)
template <int K> struct Smem {
  static constexpr int HW = TW + K - 1, HP = (TH + K - 1) * HW;
  static constexpr unsigned halo = up128(HP * LDS), wts = up128(K * K * BN * LDS);
  static constexpr unsigned stage = halo + wts, bytes = STAGES * stage;
};

// cp.async of chunk `ch` (the tile's int8 halo, zeros outside the image, and
// the chunk's weights for the block's 128 output channels) into one stage
template <int K>
__device__ __forceinline__ void stage_chunk(const CArgs& a, unsigned char* st, int ch, int n, int y0,
                                            int x0, int nb) {
  constexpr int R = K / 2, HW = Smem<K>::HW, HP = Smem<K>::HP, TAPS = K * K;
  unsigned char* Hs = st;
  unsigned char* Ws = st + Smem<K>::halo;
  for (int e = threadIdx.x; e < HP * 2; e += NT) {
    const int hp = e >> 1, half = e & 1;
    const int iy = y0 + hp / HW - R, ix = x0 + hp % HW - R;
    const bool in = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
    const int8_t* src =
        in ? a.xq + (((int64_t)n * a.H + iy) * a.W + ix) * a.cin_pad + ch * KC + half * 16 : a.xq;
    cp16(Hs + hp * LDS + half * 16, src, in);
  }
  for (int e = threadIdx.x; e < TAPS * BN * 2; e += NT) {
    const int row = e >> 1, half = e & 1, tap = row / BN, nn = row - tap * BN;
    const int8_t* src = a.w + (((int64_t)ch * TAPS + tap) * a.cout_pad + nb + nn) * KC + half * 16;
    cp16(Ws + row * LDS + half * 16, src, true);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(NT, 1) qconv_kernel(const CArgs a) {
  constexpr int HW = Smem<K>::HW, TAPS = K * K;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles_x = (a.W + TW - 1) / TW, tiles_y = (a.H + TH - 1) / TH;
  const int64_t t = blockIdx.x;
  const int n = (int)(t / ((int64_t)tiles_x * tiles_y));
  const int r = (int)(t - (int64_t)n * tiles_x * tiles_y);
  const int y0 = (r / tiles_x) * TH, x0 = (r % tiles_x) * TW;
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
    if (c < a.nchunk) stage_chunk<K>(a, smem + c * Smem<K>::stage, c, n, y0, x0, nb);
    cp_commit();
  }
  for (int ch = 0; ch < a.nchunk; ++ch) {
    const int next = ch + STAGES - 1;
    if (next < a.nchunk) stage_chunk<K>(a, smem + (next % STAGES) * Smem<K>::stage, next, n, y0, x0, nb);
    cp_commit();
    cp_wait_group<STAGES - 1>();  // chunk ch has landed
    __syncthreads();
    const unsigned char* Hs = smem + (ch % STAGES) * Smem<K>::stage;
    const unsigned char* Ws = Hs + Smem<K>::halo;
#pragma unroll 1
    for (int tap = 0; tap < TAPS; ++tap) {
      const int du = tap / K, dv = tap % K;
      uint32_t af[WM][4];
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) {
        const int ty = wm * WM + mi;
        ldsm_x4(af[mi], Hs + ((ty + du) * HW + dv + (lane & 15)) * LDS + (lane >> 4) * 16);
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
  // are pixels g and g + 8 of tile row ty; columns 2 * tig, 2 * tig + 1
  const T* bias = static_cast<const T*>(a.bias);
  const T* res = static_cast<const T*>(a.res);
  T* y = static_cast<T*>(a.y);
  const int g = lane >> 2, tig = lane & 3;
  const bool pairs = (a.cout & 1) == 0;  // (c, c + 1) both valid and 2-element aligned
#pragma unroll
  for (int mi = 0; mi < WM; ++mi) {
    const int iy = y0 + wm * WM + mi;
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const int ix = x0 + g + hlf * 8;
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
          float v = __fmul_rn(__int2float_rn(acc[mi][nj][hlf * 2 + e]), a.scale[c + e]);
          if (bias != nullptr) v = __fadd_rn(v, to_f(bias[c + e]));
          o[e] = from_f<T>(v);
          if (res != nullptr) o[e] = from_f<T>(__fadd_rn(to_f(o[e]), to_f(res[pix * a.cout + c + e])));
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

template <typename T, int K>
int launch_conv(const CArgs& c, cudaStream_t stream) {
  constexpr unsigned bytes = Smem<K>::bytes;
  auto kern = qconv_kernel<T, K>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (int64_t)c.N * ((c.H + TH - 1) / TH) * ((c.W + TW - 1) / TW);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)(c.cout_pad / BN));
  kern<<<grid, NT, bytes, stream>>>(c);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const QArgs& q, const CArgs& c, int k, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (q.P + 7) / 8, cap = (int64_t)sms * 8;  // 8 blocks an SM, grid-stride beyond
  quantize_kernel<T><<<(unsigned)(want < cap ? want : cap), dim3(32, 8), 0, stream>>>(q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return k == 3 ? launch_conv<T, 3>(c, stream) : launch_conv<T, 1>(c, stream);
}

}  // namespace

// p0..p3: the NHWC parts (c_i channels each, c_i = 0 for an absent part),
// contiguous; sx: float32 (sum c_i,) activation scales; w: the int8 weights
// formatted as [ceil(cin / 32)][k * k][cout_pad][32] (cout_pad = cout rounded
// up to 128), zero-padded; scale: float32 (cout,); bias, res: null when
// absent, else in the parts' dtype; xq: int8 scratch (N, H, W, cin rounded
// up to 32); y: (N, H, W, cout). dtype: 0 float32, 1 bfloat16.
extern "C" int prv2_quant_conv(const void* p0, const void* p1, const void* p2, const void* p3,
                               const void* sx, const void* w, const void* scale, const void* bias,
                               const void* res, void* xq, void* y, long long N, long long H,
                               long long W, long long c0, long long c1, long long c2, long long c3,
                               long long cout, long long k, long long relu_in, int dtype,
                               void* stream) {
  if (N * H * W == 0) return 0;
  if (cout < 1 || (k != 1 && k != 3)) return (int)cudaErrorInvalidValue;
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
  c.cout_pad = (int)((cout + BN - 1) / BN * BN);
  c.nchunk = q.cin_pad / KC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(q, c, (int)k, s);
  if (dtype == 1) return run<bf16>(q, c, (int)k, s);
  return (int)cudaErrorInvalidValue;
}
