// K5: the GatedConvUnit tail after its 3x3 fusion conv,
//   y = out * sigmoid(W . relu(LN(f)))      (gate on)
//   y = W . relu(LN(f))                     (gate off)
// for channels_last rows: f, out, y (P, C); W the bias-free 1x1 conv
// weight (C_out = C, C_in = C); LN over the C channels of each row with
// eps and the fast variance max(E[x^2] - mean^2, 0), float32 statistics.
//
// Replaces patchrefinerv2_tpu/models/blocks/dpt.py:96 `GatedConvUnit`
// (:168-193, the plain layout: `_layer_norm`, relu, the 1x1 conv, sigmoid,
// the product), which the TPU ran as separate XLA ops (the fused Pallas
// form was retired at 2192d25). Rounding follows the JAX package: the LN
// output, the 1x1 output and the sigmoid are each rounded to the input type
// before the next step; the 1x1 product accumulates in float32.
//
// Bound: bytes for bfloat16 at C = 32 (f and out read once, y written once);
// at C = 256 the 1x1 product (2 * P * C^2 flops, 256 flops per byte moved)
// is near the tensor cores' balance point (295 flops per byte). The design keeps the LN output
// and the 1x1 output out of device memory: each block is persistent, loads
// W once into shared memory, then for every tile of BP rows computes
// relu(LN(f)) into shared memory (one row per C / 8 lanes, 8 channels a
// lane), multiplies it by W and applies the gate in the epilogue, reading
// out and writing y once. bfloat16 multiplies on the tensor cores (WMMA
// 16x16x16, float32 accumulators, each warp a 16 x 64 strip); float32 runs
// CUDA-core FMAs (the tensor cores would round float32 inputs to TF32), one
// output channel per thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

// warps per block: 16 at C = 256 (one 16 x 64 strip each per 64-row tile),
// 8 below: on the H100 16 warps are faster at C = 256 and slower at C = 32
// and 128
template <typename T, int C>
__host__ __device__ constexpr int warps() {
  return (sizeof(T) == 2 && C >= 256) ? 16 : 8;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// 8 consecutive elements (16-byte aligned) to / from float registers
__device__ __forceinline__ void load8(const float* p, float x[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w; x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float x[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(bf16* p, const float x[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T> struct Cfg;
template <> struct Cfg<bf16> { static constexpr int BP = 64; static constexpr int PAD = 8; };
template <> struct Cfg<float> { static constexpr int BP = 32; static constexpr int PAD = 1; };

// Hs[r][c] = relu(LN(f[p0 + r]))[c] rounded to T; zeros past P.
template <typename T, int C, int NWARPS>
__device__ __forceinline__ void ln_relu_tile(const T* __restrict__ f, const T* __restrict__ g,
                                             const T* __restrict__ beta, float eps, T* Hs,
                                             int64_t p0, int64_t P) {
  constexpr int BP = Cfg<T>::BP, HP = C + Cfg<T>::PAD;
  constexpr int LPR = C / 8;     // lanes per row
  constexpr int RPW = 32 / LPR;  // rows per warp step
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int seg = lane % LPR;
  for (int rb = warp * RPW; rb < BP; rb += NWARPS * RPW) {
    const int r = rb + lane / LPR;
    const int64_t p = p0 + r;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (p < P) load8(f + p * C + seg * 8, x);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1 += x[j];
      s2 += x[j] * x[j];
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off /= 2) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mean = s1 / C;
    const float var = fmaxf(s2 / C - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = seg * 8 + j;
      const float y = fmaxf((x[j] - mean) * (rstd * to_f(g[c])) + to_f(beta[c]), 0.f);
      Hs[r * HP + c] = (p < P) ? from_f<T>(y) : from_f<T>(0.f);
    }
  }
}

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// ---------------------------------------------------------------- bfloat16
template <int C>
__global__ void __launch_bounds__(warps<bf16, C>() * 32) gate_tail_bf16(
    const bf16* __restrict__ f, const bf16* __restrict__ out, const bf16* __restrict__ w,
    const bf16* __restrict__ g, const bf16* __restrict__ beta, bf16* __restrict__ y, int64_t P,
    float eps) {
  constexpr int BP = Cfg<bf16>::BP, HP = C + 8;
  constexpr int NWARPS = warps<bf16, C>(), NT = NWARPS * 32;
  constexpr int NF = C / 16 < 4 ? C / 16 : 4;           // fragments per strip (16 x 16 NF)
  constexpr int STRIPS = (BP / 16) * (C / (16 * NF));
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);                // [C_out][C_in + 8]
  bf16* Hs = Ws + C * HP;                                  // [BP][C + 8]
  float* scratch = reinterpret_cast<float*>(Hs + BP * HP); // [NWARPS][16 * 16]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* sc = scratch + warp * 256;

  for (int e = threadIdx.x; e < C * C; e += NT) Ws[(e / C) * HP + e % C] = w[e];

  const int64_t tiles = (P + BP - 1) / BP;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t p0 = tile * BP;
    __syncthreads();  // Ws loaded / Hs free
    ln_relu_tile<bf16, C, NWARPS>(f, g, beta, eps, Hs, p0, P);
    __syncthreads();
    for (int st = warp; st < STRIPS; st += NWARPS) {
      const int rt = st % (BP / 16), ct = (st / (BP / 16)) * 16 * NF;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
      for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll 4
      for (int k0 = 0; k0 < C; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Hs + rt * 16 * HP + k0, HP);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          // B (k = input channel, n = output channel) = W^T: column n is row n of W
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, Ws + (ct + 16 * j) * HP + k0, HP);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::store_matrix_sync(sc, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        const int row = lane / 2, col = (lane % 2) * 8;
        const int64_t p = p0 + rt * 16 + row;
        if (p < P) {
          const int64_t off = p * C + ct + 16 * j + col;
          float z[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) z[e] = rnd<bf16>(sc[row * 16 + col + e]);
          if (out != nullptr) {
            float o8[8];
            load8(out + off, o8);
#pragma unroll
            for (int e = 0; e < 8; ++e) z[e] = o8[e] * rnd<bf16>(sigmoid(z[e]));
          }
          store8(y + off, z);
        }
        __syncwarp();
      }
    }
  }
}

// ---------------------------------------------------------------- float32
template <int C>
__global__ void __launch_bounds__(warps<float, C>() * 32) gate_tail_f32(
    const float* __restrict__ f, const float* __restrict__ out, const float* __restrict__ w,
    const float* __restrict__ g, const float* __restrict__ beta, float* __restrict__ y, int64_t P,
    float eps) {
  constexpr int BP = Cfg<float>::BP, HP = C + 1;
  constexpr int NWARPS = warps<float, C>(), NT = NWARPS * 32;
  constexpr int TG = NT / C;     // thread groups, each one output channel a thread
  constexpr int RPG = BP / TG;   // rows per group
  extern __shared__ __align__(128) unsigned char smem[];
  float* Hs = reinterpret_cast<float*>(smem);  // [BP][C + 1]
  const int o = threadIdx.x % C, grp = threadIdx.x / C;
  const float* wo = w + (int64_t)o * C;

  const int64_t tiles = (P + BP - 1) / BP;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t p0 = tile * BP;
    __syncthreads();
    ln_relu_tile<float, C, NWARPS>(f, g, beta, eps, Hs, p0, P);
    __syncthreads();
    float acc[RPG];
#pragma unroll
    for (int r = 0; r < RPG; ++r) acc[r] = 0.f;
    for (int i = 0; i < C; ++i) {
      const float wi = __ldg(wo + i);
#pragma unroll
      for (int r = 0; r < RPG; ++r) acc[r] = fmaf(Hs[(grp * RPG + r) * HP + i], wi, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RPG; ++r) {
      const int64_t p = p0 + grp * RPG + r;
      if (p >= P) continue;
      const float z = acc[r];
      y[p * C + o] = (out != nullptr) ? out[p * C + o] * sigmoid(z) : z;
    }
  }
}

template <typename T> struct Kern;
template <> struct Kern<bf16> {
  template <int C> static constexpr auto fn() { return gate_tail_bf16<C>; }
  template <int C> static size_t smem() {
    return (size_t)C * (C + 8) * 2 + (size_t)Cfg<bf16>::BP * (C + 8) * 2 + warps<bf16, C>() * 256 * 4;
  }
};
template <> struct Kern<float> {
  template <int C> static constexpr auto fn() { return gate_tail_f32<C>; }
  template <int C> static size_t smem() { return (size_t)Cfg<float>::BP * (C + 1) * 4; }
};

template <typename T, int C>
int launch(const void* f, const void* out, const void* w, const void* g, const void* beta, void* y,
           int64_t P, float eps, cudaStream_t stream) {
  auto kern = Kern<T>::template fn<C>();
  const size_t bytes = Kern<T>::template smem<C>();
  constexpr int NT = warps<T, C>() * 32;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (P + Cfg<T>::BP - 1) / Cfg<T>::BP;
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(tiles < cap ? tiles : cap);
  kern<<<blocks, NT, bytes, stream>>>((const T*)f, (const T*)out, (const T*)w, (const T*)g,
                                      (const T*)beta, (T*)y, P, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_c(long long C, const void* f, const void* out, const void* w, const void* g,
               const void* beta, void* y, int64_t P, float eps, cudaStream_t s) {
  switch (C) {
    case 32: return launch<T, 32>(f, out, w, g, beta, y, P, eps, s);
    case 128: return launch<T, 128>(f, out, w, g, beta, y, P, eps, s);
    case 256: return launch<T, 256>(f, out, w, g, beta, y, P, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// f, out, y: (P, C) contiguous, 16-byte aligned; out null for gate off;
// w: (C, C) [out][in]; g, beta: (C,) LayerNorm scale and bias.
extern "C" int prv2_gate_tail(const void* f, const void* out, const void* w, const void* g,
                              const void* beta, void* y, long long P, long long C, float eps,
                              int dtype, void* stream) {
  if (P == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_c<float>(C, f, out, w, g, beta, y, P, eps, s);
  if (dtype == 1) return dispatch_c<bf16>(C, f, out, w, g, beta, y, P, eps, s);
  return (int)cudaErrorInvalidValue;
}
