// K3 + K4: exact softmax attention with an optional BEiT relative-position
// bias, (B, H, S, D) with D in {16, 48, 64}.
//
// Replaces patchrefinerv2_tpu/models/backbones/beit.py:46
// `relative_position_bias` + :104 `BeitAttention` (K3: the bias is built
// from the (num_rel + 3, H) table as an (H, S, S) Toeplitz tensor, then
// added to the logits) and patchrefinerv2_tpu/ops/attention.py:44 `mha` /
// :27 `mha_reference` (K4: the same attention without the bias, DINOv2).
//
// Numerics follow the JAX package: q * scale is rounded to the input type,
// Q.K^T accumulates in float32, the bias is added in float32, the softmax
// is float32 (max, exp, sum, divide), P is rounded to V's type before P.V,
// which accumulates in float32, and the output is rounded to the input
// type. An online (flash) softmax would round P before normalising it, so
// each block keeps a whole row of float32 logits for its BQ = 32 queries in
// shared memory instead (32 x 1096 x 4 B = 140 KB at S = 1025, dynamic
// shared memory above 48 KB; S up to ~1500) and runs three phases:
//   1. logits: for every tile of BK keys, L[:, tile] = Qs . K_tile^T;
//   2. softmax: one warp per row adds the bias (the head's column of the
//      table, staged in shared memory, at the timm index computed here, so
//      no (H, S, S) bias is ever written), takes the max, exponentiates,
//      sums and normalises; P is written over the start of its own logit
//      row in the input type;
//   3. O = P . V over the V tiles.
// K and V stream through two shared tiles: the next tile is loaded while
// the current one is used (cp.async, 16 bytes a thread, in bfloat16).
// bfloat16 runs both products on the tensor cores through WMMA (16x16x16,
// float32 accumulators, one 16 x 16 tile per warp and step); float32 runs
// them as CUDA-core FMAs, since the tensor cores would round float32 inputs
// to TF32.
//
// Bound: operations. 4 * B * H * S^2 * D multiply-adds against 2 * B * H *
// S * D * 4 elements moved (64 flops per byte at S = 1025, bf16): the
// tensor cores set the floor in bfloat16, the FMA units in float32. K and
// V are re-read from L2 by each of the S / 32 query blocks of a head. The
// ragged edge (S is not a multiple of 16 or 64) is masked: padded queries
// and keys read zeros and padded probabilities are 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 32;           // query rows per block
constexpr int BK = 64;           // keys per K / V tile
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;  // threads per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// Row stride (elements) of the Q and K/V tiles: odd for float32 (the FMA
// loops read a column across threads: conflict-free), a multiple of 8 for
// bfloat16 (WMMA needs 16-byte row strides and 32-byte aligned tiles).
template <typename T, int D> struct Pad { static constexpr int v = D + 8; };
template <int D> struct Pad<float, D> { static constexpr int v = D + 1; };

__device__ __forceinline__ int rel_index(int qi, int kj, int gh, int gw, int num_rel) {
  if (qi == 0) return kj == 0 ? num_rel + 2 : num_rel;
  if (kj == 0) return num_rel + 1;
  const int qp = qi - 1, kp = kj - 1;
  const int qy = qp / gw, qx = qp - qy * gw;
  const int ky = kp / gw, kx = kp - ky * gw;
  return (qy - ky + gh - 1) * (2 * gw - 1) + (qx - kx + gw - 1);
}

// ---- phase 1: L[:, kt : kt + BK] = Qs . Ks^T
template <int D>
__device__ __forceinline__ void qk_tile(const float* Qs, const float* Ks, float* L, int Ls, int kt) {
  constexpr int DP = Pad<float, D>::v;
  const int t = threadIdx.x;
  const int r0 = 2 * (t / 16), c = t % 16;
  float acc[2][4] = {};
  for (int d = 0; d < D; ++d) {
    const float a0 = Qs[r0 * DP + d], a1 = Qs[(r0 + 1) * DP + d];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float b = Ks[(c + 16 * m) * DP + d];
      acc[0][m] = fmaf(a0, b, acc[0][m]);
      acc[1][m] = fmaf(a1, b, acc[1][m]);
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    L[r0 * Ls + kt + c + 16 * m] = acc[0][m];
    L[(r0 + 1) * Ls + kt + c + 16 * m] = acc[1][m];
  }
}

template <int D>
__device__ __forceinline__ void qk_tile(const bf16* Qs, const bf16* Ks, float* L, int Ls, int kt) {
  constexpr int DP = Pad<bf16, D>::v;
  const int w = threadIdx.x / 32;  // query rows 16 (w / 4) .., key columns 16 (w % 4) ..
  const int r0 = 16 * (w / 4), c0 = 16 * (w % 4);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
    wmma::load_matrix_sync(a, Qs + r0 * DP + d0, DP);
    wmma::load_matrix_sync(b, Ks + c0 * DP + d0, DP);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(L + r0 * Ls + kt + c0, acc, Ls, wmma::mem_row_major);
}

// ---- phase 3: O += P[:, kt : kt + BK] . Vs, then the output store
template <typename T, int D> struct PV;

template <int D> struct PV<float, D> {
  static constexpr int DP = Pad<float, D>::v;
  static constexpr int DM = D / 16;
  float acc[2][DM];
  __device__ __forceinline__ PV() {
#pragma unroll
    for (int m = 0; m < DM; ++m) acc[0][m] = acc[1][m] = 0.0f;
  }
  __device__ __forceinline__ void step(const float* L, int Ls, const float* Vs, int kt) {
    const int t = threadIdx.x;
    const int r0 = 2 * (t / 16), c = t % 16;
    for (int kk = 0; kk < BK; ++kk) {
      const float p0 = L[r0 * Ls + kt + kk], p1 = L[(r0 + 1) * Ls + kt + kk];
#pragma unroll
      for (int m = 0; m < DM; ++m) {
        const float vv = Vs[kk * DP + c + 16 * m];
        acc[0][m] = fmaf(p0, vv, acc[0][m]);
        acc[1][m] = fmaf(p1, vv, acc[1][m]);
      }
    }
  }
  __device__ __forceinline__ void store(float* o, float* /*stage*/, int q0, int S, int64_t oss) {
    const int t = threadIdx.x;
    const int r0 = 2 * (t / 16), c = t % 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + r0 + i;
      if (qi >= S) continue;
#pragma unroll
      for (int m = 0; m < DM; ++m) o[qi * oss + c + 16 * m] = acc[i][m];
    }
  }
};

template <int D> struct PV<bf16, D> {
  static constexpr int DP = Pad<bf16, D>::v;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  __device__ __forceinline__ PV() { wmma::fill_fragment(acc, 0.0f); }
  // P row r is bf16 at the start of logit row r: row stride 2 * Ls elements
  __device__ __forceinline__ void step(const float* L, int Ls, const bf16* Vs, int kt) {
    const int w = threadIdx.x / 32;  // query rows 16 (w / 4) .., output columns 16 (w % 4) ..
    const int r0 = 16 * (w / 4), c0 = 16 * (w % 4);
    if (c0 >= D) return;
    const bf16* P = reinterpret_cast<const bf16*>(L) + (size_t)r0 * 2 * Ls;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, P + kt + kk, 2 * Ls);
      wmma::load_matrix_sync(b, Vs + kk * DP + c0, DP);
      wmma::mma_sync(acc, a, b, acc);
    }
  }
  __device__ __forceinline__ void store(bf16* o, float* stage, int q0, int S, int64_t oss) {
    const int w = threadIdx.x / 32;
    const int r0 = 16 * (w / 4), c0 = 16 * (w % 4);
    if (c0 < D) wmma::store_matrix_sync(stage + r0 * (D + 4) + c0, acc, D + 4, wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < BQ * D; e += NT) {
      const int r = e / D, d = e - r * D;
      if (q0 + r < S) o[(q0 + r) * oss + d] = __float2bfloat16_rn(stage[r * (D + 4) + d]);
    }
  }
};

// K / V tile rows [k0, k0 + BK) into shared memory with cp.async: float32
// 4 bytes a thread (its padded rows are not 16-byte aligned), bfloat16 16
// bytes a thread (the wrapper passes K and V with 16-byte aligned rows).
// Rows past S are zero-filled. The copies land at the next cp_async_wait.
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in, int bytes16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(s), "l"(src), "r"(in ? 4 : 0));
}

template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t ss, int k0, int S) {
  constexpr int DP = Pad<float, D>::v;
  for (int e = threadIdx.x; e < BK * D; e += NT) {
    const int r = e / D, d = e - r * D;
    const bool in = k0 + r < S;
    cp_async(dst + r * DP + d, src + (in ? (int64_t)(k0 + r) * ss + d : 0), in, 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t ss, int k0, int S) {
  constexpr int DP = Pad<bf16, D>::v, V = D / 8;
  for (int e = threadIdx.x; e < BK * V; e += NT) {
    const int r = e / V, c = (e - r * V) * 8;
    const bool in = k0 + r < S;
    cp_async(dst + r * DP + c, src + (in ? (int64_t)(k0 + r) * ss + c : 0), in, 1);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stream the K (or V) tiles of one head through two shared buffers: tile
// i + 1 is in flight while step(buffer, i) runs on tile i.
template <int D, typename T, typename Step>
__device__ __forceinline__ void over_tiles(T* KV, const T* src, int64_t ss, int S, int S_pad,
                                           Step step) {
  constexpr int DP = Pad<T, D>::v;
  load_tile<D>(KV, src, ss, 0, S);
  for (int i = 0, kt = 0; kt < S_pad; ++i, kt += BK) {
    T* cur = KV + (i & 1) * BK * DP;
    if (kt + BK < S_pad) {
      load_tile<D>(KV + ((i + 1) & 1) * BK * DP, src, ss, kt + BK, S);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    step(cur, kt);
    __syncthreads();  // cur is refilled two tiles on
  }
}

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline int padded_keys(int S) { return (S + BK - 1) / BK * BK; }

// ntab: rows of the bias table (num_rel + 3), 0 without a bias
template <typename T, int D>
__host__ __device__ inline size_t smem_bytes(int S, int ntab) {
  const int Ls = padded_keys(S) + 8;
  return align128((size_t)BQ * Ls * 4) + align128((size_t)BQ * Pad<T, D>::v * sizeof(T)) +
         align128((size_t)2 * BK * Pad<T, D>::v * sizeof(T)) + align128((size_t)BQ * (D + 4) * 4) +
         align128((size_t)ntab * 4);
}

struct Strides {
  int64_t b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    const T* __restrict__ table, int S, int H, Strides qs, Strides ks, Strides vs, Strides os,
    int gh, int gw, float scale) {
  constexpr int DP = Pad<T, D>::v;
  extern __shared__ __align__(128) unsigned char smem[];
  const int S_pad = padded_keys(S);
  const int Ls = S_pad + 8;
  float* L = reinterpret_cast<float*>(smem);
  T* Qs = reinterpret_cast<T*>(smem + align128((size_t)BQ * Ls * 4));
  T* KV = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(Qs) +
                               align128((size_t)BQ * DP * sizeof(T)));  // two K / V tiles
  float* stage = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(KV) +
                                          align128((size_t)2 * BK * DP * sizeof(T)));
  float* tab = stage + align128((size_t)BQ * (D + 4) * 4) / 4;  // this head's bias column

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // q * scale, rounded to T as the JAX package rounds it (scale in T too)
  const float sc = to_f(from_f<T>(scale));
  for (int e = threadIdx.x; e < BQ * D; e += NT) {
    const int r = e / D, d = e - r * D;
    const float x = (q0 + r < S) ? to_f(qb[(int64_t)(q0 + r) * qs.s + d]) : 0.0f;
    Qs[r * DP + d] = from_f<T>(x * sc);
  }
  const int num_rel = (2 * gh - 1) * (2 * gw - 1);
  if (table != nullptr)
    for (int e = threadIdx.x; e < num_rel + 3; e += NT) tab[e] = to_f(table[e * H + h]);

  // ---- phase 1: logits
  over_tiles<D>(KV, kb, ks.s, S, S_pad, [&](const T* Ks, int kt) { qk_tile<D>(Qs, Ks, L, Ls, kt); });

  // ---- phase 2: bias + softmax, one warp per row; P over its logit row
  for (int r = warp; r < BQ; r += NWARPS) {
    const int qi = q0 + r;
    float* Lr = L + r * Ls;
    T* Pr = reinterpret_cast<T*>(Lr);
    if (qi < S) {
      float m = -INFINITY;
      for (int kj = lane; kj < S; kj += 32) {
        float s = Lr[kj];
        if (table != nullptr) s += tab[rel_index(qi, kj, gh, gw, num_rel)];
        Lr[kj] = s;
        m = fmaxf(m, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.0f;
      for (int kj = lane; kj < S; kj += 32) {
        const float ex = expf(Lr[kj] - m);
        Lr[kj] = ex;
        sum += ex;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // P[kj] (sizeof(T) bytes at kj * sizeof(T)) lands on logits this warp
      // has already read: in this chunk (synchronised) or an earlier one
      for (int k0 = 0; k0 < S_pad; k0 += 32) {
        const int kj = k0 + lane;
        const float p = (kj < S) ? Lr[kj] / sum : 0.0f;
        __syncwarp();
        Pr[kj] = from_f<T>(p);
        __syncwarp();
      }
    } else {
      for (int kj = lane; kj < S_pad; kj += 32) Pr[kj] = from_f<T>(0.0f);
    }
  }

  // ---- phase 3: O = P . V
  PV<T, D> pv;
  over_tiles<D>(KV, vb, vs.s, S, S_pad, [&](const T* Vs, int kt) { pv.step(L, Ls, Vs, kt); });
  pv.store(ob, stage, q0, S, os.s);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const void* table, int B, int H,
           int S, Strides qs, Strides ks, Strides vs, Strides os, int gh, int gw, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, D>(S, table != nullptr ? (2 * gh - 1) * (2 * gw - 1) + 3 : 0);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  attention_kernel<T, D><<<grid, NT, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (const T*)table, S, H, qs, ks, vs, os, gh, gw,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, const void* table,
               int B, int H, int S, Strides qs, Strides ks, Strides vs, Strides os, int gh, int gw,
               float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, table, B, H, S, qs, ks, vs, os, gh, gw, scale, s);
    case 48: return launch<T, 48>(q, k, v, o, table, B, H, S, qs, ks, vs, os, gh, gw, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, table, B, H, S, qs, ks, vs, os, gh, gw, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (B, H, S, D) with the given (batch, head, token) strides in
// elements and unit stride over D (bfloat16 k and v: rows 16-byte aligned);
// table: (num_rel + 3, H) or null (no bias).
extern "C" int prv2_attention(const void* q, const void* k, const void* v, void* o,
                              const void* table, long long B, long long H, long long S,
                              long long D, long long qsb, long long qsh, long long qss,
                              long long ksb, long long ksh, long long kss, long long vsb,
                              long long vsh, long long vss, long long osb, long long osh,
                              long long oss, long long gh, long long gw, float scale, int dtype,
                              void* stream) {
  if (B * H * S == 0) return 0;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>((int)D, q, k, v, o, table, (int)B, (int)H, (int)S, qs, ks, vs, os,
                             (int)gh, (int)gw, scale, s);
  if (dtype == 1)
    return dispatch_d<bf16>((int)D, q, k, v, o, table, (int)B, (int)H, (int)S, qs, ks, vs, os,
                            (int)gh, (int)gw, scale, s);
  return (int)cudaErrorInvalidValue;
}
