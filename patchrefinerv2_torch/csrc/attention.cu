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
// is float32 (max, exp, sum, divide), P is rounded to V's type only after
// it is normalised, P.V accumulates in float32, and the output is rounded
// to the input type. The one-pass online (flash) softmax rounds P before it
// divides by the row sum, so neither kernel below takes it. The bias entry
// of a logit is read from the head's column of the table (staged in shared
// memory) at the timm index, so no (H, S, S) bias is ever written.
//
// Two kernels, chosen by dtype:
//
// bfloat16, `attention_mma_kernel` (the serving dtype: every call of the
// bf16 frames). Bound: at S = 769 / 1025 the 4 S^2 D multiply-adds of a
// head take ~2-4 us of tensor-core time and its Q, K, V and O ~1 us of
// HBM, so what sets the time is latency and occupancy: how many warps are
// resident, how long each waits on its loads and its dependent mma and
// exponential chains. The design:
//   - a block holds 16 RW query rows, 16 a warp, in NG groups of RW warps
//     that split the keys (group gi takes tiles gi, gi + NG, ...; their row
//     max and sum are merged in shared memory after pass 1, their P.V sums
//     after pass 2). The host takes the first shape whose blocks fit the
//     card in one wave, two an SM: NG = 2, RW = 4 (208 blocks of 8 warps at
//     the flagship's S = 769, H = 16), else NG = 2, RW = 5 (208 blocks of 10
//     at DINOv2's S = 1025, where 64-row blocks would be 272, a second wave
//     of 8), else NG = 1, RW = 4. Up to 8 warps a block keep their Q
//     A-fragments (mma.sync m16n8k16, loaded with ldmatrix) in registers
//     (128 a thread); 10 have 96 and reload them from shared memory;
//   - the logits of a 64-key tile live only in the float32 accumulators.
//     P's bf16 A-fragments are packed in registers from those accumulators
//     (the C layout of two n8 tiles is the A layout of one k16 step) and fed
//     straight to P.V: no logit or P goes to shared memory;
//   - two passes over K, so that P is normalised before it is rounded:
//     pass 1 keeps per row the exact max m and the sum l (rescaled online,
//     which moves l by a few ulps); pass 2 streams K and V together,
//     recomputes each logit tile, forms p = exp(s - m) / l in float32,
//     rounds it to bf16 and accumulates P.V. That is one Q.K^T more (6 S^2 D
//     instead of 4 S^2 D a head), a few microseconds of tensor-core time;
//   - the exponentials are the MUFU unit's ex2 of x log2 e and the division
//     a product with 1 / l: each moves p by ~1e-6 of itself before its
//     rounding to bf16 (2^-9), where expf and a true division took ~20
//     instructions a logit and bounded the first version of this kernel;
//   - K and V tiles (64 keys x D) stream through two cp.async stages in
//     shared memory, the next step's tile in flight during this one, with
//     rows padded to D + 8 elements so ldmatrix is free of bank conflicts;
//     each key group loads its own tiles and waits only for its own warps
//     (a named barrier), so the two groups do not run in lockstep;
//   - the bias: per row the (qy, qx) part of the timm index and per key the
//     (ky, kx) part are worked out once (the keys' in a shared table), so a
//     logit's index is one subtraction: no integer division per logit;
//   - ragged S: keys past S are zero-filled and take -inf before the max
//     (p = 0); query rows past S compute on zeros and are never stored.
//
// float32, `attention_kernel` (only the float32 parity frames, m1 f32):
// the three-phase CUDA-core kernel of the first port. Each block keeps a
// whole row of float32 logits for its BQ = 32 queries in shared memory
// (32 x 1096 x 4 B = 140 KB at S = 1025; S up to ~1500) and runs: 1. the
// logits for every tile of BK keys; 2. one warp per row adds the bias,
// takes the max, exponentiates, sums and normalises (P over the start of
// its own logit row); 3. O = P . V over the V tiles. Float32 stays on the
// FMA units, since the tensor cores would round its inputs to TF32; it is
// bound by those FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Strides {
  int64_t b, h, s;
};

__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in, int bytes16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(s), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline int num_rel_of(int gh, int gw) { return (2 * gh - 1) * (2 * gw - 1); }

// =====================================================================
// float32: three phases, logit rows in shared memory
// =====================================================================
namespace f32k {

constexpr int BQ = 32;           // query rows per block
constexpr int BK = 64;           // keys per K / V tile
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;  // threads per block

// odd row stride: the FMA loops read a column across threads, conflict-free
template <int D> __host__ __device__ constexpr int pad() { return D + 1; }

__device__ __forceinline__ int rel_index(int qi, int kj, int gh, int gw, int num_rel) {
  if (qi == 0) return kj == 0 ? num_rel + 2 : num_rel;
  if (kj == 0) return num_rel + 1;
  const int qp = qi - 1, kp = kj - 1;
  const int qy = qp / gw, qx = qp - qy * gw;
  const int ky = kp / gw, kx = kp - ky * gw;
  return (qy - ky + gh - 1) * (2 * gw - 1) + (qx - kx + gw - 1);
}

// L[:, kt : kt + BK] = Qs . Ks^T
template <int D>
__device__ __forceinline__ void qk_tile(const float* Qs, const float* Ks, float* L, int Ls, int kt) {
  constexpr int DP = pad<D>();
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

// O += P[:, kt : kt + BK] . Vs, two rows and D / 16 columns a thread
template <int D>
__device__ __forceinline__ void pv_tile(const float* L, int Ls, const float* Vs, int kt,
                                        float (&acc)[2][D / 16]) {
  constexpr int DP = pad<D>();
  const int t = threadIdx.x;
  const int r0 = 2 * (t / 16), c = t % 16;
  for (int kk = 0; kk < BK; ++kk) {
    const float p0 = L[r0 * Ls + kt + kk], p1 = L[(r0 + 1) * Ls + kt + kk];
#pragma unroll
    for (int m = 0; m < D / 16; ++m) {
      const float vv = Vs[kk * DP + c + 16 * m];
      acc[0][m] = fmaf(p0, vv, acc[0][m]);
      acc[1][m] = fmaf(p1, vv, acc[1][m]);
    }
  }
}

// K / V tile rows [k0, k0 + BK) into shared memory, 4 bytes a thread (the
// padded rows are not 16-byte aligned); rows past S are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t ss, int k0, int S) {
  constexpr int DP = pad<D>();
  for (int e = threadIdx.x; e < BK * D; e += NT) {
    const int r = e / D, d = e - r * D;
    const bool in = k0 + r < S;
    cp_async(dst + r * DP + d, src + (in ? (int64_t)(k0 + r) * ss + d : 0), in, 0);
  }
  cp_async_commit();
}

// Stream the K (or V) tiles of one head through two shared buffers: tile
// i + 1 is in flight while step(buffer, i) runs on tile i.
template <int D, typename Step>
__device__ __forceinline__ void over_tiles(float* KV, const float* src, int64_t ss, int S,
                                           int S_pad, Step step) {
  constexpr int DP = pad<D>();
  load_tile<D>(KV, src, ss, 0, S);
  for (int i = 0, kt = 0; kt < S_pad; ++i, kt += BK) {
    float* cur = KV + (i & 1) * BK * DP;
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

__host__ __device__ inline int padded_keys(int S) { return (S + BK - 1) / BK * BK; }

// ntab: rows of the bias table (num_rel + 3), 0 without a bias
template <int D>
__host__ __device__ inline size_t smem_bytes(int S, int ntab) {
  const int Ls = padded_keys(S) + 8;
  return align128((size_t)BQ * Ls * 4) + align128((size_t)BQ * pad<D>() * 4) +
         align128((size_t)2 * BK * pad<D>() * 4) + align128((size_t)ntab * 4);
}

template <int D>
__global__ void __launch_bounds__(NT) attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, const float* __restrict__ table, int S, int H, Strides qs, Strides ks,
    Strides vs, Strides os, int gh, int gw, float scale) {
  constexpr int DP = pad<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int S_pad = padded_keys(S);
  const int Ls = S_pad + 8;
  float* L = reinterpret_cast<float*>(smem);
  float* Qs = reinterpret_cast<float*>(smem + align128((size_t)BQ * Ls * 4));
  float* KV = Qs + align128((size_t)BQ * DP * 4) / 4;  // two K / V tiles
  float* tab = KV + align128((size_t)2 * BK * DP * 4) / 4;  // this head's bias column

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  for (int e = threadIdx.x; e < BQ * D; e += NT) {
    const int r = e / D, d = e - r * D;
    Qs[r * DP + d] = (q0 + r < S) ? qb[(int64_t)(q0 + r) * qs.s + d] * scale : 0.0f;
  }
  const int num_rel = num_rel_of(gh, gw);
  if (table != nullptr)
    for (int e = threadIdx.x; e < num_rel + 3; e += NT) tab[e] = table[e * H + h];

  // ---- phase 1: logits
  over_tiles<D>(KV, kb, ks.s, S, S_pad, [&](const float* Ks, int kt) { qk_tile<D>(Qs, Ks, L, Ls, kt); });

  // ---- phase 2: bias + softmax, one warp per row
  for (int r = warp; r < BQ; r += NWARPS) {
    const int qi = q0 + r;
    float* Lr = L + r * Ls;
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
      for (int kj = lane; kj < S_pad; kj += 32) Lr[kj] = (kj < S) ? Lr[kj] / sum : 0.0f;
    } else {
      for (int kj = lane; kj < S_pad; kj += 32) Lr[kj] = 0.0f;
    }
  }

  // ---- phase 3: O = P . V
  float acc[2][D / 16] = {};
  over_tiles<D>(KV, vb, vs.s, S, S_pad, [&](const float* Vs, int kt) { pv_tile<D>(L, Ls, Vs, kt, acc); });
  const int r0 = 2 * (threadIdx.x / 16), c = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= S) continue;
#pragma unroll
    for (int m = 0; m < D / 16; ++m) ob[qi * os.s + c + 16 * m] = acc[i][m];
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, const void* table, int B, int H,
           int S, Strides qs, Strides ks, Strides vs, Strides os, int gh, int gw, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(S, table != nullptr ? num_rel_of(gh, gw) + 3 : 0);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  attention_kernel<D><<<grid, NT, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (const float*)table, S, H, qs,
      ks, vs, os, gh, gw, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32k

// =====================================================================
// bfloat16: register-tiled two passes on mma.sync
// =====================================================================
namespace mmak {

constexpr int BK = 64;  // keys per K / V tile

// shared row stride in elements: 16-byte rows whose 8-row ldmatrix
// groups fall on distinct bank quads for D = 16, 48 and 64
template <int D> __host__ __device__ constexpr int ld() { return D + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c += a . b, m16n8k16, bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e^x as 2^(x log2 e) on the MUFU unit (ex2.approx, ~2 ulp; e^-inf = 0)
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__host__ __device__ inline int padded_keys(int S) { return (S + BK - 1) / BK * BK; }

// Q (bq rows); two stages of ng K tiles and ng V tiles; the groups' row
// max and sum; the bias column and the keys' index parts
template <int D>
__host__ __device__ inline size_t smem_bytes(int S, int ntab, int ng, int bq) {
  return (size_t)(bq + 4 * ng * BK) * ld<D>() * 2 + (size_t)ng * bq * 2 * 4 +
         (ntab > 0 ? (size_t)(ntab + padded_keys(S)) * 4 : 0);
}

// The timm index of (query, key) from the row part rb (-1: the cls query)
// and the key part cb (-1: the cls key): the cls entries are the last three
// rows of the table; between two patches
// (qy - ky + gh - 1) (2 gw - 1) + (qx - kx + gw - 1) = rb - cb with
// rb = (qy + gh - 1) (2 gw - 1) + qx + gw - 1 and cb = ky (2 gw - 1) + kx.
__device__ __forceinline__ int bias_index(int rb, int cb, int num_rel) {
  if (rb < 0) return cb < 0 ? num_rel + 2 : num_rel;
  return cb < 0 ? num_rel + 1 : rb - cb;
}

// NG groups of RW warps share a block's 16 RW query rows and split the
// keys: group gi takes tiles gi, gi + NG, ...; their row max and sum are
// merged after pass 1 and their P.V sums after pass 2. Up to 8 warps a
// block leave 128 registers a thread at 16 warps an SM, and the warps keep
// their Q fragments in them; 10 (two blocks an SM) leave 96, and they
// reload them from shared memory at every tile.
template <int D, int NG, int RW>
__global__ void __launch_bounds__(32 * NG * RW, NG == 1 ? 4 : 2) attention_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, const bf16* __restrict__ table, int S, int H, Strides qs, Strides ks,
    Strides vs, Strides os, int gh, int gw, float scale) {
  constexpr int LD = ld<D>(), TILE = BK * LD, V8 = D / 8;
  constexpr int BQ = 16 * RW, NT = 32 * NG * RW;
  constexpr bool QREG = NG * RW <= 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;        // [stage][group] tiles
  bf16* Vs = Ks + 2 * NG * TILE;  // [stage][group] tiles
  float* ml = reinterpret_cast<float*>(Vs + 2 * NG * TILE);  // [group][row]: m, l
  float* tab = ml + NG * BQ * 2;  // this head's bias column
  const int num_rel = num_rel_of(gh, gw);
  const bool bias = table != nullptr;
  int* kcol = reinterpret_cast<int*>(tab + (bias ? num_rel + 3 : 0));  // per key: its cb

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  bf16* ob = o + b * os.b + h * os.h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gi = warp / RW, row0 = 16 * (warp % RW);  // key group; the warp's first row
  const int g = lane / 4, tig = lane % 4;             // fragment row group, thread in group
  const int S_pad = padded_keys(S), nt = S_pad / BK, np = (nt + NG - 1) / NG;

  // step i < np: group gi loads K tile NG i + gi (pass 1); step np + j: K
  // and V tile NG j + gi (pass 2); a tile past the last is skipped
  const int gtid = tid - gi * 32 * RW;
  auto issue = [&](int i) {
    const int stage = i & 1, t = (i % np) * NG + gi;
    const bool pass2 = i >= np;
    if (t < nt)
      for (int e = gtid; e < BK * V8; e += 32 * RW) {
        const int r = e / V8, c = (e % V8) * 8;
        const int kj = t * BK + r;
        const bool in = kj < S;
        const int64_t row = in ? (int64_t)kj : 0;
        const int at = (stage * NG + gi) * TILE + r * LD + c;
        cp_async(Ks + at, kb + row * ks.s + c, in, 1);
        if (pass2) cp_async(Vs + at, vb + row * vs.s + c, in, 1);
      }
    cp_async_commit();
  };
  auto group_sync = [&]() {  // barrier 0 is __syncthreads'
    if constexpr (NG == 1) __syncthreads();
    else asm volatile("bar.sync %0, %1;\n" ::"r"(1 + gi), "r"(32 * RW));
  };
  issue(0);

  // q * scale, rounded to bf16 as the JAX package rounds it (scale in bf16 too)
  const float sc = __bfloat162float(__float2bfloat16_rn(scale));
  for (int e = tid; e < BQ * V8; e += NT) {
    const int r = e / V8, c = (e - r * V8) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < S) raw = *reinterpret_cast<const uint4*>(qb + (int64_t)(q0 + r) * qs.s + c);
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      h2[j] = __floats2bfloat162_rn(f.x * sc, f.y * sc);
    }
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = raw;
  }
  // the rows' index parts; a padded query row takes the last row's
  int rb[2] = {0, 0};
  if (bias) {
    for (int e = tid; e < num_rel + 3; e += NT) tab[e] = __bfloat162float(table[e * H + h]);
    for (int j = tid; j < S_pad; j += NT) {
      int cb = 0;
      if (j == 0) {
        cb = -1;
      } else if (j < S) {
        const int ky = (j - 1) / gw;
        cb = ky * (2 * gw - 1) + (j - 1 - ky * gw);
      }
      kcol[j] = cb;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = min(q0 + row0 + g + 8 * r, S - 1);
      if (qi == 0) {
        rb[r] = -1;
      } else {
        const int qy = (qi - 1) / gw, qx = qi - 1 - qy * gw;
        rb[r] = (qy + gh - 1) * (2 * gw - 1) + qx + gw - 1;
      }
    }
  }
  __syncthreads();
  uint32_t qf[QREG ? D / 16 : 1][4];  // this warp's 16 rows of Q, an A-fragment a k16 step
  if constexpr (QREG)
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      ldsm_x4(qf[kd], Qs + (row0 + lane % 16) * LD + 16 * kd + (lane / 16) * 8);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int i = 0; i < 2 * np; ++i) {
    if (i + 1 < 2 * np) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    group_sync();
    const int t = (i % np) * NG + gi, k0 = t * BK;
    if (t < nt) {
      const bf16* Kt = Ks + ((i & 1) * NG + gi) * TILE;
      // s = Q . K^T for this warp's 16 rows and the tile's 64 keys: n8
      // tile j holds keys k0 + 8 j + 2 tig (+1) of rows g (s[j][0..1]) and
      // g + 8 (s[j][2..3])
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const int qk = QREG ? kd : 0;
        if constexpr (!QREG) ldsm_x4(qf[0], Qs + (row0 + lane % 16) * LD + 16 * kd + (lane / 16) * 8);
#pragma unroll
        for (int kp = 0; kp < 4; ++kp) {
          uint32_t bf[4];
          ldsm_x4(bf, Kt + (16 * kp + (lane / 16) * 8 + lane % 8) * LD + 16 * kd + ((lane / 8) % 2) * 8);
          mma(s[2 * kp], qf[qk], bf[0], bf[1]);
          mma(s[2 * kp + 1], qf[qk], bf[2], bf[3]);
        }
      }
      if (bias)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int cb = kcol[k0 + 8 * j + 2 * tig + c];
            s[j][c] += tab[bias_index(rb[0], cb, num_rel)];
            s[j][c + 2] += tab[bias_index(rb[1], cb, num_rel)];
          }
      if (k0 + BK > S)  // the last tile: keys past S take -inf
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * tig + (e & 1) >= S) s[j][e] = -INFINITY;

      if (i < np) {
        // pass 1: the row max, exact, and the row sum, rescaled online;
        // a row's four threads (one quad) share m
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[r];
#pragma unroll
          for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) sum += exp_fast(s[j][2 * r] - mx) + exp_fast(s[j][2 * r + 1] - mx);
          l[r] = (m[r] == -INFINITY ? 0.0f : l[r] * exp_fast(m[r] - mx)) + sum;
          m[r] = mx;
        }
      } else {
        // pass 2: p = exp(s - m) / l in float32 (l now holds 1 / l),
        // rounded to bf16 in the A-fragments of P, then O += P . V
        const bf16* Vt = Vs + ((i & 1) * NG + gi) * TILE;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t pf[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = 2 * kk + half;
            pf[2 * half] = pack(exp_fast(s[j][0] - m[0]) * l[0], exp_fast(s[j][1] - m[0]) * l[0]);
            pf[2 * half + 1] = pack(exp_fast(s[j][2] - m[1]) * l[1], exp_fast(s[j][3] - m[1]) * l[1]);
          }
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t bf[4];
            ldsm_x4_t(bf, Vt + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * LD + 16 * dp + (lane / 16) * 8);
            mma(acc[2 * dp], pf, bf[0], bf[1]);
            mma(acc[2 * dp + 1], pf, bf[2], bf[3]);
          }
        }
      }
    }
    if (i == np - 1) {
      // the groups' row max and sum, merged in one order by every group;
      // then 1 / l for pass 2. A group with no key of its own has m = -inf
      // and l = 0, and adds 0.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        if (tig == 0) {
          ml[(gi * BQ + row0 + g + 8 * r) * 2] = m[r];
          ml[(gi * BQ + row0 + g + 8 * r) * 2 + 1] = l[r];
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY, sum = 0.0f;
        for (int j = 0; j < NG; ++j) mx = fmaxf(mx, ml[(j * BQ + row0 + g + 8 * r) * 2]);
        for (int j = 0; j < NG; ++j) {
          const float mj = ml[(j * BQ + row0 + g + 8 * r) * 2];
          if (mj != -INFINITY) sum += ml[(j * BQ + row0 + g + 8 * r) * 2 + 1] * exp_fast(mj - mx);
        }
        m[r] = mx;
        l[r] = __frcp_rn(sum);
      }
    }
    group_sync();  // this stage is refilled two steps on
  }
  __syncthreads();  // the groups' last tiles are read before red overwrites them

  // O: the groups' P.V sums added in group order through shared memory
  // (over the K tiles, free now), then rounded to bf16 and stored
  float* red = reinterpret_cast<float*>(Ks);  // [row][D]
  for (int j = 1; j < NG; ++j) {
    if (gi == j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8)
          *reinterpret_cast<float2*>(red + (row0 + g + 8 * r) * D + 8 * n8 + 2 * tig) =
              make_float2(acc[n8][2 * r], acc[n8][2 * r + 1]);
    __syncthreads();
    if (gi == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8) {
          const float2 t = *reinterpret_cast<const float2*>(red + (row0 + g + 8 * r) * D + 8 * n8 + 2 * tig);
          acc[n8][2 * r] += t.x;
          acc[n8][2 * r + 1] += t.y;
        }
    __syncthreads();
  }
  if (gi != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + g + 8 * r;
    if (qi >= S) continue;
    bf16* orow = ob + (int64_t)qi * os.s + 2 * tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// The blocks' shape (NG key groups of RW row-warps), the first that fits
// the card in one wave, two blocks an SM: two groups of 4 row-warps (64
// rows: 208 blocks at the flagship's S = 769, H = 16), else two of 5 (80
// rows: 208 blocks at DINOv2's S = 1025, where 64-row blocks would be 272,
// 8 more than a wave), else one group of 4.
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, const void* table, int B, int H,
           int S, Strides qs, Strides ks, Strides vs, Strides os, int gh, int gw, float scale,
           cudaStream_t stream) {
  static int sms = 0;  // the card's SM count (one card a process)
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  auto wave = [&](int rw) { return (int64_t)(S + 16 * rw - 1) / (16 * rw) * H * B <= 2 * (int64_t)sms; };
  const int ng = wave(4) || wave(5) ? 2 : 1, rw = ng == 2 && !wave(4) ? 5 : 4;
  auto kernel = ng == 1 ? attention_mma_kernel<D, 1, 4>
                        : rw == 4 ? attention_mma_kernel<D, 2, 4> : attention_mma_kernel<D, 2, 5>;
  const int bq = 16 * rw;
  const size_t bytes = smem_bytes<D>(S, table != nullptr ? num_rel_of(gh, gw) + 3 : 0, ng, bq);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + bq - 1) / bq, H, B);
  kernel<<<grid, 32 * ng * rw, bytes, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                (bf16*)o, (const bf16*)table, S, H, qs, ks, vs, os,
                                                gh, gw, scale);
  return (int)cudaGetLastError();
}

}  // namespace mmak

template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v, void* o, const void* table,
             int B, int H, int S, Strides qs, Strides ks, Strides vs, Strides os, int gh, int gw,
             float scale, cudaStream_t s) {
  if (dtype == 0) return f32k::launch<D>(q, k, v, o, table, B, H, S, qs, ks, vs, os, gh, gw, scale, s);
  if (dtype == 1) return mmak::launch<D>(q, k, v, o, table, B, H, S, qs, ks, vs, os, gh, gw, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: (B, H, S, D) with the given (batch, head, token) strides in
// elements and unit stride over D (bfloat16 q, k, v: rows 16-byte aligned);
// table: (num_rel + 3, H) or null (no bias). dtype 0: float32, 1: bfloat16.
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
  switch (D) {
    case 16: return launch_d<16>(dtype, q, k, v, o, table, (int)B, (int)H, (int)S, qs, ks, vs, os, (int)gh, (int)gw, scale, s);
    case 48: return launch_d<48>(dtype, q, k, v, o, table, (int)B, (int)H, (int)S, qs, ks, vs, os, (int)gh, (int)gw, scale, s);
    case 64: return launch_d<64>(dtype, q, k, v, o, table, (int)B, (int)H, (int)S, qs, ks, vs, os, (int)gh, (int)gw, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
