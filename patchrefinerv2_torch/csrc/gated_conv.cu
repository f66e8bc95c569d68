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
// Bound: bytes at every site (f and out read once, y written once): the
// 1x1 at C = 256 is ~85 bfloat16 flops a byte moved, below the tensor
// cores' balance point (~295). So the bfloat16 kernel streams: it is
// persistent (a block per SM), keeps W resident in shared memory, and keeps
// the next tiles of f in flight while the current one is normalised,
// multiplied and written. A block is a producer warpgroup and two consumer
// warpgroups that take the block's tiles in turn:
// - one producer thread fills a ring of f tiles (BP contiguous rows, one
//   cp.async.bulk each) under full / empty mbarriers; the producers' warps
//   hand their registers to the consumers (setmaxnreg);
// - a consumer loads its tile's rows of `out` into registers (16-byte
//   loads; at C < 256 first, in flight while it works, at C = 256 after the
//   products, where the accumulators hold the registers and the other
//   consumer's work hides the loads), writes relu(LN(f)) in bfloat16
//   over the staged tile in place, permuted within each 8-row group from
//   row-major to the K-major core matrices a wgmma descriptor reads (each
//   warp owns whole groups: a lane holds one row's chunks, rotated so that
//   both the row-major reads and the core-matrix writes are free of bank
//   conflicts; a row's statistics reduce over its 1, 2 or 4 lanes);
// - the 1x1 runs on `wgmma.mma_async m64nNk16` (A and B from shared memory
//   by descriptor, float32 accumulators; N 128 in two passes at C = 256,
//   one pass at C = 128, four m64 blocks of N 32 at C = 32);
// - z rounded to bfloat16 goes back over the tile by stmatrix, into rows
//   whose 16-byte chunks are rotated by row, so that the last pass reads
//   whole rows without bank conflicts; it applies the gate with `out` and
//   writes y with 16-byte stores, neighbouring threads on neighbouring
//   chunks of a row.
// Shared memory at C = 256: W 128 KB and 3 stages of 32 KB; the f stage
// doubles as the A operand and the z staging, so `out` goes to registers.
// The host's plan (ops/gated.launch_plan) picks the stages and the grid.
//
// float32 (the parity and float32 cells only) runs CUDA-core FMAs (the
// tensor cores would round float32 inputs to TF32), one output channel per
// thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- bfloat16

constexpr int SMEM_MAX = 232448;
constexpr int MAX_STAGES = 8;
constexpr int BAR_BYTES = 128;   // full[s] at 8 s, empty[s] at 64 + 8 s
constexpr int PRM_BYTES = 1024;  // the LayerNorm's scale and bias (bfloat16)
constexpr int NT = 384;          // two consumer warpgroups, then the producer's warpgroup

template <int C> struct Geo {
  static constexpr int NCH = C / 8;            // 16-byte chunks of a row
  static constexpr int MB = C == 32 ? 4 : 1;   // m64 blocks of a tile
  static constexpr int BP = 64 * MB;           // rows of a tile
  static constexpr int NP = C < 128 ? C : 128; // output channels of a product pass
  static constexpr int NPASS = C / NP;
  static constexpr int KS = C / 16;            // k-steps
  static constexpr int STAGE = BP * C * 2;     // bytes of a staged tile
  static constexpr int GROUP = NCH * 128;      // bytes of 8 rows
  // the LN's lane map: LPR lanes share a row, each holding NIT of its
  // chunks; a warp takes GPW 8-row groups at a time
  static constexpr int LPR = NCH >= 32 ? 4 : NCH >= 16 ? 2 : 1;
  static constexpr int NIT = NCH / LPR;
  static constexpr int GPW = 4 / LPR;
  static constexpr int LN_PASSES = BP / (32 * GPW);
  static constexpr int EPI = BP * NCH / 128;   // chunks a consumer thread writes
  static constexpr int ROT = NCH >= 8 ? 1 : 2; // the z staging's rotation per chunk
};

// row R, chunk c of a tile in the wgmma layout: 8-row groups of core
// matrices (8 rows by 16 bytes), chunk after chunk
template <int C> __device__ __forceinline__ uint32_t core_off(int R, int c) {
  return (R >> 3) * Geo<C>::GROUP + c * 128 + (R & 7) * 16;
}
// the same with the 8 rows of each core matrix rotated by the chunk: the
// z staging, which stmatrix writes by core matrix and the last pass reads
// by row
template <int C> __device__ __forceinline__ uint32_t z_off(int R, int c) {
  return (R >> 3) * Geo<C>::GROUP + c * 128 + (((R & 7) + c * Geo<C>::ROT) & 7) * 16;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z),
               "r"(v.w)
               : "memory");
}
// a read-only 16-byte global load, issued where it stands
__device__ __forceinline__ uint4 ldg128(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a),
               "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}
__device__ __forceinline__ float rnd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
// out * rnd(sigmoid(z)) for a pair, rounded
__device__ __forceinline__ uint32_t gate2(uint32_t z, uint32_t o) {
  const float2 zz = unpack(z), oo = unpack(o);
  const float s0 = rnd(__fdividef(1.0f, 1.0f + __expf(-zz.x)));
  const float s1 = rnd(__fdividef(1.0f, 1.0f + __expf(-zz.y)));
  return pack_rn(oo.x * s0, oo.y * s1);
}

// d (N / 2 float32 a thread) += A (64 x 16 bfloat16) * B (16 x N
// bfloat16), both K-major descriptors
template <int N> __device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b);
template <> __device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// Keeps the compiler from moving accumulator writes across the wgmma
// fences (it would otherwise wait for each wgmma before issuing the next)
template <int N> __device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// relu(LN(f)) over the staged tile `st` in place, from row-major rows to
// the wgmma layout, bfloat16; zeros from row `rows` on. Warp wq takes
// 8-row groups; lane (grp, q, r) holds chunks q * NIT + (r + it) % NIT,
// it < NIT, of row r of its group: a phase of 8 lanes reads 8 different
// chunk columns and writes 8 different rows of a core matrix.
template <int C>
__device__ __forceinline__ void ln_tile(uint32_t st, uint32_t prm, int rows, float eps, int wq, int lane) {
  using G = Geo<C>;
  const int r = lane & 7, q = (lane >> 3) % G::LPR, grp = lane / (8 * G::LPR);
#pragma unroll
  for (int ps = 0; ps < G::LN_PASSES; ++ps) {
    const int gi = (ps * 4 + wq) * G::GPW + grp;
    const uint32_t gb = st + gi * G::GROUP;
    uint4 v[G::NIT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int it = 0; it < G::NIT; ++it) {
      const int c = q * G::NIT + ((r + it) & (G::NIT - 1));
      v[it] = lds128(gb + r * (C * 2) + c * 16);
      const uint32_t* u = &v[it].x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = unpack(u[j]);
        s1 += x.x + x.y;
        s2 += x.x * x.x + x.y * x.y;
      }
    }
    if (G::LPR >= 2) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, 8);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 8);
    }
    if (G::LPR >= 4) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, 16);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 16);
    }
    const float mean = s1 * (1.0f / C);
    const float var = fmaxf(s2 * (1.0f / C) - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    const bool live = gi * 8 + r < rows;
    __syncwarp();  // the group is read before it is overwritten
#pragma unroll
    for (int it = 0; it < G::NIT; ++it) {
      const int c = q * G::NIT + ((r + it) & (G::NIT - 1));
      const uint4 gv = lds128(prm + c * 16), bv = lds128(prm + C * 2 + c * 16);
      const uint32_t *u = &v[it].x, *gu = &gv.x, *bu = &bv.x;
      uint4 h;
      uint32_t* hu = &h.x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = unpack(u[j]), ga = unpack(gu[j]), be = unpack(bu[j]);
        const float h0 = fmaxf((x.x - mean) * (rstd * ga.x) + be.x, 0.f);
        const float h1 = fmaxf((x.y - mean) * (rstd * ga.y) + be.y, 0.f);
        hu[j] = live ? pack_rn(h0, h1) : 0u;
      }
      sts128(gb + c * 128 + r * 16, h);
    }
  }
}

// The packed bfloat16 pairs of an m64 x NP accumulator block: pair 2j is
// row g, columns 8j + 2 tig, + 1; pair 2j + 1 the same columns of row g + 8
template <int NP>
__device__ __forceinline__ void pack_acc(const float* acc, uint32_t* z) {
#pragma unroll
  for (int i = 0; i < NP / 4; ++i) z[i] = pack_rn(acc[2 * i], acc[2 * i + 1]);
}

template <int C, bool GATE>
__global__ void __launch_bounds__(NT, 1) gate_tail_wgmma(
    const bf16* __restrict__ f, const bf16* __restrict__ out, const bf16* __restrict__ w,
    const bf16* __restrict__ g, const bf16* __restrict__ beta, bf16* __restrict__ y, int64_t P, int stages,
    float eps) {
  using G = Geo<C>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 127) & ~127u;
  const uint32_t bars = base, prm = base + BAR_BYTES, wsm = prm + PRM_BYTES, ring = wsm + C * C * 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);         // the producer's expect_tx
      mbar_init(bars + 64 + 8 * s, 128);  // every thread of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  bf16* prm_p = reinterpret_cast<bf16*>(smem_raw + (prm - raw));
  for (int i = tid; i < 2 * C; i += NT) prm_p[i] = i < C ? g[i] : beta[i - C];
  // W as the B operand: [n / 8][chunk][n % 8][16 bytes]; a phase of 8
  // lanes stores one core matrix
  for (int e = tid; e < C * G::NCH; e += NT) {
    const int c = (e >> 3) % G::NCH, n = ((e >> 3) / G::NCH) * 8 + (e & 7);
    sts128(wsm + core_off<C>(n, c), ldg128(w + n * C + c * 8));
  }
  __syncthreads();
  const int64_t tiles = (P + G::BP - 1) / G::BP;

  if (warp >= 8) {  // the producer's warpgroup: one thread issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      int i = 0;
      for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(bars + 64 + 8 * s, (i / stages - 1) & 1);
        const int64_t p0 = t * G::BP;
        const uint32_t bytes = (uint32_t)((P - p0 < G::BP ? P - p0 : G::BP) * C * 2);
        mbar_expect_tx(bars + 8 * s, bytes);
        bulk_load(ring + s * G::STAGE, f + p0 * C, bytes, bars + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");  // the producers' registers
  const int wg = warp >> 2, wq = warp & 3, ct = tid & 127;
  int i = wg;
  for (int64_t t = blockIdx.x + (int64_t)wg * gridDim.x; t < tiles; t += 2 * (int64_t)gridDim.x, i += 2) {
    const int s = i % stages;
    const uint32_t st = ring + s * G::STAGE;
    const int64_t p0 = t * G::BP;
    const int rows = (int)(P - p0 < G::BP ? P - p0 : G::BP);
    // the tile's rows of out: in flight while the tile is worked where the
    // registers allow; at C = 256 (the accumulators of two passes) after the
    // products, where the other consumer's work hides them
    uint4 o[GATE ? G::EPI : 1];
    auto load_out = [&]() {
#pragma unroll
      for (int k = 0; k < G::EPI; ++k) {
        const int e = ct + k * 128, R = e / G::NCH, c = e % G::NCH;
        o[k] = R < rows ? ldg128(out + (p0 + R) * C + c * 8) : make_uint4(0u, 0u, 0u, 0u);
      }
    };
    if constexpr (GATE && C < 256) load_out();
    mbar_wait(bars + 8 * s, (i / stages) & 1);
    ln_tile<C>(st, prm, rows, eps, wq, lane);
    fence_async_smem();  // the A operand, seen by the tensor cores
    named_sync(1 + wg, 128);

    float acc[G::MB][G::NP / 2];
    uint32_t zp[G::NPASS][G::MB][G::NP / 4];
#pragma unroll
    for (int pass = 0; pass < G::NPASS; ++pass) {
#pragma unroll
      for (int mb = 0; mb < G::MB; ++mb)
#pragma unroll
        for (int j = 0; j < G::NP / 2; ++j) acc[mb][j] = 0.f;
#pragma unroll
      for (int mb = 0; mb < G::MB; ++mb) fence_acc<G::NP / 2>(acc[mb]);
      wgmma_fence();
#pragma unroll
      for (int mb = 0; mb < G::MB; ++mb)
#pragma unroll
        for (int ks = 0; ks < G::KS; ++ks)
          wgmma_ss<G::NP>(acc[mb], desc(st + mb * 8 * G::GROUP + ks * 256, 128, G::GROUP),
                          desc(wsm + pass * (G::NP / 8) * G::GROUP + ks * 256, 128, G::GROUP));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < G::MB; ++mb) fence_acc<G::NP / 2>(acc[mb]);
#pragma unroll
      for (int mb = 0; mb < G::MB; ++mb) pack_acc<G::NP>(acc[mb], zp[pass][mb]);
    }
    named_sync(1 + wg, 128);  // every warp's products have read the tile

    // z over the tile: stmatrix x4 of the column groups j, j + 1 (rows g and g + 8)
    const int m = lane >> 3;
#pragma unroll
    for (int pass = 0; pass < G::NPASS; ++pass)
#pragma unroll
      for (int mb = 0; mb < G::MB; ++mb)
#pragma unroll
        for (int j = 0; j < G::NP / 8; j += 2) {
          const int R = mb * 64 + wq * 16 + (m & 1) * 8 + (lane & 7);
          const int c = pass * (G::NP / 8) + j + (m >> 1);
          const uint32_t* z = zp[pass][mb];
          stsm_x4(st + z_off<C>(R, c), z[2 * j], z[2 * j + 1], z[2 * j + 2], z[2 * j + 3]);
        }
    named_sync(1 + wg, 128);

    if constexpr (GATE && C == 256) load_out();
    // whole rows: the gate and y, 16 bytes a thread
#pragma unroll
    for (int k = 0; k < G::EPI; ++k) {
      const int e = ct + k * 128, R = e / G::NCH, c = e % G::NCH;
      if (R < rows) {
        uint4 v = lds128(st + z_off<C>(R, c));
        if constexpr (GATE) {
          v.x = gate2(v.x, o[k].x);
          v.y = gate2(v.y, o[k].y);
          v.z = gate2(v.z, o[k].z);
          v.w = gate2(v.w, o[k].w);
        }
        *reinterpret_cast<uint4*>(y + (p0 + R) * C + c * 8) = v;
      }
    }
    fence_async_smem();  // this thread's writes to the stage, before the producer's next copy
    mbar_arrive(bars + 64 + 8 * s);
  }
}

template <int C, bool GATE>
int launch_bf16(const void* f, const void* out, const void* w, const void* g, const void* beta, void* y,
                int64_t P, int stages, int grid, float eps, cudaStream_t stream) {
  const int bytes = 128 + BAR_BYTES + PRM_BYTES + C * C * 2 + stages * Geo<C>::STAGE;
  if (stages < 2 || stages > MAX_STAGES || bytes > SMEM_MAX || grid < 1) return (int)cudaErrorInvalidValue;
  auto kern = gate_tail_wgmma<C, GATE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, NT, bytes, stream>>>((const bf16*)f, (const bf16*)out, (const bf16*)w, (const bf16*)g,
                                    (const bf16*)beta, (bf16*)y, P, stages, eps);
  return (int)cudaGetLastError();
}

template <int C>
int dispatch_bf16(const void* f, const void* out, const void* w, const void* g, const void* beta, void* y,
                  int64_t P, int stages, int grid, float eps, cudaStream_t s) {
  return out != nullptr ? launch_bf16<C, true>(f, out, w, g, beta, y, P, stages, grid, eps, s)
                        : launch_bf16<C, false>(f, out, w, g, beta, y, P, stages, grid, eps, s);
}

// ---------------------------------------------------------------- float32

constexpr int F32_WARPS = 8;  // warps per block

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// 8 consecutive elements (16-byte aligned) into registers
__device__ __forceinline__ void load8(const float* p, float x[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w; x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
template <typename T> struct Cfg;
template <> struct Cfg<float> { static constexpr int BP = 32; static constexpr int PAD = 1; };  // rows a tile

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

template <int C>
__global__ void __launch_bounds__(F32_WARPS * 32) gate_tail_f32(
    const float* __restrict__ f, const float* __restrict__ out, const float* __restrict__ w,
    const float* __restrict__ g, const float* __restrict__ beta, float* __restrict__ y, int64_t P,
    float eps) {
  constexpr int BP = Cfg<float>::BP, HP = C + 1;
  constexpr int NWARPS = F32_WARPS, NT = NWARPS * 32;
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

template <int C>
int launch_f32(const void* f, const void* out, const void* w, const void* g, const void* beta, void* y,
               int64_t P, float eps, cudaStream_t stream) {
  auto kern = gate_tail_f32<C>;
  const size_t bytes = (size_t)Cfg<float>::BP * (C + 1) * 4;
  constexpr int NTH = F32_WARPS * 32;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NTH, bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (P + Cfg<float>::BP - 1) / Cfg<float>::BP;
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(tiles < cap ? tiles : cap);
  kern<<<blocks, NTH, bytes, stream>>>((const float*)f, (const float*)out, (const float*)w, (const float*)g,
                                       (const float*)beta, (float*)y, P, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// f, out, y: (P, C) contiguous, 16-byte aligned; out null for gate off;
// w: (C, C) [out][in] (16-byte aligned in bfloat16); g, beta: (C,)
// LayerNorm scale and bias. bfloat16 takes the ring's stages and the grid
// from ops/gated.launch_plan; float32 ignores them.
extern "C" int prv2_gate_tail(const void* f, const void* out, const void* w, const void* g,
                              const void* beta, void* y, long long P, long long C, long long stages,
                              long long grid, float eps, int dtype, void* stream) {
  if (P == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    switch (C) {
      case 32: return dispatch_bf16<32>(f, out, w, g, beta, y, P, (int)stages, (int)grid, eps, s);
      case 128: return dispatch_bf16<128>(f, out, w, g, beta, y, P, (int)stages, (int)grid, eps, s);
      case 256: return dispatch_bf16<256>(f, out, w, g, beta, y, P, (int)stages, (int)grid, eps, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    switch (C) {
      case 32: return launch_f32<32>(f, out, w, g, beta, y, P, eps, s);
      case 128: return launch_f32<128>(f, out, w, g, beta, y, P, eps, s);
      case 256: return launch_f32<256>(f, out, w, g, beta, y, P, eps, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
