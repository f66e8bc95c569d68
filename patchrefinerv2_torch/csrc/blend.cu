// K7: tile blending into the three float32 canvases (mosaic, sum_wp, sum_w)
// and the final average.
//
// Replaces patchrefinerv2_tpu/ops/blend.py:54 `TileBlender.add_pass` (a
// lax.scan of dynamic_update_slice over the patches, one patch after the
// other) and :113 `finalize`.
//
// add_pass: patches overlap inside an m2 chunk, so a thread per patch pixel
// would race on the canvas. This kernel stays deterministic without atomics:
// each canvas pixel is owned by one thread, which adds, for each patch that
// covers it in patch order, p * mask * valid to sum_wp and mask * valid to
// sum_w, and writes p to the mosaic where the patch is an init patch. The
// sums are taken in patch order, the order of the reference's scan, so the
// result does not depend on scheduling. It is bound by bytes (the covered
// part of the canvases read and written once, each prediction and the mask
// read once). A block owns a TH x TW canvas tile: its first warp tests the
// n patch starts against the tile and compacts the overlapping patches, in
// patch order, into a list in shared memory (ballot and prefix, 32 patches
// a step; a list holds LIST_CAP, and longer ones are taken in pieces); a
// tile that no patch overlaps exits. Each thread then owns 4 adjacent
// pixels in each of ROWS rows of the tile: 16-byte canvas loads and stores
// where the canvas width is a multiple of 4 and the canvases are aligned
// (scalar otherwise), loaded on the first patch that covers the quad and
// stored once after the last; the mosaic only where the tile has an init
// patch. Predictions and the mask are read element by element, neighbouring
// threads on neighbouring elements (the patch offsets are arbitrary in rN).
// Offsets are 32-bit (the wrapper checks the sizes).
//
// finalize: elementwise where(sum_w > 0, sum_wp / max(sum_w, 1e-12), mosaic).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TW = 128, TH = 32, THREADS = 256, ROWS = TH / (THREADS / 32), LIST_CAP = 32;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__global__ void __launch_bounds__(THREADS) blend_add_kernel(
    float* __restrict__ mosaic, float* __restrict__ swp, float* __restrict__ sw, const T* __restrict__ preds,
    const float* __restrict__ mask, const int* __restrict__ starts, const float* __restrict__ valid,
    const float* __restrict__ initv, int n, int h, int w, int RH, int RW, int vec) {
  __shared__ int4 lst[LIST_CAP];  // (patch, start y, start x, init)
  __shared__ float lval[LIST_CAP];
  __shared__ int s_cnt, s_next, s_init;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  auto overlaps = [&](int k, int& sy, int& sx) {
    sy = __ldg(starts + 2 * k);
    sx = __ldg(starts + 2 * k + 1);
    return sy < ty0 + TH && sy + h > ty0 && sx < tx0 + TW && sx + w > tx0;
  };
  if (warp == 0) {  // does any patch overlap the tile, and any init patch?
    unsigned any = 0, init = 0;
    for (int k0 = 0; k0 < n; k0 += 32) {
      int sy, sx;
      const int k = k0 + lane;
      const bool ov = k < n && overlaps(k, sy, sx);
      any |= __ballot_sync(0xffffffffu, ov);
      init |= __ballot_sync(0xffffffffu, ov && __ldg(initv + k) > 0.0f);
    }
    if (lane == 0) {
      s_cnt = any != 0;
      s_init = init != 0;
    }
  }
  __syncthreads();
  if (!s_cnt) return;
  const bool has_init = s_init;
  const int x0 = tx0 + 4 * lane;
  const bool mine = x0 < RW;
  float a[ROWS][4], b[ROWS][4], mo[ROWS][4];
  bool touched[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) touched[i] = false;

  for (int k0 = 0;;) {
    __syncthreads();  // the last piece's list has been read
    if (warp == 0) {  // the next piece: whole steps of 32 patches while they fit
      int cnt = 0, k = k0;
      for (; k < n; k += 32) {
        int sy = 0, sx = 0;
        const int kk = k + lane;
        const bool ov = kk < n && overlaps(kk, sy, sx);
        const unsigned bal = __ballot_sync(0xffffffffu, ov);
        if (cnt + __popc(bal) > LIST_CAP) break;
        if (ov) {
          const int pos = cnt + __popc(bal & ((1u << lane) - 1u));
          lst[pos] = make_int4(kk, sy, sx, __ldg(initv + kk) > 0.0f);
          lval[pos] = __ldg(valid + kk);
        }
        cnt += __popc(bal);
      }
      if (lane == 0) {
        s_cnt = cnt;
        s_next = k;
      }
    }
    __syncthreads();
    const int cnt = s_cnt, next = s_next;
    for (int j = 0; j < cnt && mine; ++j) {
      const int4 e = lst[j];
      const int q0 = x0 - e.z;
      if (q0 + 3 < 0 || q0 >= w) continue;
      const float vk = lval[j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int yy = ty0 + warp + 8 * i, r = yy - e.y;
        if (r < 0 || r >= h || yy >= RH) continue;
        const int at = yy * RW + x0;
        if (!touched[i]) {
          touched[i] = true;
          if (vec) {
            const float4 va = *reinterpret_cast<const float4*>(swp + at);
            const float4 vb = *reinterpret_cast<const float4*>(sw + at);
            a[i][0] = va.x; a[i][1] = va.y; a[i][2] = va.z; a[i][3] = va.w;
            b[i][0] = vb.x; b[i][1] = vb.y; b[i][2] = vb.z; b[i][3] = vb.w;
            if (has_init) {
              const float4 vm = *reinterpret_cast<const float4*>(mosaic + at);
              mo[i][0] = vm.x; mo[i][1] = vm.y; mo[i][2] = vm.z; mo[i][3] = vm.w;
            }
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const bool in = x0 + u < RW;
              a[i][u] = in ? swp[at + u] : 0.0f;
              b[i][u] = in ? sw[at + u] : 0.0f;
              mo[i][u] = in && has_init ? mosaic[at + u] : 0.0f;
            }
          }
        }
        const T* pr = preds + ((int)e.x * h + r) * w;
        const float* mr = mask + r * w;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u;
          if (q < 0 || q >= w || x0 + u >= RW) continue;
          const float p = ld(pr + q);
          const float m = __fmul_rn(__ldg(mr + q), vk);
          a[i][u] = __fadd_rn(a[i][u], __fmul_rn(p, m));
          b[i][u] = __fadd_rn(b[i][u], m);
          if (e.w) mo[i][u] = p;
        }
      }
    }
    if (next >= n) break;
    k0 = next;
  }
  if (!mine) return;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (!touched[i]) continue;
    const int at = (ty0 + warp + 8 * i) * RW + x0;
    if (vec) {
      *reinterpret_cast<float4*>(swp + at) = make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
      *reinterpret_cast<float4*>(sw + at) = make_float4(b[i][0], b[i][1], b[i][2], b[i][3]);
      if (has_init) *reinterpret_cast<float4*>(mosaic + at) = make_float4(mo[i][0], mo[i][1], mo[i][2], mo[i][3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (x0 + u >= RW) continue;
        swp[at + u] = a[i][u];
        sw[at + u] = b[i][u];
        if (has_init) mosaic[at + u] = mo[i][u];
      }
    }
  }
}

__global__ void blend_finalize_kernel(const float* __restrict__ mosaic,
                                      const float* __restrict__ swp,
                                      const float* __restrict__ sw, float* __restrict__ out,
                                      int64_t total) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += step) {
    const float b = sw[idx];
    out[idx] = b > 0.0f ? __fdiv_rn(swp[idx], fmaxf(b, 1e-12f)) : mosaic[idx];
  }
}

int blocks_for(int64_t total, int threads) {
  int64_t b = (total + threads - 1) / threads;
  const int64_t cap = 132 * 32;
  return (int)(b < cap ? b : cap);
}

}  // namespace

// canvases (RH, RW) float32; preds (n, h, w) float32 or bfloat16; mask
// (h, w); starts (n, 2) int32; valid, initv (n,). Every offset fits 32 bits.
extern "C" int prv2_blend_add(void* mosaic, void* swp, void* sw, const void* preds,
                              const void* mask, const void* starts, const void* valid,
                              const void* initv, long long n, long long h, long long w,
                              long long RH, long long RW, int dtype, void* stream) {
  if (RH * RW == 0 || n == 0 || h == 0 || w == 0) return 0;
  const dim3 grid((unsigned)((RW + TW - 1) / TW), (unsigned)((RH + TH - 1) / TH));
  const int vec = RW % 4 == 0 && ((uintptr_t)mosaic | (uintptr_t)swp | (uintptr_t)sw) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    blend_add_kernel<float><<<grid, THREADS, 0, s>>>(
        (float*)mosaic, (float*)swp, (float*)sw, (const float*)preds, (const float*)mask,
        (const int*)starts, (const float*)valid, (const float*)initv, (int)n, (int)h, (int)w, (int)RH,
        (int)RW, vec);
  } else if (dtype == 1) {
    blend_add_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        (float*)mosaic, (float*)swp, (float*)sw, (const __nv_bfloat16*)preds, (const float*)mask,
        (const int*)starts, (const float*)valid, (const float*)initv, (int)n, (int)h, (int)w, (int)RH,
        (int)RW, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int prv2_blend_finalize(const void* mosaic, const void* swp, const void* sw,
                                   void* out, long long total, int dtype, void* stream) {
  if (total == 0) return 0;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  blend_finalize_kernel<<<blocks_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)mosaic, (const float*)swp, (const float*)sw, (float*)out, total);
  return (int)cudaGetLastError();
}
