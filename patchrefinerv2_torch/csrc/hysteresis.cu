// K12: the bounded hysteresis of the training losses' canny edges.
//
// Replaces patchrefinerv2_tpu/models/losses_extra.py:129-134, the
// `fori_loop` of `canny_edges_graph` that runs 128 times
// `out = low & _dilate3x3(out)` (:81, zeros outside the map) from the high
// mask. It grows the high mask at most 128 pixels along a weak chain, and
// both kernels below compute exactly that, longer chains included.
//
// Bound: not by bytes (two masks read and one written, a byte a pixel, take
// 0.7 microseconds at the loss's (4, 384, 512)) but by the latency of up to
// 128 dependent steps, each of which needs the whole plane's previous step,
// and by the bytes one SM can move.
//
// The resident kernel (a plane up to 1024 pixels wide that one CTA holds):
// one launch, a cluster of CL CTAs a plane.
//   1. Every CTA of the cluster reads a share of the plane's rows of both
//      masks (16-byte loads), packs them into 32-pixel words (bit j of word
//      c is pixel 32 c + j) and writes the words into the shared memory of
//      the cluster's first CTA, the leader (distributed shared memory), so
//      that CL SMs, not one, move the plane's bytes.
//   2. The leader runs the steps. Thread t keeps a strip of R consecutive
//      rows of one word column, of both masks, in registers, and each row
//      dilated along the row (`h`). The lanes of a warp hold the words of a
//      row side by side (a segment of `seg` lanes, the row's words rounded
//      up to a power of two; 32 / seg bands of rows a warp), so the row
//      dilation's carries come by __shfl from the neighbouring lanes and a
//      strip's vertical neighbours from registers; only the rows just above
//      and below a strip pass through shared memory (double buffered: one
//      barrier a step). A thread recomputes only the rows next to a row
//      that changed in the previous step in some lane of its warp (whose
//      dilation may then differ) and its first / last row when the row
//      above / below it changed: a step is a function of its inputs, so a
//      row whose inputs did not change would keep its value (exact). The
//      barrier carries the OR of the warps' changes (__syncthreads_or): once
//      a step changes no word of the plane, no later step will (`low` is
//      fixed and a step is a function of the current mask), so the loop
//      ends there, never after `steps` steps, with no host sync and no host
//      decision. The other CTAs wait at the cluster barrier.
//   3. Every CTA unpacks its share of the result from the leader's shared
//      memory and writes it (16-byte stores).
// The plan (CL, R, warps) is the wrapper's (ops/canny.hysteresis_plan); the
// index of the first step that changed nothing can be written to
// `exit_steps`.
//
// The tiled kernel (planes too wide or too tall to be resident): a block
// stages its region of the low mask and of the current mask in shared
// memory, a word a thread: the inner tile of TW words x TH rows with a halo
// of one word left and right and S rows above and below. It then runs up to
// S steps there: after s <= S steps a pixel depends only on pixels at most s
// away, so the inner tile is exact and the halo is discarded. The host
// launches ceil(steps / S) times, ping-ponging two device masks so that the
// last launch writes the output; every step runs.
//
// The floor kernel runs a loop's barriers and no work: with one CTA, the
// resident kernel's (the latency its chain of dependent steps costs); with
// a cluster, the cluster barrier and flags that steps shared by the
// cluster's CTAs would cost.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_WORDS = 32;  // resident planes: at most 32 words (1024 pixels) a row

// ---------------------------------------------------------------- resident kernel

// 4 bytes (each zero or not) -> 4 bits
__device__ __forceinline__ uint32_t pack4(uint32_t v) {
  v |= v >> 4;
  v |= v >> 2;
  v |= v >> 1;  // bit 0 of each byte: the OR of its bits
  return (((v & 0x01010101u) * 0x00204081u) >> 21) & 0xFu;
}

// 4 bits -> 4 bytes of 0 or 1
__device__ __forceinline__ uint32_t unpack4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// 16 bytes -> 16 bits
__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return pack4(v.x) | pack4(v.y) << 4 | pack4(v.z) << 8 | pack4(v.w) << 12;
}

// the word of pixels x0 .. x0 + 31 of a row (0 past W); `fast`: all 32 lie
// in the row and start 16-byte aligned
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int64_t x0, int64_t W,
                                              bool fast) {
  const uint8_t* q = row + x0;
  if (fast) {
    const uint4* v = reinterpret_cast<const uint4*>(q);
    return pack16(__ldg(v)) | pack16(__ldg(v + 1)) << 16;
  }
  uint32_t m = 0;
#pragma unroll 1
  for (int j = 0; j < 32 && x0 + j < W; ++j) m |= (q[j] != 0 ? 1u : 0u) << j;
  return m;
}

__device__ __forceinline__ void store_word(uint8_t* row, int64_t x0, int64_t W, uint32_t m,
                                           bool fast) {
  uint8_t* q = row + x0;
  if (fast) {
    reinterpret_cast<uint4*>(q)[0] = make_uint4(unpack4(m & 0xFu), unpack4(m >> 4 & 0xFu),
                                                unpack4(m >> 8 & 0xFu), unpack4(m >> 12 & 0xFu));
    reinterpret_cast<uint4*>(q)[1] = make_uint4(unpack4(m >> 16 & 0xFu), unpack4(m >> 20 & 0xFu),
                                                unpack4(m >> 24 & 0xFu), unpack4(m >> 28));
    return;
  }
#pragma unroll 1
  for (int j = 0; j < 32 && x0 + j < W; ++j) q[j] = (uint8_t)(m >> j & 1u);
}

// A word dilated along its row: each pixel ORed with its left and right
// neighbours, the carries from the words of lanes c - 1 and c + 1 of the
// segment. At the segment's ends __shfl returns the lane's own word, which
// lm and rm clear (zeros outside the map).
__device__ __forceinline__ uint32_t hdil(uint32_t w, int seg, uint32_t lm, uint32_t rm) {
  const uint32_t l = __shfl_up_sync(FULL, w, 1, seg) & lm;
  const uint32_t r = __shfl_down_sync(FULL, w, 1, seg) & rm;
  return w | __funnelshift_l(l, w, 1) | __funnelshift_r(w, r, 1);
}

// The leader's steps over the packed plane in `stage` ([2][H * seg]: low,
// then the mask, which gets the result). Thread t holds rows y0 .. y0 + R - 1
// of word column c, y0 = (t / seg) * R, c = t % seg. edge[p][t].x / .y: h of
// the row above / below thread t's strip, written by the threads holding
// them into buffer p = s & 1 in step s (zero at the plane's top and bottom).
// Returns the index of the first step that changed nothing (`steps` if each
// one did).
template <int R>
__device__ __forceinline__ int run_steps(uint32_t* stage, uint2 (*edge)[MAX_THREADS], int64_t H,
                                         int seg, int steps) {
  constexpr uint32_t ALL = (1u << R) - 1u, LAST = 1u << (R - 1);
  const int nt = blockDim.x, t = threadIdx.x, c = t & (seg - 1);
  const uint32_t lm = c > 0 ? FULL : 0u, rm = c < seg - 1 ? FULL : 0u;
  const int64_t words = H * seg, y0 = (int64_t)(t / seg) * R;
  edge[0][t] = edge[1][t] = make_uint2(0u, 0u);
  uint32_t lo[R], cur[R], h[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool in = y0 + i < H;
    lo[i] = in ? stage[(y0 + i) * seg + c] : 0u;
    cur[i] = in ? stage[words + (y0 + i) * seg + c] : 0u;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) h[i] = hdil(cur[i], seg, lm, rm);
  __syncthreads();

  uint32_t rows = ALL, up = 0u, down = 0u;  // rows: those that changed in some lane of the warp
  int exit_step = steps;
  for (int s = 0;; ++s) {
    const int p = s & 1;
    if (t >= seg) edge[p][t - seg].y = h[0];  // the strip above sees our first row
    if (t + seg < nt) edge[p][t + seg].x = h[R - 1];
    if (!__syncthreads_or(rows != 0u)) {
      exit_step = s - 1;  // step s - 1 changed no word of the plane
      break;
    }
    if (s == steps) break;
    const uint2 e = edge[p][t];
    uint32_t need = rows | rows << 1 | rows >> 1;
    need = (need | (e.x != up ? 1u : 0u) | (e.y != down ? LAST : 0u)) & ALL;
    up = e.x;
    down = e.y;
    rows = 0u;
    if (__any_sync(FULL, need != 0u)) {
      uint32_t mine = 0u;  // out = low & (the rows above, at and below, each dilated along the row)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (need & (1u << i)) {
          const uint32_t above = i > 0 ? h[i - 1] : e.x, below = i + 1 < R ? h[i + 1] : e.y;
          const uint32_t v = lo[i] & (above | h[i] | below);
          mine |= v != cur[i] ? 1u << i : 0u;
          cur[i] = v;
        }
      }
      rows = __reduce_or_sync(FULL, mine);
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (rows & (1u << i)) h[i] = hdil(cur[i], seg, lm, rm);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (y0 + i < H) stage[words + (y0 + i) * seg + c] = cur[i];
  return exit_step;
}

// A cluster a plane (blockIdx.x / cluster size); CTA `rank` reads and
// writes rows [rank * per, (rank + 1) * per) of it, per = ceil(H / CTAs).
template <int R>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    hysteresis_resident_kernel(const uint8_t* __restrict__ low, const uint8_t* __restrict__ high,
                               uint8_t* __restrict__ out, int* __restrict__ exit_steps, int64_t H,
                               int64_t W, int seg, int steps) {
  extern __shared__ uint32_t stage[];  // the leader's: [2][H * seg] words
  __shared__ uint2 edge[2][MAX_THREADS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ctas = (int)cluster.num_blocks();
  const int nt = blockDim.x, t = threadIdx.x, shift = __ffs(seg) - 1;
  const int64_t plane = blockIdx.x / ctas, words = H * seg, per = (H + ctas - 1) / ctas;
  const int64_t k0 = min(H, rank * per) * seg, k1 = min(H, (rank + 1) * per) * seg;
  const uint8_t* lp = low + plane * H * W;
  const uint8_t* hp = high + plane * H * W;
  uint8_t* op = out + plane * H * W;
  const bool aligned = ((reinterpret_cast<uintptr_t>(lp) | reinterpret_cast<uintptr_t>(hp) |
                         reinterpret_cast<uintptr_t>(op) | (uintptr_t)W) & 15) == 0;
  uint32_t* lead = cluster.map_shared_rank(stage, 0);
  for (int64_t k = k0 + t; k < k1; k += nt) {
    const int64_t y = k >> shift, x0 = 32 * (k & (seg - 1));
    uint32_t l = 0u, m = 0u;
    if (x0 < W) {
      const bool fast = aligned && x0 + 32 <= W;
      l = load_word(lp + y * W, x0, W, fast);
      m = load_word(hp + y * W, x0, W, fast);
    }
    lead[k] = l;
    lead[words + k] = m;
  }
  cluster.sync();
  if (rank == 0) {
    const int exit_step = run_steps<R>(stage, edge, H, seg, steps);
    if (exit_steps != nullptr && t == 0) exit_steps[plane] = exit_step;
  }
  cluster.sync();
  for (int64_t k = k0 + t; k < k1; k += nt) {
    const int64_t y = k >> shift, x0 = 32 * (k & (seg - 1));
    if (x0 < W) store_word(op + y * W, x0, W, lead[words + k], aligned && x0 + 32 <= W);
  }
  cluster.sync();  // the leader's shared memory stays until every CTA has read it
}

// `steps` + 1 barriers and no work: __syncthreads_or in a CTA (CL == 1), or
// in a cluster the flags and cluster barrier that end a step shared by its
// CTAs: each warp that changed a word pushes a flag into exitf[s % 3] of
// every CTA, the cluster barrier (release / acquire) makes them visible, and
// thread 0 clears exitf[(s + 2) % 3], which nobody touches until after the
// next barrier.
template <int CL>
__global__ void __launch_bounds__(MAX_THREADS, 1) hysteresis_floor_kernel(int* sink, int steps) {
  __shared__ int exitf[3];
  const int t = threadIdx.x;
  if (t < 3) exitf[t] = t == 0;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  int s = 0;
  for (;; ++s) {
    bool any;
    if constexpr (CL == 1) {
      any = __syncthreads_or(1) != 0;
    } else {
      if ((t & 31) == 0) {
#pragma unroll
        for (int r = 0; r < CL; ++r) *cluster.map_shared_rank(&exitf[s % 3], r) = 1;
      }
      cluster.sync();
      any = *reinterpret_cast<volatile int*>(&exitf[s % 3]) != 0;
    }
    if (!any || s == steps) break;
    if (CL > 1 && t == 0) exitf[(s + 2) % 3] = 0;
  }
  cluster.sync();
  if (sink != nullptr && t == 0 && blockIdx.x == 0) *sink = s;
}

// a launch of `planes` clusters of `cl` CTAs with `smem` bytes of dynamic
// shared memory (opted in: with the static shared memory it may pass 48 KB)
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int cl, long long planes, int threads, size_t smem,
                   cudaStream_t s, Args... args) {
  if (smem > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(planes * cl));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------- tiled kernel

constexpr int S = 32;           // steps a launch runs at most = the halo in rows (and <= 32 pixels)
constexpr int TW = 4;           // inner tile width in 32-pixel words (128 pixels)
constexpr int TH = 64;          // inner tile height in rows
constexpr int RW = TW + 2;      // region width in words
constexpr int RH = TH + 2 * S;  // region height in rows
constexpr int NW = RW * RH;     // region words
constexpr int THREADS = NW;     // a thread a word: a step's latency is one word's
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
    hysteresis_tiled_kernel(const uint8_t* __restrict__ low, const uint8_t* __restrict__ src,
                            uint8_t* __restrict__ dst, int64_t H, int64_t W, int steps) {
  __shared__ uint32_t lo[NW];
  __shared__ uint32_t buf[2][NW];
  const int64_t plane = H * W;
  const uint8_t* lp = low + (int64_t)blockIdx.z * plane;
  const uint8_t* sp = src + (int64_t)blockIdx.z * plane;
  const int64_t y0 = (int64_t)blockIdx.y * TH - S;         // the region's first row
  const int64_t x0 = (int64_t)blockIdx.x * TW * 32 - 32;   // the region's first column
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < NW; k += WARPS) {  // one warp ballot a word, 0 outside the map
    const int64_t y = y0 + k / RW, x = x0 + 32 * (k % RW) + lane;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const int64_t off = y * W + x;
    const uint32_t l = __ballot_sync(FULL, in && lp[off] != 0);
    const uint32_t m = __ballot_sync(FULL, in && sp[off] != 0);
    if (lane == 0) {
      lo[k] = l;
      buf[0][k] = m;
    }
  }
  __syncthreads();
  int cur = 0;
  for (int s = 0; s < steps; ++s) {
    const uint32_t* b = buf[cur];
    for (int k = threadIdx.x; k < NW; k += THREADS) {
      const int r = k / RW, c = k % RW;
      uint32_t acc = 0;
#pragma unroll
      for (int dr = -1; dr <= 1; ++dr) {
        const int rr = r + dr;
        if (rr < 0 || rr >= RH) continue;
        const int i = rr * RW + c;
        const uint32_t w = b[i];
        const uint32_t left = c > 0 ? b[i - 1] : 0u;
        const uint32_t right = c < RW - 1 ? b[i + 1] : 0u;
        // bit j is pixel x0 + 32 c + j: (w << 1) brings each pixel's left
        // neighbour, (w >> 1) its right one, the carries the words' edges
        acc |= w | (w << 1) | (w >> 1) | (left >> 31) | (right << 31);
      }
      buf[cur ^ 1][k] = lo[k] & acc;
    }
    __syncthreads();
    cur ^= 1;
  }
  uint8_t* dp = dst + (int64_t)blockIdx.z * plane;
  for (int k = warp; k < TW * TH; k += WARPS) {
    const int r = S + k / TW, c = 1 + k % TW;
    const int64_t y = y0 + r, x = x0 + 32 * c + lane;
    if (y < H && x < W) dp[y * W + x] = (uint8_t)((buf[cur][r * RW + c] >> lane) & 1u);
  }
}

int next_pow2(int64_t n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <int R>
cudaError_t launch_resident(int cl, long long B, int threads, size_t smem, cudaStream_t s,
                            const uint8_t* low, const uint8_t* high, uint8_t* out, int* exit_steps,
                            int64_t H, int64_t W, int seg, int steps) {
  return launch(hysteresis_resident_kernel<R>, cl, B, threads, smem, s, low, high, out, exit_steps,
                H, W, seg, steps);
}

}  // namespace

// low, high: bool masks (one byte a pixel, 0 or 1), (B, H, W); out gets the
// result. steps >= 1. cluster 0: the tiled kernel (tmp: (B, H, W) bytes of
// scratch; exit_steps unused). cluster 1 to 8: the resident kernel, that
// many CTAs a plane, of `warps` warps, the leader's threads holding `rows`
// rows each, which must cover the plane (W <= 1024); exit_steps, if not
// null, gets for each plane the index of the first step that changed
// nothing (`steps` if each one did), int32. dtype is unused (the masks are
// bytes).
extern "C" int prv2_hysteresis_bounded(const void* low, const void* high, void* out, void* tmp,
                                       void* exit_steps, long long B, long long H, long long W,
                                       long long steps, long long cluster, long long rows,
                                       long long warps, int dtype, void* stream) {
  (void)dtype;
  if (B == 0 || H == 0 || W == 0) return 0;
  if (steps < 1 || steps > (1LL << 30)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t *lp = (const uint8_t*)low, *hp = (const uint8_t*)high;
  if (cluster == 0) {
    if (B > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((W + TW * 32 - 1) / (TW * 32)), (unsigned)((H + TH - 1) / TH),
                    (unsigned)B);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const long long n = (steps + S - 1) / S;
    const uint8_t* src = hp;
    for (long long i = 0; i < n; ++i) {
      uint8_t* d = ((n - 1 - i) % 2 == 0) ? (uint8_t*)out : (uint8_t*)tmp;
      const int run = (int)(steps - i * S < S ? steps - i * S : S);
      hysteresis_tiled_kernel<<<grid, THREADS, 0, s>>>(lp, src, d, H, W, run);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      src = d;
    }
    return 0;
  }
  const int seg = next_pow2((W + 31) / 32);
  if (W > 32LL * MAX_WORDS || cluster < 1 || cluster > 8 || warps < 1 || warps > MAX_WARPS ||
      B * cluster > 0x7fffffffLL || (warps * 32 / seg) * rows < H)
    return (int)cudaErrorInvalidValue;
  const int threads = (int)warps * 32, cl = (int)cluster, st = (int)steps;
  const size_t smem = 2 * (size_t)H * seg * sizeof(uint32_t);
  uint8_t* o = (uint8_t*)out;
  int* e = (int*)exit_steps;
  cudaError_t err;
  switch (rows) {  // the rows a thread holds: ops/canny.RESIDENT_ROWS
    case 2: err = launch_resident<2>(cl, B, threads, smem, s, lp, hp, o, e, H, W, seg, st); break;
    case 4: err = launch_resident<4>(cl, B, threads, smem, s, lp, hp, o, e, H, W, seg, st); break;
    case 6: err = launch_resident<6>(cl, B, threads, smem, s, lp, hp, o, e, H, W, seg, st); break;
    case 8: err = launch_resident<8>(cl, B, threads, smem, s, lp, hp, o, e, H, W, seg, st); break;
    case 12: err = launch_resident<12>(cl, B, threads, smem, s, lp, hp, o, e, H, W, seg, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The latency floor: B clusters of `cluster` CTAs of `warps` warps running
// `steps` + 1 barriers of the floor kernel and no work; sink (int32, may be
// null) gets the steps run.
extern "C" int prv2_hysteresis_floor(void* sink, long long B, long long steps, long long cluster,
                                     long long warps, int dtype, void* stream) {
  (void)dtype;
  if (B < 1 || steps < 0 || warps < 1 || warps > MAX_WARPS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = (int)warps * 32, st = (int)steps;
  int* k = (int*)sink;
  switch (cluster) {
    case 1: return (int)launch(hysteresis_floor_kernel<1>, 1, B, threads, 0, s, k, st);
    case 2: return (int)launch(hysteresis_floor_kernel<2>, 2, B, threads, 0, s, k, st);
    case 4: return (int)launch(hysteresis_floor_kernel<4>, 4, B, threads, 0, s, k, st);
    case 8: return (int)launch(hysteresis_floor_kernel<8>, 8, B, threads, 0, s, k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
