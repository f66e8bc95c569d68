// K12: the bounded hysteresis of the training losses' canny edges.
//
// Replaces patchrefinerv2_tpu/models/losses_extra.py:129-134, the
// `fori_loop` of `canny_edges_graph` that runs 128 times
// `out = low & _dilate3x3(out)` (:81, zeros outside the map) from the high
// mask. It grows the high mask at most 128 pixels along a weak chain, and
// the kernel computes exactly that, longer chains included.
//
// Design: the masks are bits. A block stages its region of the low mask and
// of the current mask in shared memory, 32 pixels of a row to a 32-bit word
// (one warp ballot per word, reading 0 outside the map): the inner tile of
// TW words x TH rows with a halo of one word (32 pixels) left and right and
// S rows above and below. It then runs up to S steps there, a word a thread
// at a time: the 3x3 dilation is three shifted ORs of the row (the carries
// from the neighbouring words) over three rows, ANDed with the low word,
// ping-ponging two buffers with one __syncthreads a step (a thread a word,
// so that a step costs one word's shared-memory latency). After s <= S steps
// a pixel depends only on pixels at most s away, so the inner tile is exact
// and the halo is discarded. The host launches ceil(steps / S) times,
// ping-ponging two device masks so that the last launch writes the output;
// no host sync and no early exit. It is bound by the latency of its 128
// dependent steps (a __syncthreads and a few shared-memory loads each), not
// by bytes: the two masks read and the one written, a byte a pixel, would
// take 0.7 microseconds at the loss's (4, 384, 512).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S = 32;           // steps a launch runs at most = the halo in rows (and <= 32 pixels)
constexpr int TW = 4;           // inner tile width in 32-pixel words (128 pixels)
constexpr int TH = 64;          // inner tile height in rows
constexpr int RW = TW + 2;      // region width in words
constexpr int RH = TH + 2 * S;  // region height in rows
constexpr int NW = RW * RH;     // region words
constexpr int THREADS = NW;     // a thread a word: a step's latency is one word's (256: 1.5x slower)
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
    hysteresis_kernel(const uint8_t* __restrict__ low, const uint8_t* __restrict__ src,
                      uint8_t* __restrict__ dst, int64_t H, int64_t W, int steps) {
  __shared__ uint32_t lo[NW];
  __shared__ uint32_t buf[2][NW];
  const int64_t plane = H * W;
  const uint8_t* lp = low + (int64_t)blockIdx.z * plane;
  const uint8_t* sp = src + (int64_t)blockIdx.z * plane;
  const int64_t y0 = (int64_t)blockIdx.y * TH - S;         // the region's first row
  const int64_t x0 = (int64_t)blockIdx.x * TW * 32 - 32;   // the region's first column
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < NW; k += WARPS) {
    const int64_t y = y0 + k / RW, x = x0 + 32 * (k % RW) + lane;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const int64_t off = y * W + x;
    const uint32_t l = __ballot_sync(0xffffffffu, in && lp[off] != 0);
    const uint32_t m = __ballot_sync(0xffffffffu, in && sp[off] != 0);
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

}  // namespace

// low, high: bool masks (one byte a pixel, 0 or 1), (B, H, W); out and tmp:
// (B, H, W) bytes, out gets the result and tmp is scratch. steps >= 1.
// dtype is unused (the masks are bytes).
extern "C" int prv2_hysteresis_bounded(const void* low, const void* high, void* out, void* tmp,
                                       long long B, long long H, long long W, long long steps,
                                       int dtype, void* stream) {
  (void)dtype;
  if (B == 0 || H == 0 || W == 0) return 0;
  if (B > 65535 || steps < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((W + TW * 32 - 1) / (TW * 32)), (unsigned)((H + TH - 1) / TH),
                  (unsigned)B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (steps + S - 1) / S;
  const uint8_t* src = (const uint8_t*)high;
  for (long long i = 0; i < n; ++i) {
    uint8_t* d = ((n - 1 - i) % 2 == 0) ? (uint8_t*)out : (uint8_t*)tmp;
    const int run = (int)(steps - i * S < S ? steps - i * S : S);
    hysteresis_kernel<<<grid, THREADS, 0, s>>>((const uint8_t*)low, src, d, H, W, run);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = d;
  }
  return 0;
}
