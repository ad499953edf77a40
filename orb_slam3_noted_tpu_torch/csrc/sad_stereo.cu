// K4: stereo SAD.  Level-stacked pyramid atlases of the left and the right
// image, (B, HA, W) float32 each, and per left keypoint its level and its
// integer centre at that level (cv, cu) plus the matched right feature's
// column (cur), all (B, K) int32 -> (B, K, 11) float32: the sums of absolute
// differences between the 11x11 left patch and the 11 horizontal shifts
// (-5..+5 px) of the 11x21 right strip.
//
// Replaces the Pallas kernel `_sad_kernel` behind `sad_stereo_tpu` in
// orb_slam3_noted_tpu/ops/pallas_kernels.py.  What it computes is the
// float32 gather path of ops/stereo.py (`match_stereo`), clamping included:
// row  = clamp(cv + dy, 0, h[lvl] - 1) + off[lvl],
// cols = clamp(cu + dx, 0, w[lvl] - 1) and clamp(cur + dx, 0, w[lvl] - 1)
// with the unclamped centres.  The TPU kernel avoided the gather with
// aligned (24, 256) windows, one-hot matrix products for the row and lane
// selection, lane rolls and bf16 atlases; on this card a warp gathers
// directly, so none of that is carried over.
//
// Bound on the H100: launch latency.  A frame's 1200 keypoints read
// 1200 x 352 floats (1.7 MB, mostly L2 hits: neighbouring keypoints share
// rows), far below a microsecond of memory time, and the roofline bound lies
// under the duration of an empty kernel.  Design: one warp per keypoint,
// eight keypoints a 256-thread block (150 blocks for a frame), each warp with
// its own 352 floats of shared memory and `__syncwarp` as its only barrier.
// The gather goes by rows: lanes 0..20 hold the strip's 21 columns and lanes
// 21..31 the patch's 11, each clamps its column once, and eleven steps load
// one row each (the row clamped once a step), so nothing divides by 11 or 21
// per element.  The level's first row and size come from the device tables
// the matcher holds (a by-value table measured the same 0.00405 ms).  Each
// of the 11 sums keeps one order: lane i adds elements
// i, i + 32, i + 64, i + 96 in turn, then a fixed shuffle tree; the warp
// does the shifts one after the other.  So the result is the same from run
// to run, and the same bits as a block per keypoint with a warp per shift
// gave.
#include <cuda_runtime.h>

namespace {

constexpr int kHalf = 5;                   // 11x11 window
constexpr int kSlide = 5;                  // +-5 px
constexpr int kWin = 2 * kHalf + 1;        // 11
constexpr int kStrip = kWin + 2 * kSlide;  // 21
constexpr int kShifts = 2 * kSlide + 1;    // 11
constexpr int kWarps = 8;                  // keypoints a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTerms = kWin * kWin;        // 121 terms a sum
constexpr int kPerLane = (kTerms + 31) / 32;
static_assert(kStrip + kWin == 32, "one lane per gathered column");

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
sad_stereo_kernel(const float* __restrict__ atlas_l, const float* __restrict__ atlas_r,
                  const int* __restrict__ cv, const int* __restrict__ cu,
                  const int* __restrict__ cur, const int* __restrict__ lvl,
                  const int* __restrict__ off_t, const int* __restrict__ h_t,
                  const int* __restrict__ w_t, float* __restrict__ out,
                  int K, int HA, int W, int n_levels) {
  __shared__ float patches[kWarps][kTerms];
  __shared__ float strips[kWarps][kWin * kStrip];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= K) return;  // the whole warp; no barrier spans warps
  float* patch = patches[warp];
  float* strip = strips[warp];
  const size_t kp = static_cast<size_t>(blockIdx.y) * K + k;
  const size_t plane = static_cast<size_t>(blockIdx.y) * HA * W;

  const int l = clampi(__ldg(lvl + kp), 0, n_levels - 1);
  const int off = __ldg(off_t + l);
  const int h = __ldg(h_t + l);
  const int w = __ldg(w_t + l);
  const int y0 = __ldg(cv + kp);

  // lanes 0..20: the strip's columns around cur; lanes 21..31: the patch's
  // around cu.  The last clamp only guards memory: tables arrive consistent
  // with HA, W.
  const bool right = lane < kStrip;
  const int col = right ? __ldg(cur + kp) + lane - kHalf - kSlide
                        : __ldg(cu + kp) + (lane - kStrip) - kHalf;
  const float* src = (right ? atlas_r : atlas_l) + plane + clampi(clampi(col, 0, w - 1), 0, W - 1);
  float* dst = right ? strip + lane : patch + (lane - kStrip);
  const int stride = right ? kStrip : kWin;
#pragma unroll
  for (int dy = 0; dy < kWin; ++dy) {
    const int row = clampi(clampi(y0 + dy - kHalf, 0, h - 1) + off, 0, HA - 1);
    dst[dy * stride] = __ldg(src + static_cast<size_t>(row) * W);
  }
  __syncwarp();

  // this lane's terms: patch element i and the strip element under it at shift 0
  int at_strip[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int i = lane + 32 * j, dy = i / kWin;
    at_strip[j] = dy * kStrip + (i - dy * kWin);
  }
  float mine = 0.0f;
  for (int s = 0; s < kShifts; ++s) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (lane + 32 * j < kTerms) acc += fabsf(patch[lane + 32 * j] - strip[at_strip[j] + s]);
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, d);
    acc = __shfl_sync(0xffffffffu, acc, 0);
    if (lane == s) mine = acc;
  }
  if (lane < kShifts) out[kp * kShifts + lane] = mine;
}

}  // namespace

extern "C" int orb_sad_stereo(const float* atlas_l, const float* atlas_r, const int* cv,
                              const int* cu, const int* cur, const int* lvl,
                              const int* off_t, const int* h_t, const int* w_t, float* out,
                              int B, int K, int HA, int W, int n_levels, void* stream) {
  const dim3 grid((K + kWarps - 1) / kWarps, B);
  sad_stereo_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      atlas_l, atlas_r, cv, cu, cur, lvl, off_t, h_t, w_t, out, K, HA, W, n_levels);
  return static_cast<int>(cudaGetLastError());
}
