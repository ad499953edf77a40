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
// selection, lane rolls and bf16 atlases; on this card a thread block
// gathers directly, so none of that is carried over.
//
// Bound on the H100: launch latency.  A frame's 1200 keypoints read
// 1200 x 352 floats (1.7 MB, mostly L2 hits: neighbouring keypoints share
// rows), far below a microsecond of memory time.  One block of 128 threads
// per keypoint: the block stages patch and strip in shared memory (352
// floats), then warp w sums shifts w, w + 4, w + 8.  Each lane adds its
// elements in index order and the warp reduces with a fixed shuffle tree,
// so the result is the same from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kHalf = 5;                   // 11x11 window
constexpr int kSlide = 5;                  // +-5 px
constexpr int kWin = 2 * kHalf + 1;        // 11
constexpr int kStrip = kWin + 2 * kSlide;  // 21
constexpr int kShifts = 2 * kSlide + 1;    // 11
constexpr int kThreads = 128;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void sad_stereo_kernel(const float* __restrict__ atlas_l,
                                  const float* __restrict__ atlas_r,
                                  const int* __restrict__ cv, const int* __restrict__ cu,
                                  const int* __restrict__ cur, const int* __restrict__ lvl,
                                  const int* __restrict__ off_t, const int* __restrict__ h_t,
                                  const int* __restrict__ w_t, float* __restrict__ out,
                                  int K, int HA, int W, int n_levels) {
  __shared__ float patch[kWin * kWin];
  __shared__ float strip[kWin * kStrip];

  const int tid = threadIdx.x;
  const size_t kp = static_cast<size_t>(blockIdx.y) * K + blockIdx.x;
  const size_t plane = static_cast<size_t>(blockIdx.y) * HA * W;
  const float* al = atlas_l + plane;
  const float* ar = atlas_r + plane;

  const int l = clampi(__ldg(lvl + kp), 0, n_levels - 1);
  const int off = __ldg(off_t + l);
  const int h = __ldg(h_t + l);
  const int w = __ldg(w_t + l);
  const int y0 = __ldg(cv + kp);
  const int xl = __ldg(cu + kp);
  const int xr = __ldg(cur + kp);

  for (int i = tid; i < kWin * kWin; i += kThreads) {
    const int dy = i / kWin, dx = i - dy * kWin;
    // the last clamp only guards memory: tables arrive consistent with HA, W
    const int row = clampi(clampi(y0 + dy - kHalf, 0, h - 1) + off, 0, HA - 1);
    const int col = clampi(clampi(xl + dx - kHalf, 0, w - 1), 0, W - 1);
    patch[i] = __ldg(al + static_cast<size_t>(row) * W + col);
  }
  for (int i = tid; i < kWin * kStrip; i += kThreads) {
    const int dy = i / kStrip, dx = i - dy * kStrip;
    const int row = clampi(clampi(y0 + dy - kHalf, 0, h - 1) + off, 0, HA - 1);
    const int col = clampi(clampi(xr + dx - kHalf - kSlide, 0, w - 1), 0, W - 1);
    strip[i] = __ldg(ar + static_cast<size_t>(row) * W + col);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int s = warp; s < kShifts; s += kThreads / 32) {
    float acc = 0.0f;
    for (int i = lane; i < kWin * kWin; i += 32) {
      const int dy = i / kWin, dx = i - dy * kWin;
      acc += fabsf(patch[i] - strip[dy * kStrip + dx + s]);
    }
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, d);
    if (lane == 0) out[kp * kShifts + s] = acc;
  }
}

}  // namespace

extern "C" int orb_sad_stereo(const float* atlas_l, const float* atlas_r, const int* cv,
                              const int* cu, const int* cur, const int* lvl,
                              const int* off_t, const int* h_t, const int* w_t, float* out,
                              int B, int K, int HA, int W, int n_levels, void* stream) {
  const dim3 grid(K, B);
  sad_stereo_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      atlas_l, atlas_r, cv, cu, cur, lvl, off_t, h_t, w_t, out, K, HA, W, n_levels);
  return static_cast<int>(cudaGetLastError());
}
