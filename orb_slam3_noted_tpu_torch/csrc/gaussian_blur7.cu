// K2: separable 7-tap Gaussian blur with reflect-101 edges over a pyramid
// atlas: (B, HA, W0) float32 -> (B, HA, W0) float32, where the atlas stacks
// the levels of one pyramid along its rows (level l at rows off_l ..
// off_l + h_l, columns 0 .. w_l; the columns right of w_l are padding).
// One launch blurs every level of every image of the batch; a single image
// or level is the one-level table over the same kernel.
//
// Replaces the Pallas kernels `_blur_kernel` / `_blur_kernel_b` behind
// `gaussian_blur7` in orb_slam3_noted_tpu/ops/pallas_kernels.py.  The TPU
// kernel wraps the edges; this one reflects them (BORDER_REFLECT_101), as
// the JAX package's CPU path `ops/image.py:gaussian_blur` and OpenCV do, and
// it reflects inside its level's h_l x w_l, never into the padding or the
// neighbouring level.
//
// Horizontal pass, then vertical, each tap sum taken in the plain version's
// order, acc = acc + k[i] * x_i starting from 0.  __fmul_rn / __fadd_rn keep
// nvcc from contracting a multiply and an add into one FMA, so each step
// rounds as PyTorch's separate multiply and add kernels do: bit-exact with
// the plain version on the card.
//
// Bound on the H100: device memory (read and write each level pixel once,
// 2.9 MB for the 8 levels of a 752x480 image, under a microsecond at
// 3.35 TB/s), but what it cost before was launches: one per level, each
// a few microseconds on the card behind tens of microseconds of host path.
// The grid is now a flat list of output tiles over all levels; a block
// finds its level by scanning a table of per-level tile offsets (at most
// kMaxLevels entries, passed by value with the launch) and otherwise works
// as before: the tile and its 3-px halo go to shared memory, the horizontal
// pass stays there, each output is written once.  The padding columns of
// the output are never written (and never read: the sampler clips to w_l).
// No matrix product and tiles of a few KB: nothing here for wgmma or TMA.
//
// A block writes 64 x 16 outputs (halo 70 x 22, 1.5x the tile's pixels
// read).  Measured on an NVIDIA H100 80GB HBM3 at 700 W over the 8-level
// atlas of a 752x480 image (chip_smoke.py, kernel durations from
// torch.profiler): 0.0101 ms (0.0184 ms for a stereo pair).  A 32 x 8 tile
// (halo 38 x 14, 2.1x) was built beside it and took 0.0159 ms (0.0298), so
// it went; the eight per-level launches this kernel replaces took 0.0234 ms
// together.  That is 3.8x the bound of 0.0027 ms; the rest is the tail of
// 1,160 short blocks and the halo re-reads, for a later pass if the blur
// ever matters.  ptxas, sm_90a: 32 registers, one barrier, 11,792 B of
// shared memory, 256 threads a block, no spills.
#include <cuda_runtime.h>

#include "atlas_levels.cuh"

namespace {

constexpr int kR = 3;
constexpr int kTaps = 2 * kR + 1;
constexpr int kThreads = 256;
constexpr int kTX = 64, kTY = 16;  // outputs of a block

struct BlurTiles {
  int tiles_x[kMaxLevels];     // tiles across the level
  int tile0[kMaxLevels + 1];   // first flat tile index; tile0[n] = total
};

// reflect-101 for indices in [-kR, n - 1 + kR] (n >= kR + 1); the final
// clamp only keeps halo reads of a ragged edge tile inside the level
__device__ __forceinline__ int reflect101(int i, int n) {
  i = (i < 0) ? -i : i;
  i = (i >= n) ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(kThreads)
gaussian_blur7_kernel(const float* __restrict__ img, const float* __restrict__ taps,
                      float* __restrict__ out, int HA, int W, const AtlasLevels lv,
                      const BlurTiles tl) {
  __shared__ float tile[kTY + 2 * kR][kTX + 2 * kR];
  __shared__ float hpass[kTY + 2 * kR][kTX];

  int l = 0;
  while (l + 1 < lv.n && static_cast<int>(blockIdx.x) >= tl.tile0[l + 1]) ++l;
  const int t = blockIdx.x - tl.tile0[l];
  const int h = lv.h[l], w = lv.w[l];
  const int x0 = (t % tl.tiles_x[l]) * kTX;
  const int y0 = (t / tl.tiles_x[l]) * kTY;
  const size_t base = (static_cast<size_t>(blockIdx.y) * HA + lv.off[l]) * W;
  const float* im = img + base;
  const int tid = threadIdx.x;

  float k[kTaps];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) k[i] = __ldg(taps + i);

  for (int i = tid; i < (kTY + 2 * kR) * (kTX + 2 * kR); i += kThreads) {
    const int ty = i / (kTX + 2 * kR);
    const int tx = i - ty * (kTX + 2 * kR);
    const int yy = reflect101(y0 + ty - kR, h);
    const int xx = reflect101(x0 + tx - kR, w);
    tile[ty][tx] = __ldg(im + static_cast<size_t>(yy) * W + xx);
  }
  __syncthreads();

  for (int i = tid; i < (kTY + 2 * kR) * kTX; i += kThreads) {
    const int ty = i / kTX;
    const int tx = i - ty * kTX;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) acc = __fadd_rn(acc, __fmul_rn(k[j], tile[ty][tx + j]));
    hpass[ty][tx] = acc;
  }
  __syncthreads();

  for (int i = tid; i < kTY * kTX; i += kThreads) {
    const int ty = i / kTX;
    const int tx = i - ty * kTX;
    const int x = x0 + tx, y = y0 + ty;
    if (x >= w || y >= h) continue;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) acc = __fadd_rn(acc, __fmul_rn(k[j], hpass[ty + j][tx]));
    out[base + static_cast<size_t>(y) * W + x] = acc;
  }
}

}  // namespace

// `hw` holds n_levels pairs (h_l, w_l) in host memory; the levels are stacked
// in that order from row 0.  Reflect-101 over kR pixels needs kR + 1 a side.
extern "C" int orb_gaussian_blur7(const float* img, const float* taps, float* out,
                                  int B, int HA, int W, int n_levels, const int* hw,
                                  void* stream) {
  AtlasLevels lv;
  if (!fill_levels(lv, hw, n_levels, HA, W, kR + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BlurTiles tl;
  int tiles = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool live = l < n_levels;
    tl.tiles_x[l] = (lv.w[l] + kTX - 1) / kTX;
    tl.tile0[l] = tiles;
    if (live) tiles += tl.tiles_x[l] * ((lv.h[l] + kTY - 1) / kTY);
  }
  tl.tile0[kMaxLevels] = tiles;
  const dim3 grid(tiles, B);
  gaussian_blur7_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, taps, out, HA, W, lv, tl);
  return static_cast<int>(cudaGetLastError());
}
