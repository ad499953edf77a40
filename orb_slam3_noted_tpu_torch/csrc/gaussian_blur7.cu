// K2: separable 7-tap Gaussian blur with reflect-101 edges,
// (B, H, W) float32 -> (B, H, W) float32.
//
// Replaces the Pallas kernels `_blur_kernel` / `_blur_kernel_b` behind
// `gaussian_blur7` in orb_slam3_noted_tpu/ops/pallas_kernels.py.  The TPU
// kernel wraps the edges; this one reflects them (BORDER_REFLECT_101), as
// the JAX package's CPU path `ops/image.py:gaussian_blur` and OpenCV do.
//
// Horizontal pass, then vertical, each tap sum taken in the plain version's
// order, acc = acc + k[i] * x_i starting from 0.  __fmul_rn / __fadd_rn keep
// nvcc from contracting a multiply and an add into one FMA, so each step
// rounds as PyTorch's separate multiply and add kernels do: bit-exact with
// the plain version on the card.
//
// Bound on the H100: device memory.  The plain version makes 14 passes over
// the level, each reading and writing a full-size temporary; this kernel
// reads each input pixel once into a shared-memory tile with a 3-px halo
// (38 x 14 floats for a 32 x 8 output tile, 2.1x the tile's own pixels, the
// overlap served from L2), keeps the horizontal pass in shared memory and
// writes each output once: about 2 x 4 bytes of DRAM traffic per pixel.
// The 14 multiply-adds per pixel are far under the card's rate.
#include <cuda_runtime.h>

namespace {

constexpr int kR = 3;
constexpr int kTaps = 2 * kR + 1;
constexpr int kTileX = 32;
constexpr int kTileY = 8;

// reflect-101 for indices in [-kR, n - 1 + kR] (n >= kR + 1); the final
// clamp only keeps halo reads of a ragged edge tile inside the image
__device__ __forceinline__ int reflect101(int i, int n) {
  i = (i < 0) ? -i : i;
  i = (i >= n) ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

__global__ void gaussian_blur7_kernel(const float* __restrict__ img,
                                      const float* __restrict__ taps,
                                      float* __restrict__ out, int H, int W) {
  __shared__ float tile[kTileY + 2 * kR][kTileX + 2 * kR];
  __shared__ float hpass[kTileY + 2 * kR][kTileX];

  const float* im = img + static_cast<size_t>(blockIdx.z) * H * W;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int tid = threadIdx.y * kTileX + threadIdx.x;

  float k[kTaps];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) k[i] = __ldg(taps + i);

  for (int i = tid; i < (kTileY + 2 * kR) * (kTileX + 2 * kR); i += kTileX * kTileY) {
    const int ty = i / (kTileX + 2 * kR);
    const int tx = i % (kTileX + 2 * kR);
    const int yy = reflect101(y0 + ty - kR, H);
    const int xx = reflect101(x0 + tx - kR, W);
    tile[ty][tx] = __ldg(im + static_cast<size_t>(yy) * W + xx);
  }
  __syncthreads();

  for (int i = tid; i < (kTileY + 2 * kR) * kTileX; i += kTileX * kTileY) {
    const int ty = i / kTileX;
    const int tx = i % kTileX;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) acc = __fadd_rn(acc, __fmul_rn(k[j], tile[ty][tx + j]));
    hpass[ty][tx] = acc;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    acc = __fadd_rn(acc, __fmul_rn(k[j], hpass[threadIdx.y + j][threadIdx.x]));
  }
  out[static_cast<size_t>(blockIdx.z) * H * W + static_cast<size_t>(y) * W + x] = acc;
}

}  // namespace

extern "C" int orb_gaussian_blur7(const float* img, const float* taps, float* out,
                                  int B, int H, int W, void* stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, B);
  gaussian_blur7_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, taps, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
