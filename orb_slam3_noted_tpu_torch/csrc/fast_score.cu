// K1: dense FAST-9/16 corner score, (B, H, W) float32 -> (B, H, W) float32.
//
// Replaces the Pallas kernels `_fast_kernel` / `_fast_kernel_b` behind
// `fast_score` in orb_slam3_noted_tpu/ops/pallas_kernels.py (one kernel with
// a batch dimension instead of the single/batched pair).
//
// score(p) = max over the 16 contiguous 9-arcs of the Bresenham ring of
// min(ring - centre) (bright) and of min(centre - ring) (dark).  The ring
// wraps at the image edges, as `jnp.roll` / `torch.roll` do in the plain
// version; callers mask a 16-px border anyway.  Only subtractions, minima
// and maxima: bit-exact with the plain version.
//
// Bound on the H100: device memory.  Per pixel it reads 17 floats and
// writes one; the 16 ring reads of a warp fall on 7 rows that neighbouring
// warps of the block share, so they are served from L1/L2 and DRAM traffic
// stays near one read and one write per pixel (about 2.9 MB for a 752x480
// level).  The arithmetic (16 subtractions, 2 x 16 x 8 minima, maxima) is
// a few hundred operations per pixel, far under the card's rate.  Design:
// one thread per output pixel, 32x8 blocks so a warp reads one contiguous
// row segment per ring offset; the ring offsets are compile-time constants
// after unrolling, so the 16 differences live in registers.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ int wrap(int i, int n) {
  i += (i < 0) ? n : 0;
  return i - ((i >= n) ? n : 0);
}

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, int H, int W) {
  // ring offsets in the order of orb_slam3_noted_tpu/ops/fast.py CIRCLE_16
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const float* im = img + static_cast<size_t>(blockIdx.z) * H * W;
  const float c = im[static_cast<size_t>(y) * W + x];

  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int yy = wrap(y + kDy[k], H);
    const int xx = wrap(x + kDx[k], W);
    d[k] = __fsub_rn(__ldg(im + static_cast<size_t>(yy) * W + xx), c);
  }

  float bright = -CUDART_INF_F;
  float dark = -CUDART_INF_F;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float mb = d[s];
    float md = -d[s];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      const float v = d[(s + j) & 15];
      mb = fminf(mb, v);
      md = fminf(md, -v);
    }
    bright = fmaxf(bright, mb);
    dark = fmaxf(dark, md);
  }
  out[static_cast<size_t>(blockIdx.z) * H * W + static_cast<size_t>(y) * W + x] =
      fmaxf(bright, dark);
}

}  // namespace

extern "C" int orb_fast_score(const float* img, float* out, int B, int H, int W,
                              void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(img, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
