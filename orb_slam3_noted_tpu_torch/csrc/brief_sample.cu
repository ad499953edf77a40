// K3: rBRIEF over a pyramid atlas.  Blurred atlas (B, HA, W0) float32 (the
// levels of one pyramid stacked along the rows, level l at rows off_l ..
// off_l + h_l and columns 0 .. w_l) and, per keypoint, its integer
// coordinates at its own level (B, N, 2) int32 as (x, y), its angle (B, N)
// float32 and its level (B, N) int32 -> descriptors (B, N, 8) int32.  One
// launch describes every keypoint of every level of every image of the batch.
//
// Replaces the Pallas kernel `_brief_kernel` behind `brief_sample_tpu` in
// orb_slam3_noted_tpu/ops/pallas_kernels.py, and the prelude the JAX package
// leaves to XLA ahead of it (orb_slam3_noted_tpu/ops/orb.py,
// `brief_descriptors`): rotate the 512 pattern points by the keypoint's
// angle, round, add the keypoint, clip to the level.  The TPU kernel took
// the coordinates ready-made because XLA fuses that prelude; in eager
// PyTorch it was two (K, 512) int32 tensors written and read again (twice
// the bytes of the samples themselves) through some twenty small launches a
// level.  Here a thread rotates its own two points in registers.  The TPU
// kernel's aligned 64 x 256 windows and one-hot matrix products exist to
// turn the gather into dense work; on this card the gather is direct.
//
// Arithmetic, step for step that of the plain version (ops/cuda_kernels.py,
// `brief_coords`): a = cosf(angle), b = sinf(angle), rx = rint(px*a - py*b),
// ry = rint(px*b + py*a) with every product and sum rounded on its own
// (__fmul_rn / __fsub_rn / __fadd_rn: no FMA contraction; -use_fast_math is
// off), rintf rounds half to even as torch.round does, then the clip to
// [0, w_l - 1] x [0, h_l - 1].  Bit b of word w is I(p1[32w + b]) <
// I(p2[32w + b]).  Bit-exact with the plain version.
//
// Bound on the H100: memory latency, not bytes (512 samples x 4 B + 16 B in
// + 32 B out per keypoint, 2.5 MB for 1200 keypoints, mostly L1/L2 hits: a
// keypoint's samples span at most 44 x 44 px).  One block of 256 threads per
// keypoint; thread 0 takes cosf / sinf once for the block; thread j reads
// pattern points j and 256 + j from __constant__ memory (filled once per
// device from ops/orb_pattern.py's table by orb_brief_set_pattern), samples
// twice, and one __ballot_sync per warp packs its word: 2.4 KB of constant
// memory, 8 B of shared memory, one barrier.  The level tables (at most
// kMaxLevels entries) travel by value with the launch.  No matrix product
// and no tile worth a bulk copy: nothing here for wgmma or TMA.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, kernel
// duration from torch.profiler): 0.0094 ms for the 1200 keypoints of one
// image, 0.0160 ms for the 2400 of a stereo pair, against 0.0118 ms for the
// eight per-level launches of the coordinate-fed kernel it replaces plus
// 0.2534 ms for the PyTorch prelude that made their coordinates.  cosf and
// sinf here give the bits of torch.cos and torch.sin on the card: 0 of 2400
// descriptors differ from the plain version.  ptxas, sm_90a: 22 registers,
// one barrier, 8 B of shared memory, a 32 B stack (the slow path of cosf /
// sinf's argument reduction), no spills.
#include <cuda_runtime.h>

#include "atlas_levels.cuh"

namespace {

constexpr int kPairs = 256;

// (x, y) of the 256 first points of the pairs, then of the 256 second points
__constant__ float2 kPattern[2 * kPairs];

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ float sample(const float* __restrict__ im, int W, float2 p,
                                        float a, float b, int kx, int ky, int h, int w) {
  const int rx = static_cast<int>(rintf(__fsub_rn(__fmul_rn(p.x, a), __fmul_rn(p.y, b))));
  const int ry = static_cast<int>(rintf(__fadd_rn(__fmul_rn(p.x, b), __fmul_rn(p.y, a))));
  const int gx = clampi(kx + rx, 0, w - 1);
  const int gy = clampi(ky + ry, 0, h - 1);
  return __ldg(im + static_cast<size_t>(gy) * W + gx);
}

__global__ void __launch_bounds__(kPairs)
brief_sample_kernel(const float* __restrict__ atlas, const int* __restrict__ xy,
                    const float* __restrict__ angle, const int* __restrict__ level,
                    int* __restrict__ out, int N, int HA, int W, const AtlasLevels lv) {
  __shared__ float cs[2];
  const int j = threadIdx.x;
  const size_t kp = static_cast<size_t>(blockIdx.y) * N + blockIdx.x;
  if (j == 0) {
    const float ang = __ldg(angle + kp);
    cs[0] = cosf(ang);
    cs[1] = sinf(ang);
  }
  const int l = clampi(__ldg(level + kp), 0, lv.n - 1);
  const int h = lv.h[l], w = lv.w[l];
  const int kx = __ldg(xy + 2 * kp), ky = __ldg(xy + 2 * kp + 1);
  const float* im = atlas + (static_cast<size_t>(blockIdx.y) * HA + lv.off[l]) * W;
  __syncthreads();
  const float a = cs[0], b = cs[1];
  const float v1 = sample(im, W, kPattern[j], a, b, kx, ky, h, w);
  const float v2 = sample(im, W, kPattern[kPairs + j], a, b, kx, ky, h, w);
  const unsigned bits = __ballot_sync(0xffffffffu, v1 < v2);
  if ((j & 31) == 0) out[kp * (kPairs / 32) + (j >> 5)] = static_cast<int>(bits);
}

}  // namespace

// Copies the 512 (x, y) pattern points from host memory into this device's
// __constant__ table; call once per device before the first launch there.
extern "C" int orb_brief_set_pattern(const float* pattern_xy) {
  return static_cast<int>(
      cudaMemcpyToSymbol(kPattern, pattern_xy, sizeof(float2) * 2 * kPairs));
}

// `hw` holds n_levels pairs (h_l, w_l) in host memory; the levels are stacked
// in that order from row 0 of each (HA, W) image.
extern "C" int orb_brief_sample(const float* atlas, const int* xy, const float* angle,
                                const int* level, int* out, int B, int N, int HA, int W,
                                int n_levels, const int* hw, void* stream) {
  AtlasLevels lv;
  if (!fill_levels(lv, hw, n_levels, HA, W, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N, B);
  brief_sample_kernel<<<grid, kPairs, 0, static_cast<cudaStream_t>(stream)>>>(
      atlas, xy, angle, level, out, N, HA, W, lv);
  return static_cast<int>(cudaGetLastError());
}
