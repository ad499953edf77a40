// K3: rBRIEF sampling, blurred level (B, H, W) float32 + sample coordinates
// gy, gx (B, K, 512) int32 -> descriptors (B, K, 8) int32.
//
// Replaces the Pallas kernel `_brief_kernel` behind `brief_sample_tpu` in
// orb_slam3_noted_tpu/ops/pallas_kernels.py.  The coordinates are the 256
// learned pattern pairs already rotated by the keypoint angle, rounded and
// clipped to the level (computed in PyTorch, ops/orb.py:brief_coords), so
// this kernel only samples and compares: bit b of word w is
// I(p1[32w + b]) < I(p2[32w + b]), the packing of the plain version.
// Bit-exact with it.  The TPU kernel needed aligned 64 x 256 windows, padded
// images and one-hot matrix products to turn the gather into dense work;
// on this card the gather is direct, so none of that is carried over.
//
// Bound on the H100: memory latency.  One block of 256 threads per
// keypoint: thread j reads its two samples (the pairs span at most
// 44 x 44 px, so a keypoint's 512 reads touch a few dozen cache lines that
// stay in L1/L2) and one __ballot_sync packs each warp's 32 comparisons into
// its word, written by lane 0 -- no shared memory and no second pass.
// ~1200 keypoints a frame give ~1200 blocks, enough to fill 132 SMs.
#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 256;

__global__ void brief_sample_kernel(const float* __restrict__ img,
                                    const int* __restrict__ gy,
                                    const int* __restrict__ gx,
                                    int* __restrict__ out, int K, int H, int W) {
  const int j = threadIdx.x;
  const size_t kp = static_cast<size_t>(blockIdx.y) * K + blockIdx.x;
  const float* im = img + static_cast<size_t>(blockIdx.y) * H * W;
  const int* py = gy + kp * 2 * kPairs;
  const int* px = gx + kp * 2 * kPairs;
  // coordinates arrive clipped; the clamp only guards memory
  const int y1 = min(max(__ldg(py + j), 0), H - 1);
  const int x1 = min(max(__ldg(px + j), 0), W - 1);
  const int y2 = min(max(__ldg(py + kPairs + j), 0), H - 1);
  const int x2 = min(max(__ldg(px + kPairs + j), 0), W - 1);
  const float a = __ldg(im + static_cast<size_t>(y1) * W + x1);
  const float b = __ldg(im + static_cast<size_t>(y2) * W + x2);
  const unsigned bits = __ballot_sync(0xffffffffu, a < b);
  if ((j & 31) == 0) out[kp * (kPairs / 32) + (j >> 5)] = static_cast<int>(bits);
}

}  // namespace

extern "C" int orb_brief_sample(const float* img, const int* gy, const int* gx, int* out,
                                int B, int K, int H, int W, void* stream) {
  const dim3 grid(K, B);
  brief_sample_kernel<<<grid, kPairs, 0, static_cast<cudaStream_t>(stream)>>>(
      img, gy, gx, out, K, H, W);
  return static_cast<int>(cudaGetLastError());
}
