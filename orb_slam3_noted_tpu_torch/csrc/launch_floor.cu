// An empty kernel, one block of one thread.  Its duration on the device is
// the least any kernel launch lasts on the card; chip_smoke.py times it the
// way it times K1-K4 and reports it beside each kernel's roofline bound,
// which for the small kernels here (K3, K4) lies below it.
#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int orb_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
