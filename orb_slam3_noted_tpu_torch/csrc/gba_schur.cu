// The reduced camera system of the global bundle adjustment (optim/gba.py):
// its product in every PCG iteration, the CG update, and the LM step's
// pose-side sums, each in a fixed order.
//
// Replaces no Pallas kernel.  The JAX package (orb_slam3_noted_tpu/optim/
// gba.py) writes every sum over keyframe slots as a one-hot matrix
// product, a TPU idiom, and the port kept it as its plain version
// (ops/gba_kernels.py).  On the H100 that one-hot is a dense (K, O)
// float32 matrix, (256, 307,200) = 315 MB at the capacity map, streamed
// through cuBLAS GEMV in each of a call's 320 PCG iterations and 40 more
// pose sums, to add 307,200 small rows into 256 slots.
//
// What bounds these kernels on the card: bytes.  A PCG iteration reads W
// (O, 6, 3), 22 MB at the capacity map, twice (once by point, once by
// pose), the row orders and indices (~10 MB) and vectors of a few hundred
// kB; about 32 MB, which the 50 MB L2 can keep over a solve's iterations.
// The CG update is one block over (K, 6) vectors: its time is its launch.
//
// Every sum runs in one order, whatever the scheduling, and no kernel uses
// atomics, so a GBA call gives the same bits from run to run:
//  - point pass, a warp per point: lane l adds the point's rows l, l + 32,
//    ... in the point segmentation's order (rows sorted by point, stable),
//    then a xor-shuffle tree; y = Cinv utx on lanes 0..2;
//  - pose pass and pose sums, a block per keyframe slot: each thread (row
//    group) adds the slot's rows t, t + T, ... in the pose segmentation's
//    order, then a fixed tree (pose pass) or the groups in turn (pose sums);
//  - CG update and start, one block: thread t takes slots t, t + 256, ...,
//    then warp trees, then the 8 warp sums in turn.
// Row orders come from ops/segsum.py's segment_order, which deals rows that
// are not valid round-robin over the segments (their data is zero).
// Indices are clamped to their tables: a bad index reads a wrong row, never
// outside the tensor.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;               // threads a block (point, pose, CG kernels)
constexpr int kWarps = kBlock / 32;
constexpr int kSumRows = 16;              // row groups of a pose-sum block (32 columns each)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long clampl(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// The sum over the block of each thread's v: warp trees, then the warp sums
// in turn; every thread returns it.  `red` holds kWarps floats.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();  // red is written again by the next call
  return s;
}

// out = A v for a row-major 6x6 A
__device__ __forceinline__ void matvec6(const float* __restrict__ A, const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) s = fmaf(A[6 * i + j], v[j], s);
    out[i] = s;
  }
}

// y[m] = Cinv[m] sum_{o of point m} W[o]^T x[pose_idx[o]]
__global__ void __launch_bounds__(kBlock)
point_pass_kernel(const float* __restrict__ W, const float* __restrict__ Cinv,
                  const float* __restrict__ x, const long long* __restrict__ pose_idx,
                  const long long* __restrict__ perm, const long long* __restrict__ starts,
                  float* __restrict__ y, int Mb, int K, long long O) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= Mb) return;  // the whole warp
  const long long s1 = starts[m + 1];
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (long long j = starts[m] + lane; j < s1; j += 32) {
    const long long o = clampl(perm[j], O - 1);
    const float* w = W + o * 18;
    const float* xk = x + clampl(pose_idx[o], K - 1) * 6;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float xi = xk[i];
      a0 = fmaf(w[3 * i], xi, a0);
      a1 = fmaf(w[3 * i + 1], xi, a1);
      a2 = fmaf(w[3 * i + 2], xi, a2);
    }
  }
  a0 = warp_sum(a0);
  a1 = warp_sum(a1);
  a2 = warp_sum(a2);
  if (lane < 3) {
    const float* c = Cinv + static_cast<long long>(m) * 9 + lane * 3;
    y[static_cast<long long>(m) * 3 + lane] = fmaf(c[0], a0, fmaf(c[1], a1, c[2] * a2));
  }
}

// out[k] = sum_{o of slot k} W[o] y[point_idx[o]]
__global__ void __launch_bounds__(kBlock)
pose_pass_kernel(const float* __restrict__ W, const float* __restrict__ y,
                 const long long* __restrict__ point_idx, const long long* __restrict__ perm,
                 const long long* __restrict__ starts, float* __restrict__ out, int Mb,
                 long long O) {
  __shared__ float red[kWarps][6];
  const int k = blockIdx.x;
  const long long s1 = starts[k + 1];
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (long long j = starts[k] + threadIdx.x; j < s1; j += kBlock) {
    const long long o = clampl(perm[j], O - 1);
    const float* w = W + o * 18;
    const float* ym = y + clampl(point_idx[o], Mb - 1) * 3;
    const float y0 = ym[0], y1 = ym[1], y2 = ym[2];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      acc[i] = fmaf(w[3 * i], y0, fmaf(w[3 * i + 1], y1, fmaf(w[3 * i + 2], y2, acc[i])));
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[i] = warp_sum(acc[i]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) red[threadIdx.x >> 5][i] = acc[i];
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    out[static_cast<long long>(k) * 6 + threadIdx.x] = s;
  }
}

// out[k, c] = sum_{o of slot k} data[o, c]; block (32, kSumRows) over
// columns blockIdx.y * 32 + threadIdx.x
__global__ void __launch_bounds__(32 * kSumRows)
pose_sum_kernel(const float* __restrict__ data, const long long* __restrict__ perm,
                const long long* __restrict__ starts, float* __restrict__ out, int C,
                long long O) {
  __shared__ float part[kSumRows][33];
  const int k = blockIdx.x;
  const int c = blockIdx.y * 32 + threadIdx.x;
  float acc = 0.f;
  if (c < C) {
    const long long s1 = starts[k + 1];
    for (long long j = starts[k] + threadIdx.y; j < s1; j += kSumRows)
      acc += data[clampl(perm[j], O - 1) * C + c];
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kSumRows; ++r) s += part[r][threadIdx.x];
    out[static_cast<long long>(k) * C + c] = s;
  }
}

// x = 0, r = b, p = z = Pinv r, rz = r.z
__global__ void __launch_bounds__(kBlock)
pcg_start_kernel(const float* __restrict__ Pinv, const float* __restrict__ b,
                 float* __restrict__ x, float* __restrict__ r, float* __restrict__ p,
                 float* __restrict__ rz, int K) {
  __shared__ float red[kWarps];
  float part = 0.f;
  for (int k = threadIdx.x; k < K; k += kBlock) {
    float rk[6], zk[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) rk[i] = b[6 * k + i];
    matvec6(Pinv + 36 * k, rk, zk);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      x[6 * k + i] = 0.f;
      r[6 * k + i] = rk[i];
      p[6 * k + i] = zk[i];
      part = fmaf(rk[i], zk[i], part);
    }
  }
  const float s = block_sum(part, red);
  if (threadIdx.x == 0) *rz = s;
}

// Ap = Hpp p - uy for slot k
__device__ __forceinline__ void apply_system(const float* __restrict__ Hpp,
                                             const float* __restrict__ uy, const float* pk,
                                             int k, float* ap) {
  matvec6(Hpp + 36 * k, pk, ap);
#pragma unroll
  for (int i = 0; i < 6; ++i) ap[i] -= uy[6 * k + i];
}

// One CG iteration in place, with the guards of optim/gba.py's PCG:
// Ap = Hpp p - uy, alpha = rz / p.Ap (0 where |p.Ap| <= 1e-20), x += alpha p,
// r -= alpha Ap, z = Pinv r, beta = r.z / rz (0 where |rz| <= 1e-20),
// p = z + beta p, rz = r.z.  `z` is scratch of x's shape.
__global__ void __launch_bounds__(kBlock)
pcg_step_kernel(const float* __restrict__ Hpp, const float* __restrict__ Pinv,
                const float* __restrict__ uy, float* __restrict__ x, float* __restrict__ r,
                float* __restrict__ p, float* __restrict__ z, float* __restrict__ rz, int K) {
  __shared__ float red[kWarps];
  float part = 0.f;
  for (int k = threadIdx.x; k < K; k += kBlock) {
    float pk[6], ap[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) pk[i] = p[6 * k + i];
    apply_system(Hpp, uy, pk, k, ap);
#pragma unroll
    for (int i = 0; i < 6; ++i) part = fmaf(pk[i], ap[i], part);
  }
  const float pAp = block_sum(part, red);
  const float rz_old = *rz;  // every thread reads it before the barrier of the next sum
  const float alpha = fabsf(pAp) > 1e-20f ? rz_old / pAp : 0.f;
  part = 0.f;
  for (int k = threadIdx.x; k < K; k += kBlock) {
    float pk[6], ap[6], rk[6], zk[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) pk[i] = p[6 * k + i];
    apply_system(Hpp, uy, pk, k, ap);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      x[6 * k + i] += alpha * pk[i];
      rk[i] = r[6 * k + i] - alpha * ap[i];
      r[6 * k + i] = rk[i];
    }
    matvec6(Pinv + 36 * k, rk, zk);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      z[6 * k + i] = zk[i];
      part = fmaf(rk[i], zk[i], part);
    }
  }
  const float rz_new = block_sum(part, red);
  const float beta = fabsf(rz_old) > 1e-20f ? rz_new / rz_old : 0.f;
  for (int k = threadIdx.x; k < K; k += kBlock) {  // the slots this thread wrote z of
#pragma unroll
    for (int i = 0; i < 6; ++i) p[6 * k + i] = z[6 * k + i] + beta * p[6 * k + i];
  }
  if (threadIdx.x == 0) *rz = rz_new;
}

}  // namespace

extern "C" int orb_gba_point_pass(const void* W, const void* Cinv, const void* x,
                                  const void* pose_idx, const void* perm, const void* starts,
                                  void* y, int Mb, int K, long long O, void* stream) {
  if (Mb > 0) {
    point_pass_kernel<<<(Mb + kWarps - 1) / kWarps, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(W), static_cast<const float*>(Cinv),
        static_cast<const float*>(x), static_cast<const long long*>(pose_idx),
        static_cast<const long long*>(perm), static_cast<const long long*>(starts),
        static_cast<float*>(y), Mb, K, O);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int orb_gba_pose_pass(const void* W, const void* y, const void* point_idx,
                                 const void* perm, const void* starts, void* out, int K, int Mb,
                                 long long O, void* stream) {
  if (K > 0) {
    pose_pass_kernel<<<K, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(W), static_cast<const float*>(y),
        static_cast<const long long*>(point_idx), static_cast<const long long*>(perm),
        static_cast<const long long*>(starts), static_cast<float*>(out), Mb, O);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int orb_gba_pose_sum(const void* data, const void* perm, const void* starts,
                                void* out, int K, int C, long long O, void* stream) {
  if (K > 0 && C > 0) {
    const dim3 grid(K, (C + 31) / 32), block(32, kSumRows);
    pose_sum_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(data), static_cast<const long long*>(perm),
        static_cast<const long long*>(starts), static_cast<float*>(out), C, O);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int orb_gba_pcg_start(const void* Pinv, const void* b, void* x, void* r, void* p,
                                 void* rz, int K, void* stream) {
  pcg_start_kernel<<<1, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Pinv), static_cast<const float*>(b), static_cast<float*>(x),
      static_cast<float*>(r), static_cast<float*>(p), static_cast<float*>(rz), K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int orb_gba_pcg_step(const void* Hpp, const void* Pinv, const void* uy, void* x,
                                void* r, void* p, void* z, void* rz, int K, void* stream) {
  pcg_step_kernel<<<1, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Hpp), static_cast<const float*>(Pinv),
      static_cast<const float*>(uy), static_cast<float*>(x), static_cast<float*>(r),
      static_cast<float*>(p), static_cast<float*>(z), static_cast<float*>(rz), K);
  return static_cast<int>(cudaGetLastError());
}
