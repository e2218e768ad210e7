// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (body _rms_kernel): out = x * rsqrt(mean(x^2) + eps) * w per row, f32
// math, output in x's dtype.
//
// What bounds it on this card: bytes.  Each element costs about four
// operations against 4 to 8 bytes read and written, two orders of
// magnitude below the operations per byte at which the H100's compute
// becomes the limit.  On the serving path the rows are d = 1536 wide:
// 1 to 4 rows per decode call (a few microseconds of launch latency
// dominate) and up to max_seq rows per prefill.
//
// What the design does about it: one block per row, so each row is read
// from device memory once (the second pass over it is served by L1) and
// written once; 16-byte vector loads and stores wherever the row and
// pointers allow, scalar ones otherwise; the sum of squares stays in f32
// registers and is reduced with warp shuffles plus one shared-memory step
// across the block's warps.  The TPU kernel's padding of rows to a block
// of 256 is not needed: the grid is exactly one block per row.  No
// scratch in device memory, no atomics, nothing allocated.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int d, float eps) {
  using P = Pack<T, VEC>;
  const P* xr = reinterpret_cast<const P*>(x + (size_t)blockIdx.x * d);
  const P* wr = reinterpret_cast<const P*>(w);
  P* orow = reinterpret_cast<P*>(out + (size_t)blockIdx.x * d);
  const int nvec = d / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const P p = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f32(p.v[j]);
      ss += f * f;
    }
  }
  __shared__ float warp_sums[kThreads / 32];
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
  const float inv = rsqrtf(total / (float)d + eps);

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const P xp = xr[i];
    const P wp = wr[i];
    P op;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      op.v[j] = from_f32<T>(to_f32(xp.v[j]) * inv * to_f32(wp.v[j]));
    orow[i] = op;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (d % kVec == 0 && aligned16(x) && aligned16(w) && aligned16(out))
    rmsnorm_kernel<T, kVec><<<rows, kThreads, 0, stream>>>(xt, wt, ot, d, eps);
  else
    rmsnorm_kernel<T, 1><<<rows, kThreads, 0, stream>>>(xt, wt, ot, d, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x, out: (rows, d) contiguous; w: (d,), all of one dtype.  Returns the
// cudaError_t of the launch.
extern "C" int rmsnorm_fwd(int dtype, const void* x, const void* w, void* out,
                           int rows, int d, float eps, void* stream) {
  using namespace repro_torch;
  if (rows == 0) return cudaSuccess;
  if (rows < 0 || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float>(x, w, out, rows, d, eps, s);
    case kBFloat16: return launch<__nv_bfloat16>(x, w, out, rows, d, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
