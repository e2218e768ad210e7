// One bitonic compare-exchange stage for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/bitonic.py::
// bitonic_stage (body _bitonic_kernel): element i is paired with
// i ^ dist; with g = offset + i its global index, the stage is ascending
// at i iff (g & size) == 0, and i keeps the smaller of the pair iff
// (i < partner) == ascending(i).  ``offset`` is the global index of x[0]
// (0 for a whole array, shard * L for a shard).
//
// What bounds it on this card: bytes.  A stage is one compare per pair
// against 2 * L * itemsize bytes read and written: at the MGMark BS
// shard of 32768 f32 that is 256 KB, a fraction of a microsecond, so
// launch latency sets its time there; at L = 2^24 it is 134 MB, 0.040 ms
// at 3.35 TB/s.
//
// What the design does about it: the TPU kernel views its block as
// (?, 2, dist) and takes min/max of the two halves, with no per-element
// scatter.  Here the same pairing is an index map: thread p owns the pair
// i = (p / dist) * 2 * dist + p % dist, j = i + dist (dist a power of two,
// so a shift and a mask), which keeps consecutive threads on consecutive
// addresses for dist >= 32 and within one 256-byte span below that, so
// every load and store is coalesced and each element is read once and
// written once.  Each element's direction is taken from its own global
// index, as the reference does, so the kernel is the reference's function
// for every size, not only size >= 2 * dist.  The compare keeps one of
// the two values exactly (a select, no arithmetic), so the output is a
// permutation of the input.
//
// NaN: jnp.minimum propagates a NaN and this select does not order it.
// The MGMark inputs hold no NaN, and no test sends one.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bitonic_kernel(const T* __restrict__ x, T* __restrict__ out,
                   long long pairs, int log_dist, long long size,
                   long long offset) {
  const long long dist = 1LL << log_dist;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
       p < pairs; p += (long long)gridDim.x * kThreads) {
    const long long i = ((p >> log_dist) << (log_dist + 1)) + (p & (dist - 1));
    const long long j = i + dist;
    const T a = x[i], b = x[j];
    const bool b_less = b < a;
    const T lo = b_less ? b : a;
    const T hi = b_less ? a : b;
    const bool asc_i = ((offset + i) & size) == 0;
    const bool asc_j = ((offset + j) & size) == 0;
    out[i] = asc_i ? lo : hi;
    out[j] = asc_j ? hi : lo;
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long L, int log_dist,
                   long long size, long long offset, cudaStream_t stream) {
  const long long pairs = L / 2;
  long long blocks = (pairs + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  bitonic_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), pairs, log_dist, size,
      offset);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x, out: (L,) contiguous, of one dtype (0 f32, 2 int32); dist = 2^log_dist
// with 2 * dist dividing L.  Returns the cudaError_t of the launch.
extern "C" int bitonic_stage_fwd(int dtype, const void* x, void* out,
                                 long long L, int log_dist, long long size,
                                 long long offset, void* stream) {
  using namespace repro_torch;
  if (L == 0) return cudaSuccess;
  if (L < 0 || log_dist < 0 || log_dist > 62 || (L % (2LL << log_dist)) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(x, out, L, log_dist, size, offset, s);
    case kInt32:
      return launch<int32_t>(x, out, L, log_dist, size, offset, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
