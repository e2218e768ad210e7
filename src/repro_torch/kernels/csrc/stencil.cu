// Same-padded K x K 2-D stencil for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/stencil.py::stencil2d
// (body _stencil_kernel): out[y, x] = sum over (dy, dx) of
// kern[dy, dx] * img[y + dy - r, x + dx - r], r = K / 2, zero outside the
// image, f32 sums in (dy, dx) order, output in img's dtype.  K is 3 or 5.
//
// What bounds it on this card: bytes.  Each output costs K*K FMAs (9 or
// 25) against one element read and one written, 2 * H * W * itemsize
// bytes in all: at 4096 x 4096 f32 that is 134 MB, 0.040 ms at
// 3.35 TB/s, while 2 * K^2 * H * W operations take 0.005 ms on the f32
// cores.
//
// What the design does about it: the TPU kernel reads its row halos
// through three clamped BlockSpec views of the image.  Here one block
// owns a 32 x 64 output tile and stages the tile plus an r-wide halo on
// all four sides in shared memory, with coalesced loads (consecutive
// threads on consecutive columns) and zeros outside the image, so every
// input element is read from device memory about once (halos of
// neighbouring tiles mostly come from L2).  Each thread then computes 8
// outputs of one column from shared memory, the K*K weights in registers,
// with fmaf in the reference's (dy, dx) order, and stores them in img's
// dtype, masked at the ragged right and bottom edges.  Any H and W.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kTileW = 64;                 // output columns per block
constexpr int kTileH = 32;                 // output rows per block
constexpr int kThreadsX = 64;
constexpr int kThreadsY = 4;
constexpr int kRowsPerThread = kTileH / kThreadsY;

template <typename T, int K>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
    stencil_kernel(const T* __restrict__ img, const float* __restrict__ kern,
                   T* __restrict__ out, int H, int W) {
  constexpr int r = K / 2;
  constexpr int SW = kTileW + 2 * r;       // staged tile width
  constexpr int SH = kTileH + 2 * r;       // staged tile height
  __shared__ float tile[SH][SW];

  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  // the tile and its halo, zero outside the image
  for (int i = tid; i < SH * SW; i += kThreadsX * kThreadsY) {
    const int sy = i / SW, sx = i % SW;
    const int gy = y0 - r + sy, gx = x0 - r + sx;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = to_f32(img[(size_t)gy * W + gx]);
    tile[sy][sx] = v;
  }
  float w[K][K];
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int dx = 0; dx < K; ++dx) w[dy][dx] = kern[dy * K + dx];
  __syncthreads();

  const int tx = threadIdx.x;
  const int gx = x0 + tx;
  if (gx >= W) return;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int ty = threadIdx.y + j * kThreadsY;
    const int gy = y0 + ty;
    if (gy >= H) break;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
        acc = fmaf(w[dy][dx], tile[ty + dy][tx + dx], acc);
    out[(size_t)gy * W + gx] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* img, const float* kern, void* out, int H,
                   int W, int K, cudaStream_t stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  const dim3 block(kThreadsX, kThreadsY);
  const T* it = static_cast<const T*>(img);
  T* ot = static_cast<T*>(out);
  switch (K) {
    case 3:
      stencil_kernel<T, 3><<<grid, block, 0, stream>>>(it, kern, ot, H, W);
      break;
    case 5:
      stencil_kernel<T, 5><<<grid, block, 0, stream>>>(it, kern, ot, H, W);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// img, out: (H, W) contiguous, of one dtype; kern: (K, K) f32 contiguous,
// K in {3, 5}.  Returns the cudaError_t of the launch.
extern "C" int stencil2d_fwd(int dtype, const void* img, const void* kern,
                             void* out, int H, int W, int K, void* stream) {
  using namespace repro_torch;
  if (H == 0 || W == 0) return cudaSuccess;
  if (H < 0 || W < 0) return cudaErrorInvalidValue;
  const float* k = static_cast<const float*>(kern);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float>(img, k, out, H, W, K, s);
    case kBFloat16: return launch<__nv_bfloat16>(img, k, out, H, W, K, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
