// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/ssd.py::ssd_chunk_kernel
// (body _ssd_kernel).  Per chunk r and head h, over the chunk's rows
// i, j < Q:
//   att[i,j] = (C_i . B_j) * exp(cs_i - cs_j) * dt_j   for i >= j, else 0
//   y[i,:]   = sum_j att[i,j] * x[j,:]                              (Q x P)
//   s[n,:]   = sum_j B[j,n] * exp(cs_{Q-1} - cs_j) * dt_j * x[j,:]   (N x P)
// f32 in, f32 math (no TF32), f32 out.
//
// What bounds it on this card: operations.  At the serving path's main
// shape (Q = 256, N = 128, P = 64) a (chunk, head) tile needs about
// 17 MFLOP for its causal half against about 0.17 MB moved, about 100
// FLOP per byte, above the f32 cores' 20 FLOP per byte (67 TFLOP/s over
// 3.35 TB/s).
//
// What the design does about it.  The TPU kernel keeps the whole (Q,Q)
// tile in VMEM; at Q = 256 in f32 that is 256 KB, above the 227 KB a block
// may use.  So each block here owns one 64-row i-tile of one (r, h): it
// keeps C's rows in shared memory and streams the 64-row j-tiles of B and
// x up to the diagonal (j-tiles past it are all zero and never loaded).
// For each j-tile, 256 threads compute the 64 x 64 scores C_i . B_j in
// registers (4 x 4 per thread), scale and mask them, park them in shared
// memory, and add scores @ x_j into a 64 x P accumulator held in
// registers.  The chunk states are separate blocks of the same grid, one
// per (64-row n-tile, h, r), that stream (B * w)_j and x_j over all
// j-tiles.  i-tile blocks are numbered heaviest first, so the last
// blocks to start are the short ones.  Shared-memory rows of B and C are
// padded to an odd length, so the 16 rows a warp reads at one n fall in
// 16 banks.  Rows past Q (a short last chunk: Q = 77, Q = 1) are
// zero-filled on load and never stored, so any Q >= 1 is taken as it is.
// B and C may come with a head stride of 0 (G = 1 shared across heads):
// then every head reads the same rows and nothing is materialised per
// head.  Plain CUDA-core FMAs; tensor cores (wgmma, TMA) are later work.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;   // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kTile = 64;       // rows of an i-tile, a j-tile, an n-tile
constexpr int kSld = kTile + 1; // padded row of the scores tile

struct Args {
  const float* x;    // (R,H,Q,P)
  const float* dt;   // (R,H,Q)
  const float* cs;   // (R,H,Q)
  const float* b;    // (R,H,Q,N)
  const float* c;    // (R,H,Q,N)
  float* y;          // (R,H,Q,P) contiguous
  float* s;          // (R,H,N,P) contiguous
  int H, Q, P, N;
  // element strides over (r, h, q) of x, dt, cs, b, c; the last dimension
  // of x, b and c is contiguous
  long long st[5][3];
};

__device__ __forceinline__ const float* base(const float* p,
                                             const long long* st, int r,
                                             int h) {
  return p + (long long)r * st[0] + (long long)h * st[1];
}

// Rows [row0, row0 + kTile) of a (Q, width) matrix with row stride
// `stride` into dst (kTile x ld), zero past Q or past width.
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, long long stride,
                                          int row0, int Q, int width,
                                          int cols) {
  for (int idx = threadIdx.x; idx < kTile * cols; idx += kThreads) {
    const int row = idx / cols, col = idx % cols;
    const int q = row0 + row;
    dst[row * ld + col] =
        (q < Q && col < width) ? src[(long long)q * stride + col] : 0.f;
  }
}

template <int NB>   // P <= 16 * NB
__device__ void y_tile(const Args& a, int it, float* smem) {
  constexpr int PB = 16 * NB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r = blockIdx.z, h = blockIdx.y;
  const int Q = a.Q, N = a.N, P = a.P;
  const int ld = N | 1;
  float* Cs = smem;                  // kTile x ld
  float* Bs = Cs + kTile * ld;       // kTile x ld
  float* Xs = Bs + kTile * ld;       // kTile x PB
  float* Ss = Xs + kTile * PB;       // kTile x kSld
  float* dts = Ss + kTile * kSld;    // kTile
  float* css = dts + kTile;          // kTile

  const float* x = base(a.x, a.st[0], r, h);
  const float* dt = base(a.dt, a.st[1], r, h);
  const float* cs = base(a.cs, a.st[2], r, h);
  const float* b = base(a.b, a.st[3], r, h);
  const float* c = base(a.c, a.st[4], r, h);
  const long long xq = a.st[0][2], dtq = a.st[1][2], csq = a.st[2][2],
                  bq = a.st[3][2], cq = a.st[4][2];

  const int i0 = it * kTile;
  load_rows(Cs, ld, c, cq, i0, Q, N, N);
  float cs_i[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
    cs_i[u] = i < Q ? cs[(long long)i * csq] : 0.f;
  }
  float acc[4][NB];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < NB; ++v) acc[u][v] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();                 // the last tile's readers are done
    load_rows(Bs, ld, b, bq, j0, Q, N, N);
    load_rows(Xs, PB, x, xq, j0, Q, P, PB);
    if (threadIdx.x < kTile) {
      const int j = j0 + threadIdx.x;
      dts[threadIdx.x] = j < Q ? dt[(long long)j * dtq] : 0.f;
      css[threadIdx.x] = j < Q ? cs[(long long)j * csq] : 0.f;
    }
    __syncthreads();

    // scores C_i . B_j, rows ty + 16u, columns tx + 16v of the tile
    float sc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) sc[u][v] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) cv[u] = Cs[(ty + 16 * u) * ld + n];
#pragma unroll
      for (int v = 0; v < 4; ++v) bv[v] = Bs[(tx + 16 * v) * ld + n];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) sc[u][v] = fmaf(cv[u], bv[v], sc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + ty + 16 * u;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int jl = tx + 16 * v;
        const bool keep = i < Q && i >= j0 + jl;
        // exp only where kept: above the diagonal cs_i - cs_j may be
        // positive and large, and inf * 0 would be NaN
        Ss[(ty + 16 * u) * kSld + jl] =
            keep ? sc[u][v] * expf(cs_i[u] - css[jl]) * dts[jl] : 0.f;
      }
    }
    __syncthreads();

    // acc += scores @ x_j
    const int jn = min(kTile, Q - j0);
    for (int jj = 0; jj < jn; ++jj) {
      float sv[4], xv[NB];
#pragma unroll
      for (int u = 0; u < 4; ++u) sv[u] = Ss[(ty + 16 * u) * kSld + jj];
#pragma unroll
      for (int v = 0; v < NB; ++v) xv[v] = Xs[jj * PB + tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < NB; ++v) acc[u][v] = fmaf(sv[u], xv[v], acc[u][v]);
    }
  }

  float* y = a.y + ((long long)r * a.H + h) * (long long)Q * P;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
    if (i >= Q) continue;
#pragma unroll
    for (int v = 0; v < NB; ++v) {
      const int p = tx + 16 * v;
      if (p < P) y[(long long)i * P + p] = acc[u][v];
    }
  }
}

template <int NB>
__device__ void state_tile(const Args& a, int nt, float* smem) {
  constexpr int PB = 16 * NB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r = blockIdx.z, h = blockIdx.y;
  const int Q = a.Q, N = a.N, P = a.P;
  float* Bs = smem;                  // kTile (j) x kSld (n)
  float* Xs = Bs + kTile * kSld;     // kTile x PB
  float* ws = Xs + kTile * PB;       // kTile

  const float* x = base(a.x, a.st[0], r, h);
  const float* dt = base(a.dt, a.st[1], r, h);
  const float* cs = base(a.cs, a.st[2], r, h);
  const float* b = base(a.b, a.st[3], r, h);
  const long long xq = a.st[0][2], dtq = a.st[1][2], csq = a.st[2][2],
                  bq = a.st[3][2];
  const float cs_last = cs[(long long)(Q - 1) * csq];
  const int n0 = nt * kTile;

  float acc[4][NB];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < NB; ++v) acc[u][v] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += kTile) {
    __syncthreads();
    if (threadIdx.x < kTile) {
      const int j = j0 + threadIdx.x;
      ws[threadIdx.x] =
          j < Q ? expf(cs_last - cs[(long long)j * csq]) *
                      dt[(long long)j * dtq]
                : 0.f;
    }
    load_rows(Xs, PB, x, xq, j0, Q, P, PB);
    __syncthreads();                 // ws is ready
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
      const int row = idx / kTile, col = idx % kTile;
      const int j = j0 + row, n = n0 + col;
      Bs[row * kSld + col] =
          (j < Q && n < N) ? b[(long long)j * bq + n] * ws[row] : 0.f;
    }
    __syncthreads();

    const int jn = min(kTile, Q - j0);
    for (int jj = 0; jj < jn; ++jj) {
      float bv[4], xv[NB];
#pragma unroll
      for (int u = 0; u < 4; ++u) bv[u] = Bs[jj * kSld + ty + 16 * u];
#pragma unroll
      for (int v = 0; v < NB; ++v) xv[v] = Xs[jj * PB + tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < NB; ++v) acc[u][v] = fmaf(bv[u], xv[v], acc[u][v]);
    }
  }

  float* s = a.s + ((long long)r * a.H + h) * (long long)N * P;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int n = n0 + ty + 16 * u;
    if (n >= N) continue;
#pragma unroll
    for (int v = 0; v < NB; ++v) {
      const int p = tx + 16 * v;
      if (p < P) s[(long long)n * P + p] = acc[u][v];
    }
  }
}

// grid (i-tiles + n-tiles, H, R): the first i-tiles blocks compute y, the
// rest the chunk states.
template <int NB>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(Args a) {
  extern __shared__ float smem[];
  const int n_itiles = (a.Q + kTile - 1) / kTile;
  if ((int)blockIdx.x < n_itiles)
    y_tile<NB>(a, n_itiles - 1 - (int)blockIdx.x, smem);   // heaviest first
  else
    state_tile<NB>(a, (int)blockIdx.x - n_itiles, smem);
}

template <int NB>
cudaError_t launch(const Args& a, int R, cudaStream_t stream) {
  constexpr int PB = 16 * NB;
  const int ld = a.N | 1;
  const size_t y_floats = 2 * (size_t)kTile * ld + kTile * PB +
                          kTile * kSld + 2 * kTile;
  const size_t s_floats = (size_t)kTile * kSld + kTile * PB + kTile;
  const size_t bytes =
      (y_floats > s_floats ? y_floats : s_floats) * sizeof(float);
  auto kernel = ssd_chunk_kernel<NB>;
  // above 48 KB a block's shared memory has to be opted into
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int n_itiles = (a.Q + kTile - 1) / kTile;
  const int n_ntiles = (a.N + kTile - 1) / kTile;
  const dim3 grid(n_itiles + n_ntiles, a.H, R);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x (R,H,Q,P), dt/cs (R,H,Q), b/c (R,H,Q,N): f32, any strides over their
// first three dimensions (15 of them in `strides`: x, dt, cs, b, c, each
// (r, h, q)), the last dimension of x, b, c contiguous.  y (R,H,Q,P) and
// s (R,H,N,P): f32, contiguous.  1 <= P <= 128, 1 <= N <= 256, Q >= 1,
// R and H <= 65535.  Returns the cudaError_t of the launch.
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* cs,
                             const void* b, const void* c, void* y, void* s,
                             int R, int H, int Q, int P, int N,
                             const long long* strides, void* stream) {
  using namespace repro_torch;
  if (R == 0 || H == 0) return cudaSuccess;
  if (R < 0 || H < 0 || R > 65535 || H > 65535 || Q < 1 || P < 1 ||
      P > 128 || N < 1 || N > 256)
    return cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.cs = static_cast<const float*>(cs);
  a.b = static_cast<const float*>(b);
  a.c = static_cast<const float*>(c);
  a.y = static_cast<float*>(y);
  a.s = static_cast<float*>(s);
  a.H = H;
  a.Q = Q;
  a.P = P;
  a.N = N;
  for (int t = 0; t < 5; ++t)
    for (int k = 0; k < 3; ++k) a.st[t][k] = strides[3 * t + k];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P <= 16) return launch<1>(a, R, st);
  if (P <= 32) return launch<2>(a, R, st);
  if (P <= 64) return launch<4>(a, R, st);
  return launch<8>(a, R, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
