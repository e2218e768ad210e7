// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/ssd.py::ssd_chunk_kernel
// (body _ssd_kernel).  Per chunk r and head h, over the chunk's rows
// i, j < Q:
//   att[i,j] = (C_i . B_j) * exp(cs_i - cs_j) * dt_j   for i >= j, else 0
//   y[i,:]   = sum_j att[i,j] * x[j,:]                              (Q x P)
//   s[n,:]   = sum_j B[j,n] * exp(cs_{Q-1} - cs_j) * dt_j * x[j,:]   (N x P)
// f32 in, f32 out.
//
// What bounds it on this card: operations.  At the serving path's main
// shape (Q = 256, N = 128, P = 64) a (chunk, head) tile needs about
// 17 MFLOP for its causal half against about 0.17 MB moved, about 100
// FLOP per byte.  The three products run on the tensor cores in 3xTF32:
// each f32 operand a splits into hi = tf32(a) and lo = tf32(a - hi), and
// a * b is taken as lo*hi + hi*lo + hi*hi, accumulated in f32.  That keeps
// f32's accuracy (one TF32 product alone misses the 1e-4 gate) at a third
// of the 495 TFLOP/s TF32 rate, 165 TFLOP/s, against 67 for f32 FMAs.
// The instruction is mma.sync.m16n8k8 (tf32).  Its fragments come from
// shared memory by ldmatrix where k runs along a row (C, B and att) and
// by single loads where it runs down a column (x, and B in the states),
// so each operand is read in whichever orientation its product needs;
// wgmma's tf32 form takes both operands K-major only, which the
// transposed products here (att @ x, (B w)^T @ x) would need copies for.
// Each fragment is split as it is loaded (hi rounded to TF32 by integer
// ops, lo = a - hi in f32), and each k-step's three products go into a
// fresh accumulator added to the running sum in f32.  What sets the time
// in practice is the issue of those split, load and add instructions,
// not the tensor cores: the kernel runs at several times its 3xTF32 bound.
//
// What the design does about it.  The TPU kernel keeps the whole (Q,Q)
// tile in VMEM; at Q = 256 in f32 that is 256 KB, above the 227 KB a block
// may use.  So each block here owns one 64-row i-tile of one (r, h): it
// keeps C's rows in shared memory and walks the 64-row j-tiles of B and
// x up to the diagonal (j-tiles past it are all zero and never loaded).
// For each j-tile, 8 warps compute the 64 x 64 scores C_i . B_j (a
// 16 x 32 piece each), apply the decay exp(cs_i - cs_j), dt_j and the
// causal mask to the score fragments in registers on the CUDA cores,
// park att in shared memory, and add att @ x_j into a 64 x P accumulator
// held in registers (a 16 x P/2 piece per warp).  The copies are cp.async:
// B_{j+1} is in flight while att @ x_j multiplies, x_{j+1} while the next
// scores do.  The chunk states are separate blocks of the same grid, one
// per (64-row n-tile, h, r), that stream B_j (scaled by
// w_j = exp(cs_{Q-1} - cs_j) dt_j as it is read) and x_j through a
// double-buffered ring over all j-tiles.  i-tile blocks are numbered
// heaviest first, so the last blocks to start are the short ones.  Tiles
// on the diagonal skip the score pieces and the k-steps that lie wholly
// above it.  Shared-memory rows are padded (to 4 or 8 mod 32 words) so
// that every fragment load is free of bank conflicts.  Rows past Q (a
// short last chunk: Q = 77, Q = 1) and the padding of N and P to the
// mma's 8- and 16-wide granules are zero-filled in shared memory and
// never stored, so any Q >= 1 is taken as it is.  B and C may come with
// a head stride of 0 (G = 1 shared across heads): then every head reads
// the same rows and nothing is materialised per head.
#include <stdint.h>

#include "common.cuh"
#include "tf32.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kTile = 64;       // rows of an i-tile, a j-tile, an n-tile
constexpr int kLda = kTile + 4; // row of the att tile: 4 mod 32 words
constexpr int kLdw = kTile + 8; // row of a state block's B tile: 8 mod 32

struct Args {
  const float* x;    // (R,H,Q,P)
  const float* dt;   // (R,H,Q)
  const float* cs;   // (R,H,Q)
  const float* b;    // (R,H,Q,N)
  const float* c;    // (R,H,Q,N)
  float* y;          // (R,H,Q,P) contiguous
  float* s;          // (R,H,N,P) contiguous
  int H, Q, P, N;
  int vec_x, vec_bc; // rows of x / of B and C may be copied 16 B at a time
  // element strides over (r, h, q) of x, dt, cs, b, c; the last dimension
  // of x, b and c is contiguous
  long long st[5][3];
};

__device__ __forceinline__ const float* base(const float* p,
                                             const long long* st, int r,
                                             int h) {
  return p + (long long)r * st[0] + (long long)h * st[1];
}

// Rows [row0, row0 + kTile) and columns [col0, col0 + cols) of a
// (Q, width) matrix with row stride `stride` into dst (kTile x ld), by
// cp.async; zeros past Q or past width.  `vec`: 16-byte copies (the rows
// start 16-byte aligned, and width, col0 and cols are multiples of 4).
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, long long stride,
                                           int row0, int Q, int col0,
                                           int width, int cols, bool vec) {
  if (vec) {
    const int cv = cols / 4;
    for (int idx = threadIdx.x; idx < kTile * cv; idx += kThreads) {
      const int row = idx / cv, col = 4 * (idx % cv);
      float* d = dst + row * ld + col;
      const int q = row0 + row;
      if (q < Q && col0 + col < width)
        cp_async16(d, src + (long long)q * stride + col0 + col);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * cols; idx += kThreads) {
      const int row = idx / cols, col = idx % cols;
      float* d = dst + row * ld + col;
      const int q = row0 + row;
      if (q < Q && col0 + col < width)
        cp_async4(d, src + (long long)q * stride + col0 + col);
      else
        *d = 0.f;
    }
  }
}

// kTile scalars [row0, row0 + kTile) of a length-Q vector with stride
// `stride` into dst; zeros past Q.
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          long long stride, int row0, int Q) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    if (row0 + i < Q)
      cp_async4(dst + i, src + (long long)(row0 + i) * stride);
    else
      dst[i] = 0.f;
  }
}

// d += a * b for a B operand given as f32 bits (k = t, n = g) and
// (k = t + 4, n = g): split here, as it is loaded (tf32.cuh).
__device__ __forceinline__ void mma_3xtf32_split(float (&d)[4], const Frag& a,
                                                 uint32_t b0, uint32_t b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_3xtf32(d, a, bh0, bh1, bl0, bl1);
}

// Shared-memory layout of a y block, in floats.
struct YSmem {
  int ldc, ldx;
  int c, b, x, att, dt, cs, total;
  __host__ __device__ YSmem(int N8, int PB) {
    ldc = N8 + 4;       // 4 mod 32 words
    ldx = PB + 8;       // 8 or 24 mod 32 words
    c = 0;
    b = c + kTile * ldc;
    x = b + kTile * ldc;
    att = x + kTile * ldx;
    dt = att + kTile * kLda;
    cs = dt + kTile;
    total = cs + kTile;
  }
};

// Shared-memory layout of a state block, in floats: two stages of
// (B tile kTile x kLdw, x tile kTile x ldx, dt, cs).
struct SSmem {
  int ldx, stage, b, x, dt, cs, total;
  __host__ __device__ SSmem(int PB) {
    ldx = PB + 8;
    b = 0;
    x = b + kTile * kLdw;
    dt = x + kTile * ldx;
    cs = dt + kTile;
    stage = cs + kTile;
    total = 2 * stage;
  }
};

template <int NT>   // P <= 16 * NT: each warp owns NT n8-tiles of columns
__device__ void y_tile(const Args& a, int it, float* smem) {
  constexpr int PB = 16 * NT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = blockIdx.z, h = blockIdx.y;
  const int Q = a.Q, N = a.N, P = a.P;
  const int N8 = (N + 7) & ~7;
  const YSmem L(N8, PB);
  float* Cs = smem + L.c;
  float* Bs = smem + L.b;
  float* Xs = smem + L.x;
  float* As = smem + L.att;
  float* dts = smem + L.dt;
  float* css = smem + L.cs;

  const float* x = base(a.x, a.st[0], r, h);
  const float* dt = base(a.dt, a.st[1], r, h);
  const float* cs = base(a.cs, a.st[2], r, h);
  const float* b = base(a.b, a.st[3], r, h);
  const float* c = base(a.c, a.st[4], r, h);
  const long long xq = a.st[0][2], dtq = a.st[1][2], csq = a.st[2][2],
                  bq = a.st[3][2], cq = a.st[4][2];

  const int i0 = it * kTile;
  // warp tiles: scores rows rm..rm+15, columns cn..cn+31; y rows
  // rm..rm+15, columns cp..cp+PB/2-1
  const int rm = 16 * (warp & 3), cn = 32 * (warp >> 2);
  const int cp = (warp >> 2) * (PB / 2);
  // ldmatrix row addresses of this lane: tile m = lane / 8, row lane % 8;
  // A fragments (C rows, att rows) take tiles (rows +0/+8, k +0/+4), B
  // fragments of the scores (B rows) take (n-tile +0/+1, k +0/+4)
  const int lm = lane >> 3, lr = lane & 7;
  const float* ca = Cs + (rm + lr + 8 * (lm & 1)) * L.ldc + 4 * (lm >> 1);
  const float* bb = Bs + (cn + 8 * (lm >> 1) + lr) * L.ldc + 4 * (lm & 1);
  const float* aa = As + (rm + lr + 8 * (lm & 1)) * kLda + 4 * (lm >> 1);
  float cs_row[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = i0 + rm + g + 8 * u;
    cs_row[u] = i < Q ? cs[(long long)i * csq] : 0.f;
  }

  stage_rows(Cs, L.ldc, c, cq, i0, Q, 0, N, N8, a.vec_bc);
  stage_rows(Bs, L.ldc, b, bq, 0, Q, 0, N, N8, a.vec_bc);
  stage_vec(dts, dt, dtq, 0, Q);
  stage_vec(css, cs, csq, 0, Q);
  stage_rows(Xs, L.ldx, x, xq, 0, Q, 0, P, PB, a.vec_x);
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    const bool diag = jt == it;
    cp_async_wait<0>();
    __syncthreads();                 // B_j, x_j, dt_j, cs_j (and C) landed

    // ---- scores C_i . B_j: a 16 x 32 piece per warp ----
    float sc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    if (!(diag && cn > rm + 15)) {   // else wholly above the diagonal
      for (int k0 = 0; k0 < N8; k0 += 8) {
        uint32_t r[4];
        Frag fa;
        ldsm_x4(r, ca + k0);
        fa.set(r);
#pragma unroll
        for (int n = 0; n < 4; n += 2) {
          ldsm_x4(r, bb + 8 * n * L.ldc + k0);   // n-tiles n and n + 1
          mma_3xtf32_split(sc[n], fa, r[0], r[1]);
          mma_3xtf32_split(sc[n + 1], fa, r[2], r[3]);
        }
      }
    }
    // decay, dt and the causal mask on the fragments; att to shared memory
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = rm + g + 8 * (e >> 1), jl = cn + 8 * n + 2 * t + (e & 1);
        const int i = i0 + il, j = j0 + jl;
        const bool keep = i < Q && j <= i;
        // exp only where kept: above the diagonal cs_i - cs_j may be
        // positive and large, and inf * 0 would be NaN
        As[il * kLda + jl] =
            keep ? sc[n][e] * expf(cs_row[e >> 1] - css[jl]) * dts[jl] : 0.f;
      }
    __syncthreads();                 // att complete; B_j, dt_j, cs_j free
    if (!diag) {
      stage_rows(Bs, L.ldc, b, bq, j0 + kTile, Q, 0, N, N8, a.vec_bc);
      stage_vec(dts, dt, dtq, j0 + kTile, Q);
      stage_vec(css, cs, csq, j0 + kTile, Q);
      cp_async_commit();
    }

    // ---- y += att @ x_j: a 16 x PB/2 piece per warp ----
    int kend = min(kTile, Q - j0);
    if (diag) kend = min(kend, rm + 16);   // keys past the warp's last row
    const float* xb = Xs + t * L.ldx + cp + g;
    for (int k0 = 0; k0 < kend; k0 += 8) {
      uint32_t r[4];
      Frag fa;
      ldsm_x4(r, aa + k0);
      fa.set(r);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_3xtf32_split(acc[n], fa, bits(xb[k0 * L.ldx + 8 * n]),
                   bits(xb[(k0 + 4) * L.ldx + 8 * n]));
    }
    __syncthreads();                 // x_j and att free
    if (!diag) {
      stage_rows(Xs, L.ldx, x, xq, j0 + kTile, Q, 0, P, PB, a.vec_x);
      cp_async_commit();
    }
  }

  float* y = a.y + ((long long)r * a.H + h) * (long long)Q * P;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = i0 + rm + g + 8 * u;
    if (i >= Q) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = cp + 8 * n + 2 * t + e;
        if (p < P) y[(long long)i * P + p] = acc[n][2 * u + e];
      }
  }
}

template <int NT>
__device__ void state_tile(const Args& a, int nt, float* smem) {
  constexpr int PB = 16 * NT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = blockIdx.z, h = blockIdx.y;
  const int Q = a.Q, N = a.N, P = a.P;
  const SSmem L(PB);

  const float* x = base(a.x, a.st[0], r, h);
  const float* dt = base(a.dt, a.st[1], r, h);
  const float* cs = base(a.cs, a.st[2], r, h);
  const float* b = base(a.b, a.st[3], r, h);
  const long long xq = a.st[0][2], dtq = a.st[1][2], csq = a.st[2][2],
                  bq = a.st[3][2];
  const float cs_last = cs[(long long)(Q - 1) * csq];
  const int n0 = nt * kTile;
  // 16-byte copies of B's n window need N and n0 in whole float4s
  const bool vec_b = a.vec_bc;
  // warp tile: states rows (n) rm..rm+15, columns (p) cp..cp+PB/2-1
  const int rm = 16 * (warp & 3), cp = (warp >> 2) * (PB / 2);

  auto stage = [&](int jt, int buf) {
    float* sm = smem + buf * L.stage;
    const int j0 = jt * kTile;
    stage_rows(sm + L.b, kLdw, b, bq, j0, Q, n0, N, kTile, vec_b);
    stage_rows(sm + L.x, L.ldx, x, xq, j0, Q, 0, P, PB, a.vec_x);
    stage_vec(sm + L.dt, dt, dtq, j0, Q);
    stage_vec(sm + L.cs, cs, csq, j0, Q);
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_jt = (Q + kTile - 1) / kTile;
  stage(0, 0);
  for (int jt = 0; jt < n_jt; ++jt) {
    const int j0 = jt * kTile;
    float* sm = smem + (jt & 1) * L.stage;
    if (jt + 1 < n_jt) {
      stage(jt + 1, (jt + 1) & 1);
      cp_async_wait<1>();            // this tile's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // w_j = exp(cs_last - cs_j) * dt_j over cs_j in place (0 past Q)
    for (int i = threadIdx.x; i < kTile; i += kThreads)
      sm[L.cs + i] = j0 + i < Q
                         ? expf(cs_last - sm[L.cs + i]) * sm[L.dt + i]
                         : 0.f;
    __syncthreads();

    // ---- states += (B_j w_j)^T @ x_j, k = j ----
    const float* Bs = sm + L.b;
    const float* ws = sm + L.cs;
    const float* xb = sm + L.x + t * L.ldx + cp + g;
    const int kend = min(kTile, Q - j0);
    for (int k0 = 0; k0 < kend; k0 += 8) {
      const float w0 = ws[k0 + t], w1 = ws[k0 + t + 4];
      const float* b0 = Bs + (k0 + t) * kLdw + rm + g;
      const float* b1 = Bs + (k0 + t + 4) * kLdw + rm + g;
      const uint32_t r[4] = {bits(b0[0] * w0), bits(b0[8] * w0),
                             bits(b1[0] * w1), bits(b1[8] * w1)};
      Frag fa;
      fa.set(r);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_3xtf32_split(acc[n], fa, bits(xb[k0 * L.ldx + 8 * n]),
                   bits(xb[(k0 + 4) * L.ldx + 8 * n]));
    }
    __syncthreads();                 // this stage is free for jt + 2
  }

  float* s = a.s + ((long long)r * a.H + h) * (long long)N * P;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int n = n0 + rm + g + 8 * u;
    if (n >= N) continue;
#pragma unroll
    for (int m = 0; m < NT; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = cp + 8 * m + 2 * t + e;
        if (p < P) s[(long long)n * P + p] = acc[m][2 * u + e];
      }
  }
}

// grid (i-tiles + n-tiles, H, R): the first i-tiles blocks compute y, the
// rest the chunk states.
template <int NT>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int n_itiles = (a.Q + kTile - 1) / kTile;
  if ((int)blockIdx.x < n_itiles)
    y_tile<NT>(a, n_itiles - 1 - (int)blockIdx.x, smem);   // heaviest first
  else
    state_tile<NT>(a, (int)blockIdx.x - n_itiles, smem);
}

template <int NT>
cudaError_t launch(const Args& a, int R, cudaStream_t stream) {
  constexpr int PB = 16 * NT;
  const int N8 = (a.N + 7) & ~7;
  const YSmem ly(N8, PB);
  const SSmem ls(PB);
  const size_t bytes =
      (size_t)(ly.total > ls.total ? ly.total : ls.total) * sizeof(float);
  auto kernel = ssd_chunk_kernel<NT>;
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

bool aligned16(const void* p, long long stride_r, long long stride_h,
               long long stride_q) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride_r % 4 == 0 &&
         stride_h % 4 == 0 && stride_q % 4 == 0;
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
  a.vec_x = P % 4 == 0 && aligned16(x, a.st[0][0], a.st[0][1], a.st[0][2]);
  a.vec_bc = N % 4 == 0 &&
             aligned16(b, a.st[3][0], a.st[3][1], a.st[3][2]) &&
             aligned16(c, a.st[4][0], a.st[4][1], a.st[4][2]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P <= 16) return launch<1>(a, R, st);
  if (P <= 32) return launch<2>(a, R, st);
  if (P <= 64) return launch<4>(a, R, st);
  return launch<8>(a, R, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
