// Backward of the Mamba2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// No TPU counterpart: the JAX package differentiates its plain jnp SSD.
// This is the gradient of csrc/ssd.cu, which replaces the Pallas TPU
// kernel src/repro/kernels/ssd.py::ssd_chunk_kernel.  Per chunk r and
// head h, over the chunk's rows i, j < Q, with G = C B^T,
// Lm_ij = exp(cs_i - cs_j) [i >= j], att = G * Lm * dt_j,
// w_j = exp(cs_last - cs_j) dt_j, dA = dy x^T, dG = dA * Lm * dt_j,
// Pm = dA * att and u_j = sum_{n,p} B_jn x_jp dS_np
// (ref.py::ssd_chunk_bwd_ref):
//   dx    = att^T dy + (B * w) dS                               (Q x P)
//   dC    = dG B                                                (Q x N)
//   dB    = dG^T C + w * (x dS^T)                               (Q x N)
//   ddt_j = sum_i dA_ij G_ij Lm_ij + exp(cs_last - cs_j) u_j
//   dcs_i = sum_j Pm_ij - sum_k Pm_ki - w_i u_i (+ sum_j w_j u_j at the
//           last row)
// f32 in, f32 out.  dB and dC are written per head, (R,H,Q,N), even where
// B and C come with a head stride of 0: the caller sums them over the
// heads (autograd of the expand in ops.ssd_chunked, a deterministic sum).
//
// What bounds it on this card: operations.  At mamba2-1.3b's training
// shape (Q = 256, N = 128, P = 64) a (chunk, head) tile needs about
// 42 MFLOP over its causal pairs (the scores and dy x^T again, then
// att^T dy, dG B, dG^T C, and the two state-side products) against about
// 0.5 MB moved.  This first kernel does them as f32 FMAs on the CUDA
// cores (67 TFLOP/s), not the forward's 3xTF32 tensor-core products.
//
// What the design does.  A (Q, Q) f32 tile at Q = 256 is 256 KB, above
// the 227 KB of shared memory a block may use, so rows i and j are cut
// into 64-row tiles, and the work runs as two passes over the pairs of
// tiles at or below the diagonal, each recomputing the scores, so that
// every output has one writer and every sum a fixed order (no atomics;
// a replayed step is bit-identical):
//  (1) ssd_bwd_cols, one block per (j-tile, h, r): walks the i-tiles at
//      and below its diagonal and sums over i the column-side outputs dx,
//      dB, ddt and the column sums of Pm; it first adds the state-side
//      terms from dS.  It writes dcs_j = -colsum_j(Pm) - w_j u_j and, in
//      a scratch row, w_j u_j.
//  (2) ssd_bwd_rows, one block per (i-tile, h, r), launched after (1) on
//      the same stream: walks the j-tiles up to its diagonal and sums over
//      j the row-side outputs dC and the row sums of Pm, which it adds to
//      the dcs that (1) wrote; the block holding the chunk's last row also
//      adds sum_j w_j u_j, read from the scratch row in order.
// dcs leaves out the terms that cancel exactly: Pm_ii, in its row sum and
// its column sum, and at the last row w_last u_last, subtracted and added
// back.  So a chunk of one row gets dcs = 0 exactly, as the function's
// (cs enters only through differences), and no large equal terms are
// summed to cancel elsewhere.
// 256 threads a block as a 16 x 16 grid: thread (ty, tx) owns output rows
// ty + 16a (a < 4) and columns tx + 16c, so a 64 x 64 tile is 4 x 4 a
// thread and a 64 x 128 one 4 x 8.  Every operand is staged into shared
// memory by cp.async as it lies in device memory (rows of x, B, C, dy,
// dS) with an odd row stride, so that a product reads it conflict-free
// both along its rows and down its columns: the transposed products
// (att^T dy, dG^T C, x dS^T) need no transposed copies.  Rows past Q and
// columns past P and N are zero in shared memory and never stored, so any
// Q >= 1 is taken as it is; P <= 64 and N <= 128 (the accumulators a
// thread holds in registers).
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kTile = 64;           // rows of an i-tile and a j-tile
constexpr int kMaxP = 64, kMaxN = 128;
constexpr int kLdP = kMaxP + 1;     // odd row strides
constexpr int kLdN = kMaxN + 1;
constexpr int kLdT = kTile + 1;
constexpr int kPC = kMaxP / 16;     // columns a thread owns of a P-wide tile
constexpr int kNC = kMaxN / 16;     // ... of an N-wide tile

struct Args {
  const float* x;    // (R,H,Q,P)   forward inputs, strided over (r,h,q)
  const float* dt;   // (R,H,Q)
  const float* cs;   // (R,H,Q)
  const float* b;    // (R,H,Q,N)
  const float* c;    // (R,H,Q,N)
  const float* dy;   // (R,H,Q,P) contiguous
  const float* ds;   // (R,H,N,P) contiguous
  float* dx;         // (R,H,Q,P) contiguous
  float* ddt;        // (R,H,Q)
  float* dcs;        // (R,H,Q)
  float* db;         // (R,H,Q,N)
  float* dc;         // (R,H,Q,N)
  float* wu;         // (R,H,Q) scratch: w_j u_j, from pass (1) to (2)
  int H, Q, P, N;
  long long st[5][3];  // element strides over (r, h, q) of x, dt, cs, b, c
};

__device__ __forceinline__ const float* base(const float* p,
                                             const long long* st, int r,
                                             int h) {
  return p + (long long)r * st[0] + (long long)h * st[1];
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// `rows` rows [row0, row0 + rows) and `cols` columns of a (Q, width)
// matrix with row stride `stride` (contiguous columns) into dst (row
// stride ld), by cp.async; zeros past Q or width.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long stride, int row0, int rows,
                                      int Q, int width, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int row = idx / cols, col = idx % cols;
    const int q = row0 + row;
    if (q < Q && col < width)
      cp_async4(dst + row * ld + col, src + (long long)q * stride + col);
    else
      dst[row * ld + col] = 0.f;
  }
}

// kTile scalars [row0, row0 + kTile) of a length-Q vector with stride
// `stride`; zeros past Q.
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          long long stride, int row0, int Q) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    if (row0 + i < Q)
      cp_async4(dst + i, src + (long long)(row0 + i) * stride);
    else
      dst[i] = 0.f;
  }
}

// acc[a][c] += sum_{k < K} A(ty + 16a, k) * B(k, tx + 16c), with
// A(m, k) = As[m * AM + k * AK] and B(k, n) = Bs[k * BK + n * BN].
template <int NC, int AM, int AK, int BK, int BN>
__device__ __forceinline__ void mm(float (&acc)[4][NC], const float* As,
                                   const float* Bs, int K, int ty, int tx) {
  const float* a0 = As + ty * AM;
  const float* b0 = Bs + tx * BN;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[NC];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a0[r * 16 * AM + k * AK];
#pragma unroll
    for (int c = 0; c < NC; ++c) bv[c] = b0[c * 16 * BN + k * BK];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[4][NC]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
}

// The sum over the 16 threads of a row (tx = 0..15, neighbouring lanes).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + kTile) of a thread's (4 x NC) tile into a (Q, width)
// contiguous output.
template <int NC>
__device__ __forceinline__ void store(float* out, const float (&acc)[4][NC],
                                      int row0, int Q, int width, int ty,
                                      int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int q = row0 + ty + 16 * a;
    if (q >= Q) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < width) out[(long long)q * width + col] = acc[a][c];
    }
  }
}

// Shared memory of pass (1), in floats.
struct ColSmem {
  static constexpr int b = 0;                      // B_j   64 x kLdN
  static constexpr int x = b + kTile * kLdN;       // x_j   64 x kLdP
  static constexpr int c = x + kTile * kLdP;       // C_i   64 x kLdN
  static constexpr int dy = c + kTile * kLdN;      // dy_i  64 x kLdP
  static constexpr int ds = c;                     // dS    kMaxN x kLdP,
                                                   // before the i-tiles
  static constexpr int att = dy + kTile * kLdP;    // att(j, i) 64 x kLdT
  static constexpr int dg = att + kTile * kLdT;    // dG(j, i)  64 x kLdT
  static constexpr int dt = dg + kTile * kLdT;     // dt_j
  static constexpr int csj = dt + kTile;           // cs_j
  static constexpr int csi = csj + kTile;          // cs_i
  static constexpr int total = csi + kTile;
  static_assert(kMaxN * kLdP <= kTile * (kLdN + kLdP), "dS overlays C, dy");
};

// Shared memory of pass (2), in floats.
struct RowSmem {
  static constexpr int c = 0;                      // C_i   64 x kLdN
  static constexpr int dy = c + kTile * kLdN;      // dy_i  64 x kLdP
  static constexpr int b = dy + kTile * kLdP;      // B_j   64 x kLdN
  static constexpr int x = b + kTile * kLdN;       // x_j   64 x kLdP
  static constexpr int dg = x + kTile * kLdP;      // dG(i, j) 64 x kLdT
  static constexpr int dt = dg + kTile * kLdT;     // dt_j
  static constexpr int csj = dt + kTile;           // cs_j
  static constexpr int csi = csj + kTile;          // cs_i
  static constexpr int total = csi + kTile;
};

// Pass (1): grid (j-tiles, H, R), the j-tile with the most i-tiles first.
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_cols(Args a) {
  extern __shared__ __align__(16) float smem[];
  using S = ColSmem;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int jt = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int Q = a.Q, P = a.P, N = a.N;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int j0 = jt * kTile;

  const float* x = base(a.x, a.st[0], r, h);
  const float* dt = base(a.dt, a.st[1], r, h);
  const float* cs = base(a.cs, a.st[2], r, h);
  const float* b = base(a.b, a.st[3], r, h);
  const float* c = base(a.c, a.st[4], r, h);
  const long long xq = a.st[0][2], dtq = a.st[1][2], csq = a.st[2][2],
                  bq = a.st[3][2], cq = a.st[4][2];
  const long long rh = (long long)r * a.H + h;
  const float* dy = a.dy + rh * Q * P;
  const float* ds = a.ds + rh * N * P;

  stage(smem + S::b, kLdN, b, bq, j0, kTile, Q, N, kMaxN);
  stage(smem + S::x, kLdP, x, xq, j0, kTile, Q, P, kMaxP);
  stage(smem + S::ds, kLdP, ds, P, 0, kMaxN, N, P, kMaxP);
  stage_vec(smem + S::dt, dt, dtq, j0, Q);
  stage_vec(smem + S::csj, cs, csq, j0, Q);
  cp_async_wait_all();
  __syncthreads();

  const float cs_last = cs[(long long)(Q - 1) * csq];
  float wj[4], ej[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = ty + 16 * u;
    ej[u] = j0 + j < Q ? expf(cs_last - smem[S::csj + j]) : 0.f;
    wj[u] = ej[u] * smem[S::dt + j];
  }

  // ---- state side: dB = w * (x dS^T), dx = w * (B dS); u_j ----
  float db[4][kNC], dx[4][kPC];
  zero(db);
  mm<kNC, kLdP, 1, 1, kLdP>(db, smem + S::x, smem + S::ds, P, ty, tx);
  float ddt_p[4], dcs_p[4], wu[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kNC; ++k)
      s += smem[S::b + (ty + 16 * u) * kLdN + tx + 16 * k] * db[u][k];
    const float uj = row_sum(s);
#pragma unroll
    for (int k = 0; k < kNC; ++k) db[u][k] *= wj[u];
    // the row's sums are taken over tx below: one thread adds these
    wu[u] = wj[u] * uj;
    ddt_p[u] = tx == 0 ? ej[u] * uj : 0.f;
    dcs_p[u] = tx == 0 && j0 + ty + 16 * u != Q - 1 ? -wu[u] : 0.f;
  }
  zero(dx);
  mm<kPC, kLdN, 1, kLdP, 1>(dx, smem + S::b, smem + S::ds, N, ty, tx);
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int k = 0; k < kPC; ++k) dx[u][k] *= wj[u];
  __syncthreads();                  // dS (over C_i and dy_i) is read

  // ---- the i-tiles at and below the diagonal ----
  for (int it = jt; it < n_tiles; ++it) {
    const int i0 = it * kTile;
    stage(smem + S::c, kLdN, c, cq, i0, kTile, Q, N, kMaxN);
    stage(smem + S::dy, kLdP, dy, P, i0, kTile, Q, P, kMaxP);
    stage_vec(smem + S::csi, cs, csq, i0, Q);
    cp_async_wait_all();
    __syncthreads();

    // G(j, i) = B_j . C_i and dA(j, i) = x_j . dy_i: rows j, columns i
    float g[4][4], da[4][4];
    zero(g);
    zero(da);
    mm<4, kLdN, 1, 1, kLdN>(g, smem + S::b, smem + S::c, N, ty, tx);
    mm<4, kLdP, 1, 1, kLdP>(da, smem + S::x, smem + S::dy, P, ty, tx);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = ty + 16 * u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = tx + 16 * k;
        const bool keep = i0 + i < Q && i0 + i >= j0 + j;
        // exp only where kept: above the diagonal cs_i - cs_j may be
        // positive and large, and inf * 0 would be NaN
        const float lm =
            keep ? expf(smem[S::csi + i] - smem[S::csj + j]) : 0.f;
        const float ld = lm * smem[S::dt + j];
        const float att = g[u][k] * ld;
        ddt_p[u] += da[u][k] * g[u][k] * lm;
        if (i0 + i != j0 + j) dcs_p[u] -= da[u][k] * att;
        smem[S::att + j * kLdT + i] = att;
        smem[S::dg + j * kLdT + i] = da[u][k] * ld;
      }
    }
    __syncthreads();

    // dx += att^T dy_i, dB += dG^T C_i: k runs over i
    const int kend = min(kTile, Q - i0);
    mm<kPC, kLdT, 1, kLdP, 1>(dx, smem + S::att, smem + S::dy, kend, ty, tx);
    mm<kNC, kLdT, 1, kLdN, 1>(db, smem + S::dg, smem + S::c, kend, ty, tx);
    __syncthreads();                // C_i, dy_i, att, dG free
  }

  store(a.dx + rh * Q * P, dx, j0, Q, P, ty, tx);
  store(a.db + rh * Q * N, db, j0, Q, N, ty, tx);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float sd = row_sum(ddt_p[u]), sc = row_sum(dcs_p[u]);
    const int q = j0 + ty + 16 * u;
    if (tx == 0 && q < Q) {
      a.ddt[rh * Q + q] = sd;
      a.dcs[rh * Q + q] = sc;
      a.wu[rh * Q + q] = wu[u];
    }
  }
}

// Pass (2): grid (i-tiles, H, R), the i-tile with the most j-tiles first.
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_rows(Args a) {
  extern __shared__ __align__(16) float smem[];
  using S = RowSmem;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int Q = a.Q, P = a.P, N = a.N;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int it = n_tiles - 1 - (int)blockIdx.x, h = blockIdx.y,
            r = blockIdx.z;
  const int i0 = it * kTile;

  const float* x = base(a.x, a.st[0], r, h);
  const float* dt = base(a.dt, a.st[1], r, h);
  const float* cs = base(a.cs, a.st[2], r, h);
  const float* b = base(a.b, a.st[3], r, h);
  const float* c = base(a.c, a.st[4], r, h);
  const long long xq = a.st[0][2], dtq = a.st[1][2], csq = a.st[2][2],
                  bq = a.st[3][2], cq = a.st[4][2];
  const long long rh = (long long)r * a.H + h;
  const float* dy = a.dy + rh * Q * P;

  stage(smem + S::c, kLdN, c, cq, i0, kTile, Q, N, kMaxN);
  stage(smem + S::dy, kLdP, dy, P, i0, kTile, Q, P, kMaxP);
  stage_vec(smem + S::csi, cs, csq, i0, Q);

  float dc[4][kNC], rows[4] = {0.f, 0.f, 0.f, 0.f};
  zero(dc);
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    stage(smem + S::b, kLdN, b, bq, j0, kTile, Q, N, kMaxN);
    stage(smem + S::x, kLdP, x, xq, j0, kTile, Q, P, kMaxP);
    stage_vec(smem + S::dt, dt, dtq, j0, Q);
    stage_vec(smem + S::csj, cs, csq, j0, Q);
    cp_async_wait_all();
    __syncthreads();

    // G(i, j) = C_i . B_j and dA(i, j) = dy_i . x_j: rows i, columns j
    float g[4][4], da[4][4];
    zero(g);
    zero(da);
    mm<4, kLdN, 1, 1, kLdN>(g, smem + S::c, smem + S::b, N, ty, tx);
    mm<4, kLdP, 1, 1, kLdP>(da, smem + S::dy, smem + S::x, P, ty, tx);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = ty + 16 * u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = tx + 16 * k;
        const bool keep = i0 + i < Q && i0 + i >= j0 + j;
        const float ld =
            keep ? expf(smem[S::csi + i] - smem[S::csj + j]) * smem[S::dt + j]
                 : 0.f;
        const float dg = da[u][k] * ld;
        if (i0 + i != j0 + j) rows[u] += dg * g[u][k];   // Pm(i, j)
        smem[S::dg + i * kLdT + j] = dg;
      }
    }
    __syncthreads();

    // dC += dG B_j: k runs over j
    mm<kNC, kLdT, 1, kLdN, 1>(dc, smem + S::dg, smem + S::b,
                              min(kTile, Q - j0), ty, tx);
    __syncthreads();                // B_j, x_j, dG free
  }

  store(a.dc + rh * Q * N, dc, i0, Q, N, ty, tx);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float s = row_sum(rows[u]);
    const int q = i0 + ty + 16 * u;
    if (tx == 0 && q < Q) {
      float v = a.dcs[rh * Q + q] + s;
      if (q == Q - 1) {
        const float* wu = a.wu + rh * Q;
        for (int k = 0; k < Q - 1; ++k) v += wu[k];
      }
      a.dcs[rh * Q + q] = v;
    }
  }
}

}  // namespace
}  // namespace repro_torch

// x (R,H,Q,P), dt/cs (R,H,Q), b/c (R,H,Q,N): the forward's f32 inputs,
// any strides over their first three dimensions (15 of them in
// `strides`: x, dt, cs, b, c, each (r, h, q)), the last dimension of x, b,
// c contiguous.  dy (R,H,Q,P) and ds (R,H,N,P): f32, contiguous.  Outputs
// dx (R,H,Q,P), ddt and dcs (R,H,Q), db and dc (R,H,Q,N), and the scratch
// wu (R,H,Q): f32, contiguous.  1 <= P <= 64, 1 <= N <= 128, Q >= 1, R and
// H <= 65535.  Two launches on `stream`; returns the first cudaError_t.
extern "C" int ssd_chunk_bwd(const void* x, const void* dt, const void* cs,
                             const void* b, const void* c, const void* dy,
                             const void* ds, void* dx, void* ddt, void* dcs,
                             void* db, void* dc, void* wu, int R, int H,
                             int Q, int P, int N, const long long* strides,
                             void* stream) {
  using namespace repro_torch;
  if (R == 0 || H == 0) return cudaSuccess;
  if (R < 0 || H < 0 || R > 65535 || H > 65535 || Q < 1 || P < 1 ||
      P > kMaxP || N < 1 || N > kMaxN)
    return cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.cs = static_cast<const float*>(cs);
  a.b = static_cast<const float*>(b);
  a.c = static_cast<const float*>(c);
  a.dy = static_cast<const float*>(dy);
  a.ds = static_cast<const float*>(ds);
  a.dx = static_cast<float*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dcs = static_cast<float*>(dcs);
  a.db = static_cast<float*>(db);
  a.dc = static_cast<float*>(dc);
  a.wu = static_cast<float*>(wu);
  a.H = H;
  a.Q = Q;
  a.P = P;
  a.N = N;
  for (int t = 0; t < 5; ++t)
    for (int k = 0; k < 3; ++k) a.st[t][k] = strides[3 * t + k];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (Q + kTile - 1) / kTile;
  const dim3 grid(n_tiles, H, R);
  // above 48 KB a block's shared memory has to be opted into
  const size_t cols_bytes = ColSmem::total * sizeof(float);
  const size_t rows_bytes = RowSmem::total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cols, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cols_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_rows,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rows_bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_cols<<<grid, kThreads, cols_bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_rows<<<grid, kThreads, rows_bytes, st>>>(a);
  return cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
