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
// 42 MFLOP over its causal pairs against about 0.5 MB moved.  Every
// product runs on the tensor cores in 3xTF32 (tf32.cuh), f32's accuracy
// at a third of the TF32 rate, as the forward's do: one TF32 product
// alone misses the 1e-4 gate.
//
// What the design does.  Rows i and j are cut into 64-row tiles; the
// work is the pairs of tiles at or below the diagonal.  Two launches on
// one stream, each output with one writer and every sum in a fixed order
// (no atomics; a replayed step is bit-identical):
//  (1) ssd_bwd_cols, one block per (j-tile, chunk, head), j-tile 0 (the
//      most pairs) first: the state side from dS, then a walk over the
//      i-tiles at and below the diagonal.  For each, G(j, i) = B_j C_i^T
//      (k over N) and dA(j, i) = x_j dy_i^T (k over P) come out of the
//      mma in registers; the decay, dt and the mask make att and dG in
//      place, together with the row sums for ddt_j and dcs_j and the
//      column sums of Pm.  att and dG never leave the registers for the
//      column-side products dx_j += att^T dy_i and dB_j += dG^T C_i: an
//      mma accumulator holds columns 2t and 2t + 1 of its rows, so it
//      is taken as an A fragment whose k slots t and t + 4 stand for
//      columns 2t and 2t + 1, and the B fragment reads rows 2t and
//      2t + 1 of dy_i or C_i to match.  dG goes to a workspace, one
//      64 x 64 tile a pair, and Pm's column sums over the tile's rows to
//      another, for (2).  It writes dx, dB, ddt, dcs_j = -colsum_j(Pm) -
//      w_j u_j and, in a scratch row, w_j u_j.
//  (2) ssd_bwd_rows, one block per (i-tile, chunk, head), the i-tile
//      with the most pairs first: dC_i = sum over j-tiles of dG(i, j) B_j
//      from the workspace, and the row sums of Pm added to the dcs that
//      (1) wrote; the block holding the chunk's last row also adds
//      sum_j w_j u_j, read from the scratch row in order.
// So each product is taken once; the scores are not recomputed (the
// first kernel of this backward ran two passes on the CUDA cores, each
// taking G and dA again: about 66 MFLOP where 42 are needed).  The
// workspace costs 16 KB written and read again a pair, 84 MB at R = 8,
// H = 64, Q = 256.
// 8 warps a block.  In (1) warp w takes rows 16 (w % 4) of the j-tile and
// columns 32 (w / 4) of each i-tile, so the two column halves sum dx_j
// and dB_j apart; they are added, first half first, at the end.  In (2)
// warp w takes rows 16 (w % 4) of the i-tile and columns 64 (w / 4) of
// dC.  Each operand is split into its TF32 hi and lo planes once, as it
// is staged into shared memory (the forward splits each fragment as it
// loads it): cp.async puts a tile's f32 values into its hi plane, every
// 16-byte copy of the tile in flight at once, and each thread then
// splits the values it copied, in place.  Row strides are 4 mod 32 words
// in (1), where fragments are read along rows by ldmatrix and rows 2t,
// 2t + 1 by single loads, and 8 mod 32 in (2), where they are read down
// columns: no bank conflicts but in the state side's B_j dS.  Tiles on
// the diagonal skip the warps and k-steps wholly above it.  Rows past Q
// and columns past P and N are zero in shared memory and never stored,
// so any Q >= 1 is taken as it is; P <= 64 and N <= 128 (the
// accumulators a thread holds in registers).  At P = 64 and N = 128
// (mamba2-1.3b) both launches take an instance whose loop bounds are
// constants, which keeps (1) within its registers.
// What holds it back now: (1) holds 202 KB of shared memory, one block
// and 8 warps an SM, at 255 registers a thread; it issues about 7000
// instructions a warp an i-tile of which 576 are HMMA, the rest the
// fragments' loads, the f32 adds of each 3xTF32 step's fresh accumulator
// (kept: a product summed into the running accumulator inside the mma
// loses more), the decay and the index arithmetic.  (2) runs several
// times its share of the tensor cores' rate.
// dcs leaves out the terms that cancel exactly: Pm_ii, in its row sum and
// its column sum, and at the last row w_last u_last, subtracted and added
// back.  So a chunk of one row gets dcs = 0 exactly, as the function's
// (cs enters only through differences), and no large equal terms are
// summed to cancel elsewhere.
#include <stdint.h>

#include "common.cuh"
#include "tf32.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;       // 8 warps
constexpr int kTile = 64;           // rows of an i-tile and a j-tile
constexpr int kMaxP = 64, kMaxN = 128;
constexpr int kLdP = kMaxP + 4;     // (1): 4 mod 32 words
constexpr int kLdN = kMaxN + 4;
constexpr int kLdG = kTile + 8;     // (2): 8 mod 32 words
constexpr int kLdB = kMaxN + 8;
constexpr int kPairTile = kTile * kTile;

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
  float* wu;         // (R,H,Q) scratch: w_j u_j, from (1) to (2)
  float* gws;        // (R*H, pairs, 64, 64) scratch: dG of each pair, rows j
  float* pws;        // (R*H, tiles, Q) scratch: sum of Pm(i, j) over a j-tile
  int R, H, Q, P, N;
  int vec_x, vec_bc, vec_d;  // 16-byte loads of x / of B and C / of dy, dS
  long long st[5][3];  // element strides over (r, h, q) of x, dt, cs, b, c
};

__device__ __forceinline__ const float* base(const float* p,
                                             const long long* st, int r,
                                             int h) {
  return p + (long long)r * st[0] + (long long)h * st[1];
}

// Staging a kTile-row tile of a (nrows, width) matrix with row stride
// `stride` (contiguous columns), rows [row0, row0 + kTile) and columns
// [0, COLS), zeros past nrows or width, in two steps: stage_copy puts the
// f32 values into the hi plane (row stride ld), by 16-byte cp.async where
// `vec` (width and the stride multiples of 4, the rows 16-byte aligned),
// all of them in flight at once, else by plain loads; after
// the copies have landed, stage_split splits them in place into TF32 hi and
// lo, once a value.  Each thread splits the 16 bytes it copied, so the
// two steps need no barrier between them.
template <int COLS>
__device__ __forceinline__ void stage_copy(float* hi, int ld,
                                           const float* src,
                                           long long stride, int row0,
                                           int nrows, int width, bool vec) {
  constexpr int kVecs = kTile * COLS / 4 / kThreads;   // 16 B a thread
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int row = idx / (COLS / 4), col = 4 * (idx % (COLS / 4));
    float* d = hi + row * ld + col;
    const bool in = row0 + row < nrows;
    const float* s = src + (long long)(row0 + row) * stride + col;
    if (vec) {
      if (in && col < width)
        cp_async16(d, s);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) d[c] = in && col + c < width ? s[c] : 0.f;
    }
  }
}

template <int COLS>
__device__ __forceinline__ void stage_split(float* hi, float* lo, int ld) {
  constexpr int kVecs = kTile * COLS / 4 / kThreads;
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int o = idx / (COLS / 4) * ld + 4 * (idx % (COLS / 4));
    float4 l;
    *reinterpret_cast<float4*>(hi + o) =
        split_tf32(*reinterpret_cast<const float4*>(hi + o), l);
    *reinterpret_cast<float4*>(lo + o) = l;
  }
}

// The sum over the 4 lanes of an accumulator row (t = 0..3).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The sum over the 8 rows g of an accumulator column (lanes 4g + t).
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// acc[n] += A B_n over k < kend for the 16 x 8 tiles n < NT with
// 8 n + n_base < n_end: A (16 rows, k along its rows, split planes ah, al,
// row stride lda, at this lane's ldmatrix address) and B_n (k along the
// rows of a K-major tile, split planes bh, bl, row stride ldb, at this
// lane's ldmatrix address of tile pair 0).
template <int NT>
__device__ __forceinline__ void mm_kmajor(float (&acc)[NT][4],
                                          const float* ah, const float* al,
                                          const float* bh, const float* bl,
                                          int ldb, int kend, int n_base,
                                          int n_end) {
  for (int k0 = 0; k0 < kend; k0 += 8) {
    Frag fa;
    ldsm_x4(fa.hi, ah + k0);
    ldsm_x4(fa.lo, al + k0);
    // no break in an unrolled loop: acc's indices stay constants, and
    // acc stays in registers
#pragma unroll
    for (int n = 0; n < NT; n += 2)
      if (n_base + 8 * n < n_end) {
        uint32_t h[4], l[4];
        ldsm_x4(h, bh + 8 * n * ldb + k0);
        ldsm_x4(l, bl + 8 * n * ldb + k0);
        mma_3xtf32(acc[n], fa, h[0], h[1], l[0], l[1]);
        mma_3xtf32(acc[n + 1], fa, h[2], h[3], l[2], l[3]);
      }
  }
}

// acc[m] += A B_m, one k-step of 8, for the 16 x 8 tiles m < NT with
// 8 m < n_end: B_m (k down the rows: rows r0 and r1 stand for k slots t
// and t + 4, columns 8 m + g) from split planes bh, bl of row stride ld.
template <int NT>
__device__ __forceinline__ void mm_rows(float (&acc)[NT][4], const Frag& fa,
                                        const float* bh, const float* bl,
                                        int ld, int r0, int r1, int g,
                                        int n_end) {
#pragma unroll
  for (int m = 0; m < NT; ++m)
    if (8 * m < n_end) {
      const int o0 = r0 * ld + 8 * m + g, o1 = r1 * ld + 8 * m + g;
      mma_3xtf32(acc[m], fa, bits(bh[o0]), bits(bh[o1]), bits(bl[o0]),
                 bits(bl[o1]));
    }
}

// Shared memory of pass (1), in floats.
struct ColSmem {
  static constexpr int bh = 0, bl = bh + kTile * kLdN;        // B_j
  static constexpr int xh = bl + kTile * kLdN;                // x_j
  static constexpr int xl = xh + kTile * kLdP;
  static constexpr int ch = xl + kTile * kLdP;                // C_i
  static constexpr int cl = ch + kTile * kLdN;
  static constexpr int yh = cl + kTile * kLdN;                // dy_i
  static constexpr int yl = yh + kTile * kLdP;
  static constexpr int dt = yl + kTile * kLdP;                // dt_j
  static constexpr int csj = dt + kTile;                      // cs_j
  static constexpr int csi = csj + kTile;                     // cs_i
  static constexpr int red = csi + kTile;    // 4 x kTile: Pm's column sums
  static constexpr int rows = red + 4 * kTile;   // 3 x kTile: row sums
  static constexpr int total = rows + 3 * kTile;
  // before the i-tiles, dS (kMaxN x kLdP) over C_i and dy_i; after them,
  // the second column half's dx (kTile x kLdP) and dB (kTile x kLdN)
  static constexpr int sh = ch, sl = sh + kMaxN * kLdP;
  static constexpr int hx = ch, hb = hx + kTile * kLdP;
  static_assert(sl + kMaxN * kLdP <= dt && hb + kTile * kLdN <= dt,
                "overlays fit in C_i and dy_i");
};

// Pass (1): grid (j-tiles * R * H), the j-tile index slowest.  FULL: P
// and N at their maxima (mamba2-1.3b's 64 and 128), so that every loop
// bound is a constant.
template <bool FULL>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_cols(Args a) {
  extern __shared__ __align__(16) float smem[];
  using S = ColSmem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int js = warp & 3, ih = warp >> 2;
  const int Q = a.Q, P = FULL ? kMaxP : a.P, N = FULL ? kMaxN : a.N;
  const int P8 = (P + 7) & ~7, N8 = (N + 7) & ~7;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int RH = a.R * a.H;
  const int jt = (int)blockIdx.x / RH, rh = (int)blockIdx.x - jt * RH;
  const int r = rh / a.H, h = rh - r * a.H;
  const int j0 = jt * kTile;

  const float* x = base(a.x, a.st[0], r, h);
  const float* dt = base(a.dt, a.st[1], r, h);
  const float* cs = base(a.cs, a.st[2], r, h);
  const float* b = base(a.b, a.st[3], r, h);
  const float* c = base(a.c, a.st[4], r, h);
  const long long xq = a.st[0][2], dtq = a.st[1][2], csq = a.st[2][2],
                  bq = a.st[3][2], cq = a.st[4][2];
  const float* dy = a.dy + (long long)rh * Q * P;
  const float* ds = a.ds + (long long)rh * N * P;
  float* Bh = smem + S::bh;
  float* Bl = smem + S::bl;
  float* Xh = smem + S::xh;
  float* Xl = smem + S::xl;
  float* Ch = smem + S::ch;
  float* Cl = smem + S::cl;
  float* Yh = smem + S::yh;
  float* Yl = smem + S::yl;
  float* Sh = smem + S::sh;
  float* Sl = smem + S::sl;

  stage_copy<kMaxN>(Bh, kLdN, b, bq, j0, Q, N, a.vec_bc);
  stage_copy<kMaxP>(Xh, kLdP, x, xq, j0, Q, P, a.vec_x);
  // dS's kMaxN rows, as two tiles of kTile
  stage_copy<kMaxP>(Sh, kLdP, ds, P, 0, N, P, a.vec_d);
  stage_copy<kMaxP>(Sh + kTile * kLdP, kLdP, ds, P, kTile, N, P, a.vec_d);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool in = j0 + i < Q;
    smem[S::dt + i] = in ? dt[(long long)(j0 + i) * dtq] : 0.f;
    smem[S::csj + i] = in ? cs[(long long)(j0 + i) * csq] : 0.f;
  }
  cp_async_commit();
  cp_async_wait<0>();
  stage_split<kMaxN>(Bh, Bl, kLdN);
  stage_split<kMaxP>(Xh, Xl, kLdP);
  stage_split<kMaxP>(Sh, Sl, kLdP);
  stage_split<kMaxP>(Sh + kTile * kLdP, Sl + kTile * kLdP, kLdP);
  __syncthreads();

  // this thread's accumulator rows j0 + 16 js + g + 8 u
  const float cs_last = cs[(long long)(Q - 1) * csq];
  float csr[2], dtr[2], er[2], wr[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int jl = 16 * js + g + 8 * u;
    csr[u] = smem[S::csj + jl];
    dtr[u] = smem[S::dt + jl];
    er[u] = j0 + jl < Q ? expf(cs_last - csr[u]) : 0.f;
    wr[u] = er[u] * dtr[u];
  }
  // ldmatrix addresses: A fragments of rows 16 js (k along the row), and
  // B fragments of a pair of 8-row n-tiles of a K-major tile
  const int arow = 16 * js + lr + 8 * (lm & 1), acol = 4 * (lm >> 1);
  const int brow = 8 * (lm >> 1) + lr, bcol = 4 * (lm & 1);

  float dx[8][4], db[16][4];
  float up[2] = {0.f, 0.f};           // u_j over this warp's half of n
  zero(dx);
  zero(db);

  // ---- state side: dB = w * (x dS^T), dx = w * (B dS); u_j ----
  {
    // x dS^T for n in 64 ih + [0, 64)
    float acc[8][4];
    zero(acc);
    mm_kmajor(acc, Xh + arow * kLdP + acol, Xl + arow * kLdP + acol,
              Sh + (64 * ih + brow) * kLdP + bcol,
              Sl + (64 * ih + brow) * kLdP + bcol, kLdP, P8, 64 * ih, N8);
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = (16 * js + g + 8 * (e >> 1)) * kLdN + 64 * ih + 8 * m +
                      2 * t + (e & 1);
        up[e >> 1] += (Bh[o] + Bl[o]) * acc[m][e];
        acc[m][e] *= wr[e >> 1];
      }
    if (ih == 0) {
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) db[m][e] = acc[m][e];
    } else {
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) db[8 + m][e] = acc[m][e];
    }
    // B dS for p in 32 ih + [0, 32): dS read down its columns (k = n)
    float acc2[4][4];
    zero(acc2);
    for (int k0 = 0; k0 < N8; k0 += 8) {
      Frag fa;
      ldsm_x4(fa.hi, Bh + arow * kLdN + acol + k0);
      ldsm_x4(fa.lo, Bl + arow * kLdN + acol + k0);
      mm_rows(acc2, fa, Sh + 32 * ih, Sl + 32 * ih, kLdP, k0 + t, k0 + t + 4,
              g, P8 - 32 * ih);
    }
    if (ih == 0) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) dx[m][e] = acc2[m][e] * wr[e >> 1];
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) dx[4 + m][e] = acc2[m][e] * wr[e >> 1];
    }
  }
  __syncthreads();                  // dS (over C_i and dy_i) is read

  // ---- the i-tiles at and below the diagonal ----
  float ddt_p[2] = {0.f, 0.f}, dcs_p[2] = {0.f, 0.f};
  for (int it = jt; it < n_tiles; ++it) {
    const int i0 = it * kTile;
    stage_copy<kMaxN>(Ch, kLdN, c, cq, i0, Q, N, a.vec_bc);
    stage_copy<kMaxP>(Yh, kLdP, dy, P, i0, Q, P, a.vec_d);
    for (int i = threadIdx.x; i < kTile; i += kThreads)
      smem[S::csi + i] = i0 + i < Q ? cs[(long long)(i0 + i) * csq] : 0.f;
    cp_async_commit();
    cp_async_wait<0>();
    stage_split<kMaxN>(Ch, Cl, kLdN);
    stage_split<kMaxP>(Yh, Yl, kLdP);
    __syncthreads();

    const bool diag = it == jt;
    // on the diagonal, a warp whose columns all lie left of its rows
    // (i < j everywhere) has att = dG = 0
    const bool dead = diag && 32 * ih + 31 < 16 * js;
    // G(j, i) = B_j . C_i and dA(j, i) = x_j . dy_i: rows j, columns i
    float gs[4][4], da[4][4];
    zero(gs);
    zero(da);
    if (!dead) {
      mm_kmajor(gs, Bh + arow * kLdN + acol, Bl + arow * kLdN + acol,
                Ch + (32 * ih + brow) * kLdN + bcol,
                Cl + (32 * ih + brow) * kLdN + bcol, kLdN, N8, 0, kTile);
      mm_kmajor(da, Xh + arow * kLdP + acol, Xl + arow * kLdP + acol,
                Yh + (32 * ih + brow) * kLdP + bcol,
                Yl + (32 * ih + brow) * kLdP + bcol, kLdP, P8, 0, kTile);
    }
    // decay, dt and the causal mask; the row sums for ddt and dcs, Pm's
    // column sums; att and dG in place of G and dA
    float colp[4][2];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      colp[n][0] = colp[n][1] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = 16 * js + g + 8 * (e >> 1);
        const int il = 32 * ih + 8 * n + 2 * t + (e & 1);
        const int i = i0 + il, j = j0 + jl;
        // exp of -inf where masked: above the diagonal cs_i - cs_j may be
        // positive and large, and inf * 0 would be NaN
        const float lmv = expf(i < Q && i >= j
                                   ? smem[S::csi + il] - csr[e >> 1]
                                   : -INFINITY);
        const float ldv = lmv * dtr[e >> 1];
        ddt_p[e >> 1] += da[n][e] * gs[n][e] * lmv;
        const float att = gs[n][e] * ldv;
        const float pm = i != j ? da[n][e] * att : 0.f;
        dcs_p[e >> 1] -= pm;
        colp[n][e & 1] += pm;
        gs[n][e] = att;
        da[n][e] *= ldv;
      }
    }
    // dG to the workspace: the pair's 64 x 64 tile, rows j
    const int n_pairs = n_tiles * (n_tiles + 1) / 2;
    float* gw = a.gws + ((long long)rh * n_pairs + it * (it + 1) / 2 + jt) *
                            kPairTile;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        *reinterpret_cast<float2*>(
            gw + (16 * js + g + 8 * u) * kTile + 32 * ih + 8 * n + 2 * t) =
            make_float2(da[n][2 * u], da[n][2 * u + 1]);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float v = col_sum(colp[n][cc]);
        if (g == 0)
          smem[S::red + js * kTile + 32 * ih + 8 * n + 2 * t + cc] = v;
      }

    // dx_j += att^T dy_i and dB_j += dG^T C_i, k over this warp's 32 i:
    // the accumulators' columns 2t, 2t + 1 are the A fragment's k slots
    // t, t + 4
    if (!dead) {
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        // on the diagonal, k-steps whose columns all lie left of the
        // warp's rows add nothing
        if (!(diag && 32 * ih + 8 * kb + 7 < 16 * js)) {
          const int il = 32 * ih + 8 * kb + 2 * t;
          Frag fa;
          const uint32_t va[4] = {bits(gs[kb][0]), bits(gs[kb][2]),
                                  bits(gs[kb][1]), bits(gs[kb][3])};
          fa.set(va);
          mm_rows(dx, fa, Yh, Yl, kLdP, il, il + 1, g, P8);
          const uint32_t vg[4] = {bits(da[kb][0]), bits(da[kb][2]),
                                  bits(da[kb][1]), bits(da[kb][3])};
          fa.set(vg);
          mm_rows(db, fa, Ch, Cl, kLdN, il, il + 1, g, N8);
        }
    }
    __syncthreads();                // red complete; C_i, dy_i free
    if (threadIdx.x < kTile && i0 + (int)threadIdx.x < Q) {
      const float* rd = smem + S::red + threadIdx.x;
      a.pws[((long long)rh * n_tiles + jt) * Q + i0 + threadIdx.x] =
          rd[0] + rd[kTile] + rd[2 * kTile] + rd[3 * kTile];
    }
  }

  // ---- the two column halves added, first half first; the rows ----
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    ddt_p[u] = quad_sum(ddt_p[u]);
    dcs_p[u] = quad_sum(dcs_p[u]);
    up[u] = quad_sum(up[u]);
  }
  float* hx = smem + S::hx;
  float* hb = smem + S::hb;
  float* rows = smem + S::rows;
  if (ih == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jl = 16 * js + g + 8 * (e >> 1), col = 2 * t + (e & 1);
#pragma unroll
      for (int m = 0; m < 8; ++m) hx[jl * kLdP + 8 * m + col] = dx[m][e];
#pragma unroll
      for (int m = 0; m < 16; ++m) hb[jl * kLdN + 8 * m + col] = db[m][e];
    }
    if (t == 0)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jl = 16 * js + g + 8 * u;
        rows[jl] = ddt_p[u];
        rows[kTile + jl] = dcs_p[u];
        rows[2 * kTile + jl] = up[u];
      }
  }
  __syncthreads();
  if (ih == 0) {
    float* dxo = a.dx + (long long)rh * Q * P;
    float* dbo = a.db + (long long)rh * Q * N;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jl = 16 * js + g + 8 * (e >> 1), col = 2 * t + (e & 1);
      const int j = j0 + jl;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (j < Q && 8 * m + col < P)
          dxo[(long long)j * P + 8 * m + col] =
              dx[m][e] + hx[jl * kLdP + 8 * m + col];
#pragma unroll
      for (int m = 0; m < 16; ++m)
        if (j < Q && 8 * m + col < N)
          dbo[(long long)j * N + 8 * m + col] =
              db[m][e] + hb[jl * kLdN + 8 * m + col];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jl = 16 * js + g + 8 * u, j = j0 + jl;
      if (t == 0 && j < Q) {
        const float uj = up[u] + rows[2 * kTile + jl];
        const float wu = wr[u] * uj;
        a.ddt[(long long)rh * Q + j] = ddt_p[u] + rows[jl] + er[u] * uj;
        a.dcs[(long long)rh * Q + j] =
            dcs_p[u] + rows[kTile + jl] - (j != Q - 1 ? wu : 0.f);
        a.wu[(long long)rh * Q + j] = wu;
      }
    }
  }
}

// Shared memory of pass (2), in floats.
struct RowSmem {
  static constexpr int gh = 0, gl = gh + kTile * kLdG;        // dG(j, i)
  static constexpr int bh = gl + kTile * kLdG;                // B_j
  static constexpr int bl = bh + kTile * kLdB;
  static constexpr int total = bl + kTile * kLdB;
};

// Pass (2): grid (i-tiles * R * H), the i-tile with the most j-tiles
// first.  FULL as in (1).
template <bool FULL>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_rows(Args a) {
  extern __shared__ __align__(16) float smem[];
  using S = RowSmem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int is = warp & 3, nh = warp >> 2;
  const int Q = a.Q, N = FULL ? kMaxN : a.N;
  const int N8 = (N + 7) & ~7;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int RH = a.R * a.H;
  const int k = (int)blockIdx.x / RH, rh = (int)blockIdx.x - k * RH;
  const int it = n_tiles - 1 - k;
  const int r = rh / a.H, h = rh - r * a.H;
  const int i0 = it * kTile;
  const float* b = base(a.b, a.st[3], r, h);
  const long long bq = a.st[3][2];
  float* Gh = smem + S::gh;
  float* Gl = smem + S::gl;
  float* Bh = smem + S::bh;
  float* Bl = smem + S::bl;

  float dc[8][4];
  zero(dc);
  // the pair tiles (jt, it) of the workspace, jt = 0, 1, ..., it
  const float* gw0 =
      a.gws + ((long long)rh * n_pairs + it * (it + 1) / 2) * kPairTile;
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    stage_copy<kTile>(Gh, kLdG, gw0 + jt * kPairTile, kTile, 0, kTile, kTile,
                      true);
    stage_copy<kMaxN>(Bh, kLdB, b, bq, j0, Q, N, a.vec_bc);
    cp_async_commit();
    cp_async_wait<0>();
    stage_split<kTile>(Gh, Gl, kLdG);
    stage_split<kMaxN>(Bh, Bl, kLdB);
    __syncthreads();
    // rows j past Q hold zeros, and on the diagonal so do those past the
    // warp's last row i
    int kend = min(kTile, Q - j0);
    if (jt == it) kend = min(kend, 16 * is + 16);
    for (int k0 = 0; k0 < kend; k0 += 8) {
      // A(i, j) = dG(j, i): down the tile's columns
      const int o = (k0 + t) * kLdG + 16 * is + g;
      Frag fa;
      fa.hi[0] = bits(Gh[o]);
      fa.hi[1] = bits(Gh[o + 8]);
      fa.hi[2] = bits(Gh[o + 4 * kLdG]);
      fa.hi[3] = bits(Gh[o + 4 * kLdG + 8]);
      fa.lo[0] = bits(Gl[o]);
      fa.lo[1] = bits(Gl[o + 8]);
      fa.lo[2] = bits(Gl[o + 4 * kLdG]);
      fa.lo[3] = bits(Gl[o + 4 * kLdG + 8]);
      mm_rows(dc, fa, Bh + 64 * nh, Bl + 64 * nh, kLdB, k0 + t, k0 + t + 4,
              g, N8 - 64 * nh);
    }
    __syncthreads();                // dG and B_j free
  }

  float* dco = a.dc + (long long)rh * Q * N;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = i0 + 16 * is + g + 8 * (e >> 1);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int n = 64 * nh + 8 * m + 2 * t + (e & 1);
      if (i < Q && n < N) dco[(long long)i * N + n] = dc[m][e];
    }
  }
  if (threadIdx.x < kTile && i0 + (int)threadIdx.x < Q) {
    const int i = i0 + threadIdx.x;
    float v = a.dcs[(long long)rh * Q + i];
    for (int jt = 0; jt <= it; ++jt)
      v += a.pws[((long long)rh * n_tiles + jt) * Q + i];
    if (i == Q - 1) {
      const float* wu = a.wu + (long long)rh * Q;
      for (int q = 0; q < Q - 1; ++q) v += wu[q];
    }
    a.dcs[(long long)rh * Q + i] = v;
  }
}

template <bool FULL>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t st) {
  // above 48 KB a block's shared memory has to be opted into
  const size_t cols_bytes = ColSmem::total * sizeof(float);
  const size_t rows_bytes = RowSmem::total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cols<FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cols_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_rows<FULL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rows_bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_cols<FULL><<<grid, kThreads, cols_bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_rows<FULL><<<grid, kThreads, rows_bytes, st>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p, long long stride_r, long long stride_h,
               long long stride_q) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride_r % 4 == 0 &&
         stride_h % 4 == 0 && stride_q % 4 == 0;
}

}  // namespace
}  // namespace repro_torch

// x (R,H,Q,P), dt/cs (R,H,Q), b/c (R,H,Q,N): the forward's f32 inputs,
// any strides over their first three dimensions (15 of them in
// `strides`: x, dt, cs, b, c, each (r, h, q)), the last dimension of x, b,
// c contiguous.  dy (R,H,Q,P) and ds (R,H,N,P): f32, contiguous.  Outputs
// dx (R,H,Q,P), ddt and dcs (R,H,Q), db and dc (R,H,Q,N), and the scratch
// wu (R,H,Q), gws (R*H*T(T+1)/2, 64, 64) and pws (R,H,T,Q), T = ceil(Q /
// 64): f32, contiguous.  1 <= P <= 64, 1 <= N <= 128, Q >= 1, T R H < 2^31.
// Two launches on `stream`; returns the first cudaError_t.
extern "C" int ssd_chunk_bwd(const void* x, const void* dt, const void* cs,
                             const void* b, const void* c, const void* dy,
                             const void* ds, void* dx, void* ddt, void* dcs,
                             void* db, void* dc, void* wu, void* gws,
                             void* pws, int R, int H, int Q, int P, int N,
                             const long long* strides, void* stream) {
  using namespace repro_torch;
  if (R == 0 || H == 0) return cudaSuccess;
  const long long n_tiles = (Q + kTile - 1) / kTile;
  if (R < 0 || H < 0 || Q < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      n_tiles * R * H >= (1LL << 31))
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
  a.gws = static_cast<float*>(gws);
  a.pws = static_cast<float*>(pws);
  a.R = R;
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
  a.vec_d = P % 4 == 0 && aligned16(dy, 0, 0, 0) && aligned16(ds, 0, 0, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(n_tiles * R * H));
  return a.P == kMaxP && a.N == kMaxN ? launch<true>(a, grid, st)
                                      : launch<false>(a, grid, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
