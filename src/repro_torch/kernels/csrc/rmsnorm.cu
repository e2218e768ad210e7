// RMSNorm forward for Hopper (sm_90a), with the model's prologue fused in.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (body _rms_kernel): out = x * rsqrt(mean(x^2) + eps) * w per row, f32
// math, output in x's dtype.  Two optional operands fuse what the models
// do in front of the norm (the TPU kernel has neither; XLA fuses them
// there):
//   residual r: h = round(x + r) is written out, and out = rmsnorm(h) * w
//               (the pre-norm block's residual add);
//   gate z:     out = rmsnorm(round(x * round(silu(z)))) * w (Mamba2's
//               gated norm).
// "round" is the rounding to the storage dtype where the eager ops round,
// so h is bit-equal to the eager x + r, and out differs from the plain
// version only by the order of the f32 sum of squares.
//
// What bounds it on this card: neither bytes nor operations at the model's
// shapes.  Each element costs a few operations against 4 to 16 bytes read
// and written, far below the operations per byte at which compute becomes
// the limit, and a decode call (1 to 4 rows of 1536 to 4096) moves tens of
// kilobytes: a few nanoseconds of bandwidth against microseconds of launch
// latency.  So what the design cuts is launches: the add in front of every
// pre-norm, and the silu and the product in front of the gated norm, were
// a launch each.
//
// What the design does about it: one block per row; with fewer rows than
// SMs (a decode call) the block is sized to the row, one 16-byte pack a
// thread up to 1024 threads, so each thread has one short chain of work,
// and with more rows it has at most 256 threads; each thread keeps its part
// of the row (after the prologue) in registers between the sum of squares
// and the scale, so x, r and z are read from device memory once and h and
// out written once; 16-byte vector loads and stores wherever the row and
// pointers allow.  Rows wider than the registers hold (more than 4 packs
// a thread) or off the 16-byte grid take a loop that recomputes the
// prologue in the second pass.  The sum of squares is reduced with
// warp shuffles plus one shared-memory step across the block's warps.  No
// scratch in device memory, no atomics, nothing allocated.
//
// Backward (rmsnorm_bwd below; no TPU counterpart, the JAX package
// differentiates plain jnp): the gradients of the plain norm and of the
// residual form, ref.py::rmsnorm_bwd_ref and add_rmsnorm_bwd_ref.  Per row
// r = rsqrt(mean(x^2) + eps) and g = dy * w, then
//   dx = r g - x r^3 mean(g x)   (+ dh, the gradient of h, in residual
//                                 mode, where x is the h the forward wrote)
//   dw = sum over rows of dy x r.
// Bytes bound it, as the forward: x, dy (and dh) read once, dx written
// once.  What kept it from its bound was latency: a block per row paid a
// block-wide barrier for every row with one 16-byte pack a thread in
// flight, and the dw sum ran on a handful of SMs.  So, for rows that
// fit (16-byte aligned, at most 6 packs a lane: d <= 1536 in bf16, 768
// in f32):
//  (1) rmsnorm_bwd_rows: one warp per row, 8 warps a block, one block an
//      SM (a grid of at most the SM count, each warp walking its rows).
//      A lane loads all its packs of x and dy (and dh) at once, so a warp
//      has its whole row in flight (6 KB at d = 1536 in bf16, 48 KB an
//      SM); both row sums are warp shuffles, with no barrier.  Each warp
//      keeps dw for its lanes' columns in registers across its rows; the
//      block's 8 warps add theirs in a fixed tree through shared memory,
//      and the block writes one f32 row of partials.
//  (2) rmsnorm_bwd_dw: one block of 32 warps per 32 columns; warp w sums
//      partial rows w, w + 32, ... (lane = column), and warp 0 adds the
//      32 warp sums in order, then casts to w's dtype.
// Wider or unaligned rows keep the block-per-row kernel
// (rmsnorm_bwd_kernel), which walks rows blockIdx.x, blockIdx.x +
// gridDim.x, ... and writes its partial rows the same way.  Every sum is
// taken in a fixed order: deterministic, no atomics.
//
// The gated norm's backward (gated_rmsnorm_bwd, ref.py::
// gated_rmsnorm_bwd_ref) is the same two launches in a third mode: each
// element recomputes s = silu(z) and the norm's input g = x s in f32,
// rounded as the forward's prologue rounds them, takes (dg, dw) as above
// at g, and writes dx = dg s and dz = dg x sig(z) (1 + z (1 - sig(z))),
// each rounded once to the dtype.  Bytes bound it: x, z, dy read, dx, dz
// written, five row-sized streams.  At Mamba2-1.3b's d_inner (4096) a row
// is too wide for a warp's registers (16 packs a lane in bf16), and a
// block a row kept little in flight: the next row was read only after
// two block-wide reductions of this one, each behind a barrier, at two
// blocks an SM, and the gate's exp and divisions were taken twice an
// element.  So, for aligned rows of up to 4 packs a thread,
//  (3) gated_bwd_rows: a block of 256 threads a row, two blocks an SM,
//      each walking its rows.  The next row's x, z and dy are copied by
//      cp.async into the second of two shared-memory stages when a row
//      starts, so that they are in flight through its whole work and
//      hold no registers; each thread copies and reads only its own
//      16-byte packs, so the stages need no barrier.  The gate is taken
//      once an element (g, s and dz's factor kept in registers for the
//      second pass).  Both row sums are warp shuffles and one
//      shared-memory exchange behind one barrier, into two alternating
//      buffers so that no second barrier guards them.  w and the dw sums
//      stay in registers across the rows, and each block writes one row
//      of partials for (2), as (1) does.
// Narrower rows take (1), wider or unaligned ones the block-per-row
// kernel below; the plain and residual modes do not reach (3).
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxThreads = 1024;
enum Mode : int { kPlain = 0, kResidual = 1, kGate = 2 };

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The norm's input of pack i in f32, from x and (by MODE) r or z; with
// kResidual and store_h, h's pack is written to hrow.
template <typename T, int VEC, int MODE>
__device__ __forceinline__ void prologue(const Pack<T, VEC>* xr,
                                         const Pack<T, VEC>* orow,
                                         Pack<T, VEC>* hrow, int i,
                                         bool store_h, float (&v)[VEC]) {
  const Pack<T, VEC> xp = xr[i];
  if constexpr (MODE == kPlain) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32(xp.v[j]);
  } else if constexpr (MODE == kResidual) {
    const Pack<T, VEC> rp = orow[i];
    Pack<T, VEC> hp;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      hp.v[j] = from_f32<T>(to_f32(xp.v[j]) + to_f32(rp.v[j]));
      v[j] = to_f32(hp.v[j]);
    }
    if (store_h) hrow[i] = hp;
  } else {
    const Pack<T, VEC> zp = orow[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float z = to_f32(zp.v[j]);
      const float s = to_f32(from_f32<T>(z / (1.f + expf(-z))));
      v[j] = to_f32(from_f32<T>(to_f32(xp.v[j]) * s));
    }
  }
}

// The sum of v over the block (blockDim.x a multiple of 32).
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kMaxThreads / 32];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += warp_sums[i];
  return total;
}

// MAXP > 0: each thread holds at most MAXP packs of the row in registers;
// MAXP == 0: any width, the prologue recomputed in the second pass.
template <typename T, int VEC, int MAXP, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ other,
                   const T* __restrict__ w, T* __restrict__ out,
                   T* __restrict__ h, int d, float eps) {
  using P = Pack<T, VEC>;
  const size_t row = (size_t)blockIdx.x * d;
  const P* xr = reinterpret_cast<const P*>(x + row);
  const P* orow = reinterpret_cast<const P*>(MODE == kPlain ? x : other + row);
  P* hrow = reinterpret_cast<P*>(MODE == kResidual ? h + row : out + row);
  const P* wr = reinterpret_cast<const P*>(w);
  P* outr = reinterpret_cast<P*>(out + row);
  const int nvec = d / VEC;
  float ss = 0.f;

  if constexpr (MAXP > 0) {
    float v[MAXP][VEC];
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < nvec) {
        prologue<T, VEC, MODE>(xr, orow, hrow, i, true, v[k]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) ss += v[k][j] * v[k][j];
      }
    }
    const float inv = rsqrtf(block_sum(ss) / (float)d + eps);
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < nvec) {
        const P wp = wr[i];
        P op;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          op.v[j] = from_f32<T>(v[k][j] * inv * to_f32(wp.v[j]));
        outr[i] = op;
      }
    }
  } else {
    float v[VEC];
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      prologue<T, VEC, MODE>(xr, orow, hrow, i, true, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) ss += v[j] * v[j];
    }
    const float inv = rsqrtf(block_sum(ss) / (float)d + eps);
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      prologue<T, VEC, MODE>(xr, orow, hrow, i, false, v);
      const P wp = wr[i];
      P op;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        op.v[j] = from_f32<T>(v[j] * inv * to_f32(wp.v[j]));
      outr[i] = op;
    }
  }
}

// ---- backward ----------------------------------------------------------
constexpr int kBwdThreads = 256;

// (sum of a, sum of b) over the block (blockDim.x a multiple of 32); the
// block may call it again at once (the trailing barrier).
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 warp_sums[kBwdThreads / 32];
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
    t.x += warp_sums[i].x;
    t.y += warp_sums[i].y;
  }
  __syncthreads();
  return t;
}

// Mamba2's gate in front of the norm, as the forward's prologue computes
// it: s = silu(z) and the norm's input g = x * s, each rounded to T
// (returned: g); with sig = sigmoid(z), q = x sig (1 + z (1 - sig)) is
// dz's factor, dz = dg q.
template <typename T>
__device__ __forceinline__ float gate_in(float x, float z, float& s,
                                         float& q) {
  const float e = expf(-z);
  s = to_f32(from_f32<T>(z / (1.f + e)));
  const float sig = 1.f / (1.f + e);
  q = x * sig * (1.f + z * (1.f - sig));
  return to_f32(from_f32<T>(x * s));
}

// One element's share of the backward, from x, dy, w and (by MODE) dh or
// z, given the row's r and c = r^3 mean(dy w g): writes dx (and dz) into
// the packs' element j and adds to dw.
template <typename T, int MODE>
__device__ __forceinline__ void bwd_element(float xf, float df, float wf,
                                            float of, float r, float c,
                                            T& dx, T& dz, float& dw) {
  if constexpr (MODE == kGate) {
    float s, q;
    const float g = gate_in<T>(xf, of, s, q);
    const float dg = r * df * wf - g * c;
    dx = from_f32<T>(dg * s);
    dz = from_f32<T>(dg * q);
    dw += df * g * r;
  } else {
    float g = r * df * wf - xf * c;
    if constexpr (MODE == kResidual) g += of;
    dx = from_f32<T>(g);
    dw += df * xf * r;
  }
}

// The norm's input of one element: x, or with the gate g = x * silu(z).
template <typename T, int MODE>
__device__ __forceinline__ float norm_in(float xf, float of) {
  if constexpr (MODE == kGate) {
    float s, q;
    return gate_in<T>(xf, of, s, q);
  } else {
    return xf;
  }
}

// MODE: kPlain; kResidual (o = dh, added to dx); kGate (o = z, dz
// written).  MAXP > 0: each thread holds at most MAXP packs of a row in
// registers and its dw partial there too; MAXP == 0: any width, the row
// read twice and the dw partial kept in this block's row of `partial`.
template <typename T, int VEC, int MAXP, int MODE>
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ dy, const T* __restrict__ o,
                       T* __restrict__ dx, T* __restrict__ dz,
                       float* __restrict__ partial, int rows, int d,
                       float eps) {
  using P = Pack<T, VEC>;
  const int nvec = d / VEC;
  const P* wr = reinterpret_cast<const P*>(w);
  float* part = partial + (size_t)blockIdx.x * d;
  const float inv_d = 1.f / (float)d;

  if constexpr (MAXP > 0) {
    float dw[MAXP][VEC];
#pragma unroll
    for (int k = 0; k < MAXP; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) dw[k][j] = 0.f;
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
      const size_t off = (size_t)row * d;
      const P* xr = reinterpret_cast<const P*>(x + off);
      const P* dyr = reinterpret_cast<const P*>(dy + off);
      const P* orow =
          reinterpret_cast<const P*>(MODE == kPlain ? x : o + off);
      float xv[MAXP][VEC], dv[MAXP][VEC], ov[MAXP][VEC];
      float sxx = 0.f, sgx = 0.f;
#pragma unroll
      for (int k = 0; k < MAXP; ++k) {
        const int i = threadIdx.x + k * blockDim.x;
        if (i < nvec) {
          const P xp = xr[i], dp = dyr[i], wp = wr[i];
          P op;
          if constexpr (MODE != kPlain) op = orow[i];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            xv[k][j] = to_f32(xp.v[j]);
            dv[k][j] = to_f32(dp.v[j]);
            ov[k][j] = MODE != kPlain ? to_f32(op.v[j]) : 0.f;
            const float g = norm_in<T, MODE>(xv[k][j], ov[k][j]);
            sxx += g * g;
            sgx += dv[k][j] * to_f32(wp.v[j]) * g;
          }
        }
      }
      const float2 t = block_sum2(sxx, sgx);
      const float r = rsqrtf(t.x * inv_d + eps);
      const float c = r * r * r * t.y * inv_d;
#pragma unroll
      for (int k = 0; k < MAXP; ++k) {
        const int i = threadIdx.x + k * blockDim.x;
        if (i < nvec) {
          const P wp = wr[i];
          P xo, zo;
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            bwd_element<T, MODE>(xv[k][j], dv[k][j], to_f32(wp.v[j]),
                                 ov[k][j], r, c, xo.v[j], zo.v[j], dw[k][j]);
          reinterpret_cast<P*>(dx + off)[i] = xo;
          if constexpr (MODE == kGate) reinterpret_cast<P*>(dz + off)[i] = zo;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < nvec)
#pragma unroll
        for (int j = 0; j < VEC; ++j) part[i * VEC + j] = dw[k][j];
    }
  } else {
    // each thread owns the same columns in every row, so its partials need
    // no barrier between the zeroing and the sums
    for (int i = threadIdx.x; i < nvec; i += blockDim.x)
#pragma unroll
      for (int j = 0; j < VEC; ++j) part[i * VEC + j] = 0.f;
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
      const size_t off = (size_t)row * d;
      const P* xr = reinterpret_cast<const P*>(x + off);
      const P* dyr = reinterpret_cast<const P*>(dy + off);
      const P* orow =
          reinterpret_cast<const P*>(MODE == kPlain ? x : o + off);
      float sxx = 0.f, sgx = 0.f;
      for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
        const P xp = xr[i], dp = dyr[i], wp = wr[i];
        P op;
        if constexpr (MODE == kGate) op = orow[i];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float g = norm_in<T, MODE>(
              to_f32(xp.v[j]), MODE == kGate ? to_f32(op.v[j]) : 0.f);
          sxx += g * g;
          sgx += to_f32(dp.v[j]) * to_f32(wp.v[j]) * g;
        }
      }
      const float2 t = block_sum2(sxx, sgx);
      const float r = rsqrtf(t.x * inv_d + eps);
      const float c = r * r * r * t.y * inv_d;
      for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
        const P xp = xr[i], dp = dyr[i], wp = wr[i];
        P op, xo, zo;
        if constexpr (MODE != kPlain) op = orow[i];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          bwd_element<T, MODE>(to_f32(xp.v[j]), to_f32(dp.v[j]),
                               to_f32(wp.v[j]),
                               MODE != kPlain ? to_f32(op.v[j]) : 0.f, r, c,
                               xo.v[j], zo.v[j], part[i * VEC + j]);
        reinterpret_cast<P*>(dx + off)[i] = xo;
        if constexpr (MODE == kGate) reinterpret_cast<P*>(dz + off)[i] = zo;
      }
    }
  }
}

// One warp per row: see (1) in the header.  NP packs of VEC a lane.
constexpr int kRowWarps = 8;

// One block an SM: a lane holds up to 6 packs each of x, dy and dh (or z)
// and 6 VEC dw sums, which at 128 registers (two blocks an SM) spill.
template <typename T, int VEC, int NP, int MODE>
__global__ void __launch_bounds__(kRowWarps * 32, 1)
    rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ dy, const T* __restrict__ o,
                     T* __restrict__ dx, T* __restrict__ dz,
                     float* __restrict__ partial, int rows, int d,
                     float eps) {
  using P = Pack<T, VEC>;
  // the tree's upper halves, column (k VEC + j) 32 + lane: conflict free
  __shared__ float red[kRowWarps / 2][NP * VEC * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = d / VEC;
  const float inv_d = 1.f / (float)d;
  const P* wr = reinterpret_cast<const P*>(w);
  float dw[NP][VEC];
#pragma unroll
  for (int k = 0; k < NP; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) dw[k][j] = 0.f;

  for (int row = blockIdx.x * kRowWarps + warp; row < rows;
       row += gridDim.x * kRowWarps) {
    const size_t off = (size_t)row * d;
    const P* xr = reinterpret_cast<const P*>(x + off);
    const P* dyr = reinterpret_cast<const P*>(dy + off);
    P xp[NP], dp[NP], op[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = lane + 32 * k;
      if (i < nvec) {
        xp[k] = xr[i];
        dp[k] = dyr[i];
        if constexpr (MODE != kPlain)
          op[k] = reinterpret_cast<const P*>(o + off)[i];
      }
    }
    float sxx = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = lane + 32 * k;
      if (i < nvec) {
        const P wp = wr[i];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float g = norm_in<T, MODE>(
              to_f32(xp[k].v[j]), MODE == kGate ? to_f32(op[k].v[j]) : 0.f);
          sxx += g * g;
          sgx += to_f32(dp[k].v[j]) * to_f32(wp.v[j]) * g;
        }
      }
    }
    sxx = warp_sum(sxx);
    sgx = warp_sum(sgx);
    const float r = rsqrtf(sxx * inv_d + eps);
    const float c = r * r * r * sgx * inv_d;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = lane + 32 * k;
      if (i < nvec) {
        const P wp = wr[i];
        P xo, zo;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          bwd_element<T, MODE>(to_f32(xp[k].v[j]), to_f32(dp[k].v[j]),
                               to_f32(wp.v[j]),
                               MODE != kPlain ? to_f32(op[k].v[j]) : 0.f, r,
                               c, xo.v[j], zo.v[j], dw[k][j]);
        reinterpret_cast<P*>(dx + off)[i] = xo;
        if constexpr (MODE == kGate) reinterpret_cast<P*>(dz + off)[i] = zo;
      }
    }
  }

  // warp w += warp w + half, for half = 4, 2, 1: a fixed order
#pragma unroll
  for (int half = kRowWarps / 2; half > 0; half >>= 1) {
    if (warp >= half && warp < 2 * half)
#pragma unroll
      for (int k = 0; k < NP; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          red[warp - half][(k * VEC + j) * 32 + lane] = dw[k][j];
    __syncthreads();
    if (warp < half)
#pragma unroll
      for (int k = 0; k < NP; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          dw[k][j] += red[warp][(k * VEC + j) * 32 + lane];
    __syncthreads();
  }
  if (warp == 0) {
    float* part = partial + (size_t)blockIdx.x * d;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = lane + 32 * k;
      if (i < nvec)
#pragma unroll
        for (int j = 0; j < VEC; ++j) part[i * VEC + j] = dw[k][j];
    }
  }
}

// The gated norm's backward at rows of up to NP 16-byte packs a thread
// (kGate, aligned rows): see (3) in the header.  Each block walks rows
// blockIdx.x, blockIdx.x + gridDim.x, ...; w and the block's dw sums stay
// in registers across them.  Shared memory: two stages of a row's x, z
// and dy (3 d elements of T each), written and read by the same thread,
// so that they need no barrier.
template <typename T, int VEC, int NP>
__global__ void __launch_bounds__(kBwdThreads, 2)
    gated_bwd_rows(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ dy, const T* __restrict__ z,
                   T* __restrict__ dx, T* __restrict__ dz,
                   float* __restrict__ partial, int rows, int d,
                   float eps) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  P* ring = reinterpret_cast<P*>(ring_bytes);
  // two buffers: row k's exchange is read before row k + 1's barrier, so
  // row k + 2 may write it again with no barrier of its own
  __shared__ float2 red[2][kBwdThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = d / VEC;
  const float inv_d = 1.f / (float)d;
  P wp[NP];
  float dw[NP][VEC];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = threadIdx.x + k * kBwdThreads;
    if (i < nvec) wp[k] = reinterpret_cast<const P*>(w)[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) dw[k][j] = 0.f;
  }
  // stage s holds x, z, dy at ring[(3 s + 0, 1, 2) nvec + i]
  auto fetch = [&](int row, int s) {
    if (row < rows) {
      const size_t off = (size_t)row * d;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int i = threadIdx.x + k * kBwdThreads;
        if (i < nvec) {
          cp_async16(ring + (3 * s) * nvec + i, x + off + (size_t)i * VEC);
          cp_async16(ring + (3 * s + 1) * nvec + i,
                     z + off + (size_t)i * VEC);
          cp_async16(ring + (3 * s + 2) * nvec + i,
                     dy + off + (size_t)i * VEC);
        }
      }
    }
    cp_async_commit();      // a group every call: cp_async_wait<1> counts them
  };
  fetch(blockIdx.x, 0);
  int buf = 0, s = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, s ^= 1) {
    // the next row in flight through this one's work
    fetch(row + gridDim.x, s ^ 1);
    cp_async_wait<1>();            // this row's group has landed
    const P* xs = ring + (3 * s) * nvec;
    const P* zs = xs + nvec;
    const P* ds = zs + nvec;
    // the gate once an element: g = x s and dz's factor q, from x and z
    float g[NP][VEC], sg[NP][VEC], q[NP][VEC];
    float sxx = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = threadIdx.x + k * kBwdThreads;
      if (i < nvec) {
        const P xp = xs[i], zp = zs[i], dp = ds[i];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          g[k][j] = gate_in<T>(to_f32(xp.v[j]), to_f32(zp.v[j]), sg[k][j],
                               q[k][j]);
          sxx += g[k][j] * g[k][j];
          sgx += to_f32(dp.v[j]) * to_f32(wp[k].v[j]) * g[k][j];
        }
      }
    }
    sxx = warp_sum(sxx);
    sgx = warp_sum(sgx);
    if (lane == 0) red[buf][warp] = make_float2(sxx, sgx);
    __syncthreads();
    float2 t = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kBwdThreads / 32; ++i) {
      t.x += red[buf][i].x;
      t.y += red[buf][i].y;
    }
    buf ^= 1;
    const float r = rsqrtf(t.x * inv_d + eps);
    const float c = r * r * r * t.y * inv_d;
    const size_t off = (size_t)row * d;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = threadIdx.x + k * kBwdThreads;
      if (i < nvec) {
        const P dp = ds[i];
        P xo, zo;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float df = to_f32(dp.v[j]);
          const float dg = r * df * to_f32(wp[k].v[j]) - g[k][j] * c;
          xo.v[j] = from_f32<T>(dg * sg[k][j]);
          zo.v[j] = from_f32<T>(dg * q[k][j]);
          dw[k][j] += df * g[k][j] * r;
        }
        reinterpret_cast<P*>(dx + off)[i] = xo;
        reinterpret_cast<P*>(dz + off)[i] = zo;
      }
    }
  }
  float* part = partial + (size_t)blockIdx.x * d;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = threadIdx.x + k * kBwdThreads;
    if (i < nvec)
#pragma unroll
      for (int j = 0; j < VEC; ++j) part[i * VEC + j] = dw[k][j];
  }
}

// dw[col] = the sum of the nblk partial rows at col: see (2) in the header.
constexpr int kDwWarps = 32;

template <typename T>
__global__ void __launch_bounds__(kDwWarps * 32)
    rmsnorm_bwd_dw(const float* __restrict__ partial, T* __restrict__ dw,
                   int nblk, int d) {
  __shared__ float sums[kDwWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < d)
    for (int b = warp; b < nblk; b += kDwWarps) s += partial[(size_t)b * d + col];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < d) {
    float t = 0.f;
#pragma unroll 8
    for (int i = 0; i < kDwWarps; ++i) t += sums[i][lane];
    dw[col] = from_f32<T>(t);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The current device's SM count, read from the device once per device.
cudaError_t sm_count(int* sms) {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) cached[dev] = *sms;
  return err;
}

// Threads for each of `rows` rows of n items (packs or elements), in whole
// warps: one item each, up to kMaxThreads, when the rows leave SMs idle
// (a decode call's few rows: the shortest chain a thread); at most 256
// when they fill the card (a prefill: more blocks resident on each SM).
int threads_for(int rows, int sms, int n) {
  const int cap = rows < sms ? kMaxThreads : 256;
  const int warps = (n + 31) / 32;
  return warps * 32 < cap ? warps * 32 : cap;
}

template <typename T, int MODE>
cudaError_t launch(const void* x, const void* other, const void* w, void* out,
                   void* h, int rows, int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* ot = static_cast<const T*>(other);
  const T* wt = static_cast<const T*>(w);
  T* outt = static_cast<T*>(out);
  T* ht = static_cast<T*>(h);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const bool vec = d % kVec == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out) && (other == nullptr || aligned16(other)) &&
                   (h == nullptr || aligned16(h));
  if (!vec) {
    rmsnorm_kernel<T, 1, 0, MODE>
        <<<rows, threads_for(rows, sms, d), 0, stream>>>(xt, ot, wt, outt, ht,
                                                         d, eps);
    return cudaGetLastError();
  }
  const int threads = threads_for(rows, sms, d / kVec);
  const int packs = (d / kVec + threads - 1) / threads;
  if (packs <= 1)
    rmsnorm_kernel<T, kVec, 1, MODE><<<rows, threads, 0, stream>>>(
        xt, ot, wt, outt, ht, d, eps);
  else if (packs <= 2)
    rmsnorm_kernel<T, kVec, 2, MODE><<<rows, threads, 0, stream>>>(
        xt, ot, wt, outt, ht, d, eps);
  else if (packs <= 4)
    rmsnorm_kernel<T, kVec, 4, MODE><<<rows, threads, 0, stream>>>(
        xt, ot, wt, outt, ht, d, eps);
  else
    rmsnorm_kernel<T, kVec, 0, MODE><<<rows, threads, 0, stream>>>(
        xt, ot, wt, outt, ht, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(const void* x, const void* r, const void* z,
                        const void* w, void* out, void* h, int rows, int d,
                        float eps, cudaStream_t s) {
  if (r != nullptr)
    return launch<T, kResidual>(x, r, w, out, h, rows, d, eps, s);
  if (z != nullptr) return launch<T, kGate>(x, z, w, out, h, rows, d, eps, s);
  return launch<T, kPlain>(x, nullptr, w, out, h, rows, d, eps, s);
}

template <typename T, int VEC, int MODE>
cudaError_t launch_bwd_vec(const T* x, const T* w, const T* dy, const T* o,
                           T* dx, T* dz, float* partial, int rows, int d,
                           float eps, int nblk, cudaStream_t stream) {
  const int n = d / VEC;
  const int threads = n >= kBwdThreads ? kBwdThreads : (n + 31) / 32 * 32;
  const int packs = (n + threads - 1) / threads;
  if (packs <= 1)
    rmsnorm_bwd_kernel<T, VEC, 1, MODE><<<nblk, threads, 0, stream>>>(
        x, w, dy, o, dx, dz, partial, rows, d, eps);
  else if (packs <= 2)
    rmsnorm_bwd_kernel<T, VEC, 2, MODE><<<nblk, threads, 0, stream>>>(
        x, w, dy, o, dx, dz, partial, rows, d, eps);
  else if (packs <= 4)
    rmsnorm_bwd_kernel<T, VEC, 4, MODE><<<nblk, threads, 0, stream>>>(
        x, w, dy, o, dx, dz, partial, rows, d, eps);
  else
    rmsnorm_bwd_kernel<T, VEC, 0, MODE><<<nblk, threads, 0, stream>>>(
        x, w, dy, o, dx, dz, partial, rows, d, eps);
  return cudaGetLastError();
}

template <typename T, int NP, int MODE>
void launch_rows(const T* x, const T* w, const T* dy, const T* o, T* dx,
                 T* dz, float* partial, int rows, int d, float eps, int nblk,
                 cudaStream_t stream) {
  rmsnorm_bwd_rows<T, 16 / sizeof(T), NP, MODE>
      <<<nblk, kRowWarps * 32, 0, stream>>>(x, w, dy, o, dx, dz, partial,
                                            rows, d, eps);
}

template <typename T, int MODE>
void launch_rows_np(int np, const T* x, const T* w, const T* dy, const T* o,
                    T* dx, T* dz, float* partial, int rows, int d, float eps,
                    int nblk, cudaStream_t stream) {
  if (np <= 1)
    launch_rows<T, 1, MODE>(x, w, dy, o, dx, dz, partial, rows, d, eps, nblk,
                            stream);
  else if (np <= 2)
    launch_rows<T, 2, MODE>(x, w, dy, o, dx, dz, partial, rows, d, eps, nblk,
                            stream);
  else if (np <= 4)
    launch_rows<T, 4, MODE>(x, w, dy, o, dx, dz, partial, rows, d, eps, nblk,
                            stream);
  else
    launch_rows<T, 6, MODE>(x, w, dy, o, dx, dz, partial, rows, d, eps, nblk,
                            stream);
}

template <typename T, int VEC, int NP>
cudaError_t launch_gated(const T* x, const T* w, const T* dy, const T* z,
                         T* dx, T* dz, float* partial, int rows, int d,
                         float eps, int nblk, size_t ring,
                         cudaStream_t stream) {
  auto kernel = gated_bwd_rows<T, VEC, NP>;
  // above 48 KB a block's shared memory has to be opted into
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ring);
  if (err != cudaSuccess) return err;
  kernel<<<nblk, kBwdThreads, ring, stream>>>(x, w, dy, z, dx, dz, partial,
                                              rows, d, eps);
  return cudaGetLastError();
}

// The first launch of the backward (the rows, and a row of dw partials a
// block) for one MODE; *nblk is cut to the blocks it ran.
template <typename T, int MODE>
cudaError_t launch_bwd_rows(const T* x, const T* w, const T* dy, const T* o,
                            T* dx, T* dz, float* partial, int rows, int d,
                            float eps, int* nblk, bool vec,
                            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int np = (d / kVec + 31) / 32;        // packs a lane, a warp a row
  const int bp = (d / kVec + kBwdThreads - 1) / kBwdThreads;   // a block a row
  if (MODE == kGate && vec && np > 6 && bp <= 4) {
    // two blocks an SM, each with two stages of a row in shared memory
    int sms = 0;
    cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    *nblk = *nblk < 2 * sms ? *nblk : 2 * sms;
    const size_t ring = 2 * 3 * (size_t)d * sizeof(T);
    if (bp <= 1)
      err = launch_gated<T, kVec, 1>(x, w, dy, o, dx, dz, partial, rows, d,
                                     eps, *nblk, ring, stream);
    else if (bp <= 2)
      err = launch_gated<T, kVec, 2>(x, w, dy, o, dx, dz, partial, rows, d,
                                     eps, *nblk, ring, stream);
    else
      err = launch_gated<T, kVec, 4>(x, w, dy, o, dx, dz, partial, rows, d,
                                     eps, *nblk, ring, stream);
    return err;
  }
  if (vec && np <= 6) {
    // a warp a row: one block an SM, at most one per kRowWarps rows
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    const int warp_blocks = (rows + kRowWarps - 1) / kRowWarps;
    *nblk = *nblk < warp_blocks ? *nblk : warp_blocks;
    *nblk = *nblk < sms ? *nblk : sms;
    launch_rows_np<T, MODE>(np, x, w, dy, o, dx, dz, partial, rows, d, eps,
                            *nblk, stream);
    return cudaGetLastError();
  }
  return vec ? launch_bwd_vec<T, kVec, MODE>(x, w, dy, o, dx, dz, partial,
                                             rows, d, eps, *nblk, stream)
             : launch_bwd_vec<T, 1, MODE>(x, w, dy, o, dx, dz, partial, rows,
                                          d, eps, *nblk, stream);
}

// o: dh (residual mode), z (gate mode, dz written) or null (plain).
template <typename T>
cudaError_t launch_bwd(int mode, const void* x, const void* w, const void* dy,
                       const void* o, void* dx, void* dz, void* dw,
                       float* partial, int rows, int d, int nblk, float eps,
                       cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* dyt = static_cast<const T*>(dy);
  const T* ot = static_cast<const T*>(o);
  T* dxt = static_cast<T*>(dx);
  T* dzt = static_cast<T*>(dz);
  const bool vec = d % kVec == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(dy) && aligned16(dx) &&
                   (o == nullptr || aligned16(o)) &&
                   (dz == nullptr || aligned16(dz));
  cudaError_t err;
  if (mode == kGate)
    err = launch_bwd_rows<T, kGate>(xt, wt, dyt, ot, dxt, dzt, partial, rows,
                                    d, eps, &nblk, vec, stream);
  else if (mode == kResidual)
    err = launch_bwd_rows<T, kResidual>(xt, wt, dyt, ot, dxt, dzt, partial,
                                        rows, d, eps, &nblk, vec, stream);
  else
    err = launch_bwd_rows<T, kPlain>(xt, wt, dyt, ot, dxt, dzt, partial, rows,
                                     d, eps, &nblk, vec, stream);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dw<T><<<(d + 31) / 32, kDwWarps * 32, 0, stream>>>(
      partial, static_cast<T*>(dw), nblk, d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x, dy, dx: (rows, d) contiguous; w, dw: (d,); dh: null (the plain
// norm) or (rows, d) contiguous (residual mode: x is the forward's h and
// dx = dh + the norm's input gradient); all of one dtype.  partial:
// (nblk, d) f32 scratch, 1 <= nblk <= rows: at most the grid of the first
// launch (the warp-per-row kernel takes at most one block per 8 rows),
// whose blocks each write one row of dw partials that the second launch
// sums.  Two launches on `stream`; returns the first cudaError_t.
extern "C" int rmsnorm_bwd(int dtype, const void* x, const void* w,
                           const void* dy, const void* dh, void* dx, void* dw,
                           float* partial, int rows, int d, int nblk,
                           float eps, void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || d <= 0 || nblk <= 0 || nblk > rows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = dh != nullptr ? kResidual : kPlain;
  switch (dtype) {
    case kFloat32:
      return launch_bwd<float>(mode, x, w, dy, dh, dx, nullptr, dw, partial,
                               rows, d, nblk, eps, s);
    case kBFloat16:
      return launch_bwd<__nv_bfloat16>(mode, x, w, dy, dh, dx, nullptr, dw,
                                       partial, rows, d, nblk, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

// The gated norm's backward: x, z, dy, dx, dz (rows, d) contiguous; w, dw
// (d,); all of one dtype; partial and the two launches as in rmsnorm_bwd.
// dx = dg silu(z) and dz = dg x silu'(z), with (dg, dw) the norm's
// backward at its input x silu(z).
extern "C" int gated_rmsnorm_bwd(int dtype, const void* x, const void* z,
                                 const void* w, const void* dy, void* dx,
                                 void* dz, void* dw, float* partial, int rows,
                                 int d, int nblk, float eps, void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || d <= 0 || nblk <= 0 || nblk > rows || z == nullptr ||
      dz == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_bwd<float>(kGate, x, w, dy, z, dx, dz, dw, partial, rows,
                               d, nblk, eps, s);
    case kBFloat16:
      return launch_bwd<__nv_bfloat16>(kGate, x, w, dy, z, dx, dz, dw,
                                       partial, rows, d, nblk, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

// x, out: (rows, d) contiguous; w: (d,); r, z and h null or (rows, d)
// contiguous; all of one dtype.  r (with h, which receives x + r) selects
// the residual prologue, z the gate; at most one of them.  Returns the
// cudaError_t of the launch.
extern "C" int rmsnorm_fwd(int dtype, const void* x, const void* r,
                           const void* z, const void* w, void* out, void* h,
                           int rows, int d, float eps, void* stream) {
  using namespace repro_torch;
  if (rows < 0 || d <= 0 || (r != nullptr && z != nullptr) ||
      ((r != nullptr) != (h != nullptr)))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_mode<float>(x, r, z, w, out, h, rows, d, eps, s);
    case kBFloat16:
      return launch_mode<__nv_bfloat16>(x, r, z, w, out, h, rows, d, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
