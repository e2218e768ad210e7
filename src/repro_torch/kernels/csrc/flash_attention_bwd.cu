// Flash attention backward for Hopper (sm_90a).
//
// Replaces: nothing on the TPU.  The Pallas kernel
// src/repro/kernels/flash_attention.py::flash_attention has no backward
// (the JAX package trains through plain jnp attention, differentiated by
// jax.value_and_grad); the port's model routes its forward through
// csrc/flash_attention.cu, so its backward has to pass through a kernel
// too.  The arithmetic is ref.py::flash_attention_bwd_ref, step by step:
//
//   D  = rowsum(dO * O)                                   (launch a)
//   P  = exp(scale * Q K^T - lse), 0 where masked
//   dV = P^T dO,  dK = scale * dS^T Q,  dS = P * (dO V^T - D)  (launch b)
//   dQ = scale * dS K                                     (launch c)
//
// with lse the forward's log-sum-exp (stored by flash_attention.cu), the
// top-left causal mask kj <= qi of the forward, and dK, dV summed over the
// G = H / K q-heads that share a kv-head.  No atomics anywhere: every
// output element is written once, by one thread, after sums taken in a
// fixed order, so two runs on the same inputs give identical bits.
//
// What bounds it on this card: at the training shape (S = 1024, hd = 128,
// H = 12) about 2.5 times the forward's causal operations against
// O(S * hd * H) bytes, so operations: the tensor cores' 989 TFLOP/s for
// bf16.  The dK/dV and dQ launches recompute S and dP each (seven
// products where one fused launch would take five) so that neither needs
// atomics or a second pass over dQ.
//
// bf16: tensor cores (namespace tc below), on every head width the
// wrapper takes (16, 32, 64, 128).
//  (a) flash_bwd_prep: one thread per (batch, head, row) writes the pair
//      (lse * log2 e, 0) into an f32 scratch whose rows are padded to a
//      multiple of 64 with (+inf, 0), so a padded row's P is exp2(-inf) =
//      0 without a mask, and a 64-row tile of pairs is one aligned bulk
//      copy.  Then flash_bwd_dq_tc<HD, true> (launch c's kernel without
//      its dS and dQ) writes each row's D = sum_j P_j dP_j over all keys,
//      from the P and dP the next two launches recompute, into the pairs.
//      D = rowsum(dO * O) equals it only for the exact O: the forward's O
//      is rounded to bf16, whose error in D, times each key's share of P,
//      leaves sum_j dS_j = 0 off by it, and dQ = scale * sum_j dS_j K_j
//      carries that times the keys' mean K.  Where keys and values share
//      a large common part (whisper-base's cross-attention over 1500
//      encoder states) O is about the values' mean, its rounding outgrows
//      the spread of dP, and the bf16 gradients of wq and wk sat
//      0.02-0.03 (L2, relative) farther from f32 than the plain path's;
//      with this D the kernel path is within 1e-3 of the plain path's
//      distance (an H100, chip_smoke.py phase 15 (b);
//      tests/test_torch_tc_numerics.py shows the mechanism on the CPU).
//      The D launch costs two of the seven products' worth again.
//  (b) flash_bwd_dkdv_tc: a block of one warpgroup owns a 64-key tile of
//      one kv-head; its K and V tiles come in once by TMA.  Per 64-row q
//      tile, S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 from shared
//      memory, both operands K-major (the forward's S = Q K^T with the
//      roles swapped); P^T = exp2(S^T scale log2 e - lse log2 e), masked
//      only on the diagonal tile, and dS^T = P^T (dP^T - D) stay in the
//      accumulator's registers and are rounded to bf16 in its own fragment
//      layout, which is wgmma's A-from-registers layout; dV += P^T dO and
//      dK += dS^T Q are wgmma m64n{hd}k16 with dO and Q read MN-major
//      through the transpose bit, as the forward reads V, so no tile is
//      copied transposed.  Q, dO and the (lse, D) pairs of the q tile
//      stream through two stages on mbarriers: the next tile is in flight
//      while this one multiplies.  Keys past Skv need no mask (their rows
//      of dK and dV are not stored); rows past Sq have P = 0.
//      Work split: the G q-heads of a kv-head go to C blocks of one thread
//      block cluster (C the largest divisor of G up to 8, the portable
//      cluster size; each block loops over G / C heads), grid (K * C, B,
//      key tiles) with key tile 0 (the causal tile with the most q tiles)
//      on grid.z = 0, so the longest blocks start first.  At B = 2, K = 2,
//      G = 6, S = 1024 that is 384 blocks for 132 SMs, the longest 16 q
//      tiles against a mean of 8.5.  The C partial dK and dV meet through
//      distributed shared memory: each block stages its f32 accumulators
//      in its own (now idle) stage ring, the cluster synchronises, and
//      block r sums pairs r, r + C, ... of all C blocks in rank order and
//      stores them in bf16.  Nothing goes through device memory.
//      Registers: dK and dV accumulators of 64 x hd f32 over one
//      warpgroup are hd / 2 + hd / 2 = 128 a thread at hd = 128, S^T and
//      dP^T 32 each: 192 live at the peak, under the 255 a thread of a
//      128-thread block, so one warpgroup of 64 keys per block and 64-row
//      q tiles fit without spilling (ptxas's report in _build/*.log), two
//      blocks an SM (about 98 KB of shared memory each).
//  (c) flash_bwd_dq_tc: a block of one warpgroup per (64-row q tile,
//      q-head, batch row), heaviest q tiles first, as the forward: Q and
//      dO in once by TMA, K and V streaming through two stages; S = Q K^T
//      and dP = dO V^T from shared memory, dS in bf16 from registers, and
//      dQ += dS K with K read MN-major.  Its kDelta form runs first and
//      sums D instead (see (a)).
//  All four tiles (q, k, v, dO) come through 4-d tensor maps over the
//  caller's (batch, seq, head) strides, so views of one fused projection
//  are read in place; TMA's zero fill covers ragged S.  A refused copy
//  traps through mbar_wait's timeout instead of hanging.
//
// f32: the CUDA-core kernels (flash_bwd_dot, flash_bwd_dkdv, flash_bwd_dq
// below) are kept as they were: their 1e-4 gate against the plain version
// rules out TF32 products, as for the forward.
//  (a) one warp per (batch, head, row): D in f32 into a (B, H, Sq)
//      scratch the wrapper allocates.
//  (b) dK/dV: one block of 8 warps per (32-key tile, kv-head, batch row).
//      K and V of the tile are staged once, transposed with one column of
//      padding (bank-conflict free); the block loops over the G q-heads
//      of its group and, for each, over the 32-row q tiles at or below
//      the diagonal.  Per q tile each warp computes S and dP for 4 rows
//      with lane j owning key j (q and dO rows read as float4
//      broadcasts), writes P and dS to shared memory, and then every warp
//      accumulates its 1/8 of dK's and dV's columns for all 32 keys: the
//      GQA sum happens in registers, inside the block.
//  (c) dQ: one block of 4 warps per (32-row q tile, q-head, batch row),
//      looping over the 32-key tiles up to the diagonal, as the forward's
//      f32 kernel does; each warp recomputes P and dS for its 8 rows and
//      accumulates dQ with each lane owning hd/32 columns.
//  Ragged lengths are masked in the kernels: rows past Sq and keys past
//  Skv are staged as zeros and get P = 0.
#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kBK = 32;                    // keys per tile: one per lane

// ---- (a) D = rowsum(dO * O) -----------------------------------------------
constexpr int kDotWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kDotWarps * 32)
    flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
                  float* __restrict__ dd, int H, int Sq, int hd,
                  long long o_sb, long long o_ss, long long o_sh,
                  long long d_sb, long long d_ss, long long d_sh,
                  long long rows) {
  const long long row = (long long)blockIdx.x * kDotWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int i = (int)(row % Sq);
  const int h = (int)((row / Sq) % H);
  const long long b = row / ((long long)Sq * H);
  const T* orow = o + b * o_sb + i * o_ss + h * o_sh;
  const T* drow = dout + b * d_sb + i * d_ss + h * d_sh;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += to_f32(orow[d]) * to_f32(drow[d]);
  acc = warp_sum(acc);
  if (lane == 0) dd[row] = acc;    // row = (b * H + h) * Sq + i
}

// Operand strides of the backward, in elements: (batch, seq, head) of q,
// k, v and dO; dq, dk, dv are contiguous.
struct Strides {
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long d_sb, d_ss, d_sh;
};

// ---- (b) dK and dV --------------------------------------------------------
constexpr int kKvWarps = 8;
constexpr int kKvRows = 4;                 // rows per warp in the S/dP pass
constexpr int kKvBQ = kKvWarps * kKvRows;  // rows per q tile
constexpr int kKvThreads = kKvWarps * 32;

template <int HD>
struct KvSmem {
  float kt[HD][kBK + 1];   // the block's K tile, transposed and padded
  float vt[HD][kBK + 1];   // its V tile, the same
  float q[kKvBQ][HD];
  float dout[kKvBQ][HD];
  float p[kKvBQ][kBK];
  float ds[kKvBQ][kBK];
  float lse[kKvBQ];
  float dd[kKvBQ];
};

template <typename T, int HD>
__global__ void __launch_bounds__(kKvThreads)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dd, T* __restrict__ dk,
                   T* __restrict__ dv, int H, int K, int Sq, int Skv,
                   Strides st, float scale, int causal) {
  constexpr int CPW = HD / kKvWarps;       // dK/dV columns per warp: 2..16
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KvSmem<HD>& sm = *reinterpret_cast<KvSmem<HD>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const T* kb = k + b * st.k_sb + kvh * st.k_sh;
  const T* vb = v + b * st.v_sb + kvh * st.v_sh;

  for (int e = tid; e < kBK * HD; e += kKvThreads) {
    const int j = e / HD, d = e % HD, kj = k0 + j;
    const bool in = kj < Skv;
    sm.kt[d][j] = in ? to_f32(kb[kj * st.k_ss + d]) : 0.f;
    sm.vt[d][j] = in ? to_f32(vb[kj * st.v_ss + d]) : 0.f;
  }

  float dk_acc[CPW], dv_acc[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  const int kj = k0 + lane;                  // this lane's key
  const int r0 = warp * kKvRows;             // this warp's rows in S/dP
  const int c0 = warp * CPW;                 // its columns of dK/dV
  // rows qi >= k0 see a key of this tile under the top-left mask
  const int t_first = causal ? k0 / kKvBQ : 0;
  const int n_qt = (Sq + kKvBQ - 1) / kKvBQ;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + b * st.q_sb + h * st.q_sh;
    const T* db = dout + b * st.d_sb + h * st.d_sh;
    const float* lrow = lse + ((size_t)b * H + h) * Sq;
    const float* drow = dd + ((size_t)b * H + h) * Sq;
    for (int t = t_first; t < n_qt; ++t) {
      const int q0 = t * kKvBQ;
      __syncthreads();                     // the previous tile is consumed
      for (int e = tid; e < kKvBQ * HD; e += kKvThreads) {
        const int r = e / HD, d = e % HD, qi = q0 + r;
        const bool in = qi < Sq;
        sm.q[r][d] = in ? to_f32(qb[qi * st.q_ss + d]) : 0.f;
        sm.dout[r][d] = in ? to_f32(db[qi * st.d_ss + d]) : 0.f;
      }
      if (tid < kKvBQ) {
        const int qi = q0 + tid;
        sm.lse[tid] = qi < Sq ? lrow[qi] : 0.f;
        sm.dd[tid] = qi < Sq ? drow[qi] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T for this warp's rows, lane = key
      float s[kKvRows], dp[kKvRows];
#pragma unroll
      for (int r = 0; r < kKvRows; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        float kk[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = sm.kt[d + i][lane];
          vv[i] = sm.vt[d + i][lane];
        }
#pragma unroll
        for (int r = 0; r < kKvRows; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(&sm.q[r0 + r][d]);
          const float4 ov =
              *reinterpret_cast<const float4*>(&sm.dout[r0 + r][d]);
          s[r] += qv.x * kk[0] + qv.y * kk[1] + qv.z * kk[2] + qv.w * kk[3];
          dp[r] += ov.x * vv[0] + ov.y * vv[1] + ov.z * vv[2] + ov.w * vv[3];
        }
      }
#pragma unroll
      for (int r = 0; r < kKvRows; ++r) {
        const int qi = q0 + r0 + r;
        const bool ok = qi < Sq && kj < Skv && (!causal || kj <= qi);
        const float p = ok ? expf(s[r] * scale - sm.lse[r0 + r]) : 0.f;
        sm.p[r0 + r][lane] = p;
        sm.ds[r0 + r][lane] = p * (dp[r] - sm.dd[r0 + r]);
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: this warp's columns, all 32 keys
#pragma unroll 4
      for (int r = 0; r < kKvBQ; ++r) {
        const float p = sm.p[r][lane], ds = sm.ds[r][lane];
#pragma unroll
        for (int c = 0; c < CPW; c += 2) {
          const float2 ov =
              *reinterpret_cast<const float2*>(&sm.dout[r][c0 + c]);
          const float2 qv = *reinterpret_cast<const float2*>(&sm.q[r][c0 + c]);
          dv_acc[c] += p * ov.x;
          dv_acc[c + 1] += p * ov.y;
          dk_acc[c] += ds * qv.x;
          dk_acc[c + 1] += ds * qv.y;
        }
      }
    }
  }

  if (kj < Skv) {
    const size_t row = ((size_t)b * Skv + kj) * K + kvh;
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      dk[row * HD + c0 + c] = from_f32<T>(dk_acc[c] * scale);
      dv[row * HD + c0 + c] = from_f32<T>(dv_acc[c]);
    }
  }
}

// ---- (c) dQ ---------------------------------------------------------------
constexpr int kQWarps = 4;
constexpr int kQRows = 8;                  // rows per warp
constexpr int kQBQ = kQWarps * kQRows;     // rows per block
constexpr int kQThreads = kQWarps * 32;

template <int HD>
struct QSmem {
  float q[kQBQ][HD];
  float dout[kQBQ][HD];
  float kt[HD][kBK + 1];
  float vt[HD][kBK + 1];
  float ds[kQWarps][kQRows][kBK];
};

template <typename T, int HD>
__global__ void __launch_bounds__(kQThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 T* __restrict__ dq, int H, int K, int Sq, int Skv,
                 Strides st, float scale, int causal) {
  constexpr int DPL = HD >= 32 ? HD / 32 : 1;  // dQ columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QSmem<HD>& sm = *reinterpret_cast<QSmem<HD>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);
  const T* qb = q + b * st.q_sb + h * st.q_sh;
  const T* db = dout + b * st.d_sb + h * st.d_sh;
  const T* kb = k + b * st.k_sb + kvh * st.k_sh;
  const T* vb = v + b * st.v_sb + kvh * st.v_sh;

  for (int e = tid; e < kQBQ * HD; e += kQThreads) {
    const int r = e / HD, d = e % HD, qi = q0 + r;
    const bool in = qi < Sq;
    sm.q[r][d] = in ? to_f32(qb[qi * st.q_ss + d]) : 0.f;
    sm.dout[r][d] = in ? to_f32(db[qi * st.d_ss + d]) : 0.f;
  }

  const int row0 = q0 + warp * kQRows;
  float lse_r[kQRows], dd_r[kQRows], acc[kQRows][DPL];
#pragma unroll
  for (int r = 0; r < kQRows; ++r) {
    const int qi = row0 + r;
    const size_t at = ((size_t)b * H + h) * Sq + qi;
    lse_r[r] = qi < Sq ? lse[at] : 0.f;
    dd_r[r] = qi < Sq ? dd[at] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const int warp_last = min(row0 + kQRows, Sq) - 1;
  const int block_last = min(q0 + kQBQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, block_last + 1) : Skv;
  const int ntiles = (kv_end + kBK - 1) / kBK;
  const float* qw = &sm.q[warp * kQRows][0];
  const float* ow = &sm.dout[warp * kQRows][0];

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                       // the previous tile is consumed
    for (int e = tid; e < kBK * HD; e += kQThreads) {
      const int j = e / HD, d = e % HD, kj = k0 + j;
      const bool in = kj < Skv;
      sm.kt[d][j] = in ? to_f32(kb[kj * st.k_ss + d]) : 0.f;
      sm.vt[d][j] = in ? to_f32(vb[kj * st.v_ss + d]) : 0.f;
    }
    __syncthreads();
    // warp-uniform: no row here, or the tile lies above all its rows
    if (row0 >= Sq || (causal && k0 > warp_last)) continue;

    float s[kQRows], dp[kQRows];
#pragma unroll
    for (int r = 0; r < kQRows; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = sm.kt[d + i][lane];
        vv[i] = sm.vt[d + i][lane];
      }
#pragma unroll
      for (int r = 0; r < kQRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * HD + d);
        const float4 ov = *reinterpret_cast<const float4*>(ow + r * HD + d);
        s[r] += qv.x * kk[0] + qv.y * kk[1] + qv.z * kk[2] + qv.w * kk[3];
        dp[r] += ov.x * vv[0] + ov.y * vv[1] + ov.z * vv[2] + ov.w * vv[3];
      }
    }
    const int kj = k0 + lane;
#pragma unroll
    for (int r = 0; r < kQRows; ++r) {
      const int qi = row0 + r;
      const bool ok = qi < Sq && kj < Skv && (!causal || kj <= qi);
      const float p = ok ? expf(s[r] * scale - lse_r[r]) : 0.f;
      sm.ds[warp][r][lane] = p * (dp[r] - dd_r[r]);
    }
    __syncwarp();

    // dQ += dS K: lane owns columns lane + 32c, K read from the transposed
    // tile (bank (d + j) % 32: conflict free)
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float kk[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          kk[jj][c] = d < HD ? sm.kt[d][j + jj] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kQRows; ++r) {
        const float4 dsv =
            *reinterpret_cast<const float4*>(&sm.ds[warp][r][j]);
#pragma unroll
        for (int c = 0; c < DPL; ++c)
          acc[r][c] += dsv.x * kk[0][c] + dsv.y * kk[1][c] +
                       dsv.z * kk[2][c] + dsv.w * kk[3][c];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kQRows; ++r) {
    const int qi = row0 + r;
    if (qi >= Sq) continue;
    T* out = dq + (((size_t)b * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) out[d] = from_f32<T>(acc[r][c] * scale);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* dd, int B, int H,
                   int K, int Sq, int Skv, const long long* sp, float scale,
                   int causal, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  // sp: (batch, seq, head) strides of q, k, v, o, dout
  const Strides st{sp[0], sp[1], sp[2], sp[3], sp[4], sp[5],
                   sp[6], sp[7], sp[8], sp[12], sp[13], sp[14]};

  const long long rows = (long long)B * H * Sq;
  flash_bwd_dot<T><<<(unsigned)((rows + kDotWarps - 1) / kDotWarps),
                     kDotWarps * 32, 0, stream>>>(
      static_cast<const T*>(o), dt, dd, H, Sq, HD, sp[9], sp[10], sp[11],
      sp[12], sp[13], sp[14], rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // Above 48 KB a block's shared memory has to be opted into (per kernel
  // and device, so on every launch).
  constexpr int kKvSmem = sizeof(KvSmem<HD>);
  auto kv_kernel = flash_bwd_dkdv<T, HD>;
  err = cudaFuncSetAttribute(kv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kKvSmem);
  if (err != cudaSuccess) return err;
  kv_kernel<<<dim3((Skv + kBK - 1) / kBK, K, B), kKvThreads, kKvSmem,
              stream>>>(qt, kt, vt, dt, lse, dd, static_cast<T*>(dk),
                        static_cast<T*>(dv), H, K, Sq, Skv, st, scale,
                        causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int kQSmem = sizeof(QSmem<HD>);
  auto q_kernel = flash_bwd_dq<T, HD>;
  err = cudaFuncSetAttribute(q_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kQSmem);
  if (err != cudaSuccess) return err;
  q_kernel<<<dim3((Sq + kQBQ - 1) / kQBQ, H, B), kQThreads, kQSmem,
             stream>>>(qt, kt, vt, dt, lse, dd, static_cast<T*>(dq), H, K,
                       Sq, Skv, st, scale, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_hd_f32(int hd, const void* q, const void* k,
                            const void* v, const void* o, const float* lse,
                            const void* dout, void* dq, void* dk, void* dv,
                            float* dd, int B, int H, int K, int Sq, int Skv,
                            const long long* sp, float scale, int causal,
                            cudaStream_t s) {
  switch (hd) {
    case 16: return launch<float, 16>(q, k, v, o, lse, dout, dq, dk, dv, dd, B, H, K, Sq, Skv, sp, scale, causal, s);
    case 32: return launch<float, 32>(q, k, v, o, lse, dout, dq, dk, dv, dd, B, H, K, Sq, Skv, sp, scale, causal, s);
    case 64: return launch<float, 64>(q, k, v, o, lse, dout, dq, dk, dv, dd, B, H, K, Sq, Skv, sp, scale, causal, s);
    case 128: return launch<float, 128>(q, k, v, o, lse, dout, dq, dk, dv, dd, B, H, K, Sq, Skv, sp, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernels
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int kBM = 64;          // rows of every tile: 64 keys or 64 q rows
constexpr int kStages = 2;       // streamed tiles in flight
constexpr int kThreads = 128;    // one warpgroup
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kPrepWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg : Tile64<HD> {
  static constexpr int kRowBytes = kBM * 8;   // (lse log2 e, D) of 64 rows
  // two fixed tiles, kStages x two streamed tiles, kStages x 64 (lse, D)
  // pairs, three mbarriers, and slack to align to 1024 B
  static constexpr int kSmem = Tile64<HD>::kTileBytes * (2 + 2 * kStages) +
                               kStages * kRowBytes + 64 + 1024;
};

// ---- (a) (lse log2 e, 0) per row, rows padded to Sqp --------------------
// rl[(b * H + h) * Sqp + i] = (lse * log2 e, 0) for i < Sq and (+inf, 0)
// for Sq <= i < Sqp; the D launch fills in the second of each pair.
__global__ void __launch_bounds__(kPrepWarps * 32)
    flash_bwd_prep(const float* __restrict__ lse, float2* __restrict__ rl,
                   int Sq, int Sqp, long long rows) {
  const long long row = (long long)blockIdx.x * kPrepWarps * 32 + threadIdx.x;
  if (row >= rows) return;
  const int i = (int)(row % Sqp);
  rl[row] = make_float2(i < Sq ? lse[row / Sqp * Sq + i] * kLog2e : INFINITY,
                        0.f);
}

// Start the TMA loads of one 64-row tile from each of the maps ta and tb
// at (head, row0, b) into sa and sb, completing on bar (one thread);
// with `rows` non-null also the 64 (lse, D) pairs there into sr.
template <int HD>
__device__ __forceinline__ void load_tiles(const CUtensorMap* ta,
                                           const CUtensorMap* tb,
                                           uint32_t sa, uint32_t sb,
                                           uint32_t bar, int head, int row0,
                                           int b, const float2* rows,
                                           uint32_t sr) {
  using C = Cfg<HD>;
  mbar_expect_tx(bar, 2 * C::kTileBytes + (rows ? C::kRowBytes : 0));
#pragma unroll
  for (int c = 0; c < C::kBoxes; ++c) {
    tma_load_4d(sa + c * C::kBoxBytes, ta, bar, c * C::kCb, head, row0, b);
    tma_load_4d(sb + c * C::kBoxBytes, tb, bar, c * C::kCb, head, row0, b);
  }
  if (rows != nullptr) bulk_load(sr, rows, C::kRowBytes, bar);
}

// The accumulator of a wgmma with N columns gives thread (warp w, lane l)
// rows 16w + l/4 (registers 4j, 4j+1) and 16w + l/4 + 8 (4j+2, 4j+3),
// columns 8j + 2(l%4) + {0, 1}.  Its registers 8kk..8kk+7 of a 64-column
// accumulator, rounded to bf16 in pairs, are the A fragment of k-step kk
// of a product whose depth runs along those columns.

// ---- (b) dK and dV ---------------------------------------------------------
// grid (K * C, B, key tiles), cluster (C, 1, 1), block kThreads.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float2* __restrict__ rl,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int H, int K, int Sq,
                      int Sqp, int Skv, int nclu, float scale,
                      float scale_log2, int causal) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles want 1024-byte alignment (the swizzle repeats there)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + C::kTileBytes;
  // stage s: Q at ring + 2 s T, dO at ring + (2 s + 1) T
  const uint32_t ring = base + 2 * C::kTileBytes;
  const uint32_t srow = ring + 2 * kStages * C::kTileBytes;
  const uint32_t bar_kv = srow + kStages * C::kRowBytes;
  const uint32_t bar_st = bar_kv + 8;       // kStages barriers, 8 B each
  const float2* rows_sm = reinterpret_cast<const float2*>(smem_raw + (srow - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = H / K;
  const int kvh = blockIdx.x / nclu;
  const int rank = (int)cluster_rank();     // == blockIdx.x % nclu
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBM;          // causal: tile 0, the longest, first
  const int t_first = causal ? k0 / kBM : 0;
  const int nq = (Sq + kBM - 1) / kBM - t_first;
  const int total = (G / nclu) * nq;        // (head, q tile) pairs

  // iteration n: q-head kvh G + rank + (n / nq) C, q tile t_first + n % nq
  auto load_stage = [&](int n, int s) {
    const int h = kvh * G + rank + (n / nq) * nclu;
    const int q0 = (t_first + n % nq) * kBM;
    const uint32_t sq = ring + 2 * s * C::kTileBytes;
    load_tiles<HD>(&tq, &tdo, sq, sq + C::kTileBytes, bar_st + 8 * s, h, q0,
                   b, rl + ((size_t)b * H + h) * Sqp + q0,
                   srow + s * C::kRowBytes);
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(bar_st + 8 * s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_tiles<HD>(&tk, &tv, sk, sv, bar_kv, kvh, k0, b, nullptr, 0);
    for (int n = 0; n < kStages && n < total; ++n) load_stage(n, n);
  }

  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  const int krow = 16 * warp + (lane >> 2);   // keys k0 + krow, + 8
  const int col0 = 2 * (lane & 3);

  mbar_wait(bar_kv, 0);
  for (int n = 0; n < total; ++n) {
    const int s = n % kStages;
    const uint32_t sq = ring + 2 * s * C::kTileBytes;
    const uint32_t sdo = sq + C::kTileBytes;
    mbar_wait(bar_st + 8 * s, (n / kStages) & 1);

    // ---- S^T = K Q^T and dP^T = V dO^T (64 keys x 64 q rows, f32) ----
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_m64n64(st, desc_kmajor<HD>(sk, kk), desc_kmajor<HD>(sq, kk));
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_m64n64(dpt, desc_kmajor<HD>(sv, kk), desc_kmajor<HD>(sdo, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // ---- P^T and dS^T, rounded to bf16 as A fragments ----
    // the diagonal tile (q0 == k0) is the only one the causal mask cuts
    const bool diag = causal && (t_first + n % nq) * kBM == k0;
    const float2* rows = rows_sm + s * kBM;
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // (lse, D) of q rows 8j + col0 and + 1 of the tile
      const float4 r = *reinterpret_cast<const float4*>(rows + 8 * j + col0);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float l = (e & 1) ? r.z : r.x;
        const float d = (e & 1) ? r.w : r.y;
        float pv = exp2f(fmaf(st[i], scale_log2, -l));
        if (diag && krow + 8 * (e >> 1) > 8 * j + col0 + (e & 1)) pv = 0.f;
        p[e] = pv;
        ds[e] = pv * (dpt[i] - d);
      }
      pa[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
      pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
      dsa[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
      dsa[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
    }

    // ---- dV += P^T dO, dK += dS^T Q (dO and Q MN-major) ----
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_hd<HD>(dva, pa[kk], desc_mnmajor<HD>(sdo, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_hd<HD>(dka, dsa[kk], desc_mnmajor<HD>(sq, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);

    // every warp is done with stage s: refill it
    __syncthreads();
    if (tid == 0 && n + kStages < total) load_stage(n + kStages, s);
  }

  // ---- the cluster's C partial sums, through distributed shared memory ---
  // Each block stages its accumulators in its stage ring (every stage is
  // consumed and none is in flight) as pairs: pair p < HD/4 holds dK's
  // registers 2p, 2p+1, pair HD/4 + p dV's, thread-minor.
  float2* stage = reinterpret_cast<float2*>(smem_raw + (ring - raw));
#pragma unroll
  for (int p = 0; p < HD / 4; ++p) {
    stage[p * kThreads + tid] = make_float2(dka[2 * p], dka[2 * p + 1]);
    stage[(HD / 4 + p) * kThreads + tid] =
        make_float2(dva[2 * p], dva[2 * p + 1]);
  }
  cluster_sync();
  for (int p = rank; p < HD / 2; p += nclu) {
    const uint32_t at = ring + (uint32_t)(p * kThreads + tid) * 8u;
    float2 sum = make_float2(0.f, 0.f);
    for (int r = 0; r < nclu; ++r) {              // in rank order
      const float2 v = ld_dsmem_f2(at, (uint32_t)r);
      sum.x += v.x;
      sum.y += v.y;
    }
    const bool is_k = p < HD / 4;
    const int pp = is_k ? p : p - HD / 4;        // registers 2pp, 2pp + 1
    const int kj = k0 + krow + 8 * (pp & 1);
    if (kj < Skv) {
      const float f = is_k ? scale : 1.f;
      __nv_bfloat16* out = (is_k ? dk : dv) +
                           (((size_t)b * Skv + kj) * K + kvh) * HD +
                           8 * (pp >> 1) + col0;
      *reinterpret_cast<uint32_t*>(out) = pack_bf16(sum.x * f, sum.y * f);
    }
  }
  cluster_sync();   // no block leaves while another reads its stage
}

// ---- (c) dQ, and with kDelta the D of (a) ----------------------------------
// grid (H, B, q tiles), block kThreads.  kDelta: no dS and no dQ; each
// row's D = sum_j P_j dP_j goes into the second float of its pair in rl
// (read by the later launches; the lse half is only read).
template <int HD, bool kDelta>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    float2* __restrict__ rl,
                    __nv_bfloat16* __restrict__ dq, int H, int K, int Sq,
                    int Sqp, int Skv, float scale, float scale_log2,
                    int causal) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = base + C::kTileBytes;
  // stage s: K at ring + 2 s T, V at ring + (2 s + 1) T
  const uint32_t ring = base + 2 * C::kTileBytes;
  const uint32_t bar_q = ring + 2 * kStages * C::kTileBytes;
  const uint32_t bar_st = bar_q + 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;   // heaviest first
  const int kvh = h / (H / K);
  const int q_last = min(q0 + kBM, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int ntiles = (kv_end + kBM - 1) / kBM;

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(bar_st + 8 * s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_tiles<HD>(&tq, &tdo, sq, sdo, bar_q, h, q0, b, nullptr, 0);
    for (int t = 0; t < kStages && t < ntiles; ++t)
      load_tiles<HD>(&tk, &tv, ring + 2 * t * C::kTileBytes,
                     ring + (2 * t + 1) * C::kTileBytes, bar_st + 8 * t, kvh,
                     t * kBM, b, nullptr, 0);
  }

  const int row0 = q0 + 16 * warp + (lane >> 2);   // rows row0, row0 + 8
  const int col0 = 2 * (lane & 3);
  float2* rrow = rl + ((size_t)b * H + h) * Sqp;
  const float2 r0 = rrow[row0], r1 = rrow[row0 + 8];   // < Sqp: padded
  const float lse2[2] = {r0.x, r1.x}, dd[2] = {r0.y, r1.y};

  float acc[HD / 2];                 // dQ (left dead, and cut, by kDelta)
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float dsum[2] = {0.f, 0.f};                      // kDelta: D of the rows

  mbar_wait(bar_q, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const uint32_t sk = ring + 2 * s * C::kTileBytes;
    const uint32_t sv = sk + C::kTileBytes;
    mbar_wait(bar_st + 8 * s, (t / kStages) & 1);

    // ---- S = Q K^T and dP = dO V^T (64 q rows x 64 keys, f32) ----
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_m64n64(sc, desc_kmajor<HD>(sq, kk), desc_kmajor<HD>(sk, kk));
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_m64n64(dp, desc_kmajor<HD>(sdo, kk), desc_kmajor<HD>(sv, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // ---- dS = P (dP - D), masked on the diagonal and past Skv ----
    const int k0 = t * kBM;
    const bool edge = k0 + kBM > Skv || (causal && k0 + kBM - 1 > q0);
    if constexpr (kDelta) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2f(fmaf(sc[i], scale_log2, -lse2[r]));
        if (edge) {
          const int kj = k0 + 8 * (i >> 2) + col0 + (i & 1);
          if (kj >= Skv || (causal && kj > row0 + 8 * r)) p = 0.f;
        }
        dsum[r] = fmaf(p, dp[i], dsum[r]);
      }
      __syncthreads();
      if (tid == 0 && t + kStages < ntiles)
        load_tiles<HD>(&tk, &tv, sk, sv, bar_st + 8 * s, kvh,
                       (t + kStages) * kBM, b, nullptr, 0);
      continue;
    }
    uint32_t dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float ds[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = 8 * kk + e;
        const int r = (i >> 1) & 1;
        float p = exp2f(fmaf(sc[i], scale_log2, -lse2[r]));
        if (edge) {
          const int kj = k0 + 8 * (i >> 2) + col0 + (i & 1);
          if (kj >= Skv || (causal && kj > row0 + 8 * r)) p = 0.f;
        }
        ds[e] = p * (dp[i] - dd[r]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dsa[kk][e] = pack_bf16(ds[2 * e], ds[2 * e + 1]);
    }

    // ---- dQ += dS K (K MN-major) ----
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_hd<HD>(acc, dsa[kk], desc_mnmajor<HD>(sk, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    __syncthreads();
    if (tid == 0 && t + kStages < ntiles)
      load_tiles<HD>(&tk, &tv, sk, sv, bar_st + 8 * s, kvh,
                     (t + kStages) * kBM, b, nullptr, 0);
  }

  if constexpr (kDelta) {
    // a row's 64 columns lie in the quad of lanes 4 (l / 4) .. + 3
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = dsum[r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0) rrow[row0 + 8 * r].y = v;
    }
    return;
  }
  // ---- scale dQ, in bf16; dq is (B, Sq, H, hd) contiguous ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* out = dq + (((size_t)b * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + col0) =
          pack_bf16(acc[4 * j + 2 * r] * scale,
                    acc[4 * j + 2 * r + 1] * scale);
  }
}

// Tensor map over a (batch, seq, head, hd) bf16 tensor for 64-row boxes.
template <int HD>
bool encode(CUtensorMap* map, const void* ptr, int heads, int seq, int batch,
            const long long* st) {
  return encode_bf16_4d(map, ptr, HD, heads, seq, batch, st[0], st[1], st[2],
                        kBM, Cfg<HD>::kSw);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* scratch, int B,
                   int H, int K, int Sq, int Skv, const long long* sp,
                   float scale, int causal, int nclu, cudaStream_t stream) {
  using C = Cfg<HD>;
  using bf16 = __nv_bfloat16;
  const int Sqp = (Sq + kBM - 1) / kBM * kBM;
  float2* rl = reinterpret_cast<float2*>(scratch);
  const long long rows = (long long)B * H * Sqp;
  const long long per = kPrepWarps * 32;
  flash_bwd_prep<<<(unsigned)((rows + per - 1) / per), (unsigned)per, 0,
                   stream>>>(lse, rl, Sq, Sqp, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // sp: (batch, seq, head) strides of q, k, v, o, dout
  CUtensorMap tq, tk, tv, tdo;
  if (!encode<HD>(&tq, q, H, Sq, B, sp) ||
      !encode<HD>(&tk, k, K, Skv, B, sp + 3) ||
      !encode<HD>(&tv, v, K, Skv, B, sp + 6) ||
      !encode<HD>(&tdo, dout, H, Sq, B, sp + 12))
    return cudaErrorInvalidValue;
  const float sl2 = scale * kLog2e;

  // Above 48 KB a block's shared memory has to be opted into (per kernel
  // and device, so on every launch).
  const dim3 q_grid(H, B, (Sq + kBM - 1) / kBM);
  auto d_kernel = flash_bwd_dq_tc<HD, true>;
  err = cudaFuncSetAttribute(
      d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  d_kernel<<<q_grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, rl, static_cast<bf16*>(dq), H, K, Sq, Sqp, Skv, scale,
      sl2, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kv_kernel = flash_bwd_dkdv_tc<HD>;
  err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * nclu, B, (Skv + kBM - 1) / kBM);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nclu;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kv_kernel, tq, tk, tv, tdo,
                           static_cast<const float2*>(rl),
                           static_cast<bf16*>(dk), static_cast<bf16*>(dv), H,
                           K, Sq, Sqp, Skv, nclu, scale, sl2, causal);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto q_kernel = flash_bwd_dq_tc<HD, false>;
  err = cudaFuncSetAttribute(
      q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  q_kernel<<<q_grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, rl, static_cast<bf16*>(dq), H, K, Sq, Sqp, Skv, scale,
      sl2, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* o, const float* lse, const void* dout,
                        void* dq, void* dk, void* dv, float* scratch, int B,
                        int H, int K, int Sq, int Skv, const long long* sp,
                        float scale, int causal, int nclu, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B, H, K, Sq, Skv, sp, scale, causal, nclu, s);
    case 32: return launch<32>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B, H, K, Sq, Skv, sp, scale, causal, nclu, s);
    case 64: return launch<64>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B, H, K, Sq, Skv, sp, scale, causal, nclu, s);
    case 128: return launch<128>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B, H, K, Sq, Skv, sp, scale, causal, nclu, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace
}  // namespace repro_torch

// q, o, dout: (B, Sq, H, hd); k, v: (B, Skv, K, hd), all of one dtype,
// last dimension contiguous; strides[15] holds the (batch, seq, head)
// element strides of q, k, v, o and dout in that order.  lse: (B, H, Sq)
// f32 from the forward.  dq (B, Sq, H, hd), dk and dv (B, Skv, K, hd):
// contiguous, the inputs' dtype, written whole.  scratch: f32, (B, H, Sq)
// for f32 and (B, H, Sqp, 2) for bf16, Sqp = Sq rounded up to 64.  bf16
// also needs q, k, v and dout on TMA's grid (16-byte aligned, strides in
// multiples of 8 elements) and `cluster`, the blocks that share a
// kv-head's q-heads in the dK/dV launch: a divisor of H / K, at most 8.
// Three launches on `stream` (f32) or four (bf16); returns the first
// cudaError_t.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const float* lse, const void* dout,
                                   void* dq, void* dk, void* dv,
                                   float* scratch, int B, int H, int K,
                                   int Sq, int Skv, int hd,
                                   const long long* strides, float scale,
                                   int causal, int cluster, void* stream) {
  using namespace repro_torch;
  if (B == 0 || Sq == 0 || Skv == 0) return cudaSuccess;
  if (B < 0 || Sq < 0 || Skv < 0 || K <= 0 || H % K != 0 || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_hd_f32(hd, q, k, v, o, lse, dout, dq, dk, dv, scratch,
                             B, H, K, Sq, Skv, strides, scale, causal, s);
    case kBFloat16:
      if (cluster < 1 || cluster > tc::kMaxCluster || (H / K) % cluster != 0 ||
          (Sq + tc::kBM - 1) / tc::kBM > 65535 ||
          (Skv + tc::kBM - 1) / tc::kBM > 65535)
        return cudaErrorInvalidValue;
      return tc::dispatch_hd(hd, q, k, v, o, lse, dout, dq, dk, dv, scratch,
                             B, H, K, Sq, Skv, strides, scale, causal,
                             cluster, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
