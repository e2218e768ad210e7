// Flash attention backward for Hopper (sm_90a), on the CUDA cores.
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
// G = H / K q-heads that share a kv-head.
//
// What bounds it on this card: at the training shape (S = 1024, hd = 128,
// H = 12) about 2.5 times the forward's causal operations against
// O(S * hd * H) bytes, so operations.  This first version runs them as f32
// FMAs on the CUDA cores, not on the tensor cores whose rate sets its
// bound (chip_smoke.py reports both); a wgmma/TMA redesign is queued
// (ROADMAP).
//
// What the design does: the three launches each keep their working tiles
// in shared memory in f32 (bf16 inputs converted at staging), accumulate
// in f32 registers, and write each output element once, in the input
// dtype, with no atomics and nothing allocated.
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
// Ragged lengths are masked in the kernels: rows past Sq and keys past
// Skv are staged as zeros and get P = 0.
#include "common.cuh"

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

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* o, const float* lse, const void* dout,
                        void* dq, void* dk, void* dv, float* dd, int B, int H,
                        int K, int Sq, int Skv, const long long* sp,
                        float scale, int causal, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, dout, dq, dk, dv, dd, B, H, K, Sq, Skv, sp, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, dd, B, H, K, Sq, Skv, sp, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, dd, B, H, K, Sq, Skv, sp, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, dd, B, H, K, Sq, Skv, sp, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q, o, dout: (B, Sq, H, hd); k, v: (B, Skv, K, hd), all of one dtype,
// last dimension contiguous; strides[15] holds the (batch, seq, head)
// element strides of q, k, v, o and dout in that order.  lse: (B, H, Sq)
// f32 from the forward.  dq (B, Sq, H, hd), dk and dv (B, Skv, K, hd):
// contiguous, the inputs' dtype, written whole.  dd: (B, H, Sq) f32
// scratch.  Three launches on `stream`; returns the first cudaError_t.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const float* lse, const void* dout,
                                   void* dq, void* dk, void* dv, float* dd,
                                   int B, int H, int K, int Sq, int Skv,
                                   int hd, const long long* strides,
                                   float scale, int causal, void* stream) {
  using namespace repro_torch;
  if (B == 0 || Sq == 0 || Skv == 0) return cudaSuccess;
  if (B < 0 || Sq < 0 || Skv < 0 || K <= 0 || H % K != 0 || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_hd<float>(hd, q, k, v, o, lse, dout, dq, dk, dv, dd, B,
                                H, K, Sq, Skv, strides, scale, causal, s);
    case kBFloat16:
      return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, dout, dq, dk, dv,
                                        dd, B, H, K, Sq, Skv, strides, scale,
                                        causal, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
