// Flash attention forward for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel): causal or non-causal GQA attention with an online
// softmax, the running (m, l, acc) state in f32, q-head h reading
// kv-head h // G, and kv tiles above the causal diagonal skipped.
//
// What bounds it on this card: at prefill lengths the work is
// 4 * S^2/2 * hd * H operations against O(S * hd * H) bytes, so it is
// operations-bound beyond a few hundred tokens (and bytes-bound for
// short prompts).  This first kernel does its products on the f32 cores
// (no tensor cores), so it sits far from the bf16 tensor-core bound;
// wgmma and TMA are for a later change.
//
// What the design does about it:
//  * One block per (q tile of 32 rows, q-head, batch row); 4 warps, each
//    owning 8 query rows.  The kv loop runs inside the block, where the
//    TPU kernel used a sequential grid axis, and stops at the causal
//    diagonal of the block's last row; a warp skips the tiles that lie
//    wholly above its own rows.
//  * Each 32-key tile of K and V is staged once in shared memory (as f32)
//    and reused by all 32 query rows of the block.  K is stored
//    transposed with one column of padding, so that both the coalesced
//    store and the per-lane read are free of bank conflicts.
//  * Scores: lane j owns key j of the tile and computes its dot product
//    with each of the warp's 8 rows; the q rows are read as float4
//    broadcasts.  The row max needs one warp reduction per tile; the row
//    sum l is kept per lane and reduced once at the end.
//  * P @ V: each lane owns hd/32 output columns; probabilities go
//    through a per-warp shared-memory row and are read back as float4
//    broadcasts.
//  * Ragged lengths: rows past Sq and keys past Skv are masked inside the
//    kernel, so any S is taken (the TPU wrapper asserts S % 128 == 0).
//  * The causal mask is top-left aligned (kj <= qi); the wrapper only
//    takes causal calls with Sq == Skv, where that equals the
//    bottom-right alignment of the plain version.
//  * f32 inputs are computed in full f32 (no TF32), bf16 inputs are
//    widened to f32 on load; the output is written in the input dtype.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;

template <int HD>
struct Smem {
  float q[kBQ][HD];
  float kt[HD][kBK + 1];  // K tile, transposed and padded
  float v[kBK][HD];
  float p[kWarps][kRowsPerWarp][kBK];
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Skv, int G, long long q_sb, long long q_ss,
                     long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, long long o_sb, long long o_ss,
                     long long o_sh, float scale, int causal) {
  constexpr int DPL = HD >= 32 ? HD / 32 : 1;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  T* ob = o + b * o_sb + h * o_sh;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, qi = q0 + r;
    sm.q[r][d] = qi < Sq ? to_f32(qb[qi * q_ss + d]) : 0.f;
  }

  float acc[kRowsPerWarp][DPL];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const int row0 = q0 + warp * kRowsPerWarp;  // this warp's first row
  const int warp_last = min(row0 + kRowsPerWarp, Sq) - 1;
  const int block_last = min(q0 + kBQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, block_last + 1) : Skv;
  const int ntiles = (kv_end + kBK - 1) / kBK;
  const float* qw = &sm.q[warp * kRowsPerWarp][0];

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Skv) {
        kv = to_f32(kb[kj * k_ss + d]);
        vv = to_f32(vb[kj * v_ss + d]);
      }
      sm.kt[d][j] = kv;
      sm.v[j][d] = vv;
    }
    __syncthreads();
    // Warp-uniform: no valid row here, or the tile lies wholly above the
    // diagonal of every row of this warp.
    if (row0 >= Sq || (causal && k0 > warp_last)) continue;

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float k_0 = sm.kt[d][lane], k_1 = sm.kt[d + 1][lane];
      const float k_2 = sm.kt[d + 2][lane], k_3 = sm.kt[d + 3][lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * HD + d);
        s[r] += qv.x * k_0 + qv.y * k_1 + qv.z * k_2 + qv.w * k_3;
      }
    }

    const int kj = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool ok = kj < Skv && (!causal || kj <= row0 + r);
      const float sc = ok ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sc));
      // A row with no valid key yet keeps m = -inf; exp(-inf - 0) = 0.
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - m_use);
      const float p = expf(sc - m_use);
      l[r] = l[r] * alpha + p;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      sm.p[warp][r][lane] = p;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < HD ? sm.v[j + jj][d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv =
            *reinterpret_cast<const float4*>(&sm.p[warp][r][j]);
#pragma unroll
        for (int c = 0; c < DPL; ++c)
          acc[r][c] += pv.x * vv[0][c] + pv.y * vv[1][c] + pv.z * vv[2][c] +
                       pv.w * vv[3][c];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float lt = warp_sum(l[r]);
    const int qi = row0 + r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) ob[qi * o_ss + d] = from_f32<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int K, int Sq, int Skv,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int kSmem = sizeof(Smem<HD>);
  auto kernel = flash_fwd_kernel<T, HD>;
  // Above 48 KB a block's shared memory has to be opted into (per kernel
  // and device, so on every launch); a failure is reported like a refused
  // launch.
  const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H / K, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int H, int K, int Sq, int Skv,
                        const long long* st, float scale, int causal,
                        cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, K, Sq, Skv, st, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, K, Sq, Skv, st, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, K, Sq, Skv, st, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, K, Sq, Skv, st, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q, o: (B, Sq, H, hd); k, v: (B, Skv, K, hd), all of one dtype, last
// dimension contiguous.  strides[12] holds the (batch, seq, head) element
// strides of q, k, v and o in that order.  Returns the cudaError_t of the
// launch.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int K, int Sq, int Skv, int hd,
                                   const long long* strides, float scale,
                                   int causal, void* stream) {
  using namespace repro_torch;
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (B < 0 || Sq < 0 || Skv <= 0 || K <= 0 || H % K != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_hd<float>(hd, q, k, v, o, B, H, K, Sq, Skv, strides,
                                scale, causal, s);
    case kBFloat16:
      return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, K, Sq, Skv,
                                        strides, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
