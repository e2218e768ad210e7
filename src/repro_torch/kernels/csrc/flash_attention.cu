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
// operations-bound beyond a few hundred tokens (bytes-bound, and in
// practice launch-bound, for short prompts).  For bf16 the ceiling is
// the tensor cores' 989 TFLOP/s; the softmax between the two products
// runs on the CUDA cores and the multi-function unit (exp2), and at
// hd = 128 it is a sizeable share of a tile's time.
//
// bf16: tensor-core kernel (flash_fwd_tc below).
//  * One block of one warpgroup (128 threads) per (64-row q tile, q-head,
//    batch row); q tiles are numbered heaviest first (the last causal
//    tiles, which see the most keys, start first).  At qwen2-1.5b's
//    S = 995, H = 12 that is 192 blocks of 82 KB of shared memory, two
//    per SM, so every block is resident at once on the 132 SMs.
//  * S = Q K^T is wgmma m64n64k16 with Q (loaded once) and the 64-key K
//    tile both in shared memory, K-major, in the 128-byte swizzle (64- or
//    32-byte for hd = 32, 16, whose rows are shorter).  O += P V is
//    wgmma m64n{hd}k16 with P taken from registers: the probabilities,
//    rounded to bf16 in the accumulator's own fragment layout, are the A
//    operand as they are, and V is read from shared memory through
//    wgmma's transpose bit (MN-major), so V needs no transposed copy.
//    Both products accumulate in f32.
//  * The running (m, l) per row stay in f32 registers (a row lives in a
//    quad of lanes: two shuffles per reduction); the rescale of O is
//    applied to the register accumulator.
//  * Copies: TMA, through one 4-d tensor map each for q, k and v over
//    (hd, head, seq, batch) with the strides the caller's tensors have
//    (views of one fused projection included).  Two K/V stages ring in
//    shared memory behind mbarriers: while tile t multiplies, tile t+1
//    is in flight, and the load of t+2 is issued as soon as t is done.
//    TMA's out-of-bounds zero fill covers ragged S; masking past Sq and
//    Skv and the causal mask stay in the kernel.
//  * The tensor-map encoder (hopper.cuh) is looked up at run time, so the
//    library links against the CUDA runtime alone.
//
// f32: the CUDA-core kernel (flash_fwd_kernel below) is kept as it was
// and deliberately not redesigned: its atol 2e-5 gate against the plain
// version (and the identical f32 greedy tokens of the served models)
// rules out TF32 products.
//  * One block per (q tile of 32 rows, q-head, batch row); 4 warps, each
//    owning 8 query rows.  The kv loop runs inside the block, where the
//    TPU kernel used a sequential grid axis, and stops at the causal
//    diagonal of the block's last row; a warp skips the tiles that lie
//    wholly above its own rows.
//  * Each 32-key tile of K and V is staged once in shared memory and
//    reused by all 32 query rows of the block.  K is stored transposed
//    with one column of padding, so that both the coalesced store and
//    the per-lane read are free of bank conflicts.
//  * Scores: lane j owns key j of the tile and computes its dot product
//    with each of the warp's 8 rows; the q rows are read as float4
//    broadcasts.  The row max needs one warp reduction per tile; the row
//    sum l is kept per lane and reduced once at the end.
//  * P @ V: each lane owns hd/32 output columns; probabilities go
//    through a per-warp shared-memory row and are read back as float4
//    broadcasts.
//
// Both: ragged lengths (rows past Sq, keys past Skv) are masked inside
// the kernel, so any S is taken (the TPU wrapper asserts S % 128 == 0).
// Given a non-null lse (B, H, Sq) f32, both also store each row's
// log-sum-exp of its scaled scores, in natural-log units, for the
// backward (csrc/flash_attention_bwd.cu): one store per row of Sq, from
// the lane that holds the row's reduced (m, l).  Serving passes null and
// stores nothing.
// The causal mask is top-left aligned (kj <= qi); the wrapper only takes
// causal calls with Sq == Skv, where that equals the bottom-right
// alignment of the plain version.  The output is written in the input
// dtype.
#include "common.cuh"
#include "hopper.cuh"

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
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Sq,
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
    // m is the row's max scaled score; every lane holds it and lt
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * gridDim.y + h) * Sq + qi] = m[r] + logf(lt);
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
                   float* lse, int B, int H, int K, int Sq, int Skv,
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Skv, H / K, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal);
  return cudaGetLastError();
}


cudaError_t dispatch_hd_f32(int hd, const void* q, const void* k,
                            const void* v, void* o, float* lse, int B, int H,
                            int K, int Sq, int Skv, const long long* st,
                            float scale, int causal, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<float, 16>(q, k, v, o, lse, B, H, K, Sq, Skv, st, scale, causal, s);
    case 32: return launch<float, 32>(q, k, v, o, lse, B, H, K, Sq, Skv, st, scale, causal, s);
    case 64: return launch<float, 64>(q, k, v, o, lse, B, H, K, Sq, Skv, st, scale, causal, s);
    case 128: return launch<float, 128>(q, k, v, o, lse, B, H, K, Sq, Skv, st, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int kBM = 64;       // query rows per block: one wgmma M
constexpr int kBN = 64;       // keys per K/V tile
constexpr int kStages = 2;    // K/V tiles in flight
constexpr int kThreads = 128; // one warpgroup

template <int HD>
struct Cfg : Tile64<HD> {
  // Q, kStages x (K, V), three mbarriers, and slack to align to 1024 B
  static constexpr int kSmem =
      Tile64<HD>::kTileBytes * (1 + 2 * kStages) + 64 + 1024;
};

// Issue the K and V boxes of kv tile t into stage s (one thread).
template <int HD>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t sk,
                                        uint32_t sv, uint32_t bar, int t,
                                        int kvh, int b) {
  using C = Cfg<HD>;
  mbar_expect_tx(bar, 2 * C::kTileBytes);
#pragma unroll
  for (int c = 0; c < C::kBoxes; ++c) {
    tma_load_4d(sk + c * C::kBoxBytes, tk, bar, c * C::kCb, kvh, t * kBN, b);
    tma_load_4d(sv + c * C::kBoxBytes, tv, bar, c * C::kCb, kvh, t * kBN, b);
  }
}

// grid (H, B, q tiles); block kThreads.  The accumulator of a wgmma with
// N columns gives thread (warp w, lane l) rows 16w + l/4 (registers
// 4j, 4j+1) and 16w + l/4 + 8 (4j+2, 4j+3), columns 8j + 2(l%4) + {0, 1}.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int G,
                 long long o_sb, long long o_ss, long long o_sh,
                 float scale_log2, int causal) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles want 1024-byte alignment (the swizzle repeats there)
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bar_q = base + (1 + 2 * kStages) * C::kTileBytes;
  const uint32_t bar_kv = bar_q + 8;        // kStages barriers, 8 B each

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;   // heaviest first
  const int kvh = h / G;
  const int q_last = min(q0 + kBM, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int ntiles = (kv_end + kBN - 1) / kBN;

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(bar_kv + 8 * s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, C::kTileBytes);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c)
      tma_load_4d(sq + c * C::kBoxBytes, &tq, bar_q, c * C::kCb, h, q0, b);
    for (int t = 0; t < kStages && t < ntiles; ++t)
      load_kv<HD>(&tk, &tv, base + (1 + 2 * t) * C::kTileBytes,
                  base + (2 + 2 * t) * C::kTileBytes, bar_kv + 8 * t, t, kvh,
                  b);
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + (lane >> 2);   // rows row0, row0 + 8
  const int col0 = 2 * (lane & 3);

  mbar_wait(bar_q, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const uint32_t sk = base + (1 + 2 * s) * C::kTileBytes;
    const uint32_t sv = sk + C::kTileBytes;
    mbar_wait(bar_kv + 8 * s, (t / kStages) & 1);

    // ---- S = Q K^T (64 x 64, f32) ----
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_m64n64(sc, desc_kmajor<HD>(sq, kk), desc_kmajor<HD>(sk, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // ---- mask, online softmax ----
    const int k0 = t * kBN;
    if (k0 + kBN > Skv || (causal && k0 + kBN - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kj = k0 + 8 * (i >> 2) + col0 + (i & 1);
        const int qi = row0 + 8 * ((i >> 1) & 1);
        if (kj >= Skv || (causal && kj > qi)) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no valid key yet keeps m = -inf: exp2(-inf) = 0
      const float m_use = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f((m[r] - m_use) * scale_log2);
      mb[r] = m_use * scale_log2;
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -mb[r]));
      l[r] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // ---- O += P V: P in bf16 as the A operand, from registers ----
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_hd<HD>(acc, pa[kk], desc_mnmajor<HD>(sv, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    // every warp is done with stage s: refill it with tile t + kStages
    __syncthreads();
    if (tid == 0 && t + kStages < ntiles)
      load_kv<HD>(&tk, &tv, sk, sv, bar_kv + 8 * s, t + kStages, kvh, b);
  }

  // ---- O / l, in bf16 ----
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  // the log-sum-exp in natural-log units: m is the raw max score and l
  // the sum of exp2((s - m) * scale_log2); one lane of the row's quad
  // stores it
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      if (qi < Sq)
        lse[((size_t)b * gridDim.x + h) * Sq + qi] =
            (m[r] * scale_log2 + log2f(l[r])) * 0.6931471805599453f;
    }
  }
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(ob + qi * o_ss + 8 * j + col0) =
          pack_bf16(acc[4 * j + 2 * r] * inv[r],
                    acc[4 * j + 2 * r + 1] * inv[r]);
  }
}

// Tensor map over a (batch, seq, head, hd) bf16 tensor for 64-row boxes
// of Cfg<HD>::kCb columns (hopper::encode_bf16_4d).
template <int HD>
bool encode(CUtensorMap* map, const void* ptr, int heads, int seq, int batch,
            long long sb, long long ss, long long sh) {
  return encode_bf16_4d(map, ptr, HD, heads, seq, batch, sb, ss, sh, kBM,
                        Cfg<HD>::kSw);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int K, int Sq, int Skv,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap tq, tk, tv;
  if (!encode<HD>(&tq, q, H, Sq, B, st[0], st[1], st[2]) ||
      !encode<HD>(&tk, k, K, Skv, B, st[3], st[4], st[5]) ||
      !encode<HD>(&tv, v, K, Skv, B, st[6], st[7], st[8]))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_tc<HD>;
  const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid(H, B, (Sq + kBM - 1) / kBM);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, H / K, st[9],
      st[10], st[11], scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, float* lse, int B, int H, int K, int Sq,
                        int Skv, const long long* st, float scale, int causal,
                        cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, lse, B, H, K, Sq, Skv, st, scale, causal, s);
    case 32: return launch<32>(q, k, v, o, lse, B, H, K, Sq, Skv, st, scale, causal, s);
    case 64: return launch<64>(q, k, v, o, lse, B, H, K, Sq, Skv, st, scale, causal, s);
    case 128: return launch<128>(q, k, v, o, lse, B, H, K, Sq, Skv, st, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace
}  // namespace repro_torch

// q, o: (B, Sq, H, hd); k, v: (B, Skv, K, hd), all of one dtype, last
// dimension contiguous.  lse: null, or (B, H, Sq) f32 contiguous, which
// receives each row's log-sum-exp.  strides[12] holds the (batch, seq,
// head) element strides of q, k, v and o in that order.  bf16 also needs
// 16-byte aligned q, k, v and their strides in multiples of 8 elements
// (TMA).  Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int H, int K, int Sq, int Skv, int hd,
                                   const long long* strides, float scale,
                                   int causal, void* stream) {
  using namespace repro_torch;
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (B < 0 || Sq < 0 || Skv <= 0 || K <= 0 || H % K != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_hd_f32(hd, q, k, v, o, lse, B, H, K, Sq, Skv, strides,
                             scale, causal, s);
    case kBFloat16:
      return tc::dispatch_hd(hd, q, k, v, o, lse, B, H, K, Sq, Skv, strides,
                             scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
