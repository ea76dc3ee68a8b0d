// Plain flash attention for Hopper (sm_90a): the training forward and the
// three backward passes. Bound to Python through the plain C entry points at
// the bottom (ctypes); see textflux_torch/ops/flash_attention.py for the
// wrappers and their plain PyTorch versions.
//
// Replaces the Pallas TPU kernels of textflux_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- _flash_kernel (flash_attention)
//   flash_lse_kernel  <- _lse_kernel   (flash_attention_bwd, pass 1)
//   flash_dq_kernel   <- _dq_kernel    (flash_attention_bwd, pass 2)
//   flash_dkv_kernel  <- _dkv_kernel   (flash_attention_bwd, pass 3)
//
// What they compute, per (batch, head), with s = q k^T / sqrt(D) and keys at
// index >= kv_len masked out:
//   fwd  O   = softmax(s) v, an exp2 online softmax (scores scaled by
//              log2(e)/sqrt(D) in fp32), fp32 running max / sum / accumulator
//   lse  L_i = log sum_j exp(s_ij)            (natural log, fp32, (B, H, S))
//   dq   dQ  = (1/sqrt(D)) dS K,   dS = P o (dP - Dvec), P = exp(s - L),
//              dP = dO v^T, Dvec_i = rowsum(dO o O)_i (computed outside)
//   dkv  dV  = P^T dO,  dK = (1/sqrt(D)) dS^T Q; key rows >= kv_len get 0
// P and dS are rounded to bf16 before their products, as the forward rounds
// P before P*V; every product accumulates in fp32.
//
// Bound on the H100 at the training shape (B=1, S=4224, H=24, D=128): the
// products are 4 (fwd), 2 (lse), 6 (dq) and 8 (dkv) x B*H*S*kv*D FLOPs =
// 219 / 110 / 329 / 438 GFLOP, 0.22 / 0.11 / 0.33 / 0.44 ms at 989 TFLOP/s
// (bf16 tensor cores), against 52-156 MB of q/k/v/o/dO/dq/dk/dv (26 MB each)
// at 3.35 TB/s, 0.016-0.046 ms: every pass is bound by tensor-core
// operations, not memory. The backward does the S = QK^T product three times
// (lse, dq, dkv), the price of the JAX package's three-pass design.
//
// Design: the recipe of fused_attention.cu. One block of 4 warps per
// (b, h, 64-row tile); each warp owns 16 rows; both products of every pass
// run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate); the
// streamed tiles (K/V for fwd, lse and dq; Q/dO and their L/Dvec rows for
// dkv) are double-buffered in shared memory with cp.async, ragged tails
// zero-filled; batch and row strides are arguments, so q/k/v may be strided
// views (the single blocks hand v over as a slice of linear1's output).
//   - dq and dkv need no online softmax (L is known), so they walk their
//     streamed tile 16 columns at a time: S and dP for 16 columns, then P/dS
//     straight from the accumulators into the A fragments of the next
//     product. Nothing of the S x S matrices leaves registers.
//   - dkv computes S^T = K Q^T and dP^T = V dO^T directly (keys as the M
//     side), so P^T dO and dS^T Q need no transpose through shared memory.
//   - No atomics: each dq block owns its query rows, each dkv block its key
//     rows (the JAX package's split).
// ldmatrix, wgmma, TMA, and emitting L from the forward are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using textflux::cp_async_16;
using textflux::cp_async_commit;
using textflux::cp_async_wait;
using textflux::mma_16816;
using textflux::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;     // rows per tile, streamed or resident
constexpr int kWarps = 4;     // each warp owns 16 rows of the block's tile
constexpr int kThreads = kWarps * 32;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;

// Stage a 64-row x D tile (rows row0.. of `src`, `row_stride` elements apart)
// into shared memory with row pitch D + 8; rows >= limit are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          long long row_stride, int row0, int limit, int tid) {
  constexpr int LD = D + 8;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr int ITERS = kTile * CPR / kThreads;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const int s = row0 + r;
    const bool valid = s < limit;
    cp_async_16(dst + r * LD + col, src + (valid ? s : 0) * row_stride + col, valid ? 16 : 0);
  }
}

// A fragment of rows m0..m0+15, k-step ks, of a row-major tile with pitch LD
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int m0, int ks,
                                       int g, int t) {
  const bf16* p0 = tile + (m0 + g) * LD + ks * 16 + 2 * t;
  const bf16* p1 = p0 + 8 * LD;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B fragment of X * T^T: B[k][n] = T[n0 + n][ks*16 + k], T's rows are the n side
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1, const bf16* tile,
                                            int n0, int ks, int g, int t) {
  const bf16* p = tile + (n0 + g) * LD + ks * 16 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment of P * T: B[k][n] = T[k0 + k][n0 + n], T's rows are the k side
template <int LD>
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const unsigned short* tile, int k0, int n0, int g,
                                            int t) {
  const int kr = k0 + 2 * t;
  const int c = n0 + g;
  b0 = static_cast<uint32_t>(tile[kr * LD + c]) |
       (static_cast<uint32_t>(tile[(kr + 1) * LD + c]) << 16);
  b1 = static_cast<uint32_t>(tile[(kr + 8) * LD + c]) |
       (static_cast<uint32_t>(tile[(kr + 9) * LD + c]) << 16);
}

// the accumulators of two neighbouring n-tiles are the A fragment of one
// 16-wide k-step, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// write a warp's 16 x D fp32 accumulator, times `mul`, as bf16 rows r0 and
// r0 + 8 of a contiguous (B, S, H, D) output at `base` (row pitch heads*D)
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long pitch, int r0, int seq,
                                           const float (&acc)[D / 8][4], float mul, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < seq) {
      *reinterpret_cast<uint32_t*>(base + r0 * pitch + c) =
          pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    }
    if (r0 + 8 < seq) {
      *reinterpret_cast<uint32_t*>(base + (r0 + 8) * pitch + c) =
          pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// forward: O = softmax(q k^T / sqrt(D)) v
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int seq, int heads,
                 int kv_len, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                 long long v_sb, long long v_ss, float scale_log2) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = kTile / 8;
  constexpr int NT_O = D / 8;
  constexpr int TILE = kTile * LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // [K stage 0 | K stage 1 | V stage 0 | V stage 1]; the Q tile passes
  // through K stage 1 before the loop starts
  bf16* sK0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV0 = sK0 + 2 * TILE;
  bf16* sQ = sK0 + TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = q + b * q_sb + h * D;
  const bf16* kb = k + b * k_sb + h * D;
  const bf16* vb = v + b * v_sb + h * D;

  load_tile<D>(sQ, qb, q_ss, q0, seq, tid);
  load_tile<D>(sK0, kb, k_ss, 0, seq, tid);
  load_tile<D>(sV0, vb, v_ss, 0, seq, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int m0 = warp * 16;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) load_a<LD>(qa[ks], sQ, m0, ks, g, t);
  __syncthreads();  // every warp holds its Q fragments: K stage 1 is free

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kMasked, kMasked};  // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums

  const int n_tiles = (kv_len + kTile - 1) / kTile;  // tiles past kv_len add exactly 0
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) * kTile;
      load_tile<D>(sK0 + (stage ^ 1) * TILE, kb, k_ss, nxt, seq, tid);
      load_tile<D>(sV0 + (stage ^ 1) * TILE, vb, v_ss, nxt, seq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sK = sK0 + stage * TILE;
    const unsigned short* sVu = reinterpret_cast<const unsigned short*>(sV0 + stage * TILE);
    const int kv0 = it * kTile;

    // S = Q K^T, then scaled to log2 units in fp32
    float sc[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t b0, b1;
        load_b_rows<LD>(b0, b1, sK, j * 8, ks, g, t);
        mma_16816(sc[j], qa[ks], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = kv0 + j * 8 + 2 * t + (e & 1) < kv_len ? sc[j][e] * scale_log2 : kMasked;
      }
    }

    // online softmax (exp2), rows g (elements 0,1) and g + 8 (elements 2,3)
    float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m_run[0] - mx0);
    const float alpha1 = exp2f(m_run[1] - mx1);
    m_run[0] = mx0;
    m_run[1] = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      sc[j][0] = exp2f(sc[j][0] - mx0);
      sc[j][1] = exp2f(sc[j][1] - mx0);
      sc[j][2] = exp2f(sc[j][2] - mx1);
      sc[j][3] = exp2f(sc[j][3] - mx1);
      rs0 += sc[j][0] + sc[j][1];
      rs1 += sc[j][2] + sc[j][3];
    }
    l_run[0] = l_run[0] * alpha0 + rs0;
    l_run[1] = l_run[1] * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        uint32_t b0, b1;
        load_b_cols<LD>(b0, b1, sVu, kk * 16, n * 8, g, t);
        mma_16816(o[n], pa, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const float inv0 = 1.f / fmaxf(l_run[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l_run[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    o[n][0] *= inv0;
    o[n][1] *= inv0;
    o[n][2] *= inv1;
    o[n][3] *= inv1;
  }
  const long long pitch = static_cast<long long>(heads) * D;
  store_rows<D>(out + static_cast<long long>(b) * seq * pitch + h * D, pitch, q0 + m0 + g, seq,
                o, 1.f, t);
}

// ---------------------------------------------------------------------------
// backward pass 1: L = logsumexp_j(s_ij), natural log
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_lse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 float* __restrict__ lse, int seq, int heads, int kv_len, long long q_sb,
                 long long q_ss, long long k_sb, long long k_ss, float scale_log2) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = kTile / 8;
  constexpr int TILE = kTile * LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK0 = reinterpret_cast<bf16*>(smem_raw);  // [K stage 0 | K stage 1 (Q first)]
  bf16* sQ = sK0 + TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = q + b * q_sb + h * D;
  const bf16* kb = k + b * k_sb + h * D;

  load_tile<D>(sQ, qb, q_ss, q0, seq, tid);
  load_tile<D>(sK0, kb, k_ss, 0, seq, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int m0 = warp * 16;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) load_a<LD>(qa[ks], sQ, m0, ks, g, t);
  __syncthreads();

  float m_run[2] = {kMasked, kMasked};  // log2 units
  float l_run[2] = {0.f, 0.f};
  const int n_tiles = (kv_len + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(sK0 + (stage ^ 1) * TILE, kb, k_ss, (it + 1) * kTile, seq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sK = sK0 + stage * TILE;
    const int kv0 = it * kTile;
    float sc[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t b0, b1;
        load_b_rows<LD>(b0, b1, sK, j * 8, ks, g, t);
        mma_16816(sc[j], qa[ks], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = kv0 + j * 8 + 2 * t + (e & 1) < kv_len ? sc[j][e] * scale_log2 : kMasked;
      }
    }
    float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      rs0 += exp2f(sc[j][0] - mx0) + exp2f(sc[j][1] - mx0);
      rs1 += exp2f(sc[j][2] - mx1) + exp2f(sc[j][3] - mx1);
    }
    l_run[0] = l_run[0] * exp2f(m_run[0] - mx0) + rs0;
    l_run[1] = l_run[1] * exp2f(m_run[1] - mx1) + rs1;
    m_run[0] = mx0;
    m_run[1] = mx1;
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  if (t == 0) {
    float* lb = lse + (static_cast<long long>(b) * heads + h) * seq;
    const int r0 = q0 + m0 + g;
    // back from log2 units: L = ln(2) * (m2 + log2(l))
    if (r0 < seq) lb[r0] = kLn2 * (m_run[0] + log2f(fmaxf(l_run[0], 1e-30f)));
    if (r0 + 8 < seq) lb[r0 + 8] = kLn2 * (m_run[1] + log2f(fmaxf(l_run[1], 1e-30f)));
  }
}

// ---------------------------------------------------------------------------
// backward pass 2: dQ, one block per 64 query rows, K/V streamed
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dvec,
                bf16* __restrict__ dq, int seq, int heads, int kv_len, long long q_sb,
                long long q_ss, long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                long long do_sb, long long do_ss, float scale_log2, float scale) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_O = D / 8;
  constexpr int TILE = kTile * LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // [Q | dO | K stage 0 | K stage 1 | V stage 0 | V stage 1]
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + TILE;
  bf16* sK0 = sQ + 2 * TILE;
  bf16* sV0 = sQ + 4 * TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* kb = k + b * k_sb + h * D;
  const bf16* vb = v + b * v_sb + h * D;

  load_tile<D>(sQ, q + b * q_sb + h * D, q_ss, q0, seq, tid);
  load_tile<D>(sdO, dout + b * do_sb + h * D, do_ss, q0, seq, tid);
  load_tile<D>(sK0, kb, k_ss, 0, seq, tid);
  load_tile<D>(sV0, vb, v_ss, 0, seq, tid);
  cp_async_commit();

  const int m0 = warp * 16;
  const int r0 = q0 + m0 + g;  // this thread's rows: r0 and r0 + 8
  const long long row_base = (static_cast<long long>(b) * heads + h) * seq;
  const float l2_0 = r0 < seq ? lse[row_base + r0] * kLog2e : 0.f;
  const float l2_1 = r0 + 8 < seq ? lse[row_base + r0 + 8] * kLog2e : 0.f;
  const float dv_0 = r0 < seq ? dvec[row_base + r0] : 0.f;
  const float dv_1 = r0 + 8 < seq ? dvec[row_base + r0 + 8] : 0.f;

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = (kv_len + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) * kTile;
      load_tile<D>(sK0 + (stage ^ 1) * TILE, kb, k_ss, nxt, seq, tid);
      load_tile<D>(sV0 + (stage ^ 1) * TILE, vb, v_ss, nxt, seq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sK = sK0 + stage * TILE;
    const bf16* sV = sV0 + stage * TILE;
    const unsigned short* sKu = reinterpret_cast<const unsigned short*>(sK);
    const int kv0 = it * kTile;

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 keys at a time
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t qa[4], da[4];
        load_a<LD>(qa, sQ, m0, ks, g, t);
        load_a<LD>(da, sdO, m0, ks, g, t);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t b0, b1;
          load_b_rows<LD>(b0, b1, sK, (2 * kk + jj) * 8, ks, g, t);
          mma_16816(s[jj], qa, b0, b1);
          load_b_rows<LD>(b0, b1, sV, (2 * kk + jj) * 8, ks, g, t);
          mma_16816(dp[jj], da, b0, b1);
        }
      }
      // dS = P o (dP - Dvec), P = exp(s/sqrt(D) - L) = exp2(s*scale_log2 - L*log2(e))
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          const int col = kv0 + (2 * kk + jj) * 8 + 2 * t + (e & 1);
          const float p = col < kv_len ? exp2f(s[jj][e] * scale_log2 - (lo ? l2_0 : l2_1)) : 0.f;
          s[jj][e] = p * (dp[jj][e] - (lo ? dv_0 : dv_1));
        }
      }
      uint32_t dsa[4];
      acc_to_a(dsa, s[0], s[1]);
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {  // dQ += dS K
        uint32_t b0, b1;
        load_b_cols<LD>(b0, b1, sKu, kk * 16, n * 8, g, t);
        mma_16816(acc[n], dsa, b0, b1);
      }
    }
    __syncthreads();
  }
  const long long pitch = static_cast<long long>(heads) * D;
  store_rows<D>(dq + static_cast<long long>(b) * seq * pitch + h * D, pitch, r0, seq, acc,
                scale, t);
}

// ---------------------------------------------------------------------------
// backward pass 3: dK and dV, one block per 64 key rows, Q/dO streamed
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dvec,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int heads, int kv_len,
                 long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                 long long v_ss, long long do_sb, long long do_ss, float scale_log2,
                 float scale) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_O = D / 8;
  constexpr int TILE = kTile * LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // [K | V | Q stage 0 | Q stage 1 | dO stage 0 | dO stage 1 | L2 x2 | Dvec x2]
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TILE;
  bf16* sQ0 = sK + 2 * TILE;
  bf16* sdO0 = sK + 4 * TILE;
  float* sL0 = reinterpret_cast<float*>(sK + 6 * TILE);
  float* sD0 = sL0 + 2 * kTile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long pitch = static_cast<long long>(heads) * D;
  bf16* dkb = dk + static_cast<long long>(b) * seq * pitch + h * D;
  bf16* dvb = dv + static_cast<long long>(b) * seq * pitch + h * D;

  if (k0 >= kv_len) {  // every key of this tile is masked: p = 0, so dK = dV = 0
    for (int i = tid; i < kTile * (D / 8); i += kThreads) {
      const int r = k0 + i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      if (r < seq) {
        *reinterpret_cast<uint4*>(dkb + r * pitch + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dvb + r * pitch + c) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  const bf16* qb = q + b * q_sb + h * D;
  const bf16* dob = dout + b * do_sb + h * D;
  const long long row_base = (static_cast<long long>(b) * heads + h) * seq;
  // L (in log2 units) and Dvec of query rows row0.. into stage `st`; padded
  // rows get L = 1e30, so P = 0 there
  auto load_rows = [&](int st, int row0) {
    if (tid < kTile) {
      const int r = row0 + tid;
      sL0[st * kTile + tid] = r < seq ? lse[row_base + r] * kLog2e : 1e30f;
      sD0[st * kTile + tid] = r < seq ? dvec[row_base + r] : 0.f;
    }
  };

  load_tile<D>(sK, k + b * k_sb + h * D, k_ss, k0, seq, tid);
  load_tile<D>(sV, v + b * v_sb + h * D, v_ss, k0, seq, tid);
  load_tile<D>(sQ0, qb, q_ss, 0, seq, tid);
  load_tile<D>(sdO0, dob, do_ss, 0, seq, tid);
  cp_async_commit();
  load_rows(0, 0);

  const int m0 = warp * 16;
  const int kr0 = k0 + m0 + g;  // this thread's key rows: kr0 and kr0 + 8
  const bool valid0 = kr0 < kv_len;
  const bool valid1 = kr0 + 8 < kv_len;

  float acc_k[NT_O][4], acc_v[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  }

  const int n_tiles = (seq + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) * kTile;
      load_tile<D>(sQ0 + (stage ^ 1) * TILE, qb, q_ss, nxt, seq, tid);
      load_tile<D>(sdO0 + (stage ^ 1) * TILE, dob, do_ss, nxt, seq, tid);
      cp_async_commit();
      load_rows(stage ^ 1, nxt);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sQ = sQ0 + stage * TILE;
    const bf16* sdO = sdO0 + stage * TILE;
    const unsigned short* sQu = reinterpret_cast<const unsigned short*>(sQ);
    const unsigned short* sdOu = reinterpret_cast<const unsigned short*>(sdO);
    const float* sL = sL0 + stage * kTile;
    const float* sDv = sD0 + stage * kTile;

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 queries at a time
      // S^T = K Q^T and dP^T = V dO^T: keys are the rows (M side)
      float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, sK, m0, ks, g, t);
        load_a<LD>(va, sV, m0, ks, g, t);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t b0, b1;
          load_b_rows<LD>(b0, b1, sQ, (2 * kk + jj) * 8, ks, g, t);
          mma_16816(st[jj], ka, b0, b1);
          load_b_rows<LD>(b0, b1, sdO, (2 * kk + jj) * 8, ks, g, t);
          mma_16816(dpt[jj], va, b0, b1);
        }
      }
      // P^T and dS^T = P^T o (dP^T - Dvec); the query index is the column
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = (2 * kk + jj) * 8 + 2 * t + (e & 1);
          const bool valid = e < 2 ? valid0 : valid1;
          const float p = valid ? exp2f(st[jj][e] * scale_log2 - sL[qc]) : 0.f;
          st[jj][e] = p;
          dpt[jj][e] = p * (dpt[jj][e] - sDv[qc]);
        }
      }
      uint32_t pa[4], dsa[4];
      acc_to_a(pa, st[0], st[1]);
      acc_to_a(dsa, dpt[0], dpt[1]);
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {  // dV += P^T dO, dK += dS^T Q
        uint32_t b0, b1;
        load_b_cols<LD>(b0, b1, sdOu, kk * 16, n * 8, g, t);
        mma_16816(acc_v[n], pa, b0, b1);
        load_b_cols<LD>(b0, b1, sQu, kk * 16, n * 8, g, t);
        mma_16816(acc_k[n], dsa, b0, b1);
      }
    }
    __syncthreads();
  }
  store_rows<D>(dkb, pitch, kr0, seq, acc_k, scale, t);
  store_rows<D>(dvb, pitch, kr0, seq, acc_v, 1.f, t);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D>
constexpr int tile_bytes() {
  return kTile * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  // per device, so set on every launch (cheap) rather than cached once
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

inline dim3 grid_of(int batch, int seq, int heads) {
  return dim3((seq + kTile - 1) / kTile, heads, batch);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, int batch,
                       int seq, int heads, int kv_len, long long q_sb, long long q_ss,
                       long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                       float scale_log2, cudaStream_t st) {
  const int smem = 4 * tile_bytes<D>();
  cudaError_t err = prepare(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D><<<grid_of(batch, seq, heads), kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), seq, heads, kv_len, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
      scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_lse(const void* q, const void* k, void* lse, int batch, int seq, int heads,
                       int kv_len, long long q_sb, long long q_ss, long long k_sb,
                       long long k_ss, float scale_log2, cudaStream_t st) {
  const int smem = 2 * tile_bytes<D>();
  cudaError_t err = prepare(flash_lse_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_lse_kernel<D><<<grid_of(batch, seq, heads), kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<float*>(lse), seq,
      heads, kv_len, q_sb, q_ss, k_sb, k_ss, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dvec, void* dq, int batch, int seq,
                      int heads, int kv_len, const long long* sd, float scale_log2,
                      float scale, cudaStream_t st) {
  const int smem = 6 * tile_bytes<D>();
  cudaError_t err = prepare(flash_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<D><<<grid_of(batch, seq, heads), kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<bf16*>(dq), seq, heads, kv_len, sd[0],
      sd[1], sd[2], sd[3], sd[4], sd[5], sd[6], sd[7], scale_log2, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dvec, void* dk, void* dv, int batch,
                       int seq, int heads, int kv_len, const long long* sd, float scale_log2,
                       float scale, cudaStream_t st) {
  const int smem = 6 * tile_bytes<D>() + 4 * kTile * static_cast<int>(sizeof(float));
  cudaError_t err = prepare(flash_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<D><<<grid_of(batch, seq, heads), kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq,
      heads, kv_len, sd[0], sd[1], sd[2], sd[3], sd[4], sd[5], sd[6], sd[7], scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

// Common conventions of the entry points: q, k, v, dout are bf16 (B, S, H, D)
// with unit feature stride and head stride D; their batch and sequence
// strides (in elements) are passed and must keep every row 16-byte aligned.
// out, dq, dk, dv: contiguous bf16 (B, S, H, D), written here. lse, dvec:
// contiguous fp32 (B, H, S). head_dim is 64 or 128; 1 <= kv_len <= seq.
// Each returns a cudaError_t (0 on success).

extern "C" int textflux_flash_fwd(const void* q, const void* k, const void* v, void* out,
                                  int batch, int seq, int heads, int head_dim, int kv_len,
                                  long long q_sb, long long q_ss, long long k_sb,
                                  long long k_ss, long long v_sb, long long v_ss,
                                  float scale_log2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_fwd<64>(q, k, v, out, batch, seq, heads, kv_len, q_sb, q_ss, k_sb, k_ss,
                            v_sb, v_ss, scale_log2, st);
    case 128:
      return launch_fwd<128>(q, k, v, out, batch, seq, heads, kv_len, q_sb, q_ss, k_sb, k_ss,
                             v_sb, v_ss, scale_log2, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int textflux_flash_lse(const void* q, const void* k, void* lse, int batch, int seq,
                                  int heads, int head_dim, int kv_len, long long q_sb,
                                  long long q_ss, long long k_sb, long long k_ss,
                                  float scale_log2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_lse<64>(q, k, lse, batch, seq, heads, kv_len, q_sb, q_ss, k_sb, k_ss,
                            scale_log2, st);
    case 128:
      return launch_lse<128>(q, k, lse, batch, seq, heads, kv_len, q_sb, q_ss, k_sb, k_ss,
                             scale_log2, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss
extern "C" int textflux_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* dvec, void* dq, int batch,
                                 int seq, int heads, int head_dim, int kv_len, long long q_sb,
                                 long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                                 long long v_ss, long long do_sb, long long do_ss,
                                 float scale_log2, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long sd[8] = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss};
  switch (head_dim) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, dvec, dq, batch, seq, heads, kv_len, sd,
                           scale_log2, scale, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, dvec, dq, batch, seq, heads, kv_len, sd,
                            scale_log2, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int textflux_flash_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* dvec, void* dk,
                                  void* dv, int batch, int seq, int heads, int head_dim,
                                  int kv_len, long long q_sb, long long q_ss, long long k_sb,
                                  long long k_ss, long long v_sb, long long v_ss,
                                  long long do_sb, long long do_ss, float scale_log2,
                                  float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long sd[8] = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss};
  switch (head_dim) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, dvec, dk, dv, batch, seq, heads, kv_len, sd,
                            scale_log2, scale, st);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, dvec, dk, dv, batch, seq, heads, kv_len, sd,
                             scale_log2, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
