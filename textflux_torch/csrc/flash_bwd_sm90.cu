// The training backward's dQ and dK/dV passes for Hopper (sm_90a): wgmma
// products, TMA loads into a ring of mbarrier-guarded stages, and warp
// specialisation. Bound to Python through the plain C entry points at the
// bottom (ctypes); see textflux_torch/ops/flash_attention.py for the
// wrappers and their plain PyTorch versions.
//
// Replaces the Pallas TPU kernels of textflux_tpu/ops/flash_attention.py:
//   flash_dq_sm90_kernel   <- _dq_kernel  (flash_attention_bwd, pass 2)
//   flash_dkv_sm90_kernel  <- _dkv_kernel (flash_attention_bwd, pass 3)
// (pass 1, the LSE, is in flash_attention.cu and the forward, which also
// writes L, in flash_fwd_sm90.cu; the pieces all three wgmma kernels share
// are in sm90_common.cuh.)
//
// What they compute, per (batch, head), with s = q k^T and keys at index >=
// kv_len masked out, exactly as the plain versions do:
//   P  = exp2(s * log2(e)/sqrt(D) - L * log2(e))   (L: natural-log LSE, fp32)
//   dS = P o (dO v^T - Dvec)                        (Dvec_i = rowsum(dO o O)_i)
//   dq: dQ = (1/sqrt(D)) dS K
//   dkv: dV = P^T dO, dK = (1/sqrt(D)) dS^T Q; key rows >= kv_len get exactly 0
// P and dS are rounded to bf16 before their products; every product
// accumulates in fp32. No atomics: each dq block owns its query rows and
// each dkv block its key rows (the JAX package's split), so the gradients
// are bitwise the same from run to run.
//
// Bound on the H100 at the training shape (B=1, S=4224, H=24, D=128): dq does
// 6 and dkv 8 x B*H*S*kv*D FLOPs (329 / 438 GFLOP, 0.33 / 0.44 ms at 989
// TFLOP/s) against 0.03-0.05 ms of memory traffic: tensor-core operations
// bound both. On Hopper only wgmma reaches that rate, so the design is:
//   - Grid (ceil(S/128), H, B); 3 warpgroups per block. Warpgroup 0 is the
//     producer: it gives its registers away (setmaxnreg 24) and one thread
//     starts every TMA load. Warpgroups 1 and 2 are consumers (setmaxnreg
//     240), each owning 64 of the block's 128 rows: wgmma's M.
//   - The block's own rows (Q and dO for dq, K and V for dkv) are loaded once
//     by TMA and stay resident; the other side's rows stream through a ring
//     of kStages tiles of 64 rows with full / empty mbarriers, so loads run
//     ahead of the products and no __syncthreads() stops the block.
//   - TMA writes 128-byte swizzled tiles straight from the strided (B, S, H,
//     D) views (the single blocks' linear1 rows need no copy), zero-filling
//     rows past S; the wgmma descriptors read them without bank conflicts.
//   - Per stage, each consumer: the two score-side products (S and dP, or S^T
//     and dP^T) by wgmma m64n64k16 with both operands in shared memory, then
//     P and dS in registers, then the gradient products by wgmma m64nDk16
//     with A = P or dS straight from the accumulator registers (the wgmma
//     accumulator has the mma.sync C layout, which is the A layout) and B the
//     streamed or resident tile read MN-major through the descriptor. Nothing
//     of the S x S matrices leaves registers.
//   - dkv computes S^T = K Q^T and dP^T = V dO^T (keys on the M side), so the
//     transposed products P^T dO and dS^T Q need no transpose at all.
//   - The producer writes each stage's 64 rows of L*log2(e) and Dvec beside
//     the Q / dO tile (L = +1e30 past S, so P = 0 there).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace textflux::sm90;
using bf16 = __nv_bfloat16;

constexpr int kStages = 3;                        // depth of the streamed ring

// ---------------------------------------------------------------------------
// dQ: one block per 128 query rows, K/V streamed
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                     const float* __restrict__ dvec, bf16* __restrict__ dq, int seq, int heads,
                     int kv_len, float scale_log2, float scale) {
  constexpr int TILE = kTileBytes<D>;
  extern __shared__ unsigned char smem_raw[];
  // [Q: 2 tiles | dO: 2 tiles | (K, V) x kStages | barriers]
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sdO = sQ + 2 * TILE;
  const uint32_t sKV = sQ + 4 * TILE;
  const uint32_t bars = sKV + kStages * 2 * TILE;  // full[kStages], empty[kStages], resident
  const uint32_t res_bar = bars + 16 * kStages;

  const int q0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (kv_len + kRows - 1) / kRows;  // tiles past kv_len add exactly 0

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                             // the producer's expect-tx
      mbar_init(bars + 8 * (kStages + s), kConsumers * 4);    // one arrive per consumer warp
    }
    mbar_init(res_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(res_bar, 4 * TILE);
      for (int c = 0; c < kConsumers; ++c) {
        load_tile<D>(sQ + c * TILE, &tm_q, res_bar, q0 + c * kRows, h, b);
        load_tile<D>(sdO + c * TILE, &tm_do, res_bar, q0 + c * kRows, h, b);
      }
      int stage = 0, phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(bars + 8 * (kStages + stage), phase ^ 1);
        const uint32_t full = bars + 8 * stage;
        const uint32_t kt = sKV + stage * 2 * TILE;
        mbar_arrive_expect_tx(full, 2 * TILE);
        load_tile<D>(kt, &tm_k, full, it * kRows, h, b);
        load_tile<D>(kt + TILE, &tm_v, full, it * kRows, h, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // consumer warpgroups
    reg_alloc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = q0 + c * kRows + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
    const long long row_base = (static_cast<long long>(b) * heads + h) * seq;
    const float l2_0 = r0 < seq ? lse[row_base + r0] * kLog2e : 0.f;
    const float l2_1 = r0 + 8 < seq ? lse[row_base + r0 + 8] * kLog2e : 0.f;
    const float dv_0 = r0 < seq ? dvec[row_base + r0] : 0.f;
    const float dv_1 = r0 + 8 < seq ? dvec[row_base + r0 + 8] : 0.f;
    const uint32_t qa = sQ + c * TILE;
    const uint32_t da = sdO + c * TILE;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

    mbar_wait(res_bar, 0);
    int stage = 0, phase = 0;
    for (int it = 0; it < n_tiles; ++it) {
      mbar_wait(bars + 8 * stage, phase);
      const uint32_t kt = sKV + stage * 2 * TILE;
      const uint32_t vt = kt + TILE;

      // S = Q K^T, dP = dO V^T: m64n64, both operands K-major in shared memory
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) wgmma_ss<64, 0>(s, kmajor(qa, ks), kmajor(kt, ks), ks);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) wgmma_ss<64, 0>(dp, kmajor(da, ks), kmajor(vt, ks), ks);
      wgmma_commit();

      // P = exp2(s scale_log2 - L log2 e), 0 at keys >= kv_len (while dP runs)
      wgmma_wait<1>();
      fence_regs(s);
      const int kv0 = it * kRows;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + j * 8 + 2 * t + (e & 1);
          const float p = ex2(s[4 * j + e] * scale_log2 - (e < 2 ? l2_0 : l2_1));
          s[4 * j + e] = col < kv_len ? p : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P o (dP - Dvec), rounded to bf16 as the A operand of dS K
      uint32_t dsa[4][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - ((i & 2) ? dv_1 : dv_0));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(dsa[kk], dp, kk);
        fence_regs(dsa[kk]);
      }

      // dQ += dS K: m64nD, A from registers, K read MN-major
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D, 1>(acc, dsa[kk], mnmajor(kt, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + stage));  // this warp is done with it
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    const long long pitch = static_cast<long long>(heads) * D;
    store_acc<D>(dq + static_cast<long long>(b) * seq * pitch + h * D, pitch, r0, seq, acc, scale,
                 t);
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one block per 128 key rows, Q/dO (and their L/Dvec rows) streamed
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                      const float* __restrict__ dvec, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int seq, int heads, int kv_len, float scale_log2,
                      float scale) {
  constexpr int TILE = kTileBytes<D>;
  const int k0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long pitch = static_cast<long long>(heads) * D;
  bf16* dkb = dk + static_cast<long long>(b) * seq * pitch + h * D;
  bf16* dvb = dv + static_cast<long long>(b) * seq * pitch + h * D;

  if (k0 >= kv_len) {  // every key of the block is masked: P = 0, so dK = dV = 0
    for (int i = threadIdx.x; i < kBlockRows * (D / 8); i += kThreads) {
      const int r = k0 + i / (D / 8);
      const int col = (i % (D / 8)) * 8;
      if (r < seq) {
        *reinterpret_cast<uint4*>(dkb + r * pitch + col) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dvb + r * pitch + col) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  // [K: 2 tiles | V: 2 tiles | (Q, dO) x kStages | L x kStages | Dvec x kStages | barriers]
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + 2 * TILE;
  const uint32_t sQdO = sK + 4 * TILE;
  float* sL = reinterpret_cast<float*>(smem + 4 * TILE + kStages * 2 * TILE);
  float* sDv = sL + kStages * kRows;
  const uint32_t bars = smem_u32(sDv + kStages * kRows);  // full[kStages], empty[kStages], resident
  const uint32_t res_bar = bars + 16 * kStages;
  const int n_tiles = (seq + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 32);                            // the producer warp's lanes
      mbar_init(bars + 8 * (kStages + s), kConsumers * 4);    // one arrive per consumer warp
    }
    mbar_init(res_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup; its warp 0 works
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(res_bar, 4 * TILE);
        for (int c = 0; c < kConsumers; ++c) {
          load_tile<D>(sK + c * TILE, &tm_k, res_bar, k0 + c * kRows, h, b);
          load_tile<D>(sV + c * TILE, &tm_v, res_bar, k0 + c * kRows, h, b);
        }
      }
      const long long row_base = (static_cast<long long>(b) * heads + h) * seq;
      int stage = 0, phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(bars + 8 * (kStages + stage), phase ^ 1);
#pragma unroll
        for (int i = 0; i < kRows / 32; ++i) {  // L (log2 units) and Dvec of the stage's rows
          const int r = it * kRows + lane + 32 * i;
          sL[stage * kRows + lane + 32 * i] = r < seq ? lse[row_base + r] * kLog2e : 1e30f;
          sDv[stage * kRows + lane + 32 * i] = r < seq ? dvec[row_base + r] : 0.f;
        }
        const uint32_t full = bars + 8 * stage;
        if (lane == 0) {
          const uint32_t qt = sQdO + stage * 2 * TILE;
          mbar_arrive_expect_tx(full, 2 * TILE);
          load_tile<D>(qt, &tm_q, full, it * kRows, h, b);
          load_tile<D>(qt + TILE, &tm_do, full, it * kRows, h, b);
        } else {
          mbar_arrive(full);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // consumer warpgroups
    reg_alloc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int kr0 = k0 + c * kRows + warp * 16 + g;  // this thread's key rows: kr0 and kr0 + 8
    const bool valid0 = kr0 < kv_len;
    const bool valid1 = kr0 + 8 < kv_len;
    const uint32_t ka = sK + c * TILE;
    const uint32_t va = sV + c * TILE;

    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;

    mbar_wait(res_bar, 0);
    int stage = 0, phase = 0;
    for (int it = 0; it < n_tiles; ++it) {
      mbar_wait(bars + 8 * stage, phase);
      const uint32_t qt = sQdO + stage * 2 * TILE;
      const uint32_t dot = qt + TILE;
      const float* sLs = sL + stage * kRows;
      const float* sDs = sDv + stage * kRows;

      // S^T = K Q^T, dP^T = V dO^T: m64n64, keys on the M side
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) wgmma_ss<64, 0>(st, kmajor(ka, ks), kmajor(qt, ks), ks);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        wgmma_ss<64, 0>(dpt, kmajor(va, ks), kmajor(dot, ks), ks);
      }
      wgmma_commit();

      // P^T (the query is the column), 0 at key rows >= kv_len; then dV += P^T dO
      wgmma_wait<1>();
      fence_regs(st);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(sLs + j * 8 + 2 * t);
        const float p0 = ex2(st[4 * j + 0] * scale_log2 - l2.x);
        const float p1 = ex2(st[4 * j + 1] * scale_log2 - l2.y);
        const float p2 = ex2(st[4 * j + 2] * scale_log2 - l2.x);
        const float p3 = ex2(st[4 * j + 3] * scale_log2 - l2.y);
        st[4 * j + 0] = valid0 ? p0 : 0.f;
        st[4 * j + 1] = valid0 ? p1 : 0.f;
        st[4 * j + 2] = valid1 ? p2 : 0.f;
        st[4 * j + 3] = valid1 ? p3 : 0.f;
      }
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(pa[kk], st, kk);
        fence_regs(pa[kk]);
      }
      fence_regs(acc_v);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D, 1>(acc_v, pa[kk], mnmajor(dot, kk), 1);
      wgmma_commit();

      // dS^T = P^T o (dP^T - Dvec); then dK += dS^T Q
      wgmma_wait<1>();
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dd = *reinterpret_cast<const float2*>(sDs + j * 8 + 2 * t);
        dpt[4 * j + 0] = st[4 * j + 0] * (dpt[4 * j + 0] - dd.x);
        dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - dd.y);
        dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - dd.x);
        dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - dd.y);
      }
      uint32_t dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(dsa[kk], dpt, kk);
        fence_regs(dsa[kk]);
      }
      fence_regs(acc_k);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D, 1>(acc_k, dsa[kk], mnmajor(qt, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + stage));  // this warp is done with it
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    store_acc<D>(dkb, pitch, kr0, seq, acc_k, scale, t);
    store_acc<D>(dvb, pitch, kr0, seq, acc_v, 1.f, t);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr int kBarrierBytes = 8 * (2 * kStages + 1);

template <int D>
constexpr int dq_smem_bytes() {
  return 1024 + (4 + 2 * kStages) * kTileBytes<D> + kBarrierBytes;
}

template <int D>
constexpr int dkv_smem_bytes() {
  return 1024 + (4 + 2 * kStages) * kTileBytes<D> + 2 * kStages * kRows * 4 + kBarrierBytes;
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

// q, k, v, dout: bf16 (B, S, H, D) views; sd = their (batch, sequence)
// strides in elements, in the order q, k, v, dout
inline cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v,
                             const void* dout, int batch, int seq, int heads, int head_dim,
                             const long long* sd) {
  const void* ptrs[4] = {q, k, v, dout};
  CUtensorMap* maps[4] = {&m->q, &m->k, &m->v, &m->dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = make_bshd_map(maps[i], ptrs[i], batch, seq, heads, head_dim,
                                          sd[2 * i + 1], sd[2 * i], kRows);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

inline dim3 grid_of(int batch, int seq, int heads) {
  return dim3((seq + kBlockRows - 1) / kBlockRows, heads, batch);
}

template <int D>
cudaError_t launch_dq(const Maps& m, const void* lse, const void* dvec, void* dq, int batch,
                      int seq, int heads, int kv_len, float scale_log2, float scale,
                      cudaStream_t st) {
  const int smem = dq_smem_bytes<D>();
  static SmemLimitOnce limit;
  const cudaError_t err = limit.set(flash_dq_sm90_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_dq_sm90_kernel<D><<<grid_of(batch, seq, heads), kThreads, smem, st>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<bf16*>(dq), seq, heads, kv_len, scale_log2, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Maps& m, const void* lse, const void* dvec, void* dk, void* dv,
                       int batch, int seq, int heads, int kv_len, float scale_log2, float scale,
                       cudaStream_t st) {
  const int smem = dkv_smem_bytes<D>();
  static SmemLimitOnce limit;
  const cudaError_t err = limit.set(flash_dkv_sm90_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_dkv_sm90_kernel<D><<<grid_of(batch, seq, heads), kThreads, smem, st>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, heads, kv_len, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

// Conventions as in flash_attention.cu: q, k, v, dout are bf16 (B, S, H, D)
// with unit feature stride and head stride D; their batch and sequence
// strides (elements, multiples of 8: TMA wants 16-byte strides) are passed.
// dq, dk, dv: contiguous bf16 (B, S, H, D), written here. lse, dvec:
// contiguous fp32 (B, H, S). head_dim is 64 or 128; 1 <= kv_len <= seq.
// Each returns a cudaError_t (0 on success).

// strides: q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss
extern "C" int textflux_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* dvec, void* dq, int batch,
                                 int seq, int heads, int head_dim, int kv_len, long long q_sb,
                                 long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                                 long long v_ss, long long do_sb, long long do_ss,
                                 float scale_log2, float scale, void* stream) {
  if (head_dim != 64 && head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  const long long sd[8] = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss};
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dout, batch, seq, heads, head_dim, sd);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = head_dim == 64
            ? launch_dq<64>(m, lse, dvec, dq, batch, seq, heads, kv_len, scale_log2, scale, st)
            : launch_dq<128>(m, lse, dvec, dq, batch, seq, heads, kv_len, scale_log2, scale, st);
  return static_cast<int>(err);
}

extern "C" int textflux_flash_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* dvec, void* dk,
                                  void* dv, int batch, int seq, int heads, int head_dim,
                                  int kv_len, long long q_sb, long long q_ss, long long k_sb,
                                  long long k_ss, long long v_sb, long long v_ss,
                                  long long do_sb, long long do_ss, float scale_log2,
                                  float scale, void* stream) {
  if (head_dim != 64 && head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  const long long sd[8] = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss};
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dout, batch, seq, heads, head_dim, sd);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = head_dim == 64 ? launch_dkv<64>(m, lse, dvec, dk, dv, batch, seq, heads, kv_len,
                                        scale_log2, scale, st)
                       : launch_dkv<128>(m, lse, dvec, dk, dv, batch, seq, heads, kv_len,
                                         scale_log2, scale, st);
  return static_cast<int>(err);
}
