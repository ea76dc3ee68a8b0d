// The attention forward for Hopper (sm_90a): one wgmma / TMA mainloop under
// two entry points. Bound to Python through the plain C entry point at the
// bottom (ctypes) and, for the fused serving kernel, through
// textflux::sm90::flash_fwd, which fused_attention.cu launches after its
// norm+rope prep pass; see textflux_torch/ops/flash_attention.py for the
// wrappers and their plain PyTorch versions.
//
// Replaces the Pallas TPU kernels of textflux_tpu/ops/flash_attention.py:
//   flash_fwd_sm90_kernel<D, false> <- _flash_kernel (flash_attention), and
//                                      the attention part of _fused_kernel
//                                      (flash_attention_qk_norm_rope)
//   flash_fwd_sm90_kernel<D, true>  <- _lse_kernel (flash_attention_bwd,
//                                      pass 1): the same mainloop with V's
//                                      loads, P*V and the O epilogue compiled
//                                      out, L alone
//
// What it computes, per (batch, head), with keys at index >= kv_len masked
// out (-1e30) and s = score_mul * q k^T in log2 units (score_mul =
// log2(e)/sqrt(D) for the flash forward; 1 for the fused path, whose prep
// already folded log2(e)/sqrt(D) into q'):
//   O = softmax(s) v by an exp2 online softmax with the running max
//       subtracted, P rounded to bf16 before P*V, fp32 running max / sum /
//       accumulator, O / max(l, 1e-30) rounded to bf16;
//   L = ln(2) * (m + log2 max(l, 1e-30)), the natural-log row LSE the
//       backward needs, written as fp32 (B, H, S) when its pointer is not
//       null, so the training path needs no LSE pass of its own.
// No atomics: each block owns its query rows, so O and L are bitwise the same
// from run to run. The LSE-only instantiation keeps the online max / sum and
// the L store: half the forward's products (2 x B*H*S*kv*D FLOPs, 0.11 ms at
// the training shape), still bound by tensor-core operations. Its consumers
// wait on each S = Q K^T before its softmax (no P*V to overlap with); the
// two consumer warpgroups interleave.
//
// Bound on the H100: the products are 4 x B*H*S*kv*D FLOPs, 219 GFLOP at the
// training shape (B=1, S=4224, H=24, D=128; 0.22 ms at 989 TFLOP/s) and 24.4
// GFLOP at the serving shape (S=1408; 0.025 ms), against 0.016-0.02 ms of
// q/k/v/o traffic: tensor-core operations bound both, and on Hopper only
// wgmma reaches that rate. The design, the backward's layout
// (flash_bwd_sm90.cu) on the building blocks of sm90_common.cuh:
//   - Grid (ceil(S/128), H, B); 3 warpgroups per block. Warpgroup 0 is the
//     producer (setmaxnreg 24): one thread starts every TMA load. Warpgroups
//     1 and 2 are consumers (setmaxnreg 240), each owning 64 of the block's
//     128 query rows: wgmma's M.
//   - Q's rows are loaded once and stay resident; K and V stream through a
//     ring of kStages 64-row stages with separate full barriers for K and
//     for V (S = Q K^T starts before V has landed) and one empty barrier per
//     stage that the 8 consumer warps arrive on. TMA writes 128-byte
//     swizzled tiles straight from the strided (B, S, H, D) views (the
//     single blocks' linear1 rows need no copy) and zero-fills rows past S.
//   - Per stage, per consumer: S = Q K^T by wgmma m64n64k16 (both operands
//     K-major in shared memory); scale, mask, row max and sum over the quad
//     (shfl 1, 2), exp2; P rounded to bf16 straight into A fragments (the
//     accumulator has the A layout); O += P V by wgmma m64nDk16 with A from
//     registers and V read MN-major through the descriptor. Nothing of the
//     S x S matrix leaves registers.
//   - Intra-warpgroup overlap (FlashAttention-3's): stage j+1's S product is
//     issued before stage j's P V, and stage j+1's softmax runs while P V is
//     in flight; O is rescaled once P V has landed. The two consumer
//     warpgroups interleave besides.
// Left out: ping-pong scheduling between the consumers, a persistent grid,
// and a wider (or TMA) epilogue store: O leaves through 4-byte stores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace textflux::sm90;
using bf16 = __nv_bfloat16;

constexpr int kStages = 4;  // depth of the K/V ring: a consumer holds two stages at a time
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e30f;

// One score tile in place: s <- score_mul * s (kMasked at keys >= kv_len),
// then the online-softmax update of this thread's rows r0 (elements 0, 1 of
// each column block) and r0 + 8 (elements 2, 3): m <- max(m, rowmax(s)),
// s <- exp2(s - m), l <- l * alpha + rowsum(s); alpha = exp2(m_old - m_new)
// is what the accumulator has to be rescaled by.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float score_mul, int kv0,
                                             int kv_len, int t) {
  const bool ragged = kv0 + kRows > kv_len;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * score_mul;
      if (ragged && kv0 + j * 8 + 2 * t + (e & 1) >= kv_len) x = kMasked;
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = ex2(m[i] - mx[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = ex2(s[i] - mx[(i >> 1) & 1]);
    s[i] = p;
    rs[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

template <int D, bool kLseOnly>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                      float* __restrict__ lse, int seq, int heads, int kv_len,
                      float score_mul) {
  constexpr int TILE = kTileBytes<D>;
  extern __shared__ unsigned char smem_raw[];
  // [Q: 2 tiles | K x kStages | V x kStages | barriers]
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + kConsumers * TILE;
  const uint32_t sV = sK + kStages * TILE;
  // full_k[kStages], full_v[kStages], empty[kStages], resident
  const uint32_t full_k = sV + kStages * TILE;
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty = full_v + 8 * kStages;
  const uint32_t res_bar = empty + 8 * kStages;

  const int q0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (kv_len + kRows - 1) / kRows;  // tiles past kv_len add exactly 0

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);              // the producer's expect-tx
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 4);  // one arrive per consumer warp
    }
    mbar_init(res_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(res_bar, kConsumers * TILE);
      for (int c = 0; c < kConsumers; ++c) {
        load_tile<D>(sQ + c * TILE, &tm_q, res_bar, q0 + c * kRows, h, b);
      }
      int stage = 0, phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_arrive_expect_tx(full_k + 8 * stage, TILE);
        load_tile<D>(sK + stage * TILE, &tm_k, full_k + 8 * stage, it * kRows, h, b);
        if constexpr (!kLseOnly) {
          mbar_arrive_expect_tx(full_v + 8 * stage, TILE);
          load_tile<D>(sV + stage * TILE, &tm_v, full_v + 8 * stage, it * kRows, h, b);
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
    const int t = lane & 3;
    const int r0 = q0 + c * kRows + warp * 16 + (lane >> 2);  // this thread's rows: r0, r0 + 8
    const uint32_t qa = sQ + c * TILE;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    float m[2] = {kMasked, kMasked};  // running row max, log2 units
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums
    float alpha[2];

    if constexpr (kLseOnly) {
      // per tile: S = Q K^T, the stage back to the producer, the softmax
      mbar_wait(res_bar, 0);
      int stage = 0, phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(full_k + 8 * stage, phase);
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          wgmma_ss<64, 0>(s, kmajor(qa, ks), kmajor(sK + stage * TILE, ks), ks);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (lane == 0) mbar_arrive(empty + 8 * stage);
        softmax_tile(s, m, l, alpha, score_mul, it * kRows, kv_len, t);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        l[i] = fmaxf(l[i], 1e-30f);
      }
      if (t == 0) {
        float* lb = lse + (static_cast<long long>(b) * heads + h) * seq;
        if (r0 < seq) lb[r0] = kLn2 * (m[0] + log2f(l[0]));
        if (r0 + 8 < seq) lb[r0 + 8] = kLn2 * (m[1] + log2f(l[1]));
      }
    } else {
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      uint32_t pa[4][4];

      // stage 0: S = Q K^T and its softmax (O is still 0: nothing to rescale)
      mbar_wait(res_bar, 0);
      mbar_wait(full_k, 0);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) wgmma_ss<64, 0>(s, kmajor(qa, ks), kmajor(sK, ks), ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, m, l, alpha, score_mul, 0, kv_len, t);

      int stage = 0, phase = 0;  // of the tile whose P is in s
      for (int it = 1; it < n_tiles; ++it) {
        int nstage = stage + 1, nphase = phase;
        if (nstage == kStages) {
          nstage = 0;
          nphase ^= 1;
        }
        // P of tile it - 1 into A fragments; s is then free for tile it's scores
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc_to_a(pa[kk], s, kk);
          fence_regs(pa[kk]);
        }
        fence_regs(s);
        fence_regs(o);
        mbar_wait(full_k + 8 * nstage, nphase);
        wgmma_fence();
        // S = Q K_it^T, then O += P V_{it-1}: two groups, in this order
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          wgmma_ss<64, 0>(s, kmajor(qa, ks), kmajor(sK + nstage * TILE, ks), ks);
        }
        wgmma_commit();
        mbar_wait(full_v + 8 * stage, phase);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<D, 1>(o, pa[kk], mnmajor(sV + stage * TILE, kk), 1);
        wgmma_commit();

        // softmax of tile it while P V runs
        wgmma_wait<1>();
        fence_regs(s);
        softmax_tile(s, m, l, alpha, score_mul, it * kRows, kv_len, t);

        // P V has landed: stage it - 1 goes back to the producer, O moves to the new max
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty + 8 * stage);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n + 0] *= alpha[0];
          o[4 * n + 1] *= alpha[0];
          o[4 * n + 2] *= alpha[1];
          o[4 * n + 3] *= alpha[1];
        }
        stage = nstage;
        phase = nphase;
      }

      // the last tile's O += P V
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(pa[kk], s, kk);
        fence_regs(pa[kk]);
      }
      fence_regs(o);
      mbar_wait(full_v + 8 * stage, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D, 1>(o, pa[kk], mnmajor(sV + stage * TILE, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty + 8 * stage);

      // epilogue: full row sums, O / l as bf16, and L
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        l[i] = fmaxf(l[i], 1e-30f);
      }
      const float inv0 = 1.f / l[0];
      const float inv1 = 1.f / l[1];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n + 0] *= inv0;
        o[4 * n + 1] *= inv0;
        o[4 * n + 2] *= inv1;
        o[4 * n + 3] *= inv1;
      }
      const long long pitch = static_cast<long long>(heads) * D;
      store_acc<D>(out + static_cast<long long>(b) * seq * pitch + h * D, pitch, r0, seq, o, 1.f,
                   t);
      if (lse != nullptr && t == 0) {
        float* lb = lse + (static_cast<long long>(b) * heads + h) * seq;
        if (r0 < seq) lb[r0] = kLn2 * (m[0] + log2f(l[0]));
        if (r0 + 8 < seq) lb[r0 + 8] = kLn2 * (m[1] + log2f(l[1]));
      }
    }
  }
}

template <int D>
constexpr int fwd_smem_bytes() {
  return 1024 + (kConsumers + 2 * kStages) * kTileBytes<D> + 8 * (3 * kStages + 1);
}

// kLseOnly: out is not written (may be null), tv is not read
template <int D, bool kLseOnly>
cudaError_t launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                       void* out, float* lse, int batch, int seq, int heads, int kv_len,
                       float score_mul, cudaStream_t st) {
  const int smem = fwd_smem_bytes<D>();
  static SmemLimitOnce limit;
  const cudaError_t err = limit.set(flash_fwd_sm90_kernel<D, kLseOnly>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockRows - 1) / kBlockRows, heads, batch);
  flash_fwd_sm90_kernel<D, kLseOnly><<<grid, kThreads, smem, st>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, seq, heads, kv_len, score_mul);
  return cudaGetLastError();
}

}  // namespace

namespace textflux {
namespace sm90 {

cudaError_t flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                      int batch, int seq, int heads, int head_dim, int kv_len,
                      const long long* sd, float score_mul, cudaStream_t st) {
  if (head_dim != 64 && head_dim != 128) return cudaErrorInvalidValue;
  const void* ptrs[3] = {q, k, v};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = make_bshd_map(&maps[i], ptrs[i], batch, seq, heads, head_dim,
                                          sd[2 * i + 1], sd[2 * i], kRows);
    if (err != cudaSuccess) return err;
  }
  return head_dim == 64 ? launch_fwd<64, false>(maps[0], maps[1], maps[2], out, lse, batch, seq,
                                                heads, kv_len, score_mul, st)
                        : launch_fwd<128, false>(maps[0], maps[1], maps[2], out, lse, batch,
                                                 seq, heads, kv_len, score_mul, st);
}

}  // namespace sm90
}  // namespace textflux

// q, k, v: bf16 (B, S, H, D) with unit feature stride and head stride D;
// their batch and sequence strides (elements, multiples of 8) are passed.
// out: contiguous bf16 (B, S, H, D); lse: contiguous fp32 (B, H, S) or null
// (no L). head_dim is 64 or 128; 1 <= kv_len <= seq. Returns a cudaError_t
// (0 on success).
extern "C" int textflux_flash_fwd(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int batch, int seq, int heads, int head_dim,
                                  int kv_len, long long q_sb, long long q_ss, long long k_sb,
                                  long long k_ss, long long v_sb, long long v_ss,
                                  float scale_log2, void* stream) {
  const long long sd[6] = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss};
  return static_cast<int>(textflux::sm90::flash_fwd(
      q, k, v, out, static_cast<float*>(lse), batch, seq, heads, head_dim, kv_len, sd,
      scale_log2, static_cast<cudaStream_t>(stream)));
}

// The LSE pass alone: L = natural-log row LSE of scale_log2 * q k^T (log2
// units) over keys < kv_len, fp32 (B, H, S) into lse. q, k as for
// textflux_flash_fwd. Returns a cudaError_t (0 on success).
extern "C" int textflux_flash_lse(const void* q, const void* k, void* lse, int batch,
                                       int seq, int heads, int head_dim, int kv_len,
                                       long long q_sb, long long q_ss, long long k_sb,
                                       long long k_ss, float scale_log2, void* stream) {
  using namespace textflux::sm90;
  if (head_dim != 64 && head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[2];
  const void* ptrs[2] = {q, k};
  const long long sd[4] = {q_sb, q_ss, k_sb, k_ss};
  for (int i = 0; i < 2; ++i) {
    const cudaError_t err = make_bshd_map(&maps[i], ptrs[i], batch, seq, heads, head_dim,
                                          sd[2 * i + 1], sd[2 * i], kRows);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* l = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      head_dim == 64
          ? launch_fwd<64, true>(maps[0], maps[1], maps[1], nullptr, l, batch, seq, heads,
                                 kv_len, scale_log2, st)
          : launch_fwd<128, true>(maps[0], maps[1], maps[1], nullptr, l, batch, seq, heads,
                                  kv_len, scale_log2, st));
}
