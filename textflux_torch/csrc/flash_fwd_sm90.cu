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
//   flash_fwd_cross_sm90_kernel<D>  <- no TPU kernel: Wan's cross-attention
//                                      (the JAX package has no such model),
//                                      the same mainloop (flash_fwd_block)
//                                      over keys and values of their own
//                                      length, under a name of its own
//
// What it computes, per (batch, head), with keys at index >= kv_len masked
// out (-1e30; kv_len is the sample's entry of kv_lens when that device array
// is given, so that a CUDA graph replays with lengths it was not captured with) and s = score_mul * q k^T in log2 units (score_mul =
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
// the training shape), still bound by tensor-core operations.
//
// Bound on the H100: the products are 4 x B*H*S*kv*D FLOPs, 219 GFLOP at the
// training shape (B=1, S=4224, H=24, D=128; 0.22 ms at 989 TFLOP/s), 24.4
// GFLOP at FLUX's serving shape (S=1408; 0.025 ms) and 1.46-2.02 ms a call at
// Wan's 8,400-9,880 tokens of 40 heads, against 0.016-0.02 ms of q/k/v/o
// traffic at the training shape: tensor-core operations bound every caller,
// and on Hopper only wgmma reaches that rate. What keeps a mainloop off it:
//   - shared-memory reads: an SS product of N columns reads A and B from
//     shared memory per k-step, 32 bytes per 1,024 FLOPs at N = 64, which
//     is where shared memory and not the tensor core sets the pace;
//   - the fixed cost of a stage: barrier waits, arrives, commits and
//     group waits, paid once per stage whatever its width;
//   - the exponentials: at D = 128 a score's exp2 (16 a clock per SM) costs
//     about half its products' time, and it is hidden only if a tensor-core
//     product runs meanwhile.
// The design, on the building blocks of sm90_common.cuh:
//   - Grid (ceil(S/128), H, B); 3 warpgroups per block. Warpgroup 0 is the
//     producer (setmaxnreg 24): one thread starts every TMA load. Warpgroups
//     1 and 2 are consumers (setmaxnreg 240), each owning 64 of the block's
//     128 query rows: wgmma's M.
//   - Q's rows are loaded once (64-row boxes) and stay resident. K and V
//     stream in stages of kKeys = 128 key rows (one 128-row TMA box per
//     64-column half) through two rings of kKvStages stages each (3 at
//     D = 128: 32 KB of Q + 3 x 64 KB of K and V, under the 227 KB a block
//     may hold; 6 at D = 64), each stage with a full and an empty barrier.
//     A K stage goes back to the producer as soon as its S is computed, a V
//     stage once its P V has landed; the producer loads in the order the
//     consumers read: K_0, then K_j+1 before V_j. TMA writes 128-byte
//     swizzled tiles straight from the strided (B, S, H, D) views (the
//     single blocks' linear1 rows need no copy) and zero-fills rows past S.
//   - Per stage, per consumer: S = Q K^T by wgmma m64n128k16 (both operands
//     K-major in shared memory) into 64 fp32 registers a thread, which reads
//     3/4 of N = 64's shared-memory bytes per FLOP and halves the stages;
//     scale (skipped where it is 1, as on every fused path: a product by 1
//     changes no bit), mask (the ragged stage only), row max and sum over
//     the quad (shfl 1, 2), exp2; P rounded to bf16 straight into A
//     fragments (the accumulator has the A layout); O += P V by wgmma
//     m64nDk16 with A from registers and V read MN-major through the
//     descriptor. Nothing of the S x S matrix leaves registers.
//   - Intra-warpgroup overlap (FlashAttention-3's): stage j+1's S product is
//     issued before stage j's P V, and stage j+1's softmax runs while P V is
//     in flight; O is rescaled once P V has landed.
//   - Ping-pong between the consumers (FlashAttention-3's): two named
//     barriers, one per consumer, pass the turn to start products. A
//     consumer waits for its turn, starts its S and P V, and hands the turn
//     to the other, so the tensor core runs one consumer's products while
//     the other does its softmax. Consumer 1 starts by handing the first
//     turn to consumer 0 and gives no turn back after its last products, so
//     every arrive meets a wait. The ragged last stage is masked in
//     registers: no shape switch, and key lengths read on the device work
//     as a host length does.
// The LSE-only instantiation keeps the K ring alone (no V, no P V, no O,
// no turns): each consumer waits on its S before the softmax.
// Left out: a persistent grid, and a wider (or TMA) epilogue store: O
// leaves through 4-byte stores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace textflux::sm90;
using bf16 = __nv_bfloat16;

constexpr int kKeys = 128;                 // key rows of a K / V stage: S = Q K^T's N
constexpr int kKvHalfBytes = kKeys * 128;  // kKeys rows x 64 bf16, swizzled
constexpr int kSmemLimit = 232448;         // shared memory a block may hold on the H100
constexpr int kSchedBar = 1;               // named barrier kSchedBar + c: consumer c's turn
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e30f;

template <int D>
constexpr int kKvTileBytes = kKeys * D * 2;  // one K or V stage: D / 64 column halves
// stages of each of the K and V rings: as many as fit beside Q, the 1024
// bytes of alignment and the barriers (4 a stage and Q's)
template <int D>
constexpr int kKvStages =
    (kSmemLimit - 1024 - kConsumers * kTileBytes<D> - 8) / (2 * kKvTileBytes<D> + 32);

template <int D>
constexpr int fwd_smem_bytes() {
  return 1024 + kConsumers * kTileBytes<D> + 2 * kKvStages<D> * kKvTileBytes<D> +
         8 * (4 * kKvStages<D> + 1);
}
static_assert(kKvStages<128> >= 2 && fwd_smem_bytes<128>() <= kSmemLimit, "K/V ring at D = 128");
static_assert(kKvStages<64> >= 2 && fwd_smem_bytes<64>() <= kSmemLimit, "K/V ring at D = 64");

// stage and phase parity of a ring of S stages
template <int S>
struct Ring {
  int stage = 0;
  int phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// K-major K stage, k-step ks of 16 head-dim columns
__device__ __forceinline__ uint64_t k_desc(uint32_t tile, int ks) {
  return desc_sw128(tile + (ks >> 2) * kKvHalfBytes + (ks & 3) * 32, 16, 1024);
}
// MN-major V stage (head dim along N), k-step kk of 16 key rows
__device__ __forceinline__ uint64_t v_desc(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 16 * 128, kKvHalfBytes, 1024);
}

// the producer: the ring's next stage, once the consumers have freed it,
// filled with key rows [it * kKeys, + kKeys) of a (B, S, H, D) map
template <int D, int S>
__device__ __forceinline__ void produce(Ring<S>& r, uint32_t full, uint32_t empty, uint32_t base,
                                        const CUtensorMap* map, int it, int h, int b) {
  mbar_wait(empty + 8 * r.stage, r.phase ^ 1);
  mbar_arrive_expect_tx(full + 8 * r.stage, kKvTileBytes<D>);
#pragma unroll
  for (int half = 0; half < D / 64; ++half) {
    tma_load_4d(base + r.stage * kKvTileBytes<D> + half * kKvHalfBytes, map, full + 8 * r.stage,
                half * 64, h, it * kKeys, b);
  }
  r.next();
}

// A operand of k-step kk (key columns 16kk..16kk+15) from a score tile
__device__ __forceinline__ void p_frag(uint32_t (&a)[4], const float (&c)[kKeys / 2], int kk) {
  a[0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

// One score tile in place: s <- score_mul * s (kMasked at keys >= kv_len),
// then the online-softmax update of this thread's rows r0 (elements 0, 1 of
// each column block) and r0 + 8 (elements 2, 3): m <- max(m, rowmax(s)),
// s <- exp2(s - m), l <- l * alpha + rowsum(s); alpha = exp2(m_old - m_new)
// is what the accumulator has to be rescaled by.
__device__ __forceinline__ void softmax_tile(float (&s)[kKeys / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float score_mul, int kv0,
                                             int kv_len, int t) {
  if (score_mul != 1.f) {  // the fused paths fold it into q': a product by 1 changes no bit
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] *= score_mul;
  }
  if (kv0 + kKeys > kv_len) {  // the ragged stage
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      if (kv0 + (i >> 2) * 8 + 2 * t + (i & 1) >= kv_len) s[i] = kMasked;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = ex2(m[i] - mx[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) {
    const float p = ex2(s[i] - mx[(i >> 1) & 1]);
    s[i] = p;
    rs[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

// full row sums over the quad, floored at 1e-30
__device__ __forceinline__ void reduce_l(float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
}

// The mainloop of one block, under both kernels below: q's rows from tm_q
// (seq of them), K and V from tm_k / tm_v (boxes of kKeys rows), whose own
// row count the keys past kv_len never reach.
template <int D, bool kLseOnly>
__device__ __forceinline__ void flash_fwd_block(const CUtensorMap* tmq, const CUtensorMap* tmk,
                                                const CUtensorMap* tmv, bf16* __restrict__ out,
                                                float* __restrict__ lse, int seq, int heads,
                                                int kv_len, const int* __restrict__ kv_lens,
                                                float score_mul) {
  constexpr int QTILE = kTileBytes<D>;
  constexpr int KV = kKvTileBytes<D>;
  constexpr int S = kKvStages<D>;
  extern __shared__ unsigned char smem_raw[];
  // [Q: 2 tiles | K x S | V x S | barriers]
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + kConsumers * QTILE;
  const uint32_t sV = sK + S * KV;
  // full_k[S], full_v[S], empty_k[S], empty_v[S], resident
  const uint32_t full_k = sV + S * KV;
  const uint32_t full_v = full_k + 8 * S;
  const uint32_t empty_k = full_v + 8 * S;
  const uint32_t empty_v = empty_k + 8 * S;
  const uint32_t res_bar = empty_v + 8 * S;

  const int q0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (kv_lens != nullptr) kv_len = kv_lens[b];  // each sample's own, read on the device
  const int n_tiles = (kv_len + kKeys - 1) / kKeys;  // keys past kv_len add exactly 0

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k + 8 * s, 1);                // the producer's expect-tx
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumers * 4);  // one arrive per consumer warp
      mbar_init(empty_v + 8 * s, kConsumers * 4);
    }
    mbar_init(res_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(res_bar, kConsumers * QTILE);
      for (int c = 0; c < kConsumers; ++c) {
        load_tile<D>(sQ + c * QTILE, tmq, res_bar, q0 + c * kRows, h, b);
      }
      Ring<S> kr, vr;
      produce<D>(kr, full_k, empty_k, sK, tmk, 0, h, b);
      for (int it = 1; it <= n_tiles; ++it) {  // K_it before V_it-1: the order they are read
        if (it < n_tiles) produce<D>(kr, full_k, empty_k, sK, tmk, it, h, b);
        if constexpr (!kLseOnly) produce<D>(vr, full_v, empty_v, sV, tmv, it - 1, h, b);
      }
    }
  } else {  // consumer warpgroups
    reg_alloc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane & 3;
    const int r0 = q0 + c * kRows + warp * 16 + (lane >> 2);  // this thread's rows: r0, r0 + 8
    const uint32_t qa = sQ + c * QTILE;

    float s[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
    float m[2] = {kMasked, kMasked};  // running row max, log2 units
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums
    float alpha[2];
    Ring<S> kr, vr;
    mbar_wait(res_bar, 0);

    if constexpr (kLseOnly) {
      // per stage: S = Q K^T, the stage back to the producer, the softmax
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(full_k + 8 * kr.stage, kr.phase);
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          wgmma_ss<kKeys, 0>(s, kmajor(qa, ks), k_desc(sK + kr.stage * KV, ks), ks);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (lane == 0) mbar_arrive(empty_k + 8 * kr.stage);
        kr.next();
        softmax_tile(s, m, l, alpha, score_mul, it * kKeys, kv_len, t);
      }
      reduce_l(l);
      if (t == 0) {
        float* lb = lse + (static_cast<long long>(b) * heads + h) * seq;
        if (r0 < seq) lb[r0] = kLn2 * (m[0] + log2f(l[0]));
        if (r0 + 8 < seq) lb[r0 + 8] = kLn2 * (m[1] + log2f(l[1]));
      }
    } else {
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      uint32_t pa[kKeys / 16][4];
      // the turn to start products: consumer 0 takes the first; consumer 1
      // hands none back after its last products (every arrive meets a wait)
      const int mine = kSchedBar + c;
      const int other = kSchedBar + (c ^ 1);
      if (c == 1) named_bar_arrive(other, 2 * 128);

      // stage 0: S = Q K^T and its softmax (O is still 0: nothing to rescale)
      mbar_wait(full_k + 8 * kr.stage, kr.phase);
      named_bar_sync(mine, 2 * 128);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        wgmma_ss<kKeys, 0>(s, kmajor(qa, ks), k_desc(sK + kr.stage * KV, ks), ks);
      }
      wgmma_commit();
      if (c == 0 || n_tiles > 1) named_bar_arrive(other, 2 * 128);
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(empty_k + 8 * kr.stage);
      kr.next();
      softmax_tile(s, m, l, alpha, score_mul, 0, kv_len, t);

      for (int it = 1; it < n_tiles; ++it) {
        // P of stage it - 1 into A fragments; s is then free for stage it's scores
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          p_frag(pa[kk], s, kk);
          fence_regs(pa[kk]);
        }
        fence_regs(s);
        fence_regs(o);
        mbar_wait(full_k + 8 * kr.stage, kr.phase);
        mbar_wait(full_v + 8 * vr.stage, vr.phase);
        named_bar_sync(mine, 2 * 128);
        wgmma_fence();
        // S = Q K_it^T, then O += P V_it-1: two groups, in this order
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          wgmma_ss<kKeys, 0>(s, kmajor(qa, ks), k_desc(sK + kr.stage * KV, ks), ks);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          wgmma_rs<D, 1>(o, pa[kk], v_desc(sV + vr.stage * KV, kk), 1);
        }
        wgmma_commit();
        if (c == 0 || it + 1 < n_tiles) named_bar_arrive(other, 2 * 128);

        // S has landed: K_it goes back to the producer; its softmax while P V runs
        wgmma_wait<1>();
        fence_regs(s);
        if (lane == 0) mbar_arrive(empty_k + 8 * kr.stage);
        kr.next();
        softmax_tile(s, m, l, alpha, score_mul, it * kKeys, kv_len, t);

        // P V has landed: V_it-1 goes back to the producer, O moves to the new max
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty_v + 8 * vr.stage);
        vr.next();
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n + 0] *= alpha[0];
          o[4 * n + 1] *= alpha[0];
          o[4 * n + 2] *= alpha[1];
          o[4 * n + 3] *= alpha[1];
        }
      }

      // the last stage's O += P V
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        p_frag(pa[kk], s, kk);
        fence_regs(pa[kk]);
      }
      fence_regs(o);
      mbar_wait(full_v + 8 * vr.stage, vr.phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wgmma_rs<D, 1>(o, pa[kk], v_desc(sV + vr.stage * KV, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);

      // epilogue: full row sums, O / l as bf16, and L
      reduce_l(l);
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

template <int D, bool kLseOnly>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                      float* __restrict__ lse, int seq, int heads, int kv_len,
                      const int* __restrict__ kv_lens, float score_mul) {
  flash_fwd_block<D, kLseOnly>(&tm_q, &tm_k, &tm_v, out, lse, seq, heads, kv_len, kv_lens,
                               score_mul);
}

// Cross-attention: the same mainloop, O alone, with keys and values of a
// length of their own (kv_len, the text's rows) against seq queries; a kernel
// of its own name, so that a profile tells its time from self-attention's.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_cross_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                            int seq, int heads, int kv_len, float score_mul) {
  flash_fwd_block<D, false>(&tm_q, &tm_k, &tm_v, out, nullptr, seq, heads, kv_len, nullptr,
                            score_mul);
}

// kLseOnly: out is not written (may be null), tv is not read
template <int D, bool kLseOnly>
cudaError_t launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                       void* out, float* lse, int batch, int seq, int heads, int kv_len,
                       const int* kv_lens, float score_mul, cudaStream_t st) {
  const int smem = fwd_smem_bytes<D>();
  static SmemLimitOnce limit;
  const cudaError_t err = limit.set(flash_fwd_sm90_kernel<D, kLseOnly>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockRows - 1) / kBlockRows, heads, batch);
  flash_fwd_sm90_kernel<D, kLseOnly><<<grid, kThreads, smem, st>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, seq, heads, kv_len, kv_lens, score_mul);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_cross(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                         void* out, int batch, int seq, int heads, int kv_len, float score_mul,
                         cudaStream_t st) {
  const int smem = fwd_smem_bytes<D>();
  static SmemLimitOnce limit;
  const cudaError_t err = limit.set(flash_fwd_cross_sm90_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockRows - 1) / kBlockRows, heads, batch);
  flash_fwd_cross_sm90_kernel<D><<<grid, kThreads, smem, st>>>(
      tq, tk, tv, static_cast<bf16*>(out), seq, heads, kv_len, score_mul);
  return cudaGetLastError();
}

}  // namespace

namespace textflux {
namespace sm90 {

cudaError_t flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                      int batch, int seq, int seq_k, int heads, int head_dim, int kv_len,
                      const int* kv_lens, const long long* sd, float score_mul, bool cross,
                      cudaStream_t st) {
  if (head_dim != 64 && head_dim != 128) return cudaErrorInvalidValue;
  if (cross && (lse != nullptr || kv_lens != nullptr)) return cudaErrorInvalidValue;
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {seq, seq_k, seq_k};
  const int box[3] = {kRows, kKeys, kKeys};  // Q in 64-row tiles, K and V in stages
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = make_bshd_map(&maps[i], ptrs[i], batch, rows[i], heads, head_dim,
                                          sd[2 * i + 1], sd[2 * i], box[i]);
    if (err != cudaSuccess) return err;
  }
  if (cross) {
    return head_dim == 64 ? launch_cross<64>(maps[0], maps[1], maps[2], out, batch, seq, heads,
                                             kv_len, score_mul, st)
                          : launch_cross<128>(maps[0], maps[1], maps[2], out, batch, seq, heads,
                                              kv_len, score_mul, st);
  }
  return head_dim == 64 ? launch_fwd<64, false>(maps[0], maps[1], maps[2], out, lse, batch, seq,
                                                heads, kv_len, kv_lens, score_mul, st)
                        : launch_fwd<128, false>(maps[0], maps[1], maps[2], out, lse, batch,
                                                 seq, heads, kv_len, kv_lens, score_mul, st);
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
      q, k, v, out, static_cast<float*>(lse), batch, seq, seq, heads, head_dim, kv_len, nullptr,
      sd, scale_log2, false, static_cast<cudaStream_t>(stream)));
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
  const int box[2] = {kRows, kKeys};
  for (int i = 0; i < 2; ++i) {
    const cudaError_t err = make_bshd_map(&maps[i], ptrs[i], batch, seq, heads, head_dim,
                                          sd[2 * i + 1], sd[2 * i], box[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* l = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      head_dim == 64
          ? launch_fwd<64, true>(maps[0], maps[1], maps[1], nullptr, l, batch, seq, heads,
                                 kv_len, nullptr, scale_log2, st)
          : launch_fwd<128, true>(maps[0], maps[1], maps[1], nullptr, l, batch, seq, heads,
                                  kv_len, nullptr, scale_log2, st));
}
