// Fused per-head RMSNorm + rotate-half RoPE + softmax attention, forward,
// for Hopper (sm_90a). Bound to Python through the plain C entry point at the
// bottom (ctypes); see textflux_torch/ops/flash_attention.py for the wrapper.
//
// Replaces the Pallas TPU kernel textflux_tpu/ops/flash_attention.py::
// _fused_kernel (+ _norm_rope), reached through flash_attention_qk_norm_rope.
//
// What it computes, per (batch, head):
//   qn = rmsnorm(q) (fp32), q' = (qn*cos_q + roll(qn, D/2)*sin_q) * log2(e)/sqrt(D)
//   kn = rmsnorm(k) (fp32), k' =  kn*cos_k + roll(kn, D/2)*sin_k
//   both rounded to bf16, then an exp2 online softmax over 64-row K/V tiles
//   with fp32 running max / sum / accumulator; keys at index >= kv_len get
//   -1e30. The tables are the wrapper's folded ones (learned RMSNorm scale and
//   rotate-half sign folded into cos/sin), (S, D) fp32.
//
// Bound on the H100 at the serving shape (B=1, S=1408, H=24, D=128):
//   work  4*S*S*D*H ~ 24.4 GFLOP -> ~25 us at 989 TFLOP/s (bf16 tensor cores)
//   bytes q/k/v/o ~ 34.6 MB + tables ~ 2.9 MB -> ~11 us at 3.35 TB/s
// so it is bound by tensor-core operations, not memory.
//
// Design against that bound, in two launches on one stream:
//   1. norm_rope_kernel: one warp per (b, s, h) row of q and k does the fp32
//      norm + rope once and writes bf16 q', k' to scratch (the TPU kernel, and
//      this kernel's first version, redid the K prep in every query tile;
//      that and its dependent per-row loads were the first version's
//      bottleneck). Costs one extra write + read of q and k (~35 MB, ~10 us).
//   2. attention_kernel: one block of 4 warps per (b, h, 64-row query tile).
//      Both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//      fp32 accumulate); each warp owns 16 query rows whose A fragments stay
//      in registers for the whole K/V loop; K'/V tiles stream through shared
//      memory with cp.async, double-buffered so tile i+1 loads while tile i
//      is multiplied; the probability tile goes from the S accumulator
//      straight into the A fragments of P*V; scores never leave registers.
// wgmma, TMA and warp specialisation are later work.

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

constexpr int kBlockM = 64;   // query rows per thread block
constexpr int kBlockN = 64;   // key/value rows per tile (== kBlockM: tiles share a loader)
constexpr int kWarps = 4;     // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kPrepWarps = 8; // rows per block of the prep kernel

// One warp prepares one row of D features held EPL = D/32 per lane:
//   dst = (xn*cos2 + xn_partner*sin2) * mul,  xn = x * rsqrt(mean(x^2) + eps)
// The rotate-half partner of feature j is j +- D/2, which lives in lane ^ 16
// at the same slot.
template <int D>
__device__ __forceinline__ void norm_rope_row(const __nv_bfloat16* __restrict__ x,
                                              const float* __restrict__ cos2,
                                              const float* __restrict__ sin2,
                                              float eps, float mul,
                                              __nv_bfloat16* __restrict__ dst, int lane) {
  constexpr int EPL = D / 32;
  float xv[EPL], c[EPL], s[EPL];
#pragma unroll
  for (int e = 0; e < EPL; e += 2) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x + lane * EPL + e));
    const float2 cf = *reinterpret_cast<const float2*>(cos2 + lane * EPL + e);
    const float2 sf = *reinterpret_cast<const float2*>(sin2 + lane * EPL + e);
    xv[e] = f.x;
    xv[e + 1] = f.y;
    c[e] = cf.x;
    c[e + 1] = cf.y;
    s[e] = sf.x;
    s[e + 1] = sf.y;
  }
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) ss += xv[e] * xv[e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  float xn[EPL], partner[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) xn[e] = xv[e] * r;
#pragma unroll
  for (int e = 0; e < EPL; ++e) partner[e] = __shfl_xor_sync(0xffffffffu, xn[e], 16);
#pragma unroll
  for (int e = 0; e < EPL; e += 2) {
    const float o0 = (xn[e] * c[e] + partner[e] * s[e]) * mul;
    const float o1 = (xn[e + 1] * c[e + 1] + partner[e + 1] * s[e + 1]) * mul;
    *reinterpret_cast<__nv_bfloat162*>(dst + lane * EPL + e) = __floats2bfloat162_rn(o0, o1);
  }
}

// q'/k' for every (b, s, h) row, into contiguous (B, S, H, D) scratch
template <int D>
__global__ void __launch_bounds__(kPrepWarps * 32)
norm_rope_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const float* __restrict__ cos_q, const float* __restrict__ sin_q,
                 const float* __restrict__ cos_k, const float* __restrict__ sin_k,
                 __nv_bfloat16* __restrict__ qn, __nv_bfloat16* __restrict__ kn,
                 int batch, int seq, int heads, long long q_sb, long long q_ss,
                 long long k_sb, long long k_ss, float eps, float q_mul) {
  const long long row = static_cast<long long>(blockIdx.x) * kPrepWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(batch) * seq * heads) return;  // warp-uniform
  const int h = static_cast<int>(row % heads);
  const long long bs = row / heads;
  const int s = static_cast<int>(bs % seq);
  const int b = static_cast<int>(bs / seq);
  const long long o = row * D;
  norm_rope_row<D>(q + b * q_sb + s * q_ss + h * D, cos_q + static_cast<long long>(s) * D,
                   sin_q + static_cast<long long>(s) * D, eps, q_mul, qn + o, lane);
  norm_rope_row<D>(k + b * k_sb + s * k_ss + h * D, cos_k + static_cast<long long>(s) * D,
                   sin_k + static_cast<long long>(s) * D, eps, 1.f, kn + o, lane);
}

// Stage a 64-row x D tile (rows row0.. of `src`, `row_stride` elements apart)
// into shared memory with row pitch LD; rows >= limit are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* __restrict__ src,
                                                long long row_stride, int row0, int limit,
                                                int tid) {
  constexpr int LD = D + 8;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr int ITERS = kBlockN * CPR / kThreads;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ qn, const __nv_bfloat16* __restrict__ kn,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 int seq, int heads, int kv_len, long long v_sb, long long v_ss) {
  constexpr int LD = D + 8;          // padded smem row: conflict-free fragment loads
  constexpr int KSTEPS = D / 16;     // k-steps of the Q*K^T product
  constexpr int NT_S = kBlockN / 8;  // n-tiles of one score tile
  constexpr int NT_O = D / 8;        // n-tiles of the output
  constexpr int TILE = kBlockN * LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // [K stage 0 | K stage 1 | V stage 0 | V stage 1]; the Q tile passes through
  // K stage 1 before the loop starts
  __nv_bfloat16* sK0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV0 = sK0 + 2 * TILE;
  __nv_bfloat16* sQ = sK0 + TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long qk_ss = static_cast<long long>(heads) * D;  // q'/k'/out row stride
  const long long qk_base = static_cast<long long>(b) * seq * qk_ss + h * D;
  const __nv_bfloat16* qb = qn + qk_base;
  const __nv_bfloat16* kb = kn + qk_base;
  const __nv_bfloat16* vb = v + b * v_sb + h * D;

  load_tile_async<D>(sQ, qb, qk_ss, q0, seq, tid);
  load_tile_async<D>(sK0, kb, qk_ss, 0, seq, tid);
  load_tile_async<D>(sV0, vb, v_ss, 0, seq, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int m0 = warp * 16;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const __nv_bfloat16* p0 = sQ + (m0 + g) * LD + ks * 16 + 2 * t;
    const __nv_bfloat16* p1 = p0 + 8 * LD;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(p0);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(p1);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
  }
  __syncthreads();  // every warp holds its Q fragments: K stage 1 is free

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-1e30f, -1e30f};  // rows g and g + 8 of this warp
  float l_run[2] = {0.f, 0.f};        // this thread's share of the row sums

  const int n_tiles = (kv_len + kBlockN - 1) / kBlockN;  // tiles past kv_len add exactly 0
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      const int nxt = (it + 1) * kBlockN;
      load_tile_async<D>(sK0 + (stage ^ 1) * TILE, kb, qk_ss, nxt, seq, tid);
      load_tile_async<D>(sV0 + (stage ^ 1) * TILE, vb, v_ss, nxt, seq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage's tile is visible to every warp
    const __nv_bfloat16* sK = sK0 + stage * TILE;
    const unsigned short* sVu = reinterpret_cast<const unsigned short*>(sV0 + stage * TILE);
    const int kv0 = it * kBlockN;

    // S = Q K^T (already in log2 units)
    float sc_[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      sc_[j][0] = sc_[j][1] = sc_[j][2] = sc_[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const __nv_bfloat16* kp = sK + (j * 8 + g) * LD + ks * 16 + 2 * t;
        mma_16816(sc_[j], qa[ks], *reinterpret_cast<const uint32_t*>(kp),
                  *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
    if (kv0 + kBlockN > kv_len) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kv0 + j * 8 + 2 * t + (e & 1) >= kv_len) sc_[j][e] = -1e30f;
        }
      }
    }

    // online softmax (exp2), rows g (elements 0,1) and g + 8 (elements 2,3)
    float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc_[j][0], sc_[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc_[j][2], sc_[j][3]));
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
      sc_[j][0] = exp2f(sc_[j][0] - mx0);
      sc_[j][1] = exp2f(sc_[j][1] - mx0);
      sc_[j][2] = exp2f(sc_[j][2] - mx1);
      sc_[j][3] = exp2f(sc_[j][3] - mx1);
      rs0 += sc_[j][0] + sc_[j][1];
      rs1 += sc_[j][2] + sc_[j][3];
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

    // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are exactly the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc_[2 * kk][0], sc_[2 * kk][1]);
      pa[1] = pack_bf16(sc_[2 * kk][2], sc_[2 * kk][3]);
      pa[2] = pack_bf16(sc_[2 * kk + 1][0], sc_[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc_[2 * kk + 1][2], sc_[2 * kk + 1][3]);
      const int kr = kk * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const int c = n * 8 + g;
        const uint32_t b0 = static_cast<uint32_t>(sVu[kr * LD + c]) |
                            (static_cast<uint32_t>(sVu[(kr + 1) * LD + c]) << 16);
        const uint32_t b1 = static_cast<uint32_t>(sVu[(kr + 8) * LD + c]) |
                            (static_cast<uint32_t>(sVu[(kr + 9) * LD + c]) << 16);
        mma_16816(o[n], pa, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // ---- finish: full row sums, normalise, bf16 out in (B, S, H, D) ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const float l0 = fmaxf(l_run[0], 1e-30f);
  const float l1 = fmaxf(l_run[1], 1e-30f);
  const int r0 = q0 + m0 + g;
  const int r1 = r0 + 8;
  __nv_bfloat16* ob = out + qk_base;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < seq) {
      *reinterpret_cast<uint32_t*>(ob + r0 * qk_ss + c) = pack_bf16(o[n][0] / l0, o[n][1] / l0);
    }
    if (r1 < seq) {
      *reinterpret_cast<uint32_t*>(ob + r1 * qk_ss + c) = pack_bf16(o[n][2] / l1, o[n][3] / l1);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* cos_q,
                   const void* sin_q, const void* cos_k, const void* sin_k, void* qn,
                   void* kn, void* out, int batch, int seq, int heads, int kv_len,
                   long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                   long long v_sb, long long v_ss, float eps, float q_mul,
                   cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * seq * heads;
  const unsigned prep_blocks = static_cast<unsigned>((rows + kPrepWarps - 1) / kPrepWarps);
  norm_rope_kernel<D><<<prep_blocks, kPrepWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const float*>(cos_q), static_cast<const float*>(sin_q),
      static_cast<const float*>(cos_k), static_cast<const float*>(sin_k),
      static_cast<__nv_bfloat16*>(qn), static_cast<__nv_bfloat16*>(kn), batch, seq, heads,
      q_sb, q_ss, k_sb, k_ss, eps, q_mul);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem = 4 * kBlockN * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  // per device, so set on every launch (cheap) rather than cached once
  err = cudaFuncSetAttribute(attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockM - 1) / kBlockM, heads, batch);
  attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qn), static_cast<const __nv_bfloat16*>(kn),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), seq, heads,
      kv_len, v_sb, v_ss);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (B, S, H, D) with unit feature stride and head stride D; the
// batch and sequence strides (in elements) are passed; v's rows must be
// 16-byte aligned. Tables: fp32 (S, D), contiguous. qn, kn: bf16 scratch
// (B, S, H, D), contiguous, written here. out: bf16 (B, S, H, D), contiguous.
// Returns a cudaError_t.
extern "C" int textflux_fused_norm_rope_attention(
    const void* q, const void* k, const void* v, const void* cos_q, const void* sin_q,
    const void* cos_k, const void* sin_k, void* qn, void* kn, void* out, int batch, int seq,
    int heads, int head_dim, int kv_len, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, float eps, float q_mul, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, cos_q, sin_q, cos_k, sin_k, qn, kn, out, batch, seq, heads,
                        kv_len, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, eps, q_mul, st);
    case 128:
      return launch<128>(q, k, v, cos_q, sin_q, cos_k, sin_k, qn, kn, out, batch, seq, heads,
                         kv_len, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, eps, q_mul, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
