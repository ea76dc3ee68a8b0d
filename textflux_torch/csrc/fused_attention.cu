// Fused per-head RMSNorm + rotate-half RoPE + softmax attention, forward,
// for Hopper (sm_90a). Bound to Python through the plain C entry points at
// the bottom (ctypes); see textflux_torch/ops/flash_attention.py for the
// wrapper.
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
//   1. norm_rope_kernel (here): one warp per (b, s, h) row of q and k does
//      the fp32 norm + rope once and writes bf16 q', k' to scratch (the TPU
//      kernel, and this kernel's first version, redid the K prep in every
//      query tile; that and its dependent per-row loads were the first
//      version's bottleneck). Costs one extra write + read of q and k (~35
//      MB, ~10 us).
//   2. flash_fwd_sm90_kernel (flash_fwd_sm90.cu) on q', k' and v with score
//      multiplier 1 and no L: the training forward's wgmma / TMA mainloop,
//      which reads the contiguous scratch and v's strided rows by TMA.
// textflux_norm_rope_prep launches pass 1 alone, so that it can be timed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"  // textflux::sm90::flash_fwd

namespace {

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

template <int D>
cudaError_t launch_prep(const void* q, const void* k, const void* cos_q, const void* sin_q,
                        const void* cos_k, const void* sin_k, void* qn, void* kn, int batch,
                        int seq, int heads, long long q_sb, long long q_ss, long long k_sb,
                        long long k_ss, float eps, float q_mul, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * seq * heads;
  const unsigned prep_blocks = static_cast<unsigned>((rows + kPrepWarps - 1) / kPrepWarps);
  norm_rope_kernel<D><<<prep_blocks, kPrepWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const float*>(cos_q), static_cast<const float*>(sin_q),
      static_cast<const float*>(cos_k), static_cast<const float*>(sin_k),
      static_cast<__nv_bfloat16*>(qn), static_cast<__nv_bfloat16*>(kn), batch, seq, heads,
      q_sb, q_ss, k_sb, k_ss, eps, q_mul);
  return cudaGetLastError();
}

cudaError_t prep(const void* q, const void* k, const void* cos_q, const void* sin_q,
                 const void* cos_k, const void* sin_k, void* qn, void* kn, int batch, int seq,
                 int heads, int head_dim, long long q_sb, long long q_ss, long long k_sb,
                 long long k_ss, float eps, float q_mul, cudaStream_t st) {
  switch (head_dim) {
    case 64:
      return launch_prep<64>(q, k, cos_q, sin_q, cos_k, sin_k, qn, kn, batch, seq, heads, q_sb,
                             q_ss, k_sb, k_ss, eps, q_mul, st);
    case 128:
      return launch_prep<128>(q, k, cos_q, sin_q, cos_k, sin_k, qn, kn, batch, seq, heads,
                              q_sb, q_ss, k_sb, k_ss, eps, q_mul, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k: bf16 (B, S, H, D) with unit feature stride and head stride D; the
// batch and sequence strides (in elements) are passed. Tables: fp32 (S, D),
// contiguous. qn, kn: bf16 scratch (B, S, H, D), contiguous, written here.
// head_dim is 64 or 128. Returns a cudaError_t.
extern "C" int textflux_norm_rope_prep(const void* q, const void* k, const void* cos_q,
                                       const void* sin_q, const void* cos_k, const void* sin_k,
                                       void* qn, void* kn, int batch, int seq, int heads,
                                       int head_dim, long long q_sb, long long q_ss,
                                       long long k_sb, long long k_ss, float eps, float q_mul,
                                       void* stream) {
  return static_cast<int>(prep(q, k, cos_q, sin_q, cos_k, sin_k, qn, kn, batch, seq, heads,
                               head_dim, q_sb, q_ss, k_sb, k_ss, eps, q_mul,
                               static_cast<cudaStream_t>(stream)));
}

// As textflux_norm_rope_prep, then the attention over q', k' and v: v is bf16
// (B, S, H, D) with unit feature stride, head stride D and batch / sequence
// strides that are multiples of 8 elements, 16-byte aligned (TMA reads it).
// out: bf16 (B, S, H, D), contiguous. 1 <= kv_len <= seq. kv_lens: null, or
// a device array of B int32 key lengths that the attention reads in kv_len's
// place. Returns a cudaError_t.
extern "C" int textflux_fused_norm_rope_attention(
    const void* q, const void* k, const void* v, const void* cos_q, const void* sin_q,
    const void* cos_k, const void* sin_k, void* qn, void* kn, void* out, int batch, int seq,
    int heads, int head_dim, int kv_len, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, float eps, float q_mul,
    const void* kv_lens, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = prep(q, k, cos_q, sin_q, cos_k, sin_k, qn, kn, batch, seq, heads, head_dim,
                         q_sb, q_ss, k_sb, k_ss, eps, q_mul, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row = static_cast<long long>(heads) * head_dim;  // q'/k' sequence stride
  const long long sd[6] = {seq * row, row, seq * row, row, v_sb, v_ss};
  err = textflux::sm90::flash_fwd(qn, kn, v, out, nullptr, batch, seq, seq, heads, head_dim,
                                  kv_len, static_cast<const int*>(kv_lens), sd, 1.f, false, st);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// Wan's attention: q/k RMSNorm across the token's heads, then RoPE or none
// ---------------------------------------------------------------------------
//
// Replaces no TPU kernel: the JAX package has no model whose q/k norm spans
// the heads. Wan's self-attention normalises each token's q (and k) over all
// H*D features with one (H*D,) weight, then applies interleaved 3-axis RoPE;
// its cross-attention does the same without RoPE, q over the video tokens
// and k over the text's. The per-head prep above cannot: its statistic is a
// warp's one head. norm_across_heads_kernel gives each token row of q or k
// one block of kAcrossThreads threads, which reads the row's H*D bf16
// features once (8-byte loads, kept in registers), sums their squares over
// the block, and writes
//   dst = rope(x * rsqrt(mean(x^2) + eps) * w) * mul   (fp32, one rounding)
// rope: (a, b) -> (a cos - b sin, b cos + a sin) on each interleaved pair,
// whose two features sit in one thread's 4-feature chunk. Bound on the H100
// by bytes: 2 + 2 bytes a feature of q and of k (plus the fp32 tables, read
// from L2 after the first head): at Wan's S = 9,880, H*D = 5,120, ~0.20 GB,
// ~0.06 ms at 3.35 TB/s. The attention then runs the forward mainloop on
// q', k' and v: flash_fwd_sm90_kernel for self-attention,
// flash_fwd_cross_sm90_kernel for cross-attention (keys of the text's
// length).

namespace {

constexpr int kAcrossThreads = 256;
constexpr int kAcrossChunks = 8;  // 4-feature chunks a thread holds: H*D <= 8,192

template <bool kRope>
__global__ void __launch_bounds__(kAcrossThreads)
norm_across_heads_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const float* __restrict__ wq, const float* __restrict__ wk,
                         const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                         __nv_bfloat16* __restrict__ qn, __nv_bfloat16* __restrict__ kn,
                         int batch, int seq_q, int seq_k, int head_dim, int width,
                         long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                         float eps, float q_mul) {
  __shared__ float partial[kAcrossThreads / 32];
  const long long q_rows = static_cast<long long>(batch) * seq_q;
  long long row = blockIdx.x;
  const bool is_q = row < q_rows;
  if (!is_q) row -= q_rows;
  const int seq = is_q ? seq_q : seq_k;
  const int s = static_cast<int>(row % seq);
  const int b = static_cast<int>(row / seq);
  const __nv_bfloat16* src = is_q ? q + b * q_sb + s * q_ss : k + b * k_sb + s * k_ss;
  __nv_bfloat16* dst = (is_q ? qn : kn) + row * width;
  const float* w = is_q ? wq : wk;
  const float mul = is_q ? q_mul : 1.f;
  const int chunks = width / 4;

  float x[kAcrossChunks][4];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kAcrossChunks; ++i) {
    const int c = i * kAcrossThreads + threadIdx.x;
    if (c < chunks) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src + 4 * c);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      x[i][0] = lo.x;
      x[i][1] = lo.y;
      x[i][2] = hi.x;
      x[i][3] = hi.y;
      ss += lo.x * lo.x + lo.y * lo.y + hi.x * hi.x + hi.y * hi.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int i = 0; i < kAcrossThreads / 32; ++i) ss += partial[i];
  const float r = rsqrtf(ss / static_cast<float>(width) + eps);

#pragma unroll
  for (int i = 0; i < kAcrossChunks; ++i) {
    const int c = i * kAcrossThreads + threadIdx.x;
    if (c < chunks) {
      const float4 wv = *reinterpret_cast<const float4*>(w + 4 * c);
      float y[4] = {x[i][0] * r * wv.x, x[i][1] * r * wv.y, x[i][2] * r * wv.z,
                    x[i][3] * r * wv.w};
      if constexpr (kRope) {
        const int j = (4 * c) % head_dim;  // feature of the head: pairs (j, j+1), (j+2, j+3)
        const float4 cv = *reinterpret_cast<const float4*>(cos_t + static_cast<long long>(s) *
                                                           head_dim + j);
        const float4 sv = *reinterpret_cast<const float4*>(sin_t + static_cast<long long>(s) *
                                                           head_dim + j);
        const float a0 = y[0], b0 = y[1], a1 = y[2], b1 = y[3];
        y[0] = a0 * cv.x - b0 * sv.x;
        y[1] = b0 * cv.y + a0 * sv.y;
        y[2] = a1 * cv.z - b1 * sv.z;
        y[3] = b1 * cv.w + a1 * sv.w;
      }
      __nv_bfloat162 lo = __floats2bfloat162_rn(y[0] * mul, y[1] * mul);
      __nv_bfloat162 hi = __floats2bfloat162_rn(y[2] * mul, y[3] * mul);
      uint2 out;
      out.x = *reinterpret_cast<uint32_t*>(&lo);
      out.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst + 4 * c) = out;
    }
  }
}

cudaError_t across_prep(const void* q, const void* k, const void* wq, const void* wk,
                        const void* cos_t, const void* sin_t, void* qn, void* kn, int batch,
                        int seq_q, int seq_k, int heads, int head_dim, long long q_sb,
                        long long q_ss, long long k_sb, long long k_ss, float eps, float q_mul,
                        cudaStream_t st) {
  const int width = heads * head_dim;
  if (head_dim % 4 != 0 || width > 4 * kAcrossThreads * kAcrossChunks) {
    return cudaErrorInvalidValue;
  }
  const long long rows = static_cast<long long>(batch) * (seq_q + seq_k);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* wqf = static_cast<const float*>(wq);
  const auto* wkf = static_cast<const float*>(wk);
  auto* qo = static_cast<__nv_bfloat16*>(qn);
  auto* ko = static_cast<__nv_bfloat16*>(kn);
  if (cos_t != nullptr) {
    norm_across_heads_kernel<true><<<static_cast<unsigned>(rows), kAcrossThreads, 0, st>>>(
        qb, kb, wqf, wkf, static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
        qo, ko, batch, seq_q, seq_k, head_dim, width, q_sb, q_ss, k_sb, k_ss, eps, q_mul);
  } else {
    norm_across_heads_kernel<false><<<static_cast<unsigned>(rows), kAcrossThreads, 0, st>>>(
        qb, kb, wqf, wkf, nullptr, nullptr, qo, ko, batch, seq_q, seq_k, head_dim, width, q_sb,
        q_ss, k_sb, k_ss, eps, q_mul);
  }
  return cudaGetLastError();
}

}  // namespace

// q: bf16 (B, seq_q, H, D), k: bf16 (B, seq_k, H, D), each with unit feature
// stride and head stride D, their batch and sequence strides (elements,
// multiples of 4) passed. wq, wk: fp32 (H*D,). cos_t, sin_t: fp32 (seq_q, D)
// interleaved tables (seq_q == seq_k), or both null for no RoPE. qn, kn:
// contiguous bf16 scratch of q's and k's shapes, written here (q' times
// q_mul). Returns a cudaError_t.
extern "C" int textflux_across_heads_prep(const void* q, const void* k, const void* wq,
                                          const void* wk, const void* cos_t, const void* sin_t,
                                          void* qn, void* kn, int batch, int seq_q, int seq_k,
                                          int heads, int head_dim, long long q_sb,
                                          long long q_ss, long long k_sb, long long k_ss,
                                          float eps, float q_mul, void* stream) {
  return static_cast<int>(across_prep(q, k, wq, wk, cos_t, sin_t, qn, kn, batch, seq_q, seq_k,
                                      heads, head_dim, q_sb, q_ss, k_sb, k_ss, eps, q_mul,
                                      static_cast<cudaStream_t>(stream)));
}

// As textflux_across_heads_prep (q_mul = log2(e)/sqrt(D)), then the
// attention over q', k' and v: v is bf16 (B, seq_k, H, D) with unit feature
// stride, head stride D and batch / sequence strides that are multiples of 8
// elements, 16-byte aligned (TMA reads it). With tables: self-attention
// (seq_k == seq_q), flash_fwd_sm90_kernel; without: cross-attention,
// flash_fwd_cross_sm90_kernel. out: contiguous bf16 (B, seq_q, H, D). Every
// key is live. Returns a cudaError_t.
extern "C" int textflux_across_heads_attention(
    const void* q, const void* k, const void* v, const void* wq, const void* wk,
    const void* cos_t, const void* sin_t, void* qn, void* kn, void* out, int batch, int seq_q,
    int seq_k, int heads, int head_dim, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, float eps, float q_mul, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cross = cos_t == nullptr;
  if (!cross && seq_k != seq_q) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = across_prep(q, k, wq, wk, cos_t, sin_t, qn, kn, batch, seq_q, seq_k, heads,
                                head_dim, q_sb, q_ss, k_sb, k_ss, eps, q_mul, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row = static_cast<long long>(heads) * head_dim;
  const long long sd[6] = {seq_q * row, row, seq_k * row, row, v_sb, v_ss};
  err = textflux::sm90::flash_fwd(qn, kn, v, out, nullptr, batch, seq_q, seq_k, heads, head_dim,
                                  seq_k, nullptr, sd, 1.f, cross, st);
  return static_cast<int>(err);
}
