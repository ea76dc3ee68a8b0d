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
// out: bf16 (B, S, H, D), contiguous. 1 <= kv_len <= seq. Returns a
// cudaError_t.
extern "C" int textflux_fused_norm_rope_attention(
    const void* q, const void* k, const void* v, const void* cos_q, const void* sin_q,
    const void* cos_k, const void* sin_k, void* qn, void* kn, void* out, int batch, int seq,
    int heads, int head_dim, int kv_len, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, float eps, float q_mul, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = prep(q, k, cos_q, sin_q, cos_k, sin_k, qn, kn, batch, seq, heads, head_dim,
                         q_sb, q_ss, k_sb, k_ss, eps, q_mul, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row = static_cast<long long>(heads) * head_dim;  // q'/k' sequence stride
  const long long sd[6] = {seq * row, row, seq * row, row, v_sb, v_ss};
  err = textflux::sm90::flash_fwd(qn, kn, v, out, nullptr, batch, seq, heads, head_dim, kv_len,
                                  sd, 1.f, st);
  return static_cast<int>(err);
}
