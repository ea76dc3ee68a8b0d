// The AdaLN modulate of the DiT's blocks and output head for Hopper (sm_90a):
// y = LayerNorm(x) * (1 + scale) + shift in one pass over x. Bound to Python
// through the plain C entry point at the bottom (ctypes); see
// textflux_torch/ops/adaln.py for the wrapper and its plain PyTorch version.
//
// Replaces no TPU kernel: on the TPU XLA fuses the JAX package's
// layer_norm(x) * (1 + scale) + shift into the neighbouring ops. Eager
// PyTorch (and a CUDA graph of it) runs the same composition as 13 launches
// that upcast the row to float32 and write and read it about ten times; at
// 3,072 features that is ~180 KB of traffic a token where one read and one
// write of the bf16 row (12 KB) suffice.
//
// What it computes: x bf16 (B, S, D) with unit feature stride and batch and
// sequence strides, shift and scale bf16 (B, D) with unit feature stride and
// a batch stride (the chunks of a block's modulation vector); y bf16
// (B, S, D), contiguous. Per row, with the composition's rounding points:
//   mean = sum(x) / D, var = sum((x - mean)^2) / D      (fp32, two passes)
//   n = bf16((x - mean) * rsqrt(var + eps))
//   y = bf16(bf16(n * bf16(1 + scale)) + shift)
// Only the fp32 summation order of the mean and the variance differs from
// the composition: n is rarely one bf16 place off the composition's, and
// never more, and y then differs by that place carried through the product
// and the sum, which round as the composition's do.
//
// Bound on the H100: 2*B*S*D + 2*B*D bf16 bytes at 3.35 TB/s (x read once, y
// written once, the vectors once); no tensor-core work. The design moves
// those bytes and no others, in as few instructions as it can, since at the
// serving shapes (~1 wave of ~10 warps an SM) the instruction throughput for a
// row's ~20 instructions an element competes with the memory time:
//   - One warp a row. A lane holds its share of the row in registers as
//     16-byte vectors (V of them, D <= 256 * V: 12 at D = 3,072), loaded
//     and stored 16 bytes a lane, so each warp-wide access is 512
//     contiguous bytes. The mean and then the variance of (x - mean) are
//     taken from those registers; x is read from device memory once.
//   - The grid is (row blocks, batch): a block's 4 rows share a sample,
//     whose shift and bf16(1 + scale) the block stages in shared memory
//     (loaded by all its threads while x's loads are in flight), so the
//     output phase reads them at shared-memory latency (read from L2 one
//     vector after another they added ~5 us to every launch) and computes
//     1 + scale once a block, not once a row.
//   - n * bf16(1 + scale) is one bf16x2 multiply (mul.rn.bf16x2 rounds the
//     exact product once, as the composition's float32 product, exact for
//     two bf16 factors, then its rounding do); both roundings to bf16 are
//     one cvt for two values. 1 + scale and the sum with shift stay float32
//     adds then a rounding, since rounding twice can differ from once there.
//   - Each vector's eight values are summed as a tree and the vectors'
//     partial sums in order, so a lane's dependent chain is V + 3 additions
//     long, not 8V.
//   - Sums are warp shuffles in a fixed order and no block shares an output,
//     so y is bitwise the same from run to run and in a CUDA graph's replay.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kWarps = 4;       // rows a block
constexpr int kVec = 8;         // bf16 a 16-byte vector
constexpr int kSpan = 32 * kVec;  // features a warp-wide vector covers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
  const bf162* h = reinterpret_cast<const bf162*>(&v);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

__device__ __forceinline__ float tree8(const float (&f)[kVec]) {
  return ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
}

// V 16-byte vectors a lane: rows of D <= 256 * V features, D a multiple of 8.
// Grid (ceil(S / kWarps), B); dynamic shared memory 2 * D bf16.
template <int V>
__global__ void __launch_bounds__(kWarps * 32)
adaln_modulate_kernel(const bf16* __restrict__ x, const bf16* __restrict__ shift,
                      const bf16* __restrict__ scale, bf16* __restrict__ y, int seq, int d,
                      long long x_sb, long long x_ss, long long shift_sb, long long scale_sb,
                      float eps) {
  extern __shared__ uint4 staged[];  // the sample's shift, then bf16(1 + scale)
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = s < seq;  // warp-uniform

  uint4 v[V];
  if (live) {
    const bf16* xr = x + b * x_sb + s * x_ss;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int col = i * kSpan + lane * kVec;
      if (col < d) v[i] = *reinterpret_cast<const uint4*>(xr + col);
    }
  }
  const int nv = d / kVec;
  for (int i = threadIdx.x; i < nv; i += kWarps * 32) {
    staged[i] = *reinterpret_cast<const uint4*>(shift + b * shift_sb + i * kVec);
    float f[kVec];
    unpack(*reinterpret_cast<const uint4*>(scale + b * scale_sb + i * kVec), f);
    uint4 g;
    bf162* g2 = reinterpret_cast<bf162*>(&g);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) {
      g2[j] = __floats2bfloat162_rn(1.f + f[2 * j], 1.f + f[2 * j + 1]);
    }
    staged[nv + i] = g;
  }

  float mean = 0.f, r = 0.f;
  if (live) {
    float part[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      part[i] = 0.f;
      if (i * kSpan + lane * kVec < d) {
        float f[kVec];
        unpack(v[i], f);
        part[i] = tree8(f);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) sum += part[i];
    // torch.mean's float32 mean: the sum times 1/D
    const float inv_d = 1.f / static_cast<float>(d);
    mean = warp_sum(sum) * inv_d;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      part[i] = 0.f;
      if (i * kSpan + lane * kVec < d) {
        float f[kVec];
        unpack(v[i], f);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float c = f[j] - mean;
          f[j] = __fmul_rn(c, c);  // the square rounded, as torch.square, not fused
        }
        part[i] = tree8(f);
      }
    }
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) sq += part[i];
    r = rsqrtf(warp_sum(sq) * inv_d + eps);
  }
  __syncthreads();
  if (!live) return;

  bf16* yr = y + (static_cast<long long>(b) * seq + s) * d;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int col = i * kSpan + lane * kVec;
    if (col < d) {
      const uint4 shq = staged[col / kVec];
      const uint4 gq = staged[nv + col / kVec];
      const bf162* x2 = reinterpret_cast<const bf162*>(&v[i]);
      const bf162* sh2 = reinterpret_cast<const bf162*>(&shq);
      const bf162* g2 = reinterpret_cast<const bf162*>(&gq);
      uint4 out;
      bf162* o = reinterpret_cast<bf162*>(&out);
#pragma unroll
      for (int j = 0; j < kVec / 2; ++j) {
        const float2 xf = __bfloat1622float2(x2[j]);
        const bf162 n = __floats2bfloat162_rn(__fmul_rn(xf.x - mean, r),
                                              __fmul_rn(xf.y - mean, r));
        const float2 p = __bfloat1622float2(__hmul2_rn(n, g2[j]));
        const float2 sh = __bfloat1622float2(sh2[j]);
        o[j] = __floats2bfloat162_rn(__fadd_rn(p.x, sh.x), __fadd_rn(p.y, sh.y));
      }
      *reinterpret_cast<uint4*>(yr + col) = out;
    }
  }
}

template <int V>
cudaError_t launch(const void* x, const void* shift, const void* scale, void* y, int batch,
                   int seq, int d, long long x_sb, long long x_ss, long long shift_sb,
                   long long scale_sb, float eps, cudaStream_t stream) {
  const dim3 grid((seq + kWarps - 1) / kWarps, batch);
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(bf16);
  adaln_modulate_kernel<V><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(shift),
      static_cast<const bf16*>(scale), static_cast<bf16*>(y), seq, d, x_sb, x_ss, shift_sb,
      scale_sb, eps);
  return cudaGetLastError();
}

}  // namespace

// x: bf16 (B, S, D), unit feature stride, batch and sequence strides x_sb,
// x_ss in elements; shift, scale: bf16 (B, D), unit feature stride, batch
// strides shift_sb, scale_sb; every pointer 16-byte aligned and every stride
// a multiple of 8. y: bf16 (B, S, D), contiguous, written here. 1 <= B <=
// 65,535, 1 <= S < 2^31, D a multiple of 8 up to 8,192. Returns a cudaError_t.
extern "C" int textflux_adaln_modulate(const void* x, const void* shift, const void* scale,
                                       void* y, int batch, int seq, int d, long long x_sb,
                                       long long x_ss, long long shift_sb, long long scale_sb,
                                       float eps, void* stream) {
  if (batch < 1 || batch > 65535 || seq < 1 || d < kVec || d % kVec != 0 || d > 32 * kSpan) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int v = (d + kSpan - 1) / kSpan;
#define TEXTFLUX_ADALN(V)                                                                  \
  if (v <= V) {                                                                            \
    return static_cast<int>(launch<V>(x, shift, scale, y, batch, seq, d, x_sb, x_ss,       \
                                      shift_sb, scale_sb, eps, st));                       \
  }
  TEXTFLUX_ADALN(1)
  TEXTFLUX_ADALN(2)
  TEXTFLUX_ADALN(4)
  TEXTFLUX_ADALN(8)
  TEXTFLUX_ADALN(12)
  TEXTFLUX_ADALN(16)
  TEXTFLUX_ADALN(24)
  TEXTFLUX_ADALN(32)
#undef TEXTFLUX_ADALN
  return static_cast<int>(cudaErrorInvalidValue);
}
