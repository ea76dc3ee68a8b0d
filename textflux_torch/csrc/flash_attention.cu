// The backward's first pass for Hopper (sm_90a): the row log-sum-exp L.
// Bound to Python through the plain C entry point at the bottom (ctypes);
// see textflux_torch/ops/flash_attention.py for the wrapper and its plain
// PyTorch version. The forward (flash_fwd_sm90.cu) writes the same L beside
// O, so the training path no longer launches this kernel; it stays as
// flash_attention_bwd's pass 1 when no L is given, which is the JAX
// function's shape. The dQ and dK/dV passes are in flash_bwd_sm90.cu.
//
// Replaces the Pallas TPU kernel of textflux_tpu/ops/flash_attention.py:
//   flash_lse_kernel  <- _lse_kernel   (flash_attention_bwd, pass 1)
//
// What it computes, per (batch, head), with s = q k^T / sqrt(D) and keys at
// index >= kv_len masked out:
//   L_i = log sum_j exp(s_ij)            (natural log, fp32, (B, H, S))
// by an exp2 online max / sum over 64-key tiles (scores scaled by
// log2(e)/sqrt(D) in fp32).
//
// Bound on the H100 at the training shape (B=1, S=4224, H=24, D=128): the
// product is 2 x B*H*S*kv*D FLOPs = 110 GFLOP, 0.11 ms at 989 TFLOP/s (bf16
// tensor cores), against 52 MB of q/k (26 MB each) at 3.35 TB/s, 0.016 ms:
// bound by tensor-core operations, not memory.
//
// Design: the first kernels' recipe. One block of 4 warps per (b, h, 64-row tile); each
// warp owns 16 rows; S = Q K^T runs on the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 accumulate); the streamed K tiles are double-buffered in
// shared memory with cp.async, ragged tails zero-filled; batch and row
// strides are arguments, so q/k may be strided views. mma.sync runs at a
// fraction of the wgmma rate; the kernel is off the training path since the
// forward writes L, and was not redesigned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using textflux::cp_async_16;
using textflux::cp_async_commit;
using textflux::cp_async_wait;
using textflux::mma_16816;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;     // rows per tile, streamed or resident
constexpr int kWarps = 4;     // each warp owns 16 rows of the block's tile
constexpr int kThreads = kWarps * 32;
constexpr float kLn2 = 0.6931471805599453f;
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

}  // namespace

// q, k: bf16 (B, S, H, D) with unit feature stride and head stride D; their
// batch and sequence strides (in elements) are passed and must keep every
// row 16-byte aligned. lse: contiguous fp32 (B, H, S), written here.
// head_dim is 64 or 128; 1 <= kv_len <= seq. Returns a cudaError_t (0 on
// success).
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
