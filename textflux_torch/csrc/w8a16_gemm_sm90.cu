// The int8 weight-only linear for Hopper (sm_90a): Y = X (W_q * scale)^T + b
// in one kernel, the int8 codes converted to bf16 on chip. Bound to Python
// through the plain C entry point at the bottom (ctypes); see
// textflux_torch/ops/int8_matmul.py for the wrapper and its plain PyTorch
// version.
//
// Replaces no TPU kernel: the JAX package dequantises on read inside XLA's
// dot (textflux_tpu/io/quantize.py::dequantize_dense). It was added because
// on the H100 the port's plain version (codes cast to bf16, times the scale,
// then cuBLAS, then the bias) wrote and read two bf16 copies of every weight
// each time a linear ran, and that dequantise was half the device time of
// the int8 serving cell. Here no bf16 weight reaches device memory.
//
// What it computes: X bf16 (M, K) row-major, W_q int8 (N, K) row-major (the
// layout QuantLinear stores), scale fp32 (N,), bias bf16 (N,) or none;
// Y[m, n] = bf16(sum_k X[m, k] * W_q[n, k] * scale[n] + bias[n]): the
// products in fp32 on the tensor cores, the scale and the bias in fp32 in
// the epilogue, one rounding to bf16.
//
// Bound on the H100: 2*M*N*K FLOPs at 989 TFLOP/s against N*K bytes of
// codes plus 2*(M*K + M*N) of activations at 3.35 TB/s. The serving step's
// products (M = 512..1,664 tokens) are bound by tensor-core operations, the
// 1- and 30-row conditioning products by the codes' bytes. The design, on
// the building blocks of sm90_common.cuh:
//   - Swapped operands: a tile is Y^T[128 channels, T tokens]. The weight
//     rows are wgmma's 64-row A operand, one 64-row half for each of two
//     consumer warpgroups, taken from registers; the activations are the B
//     operand, K-major in shared memory. Tokens are wgmma's N: T is 32, 64,
//     128, 192 or 256, picked by the wrapper from M and N, so a 1-row or
//     30-row product takes a 32-token tile and is never padded to 64 rows.
//   - A producer warpgroup (setmaxnreg 24; one thread issues) keeps TMA
//     loads of the int8 W tile (128 rows x 64 bytes, 64-byte swizzle) and
//     the bf16 X tile (T rows x 64, 128-byte swizzle) in flight through a
//     ring of stages (4 to 8, as many as shared memory holds), one full and
//     one empty mbarrier a stage. Rows and columns past M, N and K read as
//     zeros, so ragged edges need no masks in the mainloop.
//   - Each consumer reads its 64 rows' codes of a stage from shared memory
//     straight into the A-fragment layout (two 4-byte loads and one byte
//     permute give a thread the codes of k = 2t, 2t+1, 2t+8, 2t+9 of a
//     k-step; the 64-byte swizzle keeps the loads free of bank conflicts)
//     and converts them by magic numbers: the code's byte, biased by 128,
//     under the exponent of 2^23 is the float 2^23 + 128 + q, one subtraction
//     leaves q exactly, and its upper half is q in bf16 (|q| <= 127 fits).
//     The next stage's conversion runs while this stage's four wgmma
//     m64nTk16 run; the A registers are double-buffered. Without the
//     conversion the same mainloop reaches 740 TFLOP/s at the largest
//     product, cuBLAS's bf16 rate: the conversion's instructions are what
//     stands between the two. (A bf16x2 form with 8 operations for 4 codes
//     in place of 11 ran 0-4% slower; two product groups in flight, with a
//     third A buffer, 15-20% slower. One H100 80GB HBM3, 700 W.)
//   - Persistent: min(tiles, SMs) blocks walk the tiles, tokens fastest, so
//     the blocks in flight share a weight tile and read it from L2. The
//     producer fetches the next tile's stages while the consumers finish
//     the last one.
//   - Epilogue: fp32 accumulators times scale[n] plus bias[n], rounded to
//     bf16, stored transposed by stmatrix into a 128-byte-swizzled tile of
//     shared memory (a consumer's own) and written to Y by one TMA store,
//     which leaves out rows past M and columns past N.
// No atomics and no split of K: a block owns its outputs, so Y is bitwise
// the same from run to run and in a CUDA graph's replay.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace textflux::sm90;
using bf16 = __nv_bfloat16;

constexpr int kWRows = kBlockRows;          // output channels a tile: 64 a consumer
constexpr int kBK = 64;                     // k a stage: 64 bytes of codes, 128 of bf16
constexpr int kWStageBytes = kWRows * kBK;  // 8 KB, 64-byte swizzle
constexpr int kSmemMax = 232448;            // a block's shared memory on the H100
constexpr int kMaxStages = 8;

template <int T>
struct Tile {
  static constexpr int kXBytes = T * kBK * 2;  // T tokens x 64 bf16, 128-byte swizzle
  static constexpr int kStageBytes = kXBytes + kWStageBytes;
  static constexpr int kOutBytes = T * 128;    // a consumer's T tokens x 64 channels, bf16
  static constexpr int kFixed = 1024 + kConsumers * kOutBytes + 16 * kMaxStages;
  static constexpr int kFit = (kSmemMax - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + kConsumers * kOutBytes +
                               16 * kStages;
  static_assert(kStages >= 2, "a ring of at least two stages");
  static_assert(kSmem <= kSmemMax, "shared memory");
};

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// four int8 codes (bytes 0..3 of w) -> bf16 pairs: lo = (q0, q1), hi = (q2, q3),
// the lower byte in the lower half
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  constexpr uint32_t kExp = 0x4B000000u;  // 2^23
  constexpr float kBias = 8388736.f;      // 2^23 + 128
  const uint32_t u = w ^ 0x80808080u;     // q + 128 in each byte
  const float f0 = __uint_as_float(__byte_perm(u, kExp, 0x7650)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, kExp, 0x7651)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, kExp, 0x7652)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, kExp, 0x7653)) - kBias;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// A fragments of the four k-steps of one stage for this thread's rows r and
// r + 8: `row` is the shared address of row r's 64 codes in the stage's W
// tile, `sw` its 64-byte swizzle phase (the same for r + 8), `word` the byte
// of the 4-byte word holding k = 2t, 2t+1 in a 16-byte chunk, `sel` the
// permute that keeps this thread's halves of that word and of the one 8
// bytes on (k = 2t+8, 2t+9)
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], uint32_t row, uint32_t sw,
                                       uint32_t word, uint32_t sel) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t p = row + ((kk ^ sw) << 4) + word;
    const uint32_t w0 = __byte_perm(lds32(p), lds32(p + 8), sel);
    const uint32_t w1 = __byte_perm(lds32(p + 8 * kBK), lds32(p + 8 * kBK + 8), sel);
    codes_to_bf16(w0, a[kk][0], a[kk][2]);
    codes_to_bf16(w1, a[kk][1], a[kk][3]);
  }
}

// One stage of a consumer: the four products of stage `q` (A in `cur`),
// then the stage before it back to the producer, then the next stage's
// codes into `nxt` while these products run.
template <int T, int S>
__device__ __forceinline__ void consume(float (&acc)[T / 2], uint32_t (&cur)[4][4],
                                        uint32_t (&nxt)[4][4], int i, int nk, int q,
                                        uint32_t sX, uint32_t wrow, uint32_t full,
                                        uint32_t empty, uint32_t sw, uint32_t word,
                                        uint32_t sel, int lane) {
  const int slot = q % S;
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(cur[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<T, 0>(acc, cur[kk], desc_sw128(sX + slot * Tile<T>::kXBytes + kk * 32, 16, 1024),
                   (i > 0 || kk > 0) ? 1 : 0);
  }
  wgmma_commit();
  wgmma_wait<1>();  // the previous stage's products are done: its slot and its A are free
  // `nxt` was the previous stage's A: held live up to here, so that no other
  // value takes its registers while those products could still read them
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(nxt[kk]);
  if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((q - 1) % S));
  if (i + 1 < nk) {
    const int nslot = (q + 1) % S;
    mbar_wait(full + 8 * nslot, ((q + 1) / S) & 1);
    load_a(nxt, wrow + nslot * kWStageBytes, sw, word, sel);
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
w8a16_gemm_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_y,
                       const float* __restrict__ scale, const bf16* __restrict__ bias, int m,
                       int n, int k) {
  using C = Tile<T>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  // [X x S | W x S | out: one per consumer | full x S | empty x S]
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sX = smem_u32(smem);
  const uint32_t sW = sX + S * C::kXBytes;
  const uint32_t sOut = sW + S * kWStageBytes;
  const uint32_t full = sOut + kConsumers * C::kOutBytes;
  const uint32_t empty = full + 8 * S;

  const int m_tiles = (m + T - 1) / T;
  const int tiles = ((n + kWRows - 1) / kWRows) * m_tiles;
  const int nk = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);                // the producer's expect-tx
      mbar_init(empty + 8 * s, kConsumers * 4);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      int q = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile / m_tiles) * kWRows;
        const int m0 = (tile % m_tiles) * T;
        for (int kb = 0; kb < nk; ++kb, ++q) {
          const int slot = q % S;
          mbar_wait(empty + 8 * slot, ((q / S) & 1) ^ 1);
          mbar_arrive_expect_tx(full + 8 * slot, C::kStageBytes);
          tma_load_2d(sX + slot * C::kXBytes, &tm_x, full + 8 * slot, kb * kBK, m0);
          tma_load_2d(sW + slot * kWStageBytes, &tm_w, full + 8 * slot, kb * kBK, n0);
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
    const int ch = c * 64 + warp * 16 + g;  // this thread's channels in a tile: ch, ch + 8
    const uint32_t wrow = sW + ch * kBK;
    const uint32_t sw = (g >> 1) & 3;
    const uint32_t word = (t >> 1) << 2;
    const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
    const uint32_t out = sOut + c * C::kOutBytes;
    const bool leader = threadIdx.x % 128 == 0;

    float acc[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) acc[i] = 0.f;
    uint32_t a0[4][4], a1[4][4];
    int q = 0;  // stages consumed, over all tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile / m_tiles) * kWRows;
      const int m0 = (tile % m_tiles) * T;

      mbar_wait(full + 8 * (q % S), (q / S) & 1);
      load_a(a0, wrow + (q % S) * kWStageBytes, sw, word, sel);
      for (int i = 0; i < nk; i += 2) {
        consume<T, S>(acc, a0, a1, i, nk, q + i, sX, wrow, full, empty, sw, word, sel, lane);
        if (i + 1 < nk) {
          consume<T, S>(acc, a1, a0, i + 1, nk, q + i + 1, sX, wrow, full, empty, sw, word, sel,
                        lane);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(a0[kk]);
        fence_regs(a1[kk]);
      }
      q += nk;
      if (lane == 0) mbar_arrive(empty + 8 * ((q - 1) % S));

      // epilogue: acc * scale + bias as bf16, transposed into this consumer's
      // tile (row = token, 128-byte swizzle), then one TMA store
      const int n_a = n0 + ch;
      const int n_b = n_a + 8;
      const float s_a = n_a < n ? scale[n_a] : 0.f;
      const float s_b = n_b < n ? scale[n_b] : 0.f;
      const float b_a = (bias != nullptr && n_a < n) ? __bfloat162float(bias[n_a]) : 0.f;
      const float b_b = (bias != nullptr && n_b < n) ? __bfloat162float(bias[n_b]) : 0.f;
      if (leader) bulk_wait_read();  // the last tile's store has read `out`
      named_bar_sync(1 + c, 128);
      const int mq = lane >> 3;  // the matrix whose row this lane addresses
      const int mi = lane & 7;   // that row: token 8j + mi
#pragma unroll
      for (int j = 0; j < T / 8; j += 2) {
        const int tok = 8 * (j + (mq >> 1)) + mi;
        const uint32_t chunk = (2 * warp + (mq & 1)) ^ mi;
        stmatrix_x4_trans(out + tok * 128 + (chunk << 4),
                          pack_bf16(acc[4 * j] * s_a + b_a, acc[4 * j + 1] * s_a + b_a),
                          pack_bf16(acc[4 * j + 2] * s_b + b_b, acc[4 * j + 3] * s_b + b_b),
                          pack_bf16(acc[4 * j + 4] * s_a + b_a, acc[4 * j + 5] * s_a + b_a),
                          pack_bf16(acc[4 * j + 6] * s_b + b_b, acc[4 * j + 7] * s_b + b_b));
      }
      fence_async_shared();
      named_bar_sync(1 + c, 128);
      if (leader && n0 + c * 64 < n) {
        tma_store_2d(&tm_y, out, n0 + c * 64, m0);
        bulk_commit();
      }
    }
    if (leader) bulk_wait();
  }
}

template <int T>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& ty,
                   const float* scale, const bf16* bias, int m, int n, int k, int grid,
                   cudaStream_t st) {
  static SmemLimitOnce limit;
  const cudaError_t err = limit.set(w8a16_gemm_sm90_kernel<T>, Tile<T>::kSmem);
  if (err != cudaSuccess) return err;
  w8a16_gemm_sm90_kernel<T><<<grid, kThreads, Tile<T>::kSmem, st>>>(tx, tw, ty, scale, bias, m,
                                                                    n, k);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous bf16 (m, k); w: contiguous int8 (n, k); scale: contiguous
// fp32 (n,); bias: contiguous bf16 (n,) or null; y: contiguous bf16 (m, n).
// m >= 1, k a multiple of 16, n a multiple of 8, every pointer 16-byte
// aligned; tile (tokens a tile) is 32, 64, 128, 192 or 256; grid is the
// number of persistent blocks (1 <= grid). Launches on `stream` without
// synchronising. Returns a cudaError_t (0 on success).
extern "C" int textflux_w8a16_gemm(const void* x, const void* w, const void* scale,
                                   const void* bias, void* y, int m, int n, int k, int tile,
                                   int grid, void* stream) {
  using namespace textflux::sm90;
  if (m < 1 || n < 8 || n % 8 != 0 || k < 16 || k % 16 != 0 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tx, tw, ty;
  cudaError_t err = make_2d_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, m, k, 2LL * k, 64,
                                tile, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = make_2d_map(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, n, k, k, 64, kWRows,
                      CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err == cudaSuccess) {
    err = make_2d_map(&ty, y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, m, n, 2LL * n, 64, tile,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* s = static_cast<const float*>(scale);
  const bf16* b = static_cast<const bf16*>(bias);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 32: return static_cast<int>(launch<32>(tx, tw, ty, s, b, m, n, k, grid, st));
    case 64: return static_cast<int>(launch<64>(tx, tw, ty, s, b, m, n, k, grid, st));
    case 128: return static_cast<int>(launch<128>(tx, tw, ty, s, b, m, n, k, grid, st));
    case 192: return static_cast<int>(launch<192>(tx, tw, ty, s, b, m, n, k, grid, st));
    case 256: return static_cast<int>(launch<256>(tx, tw, ty, s, b, m, n, k, grid, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
