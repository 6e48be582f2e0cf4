// Tiled matrix products for Hopper (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/matmul.py:
//   matmul_pallas      (body _matmul_kernel)      C = A.B, f32 accumulator
//                                                 across K, cast to out_dtype;
//   matmul_acc_pallas  (body _matmul_acc_kernel)  C <- C + A.B, accumulator
//                                                 seeded from the C tile, C's
//                                                 buffer is the output.
// Four kernels carry them:
//   repro_matmul_f16   f16 A and B, f32 or f16 C: the tensor-core kernel
//                      below (wgmma fed by TMA);
//   repro_matmul       f32 A and B, f32 or f16 C: simt_tile.cuh, IEEE f32 on
//                      the CUDA cores;
//   repro_matmul_acc   f32 A and B, f32 C, in place: ffma_tile.cuh, IEEE f32
//                      on the CUDA cores fed by TMA; f16 A and B:
//                      simt_tile.cuh.
// f32 inputs stay on the CUDA cores: the reference's f32 bound of 1e-4 rules
// out TF32 tensor cores.  matmul_acc reads and writes each C tile from the
// one block that owns it, so the update in place is safe and allocates
// nothing.
//
// Bound: 2*M*N*K operations.  At 4096^3 that is 137.4 GFLOP: 0.139 ms at the
// tensor cores' 989 TFLOP/s for f16, 2.05 ms at the CUDA cores' 67 TFLOP/s
// for f32, against 0.04-0.06 ms to move A, B and C at 3.35 TB/s: bound by
// operations.
//
// The f16 kernel (simple first, then fast): an output tile of 128 x 256 per
// block of three warpgroups.  One thread of the producer warpgroup keeps a
// 4-stage ring of shared-memory tiles filled by TMA: A as a 128 x 64 box
// (K-major, 128-byte rows), B as four boxes of 64 x 64 (MN-major: B is
// row-major K x N and is read through the descriptor's transpose bit, so
// nothing is transposed in memory).  Each of the two consumer warpgroups
// owns 64 rows of the tile and issues four wgmma m64n256k16 per stage into
// f32 registers, keeping one stage's products in flight while it releases
// the stage before; the producer gives up registers (setmaxnreg) so the
// consumers can hold 128 accumulators each.  TMA's zero fill pads ragged M,
// N and K; the epilogue stores f32 or f16 from registers with bounds checks.
// One tile width only: a narrower tile for grids that leave SMs idle waits
// for a workload where it measures faster.  No persistent scheduling or TMA
// store yet: 4096^2 / (128 x 256) = 512 tiles already fill the 132 SMs for
// about four waves.  f16 x f16 products are exact in f32; the tensor cores
// add them in f32.

#include <cuda_fp16.h>

#include "ffma_tile.cuh"
#include "hopper_tile.cuh"
#include "simt_tile.cuh"

namespace wg {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4, kThreads = 384;
// dynamic shared memory of a block: 197,696 B
constexpr size_t kSmemBytes =
    1024 + static_cast<size_t>(kStages) * (kBM + kBN) * kBK * sizeof(__half) +
    2 * kStages * sizeof(uint64_t);

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y, bool pair, bool both);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y, bool pair, bool both) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    p[0] = x;
    if (both) p[1] = y;
  }
}
template <>
__device__ __forceinline__ void store2<__half>(__half* p, float x, float y, bool pair, bool both) {
  if (pair) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  } else {
    p[0] = __float2half_rn(x);
    if (both) p[1] = __float2half_rn(y);
  }
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
matmul_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              TOut* __restrict__ C, int M, int N, int K, long long ldc) {
  constexpr int kTileA = kBM * kBK, kTileB = kBK * kBN;   // elements per stage
  extern __shared__ uint8_t smem_raw[];
  __half* sa = reinterpret_cast<__half*>(hopper::align_1024(smem_raw));
  __half* sb = sa + kStages * kTileA;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kTileB);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128;
  const int nk = (K + kBK - 1) / kBK;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);         // one arrival per consumer warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {                               // producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        hopper::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], (kTileA + kTileB) * sizeof(__half));
        hopper::tma_load_2d(sa + s * kTileA, &map_a, kt * kBK, m0, &full[s]);
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j)
          hopper::tma_load_2d(sb + s * kTileB + j * kBK * 64, &map_b, n0 + 64 * j, kt * kBK,
                              &full[s]);
      }
    }
  } else {                                     // consumers: rows m0 + 64 wg ..
    hopper::setmaxnreg_inc<232>();
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    hopper::fence_regs(acc);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      hopper::mbar_wait(&full[s], (kt / kStages) & 1);
      const __half* a = sa + s * kTileA + wg * 64 * kBK;
      const __half* b = sb + s * kTileB;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hopper::mma_f16_n256<1>(acc, hopper::desc_sw128(a + kk * 16, 16, 1024),
                                hopper::desc_sw128(b + kk * 16 * 64, kBK * 64 * sizeof(__half), 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();                 // stage kt - 1 is read: release it
      if (kt > 0 && threadIdx.x % 128 == 0) hopper::mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    const int t = threadIdx.x % 128;
    const int row = m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col = n0 + 2 * (t % 4);
    const bool even = (ldc % 2) == 0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = col + 8 * j;
      if (c >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r < M)
          store2<TOut>(C + r * ldc + c, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                       even && c + 1 < N, c + 1 < N);
      }
    }
  }
}

template <typename TOut>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b, void* c, int m, int n, int k,
           long long ldc, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  return static_cast<int>(hopper::launch(matmul_kernel<TOut>, grid, kThreads, kSmemBytes,
                                         stream, map_a, map_b, static_cast<TOut*>(c), m, n,
                                         k, ldc));
}

// The maps of A (K x M, box 64 x 128) and B (N x K, box 64 x 64).  A dim of
// size 1 has no row stride to speak of; it gets a padded one (TMA wants a
// multiple of 16 bytes).  K = 0 leaves both maps zero: the kernel then
// loads nothing and stores zeros.
inline int make_maps(CUtensorMap* map_a, CUtensorMap* map_b, const void* a, const void* b,
                     int m, int n, int k, long long lda, long long ldb) {
  *map_a = CUtensorMap{};
  *map_b = CUtensorMap{};
  if (k == 0) return 0;
  const long long pad_a = (k + 7) / 8 * 8, pad_b = (n + 7) / 8 * 8;
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k)};
  const cuuint64_t str_a[1] = {static_cast<cuuint64_t>((m == 1 ? pad_a : lda) * 2)};
  const cuuint64_t str_b[1] = {static_cast<cuuint64_t>((k == 1 ? pad_b : ldb) * 2)};
  const cuuint32_t box_a[2] = {kBK, kBM}, box_b[2] = {64, kBK};
  cudaError_t err = hopper::make_map(map_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, a, dims_a,
                                     str_a, box_a);
  if (err == cudaSuccess)
    err = hopper::make_map(map_b, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, b, dims_b, str_b, box_b);
  return static_cast<int>(err);
}

}  // namespace wg

// dtype codes: 0 = float32, 1 = float16

// C = A.B for f16 A and B (16-byte aligned bases, row strides a multiple of
// 8 elements), C f32 (out_code 0) or f16 (1), on the tensor cores
extern "C" int repro_matmul_f16(int out_code, const void* a, const void* b, void* c, int m,
                                int n, int k, long long lda, long long ldb, long long ldc,
                                void* stream) {
  if (m < 1 || n < 1 || k < 0 || (out_code != 0 && out_code != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  const int err = wg::make_maps(&map_a, &map_b, a, b, m, n, k, lda, ldb);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_code == 0 ? wg::launch<float>(map_a, map_b, c, m, n, k, ldc, s)
                       : wg::launch<__half>(map_a, map_b, c, m, n, k, ldc, s);
}

// C = A.B for f32 A and B, C f32 or f16, in IEEE f32 on the CUDA cores
extern "C" int repro_matmul(int in_code, int out_code, const void* a, const void* b, void* c,
                            int m, int n, int k, long long lda, long long ldb, long long ldc,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code == 0 && out_code == 0)
    return simt::launch<float, float, simt::kStore>(a, b, c, m, n, k, lda, ldb, ldc, s);
  if (in_code == 0 && out_code == 1)
    return simt::launch<float, __half, simt::kStore>(a, b, c, m, n, k, lda, ldb, ldc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// C (f32) += A.B for f32 A and B (TMA: 16-byte aligned bases, row strides a
// multiple of 4 elements) or f16 A and B
extern "C" int repro_matmul_acc(int in_code, const void* a, const void* b, void* c, int m,
                                int n, int k, long long lda, long long ldb, long long ldc,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code == 0) return f32tile::launch_acc(a, b, c, m, n, k, lda, ldb, ldc, s);
  if (in_code == 1)
    return simt::launch<__half, float, simt::kAccumulate>(a, b, c, m, n, k, lda, ldb, ldc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
