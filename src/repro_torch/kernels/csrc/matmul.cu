// Tiled matrix products for Hopper (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/matmul.py:
//   matmul_pallas      (body _matmul_kernel)      C = A.B, f32 accumulator
//                                                 across K, cast to out_dtype;
//   matmul_acc_pallas  (body _matmul_acc_kernel)  C <- C + A.B, accumulator
//                                                 seeded from the C tile as
//                                                 f32, C's buffer is the
//                                                 output, in C's dtype.
// Each op runs on one of three tiles, in a store mode (matmul) or an
// accumulate mode (matmul_acc), with C in f32 or f16.  The wrapper
// (kernels/matmul.py::_route) picks the tile before the launch, from the
// input dtype and from whether TMA can read A and B (16-byte aligned bases,
// row strides a multiple of 16 bytes); a refused launch raises, and nothing
// falls back to another tile:
//   f16 A, B, TMA-readable   repro_tile_wgmma: the tensor-core tile below
//                            (wgmma fed by TMA);
//   f32 A, B, TMA-readable   repro_tile_ffma: ffma_tile.cuh, IEEE f32 FFMA on
//                            the CUDA cores, fed by TMA;
//   any other view           repro_tile_simt: simt_tile.cuh, register-staged
//                            IEEE f32 on the CUDA cores, element loads with
//                            bounds checks (any base, any row stride).
// f32 inputs stay on the CUDA cores: the reference's f32 bound of 1e-4 rules
// out TF32 tensor cores (ffma_tile.cuh says why).  The accumulate mode reads
// and writes each C tile from the one block that owns it, so the update in
// place is safe and allocates nothing.  Every tile sums in f32 and rounds
// once to C's type.
//
// Bounds: 2*M*N*K operations.  At 4096^3 that is 137.4 GFLOP: 0.139 ms at the
// tensor cores' 989 TFLOP/s for f16, 2.05 ms at the CUDA cores' 67 TFLOP/s
// for f32 (on either CUDA-core tile), against 0.04-0.06 ms to move A, B and
// C at 3.35 TB/s: bound by operations.  The f16-input accumulate at the SUMMA
// block shape (4096 x 2048).(2048 x 2048) does 34.4 GFLOP, 34.8 us on the
// tensor cores, and moves A 16.8 MB, B 8.4 MB and an f32 C read and written
// (2 x 33.6 MB), 92.3 MB in 27.5 us: bound by operations with the bytes close
// behind, so its C seed has to overlap the first TMA stages.
//
// The wgmma tile (simple first, then fast): an output tile of 128 x 256 per
// block of three warpgroups.  One thread of the producer warpgroup keeps a
// 4-stage ring of shared-memory tiles filled by TMA: A as a 128 x 64 box
// (K-major, 128-byte rows), B as four boxes of 64 x 64 (MN-major: B is
// row-major K x N and is read through the descriptor's transpose bit, so
// nothing is transposed in memory).  Each of the two consumer warpgroups
// owns 64 rows of the tile and issues four wgmma m64n256k16 per stage into
// f32 registers, keeping one stage's products in flight while it releases
// the stage before; the producer gives up registers (setmaxnreg) so the
// consumers can hold 128 accumulators each.  The store mode starts them at
// zero.  The accumulate mode loads them from C through the accumulator's
// fragment mapping (hopper_tile.cuh) before its first wait, so the loads
// overlap the first TMA stages, and writes them back in place through the
// same mapping.  TMA's zero fill pads ragged M, N and K; C moves with bounds
// checks, two neighbours in one access where its base and row stride allow.
// One tile width only: a narrower tile for grids that leave SMs idle waits
// for a workload where it measures faster.  No persistent scheduling or TMA
// store yet: 4096^2 / (128 x 256) = 512 tiles fill the 132 SMs for about
// four waves, the SUMMA block's 256 tiles for two.  f16 x f16 products are
// exact in f32; the tensor cores add them in f32 with truncation, which is
// why the f16 distributed runs have a bound of their own.

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

template <typename TOut, bool kAcc>
__global__ void __launch_bounds__(kThreads, 1)
matmul_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              TOut* __restrict__ C, int M, int N, int K, long long ldc, int c_pair) {
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
    // thread t's accumulator entries 4j + 2h and 4j + 2h + 1 are C[row + 8h]
    // [col + 8j] and its right neighbour
    const int t = threadIdx.x % 128;
    const int row = m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col = n0 + 2 * (t % 4);
    float acc[kBN / 2];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = col + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        float2 v = make_float2(0.f, 0.f);
        if (kAcc && r < M) v = hopper::load2(C + r * ldc + c, c_pair && c + 1 < N, N - c);
        acc[4 * j + 2 * h] = v.x;
        acc[4 * j + 2 * h + 1] = v.y;
      }
    }
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

#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = col + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r < M)
          hopper::store2(C + r * ldc + c, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                         c_pair && c + 1 < N, N - c);
      }
    }
  }
}

// The maps of A (K x M, box 64 x 128) and B (N x K, box 64 x 64).  A dim of
// size 1 has no row stride to speak of; it gets a padded one (TMA wants a
// multiple of 16 bytes).  K = 0 leaves both maps zero: the kernel then
// loads nothing and writes zeros (store mode) or C as it was (accumulate
// mode).
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

// C = A.B (kAcc false) or C += A.B (kAcc true) for f16 A, B (16-byte
// aligned bases, row strides a multiple of 8 elements) and C of TOut with
// any row stride
template <typename TOut, bool kAcc>
int launch(const void* a, const void* b, void* c, int m, int n, int k, long long lda,
           long long ldb, long long ldc, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const int err = make_maps(&map_a, &map_b, a, b, m, n, k, lda, ldb);
  if (err != 0) return err;
  const int c_pair = reinterpret_cast<uintptr_t>(c) % (2 * sizeof(TOut)) == 0 && ldc % 2 == 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  return static_cast<int>(hopper::launch(matmul_kernel<TOut, kAcc>, grid, kThreads, kSmemBytes,
                                         stream, map_a, map_b, static_cast<TOut*>(c), m, n,
                                         k, ldc, c_pair));
}

}  // namespace wg

// The three entries share one signature.  mode: 0 = store (C = A.B), 1 =
// accumulate (C += A.B in C's storage); dtype codes: 0 = float32, 1 =
// float16, for A and B (in_code) and for C (c_code).  A (m, k), B (k, n) and
// C (m, n) are row-major with unit inner stride and row strides lda, ldb,
// ldc.  Each launches on `stream` and returns a cudaError_t (0: launched, or
// nothing to do for m = 0 or n = 0).

namespace {

bool bad_args(int mode, int in_code, int c_code, int m, int n, int k) {
  return mode < 0 || mode > 1 || in_code < 0 || in_code > 1 || c_code < 0 || c_code > 1 ||
         m < 0 || n < 0 || k < 0;
}

template <typename TIn>
int simt_launch(int mode, int c_code, const void* a, const void* b, void* c, int m, int n, int k,
                long long lda, long long ldb, long long ldc, cudaStream_t s) {
  if (mode == 0)
    return c_code == 0
               ? simt::launch<TIn, float, simt::kStore>(a, b, c, m, n, k, lda, ldb, ldc, s)
               : simt::launch<TIn, __half, simt::kStore>(a, b, c, m, n, k, lda, ldb, ldc, s);
  return c_code == 0
             ? simt::launch<TIn, float, simt::kAccumulate>(a, b, c, m, n, k, lda, ldb, ldc, s)
             : simt::launch<TIn, __half, simt::kAccumulate>(a, b, c, m, n, k, lda, ldb, ldc, s);
}

}  // namespace

// f16 A and B that TMA reads, on the tensor cores
extern "C" int repro_tile_wgmma(int mode, int in_code, int c_code, const void* a, const void* b,
                                void* c, int m, int n, int k, long long lda, long long ldb,
                                long long ldc, void* stream) {
  if (bad_args(mode, in_code, c_code, m, n, k) || in_code != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    return c_code == 0 ? wg::launch<float, false>(a, b, c, m, n, k, lda, ldb, ldc, s)
                       : wg::launch<__half, false>(a, b, c, m, n, k, lda, ldb, ldc, s);
  return c_code == 0 ? wg::launch<float, true>(a, b, c, m, n, k, lda, ldb, ldc, s)
                     : wg::launch<__half, true>(a, b, c, m, n, k, lda, ldb, ldc, s);
}

// f32 A and B that TMA reads, IEEE f32 on the CUDA cores
extern "C" int repro_tile_ffma(int mode, int in_code, int c_code, const void* a, const void* b,
                               void* c, int m, int n, int k, long long lda, long long ldb,
                               long long ldc, void* stream) {
  if (bad_args(mode, in_code, c_code, m, n, k) || in_code != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    return c_code == 0 ? f32tile::launch<float, false>(a, b, c, m, n, k, lda, ldb, ldc, s)
                       : f32tile::launch<__half, false>(a, b, c, m, n, k, lda, ldb, ldc, s);
  return c_code == 0 ? f32tile::launch<float, true>(a, b, c, m, n, k, lda, ldb, ldc, s)
                     : f32tile::launch<__half, true>(a, b, c, m, n, k, lda, ldb, ldc, s);
}

// f32 or f16 A and B at any base and row stride, IEEE f32 on the CUDA cores
extern "C" int repro_tile_simt(int mode, int in_code, int c_code, const void* a, const void* b,
                               void* c, int m, int n, int k, long long lda, long long ldb,
                               long long ldc, void* stream) {
  if (bad_args(mode, in_code, c_code, m, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_code == 0 ? simt_launch<float>(mode, c_code, a, b, c, m, n, k, lda, ldb, ldc, s)
                      : simt_launch<__half>(mode, c_code, a, b, c, m, n, k, lda, ldb, ldc, s);
}
