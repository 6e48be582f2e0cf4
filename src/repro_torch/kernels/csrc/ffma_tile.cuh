// The Hopper CUDA-core tile of f32 matmul and f32 matmul_acc (sm_90a):
// C = A.B (store mode) or C += A.B in place (accumulate mode) for f32 A and
// B read by TMA, C f32 or f16, every product and sum IEEE f32 on the CUDA
// cores (FFMA; no TF32, no split into TF32 terms, so the arithmetic and its
// 67 TFLOP/s bound are those of f32).  f32 stays off the tensor cores
// because the reference's f32 bound of 1e-4 (tests/test_kernels.py), and
// the distributed bodies' normwise 2 sqrt(n) 2^-24, hold only for f32
// products: TF32 keeps 10 mantissa bits.
//
// Replaces, for f32 inputs whose views TMA can read (16-byte aligned bases
// and row strides), src/repro/kernels/matmul.py matmul_pallas (body
// _matmul_kernel: the accumulator starts at zero, C = acc cast to
// out_dtype) and matmul_acc_pallas (body _matmul_acc_kernel: the
// accumulator is seeded from the C tile widened to f32, C's buffer is the
// output, cast back to C's dtype).  Other f32 views go to simt_tile.cuh.
//
// Bound: 2*M*N*K operations at the CUDA cores' 67 TFLOP/s.  matmul at 4096^3:
// 137.4 GFLOP, 2.051 ms against 0.06 ms to move A, B and C at 3.35 TB/s;
// matmul_acc at the SUMMA block shape (4096 x 2048).(2048 x 2048): 0.513 ms
// against 0.05 ms.  Both are bound by operations, and what the tile must
// keep off the FFMA pipe's critical path is everything else: address
// arithmetic, loads, barriers.  The f16-output and f16-C instantiations
// have the same bound (C's bytes are fewer).
//
// Design: a 128 x 128 output tile per block of 8 consumer warps and one
// producer warp.  One thread of the producer keeps a 4-stage ring of K
// slices 32 deep filled by TMA (hopper_tile.cuh's maps and mbarriers): A as
// a 128 x 32 box with the 128-byte swizzle (k-major rows of 128 bytes, the
// 16-byte chunk c of row r stored at c ^ (r % 8)), B as a 32 x 128 box as
// it is.  TMA's zero fill pads ragged M, N and K, so loads need no bounds
// checks, and no thread spends registers or instructions on a copy.  Each
// consumer thread owns an 8 x 8 register micro-tile: rows ty + 16 i (so all
// eight share r % 8 = ty % 8, and one swizzled offset per 4 k serves them
// all, the rows differing by immediate offsets) and columns tx*4+j and
// 64+tx*4+j.  Per 4 k it reads its 8 rows of A as one 16-byte vector each
// along k (a warp's two rows ty = 2w, 2w+1 land on different banks) and,
// per k, two 16-byte vectors of B, then issues 256 FFMAs; a consumer warp
// releases a stage with one mbarrier arrival, so there is no block barrier
// in the K loop.  The store mode starts the accumulator at zero; the
// accumulate mode seeds it from C before the first wait, so the seed loads
// overlap the first TMA stages.  The seed and the epilogue move four
// elements a thread in one access where C's base and row stride allow it
// (else one element at a time), and C is read and written by the one block
// that owns the tile: the update is in place.  Each output is C + sum_k a*b
// (or sum_k a*b) with the FFMAs in k order, as simt_tile.cuh's, rounded
// once to C's type.

#pragma once

#include <cstdint>

#include "hopper_tile.cuh"

namespace f32tile {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 4;
constexpr int kConsumerWarps = 8, kConsumers = 32 * kConsumerWarps, kThreads = kConsumers + 32;
constexpr int kTileA = kBM * kBK, kTileB = kBK * kBN;     // floats per stage
// dynamic shared memory of a block: 132,160 B
constexpr size_t kSmemBytes = 1024 + static_cast<size_t>(kStages) * (kTileA + kTileB) * sizeof(float) +
                              2 * kStages * sizeof(uint64_t);

template <typename TOut, bool kAcc>
__global__ void __launch_bounds__(kThreads, 1)
tile_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            TOut* __restrict__ C, int M, int N, int K, long long ldc, int c_vec) {
  extern __shared__ uint8_t smem_raw[];
  float* sa = reinterpret_cast<float*>(hopper::align_1024(smem_raw));
  float* sb = sa + kStages * kTileA;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kTileB);
  uint64_t* empty = full + kStages;

  const int nk = (K + kBK - 1) / kBK;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);   // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {                   // producer
    if (threadIdx.x == kConsumers) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        hopper::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], (kTileA + kTileB) * sizeof(float));
        hopper::tma_load_2d(sa + s * kTileA, &map_a, kt * kBK, m0, &full[s]);
        hopper::tma_load_2d(sb + s * kTileB, &map_b, n0, kt * kBK, &full[s]);
      }
    }
    return;
  }

  const int tid = threadIdx.x, lane = tid & 31, tx = tid & 15, ty = tid >> 4;
  constexpr int kRowStep = 16;                       // tile-local rows ty + 16 i

  // the accumulator: zero, or seeded from C
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty + kRowStep * i;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = n0 + hh * 64 + tx * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (kAcc && r < M) hopper::load4(C + r * ldc + c, c_vec && c + 3 < N, N - c, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][hh * 4 + e] = v[e];
    }
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    const float* As = sa + s * kTileA + ty * kBK;
    const float* Bs = sb + s * kTileB;
#pragma unroll
    for (int k4 = 0; k4 < kBK / 4; ++k4) {
      const float* ak = As + ((k4 ^ (ty & 7)) << 2);   // this k4's chunk in every row
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(ak + i * kRowStep * kBK);
        a[i][0] = t.x; a[i][1] = t.y; a[i][2] = t.z; a[i][3] = t.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = Bs + (k4 * 4 + kk) * kBN + tx * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 64);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], bv[j], acc[i][j]);
      }
    }
    __syncwarp();                                    // every lane has read stage s
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty + kRowStep * i;
    if (r >= M) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = n0 + hh * 64 + tx * 4;
      const float v[4] = {acc[i][hh * 4], acc[i][hh * 4 + 1], acc[i][hh * 4 + 2],
                          acc[i][hh * 4 + 3]};
      hopper::store4(C + r * ldc + c, v, c_vec && c + 3 < N, N - c);
    }
  }
}

// The maps of A (K x M, box 32 x 128, 128-byte swizzle) and B (N x K, box
// 128 x 32, no swizzle).  A dim of size 1 has no row stride to speak of; it
// gets a padded one (TMA wants a multiple of 16 bytes).  K = 0 leaves both
// maps zero: the kernel then loads nothing and writes zeros (store mode) or
// C as it was (accumulate mode).
inline int make_maps(CUtensorMap* map_a, CUtensorMap* map_b, const void* a, const void* b,
                     int m, int n, int k, long long lda, long long ldb) {
  *map_a = CUtensorMap{};
  *map_b = CUtensorMap{};
  if (k == 0) return 0;
  const long long pad_a = (k + 3) / 4 * 4, pad_b = (n + 3) / 4 * 4;
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k)};
  const cuuint64_t str_a[1] = {static_cast<cuuint64_t>((m == 1 ? pad_a : lda) * 4)};
  const cuuint64_t str_b[1] = {static_cast<cuuint64_t>((k == 1 ? pad_b : ldb) * 4)};
  const cuuint32_t box_a[2] = {kBK, kBM}, box_b[2] = {kBN, kBK};
  cudaError_t err = hopper::make_map(map_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a, dims_a,
                                     str_a, box_a);
  if (err == cudaSuccess)
    err = hopper::make_map(map_b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, b, dims_b, str_b, box_b,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  return static_cast<int>(err);
}

// C = A.B (kAcc false) or C += A.B (kAcc true) for f32 A, B (16-byte
// aligned bases, row strides a multiple of 4 elements) and C of TOut with
// any row stride
template <typename TOut, bool kAcc>
int launch(const void* a, const void* b, void* c, int m, int n, int k, long long lda,
           long long ldb, long long ldc, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const int err = make_maps(&map_a, &map_b, a, b, m, n, k, lda, ldb);
  if (err != 0) return err;
  const int c_vec = reinterpret_cast<uintptr_t>(c) % (4 * sizeof(TOut)) == 0 && ldc % 4 == 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  return static_cast<int>(hopper::launch(tile_kernel<TOut, kAcc>, grid, kThreads, kSmemBytes,
                                         stream, map_a, map_b, static_cast<TOut*>(c), m, n,
                                         k, ldc, c_vec));
}

}  // namespace f32tile
