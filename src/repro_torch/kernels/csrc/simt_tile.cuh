// The CUDA-core (SIMT) tile skeleton for Hopper (sm_90a), shared by the
// (min, +) kernel (minplus.cu) and by matmul.cu's route for the views that
// TMA cannot read (a base or a row stride off a 16-byte boundary: f16 (64 x
// 12) blocks, an x[:, 1:] panel, f32 at 250^3 with 1000-byte rows), for
// matmul and matmul_acc with f32 or f16 inputs and an f32 or f16 C.  The
// views TMA reads go to the wgmma tile (f16, matmul.cu) or the FFMA tile
// (f32, ffma_tile.cuh).
//
// C = A (x) B for row-major A (M, K) and B (K, N) with unit inner stride and
// row strides lda, ldb, ldc (so a column panel of a block is read in place).
// Three epilogues, chosen at compile time:
//   kStore       acc = 0,    acc += a * b,          C = acc   (matmul)
//   kAccumulate  acc = C,    acc += a * b,          C = acc   (matmul_acc)
//   kMinPlus     acc = +inf, acc = min(acc, a + b), C = acc   (minplus)
// Every product and sum is IEEE f32 on the CUDA cores: no TF32, no tensor
// cores (f16 inputs and an f16 C are widened to f32 as they are loaded, C
// is rounded once as it is stored, and products of f16 values are exact in
// f32).  The (min, +) semiring has no tensor-core path at all, and Hopper's
// DPX min/add instructions cover only integers.
//
// Bound: 2*M*N*K operations at the CUDA cores' 67 TFLOP/s for matmul in
// either input type (the f16 inputs lose the tensor cores here), M*N*K
// (add, min) pairs at 33.5 T/s for minplus.
//
// Design (simple and right first): a 128 x 128 output tile per block of 256
// threads, each thread owning an 8 x 8 register micro-tile (rows ty*4+i and
// 64+ty*4+i, columns tx*4+j and 64+tx*4+j, so the float4 reads of a k-row of
// shared memory are contiguous across a half-warp).  K is walked in slices
// of 8: the A slice (128 x 8) is stored transposed and the B slice (8 x 128)
// as is, in two shared-memory buffers; the next slice is loaded from device
// memory into registers while the current one is multiplied, then stored to
// the other buffer, with one barrier per slice.  Every load is element by
// element and bounds-checked, so any base and row stride is read, and pads
// with the epilogue's identity (0, or +inf for min-plus), so partial tiles
// are right.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace simt {

constexpr int kBM = 128, kBN = 128, kBK = 8, kThreads = 256;

enum Mode { kStore = 0, kAccumulate = 1, kMinPlus = 2 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

// IEEE minimum that propagates NaN, as jnp.minimum / torch.minimum do
// (fminf would drop a NaN operand).  PTX min.NaN needs sm_80 or later.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <typename TIn, typename TOut, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
tile_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B, TOut* C,
            int M, int N, int K, long long lda, long long ldb, long long ldc) {
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const float pad = MODE == kMinPlus ? __int_as_float(0x7f800000) : 0.f;

  // loader coordinates: A slice row a_r, k a_c..a_c+3; B slice k b_r,
  // columns b_c..b_c+3
  const int a_r = tid / 2, a_c = (tid % 2) * 4;
  const int b_r = tid / 32, b_c = (tid % 32) * 4;
  const int ga_r = row0 + a_r;

  float ra[4], rb[4];
  float acc[8][8];

  int rows[8], cols[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    rows[i] = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    cols[i] = col0 + (i < 4 ? tx * 4 + i : 64 + tx * 4 + i - 4);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (MODE == kAccumulate) {
        acc[i][j] = (rows[i] < M && cols[j] < N)
                        ? widen(C[rows[i] * ldc + cols[j]]) : 0.f;
      } else {
        acc[i][j] = pad;
      }
    }
  }

  // first slice
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = a_c + i;
    ra[i] = (ga_r < M && gk < K) ? widen(A[ga_r * lda + gk]) : pad;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gc = col0 + b_c + i;
    rb[i] = (b_r < K && gc < N) ? widen(B[b_r * ldb + gc]) : pad;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) As[0][a_c + i][a_r] = ra[i];
  *reinterpret_cast<float4*>(&Bs[0][b_r][b_c]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) {                     // next slice: device memory -> registers
      const int kn = k0 + kBK;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gk = kn + a_c + i;
        ra[i] = (ga_r < M && gk < K) ? widen(A[ga_r * lda + gk]) : pad;
      }
      const int gk = kn + b_r;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gc = col0 + b_c + i;
        rb[i] = (gk < K && gc < N) ? widen(B[gk * ldb + gc]) : pad;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (MODE == kMinPlus) {
            acc[i][j] = min_nan(acc[i][j], a[i] + b[j]);
          } else {
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
      }
    }
    if (more) {                     // registers -> the other buffer
#pragma unroll
      for (int i = 0; i < 4; ++i) As[buf ^ 1][a_c + i][a_r] = ra[i];
      *reinterpret_cast<float4*>(&Bs[buf ^ 1][b_r][b_c]) =
          make_float4(rb[0], rb[1], rb[2], rb[3]);
    }
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (rows[i] < M && cols[j] < N) C[rows[i] * ldc + cols[j]] = narrow<TOut>(acc[i][j]);
    }
  }
}

template <typename TIn, typename TOut, int MODE>
int launch(const void* a, const void* b, void* c, int m, int n, int k, long long lda,
           long long ldb, long long ldc, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  tile_kernel<TIn, TOut, MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b), static_cast<TOut*>(c), m, n,
      k, lda, ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
