// Tiled matrix products for Hopper (sm_90a) on the CUDA cores, in IEEE f32.
//
// Replaces two TPU kernels of src/repro/kernels/matmul.py:
//   matmul_pallas      (body _matmul_kernel)      C = A.B, f32 accumulator
//                                                 across K, cast to out_dtype;
//   matmul_acc_pallas  (body _matmul_acc_kernel)  C <- C + A.B, accumulator
//                                                 seeded from the C tile, C's
//                                                 buffer is the output.
// A and B are f32 or f16 (widened to f32 as they are staged), C is f32 or, for
// matmul, f16.  matmul_acc reads and writes each C tile from the one block
// that owns it, so the update in place is safe and allocates nothing.
//
// Bound: 2*M*N*K operations.  At 4096^3 that is 137.4 GFLOP, 2.05 ms at the
// card's 67 TFLOP/s of f32 on the CUDA cores, against 0.06 ms to move the
// 201 MB of A, B and C at 3.35 TB/s: bound by operations.  The reference's
// f32 bound of 1e-4 rules out TF32 tensor cores, so f32 stays on the CUDA
// cores; f16 inputs could use the tensor cores (0.139 ms at 989 TFLOP/s),
// which this simple kernel does not.  See simt_tile.cuh for the design.

#include "simt_tile.cuh"

// dtype codes: 0 = float32, 1 = float16
extern "C" int repro_matmul(int in_code, int out_code, const void* a, const void* b,
                            void* c, int m, int n, int k, long long lda, long long ldb,
                            long long ldc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code == 0 && out_code == 0)
    return simt::launch<float, float, simt::kStore>(a, b, c, m, n, k, lda, ldb, ldc, s);
  if (in_code == 0 && out_code == 1)
    return simt::launch<float, __half, simt::kStore>(a, b, c, m, n, k, lda, ldb, ldc, s);
  if (in_code == 1 && out_code == 0)
    return simt::launch<__half, float, simt::kStore>(a, b, c, m, n, k, lda, ldb, ldc, s);
  if (in_code == 1 && out_code == 1)
    return simt::launch<__half, __half, simt::kStore>(a, b, c, m, n, k, lda, ldb, ldc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// C (f32) += A.B for f32 or f16 A and B
extern "C" int repro_matmul_acc(int in_code, const void* a, const void* b, void* c, int m,
                                int n, int k, long long lda, long long ldb, long long ldc,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code == 0)
    return simt::launch<float, float, simt::kAccumulate>(a, b, c, m, n, k, lda, ldb, ldc, s);
  if (in_code == 1)
    return simt::launch<__half, float, simt::kAccumulate>(a, b, c, m, n, k, lda, ldb, ldc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
