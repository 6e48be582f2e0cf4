// The (min, +) matrix product for Hopper (sm_90a): C[i,j] = min_k A[i,k] + B[k,j].
//
// Replaces the TPU kernel src/repro/kernels/minplus.py (minplus_pallas, body
// _minplus_kernel), the hot spot of blocked Floyd-Warshall: running minimum
// from +inf, rank-1 (min, +) updates over K, output in A's dtype (f32).
// The minimum propagates NaN (PTX min.NaN), as jnp.minimum and torch.minimum
// do; Floyd-Warshall inputs hold +inf and never NaN.
//
// Bound: M*N*K (i, j, k) triples, each an f32 add and an f32 min: two
// instructions on the CUDA cores, where the card's 67 TFLOP/s counts a fused
// multiply-add as two operations.  At 4096^3 that is 2 * 68.7 G instructions
// at 33.5 T/s, 4.1 ms, against 0.06 ms for the bytes: bound by operations.
// There is no tensor-core path for (min, +), and Hopper's DPX min/add covers
// only integers.  The tile skeleton is the matmul's (simt_tile.cuh) with the
// multiply-add replaced by add-then-min and +inf as the padding.

#include "simt_tile.cuh"

extern "C" int repro_minplus(const void* a, const void* b, void* c, int m, int n, int k,
                             long long lda, long long ldb, long long ldc, void* stream) {
  return simt::launch<float, float, simt::kMinPlus>(a, b, c, m, n, k, lda, ldb, ldc,
                                                    static_cast<cudaStream_t>(stream));
}
