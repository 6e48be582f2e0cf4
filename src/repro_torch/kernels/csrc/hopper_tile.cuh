// Hopper (sm_90a) building blocks of the TMA-fed kernels (matmul.cu's
// wgmma tile for f16 inputs and its FFMA tile for f32 inputs,
// flash_attention.cu's bf16 flash attention, grouped_matmul.cu's expert
// products): TMA tensor maps built on the
// host, mbarrier waits with phase bits, wgmma descriptors for
// 128-byte-swizzled tiles, the wgmma.mma_async instructions the two
// tensor-core kernels issue, all with an f32 accumulator, and the loads and
// stores of a matmul's C tile in f32 or f16.
//
// How the pieces agree.  A TMA box whose inner extent is 64 16-bit elements
// (128 bytes) lands in shared memory as rows of 128 bytes with the 128-byte
// swizzle (16-byte chunk c of row r stored at chunk c ^ (r % 8)); a tile of
// 64 such rows is 8 KB, and tiles start on 1024-byte boundaries so that the
// swizzle phase matches what a wgmma descriptor of layout type 1 (128B)
// assumes.  Each wgmma reads a k16 slice of such tiles through a descriptor:
//   K-major operand (the reduction dim contiguous: matmul's A, the queries,
//     the keys): 8-row groups 1024 bytes apart (SBO); the k16 slice s of a
//     128-byte row starts 32 * s bytes in; LBO is unused (16).
//   MN-major operand (the output dim contiguous: matmul's B, the values),
//     read through the descriptor's transpose bit, so nothing is transposed
//     in memory: 64-element column chunks one tile (8192 bytes) apart (LBO),
//     8-row groups along the reduction dim 1024 bytes apart (SBO); the k16
//     slice s starts 16 rows (2048 bytes) in.
// TMA fills out-of-bounds elements of a box with zeros and still counts the
// whole box toward the barrier's transaction bytes, so ragged edges need no
// bounds checks on loads.  Only TMA writes and wgmma reads these tiles (both
// in the async proxy), so no fence.proxy.async is needed between them; the
// mbarriers are made visible to TMA with fence.mbarrier_init.
//
// The accumulator of an m64nN wgmma gives thread t of the warpgroup (warp
// w = t / 32, lane l = t % 32) rows 16w + l/4 and 16w + l/4 + 8 and, in every
// 8-column group j, columns 8j + 2(l%4) and +1: d[4j], d[4j+1] on the first
// row, d[4j+2], d[4j+3] on the second.  The A fragment of a register-A
// wgmma (m64k16, 16-bit) holds the same rows and columns 2(l%4), +1, +8, +9
// of the k16 slice, so the accumulator's groups 2s and 2s+1, packed in
// pairs, are the A fragment of slice s (as in FlashAttention-3).

#pragma once

#include <cuda.h>            // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

// ---------------------------------------------------------------------------
// host: TMA tensor maps, encoded through the driver entry point that the
// runtime hands out (so the libraries need not link libcuda)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A map of a rank-`rank` tensor: dims innermost first, byte strides of dims
// 1.. (multiples of 16), a box of `box` elements, zero fill.  With the
// default 128-byte swizzle the box's inner extent is 128 bytes (64 16-bit
// or 32 f32 elements); with CU_TENSOR_MAP_SWIZZLE_NONE it may be any
// multiple of 16 bytes.  The base must be 16-byte aligned.  Returns
// cudaSuccess or cudaErrorInvalidValue.
inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank,
                            const void* base, const cuuint64_t* dims,
                            const cuuint64_t* byte_strides, const cuuint32_t* box,
                            CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, dtype, static_cast<cuuint32_t>(rank), const_cast<void*>(base),
                        dims, byte_strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Raise the kernel's dynamic shared memory limit, then launch.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (dynamic shared memory is
// requested with 1024 bytes to spare)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity` (a
// barrier starts in phase 0; waiting with parity 1 on a fresh barrier
// returns at once, which is how a producer passes its first round).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// device: a matmul's C tile, f32 or f16 in memory and f32 in registers (the
// accumulator is seeded from C as f32 and rounded once to C's type, as
// _matmul_acc_kernel's cin.astype(f32) and .astype(out_dtype) do).  `vec`
// moves a row's neighbours in one access (the host checked C's base and row
// stride for it); otherwise they move one by one, the first `n` of them.

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p, bool vec, int n) {
  if (vec) {
    if constexpr (sizeof(T) == 4) return *reinterpret_cast<const float2*>(p);
    else return __half22float2(*reinterpret_cast<const __half2*>(p));
  }
  return make_float2(n > 0 ? to_f32(p[0]) : 0.f, n > 1 ? to_f32(p[1]) : 0.f);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y, bool vec, int n) {
  if (vec) {
    if constexpr (sizeof(T) == 4) *reinterpret_cast<float2*>(p) = make_float2(x, y);
    else *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
    return;
  }
  if (n > 0) p[0] = from_f32<T>(x);
  if (n > 1) p[1] = from_f32<T>(y);
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, bool vec, int n, float (&v)[4]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      const __half2* h = reinterpret_cast<const __half2*>(&raw);
      const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < n ? to_f32(p[e]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4], bool vec, int n) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint2 raw;
      __half2* h = reinterpret_cast<__half2*>(&raw);
      h[0] = __floats2half2_rn(v[0], v[1]);
      h[1] = __floats2half2_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(p) = raw;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) p[e] = from_f32<T>(v[e]);
}

// ---------------------------------------------------------------------------
// device: warpgroup registers and wgmma ordering

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// before the first wgmma, and after ordinary instructions wrote its
// accumulator or A-fragment registers
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most kPending committed groups are still running
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}
// Tie the accumulator registers to this point: the compiler must not move
// a read of them above a wgmma_wait (the wgmma asm names them as outputs,
// so without this it could read them before the asynchronous product lands).
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma descriptor of a 128-byte-swizzled operand tile at p (see the top
// of this file for lbo and sbo), in bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// ---------------------------------------------------------------------------
// wgmma.mma_async m64nNk16, f32 accumulator (d += a . b).  mma_*: A and B
// from shared memory (A K-major); mma_rs_*: A from registers (the fragment
// above).  kTransB = 1 reads B MN-major.

template <int kTransB>
__device__ __forceinline__ void mma_f16_n256(float (&d)[128], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void mma_bf16_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void mma_rs_bf16_n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void mma_rs_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(kTransB));
}

}  // namespace hopper
