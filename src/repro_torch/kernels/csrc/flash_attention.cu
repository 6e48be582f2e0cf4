// Flash attention (online softmax) for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:84
// (flash_attention_pallas, body _fa_kernel): grouped-query attention (query
// head h reads kv head h / (Hq / Hkv)), causal and sliding-window masks,
// queries aligned to the END of the keys (query row i sits at key position
// i + Lk - Lq), f32 scores, softmax statistics and P.V, output in q's dtype.
//
//   q    (B, Hq,  Lq, D)   bf16 or f32   element strides (batch, head, position)
//   k/v  (B, Hkv, Lk, D)   bf16 or f32   element strides, last dim contiguous
//   out  (B, Hq,  Lq, D)   q's dtype     element strides
//
// repro_flash_attention_wgmma -- bf16 q, k and v with D = 64 or 128, on the
//   tensor cores (the kernel in namespace tc below);
// repro_flash_attention       -- every other (q, k/v) pair: f32/f32, f32/bf16
//   (IEEE f32 on the CUDA cores: no TF32), and bf16 with other head sizes.
//
// A query row that sees no key writes 0, decided per row in both: masked
// scores are -inf, a row whose running max is still -inf contributes
// nothing, and its denominator stays 0.  (The Pallas kernel fills with
// -1e30 and so gives 0 only when the whole query tile is masked; a masked
// row inside a live tile comes out as a uniform average of V there.)
//
// Bound: the work is 4 * D operations per visible (query, key) pair (Q.K^T
// and P.V) over every head; the bytes are q, k, v and out once.  At the
// serving path's prefill (Lq = Lk = 512, 24 / 8 heads, D 128, bf16) the 8.4
// MB take 2.5 us at 3.35 TB/s against 1.6 us of tensor-core work: bound by
// bytes, and in practice by latency (a few kv tiles per block).  At long L
// (8192) the 412 GFLOP dominate: bound by operations.
//
// The tensor-core kernel.  One block per (64-row query tile, q head,
// batch): a consumer warpgroup that owns the 64 rows (the m64 of wgmma) and
// a producer warp.  One producer thread loads the query tile once and
// streams the visible 64-key K and V tiles through a 2-stage TMA ring
// (4-D tensor maps over (D, L, H, B) with the caller's element strides, so
// the model's transposed views and cache slices are read in place; TMA's
// zero fill pads ragged Lq and Lk).  Per kv tile the warpgroup computes
// S = Q.K^T with wgmma m64n64k16 (Q and K from shared memory, both
// K-major) into f32 registers, scales the f32 scores (the scale is folded
// with log2(e) into the exp2 argument, never into a bf16 q), masks the
// causal, window and ragged edges, and updates the f32 running max and sum
// of its two rows per thread.  P.V keeps the reference's f32 arithmetic: P
// is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), and two register-A
// wgmma m64nDk16 per 16 keys add P_hi.V and P_lo.V into the same f32 O
// accumulator (V from shared memory, MN-major through the transpose bit).
// The split leaves P with an error of about 2^-16 of itself against 2^-8
// for a single bf16 P; the row sum comes from the f32 P.  The accumulator
// of S maps onto the A fragment of P.V register for register (see
// hopper_tile.cuh).  Blocks take the query tiles longest-first; two blocks
// (80 KB of shared memory each at D = 128) share an SM, so one's softmax
// overlaps the other's products.  Per tile, S and P.V each wait for their
// own wgmma group: no intra-warpgroup overlap yet.
//
// The CUDA-core kernel (simple and right first).  One thread block per
// (query tile of 64 rows, q head, batch) walks the kv tiles its rows can
// see, in a loop that takes the place of the TPU grid's sequential kv axis;
// tiles wholly past the causal edge or before the window are never visited.
// The block stages the tile's scaled queries (once), keys and values in
// shared memory as f32 (transposed, so every inner-loop read is a 16-byte
// vector), and each of its 256 threads computes a 4 x 4 block of the 64 x 64
// score tile, masks it, folds it into the running max and sum of its 4 rows
// (16 lanes share a row: shuffle reductions), and accumulates P.V for its 4
// rows and D/16 columns in registers.  Ragged Lq / Lk edges are masked in
// the tile.  It runs in IEEE f32 on the CUDA cores, so the f32 model path
// keeps its 1e-5 agreement.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "hopper_tile.cuh"

namespace {

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBKV = 64;                 // keys per kv tile
constexpr int kThreads = 256;            // 16 x 16 threads, 4 x 4 scores each
constexpr int kLdp = kBKV + 4;           // padded row of the probability tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int hq, hkv, lq, lk, hd;
  int causal;
  int window;                            // <= 0: no sliding window
  float scale;
};

// eight consecutive elements (16-byte aligned) widened to f32
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reductions over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DMAX>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(DMAX) * kBQ + static_cast<size_t>(DMAX) * kBKV +
                          static_cast<size_t>(kBKV) * DMAX + static_cast<size_t>(kBQ) * kLdp);
}

template <typename TQ, typename TKV, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Params p) {
  constexpr int kCols = DMAX / 64;       // float4 column groups of P.V per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                      // DMAX x kBQ    scaled queries, transposed
  float* kt = qt + DMAX * kBQ;           // DMAX x kBKV   keys, transposed
  float* vs = kt + DMAX * kBKV;          // kBKV x DMAX   values
  float* ps = vs + kBKV * DMAX;          // kBQ x kLdp    probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;               // score columns tx*4 .. tx*4+3
  const int ty = tid >> 4;               // rows ty*4 .. ty*4+3
  const int r0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const TQ* q = static_cast<const TQ*>(p.q) + b * p.q_sb + h * p.q_sh;
  const TKV* k = static_cast<const TKV*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const TKV* v = static_cast<const TKV*>(p.v) + b * p.v_sb + hk * p.v_sh;
  TQ* o = static_cast<TQ*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int rows = min(kBQ, p.lq - r0);
  const int off = p.lk - p.lq;           // key position of query row 0
  const int nch = p.hd / 8;

  // queries scaled in f32 (the Pallas kernel's q.astype(f32) * scale)
  for (int i = tid; i < kBQ * nch; i += kThreads) {
    const int r = i % kBQ, c = i / kBQ;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < rows) load8(q + (r0 + r) * p.q_sl + c * 8, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) qt[(c * 8 + e) * kBQ + r] = x[e] * p.scale;
  }

  // the keys this tile's rows can see: [k_begin, k_end)
  const int qpos_lo = r0 + off, qpos_hi = r0 + rows - 1 + off;
  int k_begin = 0, k_end = p.lk;
  if (p.causal) k_end = min(k_end, qpos_hi + 1);
  if (p.window > 0) k_begin = max(0, qpos_lo - p.window + 1);
  const int t_begin = k_begin / kBKV;
  const int t_end = k_end > k_begin ? (k_end + kBKV - 1) / kBKV : t_begin;

  float m[4], l[4], acc[4][kCols][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int kb = t * kBKV;
    const int nk = min(kBKV, p.lk - kb);
    __syncthreads();                     // the previous tile's reads are done
    for (int i = tid; i < kBKV * nch; i += kThreads) {
      const int j = i % kBKV, c = i / kBKV;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < nk) load8(k + (kb + j) * p.k_sl + c * 8, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) kt[(c * 8 + e) * kBKV + j] = x[e];
    }
    for (int i = tid; i < kBKV * nch; i += kThreads) {
      const int c = i % nch, j = i / nch;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < nk) load8(v + (kb + j) * p.v_sl + c * 8, x);
      float4* dst = reinterpret_cast<float4*>(vs + j * DMAX + c * 8);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();

    // S = (q * scale) . k^T for this thread's 4 x 4 scores
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < p.hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kBQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kBKV + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, then fold the tile into each row's running max and sum
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = r0 + ty * 4 + i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kb + tx * 4 + j;
        bool ok = tx * 4 + j < nk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // no key seen yet
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        sum += s[i][j];
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kLdp + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc += P . V (keys past nk have probability 0 and are skipped)
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kLdp + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 w = *reinterpret_cast<const float4*>(vs + j * DMAX + c * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c][0] = fmaf(pv[i], w.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(pv[i], w.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(pv[i], w.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(pv[i], w.w, acc[i][c][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    TQ* dst = o + (r0 + r) * p.o_sl;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 64 + tx * 4 + e;
        if (col < p.hd) dst[col] = from_f32<TQ>(l[i] == 0.f ? 0.f : acc[i][c][e] / l[i]);
      }
  }
}

template <typename TQ, typename TKV, int DMAX>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  static_assert(smem <= 227 * 1024, "tile does not fit the shared memory of a block");
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<TQ, TKV, DMAX>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.lq + kBQ - 1) / kBQ, p.hq, b);
  flash_attention_kernel<TQ, TKV, DMAX><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(const Params& p, int b, cudaStream_t s) {
  if (p.hd <= 64) return launch<TQ, TKV, 64>(p, b, s);
  if (p.hd <= 128) return launch<TQ, TKV, 128>(p, b, s);
  return launch<TQ, TKV, 256>(p, b, s);
}

// ---------------------------------------------------------------------------
// The tensor-core kernel: bf16 q, k and v, D = 64 or 128.
namespace tc {

constexpr int kBQ = 64, kBKV = 64, kStages = 2;
constexpr int kThreads = 160;            // one consumer warpgroup + one producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes() {          // q, then kStages x (k, v); barriers:
                                         // 42,024 B at D = 64, 82,984 B at 128
  return 1024 + static_cast<size_t>(1 + 2 * kStages) * kBQ * D * sizeof(__nv_bfloat16) +
         (1 + 2 * kStages) * sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t dv) {
  if constexpr (D == 128) {
    hopper::mma_rs_bf16_n128<1>(o, a, dv);
  } else {
    hopper::mma_rs_bf16_n64<1>(o, a, dv);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const Params p) {
  constexpr int kTile = kBQ * D;         // elements of a q, k or v tile
  constexpr int kChunk = 64 * 64;        // elements of one 64 x 64 TMA box
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(hopper::align_1024(smem_raw));
  __nv_bfloat16* sk = sq + kTile;
  __nv_bfloat16* sv = sk + kStages * kTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + kStages * kTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // the longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int rows = min(kBQ, p.lq - r0);
  const int off = p.lk - p.lq;           // key position of query row 0

  // the keys this tile's rows can see: [k_begin, k_end)
  const int qpos_lo = r0 + off, qpos_hi = r0 + rows - 1 + off;
  int k_begin = 0, k_end = p.lk;
  if (p.causal) k_end = min(k_end, qpos_hi + 1);
  if (p.window > 0) k_begin = max(0, qpos_lo - p.window + 1);
  const int t_begin = k_begin / kBKV;
  const int t_end = k_end > k_begin ? (k_end + kBKV - 1) / kBKV : t_begin;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 1);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {              // producer warp: one thread issues every load
    if (threadIdx.x == 128 && t_end > t_begin) {
      hopper::mbar_expect_tx(q_full, kTile * sizeof(__nv_bfloat16));
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_load_4d(sq + c * kChunk, &map_q, c * 64, r0, h, b, q_full);
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin, s = i % kStages;
        hopper::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * kTile * sizeof(__nv_bfloat16));
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_4d(sk + s * kTile + c * kChunk, &map_k, c * 64, t * kBKV, hk, b,
                              &full[s]);
          hopper::tma_load_4d(sv + s * kTile + c * kChunk, &map_v, c * 64, t * kBKV, hk, b,
                              &full[s]);
        }
      }
    }
    return;
  }

  // consumer warpgroup: this thread's rows rq, rq + 8 of the tile, and
  // columns cq, cq + 1 of every 8-column group
  const int tid = threadIdx.x;
  const int rq = (tid / 32) * 16 + (tid % 32) / 4;
  const int cq = 2 * (tid % 4);
  const float scale2 = p.scale * kLog2e;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (t_end > t_begin) hopper::mbar_wait(q_full, 0);

  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin, s = i % kStages;
    hopper::mbar_wait(&full[s], (i / kStages) & 1);
    const __nv_bfloat16* kt = sk + s * kTile;
    const __nv_bfloat16* vt = sv + s * kTile;

    // S = Q . K^T (64 x 64, f32)
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int e = (kk / 4) * kChunk + (kk % 4) * 16;
      hopper::mma_bf16_n64<0>(sc, hopper::desc_sw128(sq + e, 16, 1024),
                              hopper::desc_sw128(kt + e, 16, 1024));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // scale in f32 (log2 domain), mask the edges, fold into the running max
    const int kb = t * kBKV;
    const bool edge = (p.causal && kb + kBKV - 1 > qpos_lo) ||
                      (p.window > 0 && r0 + kBQ - 1 + off - kb >= p.window) ||
                      kb + kBKV > p.lk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float x = sc[j] * scale2;
      if (edge) {
        const int qpos = r0 + rq + 8 * ((j >> 1) & 1) + off;
        const int kpos = kb + 8 * (j >> 2) + cq + (j & 1);
        bool ok = kpos < p.lk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
        x = ok ? x : -INFINITY;
      }
      sc[j] = x;
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
    }
    float m_use[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;   // no key seen yet
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      sc[j] = exp2f(sc[j] - m_use[(j >> 1) & 1]);
      sum[(j >> 1) & 1] += sc[j];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];   // this thread's columns
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

    // P = P_hi + P_lo in bf16, packed as the A fragments of 4 k16 slices
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x0 = sc[8 * kk + 2 * q], x1 = sc[8 * kk + 2 * q + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[kk][q] = pack_bf16(hi);
        p_lo[kk][q] = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
      }
    }

    // O += P_hi . V + P_lo . V
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = hopper::desc_sw128(vt + kk * 16 * 64, kChunk * sizeof(__nv_bfloat16),
                                             1024);
      mma_pv<D>(o, p_hi[kk], dv);
      mma_pv<D>(o, p_lo[kk], dv);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (tid == 0) hopper::mbar_arrive(&empty[s]);  // k and v of stage s are read
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rq + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* dst = out + (r0 + row) * p.o_sl + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * l[r], o[4 * j + 2 * r + 1] * l[r]);
  }
}

// The 4-D map (D, L, H, B) of a q, k or v view with element strides
// (batch, head, position), box 64 x 64 x 1 x 1.  A dim of size 1 gets a
// padded stride (TMA wants a multiple of 16 bytes, and never steps it).
inline cudaError_t make_map(CUtensorMap* map, const void* base, int d, int len, int heads,
                            int batch, long long sb, long long sh, long long sl) {
  const long long pad = static_cast<long long>(d);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>((len == 1 ? pad : sl) * 2),
                                 static_cast<cuuint64_t>((heads == 1 ? pad : sh) * 2),
                                 static_cast<cuuint64_t>((batch == 1 ? pad : sb) * 2)};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
}

template <int D>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, p.q, D, p.lq, p.hq, b, p.q_sb, p.q_sh, p.q_sl);
  if (err == cudaSuccess) err = make_map(&mk, p.k, D, p.lk, p.hkv, b, p.k_sb, p.k_sh, p.k_sl);
  if (err == cudaSuccess) err = make_map(&mv, p.v, D, p.lk, p.hkv, b, p.v_sb, p.v_sh, p.v_sl);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.lq + kBQ - 1) / kBQ, p.hq, b);
  return hopper::launch(flash_kernel<D>, grid, kThreads, smem_bytes<D>(), stream, mq, mk, mv, p);
}

}  // namespace tc

Params make_params(const void* q, const void* k, const void* v, void* out,
                   const long long* strides, int hq, int hkv, int lq, int lk, int hd,
                   int causal, int window, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = out;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_sl = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_sl = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_sl = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_sl = strides[11];
  p.hq = hq; p.hkv = hkv; p.lq = lq; p.lk = lk; p.hd = hd;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// dtype codes: 0 = bfloat16, 1 = float32; (q, k/v) are bf16/bf16, f32/f32 or
// f32/bf16.  strides: 12 element strides, (batch, head, position) of q, k,
// v and out in that order; every one and every base address must keep
// 16-byte alignment of an 8-element chunk.  hd is a multiple of 8, at most
// 256.  window <= 0 means none.  Returns a cudaError_t (0 = ok).
int repro_flash_attention(int q_dtype, int kv_dtype, const void* q, const void* k,
                          const void* v, void* out, const long long* strides, int b, int hq,
                          int hkv, int lq, int lk, int hd, int causal, int window, float scale,
                          void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || lq < 1 || lk < 1 || hd < 8 ||
      hd > 256 || hd % 8 != 0 || hq > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, out, strides, hq, hkv, lq, lk, hd, causal, window,
                               scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch_d<__nv_bfloat16, __nv_bfloat16>(p, b, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = launch_d<float, float>(p, b, s);
  else if (q_dtype == 1 && kv_dtype == 0)
    err = launch_d<float, __nv_bfloat16>(p, b, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

// bf16 q, k, v and out, hd 64 or 128, on the tensor cores; the arguments as
// above (the same alignment: TMA wants 16-byte bases and strides).
int repro_flash_attention_wgmma(const void* q, const void* k, const void* v, void* out,
                                const long long* strides, int b, int hq, int hkv, int lq,
                                int lk, int hd, int causal, int window, float scale,
                                void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || lq < 1 || lk < 1 ||
      (hd != 64 && hd != 128) || hq > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, out, strides, hq, hkv, lq, lk, hd, causal, window,
                               scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(hd == 128 ? tc::launch<128>(p, b, s) : tc::launch<64>(p, b, s));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
