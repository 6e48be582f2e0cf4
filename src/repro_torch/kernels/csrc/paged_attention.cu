// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention_pallas, body _paged_attn_kernel): one query token per
// request attends to a KV cache scattered over fixed-size pages of a shared
// arena, named by the request's block table.
//
//   q            (B, Hkv, rep, hd)      bf16 or f32, contiguous
//   k/v pages    (N, block, Hkv, hd)    bf16 or f32, contiguous
//   block_tables (B, P) int32           -1 = unallocated entry
//   lengths      (B,)   int32           valid tokens per request
//   out          (B, Hkv, rep, hd)      q's dtype
//
// Semantics are the Pallas kernel's: q is scaled in f32, scores, softmax
// statistics and the P.V accumulation are f32; pages at or past the length
// and dead (-1) entries are skipped whole, the partial last page is masked
// per position, and a row with no live page writes 0.  An entry >= N is
// treated as dead, so a bad table never reads outside the arena.
//
// Bound: the kernel must read every live K and V page once.  For B requests
// of L live tokens that is 2 * B * L * Hkv * hd * sizeof(kv) bytes, at the
// card's 3.35 TB/s; the arithmetic (4 * B * Hkv * rep * L * hd operations)
// is far below the tensor-core rate, so decode attention is bound by bytes.
//
// Design (simple and right first): one thread block per (request, kv-head).
// The block loads its own table row and length (scalar prefetch has no
// counterpart here) and walks the live pages only, so the TPU grid's
// sequential page axis becomes a loop inside the block.  Each live page's K
// and V rows for the block's head are copied into shared memory with 16-byte
// cp.async copies, double-buffered: the next live page is in flight while
// the current one is scored, so a page costs its arithmetic, not a
// device-memory round trip.  Per page, each warp scores a quarter of the
// valid tokens against the block's rep query heads (lanes split hd,
// warp-shuffle reduction), one warp per query head folds the page into the
// online-softmax statistics, and every thread accumulates P.V in f32 for
// the head dims it owns.  The grid is B * Hkv blocks, which leaves most SMs
// idle at small batch; split-K over pages (flash-decoding), wgmma and TMA
// are left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDimsPerThread = 2;      // hd <= 256
// query heads per kv head (GQA group) are a template parameter: a runtime
// count would leave the per-head accumulators to dynamic indexing, which
// moves them to local memory (measured 4x slower per page on the H100)
constexpr float kNegInf = -1e30f;         // the Pallas kernel's initial max

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory bytes of one block: f32 queries, scores and statistics,
// then two (K, V) page buffers in the arena's dtype, 16-byte aligned.
__host__ __device__ inline size_t stats_bytes(int rep, int hd, int blk) {
  const size_t b = sizeof(float) * (static_cast<size_t>(rep) * hd +
                                    static_cast<size_t>(rep) * blk + 3 * rep);
  return (b + 15) / 16 * 16;
}
template <typename TKV>
__host__ __device__ inline size_t smem_bytes(int rep, int hd, int blk) {
  return stats_bytes(rep, hd, blk) + 4 * static_cast<size_t>(blk) * hd * sizeof(TKV);
}

// Copy the first n_valid token rows of one page (this block's head) into
// shared memory: each row is hd contiguous elements, cut in 16-byte pieces.
template <typename TKV>
__device__ __forceinline__ void load_page(TKV* k_dst, TKV* v_dst, const TKV* k_src,
                                          const TKV* v_src, int n_valid, int hd,
                                          long long tok_stride) {
  constexpr int kVec = 16 / sizeof(TKV);
  const int per_row = hd / kVec;
  const int n = n_valid * per_row;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int t = i / per_row;
    const int c = (i - t * per_row) * kVec;
    cp_async_16(k_dst + t * hd + c, k_src + t * tok_stride + c);
    cp_async_16(v_dst + t * hd + c, v_src + t * tok_stride + c);
  }
}

template <typename TQ, typename TKV, int REP>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                       const TKV* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, TQ* __restrict__ out,
                       int hkv, int hd, int n_blocks, int blk, int pages,
                       float scale) {
  constexpr int rep = REP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // rep * hd  scaled f32 queries
  float* p_s = q_s + rep * hd;         // rep * blk  scores, then probabilities
  float* alpha_s = p_s + rep * blk;    // rep        rescale of this page
  float* l_s = alpha_s + rep;          // rep        running denominators
  float* m_s = l_s + rep;              // rep        running maxima
  TKV* tiles = reinterpret_cast<TKV*>(smem_raw + stats_bytes(rep, hd, blk));
  const int tile = blk * hd;           // K0 V0 K1 V1, one (K, V) pair per buffer

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = lengths[b];
  const int* table = block_tables + static_cast<long long>(b) * pages;
  const long long tok_stride = static_cast<long long>(hkv) * hd;
  const long long page_stride = static_cast<long long>(blk) * tok_stride;

  // the next live page at or after p; pages at or past the length end the
  // walk, dead (-1) entries and entries outside the arena are skipped whole
  auto next_live = [&](int p) {
    for (; p < pages && p * blk < length; ++p) {
      const int e = table[p];
      if (e >= 0 && e < n_blocks) return p;
    }
    return -1;
  };
  auto issue = [&](int p, int buf) {
    const long long off = table[p] * page_stride + static_cast<long long>(h) * hd;
    load_page(tiles + (2 * buf) * tile, tiles + (2 * buf + 1) * tile, k_pages + off,
              v_pages + off, min(blk, length - p * blk), hd, tok_stride);
  };

  int cur = next_live(0);
  if (cur >= 0) issue(cur, 0);
  cp_async_commit();

  const long long head_off = (static_cast<long long>(b) * hkv + h) * rep * hd;
  for (int i = tid; i < rep * hd; i += kThreads) q_s[i] = to_f32(q[head_off + i]) * scale;
  if (tid < rep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[REP][kMaxDimsPerThread];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int j = 0; j < kMaxDimsPerThread; ++j) acc[r][j] = 0.f;

  // block-uniform control flow: cur, nxt and n_valid are the same for every
  // thread, so every thread reaches every barrier
  int buf = 0;
  while (cur >= 0) {
    const int nxt = next_live(cur + 1);
    if (nxt >= 0) issue(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                // this thread's copies of `cur` landed
    __syncthreads();                   // ... and every thread's

    const TKV* ks = tiles + (2 * buf) * tile;
    const TKV* vs = tiles + (2 * buf + 1) * tile;
    const int n_valid = min(blk, length - cur * blk);   // partial last page

    // scores s[r][t] = q_r . k_t
    for (int t = warp; t < n_valid; t += kWarps) {
      float part[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) part[r] = 0.f;
      for (int d = lane; d < hd; d += 32) {
        const float kd = to_f32(ks[t * hd + d]);
#pragma unroll
        for (int r = 0; r < REP; ++r) part[r] += q_s[r * hd + d] * kd;
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float s = warp_sum(part[r]);
        if (lane == 0) p_s[r * blk + t] = s;
      }
    }
    __syncthreads();

    // online softmax, one warp per query head: fold this page into (m, l)
    // and turn its scores into probabilities
    for (int r = warp; r < rep; r += kWarps) {
      float* row = p_s + r * blk;
      float m_cur = kNegInf;
      for (int t = lane; t < n_valid; t += 32) m_cur = fmaxf(m_cur, row[t]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(m_cur));
      float sum = 0.f;
      for (int t = lane; t < n_valid; t += 32) {
        const float p = expf(row[t] - m_new);
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r][d] = alpha_r * acc[r][d] + sum_t p[r][t] * v[t][d]
#pragma unroll
    for (int j = 0; j < kMaxDimsPerThread; ++j) {
      const int d = tid + j * kThreads;
      if (d < hd) {
#pragma unroll
        for (int r = 0; r < REP; ++r) acc[r][j] *= alpha_s[r];
        for (int t = 0; t < n_valid; ++t) {
          const float vd = to_f32(vs[t * hd + d]);
#pragma unroll
          for (int r = 0; r < REP; ++r) acc[r][j] += p_s[r * blk + t] * vd;
        }
      }
    }
    __syncthreads();                   // buffers and p_s are rewritten next
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();                     // l_s from the last page (or the init)

#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float l = l_s[r];
    const float safe = (l == 0.f) ? 1.f : l;         // no live page: output 0
#pragma unroll
    for (int j = 0; j < kMaxDimsPerThread; ++j) {
      const int d = tid + j * kThreads;
      if (d < hd) out[head_off + r * hd + d] = from_f32<TQ>(acc[r][j] / safe);
    }
  }
}

template <typename TQ, typename TKV, int REP>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* lengths, void* out, int b, int hkv, int hd, int n_blocks,
                   int blk, int pages, float scale, cudaStream_t stream) {
  if ((hd * sizeof(TKV)) % 16 != 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<TKV>(REP, hd, blk);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<TQ, TKV, REP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(b, hkv);
  paged_attention_kernel<TQ, TKV, REP><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      tables, lengths, static_cast<TQ*>(out), hkv, hd, n_blocks, blk, pages, scale);
  return cudaGetLastError();
}

// the GQA group sizes of the repository's archs (Hq / Hkv)
template <typename TQ, typename TKV>
cudaError_t launch_rep(int rep, const void* q, const void* k, const void* v,
                       const int* tables, const int* lengths, void* out, int b, int hkv,
                       int hd, int n_blocks, int blk, int pages, float scale,
                       cudaStream_t s) {
#define REPRO_REP_CASE(R)                                                               \
  case R:                                                                               \
    return launch<TQ, TKV, R>(q, k, v, tables, lengths, out, b, hkv, hd, n_blocks, blk, \
                              pages, scale, s);
  switch (rep) {
    REPRO_REP_CASE(1)
    REPRO_REP_CASE(2)
    REPRO_REP_CASE(3)
    REPRO_REP_CASE(4)
    REPRO_REP_CASE(6)
    REPRO_REP_CASE(8)
    REPRO_REP_CASE(12)
    REPRO_REP_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_REP_CASE
}

}  // namespace

extern "C" {

// dtype codes: 0 = bfloat16, 1 = float32; q and the arenas are bf16/bf16,
// f32/f32 or f32/bf16 (an f32 model over the bf16 cache).  rep is one of
// 1, 2, 3, 4, 6, 8, 12, 16.  Returns a cudaError_t (0 = ok).
int repro_paged_attention(int q_dtype, int kv_dtype, const void* q, const void* k,
                          const void* v, const int* block_tables, const int* lengths,
                          void* out, int b, int hkv, int rep, int hd, int n_blocks,
                          int blk, int pages, float scale, void* stream) {
  if (b < 1 || hkv < 1 || hd < 1 || hd > kThreads * kMaxDimsPerThread || n_blocks < 1 ||
      blk < 1 || pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch_rep<__nv_bfloat16, __nv_bfloat16>(rep, q, k, v, block_tables, lengths, out,
                                                   b, hkv, hd, n_blocks, blk, pages, scale, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = launch_rep<float, float>(rep, q, k, v, block_tables, lengths, out, b, hkv, hd,
                                   n_blocks, blk, pages, scale, s);
  else if (q_dtype == 1 && kv_dtype == 0)
    err = launch_rep<float, __nv_bfloat16>(rep, q, k, v, block_tables, lengths, out, b, hkv,
                                           hd, n_blocks, blk, pages, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
