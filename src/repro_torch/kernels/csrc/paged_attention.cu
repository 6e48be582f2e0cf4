// Paged decode attention for Hopper (sm_90a): split-KV over all SMs.
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
// of L live tokens that is 2 * B * L * Hkv * hd * sizeof(kv) bytes at the
// card's 3.35 TB/s; the arithmetic (4 * B * Hkv * rep * L * hd operations)
// is far below the CUDA cores' rate, so decode attention is bound by bytes
// and by latency.  No tensor cores: a kv head has rep (3 for Llama-3.2-3B)
// query rows, and wgmma's smallest M is 64.
//
// Design: split-KV (flash-decoding).  The grid is (B, Hkv, S): block
// (b, h, s) takes pages [s * pps, (s + 1) * pps) of row b's table, so even
// a batch of 4 fills the 132 SMs (S and pps are chosen on the host from B,
// Hkv, P and the SM count only; lengths are never read back).  Inside a
// block each warp works alone, with no block barrier in its loop: it takes
// every 4th chunk of the split (a chunk is ct tokens of one page, 2 KB of
// K rows and as much of V; a dead page or one past the length is skipped
// whole), keeps a 3-stage ring of its chunks in flight with 16-byte
// cp.async copies (rows past the length are zero-filled, not copied), and
// scores them with lanes in groups of 16 (32 when hd > 128): each lane holds 8
// elements of the token row, for all rep heads at once, reading 16 bytes of
// K from shared memory and summing over its group with shuffles.  Scores
// are kept in the log2 domain (q is scaled by scale * log2 e in f32), so
// every exponential is one exp2.  Each lane group keeps its own
// online-softmax state (one rescale per chunk); groups, then warps, then
// splits are merged by the same rule: m = max m_i, l = sum 2^(m_i - m) l_i,
// acc = sum 2^(m_i - m) acc_i.  With S > 1 each block writes its partial
// (m, l, acc) in f32 to a workspace and paged_attention_combine, a second
// launch on the same stream, folds the splits of each (b, h) and divides by
// l.  An empty split has m = -1e30 and l = acc = 0, so it weighs
// 2^(-1e30 - m) = 0 beside a live split and 1 among empty ones; a row whose
// splits are all empty has l = 0 and writes exactly 0.  With S = 1 the
// block writes the output itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;                // chunks in flight per warp
constexpr int kLaneElems = 8;             // one lane's slice of a token row
constexpr int kMaxHd = 256;               // 32 lanes x 8 elements
constexpr float kNegInf = -1e30f;         // the Pallas kernel's initial max
constexpr float kLog2e = 1.4426950408889634f;
// query heads per kv head (GQA group) are a template parameter: a runtime
// count would leave the per-head accumulators to dynamic indexing, which
// moves them to local memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the elements of one 16-byte vector, widened to f32
__device__ __forceinline__ void widen16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Lanes per token: 16 up to hd 128, 32 up to 256 (a lane past hd holds
// zeros of q and its products add nothing).
__host__ __device__ inline int lanes_per_token(int hd) { return hd <= 128 ? 16 : 32; }
// Tokens per chunk: 32 / g tokens a step, 8 / sizeof(kv) steps (2 KB of K
// rows at hd 128 or 256).
__host__ __device__ inline int chunk_tokens(int hd, int kv_bytes) {
  return 32 / lanes_per_token(hd) * (8 / kv_bytes);
}

// Dynamic shared memory of a split block: the split's table entries, the
// four warps' rings of (K, V) chunks, and the warps' merged states (m, l,
// acc) for the block's merge.
__host__ __device__ inline size_t table_bytes(int pps) {
  return (static_cast<size_t>(pps) * sizeof(int) + 15) / 16 * 16;
}
__host__ __device__ inline size_t ring_bytes(int hd, int kv_bytes) {
  return static_cast<size_t>(kWarps) * kStages * 2 * chunk_tokens(hd, kv_bytes) * hd * kv_bytes;
}
__host__ __device__ inline size_t smem_bytes(int rep, int hd, int kv_bytes, int pps) {
  return table_bytes(pps) + ring_bytes(hd, kv_bytes) +
         sizeof(float) * kWarps * static_cast<size_t>(rep) * (hd + 2);
}

// kG: the lanes of a token (lanes_per_token), a compile-time constant so
// that the group sums are straight-line shuffles: a shuffle under a branch
// makes the compiler check the warp for divergence at each one, which cuts
// the loop into blocks it cannot schedule across.
template <typename TQ, typename TKV, int REP, int kG>
__global__ void __launch_bounds__(kThreads, REP <= 4 ? 4 : 1)
paged_attention_split(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                      const TKV* __restrict__ v_pages, const int* __restrict__ block_tables,
                      const int* __restrict__ lengths, TQ* __restrict__ out,
                      float* __restrict__ ws, int hkv, int hd, int n_blocks, int blk,
                      int pages, int pps, float qscale) {
  constexpr int kVec = 16 / sizeof(TKV);           // elements of a 16-byte vector
  constexpr int kVecs = kLaneElems / kVec;         // vectors a lane holds (1 or 2)
  constexpr int kSteps = 8 / sizeof(TKV);          // tokens a lane group takes per chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z, n_splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int g = kG;
  constexpr int tpw = 32 / g;                      // tokens a warp scores at once
  constexpr int ct = tpw * kSteps;                 // tokens per chunk
  const int grp = lane / g, sub = lane % g;
  const int row_vecs = hd / kVec;
  const int chunk_elems = ct * hd;

  // this split's pages [p0, p0 + np), each cut into nsub chunks of ct tokens
  const int p0 = s * pps;
  const int np = min(pps, pages - p0);
  const int length = lengths[b];
  const int nsub = (blk + ct - 1) / ct;

  int* tbl = reinterpret_cast<int*>(smem_raw);
  TKV* ring = reinterpret_cast<TKV*>(smem_raw + table_bytes(pps));
  float* st = reinterpret_cast<float*>(smem_raw + table_bytes(pps) +
                                       ring_bytes(hd, sizeof(TKV)));
  float* st_m = st;                                // [warp][r]
  float* st_l = st_m + kWarps * REP;               // [warp][r]
  float* st_acc = st_l + kWarps * REP;             // [warp][r][hd]

  // the split's table entries: -1 for a dead entry, one outside the arena,
  // or a page at or past the length
  for (int i = tid; i < np; i += kThreads) {
    const int e = block_tables[static_cast<long long>(b) * pages + p0 + i];
    tbl[i] = (e >= 0 && e < n_blocks && (p0 + i) * blk < length) ? e : -1;
  }
  // this lane's slice of the rep query rows, scaled in f32 by scale * log2(e)
  // (scores live in the log2 domain: exp2 of their differences is the softmax)
  const long long head_off = (static_cast<long long>(b) * hkv + h) * REP * hd;
  float qf[REP][kLaneElems];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int d = (sub + i * g) * kVec + e;
        qf[r][i * kVec + e] = d < hd ? to_f32(q[head_off + r * hd + d]) * qscale : 0.f;
      }
  __syncthreads();

  float m[REP], l[REP], acc[REP][kLaneElems];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) acc[r][e] = 0.f;
  }

  // warp w takes chunks w, w + 4, ... of the split; its i-th chunk sits in
  // ring slot i % 3.  Chunk c is tokens [o0, o0 + ct) of page c / nsub.
  const int n_chunks = np * nsub;
  const int my_chunks = n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps : 0;
  TKV* my_ring = ring + static_cast<size_t>(warp) * kStages * 2 * chunk_elems;
  const long long tok_stride = static_cast<long long>(hkv) * hd;
  // the arena block of this warp's i-th chunk and its count of valid
  // tokens, or a count <= 0 for a chunk to skip (dead, past the length)
  auto chunk_of = [&](int i, int& e, int& o0) {
    const int c = warp + i * kWarps;
    const int pi = c / nsub;
    o0 = (c - pi * nsub) * ct;
    e = tbl[pi];
    return e < 0 ? 0 : min(blk, length - (p0 + pi) * blk) - o0;
  };
  // Copy this warp's i-th chunk into its ring slot, zeros for the rows past
  // the valid ones, and commit one cp.async group (empty when skipped).
  auto issue = [&](int i) {
    int e, o0;
    if (i < my_chunks) {
      const int nv = chunk_of(i, e, o0);
      if (nv > 0) {
        TKV* ks = my_ring + (i % kStages) * 2 * chunk_elems;
        TKV* vs = ks + chunk_elems;
        const long long off = (static_cast<long long>(e) * blk + o0) * tok_stride +
                              static_cast<long long>(h) * hd;
        for (int it = lane; it < ct * row_vecs; it += 32) {
          const int j = it / row_vecs;
          const int c = (it - j * row_vecs) * kVec;
          if (j < nv) {
            cp_async_16(ks + j * hd + c, k_pages + off + j * tok_stride + c);
            cp_async_16(vs + j * hd + c, v_pages + off + j * tok_stride + c);
          } else {
            *reinterpret_cast<uint4*>(ks + j * hd + c) = make_uint4(0, 0, 0, 0);
            *reinterpret_cast<uint4*>(vs + j * hd + c) = make_uint4(0, 0, 0, 0);
          }
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < my_chunks; ++i) {
    issue(i + kStages - 1);
    int e, o0;
    const int nv = chunk_of(i, e, o0);
    cp_async_wait<kStages - 1>();                  // this lane's copies of chunk i landed
    __syncwarp();                                  // ... and every lane's
    if (nv > 0) {                                  // warp-uniform
      const TKV* ks = my_ring + (i % kStages) * 2 * chunk_elems;
      const TKV* vs = ks + chunk_elems;
      // scores of this group's kSteps tokens for all rep heads; a row past
      // the valid ones is zeros, masked here
      float sc[REP][kSteps];
      float m_chunk[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) m_chunk[r] = kNegInf;
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        const int j = grp + t * tpw;
        float part[REP];
#pragma unroll
        for (int r = 0; r < REP; ++r) part[r] = 0.f;
#pragma unroll
        for (int vi = 0; vi < kVecs; ++vi) {
          // a lane past hd reads the row's start: finite, and its q is 0
          const int d0 = (sub + vi * g) * kVec;
          float kv[kVec];
          widen16(ks + j * hd + (d0 < hd ? d0 : 0), kv);
#pragma unroll
          for (int x = 0; x < kVec; ++x)
#pragma unroll
            for (int r = 0; r < REP; ++r) part[r] = fmaf(qf[r][vi * kVec + x], kv[x], part[r]);
        }
#pragma unroll
        for (int r = 0; r < REP; ++r) {
#pragma unroll
          for (int o = g / 2; o > 0; o >>= 1)    // sum over the g lanes of the token
            part[r] += __shfl_xor_sync(0xffffffffu, part[r], o);
          sc[r][t] = j < nv ? part[r] : kNegInf;
          m_chunk[r] = fmaxf(m_chunk[r], sc[r][t]);
        }
      }
      // one rescale per chunk, then P.V (masked tokens: p = 0 over zero rows)
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float m_new = fmaxf(m[r], m_chunk[r]);
        const float alpha = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int x = 0; x < kLaneElems; ++x) acc[r][x] *= alpha;
      }
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        const int j = grp + t * tpw;
        float p[REP];
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          p[r] = j < nv ? exp2f(sc[r][t] - m[r]) : 0.f;   // 0, not exp2(0), in a
          l[r] += p[r];                                   // group with no live token yet
        }
#pragma unroll
        for (int vi = 0; vi < kVecs; ++vi) {
          const int d0 = (sub + vi * g) * kVec;     // past hd: never stored
          float vv[kVec];
          widen16(vs + j * hd + (d0 < hd ? d0 : 0), vv);
#pragma unroll
          for (int x = 0; x < kVec; ++x)
#pragma unroll
            for (int r = 0; r < REP; ++r)
              acc[r][vi * kVec + x] = fmaf(p[r], vv[x], acc[r][vi * kVec + x]);
        }
      }
    }
    __syncwarp();                                  // the slot is refilled next
  }
  cp_async_wait<0>();

  // merge the lane groups of the warp (lanes lane ^ o for o >= g share sub)
#pragma unroll
  for (int o = g; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float m_new = fmaxf(m[r], m_o);
      const float a = exp2f(m[r] - m_new), a_o = exp2f(m_o - m_new);
      m[r] = m_new;
      l[r] = l[r] * a + l_o * a_o;
#pragma unroll
      for (int x = 0; x < kLaneElems; ++x)
        acc[r][x] = acc[r][x] * a + __shfl_xor_sync(0xffffffffu, acc[r][x], o) * a_o;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (sub == 0) {
        st_m[warp * REP + r] = m[r];
        st_l[warp * REP + r] = l[r];
      }
#pragma unroll
      for (int vi = 0; vi < kVecs; ++vi)
#pragma unroll
        for (int x = 0; x < kVec; ++x) {
          const int d = (sub + vi * g) * kVec + x;
          if (d < hd) st_acc[(warp * REP + r) * hd + d] = acc[r][vi * kVec + x];
        }
    }
  }
  __syncthreads();

  // merge the warps: the block's (m, l, acc), written as the output (S = 1)
  // or as this split's partial
  const long long part_base = ((static_cast<long long>(b) * hkv + h) * n_splits + s) * REP;
  float* ws_acc = ws;
  float* ws_ml = ws + static_cast<long long>(gridDim.x) * hkv * n_splits * REP * hd;
  for (int idx = tid; idx < REP * hd; idx += kThreads) {
    const int r = idx / hd;
    float m_b = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_b = fmaxf(m_b, st_m[w * REP + r]);
    float l_b = 0.f, acc_b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = exp2f(st_m[w * REP + r] - m_b);
      l_b += a * st_l[w * REP + r];
      acc_b += a * st_acc[(w * REP + r) * hd + idx - r * hd];
    }
    if (n_splits == 1) {
      out[head_off + idx] = from_f32<TQ>(l_b == 0.f ? 0.f : acc_b / l_b);
    } else {
      ws_acc[part_base * hd + idx] = acc_b;
      if (idx - r * hd == 0) {
        ws_ml[(part_base + r) * 2] = m_b;
        ws_ml[(part_base + r) * 2 + 1] = l_b;
      }
    }
  }
}

// The splits of each (b, h): rescale by exp2(m_s - max m), sum, divide by
// the summed l (exactly 0 where every split is empty).  One thread an
// output (grid (B, Hkv, rep * hd / 128)); it folds the splits in one pass,
// so the loads of all splits are independent of each other and of the
// running state.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine(const float* __restrict__ ws, TQ* __restrict__ out, int hkv,
                        int rep, int hd, int n_splits) {
  const long long bh = static_cast<long long>(blockIdx.x) * hkv + blockIdx.y;
  const float* ws_acc = ws + bh * n_splits * rep * hd;
  const float* ws_ml = ws + static_cast<long long>(gridDim.x) * hkv * n_splits * rep * hd +
                       bh * n_splits * rep * 2;
  const int idx = blockIdx.z * kThreads + threadIdx.x;
  if (idx < rep * hd) {
    const int r = idx / hd, d = idx - r * hd;
    float m = kNegInf, l = 0.f, acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_splits; ++s) {
      const float m_s = ws_ml[(s * rep + r) * 2];
      const float l_s = ws_ml[(s * rep + r) * 2 + 1];
      const float acc_s = ws_acc[(s * rep + r) * hd + d];
      const float m_new = fmaxf(m, m_s);
      const float a = exp2f(m - m_new), a_s = exp2f(m_s - m_new);
      l = l * a + l_s * a_s;
      acc = acc * a + acc_s * a_s;
      m = m_new;
    }
    out[bh * rep * hd + idx] = from_f32<TQ>(l == 0.f ? 0.f : acc / l);
  }
}

template <typename TQ, typename TKV, int REP, int kG>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* lengths, void* out, void* ws, int b, int hkv, int hd,
                   int n_blocks, int blk, int pages, int pps, float scale,
                   cudaStream_t stream) {
  if ((hd * sizeof(TKV)) % 16 != 0) return cudaErrorInvalidValue;
  const int n_splits = (pages + pps - 1) / pps;
  if (n_splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(REP, hd, sizeof(TKV), pps);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(paged_attention_split<TQ, TKV, REP, kG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  paged_attention_split<TQ, TKV, REP, kG><<<dim3(b, hkv, n_splits), kThreads, smem,
                                             stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      tables, lengths, static_cast<TQ*>(out), static_cast<float*>(ws), hkv, hd, n_blocks,
      blk, pages, pps, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  paged_attention_combine<TQ><<<dim3(b, hkv, (REP * hd + kThreads - 1) / kThreads), kThreads,
                                0, stream>>>(
      static_cast<const float*>(ws), static_cast<TQ*>(out), hkv, REP, hd, n_splits);
  return cudaGetLastError();
}

// Built whole, the library holds every (q, arena) dtype pair, group and lane
// group; built with REPRO_PA_Q, REPRO_PA_KV (dtype codes), REPRO_PA_REP and
// REPRO_PA_G (lanes a token) defined, it holds that one instantiation and
// answers any other with cudaErrorNotSupported, so a caller that launches one
// shape compiles one kernel in place of 48.
template <typename T> constexpr int dtype_code();
template <> constexpr int dtype_code<__nv_bfloat16>() { return 0; }
template <> constexpr int dtype_code<float>() { return 1; }

template <typename TQ, typename TKV, int REP, int kG, typename... Args>
cudaError_t launch_built(Args... args) {
#ifdef REPRO_PA_REP
  constexpr bool built = dtype_code<TQ>() == REPRO_PA_Q && dtype_code<TKV>() == REPRO_PA_KV &&
                         REP == REPRO_PA_REP && kG == REPRO_PA_G;
#else
  constexpr bool built = true;
#endif
  if constexpr (built)
    return launch<TQ, TKV, REP, kG>(args...);
  else
    return cudaErrorNotSupported;
}

// the GQA group sizes of the repository's archs (Hq / Hkv)
template <typename TQ, typename TKV>
cudaError_t launch_rep(int rep, const void* q, const void* k, const void* v,
                       const int* tables, const int* lengths, void* out, void* ws, int b,
                       int hkv, int hd, int n_blocks, int blk, int pages, int pps,
                       float scale, cudaStream_t s) {
#define REPRO_REP_CASE(R)                                                                  \
  case R:                                                                                  \
    return hd <= 128 ? launch_built<TQ, TKV, R, 16>(q, k, v, tables, lengths, out, ws, b, hkv, \
                                                    hd, n_blocks, blk, pages, pps, scale, s)  \
                     : launch_built<TQ, TKV, R, 32>(q, k, v, tables, lengths, out, ws, b, hkv, \
                                                    hd, n_blocks, blk, pages, pps, scale, s);
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
// 1, 2, 3, 4, 6, 8, 12, 16.  pps is the pages of a split; the grid has
// ceil(pages / pps) splits, and with more than one, ws holds B * Hkv *
// splits * rep * (hd + 2) floats of workspace.  Returns a cudaError_t
// (0 = ok).
int repro_paged_attention(int q_dtype, int kv_dtype, const void* q, const void* k,
                          const void* v, const int* block_tables, const int* lengths,
                          void* out, void* ws, int b, int hkv, int rep, int hd, int n_blocks,
                          int blk, int pages, int pps, float scale, void* stream) {
  if (b < 1 || hkv < 1 || hd < 1 || hd > kMaxHd || n_blocks < 1 || blk < 1 || pages < 1 ||
      pps < 1 || pps > pages)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch_rep<__nv_bfloat16, __nv_bfloat16>(rep, q, k, v, block_tables, lengths, out,
                                                   ws, b, hkv, hd, n_blocks, blk, pages, pps,
                                                   scale, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = launch_rep<float, float>(rep, q, k, v, block_tables, lengths, out, ws, b, hkv, hd,
                                   n_blocks, blk, pages, pps, scale, s);
  else if (q_dtype == 1 && kv_dtype == 0)
    err = launch_rep<float, __nv_bfloat16>(rep, q, k, v, block_tables, lengths, out, ws, b,
                                           hkv, hd, n_blocks, blk, pages, pps, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
