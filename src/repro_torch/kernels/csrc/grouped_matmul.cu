// Grouped expert products of a Mixture-of-Experts layer for Hopper (sm_90a):
// rows sorted by expert, group e multiplied by expert e's matrices, as
// lax.ragged_dot multiplies them.
//
// Replaces no TPU kernel.  The reference leaves the experts' products to
// lax.ragged_dot (src/repro/models/moe.py:100-105, _expert_ffn); the port
// had run them as one torch.matmul per expert and projection, with the
// loop's bounds read back to the host once a layer call.  These two kernels
// read the groups' bounds (offsets, groups + 1 int32 on the device) inside
// the launch, so the host neither waits nor loops:
//   repro_grouped_gate_up  h = silu(x.W_gate[e]) * (x.W_up[e]) for every
//                          group in one launch: both sums in f32 registers,
//                          h rounded once to bf16 (g and u never reach
//                          device memory);
//   repro_grouped_down     y = h.W_down[e] in one launch, into bf16 rows or,
//                          with slots, as the MoE combine's weighted put:
//                          f32 row slots[r] = bf16(y_r) * scale[slots[r]],
//                          each slot written by one thread, no atomics.
// Rows at or past offsets[groups] come out 0 (ragged_dot's rule, and the
// padding rows of the token-routing layout).
//
// What bounds them.  Each expert given a row reads its matrices once when
// its rows fit one row tile: at Mellum2's decode (64 rows, top-8 of 64
// experts, d 2304, ff 896) a layer call reads 64 x 3 x 2304 x 896 bf16
// weights, 0.79 GB, 0.24 ms at 3.35 TB/s, for 6.3 GFLOP: bound by bytes.
// A 1500-token prefill's 12,000 assignments need 149 GFLOP (0.15 ms at 989
// TFLOP/s) and the same bytes: still bound by bytes.  Mixtral's prefill
// (3,000 assignments over 8 experts, d 6144, ff 16384) needs 1.8 TFLOP
// against 4.9 GB: bound by operations.  Kimi-K2's decode (512 assignments
// over 384 experts, d 7168, ff 2048) reads 25 GB: bound by bytes.
//
// Design.  The weight's wide dimension (ff for gate/up, d for down) is the
// 64-row operand A of wgmma, read M-major from the weight as it lies (E, K,
// M), through the descriptor's transpose bit; a group's token rows are the
// N side, a row tile of BN = 8..128 rows (the host picks it from the mean
// rows an expert, T k / E: the smallest power of two at least twice that),
// so decode's ~8 rows an expert use an n16 product, not a 64-row tile.  A
// block owns one row tile of one group and 128 weight columns (gate+up: each
// of two consumer warpgroups 64 columns of both weights, two accumulators)
// or 256 (down: each warpgroup 64 columns at m0 and 64 at m0 + 128).  A
// producer thread keeps a ring of stages filled by TMA: per stage four 64 x
// 64 weight boxes from 3-D maps (a ragged K is zero-filled per expert) and
// the row tile's 64 x BN box of x, K-major.  The grid covers every group's
// row tiles in order, ceil(rows / BN) + groups + 1 of them at most, times
// the column tiles, launched 8 column tiles to a row tile so that the
// blocks that read one expert's columns run together and share them in L2;
// each block finds its own (group, first row, end row) from the offsets
// with one warp's scan, and a block past the last tile exits.  The last
// group (index `groups`) is the rows past offsets[groups]; its blocks write
// zeros and load nothing.  Rows of the next group that a row tile's box
// reaches are multiplied and never stored.  The down product's 128-row
// tiles run as block pairs (a 2-block cluster) that multicast the row tile,
// each loading half: 17% fewer bytes into each SM, 23% faster at Mixtral's
// prefill (paired, gate+up measured 5% slower, so it runs alone).  The
// epilogue stores from the accumulator's fragment (hopper_tile.cuh),
// masked to the tile's rows and to M.

#include <cuda_bf16.h>

#include "hopper_tile.cuh"

namespace gm {

constexpr int kBK = 64, kThreads = 384;
constexpr int kTileA = 64 * kBK;                          // one warpgroup's box, elements
constexpr size_t kSmemLimit = 220 * 1024;

// wgmma m64nNk16, bf16 in, f32 accumulator, A M-major (transposed) and B
// K-major, both from shared memory
template <int N>
struct Mma;

template <>
struct Mma<8> {
  __device__ __forceinline__ static void run(float (&d)[4], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Mma<16> {
  __device__ __forceinline__ static void run(float (&d)[8], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Mma<32> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

// The pair of blocks of a 2-block cluster: its rank, a barrier's address in
// the peer, an arrival there, the cluster-wide barrier, and a TMA load that
// lands in both blocks' shared memory and completes on both barriers.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void arrive_peer(uint64_t* bar, uint32_t peer) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(hopper::smem_addr(bar)), "r"(peer));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}

__device__ __forceinline__ void tma_load_2d_both(void* dst, const CUtensorMap* map, int c0,
                                                 int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(hopper::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(hopper::smem_addr(bar)),
      "h"(static_cast<uint16_t>(3))
      : "memory");
}

// Every stage holds four 64 x 64 weight boxes, box q = 2 w + j at columns
// m0 + 64 j of weight w (gate+up: w 0 gate, 1 up) or m0 + 128 w + 64 j of
// the one weight (down), and the row tile's 64 x BN box of x.
template <int BN>
struct Shape {
  static constexpr int kStageElems = 4 * kTileA + BN * kBK;
  static constexpr int kStageBytes = kStageElems * 2;
  static constexpr int kFit = static_cast<int>((kSmemLimit - 1024) / (kStageBytes + 16));
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr size_t kSmemBytes =
      1024 + static_cast<size_t>(kStages) * kStageBytes + 2 * kStages * sizeof(uint64_t);
};

// Where a product's value lands: bf16 out[r][col], or, with slots (the
// down product's scatter), f32 out[slots[r]][col] = bf16(v) * scale[slots[r]]
// (the combine's put and weighting: each slot written once, no atomics).
struct Out {
  void* p;
  const long long* slots;
  const float* scale;
  int M;
};

struct Row {
  long long at;     // element offset of the row's column 0
  float scale;
};

__device__ __forceinline__ Row row_of(const Out& o, int r) {
  if (o.slots == nullptr) return {static_cast<long long>(r) * o.M, 1.f};
  const long long s = o.slots[r];
  return {s * o.M, o.scale[s]};
}

__device__ __forceinline__ void put(const Out& o, const Row& row, int col, float v) {
  if (col >= o.M) return;
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  if (o.slots == nullptr) static_cast<__nv_bfloat16*>(o.p)[row.at + col] = b;
  else static_cast<float*>(o.p)[row.at + col] = __bfloat162float(b) * row.scale;
}

// Warp 0: this block's row tile y of the list of every group's tiles
// (group g of n rows has ceil(n / bn) of them; group `groups` is the rows
// past offsets[groups]).  Writes (group, first row, end row) to tile, or
// leaves tile[0] at -1 where y is past the last tile.
__device__ __forceinline__ void find_tile(const int* __restrict__ offsets, int groups, int rows,
                                          int bn, int y, int* tile) {
  const int lane = threadIdx.x % 32;
  int base = 0;
  for (int c = 0; c <= groups; c += 32) {
    const int g = c + lane;
    int lo = rows, hi = rows;
    if (g < groups) {
      lo = offsets[g];
      hi = offsets[g + 1];
    } else if (g == groups) {
      lo = offsets[groups];
    }
    const int n = hi > lo ? hi - lo : 0;
    const int t = (n + bn - 1) / bn;
    int s = t;                                            // inclusive scan over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += v;
    }
    const int first = base + s - t;
    if (y >= first && y < first + t) {
      const int r0 = lo + (y - first) * bn;
      tile[0] = g;
      tile[1] = r0;
      tile[2] = r0 + bn < hi ? r0 + bn : hi;
    }
    base += __shfl_sync(0xffffffffu, s, 31);
    if (base > y) break;
  }
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + __expf(-g)) * u;
}

// One block: a row tile of one group (the N side of each product), against
// 128 weight columns (kGate: out = silu(x.W0[e]) * (x.W1[e])) or 256 (out =
// x.W0[e]), the 64-row operand: each consumer warpgroup takes 64 columns of
// both weights (kGate) or those at m0 and m0 + 128.  x (rows, K) with row
// stride ldx, the weights (groups, K, M).
template <int BN, bool kGate, bool kPair>
__global__ void __launch_bounds__(kThreads, 1)
grouped_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w0,
               const __grid_constant__ CUtensorMap map_w1, const Out o,
               const int* __restrict__ offsets, int rows, int groups, int K) {
  using S = Shape<BN>;
  constexpr int kStages = S::kStages, kCols = kGate ? 128 : 256;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int tile[3];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(hopper::align_1024(smem_raw));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * S::kStageElems);
  uint64_t* empty = full + kStages;
  const int M = o.M;

  // Launch order: kGroup column tiles of one row tile, then the next row
  // tile, so the blocks that read one expert's columns (its row tiles) run
  // close together and share them in L2.  Consecutive blocks (a cluster's
  // pair) get one row tile and neighbouring columns.
  constexpr int kGroup = 8;
  const int nx = gridDim.x, ny = gridDim.y;
  const int lin = blockIdx.x + nx * blockIdx.y;
  const int first = lin / (kGroup * nx) * kGroup;
  const int gy = ny - first < kGroup ? ny - first : kGroup;
  const int bx = (lin - first * nx) / gy, by = first + (lin - first * nx) % gy;
  const int m0 = by * kCols;
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      tile[0] = -1;
      for (int s = 0; s < kStages; ++s) {
        hopper::mbar_init(&full[s], 1);
        // one arrival per consumer warpgroup, of this block and the peer's
        hopper::mbar_init(&empty[s], kPair ? 4 : 2);
      }
      hopper::fence_barrier_init();
    }
    __syncwarp();
    find_tile(offsets, groups, rows, BN, bx, tile);
  }
  __syncthreads();
  if (kPair) cluster_sync();                              // the peer's barriers are ready
  const int e = tile[0], r0 = tile[1], r1 = tile[2];
  const uint32_t peer = kPair ? cluster_rank() ^ 1 : 0;
  if (e < 0) return;
  if (e == groups) {                                      // rows past the groups: zeros
    for (int i = threadIdx.x; i < (r1 - r0) * kCols; i += kThreads)
      put(o, row_of(o, r0 + i / kCols), m0 + i % kCols, 0.f);
    return;
  }

  const int wg = threadIdx.x / 128;
  const int nk = (K + kBK - 1) / kBK;
  if (wg == 2) {                                          // producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        __nv_bfloat16* st = ring + s * S::kStageElems;
        hopper::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], S::kStageBytes);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int w = q / 2, j = q % 2;
          hopper::tma_load_3d(st + q * kTileA, kGate && w ? &map_w1 : &map_w0,
                              m0 + 64 * j + (kGate ? 0 : 128 * w), kt * kBK, e, &full[s]);
        }
        if (kPair)   // this block's half of the row tile, to both blocks
          tma_load_2d_both(st + 4 * kTileA + (peer ^ 1) * (BN / 2) * kBK, &map_x, kt * kBK,
                           r0 + (peer ^ 1) * (BN / 2), &full[s]);
        else
          hopper::tma_load_2d(st + 4 * kTileA, &map_x, kt * kBK, r0, &full[s]);
      }
      // the pair: stay until both blocks' consumers have released every
      // stage, so no arrival or load of the peer finds this block gone
      for (int kt = nk; kPair && kt < nk + kStages; ++kt)
        hopper::mbar_wait(&empty[kt % kStages], ((kt / kStages) & 1) ^ 1);
    }
    return;
  }
  auto release = [&](int s) {
    hopper::mbar_arrive(&empty[s]);
    if (kPair) arrive_peer(&empty[s], peer);
  };
  hopper::setmaxnreg_inc<232>();                          // consumers
  const int t = threadIdx.x % 128;
  // accumulator entry 4j + 2h + c: column m + 8h, row n + 8j + c; acc1 is
  // the up product's (kGate) or 128 columns to the right
  float acc0[BN / 2], acc1[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0.f;
  hopper::fence_regs(acc0);
  hopper::fence_regs(acc1);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    const __nv_bfloat16* st = ring + s * S::kStageElems;
    const __nv_bfloat16* a0 = st + wg * kTileA;
    const __nv_bfloat16* a1 = st + (2 + wg) * kTileA;
    const __nv_bfloat16* b = st + 4 * kTileA;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A: the k16 slice starts 16 rows of 128 bytes in; B: 32 bytes in
      const uint64_t db = hopper::desc_sw128(b + kk * 16, 16, 1024);
      Mma<BN>::run(acc0, hopper::desc_sw128(a0 + kk * 16 * 64, kTileA * 2, 1024), db);
      Mma<BN>::run(acc1, hopper::desc_sw128(a1 + kk * 16 * 64, kTileA * 2, 1024), db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();                            // stage kt - 1 is read: release it
    if (kt > 0 && t == 0) release((kt - 1) % kStages);
  }
  hopper::wgmma_wait<0>();
  if (kPair && t == 0) release((nk - 1) % kStages);
  hopper::fence_regs(acc0);
  hopper::fence_regs(acc1);
  const int m = m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = r0 + 2 * (t % 4) + 8 * j + c;
      if (r >= r1) continue;
      const Row row = row_of(o, r);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + c, col = m + 8 * h;
        if constexpr (kGate) {
          put(o, row, col, silu_mul(acc0[i], acc1[i]));
        } else {
          put(o, row, col, acc0[i]);
          put(o, row, col + 128, acc1[i]);
        }
      }
    }
  }
}

// x: (rows, K) with row stride ldx, box 64 x BN; a weight (groups, K, M)
// dense, box 64 x 64 x 1 (a ragged K reads zeros, never the next expert).
template <int BOX>
cudaError_t make_maps(CUtensorMap* map_x, CUtensorMap* map_w0, CUtensorMap* map_w1,
                      const void* x, const void* w0, const void* w1, int rows, int groups,
                      int K, int M, long long ldx) {
  const cuuint64_t dims_x[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t str_x[1] = {static_cast<cuuint64_t>(ldx * 2)};
  const cuuint32_t box_x[2] = {kBK, BOX};
  const cuuint64_t dims_w[3] = {static_cast<cuuint64_t>(M), static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(groups)};
  const cuuint64_t str_w[2] = {static_cast<cuuint64_t>(M) * 2,
                               static_cast<cuuint64_t>(K) * M * 2};
  const cuuint32_t box_w[3] = {64, kBK, 1};
  cudaError_t err = hopper::make_map(map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims_x,
                                     str_x, box_x);
  if (err == cudaSuccess)
    err = hopper::make_map(map_w0, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w0, dims_w, str_w,
                           box_w);
  *map_w1 = *map_w0;
  if (err == cudaSuccess && w1 != nullptr)
    err = hopper::make_map(map_w1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w1, dims_w, str_w,
                           box_w);
  return err;
}

// The down product's 128-row tile runs as pairs of blocks (a cluster of 2
// along x: one row tile, neighbouring columns) that load half the row tile
// each and multicast it, where the column tiles pair up; every other launch
// runs one block alone.
template <int BN, bool kGate>
cudaError_t launch(const void* x, const void* w0, const void* w1, const Out& o,
                   const int* offsets, int rows, int groups, int K, long long ldx,
                   cudaStream_t stream) {
  constexpr int kCols = kGate ? 128 : 256;
  const int nx = (rows + BN - 1) / BN + groups + 1, ny = (o.M + kCols - 1) / kCols;
  constexpr bool kPairs = !kGate && BN == 128;
  const bool pair = kPairs && ny % 2 == 0;
  CUtensorMap map_x, map_w0, map_w1;
  const cudaError_t err =
      pair ? make_maps<BN / 2>(&map_x, &map_w0, &map_w1, x, w0, w1, rows, groups, K, o.M, ldx)
           : make_maps<BN>(&map_x, &map_w0, &map_w1, x, w0, w1, rows, groups, K, o.M, ldx);
  if (err != cudaSuccess) return err;
  if (!pair)
    return hopper::launch(grouped_kernel<BN, kGate, false>, dim3(nx, ny), kThreads,
                          Shape<BN>::kSmemBytes, stream, map_x, map_w0, map_w1, o, offsets,
                          rows, groups, K);
  const auto kernel = grouped_kernel<BN, kGate, kPairs>;
  const size_t smem = Shape<BN>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nx + nx % 2, ny);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, map_x, map_w0, map_w1, o, offsets, rows, groups, K);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool kGate>
int launch_bn(int bn, const void* x, const void* w0, const void* w1, const Out& o,
              const int* offsets, int rows, int groups, int K, long long ldx, void* stream) {
  if (rows < 1 || groups < 1 || K < 1 || o.M < 1 || K % 8 || o.M % 8 || ldx % 8 || ldx < K ||
      (o.M + 127) / 128 > 65535 || (o.slots != nullptr) == (o.scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bn) {
    case 8: err = launch<8, kGate>(x, w0, w1, o, offsets, rows, groups, K, ldx, s); break;
    case 16: err = launch<16, kGate>(x, w0, w1, o, offsets, rows, groups, K, ldx, s); break;
    case 32: err = launch<32, kGate>(x, w0, w1, o, offsets, rows, groups, K, ldx, s); break;
    case 64: err = launch<64, kGate>(x, w0, w1, o, offsets, rows, groups, K, ldx, s); break;
    case 128: err = launch<128, kGate>(x, w0, w1, o, offsets, rows, groups, K, ldx, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace gm

extern "C" {

// bf16 throughout; x (rows, d) with row stride ldx (a multiple of 8, as d
// and ff are: TMA's 16-byte strides), w_gate and w_up (groups, d, ff) and
// w_down (groups, ff, d) dense, h (rows, ff) a dense bf16 output; offsets:
// groups + 1 int32 on the device, non-decreasing from 0, at most rows; bn
// (the row tile) 8, 16, 32, 64 or 128.  Returns a cudaError_t (0 = ok).
int repro_grouped_gate_up(const void* x, const void* w_gate, const void* w_up, void* h,
                          const int* offsets, int rows, int groups, int d, int ff,
                          long long ldx, int bn, void* stream) {
  return gm::launch_bn<true>(bn, x, w_gate, w_up, gm::Out{h, nullptr, nullptr, ff}, offsets,
                             rows, groups, d, ldx, stream);
}

// y = h . w_down[e] as above, into a dense bf16 y (rows, d); or, with slots
// (rows int64, distinct) and scale (f32), into an f32 y whose row slots[r]
// gets bf16(h_r . w_down[e]) * scale[slots[r]] (rows not listed untouched).
int repro_grouped_down(const void* h, const void* w_down, void* y, const long long* slots,
                       const float* scale, const int* offsets, int rows, int groups, int ff,
                       int d, long long ldh, int bn, void* stream) {
  return gm::launch_bn<false>(bn, h, w_down, nullptr, gm::Out{y, slots, scale, d}, offsets,
                              rows, groups, ff, ldh, stream);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
