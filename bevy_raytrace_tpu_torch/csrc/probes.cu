// P1-P5 on Hopper: the five construct probes of tools/proto_mxu.py.
//
// The TPU tool asks five yes/no questions of its compiler before a render
// kernel is designed around the answers: does a loop with a block-wide exit
// condition and per-lane carries compile (P1), an in-kernel float32 product
// (P2), a relayout round trip (P3), a column minimum with its row index (P4),
// an equality one-hot gather (P5).  These are the same five functions written
// as plain SIMT for sm_90a, each small enough to read at a glance; the answers
// they give for this card stand in PERF.md beside their times.
//
//   P1  replaces p1_while_vreg_carry (tools/proto_mxu.py:24)
//   P2  replaces p2_dot              (tools/proto_mxu.py:55)
//   P3  replaces p3_reshape          (tools/proto_mxu.py:74)
//   P4  replaces p4_min_packed       (tools/proto_mxu.py:90)
//   P5  replaces p5_onehot_gather    (tools/proto_mxu.py:116)
//
// What bounds them on an H100: P2 by its bytes (it writes 4 MB at the tool's
// shape), P4 and P5 by the latency of their 2 MB of loads, P1 and P3 by the
// cost of a launch itself (P1's 50 rounds of four operations a lane are
// nanoseconds of arithmetic; P3 at a card-filling shape by its bytes).  P1
// runs its 1,024 lanes as warps that each vote alone, ahead of their
// carries, and meet once across a cluster of 8 blocks to agree on the round
// count; P2 gives a thread four consecutive columns of 4 rows and stores
// each row 128 bits at a time as soon as it is summed; P3 takes a float4 a
// thread; P4 and P5 spread their rows over R / 8 blocks, 128 at the tool's
// shape, 32 rows a thread (below).  They are probes of constructs, not of
// rates; the rate probes are in fp32_probe.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, no
// --use_fast_math, --fmad at its default (a*b+c contracts to fma).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// ---- P1 ---------------------------------------------------------------------
// The loop runs while ANY lane is alive; as in the TPU kernel a dead lane's
// carries a and b go on updating until the last lane has died, and only
// `alive` is sticky.  So the loop's round count R is the largest of the
// lanes' own counts, and a lane's carries after R rounds do not depend on
// when the others died.  The kernel therefore needs no barrier a round:
//   1. each warp loops on its own vote (__any_sync) until its lanes are dead
//      and counts its rounds r_w;
//   2. the warps meet once: each sends r_w into every block's shared memory
//      (st.async, counted by an mbarrier), and every warp reads R = max r_w;
//   3. each warp runs its R - r_w remaining rounds with no vote, and stores.
// `a` only grows (a + 1 >= a, and a NaN stays NaN), so a lane is alive after
// round r exactly when a_r < 50: `alive` needs no register of its own.  That
// lets a warp vote ahead: it steps `a` alone kP1Ahead rounds, votes once on
// the last, and if a lane is still alive then, runs those rounds' carries
// with no vote; otherwise it takes them a round and a vote at a time and
// stops at the round after which no lane is alive.  A lane does the same
// operations on the same values as the TPU kernel's loop, with the fma
// written out (p1_carry), so the output keeps the bits of a block-wide loop
// whatever nvcc would contract.  What P1 measures on this card is a vote a
// warp and one cluster-wide count: the TPU's construct without the barrier
// a round.  K1 (k1_render.cu) runs a per-lane loop with no vote at all.
//
// The 1,024 lanes go to a thread block cluster of kP1Blocks (8) blocks of
// kP1Threads (128), a lane a thread, on 8 SMs.  Against one block of 1,024
// (1, 2 or 4 lanes a thread), a vote every 1, 4 or 8 rounds, and a meeting
// by cluster.sync() (whose release fence costs more than the rounds it
// spreads), this form was the fastest on an H100 (PERF.md).
constexpr int kP1Lanes = 1024;
constexpr int kP1Blocks = 8;
constexpr int kP1Threads = kP1Lanes / kP1Blocks;
constexpr int kP1Warps = kP1Threads / 32;  // warps a block
constexpr int kP1Ahead = 16;               // rounds a vote
static_assert(kP1Warps * kP1Blocks == 32,
              "a lane of one warp for each warp's count");
// A warp waits for the cluster's counts at most this long (10 s) and then
// traps.  The longest run that ends, a lane at -2^24 (2^24 + 50 rounds),
// stays far inside it (test_cuda_p1_longest_run_ends).  A trap is not an
// ordinary launch error: it leaves the process's CUDA context unusable, and
// every later CUDA call of the process fails too.
constexpr unsigned long long kP1WaitNs = 10'000'000'000ull;

// A round's update of b from the round's a: b * 1.01 + a * 0.001, contracted
// as nvcc contracts the TPU kernel's body in a loop of one lane a thread.
__device__ __forceinline__ float p1_carry(float b, float a) {
  return fmaf(b, 1.01f, a * 0.001f);
}

// The cluster's meeting by st.async: every warp writes its count into every
// block's `warp_rounds`, and each block's mbarrier `got` completes when all
// of them (4 bytes each) have landed.  Nothing is read from another block,
// so no release fence or second cluster barrier is needed.
__device__ __forceinline__ unsigned p1_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void p1_send(const int* slot, int value,
                                        const unsigned long long* got,
                                        unsigned rank) {
  unsigned remote_slot, remote_got;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote_slot) : "r"(p1_smem(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote_got) : "r"(p1_smem(got)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];" ::"r"(remote_slot), "r"(value), "r"(remote_got)
      : "memory");
}

__device__ __forceinline__ unsigned long long p1_now() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// Waits for phase 0 of the mbarrier.  The wait is bounded in time: a count
// that never lands (or a lane whose a + 1 no longer grows, a < -2^24, whose
// warp never ends) traps after kP1WaitNs (10 s).  The trap ends the kernel
// with an error that the next synchronizing call reports, and it leaves the
// process's CUDA context unusable: every later CUDA call of the process
// fails (the reference's loop would never end on such an input).
__device__ __forceinline__ void p1_wait(const unsigned long long* got) {
  const unsigned long long start = p1_now();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(p1_smem(got)) : "memory");
    if (done) return;
    if (p1_now() - start > kP1WaitNs) __trap();
  }
}

__global__ void __launch_bounds__(kP1Threads)
    p1_while_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int* __restrict__ rounds_out) {
  __shared__ int warp_rounds[kP1Warps * kP1Blocks];
  __shared__ unsigned long long got;
  // The mbarrier, ready before any block of the cluster may send to it: the
  // cluster barrier's wait comes before the first send (below).
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(p1_smem(&got))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * kP1Threads + threadIdx.x;
  float a = x[i];
  float b = a * 2.0f;
  // 1. The warp's own loop: the first round always runs.
  int rounds = 0;
  for (;;) {
    float ahead[kP1Ahead];  // a after each next round
#pragma unroll
    for (int u = 0; u < kP1Ahead; ++u) ahead[u] = (u ? ahead[u - 1] : a) + 1.0f;
    if (__any_sync(~0u, ahead[kP1Ahead - 1] < 50.0f)) {
#pragma unroll
      for (int u = 0; u < kP1Ahead; ++u) b = p1_carry(b, ahead[u]);
      a = ahead[kP1Ahead - 1];
      rounds += kP1Ahead;
      continue;
    }
    // The warp's last lane dies within these rounds: a vote a round.
#pragma unroll
    for (int u = 0; u < kP1Ahead; ++u) {
      a = ahead[u];
      b = p1_carry(b, a);
      ++rounds;
      if (!__any_sync(~0u, a < 50.0f)) break;
    }
    break;
  }
  // 2. The count of the cluster: the largest warp's.
  const unsigned me = cg::this_cluster().block_rank();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (threadIdx.x == 0)
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            p1_smem(&got)),
        "r"(kP1Warps * kP1Blocks * 4)
        : "memory");
  if (lane < kP1Blocks)
    p1_send(&warp_rounds[me * kP1Warps + warp], rounds, &got, lane);
  p1_wait(&got);
  const int total = __reduce_max_sync(~0u, warp_rounds[lane]);
  // 3. The rounds this warp's lanes go on updating after they died.
  for (int r = rounds; r < total; ++r) {
    a = a + 1.0f;
    b = p1_carry(b, a);
  }
  out[i] = b + static_cast<float>(total);
  if (i == 0) *rounds_out = total;
}

// ---- P2 ---------------------------------------------------------------------
// c[M, N] = a[M, K] @ b[K, N] in float32, each element fmaf over k ascending
// from 0 (wgmma has no float32 input type, only TF32, which keeps ~3 decimal
// digits).  With K = 16 the product writes 64 times the bytes it reads: the
// bytes bound it (4.3 MB at the tool's shape, 1.29 us at 3.35 TB/s), and its
// 33.6 MFLOP are 0.5 us at the card's float32 rate.  The design:
//   * a block of 256 threads computes a 64 x 64 tile of c, a block a tile
//     (256 blocks at the tool's shape, one wave at 3 blocks an SM); thread
//     (tx, ty) holds four consecutive columns 4 tx .. 4 tx + 3 of the rows
//     ty + 16 i, i < kP2Rows (4), and writes each row's four as one 128-bit
//     streaming store (__stcs, evict-first: c is never read back here), a
//     half-warp a 256-byte row piece an instruction;
//   * per K step of 16 the block's A panel (64 rows x 16, one contiguous
//     4 KB piece when K = 16) and B panel (16 rows x 256 bytes) come into
//     shared memory with one 128-bit load each a thread, and the next
//     step's panels are loaded while this step's products run;
//   * a thread reads its four columns at every k of the step once (16
//     128-bit loads), then takes its rows one at a time: four 128-bit loads
//     of the row of A (every thread of a phase reads one address) and 64
//     fmaf; at the last step each row is stored as soon as it is summed, so
//     that the stores of one row overlap the products of the next.
// Against 8 rows a thread, all rows stored at the end, plain stores and a
// persistent grid walking the tiles, this form was the fastest at the
// tool's shape on an H100 (PERF.md).  What holds it above its bound is the
// card's own store stream: a plain 4 MB fill of zeros takes most of P2's
// time, and the loads and products before the first store are the rest.
// a, b and c must be 16-byte aligned (the launcher refuses them otherwise);
// M and N are multiples of 64, K of 16.
constexpr int kP2Tile = 64;
constexpr int kP2K = 16;
constexpr int kP2Rows = 4;                              // rows a thread
constexpr int kP2ColThreads = kP2Tile / 4;              // threads a row
constexpr int kP2RowThreads = kP2Tile / kP2Rows;        // rows apart
constexpr int kP2Threads = kP2ColThreads * kP2RowThreads;
static_assert(kP2Tile * kP2K / 4 == kP2Threads,
              "one float4 of each panel a thread");

__device__ __forceinline__ float p2_lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kP2Threads)
    p2_dot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float as[kP2Tile][kP2K];  // as[row][kk]
  __shared__ __align__(16) float bs[kP2K][kP2Tile];  // bs[kk][col]
  const int tid = threadIdx.x;
  const int tx = tid % kP2ColThreads, ty = tid / kP2ColThreads;
  const int tiles_n = n / kP2Tile;
  const int row0 = blockIdx.x / tiles_n * kP2Tile;
  const int col0 = blockIdx.x % tiles_n * kP2Tile;
  // This thread's float4 of the A and B panels at k0: of A, row tid / 4,
  // k0 + 4 (tid % 4); of B, row k0 + tid / 16, columns 4 (tid % 16) on.
  float4 av, bv;
  const auto load = [&](int k0) {
    av = __ldg(reinterpret_cast<const float4*>(
        a + static_cast<size_t>(row0 + tid / 4) * k + k0) + tid % 4);
    bv = __ldg(reinterpret_cast<const float4*>(
        b + static_cast<size_t>(k0 + tid / 16) * n + col0) + tid % 16);
  };
  load(0);
  float4 acc[kP2Rows];
#pragma unroll
  for (int i = 0; i < kP2Rows; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < k; k0 += kP2K) {
    __syncthreads();  // every thread is done with the last panels
    reinterpret_cast<float4*>(as[tid / 4])[tid % 4] = av;
    reinterpret_cast<float4*>(bs[tid / 16])[tid % 16] = bv;
    __syncthreads();
    const bool last = k0 + kP2K >= k;
    if (!last) load(k0 + kP2K);  // in flight during this step's products
    float4 br[kP2K];
#pragma unroll
    for (int kk = 0; kk < kP2K; ++kk)
      br[kk] = reinterpret_cast<const float4*>(bs[kk])[tx];
#pragma unroll
    for (int i = 0; i < kP2Rows; ++i) {
      const int row = ty + kP2RowThreads * i;
#pragma unroll
      for (int kk = 0; kk < kP2K; kk += 4) {
        const float4 ar = reinterpret_cast<const float4*>(as[row])[kk / 4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // k = k0 + kk + q, ascending
          const float ai = p2_lane(ar, q);
          acc[i].x = fmaf(ai, br[kk + q].x, acc[i].x);
          acc[i].y = fmaf(ai, br[kk + q].y, acc[i].y);
          acc[i].z = fmaf(ai, br[kk + q].z, acc[i].z);
          acc[i].w = fmaf(ai, br[kk + q].w, acc[i].w);
        }
      }
      if (last)
        __stcs(reinterpret_cast<float4*>(
                   c + static_cast<size_t>(row0 + row) * n + col0) + tx,
               acc[i]);
    }
  }
}

// ---- P3 ---------------------------------------------------------------------
// [rows, 128] -> [1, rows * 128], times 2, and back.  A row-major reshape
// moves nothing on a GPU, so the round trip is one elementwise pass: x * 2,
// exact in float32.
//
// What bounds it: at the tool's [8, 128] the launch itself (an empty kernel
// takes ~0.83 us); at a card-filling [2^21, 128] its bytes, 2 GiB at 3.35
// TB/s = 0.641 ms.  A float a thread keeps ~8 KB in flight an SM where HBM
// needs ~15 KB, and reached half of that bound.  The design: a float4 a
// thread (rows * 128 is a multiple of 4), loaded and stored with streaming
// hints (each byte is touched once), kP3Threads a block, a block for each
// kP3Threads float4s and no loop; the index is 64-bit, so every row count
// that fits on the card runs.  Against 2 or 4 float4s a thread, 32 to 512
// threads, a grid-stride loop over a one-shot or a persistent grid and plain
// accesses, this form was the fastest on an H100 (PERF.md).  x and out must
// be 16-byte aligned: the launcher refuses them otherwise.
constexpr int kP3Threads = 256;
constexpr int kP3Vecs = 128 / 4;  // float4s a row

__global__ void __launch_bounds__(kP3Threads)
    p3_reshape_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                      size_t n4) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kP3Threads + threadIdx.x;
  if (i >= n4) return;
  const float4 v = __ldcs(x + i);
  __stcs(out + i, make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f));
}

// ---- P4 ---------------------------------------------------------------------
// Per column of t [S, R]: the minimum and the row it stands in, exact: the
// lowest row wins a tie, and a NaN never wins against a number (an all-NaN
// column gives its row 0).  The TPU kernel packs the row into the low 9 bits
// of t and takes one integer minimum: a device of that machine, not carried
// over; its key orders NaN above every positive float, which this order
// keeps.
//
// What bounds it: latency, as P5's keys (the same 2 MB at the tool's shape).
// A thread a column walking the rows waited on one dependent load a row.
// P5's shape instead: a block takes kP4Cols (8) columns, one 32-byte sector
// of a row, and its kP4Threads (128) threads split the rows, kP4Rows (32)
// consecutive rows a thread, all loads issued before any compare; each
// thread keeps its own (value, row) pair; the 16 chunks of a column are then
// combined by two shuffles within a warp and through shared memory across
// the 4 warps.  The pair order (p4_before) is a total order on (value, row)
// with distinct rows, so the combined pair does not depend on the order of
// the combination: no float atomics, and the row is exact.  Rows come in
// slabs of 512 (kP4Chunks chunks); a thread's pair carries across slabs, so
// any S runs.  Against float2 and float4 loads (2 or 4 columns a thread,
// 16 or 8 rows) this shape was the fastest on an H100 (PERF.md).
constexpr int kP4Cols = 8, kP4Rows = 32, kP4Threads = 128;
constexpr int kP4Chunks = kP4Threads / kP4Cols;  // chunks a slab
constexpr int kP4Warps = kP4Threads / 32;

// (a, ra) comes before (b, rb): a number before a NaN, then the smaller
// value, then (equal values, or two NaNs) the lower row.
__device__ __forceinline__ bool p4_before(float a, int ra, float b, int rb) {
  const bool an = a != a, bn = b != b;
  if (an != bn) return bn;
  return a < b || (!(b < a) && ra < rb);
}

__global__ void __launch_bounds__(kP4Threads)
    p4_min_kernel(const float* __restrict__ t, float* __restrict__ t_out,
                  int* __restrict__ row_out, int s, int r) {
  constexpr int kSlab = kP4Chunks * kP4Rows;  // rows a slab
  static_assert(kP4Cols <= 32 && 32 % kP4Cols == 0, "whole rows a warp");
  __shared__ float part_t[kP4Warps][kP4Cols];
  __shared__ int part_row[kP4Warps][kP4Cols];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = threadIdx.x % kP4Cols, chunk = threadIdx.x / kP4Cols;
  const int col = blockIdx.x * kP4Cols + c;
  const bool live = col < r;
  // The pair starts as no row at all, which every row comes before.
  float best_t = __int_as_float(0x7FFFFFFF);
  int best = INT_MAX;
  for (int slab = 0; slab < s; slab += kSlab) {
    const int row0 = slab + chunk * kP4Rows;
    const int rows = live ? min(kP4Rows, s - row0) : 0;  // may be <= 0
    // A pointer stepped a row at a time: indexing t with a 64-bit multiply
    // a row was far slower on an H100 (PERF.md).
    const float* p = t + static_cast<size_t>(row0) * r + col;
    float v[kP4Rows];
#pragma unroll
    for (int j = 0; j < kP4Rows; ++j, p += r) v[j] = j < rows ? __ldg(p) : 0.f;
#pragma unroll
    for (int j = 0; j < kP4Rows; ++j) {
      const bool take = j < rows && p4_before(v[j], row0 + j, best_t, best);
      best_t = take ? v[j] : best_t;
      best = take ? row0 + j : best;
    }
  }
  // The chunks of a column within a warp: lanes kP4Cols apart.
#pragma unroll
  for (int off = kP4Cols; off < 32; off *= 2) {
    const float ot = __shfl_xor_sync(~0u, best_t, off);
    const int orow = __shfl_xor_sync(~0u, best, off);
    if (p4_before(ot, orow, best_t, best)) {
      best_t = ot;
      best = orow;
    }
  }
  if (lane < kP4Cols) {
    part_t[warp][c] = best_t;
    part_row[warp][c] = best;
  }
  __syncthreads();
  // Across the warps: a thread a column.
  const int out_col = blockIdx.x * kP4Cols + threadIdx.x;
  if (threadIdx.x < kP4Cols && out_col < r) {
    float bt = part_t[0][threadIdx.x];
    int br = part_row[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kP4Warps; ++w) {
      const float ot = part_t[w][threadIdx.x];
      const int orow = part_row[w][threadIdx.x];
      if (p4_before(ot, orow, bt, br)) {
        bt = ot;
        br = orow;
      }
    }
    t_out[out_col] = bt;
    row_out[out_col] = br;
  }
}

// ---- P5 ---------------------------------------------------------------------
// out[A, R] = attr[A, S] @ (packed[S, R] == m[R]): per column, the sum of the
// attribute columns of the rows whose key equals m (one row normally; a tie
// sums, as the one-hot product does).
//
// What bounds it: latency, not bytes.  The 2 MB of keys at the tool's shape
// (S = 512, R = 1,024) are about what the card's memory system holds in
// flight at once, so the design puts every key load in flight together and
// keeps nothing else on the way:
//   * a block takes kP5Cols (8) columns, one 32-byte sector of a row, and its
//     kP5Threads (128) threads split the rows, kP5Rows (32) consecutive rows a
//     thread (a chunk); that gives R / 8 blocks, 128 at the tool's shape;
//   * a thread issues its kP5Rows loads before any compare (unrolled, no branch
//     between them) and keeps one bit a row: the chunk's match mask, in
//     shared memory;
//   * after a barrier a warp gathers a column: its lanes read the column's
//     chunk masks, a ballot finds the chunks that matched, and lane a < 16
//     adds attr[a, row] for each matching row, straight from device memory
//     and only there.  Rows are taken in ascending order (chunk, then bit),
//     so a tie of rows a < b < c sums as ((0 + a) + b) + c, and a single
//     match is exact (0 + v).  No float atomics: the bits do not depend on
//     timing.
// Rows come in slabs of kP5Threads / kP5Cols chunks (one slab at S = 512), the
// mask table is fixed (576 bytes), and a column's sums stay in its warp's
// registers across slabs: any S runs.  Against 4, 16 or 32 columns a block,
// 8 or 16 rows a thread and 256 or 512 threads, this shape was the fastest
// on an H100 (PERF.md).
constexpr int kP5Attrs = 16;
constexpr int kP5Cols = 8, kP5Rows = 32, kP5Threads = 128;
constexpr int kP5Warps = kP5Threads / 32;

__global__ void __launch_bounds__(kP5Threads)
    p5_gather_kernel(const int* __restrict__ packed, const int* __restrict__ m,
                     const float* __restrict__ attr, float* __restrict__ out,
                     int s, int r) {
  constexpr int kChunks = kP5Threads / kP5Cols;  // chunks a slab
  constexpr int kSlab = kChunks * kP5Rows;       // rows a slab
  static_assert(kChunks <= 32 && kP5Rows <= 32 && kP5Cols % kP5Warps == 0,
                "a lane per chunk, a bit per row, whole columns a warp");
  __shared__ unsigned hits[kChunks][kP5Cols + 1];  // padded: no bank conflicts
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = threadIdx.x % kP5Cols, chunk = threadIdx.x / kP5Cols;
  const int col = blockIdx.x * kP5Cols + c;
  const bool live = col < r;
  const int want = live ? __ldg(m + col) : 0;
  float acc[kP5Cols / kP5Warps] = {};  // lane a < 16: attribute a of a column
  for (int slab = 0; slab < s; slab += kSlab) {
    const int row0 = slab + chunk * kP5Rows;
    int key[kP5Rows];
#pragma unroll
    for (int j = 0; j < kP5Rows; ++j)
      key[j] = live && row0 + j < s
                   ? __ldg(packed + static_cast<size_t>(row0 + j) * r + col)
                   : 0;
    unsigned bits = 0u;
#pragma unroll
    for (int j = 0; j < kP5Rows; ++j)
      bits |= (live && row0 + j < s && key[j] == want) ? 1u << j : 0u;
    hits[chunk][c] = bits;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kP5Cols / kP5Warps; ++q) {
      const unsigned mine = lane < kChunks ? hits[lane][warp + q * kP5Warps]
                                           : 0u;
      for (unsigned any = __ballot_sync(~0u, mine != 0u); any;
           any &= any - 1) {
        const int k = __ffs(any) - 1;
        for (unsigned b = __shfl_sync(~0u, mine, k); b; b &= b - 1) {
          const int row = slab + k * kP5Rows + __ffs(b) - 1;
          if (lane < kP5Attrs)
            acc[q] += __ldg(attr + static_cast<size_t>(lane) * s + row);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kP5Cols / kP5Warps; ++q) {
    const int out_col = blockIdx.x * kP5Cols + warp + q * kP5Warps;
    if (lane < kP5Attrs && out_col < r)
      out[static_cast<size_t>(lane) * r + out_col] = acc[q];
  }
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

// Every launcher takes device pointers and a stream, returns the launch's
// cudaError_t (0 on success) and does not synchronize.

// x [1024] float -> out [1024] float, rounds [1] int32, as one thread block
// cluster; a refused launch returns its error.
extern "C" int brt_p1_while(const void* x, void* out, void* rounds,
                            void* stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kP1Blocks);
  config.blockDim = dim3(kP1Threads);
  config.stream = as_stream(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kP1Blocks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, p1_while_kernel, static_cast<const float*>(x),
      static_cast<float*>(out), static_cast<int*>(rounds));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// a [m, k], b [k, n] -> c [m, n]; m and n multiples of 64, k of 16, every
// pointer 16-byte aligned.
extern "C" int brt_p2_dot(const void* a, const void* b, void* c, int m, int n,
                          int k, void* stream) {
  if (m % kP2Tile || n % kP2Tile || k % kP2K || m <= 0 || n <= 0 || k <= 0 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  p2_dot_kernel<<<(m / kP2Tile) * (n / kP2Tile), kP2Threads, 0,
                  as_stream(stream)>>>(static_cast<const float*>(a),
                                       static_cast<const float*>(b),
                                       static_cast<float*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// x [rows, 128] -> out [rows, 128]; rows >= 1 and at most a grid's worth
// (2^31 - 1 blocks: 2^34 rows, 8 TiB), x and out 16-byte aligned.
extern "C" int brt_p3_reshape(const void* x, void* out, int64_t rows,
                              void* stream) {
  constexpr int64_t kMaxRows = static_cast<int64_t>(INT_MAX) * kP3Threads /
                               kP3Vecs;
  if (rows <= 0 || rows > kMaxRows ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n4 = static_cast<size_t>(rows) * kP3Vecs;
  p3_reshape_kernel<<<static_cast<unsigned>((n4 + kP3Threads - 1) /
                                            kP3Threads),
                      kP3Threads, 0, as_stream(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}

// t [s, r] float -> t_out [r] float, row_out [r] int32.
extern "C" int brt_p4_min(const void* t, void* t_out, void* row_out, int s,
                          int r, void* stream) {
  if (s <= 0 || r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  p4_min_kernel<<<(r + kP4Cols - 1) / kP4Cols, kP4Threads, 0,
                  as_stream(stream)>>>(
      static_cast<const float*>(t), static_cast<float*>(t_out),
      static_cast<int*>(row_out), s, r);
  return static_cast<int>(cudaGetLastError());
}

// packed [s, r] int32, m [r] int32, attr [16, s] float -> out [16, r] float.
extern "C" int brt_p5_gather(const void* packed, const void* m,
                             const void* attr, void* out, int s, int r,
                             void* stream) {
  if (s <= 0 || r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  p5_gather_kernel<<<(r + kP5Cols - 1) / kP5Cols, kP5Threads, 0,
                     as_stream(stream)>>>(
      static_cast<const int*>(packed), static_cast<const int*>(m),
      static_cast<const float*>(attr), static_cast<float*>(out), s, r);
  return static_cast<int>(cudaGetLastError());
}
