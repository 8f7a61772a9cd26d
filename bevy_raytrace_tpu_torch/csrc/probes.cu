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
// What bounds them on an H100: bytes, all five (the largest, P2, writes 4 MB;
// P4 and P5 read 2 MB).  At these shapes (1,024 lanes or columns) none comes
// near that bound: each is a few microseconds of latency, and a launch costs
// about as much.  P1-P3 take a thread per lane or element; P4 and P5 spread
// their rows over R / 8 blocks, 128 at the tool's shape, 32 rows a thread
// (below).  They are probes of constructs, not of rates; the rate probes are
// in fp32_probe.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, no
// --use_fast_math, --fmad at its default (a*b+c contracts to fma).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// ---- P1 ---------------------------------------------------------------------
// One block, one thread per lane.  The loop runs while ANY lane is alive:
// __syncthreads_or is both the block-wide vote and the barrier, so every
// thread reaches it in every round, dead or not.  As in the TPU kernel a dead
// lane's carries a and b go on updating until the last lane has died; only
// `alive` is sticky.  K1 (k1_render.cu) replaced this block-wide loop by a
// per-thread `break`; P1 measures the alternative it did not take.
constexpr int kP1Lanes = 1024;

__global__ void __launch_bounds__(kP1Lanes)
    p1_while_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int* __restrict__ rounds_out) {
  const int lane = threadIdx.x;
  float a = x[lane];
  float b = a * 2.0f;
  int alive = 1;
  int rounds = 0;
  while (__syncthreads_or(alive)) {
    a = a + 1.0f;
    b = b * 1.01f + a * 0.001f;
    alive = alive && (a < 50.0f);
    ++rounds;
  }
  out[lane] = b + static_cast<float>(rounds);
  if (lane == 0) *rounds_out = rounds;
}

// ---- P2 ---------------------------------------------------------------------
// c[M, N] = a[M, K] @ b[K, N] in float32: a block computes a 64 x 64 tile of
// c from shared-memory tiles of a and b, 16 of K at a time, each thread a 4 x
// 4 patch with plain fmaf (wgmma has no float32 input type, only TF32).  A
// thread's four columns are 16 apart, so a half-warp's stores cover 64
// consecutive bytes.  With K = 16 the product writes 64 times the bytes it
// reads: the stores bound it.
constexpr int kP2Tile = 64;
constexpr int kP2K = 16;

__global__ void __launch_bounds__(256)
    p2_dot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int m, int n, int k) {
  __shared__ float as[kP2K][kP2Tile + 1];  // as[kk][row], padded
  __shared__ float bs[kP2K][kP2Tile];      // bs[kk][col]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kP2Tile, col0 = blockIdx.x * kP2Tile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kP2K) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256;
      as[e % kP2K][e / kP2K] =
          a[static_cast<size_t>(row0 + e / kP2K) * k + k0 + e % kP2K];
      bs[e / kP2Tile][e % kP2Tile] =
          b[static_cast<size_t>(k0 + e / kP2Tile) * n + col0 + e % kP2Tile];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kP2K; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[kk][ty * 4 + i];
        bv[i] = bs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[static_cast<size_t>(row0 + ty * 4 + i) * n + col0 + tx + 16 * j] =
          acc[i][j];
}

// ---- P3 ---------------------------------------------------------------------
// [rows, 128] -> [1, rows * 128], times 2, and back.  A row-major reshape
// moves nothing on a GPU, so the round trip is one elementwise pass that reads
// through the [rows, 128] index map and writes through the flat one and back.
__global__ void __launch_bounds__(128)
    p3_reshape_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int rows) {
  const int flat = blockIdx.x * blockDim.x + threadIdx.x;  // index in [1, n]
  if (flat >= rows * 128) return;
  const int r = flat / 128, c = flat % 128;  // index in [rows, 128]
  out[r * 128 + c] = x[r * 128 + c] * 2.0f;
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

// x [1024] float -> out [1024] float, rounds [1] int32.
extern "C" int brt_p1_while(const void* x, void* out, void* rounds,
                            void* stream) {
  p1_while_kernel<<<1, kP1Lanes, 0, as_stream(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<int*>(rounds));
  return static_cast<int>(cudaGetLastError());
}

// a [m, k], b [k, n] -> c [m, n]; m and n multiples of 64, k of 16.
extern "C" int brt_p2_dot(const void* a, const void* b, void* c, int m, int n,
                          int k, void* stream) {
  if (m % kP2Tile || n % kP2Tile || k % kP2K || m <= 0 || n <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p2_dot_kernel<<<dim3(n / kP2Tile, m / kP2Tile), 256, 0, as_stream(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// x [rows, 128] -> out [rows, 128].
extern "C" int brt_p3_reshape(const void* x, void* out, int rows,
                              void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  p3_reshape_kernel<<<rows, 128, 0, as_stream(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows);
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
