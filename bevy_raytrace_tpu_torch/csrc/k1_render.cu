// K1 on Hopper: the whole-frame forward path tracer, one thread per lane.
//
// Replaces bevy_raytrace_tpu/kernels/mxu_render.py::_make_kernel (the TPU's
// v3 kernel, launched by render_mxu_lanes).  It computes what that kernel
// computes, written as plain SIMT rather than block by block:
//
//   * lane i renders the ABSOLUTE pixel id pids[i]; a permutation of pids
//     changes the schedule only, never a pixel, because every random number
//     is PCG4D(pixel, sample_base + s, stream, seed);
//   * for each sample: a thin-lens camera ray keyed on CAMERA_STREAM, then
//     up to max_depth rounds of (dense sweep over every sphere -> shade);
//   * the sweep (brt::sweep_nearest in common.cuh, which the rate probe V3
//     calls too) uses the centered half-b quadratic with near/far
//     root choice and valid = t > t_min (no t_max test).  The nearest hit
//     keeps a (best_t, best_idx) register pair, strict < in ascending
//     index order: the reference's first-wins tie rule, with no cap on the
//     sphere count.  The winner's t is then recomputed with an exact sqrt;
//   * Lambertian, metal (fuzz + below-horizon absorb) and dielectric (TIR +
//     Schlick); sky on a miss; depth exhaustion kills the path with black.
//     The camera ray, the sky and the scatter are common.cuh's, shared with
//     K2;
//   * radiance and the per-lane count of executed rounds (the cost map)
//     accumulate in registers in (sample, bounce) order, the TPU kernel's
//     order, and are written once.  The wrapper divides by spp.
//
// The schedule is the TPU kernel's persistent-lane refill: ONE loop over
// rounds per lane, with the lane's path state (sample s, bounce, o, d,
// throughput) in registers.  Each round a lane that needs a path generates
// sample s's camera ray, every live lane runs the sweep, then each lane
// shades, adds the sky or is absorbed; a lane whose path ended advances s in
// the same round, and leaves when s == spp.  So the sweep, nearly all of a
// round's work, runs on every lane that still has samples, instead of
// waiting at the end of a bounce loop for the warp's longest path: a lane
// idles only once its own samples are done, and balance_perm (pixels sorted
// by measured path length) narrows how far apart a warp's lanes finish.
// Each lane still walks its own samples and bounces in order, so the sums
// are added in the same order as a nested sample / bounce loop's, bit for
// bit.
//
// The chunk-culled traversal (k1_culled_kernel; the TPU kernel with
// n_cull > 0, its `plan=`): the rows arrive gathered into a cluster plan's
// Morton order, chunk c owning rows [c L, min((c + 1) L, S)), with
// members[row] its scene index, row_of its inverse, bounds[c] = (bx, by, bz,
// br^2) from the live geometry and the priority rows prio[k] (the K largest
// spheres).  Each round a lane
//   * takes t_ub, the nearest valid root among the priority rows and the row
//     of its previous winner (kept across rounds and refills, -1 = none,
//     the reference's r^2 = -1 dud), each by brt::sweep_root, the sweep's own
//     arithmetic, so t_ub never lands below the winner's t;
//   * tests its ray against every chunk's bounding sphere: a chunk is live
//     when the point of [t_min, t_ub] nearest the bound's center lies
//     inside it, widened by a slack for the member test's own rounding that
//     grows with the ray's squared distance to the bound and with the
//     chunk's factor, br / r_min at most (chunk_live; no root taken);
//   * gets the (t, scene index)-least valid root among the members of its
//     live chunks: the dense sweep's winner, tie rule included, since the
//     bound test is conservative against the member test (clusters.py
//     widens every radius; the slack covers the grazing hits the member
//     test's rounding takes just outside a small sphere).
// So the image and len are the dense kernel's bit for bit.  The member work
// is shared by the warp: the lanes vote on each chunk, their (chunk, lane)
// pairs go into a per-warp queue in shared memory, the warp's 32 threads
// sweep the pairs in strides, each with the owning lane's ray, and fold what
// they find into that lane's 64-bit (t's bits, scene index) key with one
// shared-memory atomicMin a pair.  A warp so sweeps each lane's own live
// chunks, 8.4 of the flagship's 41 a lane and round, where a per-thread cull
// walked the union of its 32 lanes' (about 26, PERF.md section 6).  The warp
// runs its rounds together: a thread whose own samples are done, or that
// lies past the lanes, stays in the loop to vote and sweep until the warp's
// last lane is done.  With live != nullptr each lane also writes its count
// of live chunks summed over its rounds; max_rounds > 0 ends a lane after
// that many rounds (the reference's probe cap, tools/livechunks.py).
//
// The sphere rows are staged in dynamic shared memory once a block
// (table_mode 1; the rate probe V3 ran the same loop 1.30x faster from
// there), before any thread may leave, and with them (culled) the bounds
// and the priority rows; tables larger than the plan allows
// (kernels/common.py::forward_table_plan, from brt_k1_table_bytes_limit and
// brt_k1_culled_table_bytes_limit) are read through the read-only cache
// (table_mode 0).  Both modes compute the same bits.
//
// Left out, as TPU devices: the bf16 limb split and one-hot MXU gather, the
// 10-bit packed (t|idx) key and its 1,024-sphere cap, f32 lane counters,
// v_planes/tile_rows/chunking, the culled loop's bit-mask words and its
// scalar-memory worklist, and the debug probes.
//
// What bounds it on an H100: fp32 issue in the sweep (about 20 flops per
// ray-sphere test), not bytes: the sphere table (16 B of geometry per
// sphere, read as one broadcast float4 load by the whole warp) stays in
// shared memory or L1/L2, and the only device-memory traffic is pids in and
// 16 B per lane out.  Lanes idle once their own samples are done;
// balance_perm sorts pixels by measured path length so a warp holds
// similar-cost pixels.  The culled kernel is bound the same way, by its
// bound tests (41 a round on the flagship, about 14 operations each, no
// root) and its live chunks' member tests, which read rows the warp's
// other threads may not (no broadcast), plus a vote, a prefix count and a
// store a live chunk and an atomicMin a pair.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3.  No
// --use_fast_math.  --fmad is left at its default (on): a*b+c contracts to
// fma, which flips rare borderline discrete choices against the PyTorch twin;
// the bench's compiled-parity thresholds absorb that.
//
// The sweep's update of (best_t, best) is two nested `if`s on purpose:
// written as one joint condition the same sweep runs 1.6x slower on the card
// with bit-identical output (a code-generation effect of nvcc 12; the two
// forms were built from one source and timed interleaved, PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
// The culled kernel's queue of (chunk, lane) pairs, per warp: it is swept
// whenever another chunk's votes might not fit, so any chunk count goes
// through it in passes.  512 holds a flagship round's ~270 pairs in one
// pass; 256 was 7% slower there (two passes, two ragged last strides) and
// 1,024 3% slower (PERF.md, section 6).
constexpr int kQueue = 512;
// Blocks of the culled kernel an SM must hold, for __launch_bounds__: at
// 8, ptxas keeps it in 64 registers with no spill; left to itself it took
// 48 registers and spilled 56 bytes in the staged instantiation, and at 7
// (72 registers) the flagship ran 4% slower (PERF.md, section 6).
constexpr int kCulledBlocks = 8;
// A lane's nearest-hit key before any pair of the round found a hit.
constexpr unsigned long long kNoHit = ~0ull;
// The bound test's slack for the member test's rounding, in units of
// u = 2^-24 (chunk_live derives it); kernels/render_lanes.py::CULL_SLACK
// mirrors it for the plain twin, and a CPU test holds the two equal.
#define BRT_K1_CULL_SLACK 32
constexpr float kSlack = BRT_K1_CULL_SLACK * 0x1p-24f;

// A table row: from shared memory (SMEM, staged once a block) or through
// the read-only cache.
template <bool SMEM>
__device__ __forceinline__ float4 row4(const float4* __restrict__ p, int i) {
  return SMEM ? p[i] : __ldg(p + i);
}

// A new path: sample s's camera ray (o, d) and throughput 1.  The camera
// and the pixel's coordinates are read or derived here, once a path, so
// they hold no register through the sweep.
__device__ __forceinline__ void start_path(
    const float* __restrict__ cam_in, int pid, uint32_t sample_base, int s,
    uint32_t seed, int width, int height, uint32_t& su, float (&o)[3],
    float (&d)[3], float& tp_r, float& tp_g, float& tp_b) {
  const brt::Cam c = brt::load_cam(cam_in);
  su = sample_base + static_cast<uint32_t>(s);
  uint32_t ca = static_cast<uint32_t>(pid), cb = su, cc = brt::CAMERA_STREAM,
           cd = seed;
  brt::pcg4d(ca, cb, cc, cd);
  brt::camera_ray(c, static_cast<float>(pid % width),
                  static_cast<float>(pid / width), static_cast<float>(width),
                  static_cast<float>(height), brt::to_unit(ca),
                  brt::to_unit(cb), brt::to_unit(cc), brt::to_unit(cd), o, d);
  tp_r = tp_g = tp_b = 1.f;
}

// The rest of a round, once its nearest hit `best` (a row, -1 on a miss)
// is known: the sky on a miss, else the winner's exact t, the hit frame
// and the scatter.  Returns whether the path ended (a miss, an absorbed
// scatter or depth exhaustion); else (o, d) is the next bounce's ray.
template <bool SMEM>
__device__ __forceinline__ bool shade(
    const float4* __restrict__ rows, const float4* __restrict__ geom,
    const float4* __restrict__ attr, int best, uint32_t upid, uint32_t su,
    uint32_t seed, int max_depth, float t_min, int& bounce, float (&o)[3],
    float (&d)[3], float& tp_r, float& tp_g, float& tp_b, float& acc_r,
    float& acc_g, float& acc_b) {
  bool ended = true;
  if (best < 0) {  // miss: sky, and the path ends
    float sk_r, sk_g;
    brt::sky(d[1], sk_r, sk_g);
    acc_r += tp_r * sk_r;
    acc_g += tp_g * sk_g;
    acc_b += tp_b;
  } else {
    // ---- exact t of the winner, hit frame ---------------------------------
    const float4 g = SMEM ? rows[best] : __ldg(geom + best);
    const float4 a0 = __ldg(attr + 2 * best);
    const float4 a1 = __ldg(attr + 2 * best + 1);
    const float rocx = o[0] - g.x, rocy = o[1] - g.y, rocz = o[2] - g.z;
    const float hb_r = rocx * d[0] + rocy * d[1] + rocz * d[2];
    const float cq_r = (rocx * rocx + rocy * rocy + rocz * rocz) - g.w;
    const float sq_r = sqrtf(fmaxf(hb_r * hb_r - cq_r, 0.f));
    const float rn_r = -hb_r - sq_r;
    const float bt = rn_r > t_min ? rn_r : sq_r - hb_r;
    const float h[3] = {o[0] + bt * d[0], o[1] + bt * d[1], o[2] + bt * d[2]};
    float n[3] = {(h[0] - g.x) * a0.x, (h[1] - g.y) * a0.x,
                  (h[2] - g.z) * a0.x};
    const bool front = (d[0] * n[0] + d[1] * n[1] + d[2] * n[2]) < 0.f;
    if (!front) {
      n[0] = -n[0];
      n[1] = -n[1];
      n[2] = -n[2];
    }
    // ---- shade: a fuzzed metal reflection below the surface is absorbed --
    uint32_t ba = upid, bb = su, bc = static_cast<uint32_t>(bounce), bd = seed;
    brt::pcg4d(ba, bb, bc, bd);
    float sdir[3];
    if (brt::scatter(d, n, front, a1.x, a1.y, a1.z, brt::to_unit(ba),
                     brt::to_unit(bb), brt::to_unit(bc), brt::to_unit(bd),
                     sdir)) {
      if (brt::is_lambertian(a1.x) || brt::is_metal(a1.x)) {  // glass: 1
        tp_r *= a0.y;
        tp_g *= a0.z;
        tp_b *= a0.w;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        o[k] = h[k];
        d[k] = sdir[k];
      }
      // Depth exhaustion kills the path with black.
      ended = ++bounce == max_depth;
    }
  }
  return ended;
}

// geom[i] = (cx, cy, cz, r^2); attr[2i] = (1/r, albedo r, g, b),
// attr[2i+1] = (kind, fuzz, ior, 0).  1/r keeps the radius sign (hollow glass).
// SMEM: geom is staged into dynamic shared memory before any thread leaves,
// and the sweep and the winner's row read it there.
template <bool SMEM>
__global__ void __launch_bounds__(kThreads)
    k1_render_kernel(const float4* __restrict__ geom,
                     const float4* __restrict__ attr, int n_spheres,
                     const float* __restrict__ cam_in,
                     const int* __restrict__ pids, int n_lanes,
                     float* __restrict__ fb, float* __restrict__ len_out,
                     uint32_t seed, uint32_t sample_base, int spp,
                     int max_depth, float t_min, int width, int height) {
  extern __shared__ float4 staged[];
  if (SMEM) {
    for (int j = threadIdx.x; j < n_spheres; j += kThreads)
      staged[j] = __ldg(geom + j);
    __syncthreads();
  }
  const float4* rows = SMEM ? staged : geom;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int pid = pids[lane];
  const uint32_t upid = static_cast<uint32_t>(pid);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, rounds = 0.f;
  // The lane's path: sample s, its bounce, ray (o, d) and throughput.
  int s = max_depth > 0 ? 0 : spp;  // depth 0: no round, black
  int bounce = 0;
  uint32_t su = 0;
  float o[3], d[3];
  float tp_r = 1.f, tp_g = 1.f, tp_b = 1.f;

  while (s < spp) {
    if (bounce == 0)
      start_path(cam_in, pid, sample_base, s, seed, width, height, su, o, d,
                 tp_r, tp_g, tp_b);
    rounds += 1.0f;
    // ---- nearest hit: first index wins ties ------------------------------
    float best_t;
    int best;
    brt::sweep_nearest<1, SMEM>(rows, n_spheres, o, d, t_min, best_t, best);
    if (shade<SMEM>(rows, geom, attr, best, upid, su, seed, max_depth, t_min,
                    bounce, o, d, tp_r, tp_g, tp_b, acc_r, acc_g, acc_b)) {
      ++s;  // the lane takes its next sample in the next round
      bounce = 0;
    }
  }
  fb[3 * lane + 0] = acc_r;
  fb[3 * lane + 1] = acc_g;
  fb[3 * lane + 2] = acc_b;
  len_out[lane] = rounds;
}

// ---- the chunk-culled traversal ------------------------------------------

// A warp's round: each lane's ray, each lane's nearest (t, scene index) key
// so far, and the (chunk, lane) pairs still to sweep.
struct WarpQueue {
  float4 o[32], d[32];
  unsigned long long key[32];
  int pairs[kQueue];
};

// t's bits in an order that ranks like the floats (no NaN reaches here;
// -0 is taken as +0, which it equals).
__device__ __forceinline__ uint32_t ordered(float t) {
  const uint32_t u = __float_as_uint(t + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// t_ub: the nearest valid root among the priority rows and the row `prev`
// of the lane's previous winner (-1 = none), each by brt::sweep_root, the
// sweep's own arithmetic, so t_ub never lands below the winner's t.
template <bool SMEM>
__device__ __forceinline__ float upper_bound(
    const float4* __restrict__ prio, int n_prio,
    const float4* __restrict__ rows, int prev, const float (&o)[3],
    const float (&d)[3], float t_min) {
  float t_ub = 1e30f;
  for (int k = 0; k < n_prio; ++k) {
    const float t = brt::sweep_root(row4<SMEM>(prio, k), o, d, t_min);
    if (t > t_min && t < t_ub) t_ub = t;  // NaN: no bound
  }
  if (prev >= 0) {
    const float t = brt::sweep_root(row4<SMEM>(rows, prev), o, d, t_min);
    if (t > t_min && t < t_ub) t_ub = t;
  }
  return t_ub;
}

// Whether the ray may meet a member of the chunk bounded by b = (bx, by,
// bz, br^2) with slack factor f in [t_min, t_ub]: whether the point of the
// segment nearest the bound's center, v = ob + t* d at t* = -hb clamped to
// [t_min, t_ub], passes |v|^2 <= br^2 + kSlack f (|v|^2 + hb^2).  For a
// unit d, |v|^2 + hb^2 = |ob|^2 + (t* + hb)^2 >= |ob|^2: the slack grows
// with the ray's squared distance to the bound, for two operations more.
// Without it this is the chord test (far root >= t_min, near root <= t_ub),
// closed at both ends, with no root taken.  f is clusters.py's per-chunk
// factor: 1 + max |c - b| / r over the chunk's members (times 1.0001), so
// f >= (|c - b| + r) / r for each member, f <= br / r_min, and f = 1 for a
// chunk of one sphere (b = c bit for bit).
//
// Why the slack (u = 2^-24; for a member (c, r^2) of the chunk, X = |oc|^2
// of the member test's rounded oc, h = oc . d exactly; |d|^2 = 1 + e with
// |e| <= 13 u from rsqrtf's 2 ulp and the normalization's rounding).  The
// member test (brt::sweep_root, sweep_nearest) takes a hit where its
// rounded disc = hb^2 - (|oc|^2 - r^2) is > 0, fma-contracted or not.  hb
// errs by at most 3 u |oc|, so hb^2 by 6 u X; hb*hb's own rounding (where
// not fused) by u X; |oc|^2 by 3 u X; the subtraction of r^2 by u X (or
// u r^2); the last rounding keeps disc's sign.  So a hit has Q = |oc|^2 -
// h^2 < r^2 + 11 u X: a grazing "hit" up to that far outside the sphere in
// squared miss distance, from a small sphere seen from afar (X large),
// which a bound test that rounds accurately would reject.
// At cluster size 1 the bound is its member: b = c bit for bit, so ob = oc
// bit for bit, f = 1, and fl(br^2) >= fl(r^2) (1 + 2e-4) by clusters.py's
// margin.
//   * t* = -hb unclamped: |v|^2 = Q + (hb - h)^2 + e t*^2 < r^2 + 24 u X.
//   * t* clamped: a member root t_f beyond t_ub cannot win (t_ub is a valid
//     root by the same arithmetic, brt::sweep_root), so t_f lies in (t_min,
//     t_ub] and t* between -hb and t_f; |v(t)|^2 is convex in t, so
//     |v(t*)|^2 <= max(|v(-hb)|^2, |v(t_f)|^2), and |v(t_f)|^2 = Q + (t_f +
//     h)^2 + e t_f^2, (t_f + h)^2 being the rounded root's square (disc (1 +
//     11 u)) plus hb's and t_f's rounding: < r^2 + 26.1 u X.
//   * |v|^2's own rounding is relative, (1 + 5 u) |v|^2, and the terms in
//     r^2 above add up to some 100 u r^2: all inside the margin's 2e-4 r^2.
// The slack's operand is >= X (1 - 25 u), so kSlack = 32 u makes the test
// conservative at cluster size 1 with 22% to spare; on grazing rays aimed
// at 2,000 seeded spheres 8 u already keeps every hit's chunk live and no
// slack does not (tests/test_torch_k1_cull.py).
// At any cluster size, for a member of radius r at g = |c - b| from the
// bound's center, m = g + r <= br / 1.0001, and a = |ob|, X_b = a^2:
//   * the bullets above, with the member as its own bound, give a t0 in
//     [t_min, t_ub] with |oc + t0 d|^2 < r^2 + 26.1 u X =: r^2 + D (t0 is
//     that test's clamped t*);
//   * ob = oc + (c - b) + n, |n| <= u (a + |oc|) (each subtraction rounds
//     its components), so |ob + t0 d| <= sqrt(r^2 + D) + g + |n|, and
//     (sqrt(r^2 + D) + g)^2 - m^2 = D (1 + 2 g / (sqrt(r^2 + D) + r)) <=
//     D m / r <= f D, for any D >= 0: the shell of the member test's
//     rounding around a member on the bound's rim widens the bound's
//     squared radius by f times it, by m / r where the member is r across;
//   * X <= 1.1 X_b + 11 g^2 (by |oc| <= a + g + |n|): so the segment's
//     least |ob + t d|^2 is < m^2 (1 + 2 u) + u X_b (28.71 f + 2.1) + u g^2
//     (287.1 f + 11), the last two from f D and from |n|;
//   * the test's own arithmetic, as at cluster size 1: t* = clamp(-hb)
//     lies within 16 u a of the exact least point (a u^2 X_b term), the
//     computed |v|^2 is (1 + 5 u) the exact one, and the slack's operand
//     is >= X_b (1 - 25 u).
// So the slack kSlack f X_b = 32 f u X_b covers the X_b term (30.81 f u X_b
// at most, with 3.7% to spare), and the g^2 term, at most 298.1 f u m^2,
// asks the bound's radius to grow with f: clusters.py widens br by 1 + 160
// u (f - 1) beyond its margin of 1.0001, which with the margin's 2e-4 m^2
// covers 320 u f m^2 and the relative roundings.  The widening is 1 at f =
// 1, so a chunk of one sphere keeps the bits of cluster size 1.  The
// factor is per chunk: a member far smaller than its chunk (on the SPD
// sphereflake, br / r_min up to 185 outside the ground's chunk) gets its
// chunk's slack scaled by up to that, and the rest of its chunks keep
// theirs.  tests/test_torch_k1_cull.py aims grazing rays at members 50-200x
// smaller than their chunk's bound: with f every hit keeps its chunk, with
// f = 1 some do not.
__device__ __forceinline__ bool chunk_live(const float4 b, float f,
                                           const float (&o)[3],
                                           const float (&d)[3], float t_min,
                                           float t_ub) {
  const float bx = o[0] - b.x, by = o[1] - b.y, bz = o[2] - b.z;
  const float hb =
      __fmaf_rn(bx, d[0], __fmaf_rn(by, d[1], __fmul_rn(bz, d[2])));
  const float ts = fminf(fmaxf(-hb, t_min), t_ub);
  const float vx = __fmaf_rn(ts, d[0], bx), vy = __fmaf_rn(ts, d[1], by),
              vz = __fmaf_rn(ts, d[2], bz);
  const float v2 = __fmaf_rn(vx, vx, __fmaf_rn(vy, vy, __fmul_rn(vz, vz)));
  return v2 <= __fmaf_rn(__fmul_rn(kSlack, f), __fmaf_rn(hb, hb, v2), b.w);
}

// A chunk's slack factor: from shared memory (SMEM) or the read-only cache.
template <bool SMEM>
__device__ __forceinline__ float factor_of(const float* __restrict__ p,
                                           int i) {
  return SMEM ? p[i] : __ldg(p + i);
}

// The warp sweeps the first `count` pairs of q in strides of 32: a thread
// takes a pair (chunk c, lane j), sweeps chunk c's rows with lane j's ray,
// and folds its (t, scene index)-least valid root into j's key with one
// atomicMin.  The lowest key is the dense sweep's winner: the least t, the
// lower scene index on a tie.  The row loop is the dense sweep's, with a
// flag for an exact tie instead of the scene-index compare, which would
// load members in the loop and keep the compiler from overlapping the
// rows' loads (11% of the flagship); a chunk with a tie is swept again
// with the compare.  The flag is a bool set in the update's else on
// purpose: as an unsigned, or set before the update, the same sweep ran 11%
// slower on the flagship and 17% at depth 1, with the same bits (PERF.md,
// section 6).
template <bool SMEM>
__device__ __forceinline__ void sweep_pairs(
    WarpQueue& q, int count, const float4* __restrict__ rows, int n_rows,
    int chunk, const int* __restrict__ members, float t_min) {
  for (int p = threadIdx.x & 31; p < count; p += 32) {
    const int pair = q.pairs[p];
    const int j = pair & 31, lo = (pair >> 5) * chunk;
    const float4 ro = q.o[j], rd = q.d[j];
    const float o[3] = {ro.x, ro.y, ro.z}, d[3] = {rd.x, rd.y, rd.z};
    const int hi = min(lo + chunk, n_rows);
    float best_t = 0.f;
    int best = -1;
    bool tie = false;
    for (int i = lo; i < hi; ++i) {
      const float tn = brt::sweep_root(row4<SMEM>(rows, i), o, d, t_min);
      if (tn > t_min) {
        if (best < 0 || tn < best_t) {
          best_t = tn;
          best = i;
        } else {
          tie |= tn == best_t;
        }
      }
    }
    if (best < 0) continue;
    int scene = __ldg(members + best);
    if (tie) {  // the dense sweep's tie rule: the lower scene index
      for (int i = lo; i < hi; ++i) {
        const int m = __ldg(members + i);
        if (m < scene &&
            brt::sweep_root(row4<SMEM>(rows, i), o, d, t_min) == best_t)
          scene = m;
      }
    }
    const unsigned long long key =
        static_cast<unsigned long long>(ordered(best_t)) << 32 |
        static_cast<uint32_t>(scene);
    if (key < *reinterpret_cast<volatile unsigned long long*>(&q.key[j]))
      atomicMin(&q.key[j], key);
  }
}

// K1 with the chunk-culled traversal: as k1_render_kernel, with the rows
// (geom, attr) in the plan's order, bounds [n_chunks] and their slack
// factors factor [n_chunks], members [n_spheres]
// (row -> scene index), row_of [n_spheres] (its inverse), prio [n_prio],
// live [n_lanes] or nullptr, max_rounds 0 or the rounds after which a lane
// stops.  A warp runs its rounds together: every thread stays in the loop
// until all 32 are done, and a thread past n_lanes, or done with its own
// samples, only votes and sweeps the others' pairs.  Each round
//   A. a lane that still has a path takes its t_ub (upper_bound) and tests
//      its ray against every chunk bound (chunk_live), 32 chunks at a time
//      into a bit mask, and adds its own live chunks to `live`; the warp
//      votes on each chunk that is live for any of its lanes and appends
//      the (chunk, lane) pairs to the warp's queue;
//   B. the warp sweeps the queue's pairs in strides (sweep_pairs), whenever
//      the next chunk's votes might not fit and at the end of the chunks;
//   C. each lane reads its key, the scene index -> its row (row_of), and
//      shades, as the dense kernel does.
// So the member work is each lane's own live chunks, spread over the warp,
// not the union of its lanes' live chunks that a per-thread cull walks.
// SMEM stages the rows, the bounds, the priority rows and the factors (four
// to a row), in that order.
template <bool SMEM>
__global__ void __launch_bounds__(kThreads, kCulledBlocks)
    k1_culled_kernel(const float4* __restrict__ geom,
                     const float4* __restrict__ attr, int n_spheres,
                     const float4* __restrict__ bounds,
                     const float* __restrict__ factor,
                     const int* __restrict__ members,
                     const int* __restrict__ row_of,
                     const float4* __restrict__ prio, int n_chunks, int chunk,
                     int n_prio, const float* __restrict__ cam_in,
                     const int* __restrict__ pids, int n_lanes,
                     float* __restrict__ fb, float* __restrict__ len_out,
                     float* __restrict__ live_out, uint32_t seed,
                     uint32_t sample_base, int spp, int max_depth, float t_min,
                     int width, int height, int max_rounds) {
  extern __shared__ float4 staged[];
  __shared__ WarpQueue queues[kWarps];
  if (SMEM) {
    for (int j = threadIdx.x; j < n_spheres; j += kThreads)
      staged[j] = __ldg(geom + j);
    for (int j = threadIdx.x; j < n_chunks; j += kThreads)
      staged[n_spheres + j] = __ldg(bounds + j);
    for (int j = threadIdx.x; j < n_prio; j += kThreads)
      staged[n_spheres + n_chunks + j] = __ldg(prio + j);
    float* fs = reinterpret_cast<float*>(staged + n_spheres + n_chunks +
                                         n_prio);
    for (int j = threadIdx.x; j < n_chunks; j += kThreads)
      fs[j] = __ldg(factor + j);
    __syncthreads();
  }
  const float4* rows = SMEM ? staged : geom;
  const float4* bnds = SMEM ? staged + n_spheres : bounds;
  const float4* prs = SMEM ? staged + n_spheres + n_chunks : prio;
  const float* fct =
      SMEM ? reinterpret_cast<const float*>(staged + n_spheres + n_chunks +
                                            n_prio)
           : factor;
  WarpQueue& q = queues[threadIdx.x >> 5];
  const int me = threadIdx.x & 31;
  const unsigned below = (1u << me) - 1u;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = lane < n_lanes;
  const int pid = mine ? pids[lane] : 0;
  const uint32_t upid = static_cast<uint32_t>(pid);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, rounds = 0.f, live = 0.f;
  int s = mine && max_depth > 0 ? 0 : spp;  // depth 0: no round, black
  int bounce = 0;
  uint32_t su = 0;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
  float tp_r = 1.f, tp_g = 1.f, tp_b = 1.f;
  int prev = -1;  // the row of the lane's last winner

  for (;;) {
    const bool on = s < spp && !(max_rounds > 0 &&
                                 rounds >= static_cast<float>(max_rounds));
    if (!__any_sync(kAll, on)) break;
    float t_ub = 0.f;
    if (on) {
      if (bounce == 0)
        start_path(cam_in, pid, sample_base, s, seed, width, height, su, o, d,
                   tp_r, tp_g, tp_b);
      rounds += 1.0f;
      t_ub = upper_bound<SMEM>(prs, n_prio, rows, prev, o, d, t_min);
      q.o[me] = make_float4(o[0], o[1], o[2], 0.f);
      q.d[me] = make_float4(d[0], d[1], d[2], 0.f);
    }
    q.key[me] = kNoHit;
    __syncwarp();
    // ---- A: the lanes' live chunks, as pairs; B: their sweep --------------
    int count = 0;
    for (int c0 = 0; c0 < n_chunks; c0 += 32) {
      // This lane's live chunks among the next 32, as bits: a loop with no
      // vote in it, so the bound tests overlap.
      unsigned mask = 0;
      if (on) {
        const int n = min(32, n_chunks - c0);
        for (int k = 0; k < n; ++k)
          if (chunk_live(row4<SMEM>(bnds, c0 + k),
                         factor_of<SMEM>(fct, c0 + k), o, d, t_min, t_ub))
            mask |= 1u << k;
        live += static_cast<float>(__popc(mask));
      }
      // The warp's pairs of those chunks, chunk by chunk, in lane order.
      for (unsigned any = __reduce_or_sync(kAll, mask); any != 0u;
           any &= any - 1u) {
        const int k = __ffs(any) - 1;
        const bool hit = (mask >> k) & 1u;
        const unsigned vote = __ballot_sync(kAll, hit);
        if (hit) q.pairs[count + __popc(vote & below)] = (c0 + k) << 5 | me;
        count += __popc(vote);
        if (count > kQueue - 32) {
          __syncwarp();
          sweep_pairs<SMEM>(q, count, rows, n_spheres, chunk, members, t_min);
          count = 0;
          __syncwarp();
        }
      }
    }
    __syncwarp();
    sweep_pairs<SMEM>(q, count, rows, n_spheres, chunk, members, t_min);
    __syncwarp();
    // ---- C: the winner's row, and the rest of the round -------------------
    if (on) {
      const unsigned long long key = q.key[me];
      const int best =
          key == kNoHit ? -1 : __ldg(row_of + static_cast<uint32_t>(key));
      if (best >= 0) prev = best;
      if (shade<SMEM>(rows, geom, attr, best, upid, su, seed, max_depth, t_min,
                      bounce, o, d, tp_r, tp_g, tp_b, acc_r, acc_g, acc_b)) {
        ++s;
        bounce = 0;
      }
    }
  }
  if (!mine) return;
  fb[3 * lane + 0] = acc_r;
  fb[3 * lane + 1] = acc_g;
  fb[3 * lane + 2] = acc_b;
  len_out[lane] = rounds;
  if (live_out != nullptr) live_out[lane] = live;
}

// Launches kernel<true> with n_rows staged rows (table_mode 1) or
// kernel<false> (table_mode 0) over n_lanes lanes.
template <typename Shared, typename Global, typename... Args>
int launch(Shared shared, Global global, int n_rows, int n_lanes,
           int table_mode, void* stream, Args... args) {
  if (n_lanes <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table_mode == 1) {
    size_t smem = 0;
    const cudaError_t err = brt::prepare_staged_launch(shared, n_rows, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    shared<<<blocks, kThreads, smem, st>>>(args...);
  } else {
    global<<<blocks, kThreads, 0, st>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most bytes of sphere rows K1 stages in shared memory while keeping
// min_blocks blocks resident on an SM (or as many as its registers allow, if
// fewer): see brt::table_bytes_limit.  Writes it to *out; returns a
// cudaError_t.  kernels/common.py::forward_table_plan reads it.
extern "C" int brt_k1_table_bytes_limit(int min_blocks, int* out) {
  return static_cast<int>(brt::table_bytes_limit(k1_render_kernel<true>,
                                                 kThreads, min_blocks, out));
}

// The same for the culled kernel, whose staged table holds the rows, the
// bounds and the priority rows (16 bytes each) and the bounds' factors (4
// bytes each), beside its warps' queues.
extern "C" int brt_k1_culled_table_bytes_limit(int min_blocks, int* out) {
  return static_cast<int>(brt::table_bytes_limit(k1_culled_kernel<true>,
                                                 kThreads, min_blocks, out));
}

// Launches K1 on `stream`.  Pointers are device pointers: geom [S] float4,
// attr [2S] float4, cam [16] float, pids [n_lanes] int32, fb [n_lanes, 3]
// and len [n_lanes] float sums over the spp samples.  table_mode: 1 = the
// rows staged in shared memory (16 x S bytes must fit what a block may take
// on the device), 0 = read through the read-only cache.  Returns the
// launch's cudaError_t, or cudaErrorInvalidValue for arguments it does not
// take; the kernel itself runs asynchronously.
extern "C" int brt_k1_render(const void* geom, const void* attr, int n_spheres,
                             const void* cam, const void* pids, int n_lanes,
                             void* fb, void* len, unsigned int seed,
                             unsigned int sample_base, int spp, int max_depth,
                             float t_min, int width, int height,
                             int table_mode, void* stream) {
  if (n_spheres < 1 || (table_mode != 0 && table_mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(k1_render_kernel<true>, k1_render_kernel<false>, n_spheres,
                n_lanes, table_mode, stream,
                static_cast<const float4*>(geom),
                static_cast<const float4*>(attr), n_spheres,
                static_cast<const float*>(cam), static_cast<const int*>(pids),
                n_lanes, static_cast<float*>(fb), static_cast<float*>(len),
                static_cast<uint32_t>(seed),
                static_cast<uint32_t>(sample_base), spp, max_depth, t_min,
                width, height);
}

// Launches the chunk-culled K1: as brt_k1_render, with geom and attr in the
// plan's order, bounds [n_chunks] float4 (bx, by, bz, br^2), factor
// [n_chunks] float (each bound's slack factor), members [S]
// int32 (row -> scene index, a permutation) and row_of [S] int32 (its
// inverse), prio [n_prio] float4 (cx, cy, cz, r^2), chunk >= 1 rows a chunk
// and n_chunks = ceil(S / chunk); live [n_lanes] float (each lane's live
// chunks summed over its rounds) or nullptr; max_rounds 0 or the rounds
// after which a lane stops.  table_mode 1 stages S + n_chunks + n_prio +
// ceil(n_chunks / 4) rows.
extern "C" int brt_k1_render_culled(
    const void* geom, const void* attr, int n_spheres, const void* bounds,
    const void* factor, const void* members, const void* row_of,
    const void* prio, int n_chunks,
    int chunk, int n_prio, const void* cam, const void* pids, int n_lanes,
    void* fb, void* len, void* live, unsigned int seed,
    unsigned int sample_base, int spp, int max_depth, float t_min, int width,
    int height, int max_rounds, int table_mode, void* stream) {
  if (n_spheres < 1 || (table_mode != 0 && table_mode != 1) || chunk < 1 ||
      n_chunks != (n_spheres + chunk - 1) / chunk || n_chunks > (1 << 26) ||
      n_prio < 0 || max_rounds < 0 || bounds == nullptr ||
      factor == nullptr || members == nullptr || row_of == nullptr ||
      (n_prio > 0 && prio == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(k1_culled_kernel<true>, k1_culled_kernel<false>,
                n_spheres + n_chunks + n_prio + (n_chunks + 3) / 4, n_lanes,
                table_mode, stream, static_cast<const float4*>(geom),
                static_cast<const float4*>(attr), n_spheres,
                static_cast<const float4*>(bounds),
                static_cast<const float*>(factor),
                static_cast<const int*>(members),
                static_cast<const int*>(row_of),
                static_cast<const float4*>(prio), n_chunks, chunk, n_prio,
                static_cast<const float*>(cam), static_cast<const int*>(pids),
                n_lanes, static_cast<float*>(fb), static_cast<float*>(len),
                static_cast<float*>(live), static_cast<uint32_t>(seed),
                static_cast<uint32_t>(sample_base), spp, max_depth, t_min,
                width, height, max_rounds);
}
