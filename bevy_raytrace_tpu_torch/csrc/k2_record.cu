// K2 on Hopper: the recording forward of the fast gradient path, one thread
// per pixel of the stripe.
//
// Replaces bevy_raytrace_tpu/kernels/pallas_render.py::_make_kernel (the
// TPU's v1 kernel, launched by render_pallas) in its with_residuals form.  It
// computes what that kernel computes:
//
//   * thread i < n_pix renders the ABSOLUTE pixel pixel_base + i (the v1
//     kernel's stripe mode, pixel_base / num_local): the RNG counters and
//     (px, py) come from the absolute id, img and the residuals are indexed
//     by the local i with stride n_pix.  A whole frame is pixel_base 0,
//     n_pix = width * height;
//   * for each sample s in order 0..spp-1: a thin-lens camera ray keyed on
//     (pixel, sample_base + s, CAMERA_STREAM, seed), then max_depth rounds of
//     (per-sphere loop -> shade);
//   * the per-sphere loop is the v1 kernel's EXPANDED quadratic (unit
//     direction, a == 1): half_b = o.d - c.d, cq = |o|^2 - 2 o.c + kq with
//     kq = |c|^2 - r^2 precomputed on the host, near root when > t_min else
//     far root, valid when t_min < t < t_max.  The nearest hit is updated
//     with a strict < in ascending sphere order (first index wins ties).  The
//     hit point uses that t as it is: unlike K1 there is no exact-t
//     recompute, so the image matches the JAX K2's, not K1's;
//   * with RECORD >= 1 the winner index of every (sample, bounce, pixel) is
//     stored in res[s, b, i] (-1 = miss, or a path already dead), and with
//     RECORD == 2 the runner-up in res2: the nearest other hit, by the v1
//     kernel's rule (a sphere that beats the winner demotes it to runner-up;
//     an exact tie with the current winner never becomes runner-up);
//   * Lambertian, metal and dielectric shading (common.cuh::scatter), sky on
//     a miss; each sample's radiance is added to the pixel's sum in sample
//     order, and the sum is divided by spp once, as the v1 kernel's
//     accumulation across its spp grid axis does.
//
//   * with a cluster plan the per-sphere loop is culled (the v1 kernel's
//     `clusters=` broad phase): the sphere rows arrive gathered into the
//     plan's Morton order, cluster c owning rows [c L, min((c + 1) L, S)),
//     and each bounce tests the ray against every cluster's bounding sphere
//     (bounds[c] = (bx, by, bz, |b|^2 - br^2), recomputed from live geometry
//     by the host for every launch) with the expanded quadratic: the cluster
//     is live when sqrt(hb^2 - cq) - hb > t_min (NaN compares false).  The
//     members go through the SAME per-sphere test as the brute-force loop
//     (test_sphere below), and the result is that of visiting the live
//     clusters' rows in Morton order, so it differs from the brute-force
//     loop only where two different spheres tie exactly (the first in
//     Morton order wins, not the first in scene order) or where a bound is
//     not conservative, which would be a bug.  Residuals store members[row],
//     the SCENE index, so the replay needs no plan.
//
// Two kernels on two schedules, chosen by the plan (or its absence):
//
// k2_record_kernel, the brute-force loop (no plan: config1's 3 spheres, and
// any scene under 32 spheres on the main path): for each sample, for each
// bounce, every sphere; a path that ended runs its remaining bounces as -1
// stores.  On a few spheres this beats a round loop: K4's, on K1's
// schedule, took 8.47 ms a render on 3 spheres where this loop took 2.86
// ms, and there is no cull for a warp to share (PERF.md).
//
// k2_record_kernel_culled, the culled traversal on culled K1's schedule
// (k1_render.cu's k1_culled_kernel):
//   * per-lane refill rounds: one loop over rounds per thread, with the
//     thread's path (sample s, bounce, o, d, throughput) in registers.  A
//     path that ends stores -1 into its remaining (s, b) slots of res and
//     res2, and the thread starts its next sample in the next round, as K4
//     does; so a thread waits for its warp only once its own samples are
//     done, not for the warp's longest path of every sample.  Each thread
//     still walks its own samples and bounces in order, so the image's sums
//     are added in the nested loop's order, bit for bit;
//   * the warp's (cluster, lane) pair queue: each round every lane with a
//     path runs the bound test above against every cluster (32 at a time,
//     into a bit mask, with no vote in the loop), the warp votes on each
//     cluster live for any lane and appends its (cluster, lane) pairs to a
//     per-warp queue in shared memory, and the warp's 32 threads sweep the
//     pairs in strides, each with its owning lane's ray (o, d, o.d and |o|^2
//     as that lane computed them) through test_sphere over the cluster's
//     rows.  A warp so sweeps each lane's own live clusters, where a
//     per-thread cull walked the union of its 32 lanes' live clusters.  The
//     warp runs its rounds together: a thread whose samples are done, or
//     that lies past the stripe, stays in the loop to vote and sweep until
//     its warp's last lane is done;
//   * the fold.  test_sphere's sequential rule over rows in ascending order
//     gives (by induction over the rows) the winner W = the least (t, row)
//     of the valid hits (t_min < t < t_max), and the runner-up R = the least
//     (t, row) whose t is strictly greater than W's: a row that ties the
//     winner's t never becomes the runner-up.  Both depend on the set of
//     valid hits alone, so the live clusters may be merged in any order.
//     Each pair's thread takes its cluster's own (w, r) from test_sphere
//     over the cluster's rows and folds them into its lane's two 64-bit keys
//     in shared memory, t's bits in an order that ranks like the floats and
//     then the ROW (the parent's loop breaks exact ties by visit order):
//     old = atomicMin(W, w); of w and old, the larger is a candidate for R
//     when its t is strictly greater than the smaller's (a displaced winner,
//     or a w that lost), and so is r; the least candidate goes into R by a
//     second atomicMin.  Every candidate's t exceeds the final W's, since W
//     only falls.  And the least hit above the final W's t, R*, is offered:
//     if it is some cluster's r, as r; if it is some cluster's w, it met a
//     lesser key in W (at its own atomic, or when a later key displaced
//     it), and that key's t is below R*'s, since an equal t would make that
//     key a lesser hit than R* above the final t.  So the keys end as the
//     parent's W and R, bit for bit, in any order of the atomics, and
//     members[row] maps a row to its scene index at the store.
// With live != nullptr each lane also writes its queued pairs and its
// rounds, each summed over the launch (live[i], live[n_pix + i]).
//
// The TPU kernel's cull is per tile: hit bits of 1024+ rays are OR-ed into
// bit-mask words, compacted into an SMEM worklist, and every ray of the tile
// walks every flagged cluster in unroll-sized blocks (hence its padded
// clusters).  Here the worklist is the warp's pair queue, and a lane's ray
// meets only its own live clusters.  No pad rows are visited.
//
// Left out, as TPU devices: the (tile_rows, 128) plane layout and unroll
// padding, skip_dead_tiles and the bit-mask words.
//
// What bounds it on an H100: fp32 issue in the sphere loop, as for K1, so
// the loop takes the root only where the discriminant allows a hit
// (test_sphere: an IEEE sqrtf on every test cost 1.33x in the rate probe
// V3, PERF.md) and both kernels read the table from shared memory, staged
// once a block (V3: 1.30x over __ldg).  The culled kernel issues its bound
// tests (a cluster each, with an IEEE sqrtf), its lanes' live clusters'
// member tests, which read rows the warp's other threads may not (no
// broadcast), and a vote, a queue store and up to two atomicMins a live
// cluster.  On the inverse cell's scene at L = 12 a lane-round queues 10.7
// of 41 clusters, where a per-thread cull walked 15.5 (PERF.md).  The
// residual stores are 2 (int16) or 4 (int32) bytes per (sample, bounce,
// pixel): the brute-force loop writes a warp's as one coalesced
// transaction; in the round loop a warp's threads sit at different (s, b),
// so a warp store is up to 32 scattered writes (K4, the same schedule: at
// most 1% at depth 8).  A -1 prefill of res and res2 (a memset) in place
// of the dead paths' stores gave K4 no steady gain for its bytes (3.9 GB at
// 1200x800x256x8), so the stores stay in the kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
// The culled kernel's queue of (cluster, lane) pairs, per warp: swept
// whenever another cluster's votes might not fit, so any cluster count goes
// through it in passes.  At the inverse cell's render 256 was 8.6% slower
// and 1,024 3.7% slower (PERF.md, section 6).
constexpr int kQueue = 512;
// Blocks of the culled kernel an SM must hold, for __launch_bounds__: at 8
// ptxas keeps it in 64 registers with no spill; 7 was 4.9% slower and 6
// 12.9% slower at the cell's render (PERF.md, section 6).
constexpr int kCulledBlocks = 8;
// A lane's key before any pair of the round found a hit.
constexpr unsigned long long kNoHit = ~0ull;

// The nearest hit (bt, bidx) and, with RECORD == 2, the runner-up (bt2,
// bidx2) of one bounce.
struct Nearest {
  float bt, bt2;
  int bidx, bidx2;
};

// One ray-sphere test of the expanded quadratic against row i, g =
// geom[i], folded into the nearest hit: strict <, so the first row visited
// wins an exact tie.  `tn != bt` keeps a row that ties the winner exactly
// from becoming its runner-up.  The root is taken only where the
// discriminant can give a hit: `disc >= 0`, so a tangent ray (disc == 0,
// sq = 0) is a hit, as in the TPU kernel and the twin, which take sqrt of
// every disc; a NaN or negative disc would give a NaN root that fails every
// compare, so skipping it changes no bit.  (K1's sweep tests disc > 0 and
// treats a tangency as a miss: the reference K1's rule, not K2's.)  The
// update is nested ifs: as one joint condition nvcc compiled K1's sweep
// 1.44-1.58x slower (PERF.md).  The runner-up compares exist only in the
// RECORD == 2 instantiation.
template <int RECORD>
__device__ __forceinline__ void test_sphere(const float4 g, int i,
                                            const float o[3], const float d[3],
                                            float o_dot_d, float o2,
                                            float t_min, Nearest& nh) {
  const float c_dot_d = g.x * d[0] + g.y * d[1] + g.z * d[2];
  const float o_dot_c = o[0] * g.x + o[1] * g.y + o[2] * g.z;
  const float half_b = o_dot_d - c_dot_d;
  const float cq = o2 - 2.0f * o_dot_c + g.w;
  const float disc = half_b * half_b - cq;
  if (disc >= 0.f) {
    const float sq = sqrtf(disc);
    const float rn = -half_b - sq;
    const float tn = rn > t_min ? rn : -half_b + sq;
    if (tn > t_min) {
      if (tn < nh.bt) {
        if (RECORD == 2) {
          nh.bt2 = nh.bt;
          nh.bidx2 = nh.bidx;
        }
        nh.bt = tn;
        nh.bidx = i;
      } else if (RECORD == 2) {
        if (tn < nh.bt2 && tn != nh.bt) {
          nh.bt2 = tn;
          nh.bidx2 = i;
        }
      }
    }
  }
}

// A table row: from shared memory (SMEM, staged once a block) or through
// the read-only cache.
template <bool SMEM>
__device__ __forceinline__ float4 row4(const float4* __restrict__ p, int i) {
  return SMEM ? p[i] : __ldg(p + i);
}

// The brute-force loop.  geom[i] = (cx, cy, cz, |c|^2 - r^2); attr[2i] =
// (1/r, albedo r, g, b), attr[2i+1] = (kind, fuzz, ior, 0).  SMEM: geom is
// staged into dynamic shared memory before any thread leaves, and the loop
// reads it there.
template <typename ResT, int RECORD, bool SMEM>
__global__ void __launch_bounds__(kThreads)
    k2_record_kernel(const float4* __restrict__ geom,
                     const float4* __restrict__ attr, int n_spheres,
                     const float* __restrict__ cam_in, int pixel_base,
                     int n_pix, float* __restrict__ img,
                     ResT* __restrict__ res,
                     ResT* __restrict__ res2, uint32_t seed,
                     uint32_t sample_base, int spp, int max_depth, float t_min,
                     float t_max, int width, int height) {
  extern __shared__ float4 staged[];
  if (SMEM) {
    for (int j = threadIdx.x; j < n_spheres; j += kThreads)
      staged[j] = __ldg(geom + j);
    __syncthreads();
  }
  const float4* rows = SMEM ? staged : geom;
  const int i_loc = blockIdx.x * blockDim.x + threadIdx.x;
  if (i_loc >= n_pix) return;
  const brt::Cam c = brt::load_cam(cam_in);
  const int pid = pixel_base + i_loc;
  const uint32_t upid = static_cast<uint32_t>(pid);
  const float px = static_cast<float>(pid % width);
  const float py = static_cast<float>(pid / width);
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;

  for (int s = 0; s < spp; ++s) {
    const uint32_t su = sample_base + static_cast<uint32_t>(s);
    uint32_t ca = upid, cb = su, cc = brt::CAMERA_STREAM, cd = seed;
    brt::pcg4d(ca, cb, cc, cd);
    float o[3], d[3];
    brt::camera_ray(c, px, py, fw, fh, brt::to_unit(ca), brt::to_unit(cb),
                    brt::to_unit(cc), brt::to_unit(cd), o, d);
    float tp_r = 1.f, tp_g = 1.f, tp_b = 1.f;
    float rad_r = 0.f, rad_g = 0.f, rad_b = 0.f;
    bool alive = true;

    for (int b = 0; b < max_depth; ++b) {
      const size_t slot =
          (static_cast<size_t>(s) * max_depth + b) * n_pix + i_loc;
      if (!alive) {
        if (RECORD >= 1) res[slot] = static_cast<ResT>(-1);
        if (RECORD == 2) res2[slot] = static_cast<ResT>(-1);
        continue;
      }
      // ---- per-sphere loop, expanded quadratic ---------------------------
      const float o_dot_d = o[0] * d[0] + o[1] * d[1] + o[2] * d[2];
      const float o2 = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
      Nearest nh = {t_max, t_max, -1, -1};
      for (int i = 0; i < n_spheres; ++i)
        test_sphere<RECORD>(row4<SMEM>(rows, i), i, o, d, o_dot_d, o2, t_min,
                            nh);
      const float bt = nh.bt;
      const int bidx = nh.bidx;
      const bool hit = bt < t_max;
      if (RECORD >= 1) res[slot] = static_cast<ResT>(hit ? bidx : -1);
      if (RECORD == 2) {
        const bool hit2 = hit && nh.bt2 < t_max;
        res2[slot] = static_cast<ResT>(hit2 ? nh.bidx2 : -1);
      }
      if (!hit) {  // sky, and the path ends
        float sk_r, sk_g;
        brt::sky(d[1], sk_r, sk_g);
        rad_r += tp_r * sk_r;
        rad_g += tp_g * sk_g;
        rad_b += tp_b;
        alive = false;
        continue;
      }
      // ---- hit frame and shading -----------------------------------------
      const float4 g = row4<SMEM>(rows, bidx);
      const float4 a0 = __ldg(attr + 2 * bidx);
      const float4 a1 = __ldg(attr + 2 * bidx + 1);
      const float h[3] = {o[0] + bt * d[0], o[1] + bt * d[1], o[2] + bt * d[2]};
      float n[3] = {(h[0] - g.x) * a0.x, (h[1] - g.y) * a0.x,
                    (h[2] - g.z) * a0.x};
      const bool front = (d[0] * n[0] + d[1] * n[1] + d[2] * n[2]) < 0.f;
      if (!front) {
        n[0] = -n[0];
        n[1] = -n[1];
        n[2] = -n[2];
      }
      uint32_t ba = upid, bb = su, bc = static_cast<uint32_t>(b), bd = seed;
      brt::pcg4d(ba, bb, bc, bd);
      float sdir[3];
      const bool ok = brt::scatter(d, n, front, a1.x, a1.y, a1.z,
                                   brt::to_unit(ba), brt::to_unit(bb),
                                   brt::to_unit(bc), brt::to_unit(bd), sdir);
      if (brt::is_lambertian(a1.x) || brt::is_metal(a1.x)) {  // glass: 1
        tp_r *= a0.y;
        tp_g *= a0.z;
        tp_b *= a0.w;
      }
      alive = ok;
      if (alive) {
        o[0] = h[0];
        o[1] = h[1];
        o[2] = h[2];
        d[0] = sdir[0];
        d[1] = sdir[1];
        d[2] = sdir[2];
      }
    }
    acc_r += rad_r;
    acc_g += rad_g;
    acc_b += rad_b;
  }
  const float fspp = static_cast<float>(spp);
  img[3 * i_loc + 0] = acc_r / fspp;
  img[3 * i_loc + 1] = acc_g / fspp;
  img[3 * i_loc + 2] = acc_b / fspp;
}

// ---- the culled traversal ------------------------------------------------

// A warp's round: each lane's ray as (o, o.d) and (d, |o|^2), each lane's
// winner and runner-up keys so far, and the (cluster, lane) pairs still to
// sweep.
struct WarpQueue {
  float4 o[32], d[32];
  unsigned long long key[32], key2[32];
  int pairs[kQueue];
};

// A hit's 64-bit key: t's bits in an order that ranks like the floats (a
// valid t is > t_min, so no NaN reaches here), then the row.
__device__ __forceinline__ unsigned long long hit_key(float t, int row) {
  const uint32_t u = __float_as_uint(t);
  const uint32_t k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return static_cast<unsigned long long>(k) << 32 | static_cast<uint32_t>(row);
}

// hit_key's t, bit for bit.
__device__ __forceinline__ float key_t(unsigned long long key) {
  const uint32_t k = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Folds one cluster's (w, r), test_sphere's result over its rows, into lane
// j's winner and runner-up keys (the header's argument).  A key that is not
// below the winner key as read skips the atomic: the value read is one the
// key held, which is all the argument needs.
template <int RECORD>
__device__ __forceinline__ void fold(WarpQueue& q, int j, const Nearest& nh) {
  const unsigned long long w = hit_key(nh.bt, nh.bidx);
  unsigned long long old =
      *reinterpret_cast<volatile unsigned long long*>(&q.key[j]);
  if (w < old) old = atomicMin(&q.key[j], w);
  if (RECORD == 2) {
    const unsigned long long lo = w < old ? w : old, hi = w < old ? old : w;
    unsigned long long cand = (hi >> 32) != (lo >> 32) ? hi : kNoHit;
    if (nh.bidx2 >= 0) {
      const unsigned long long r = hit_key(nh.bt2, nh.bidx2);
      if (r < cand) cand = r;
    }
    if (cand < *reinterpret_cast<volatile unsigned long long*>(&q.key2[j]))
      atomicMin(&q.key2[j], cand);
  }
}

// The warp sweeps the first `count` pairs of q in strides of 32: a thread
// takes a pair (cluster c, lane j), runs test_sphere over cluster c's rows
// with lane j's ray, and folds what it found into j's keys.
template <int RECORD, bool SMEM>
__device__ __forceinline__ void sweep_pairs(WarpQueue& q, int count,
                                            const float4* __restrict__ rows,
                                            int n_rows, int cluster_size,
                                            float t_min, float t_max) {
  for (int p = threadIdx.x & 31; p < count; p += 32) {
    const int pair = q.pairs[p];
    const int j = pair & 31, lo = (pair >> 5) * cluster_size;
    const float4 ro = q.o[j], rd = q.d[j];
    const float o[3] = {ro.x, ro.y, ro.z}, d[3] = {rd.x, rd.y, rd.z};
    const int hi = min(lo + cluster_size, n_rows);
    Nearest nh = {t_max, t_max, -1, -1};
    for (int i = lo; i < hi; ++i)
      test_sphere<RECORD>(row4<SMEM>(rows, i), i, o, d, ro.w, rd.w, t_min,
                          nh);
    if (nh.bidx >= 0) fold<RECORD>(q, j, nh);
  }
}

// The culled K2: as k2_record_kernel, with the rows (geom, attr) in the
// plan's order, bounds [n_clusters] and members [n_spheres] (row -> scene
// index); live [2 n_pix] int32 or nullptr.  Each round
//   A. a lane with a path takes its ray's o.d and |o|^2, tests the ray
//      against every cluster bound, 32 at a time into a bit mask, and the
//      warp votes on each cluster live for any of its lanes and appends the
//      (cluster, lane) pairs to the warp's queue;
//   B. the warp sweeps the queue (sweep_pairs) whenever the next cluster's
//      votes might not fit, and at the end of the clusters;
//   C. each lane reads its keys, stores the winner's and the runner-up's
//      scene index, and shades, or adds the sky, as the brute-force loop
//      does; a path that ended stores -1 into its later bounces.
// SMEM stages the rows and the bounds, in that order.
template <typename ResT, int RECORD, bool SMEM>
__global__ void __launch_bounds__(kThreads, kCulledBlocks)
    k2_record_kernel_culled(
        const float4* __restrict__ geom, const float4* __restrict__ attr,
        int n_spheres, const float4* __restrict__ bounds,
        const int* __restrict__ members, int n_clusters, int cluster_size,
        const float* __restrict__ cam_in, int pixel_base, int n_pix,
        float* __restrict__ img, ResT* __restrict__ res,
        ResT* __restrict__ res2, int* __restrict__ live_out, uint32_t seed,
        uint32_t sample_base, int spp, int max_depth, float t_min,
        float t_max, int width, int height) {
  extern __shared__ float4 staged[];
  __shared__ WarpQueue queues[kWarps];
  if (SMEM) {
    for (int j = threadIdx.x; j < n_spheres; j += kThreads)
      staged[j] = __ldg(geom + j);
    for (int j = threadIdx.x; j < n_clusters; j += kThreads)
      staged[n_spheres + j] = __ldg(bounds + j);
    __syncthreads();
  }
  const float4* rows = SMEM ? staged : geom;
  const float4* bnds = SMEM ? staged + n_spheres : bounds;
  WarpQueue& q = queues[threadIdx.x >> 5];
  const int me = threadIdx.x & 31;
  const unsigned below = (1u << me) - 1u;
  const int i_loc = blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = i_loc < n_pix;
  const int pid = pixel_base + (mine ? i_loc : 0);
  const uint32_t upid = static_cast<uint32_t>(pid);
  const size_t stride = static_cast<size_t>(n_pix);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  int pairs = 0, rounds = 0;
  // The thread's path: sample s, its bounce, ray (o, d) and throughput;
  // slot indexes res[s, bounce, i_loc].
  int s = mine && max_depth > 0 ? 0 : spp;  // depth 0: no round, black
  int bounce = 0;
  uint32_t su = 0;
  size_t slot = 0;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
  float tp_r = 1.f, tp_g = 1.f, tp_b = 1.f;

  for (;;) {
    const bool on = s < spp;
    if (!__any_sync(kAll, on)) break;
    float o_dot_d = 0.f, o2 = 0.f;
    if (on) {
      if (bounce == 0) {  // a new path: sample s's camera ray
        // The camera and the pixel's coordinates are read or derived here,
        // once a path, so they hold no register through the sweep.
        const brt::Cam c = brt::load_cam(cam_in);
        su = sample_base + static_cast<uint32_t>(s);
        uint32_t ca = upid, cb = su, cc = brt::CAMERA_STREAM, cd = seed;
        brt::pcg4d(ca, cb, cc, cd);
        brt::camera_ray(c, static_cast<float>(pid % width),
                        static_cast<float>(pid / width),
                        static_cast<float>(width), static_cast<float>(height),
                        brt::to_unit(ca), brt::to_unit(cb), brt::to_unit(cc),
                        brt::to_unit(cd), o, d);
        tp_r = tp_g = tp_b = 1.f;
        slot = static_cast<size_t>(s) * max_depth * stride + i_loc;
      }
      ++rounds;
      o_dot_d = o[0] * d[0] + o[1] * d[1] + o[2] * d[2];
      o2 = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
      q.o[me] = make_float4(o[0], o[1], o[2], o_dot_d);
      q.d[me] = make_float4(d[0], d[1], d[2], o2);
    }
    Nearest nh = {t_max, t_max, -1, -1};
    q.key[me] = kNoHit;
    if (RECORD == 2) q.key2[me] = kNoHit;
    __syncwarp();
    // ---- A: the lanes' live clusters, as pairs; B: their sweep ------------
    int count = 0;
    for (int c0 = 0; c0 < n_clusters; c0 += 32) {
      // This lane's live clusters among the next 32, as bits: a loop with
      // no vote in it, so the bound tests overlap.
      unsigned mask = 0;
      if (on) {
        const int n = min(32, n_clusters - c0);
        for (int k = 0; k < n; ++k) {
          const float4 bs = row4<SMEM>(bnds, c0 + k);
          const float c_dot_d = bs.x * d[0] + bs.y * d[1] + bs.z * d[2];
          const float o_dot_c = o[0] * bs.x + o[1] * bs.y + o[2] * bs.z;
          const float hb = o_dot_d - c_dot_d;
          const float cq = o2 - 2.0f * o_dot_c + bs.w;
          const float rfar = sqrtf(hb * hb - cq) - hb;
          if (rfar > t_min) mask |= 1u << k;  // NaN: the ray misses it
        }
        pairs += __popc(mask);
      }
      // The warp's pairs of those clusters, cluster by cluster, in lane
      // order.
      for (unsigned any = __reduce_or_sync(kAll, mask); any != 0u;
           any &= any - 1u) {
        const int k = __ffs(any) - 1;
        const bool hit = (mask >> k) & 1u;
        const unsigned vote = __ballot_sync(kAll, hit);
        if (hit) q.pairs[count + __popc(vote & below)] = (c0 + k) << 5 | me;
        count += __popc(vote);
        if (count > kQueue - 32) {
          __syncwarp();
          sweep_pairs<RECORD, SMEM>(q, count, rows, n_spheres, cluster_size,
                                    t_min, t_max);
          count = 0;
          __syncwarp();
        }
      }
    }
    __syncwarp();
    sweep_pairs<RECORD, SMEM>(q, count, rows, n_spheres, cluster_size, t_min,
                              t_max);
    __syncwarp();
    if (on) {
      const unsigned long long key = q.key[me];
      if (key != kNoHit) {
        nh.bt = key_t(key);
        nh.bidx = static_cast<int>(static_cast<uint32_t>(key));
      }
      if (RECORD == 2) {
        const unsigned long long key2 = q.key2[me];
        if (key2 != kNoHit)
          nh.bidx2 = static_cast<int>(static_cast<uint32_t>(key2));
      }
    }
    if (!on) continue;
    // ---- C: the residuals, and the rest of the round ----------------------
    const float bt = nh.bt;
    const int bidx = nh.bidx;
    const bool hit = bidx >= 0;
    if (RECORD >= 1)
      res[slot] = static_cast<ResT>(hit ? __ldg(members + bidx) : -1);
    if (RECORD == 2)
      res2[slot] = static_cast<ResT>(
          hit && nh.bidx2 >= 0 ? __ldg(members + nh.bidx2) : -1);
    bool ended = true;
    if (!hit) {  // sky, and the path ends
      float sk_r, sk_g;
      brt::sky(d[1], sk_r, sk_g);
      // Rounded products, as the brute-force loop adds them into a zero
      // radiance before its sample's sum: no fma into the sum.
      acc_r += __fmul_rn(tp_r, sk_r);
      acc_g += __fmul_rn(tp_g, sk_g);
      acc_b += tp_b;
    } else {
      // ---- hit frame and shading ------------------------------------------
      const float4 g = row4<SMEM>(rows, bidx);
      const float4 a0 = __ldg(attr + 2 * bidx);
      const float4 a1 = __ldg(attr + 2 * bidx + 1);
      const float h[3] = {o[0] + bt * d[0], o[1] + bt * d[1], o[2] + bt * d[2]};
      float n[3] = {(h[0] - g.x) * a0.x, (h[1] - g.y) * a0.x,
                    (h[2] - g.z) * a0.x};
      const bool front = (d[0] * n[0] + d[1] * n[1] + d[2] * n[2]) < 0.f;
      if (!front) {
        n[0] = -n[0];
        n[1] = -n[1];
        n[2] = -n[2];
      }
      uint32_t ba = upid, bb = su, bc = static_cast<uint32_t>(bounce),
               bd = seed;
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
        // Depth exhaustion ends the path with black.
        ended = ++bounce == max_depth;
        slot += stride;
      }
    }
    if (ended) {
      // ---- the ended path's later bounces: -1 -----------------------------
      if (RECORD >= 1) {
        for (int b = bounce + 1; b < max_depth; ++b) {
          slot += stride;
          res[slot] = static_cast<ResT>(-1);
          if (RECORD == 2) res2[slot] = static_cast<ResT>(-1);
        }
      }
      ++s;  // the thread takes its next sample in the next round
      bounce = 0;
    }
  }
  if (!mine) return;
  const float fspp = static_cast<float>(spp);
  img[3 * i_loc + 0] = acc_r / fspp;
  img[3 * i_loc + 1] = acc_g / fspp;
  img[3 * i_loc + 2] = acc_b / fspp;
  if (live_out != nullptr) {
    live_out[i_loc] = pairs;
    live_out[n_pix + i_loc] = rounds;
  }
}

// Launches kernel<true> (`shared`) with n_rows rows staged in dynamic shared
// memory when they fit what a block may take beside the kernel's static
// shared memory, else kernel<false> (`global`), over n_pix threads.
template <typename Shared, typename Global, typename... Args>
int launch(Shared shared, Global global, int n_rows, int n_pix,
           cudaStream_t stream, Args... args) {
  int max_bytes = 0;
  cudaError_t err = brt::dynamic_smem_max(shared, &max_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  if (sizeof(float4) * static_cast<size_t>(n_rows) <=
      static_cast<size_t>(max_bytes)) {
    size_t smem = 0;
    err = brt::prepare_staged_launch(shared, n_rows, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    shared<<<blocks, kThreads, smem, stream>>>(args...);
  } else {
    global<<<blocks, kThreads, 0, stream>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename ResT, int RECORD>
int launch_record(const void* geom, const void* attr, int n_spheres,
                  const void* bounds, const void* members, int n_clusters,
                  int cluster_size, const void* cam, int pixel_base, int n_pix,
                  void* img, void* res, void* res2, void* live, uint32_t seed,
                  uint32_t sample_base, int spp, int max_depth, float t_min,
                  float t_max, int width, int height, cudaStream_t stream) {
  const auto g = static_cast<const float4*>(geom);
  const auto a = static_cast<const float4*>(attr);
  const auto c = static_cast<const float*>(cam);
  const auto out = static_cast<float*>(img);
  const auto r = static_cast<ResT*>(res);
  const auto r2 = static_cast<ResT*>(res2);
  if (bounds == nullptr)
    return launch(k2_record_kernel<ResT, RECORD, true>,
                  k2_record_kernel<ResT, RECORD, false>, n_spheres, n_pix,
                  stream, g, a, n_spheres, c, pixel_base, n_pix, out, r, r2,
                  seed, sample_base, spp, max_depth, t_min, t_max, width,
                  height);
  return launch(k2_record_kernel_culled<ResT, RECORD, true>,
                k2_record_kernel_culled<ResT, RECORD, false>,
                n_spheres + n_clusters, n_pix, stream, g, a, n_spheres,
                static_cast<const float4*>(bounds),
                static_cast<const int*>(members), n_clusters, cluster_size, c,
                pixel_base, n_pix, out, r, r2, static_cast<int*>(live), seed,
                sample_base, spp, max_depth, t_min, t_max, width, height);
}

}  // namespace

// Launches K2 on `stream`.  Device pointers: geom [S] float4, attr [2S]
// float4, cam [16] float, img [n_pix, 3] float (the mean over spp), res and
// res2 [spp, max_depth, n_pix] of res_bytes (2: int16, 4: int32) each.
// record: 0 = image only (res, res2 unused), 1 = res, 2 = res and res2.
// Thread i renders the absolute pixel pixel_base + i.
// bounds != nullptr selects the culled kernel: geom/attr rows are then in
// the plan's order, bounds is [n_clusters] float4, members [n_spheres]
// int32 (row -> scene index), cluster_size >= 1 the rows per cluster and
// n_clusters = ceil(n_spheres / cluster_size); live is nullptr or [2, n_pix]
// int32 (each pixel's queued pairs, then its rounds); otherwise the five
// are unused and live must be nullptr.  The sphere rows (and bounds) are
// staged in shared memory when they fit what a block may take on the device
// beside the kernel's static shared memory (16 bytes a row: ~14,500 rows on
// an H100, ~13,600 for the culled kernel), else read through the read-only
// cache: a size path, both the kernel.
// Returns the launch's cudaError_t, or cudaErrorInvalidValue for arguments
// it does not take; the kernel itself runs asynchronously.
extern "C" int brt_k2_record(const void* geom, const void* attr,
                             int n_spheres, const void* bounds,
                             const void* members, int n_clusters,
                             int cluster_size, const void* cam, int pixel_base,
                             int n_pix, void* img, void* res, void* res2,
                             int res_bytes, int record, unsigned int seed,
                             unsigned int sample_base, int spp, int max_depth,
                             float t_min, float t_max, int width, int height,
                             void* live, void* stream) {
  if (n_pix <= 0) return static_cast<int>(cudaSuccess);
  const bool clustered = bounds != nullptr;
  const bool bad_plan =
      members == nullptr || cluster_size < 1 || n_clusters > (1 << 26) ||
      n_clusters != (n_spheres + cluster_size - 1) / cluster_size;
  if (clustered ? bad_plan : live != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
#define BRT_K2_LAUNCH(T, R)                                                  \
  return launch_record<T, R>(geom, attr, n_spheres, bounds, members,         \
                             n_clusters, cluster_size, cam, pixel_base,      \
                             n_pix, img, res, res2, live, seed, sample_base, \
                             spp, max_depth, t_min, t_max, width, height,    \
                             static_cast<cudaStream_t>(stream))
  if (record == 0) BRT_K2_LAUNCH(int16_t, 0);
  if (res_bytes == 2 && record == 1) BRT_K2_LAUNCH(int16_t, 1);
  if (res_bytes == 2 && record == 2) BRT_K2_LAUNCH(int16_t, 2);
  if (res_bytes == 4 && record == 1) BRT_K2_LAUNCH(int32_t, 1);
  if (res_bytes == 4 && record == 2) BRT_K2_LAUNCH(int32_t, 2);
#undef BRT_K2_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
