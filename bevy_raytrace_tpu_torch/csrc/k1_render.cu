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
// The chunk-culled traversal (CULLED; the TPU kernel with n_cull > 0, its
// `plan=`): the rows arrive gathered into a cluster plan's Morton order,
// chunk c owning rows [c L, min((c + 1) L, S)), with members[row] its scene
// index, bounds[c] = (bx, by, bz, br^2) from the live geometry and the
// priority rows prio[k] (the K largest spheres).  Each round a lane
//   * takes t_ub, the nearest valid root among the priority rows and the row
//     of its previous winner (kept across rounds and refills, -1 = none,
//     the reference's r^2 = -1 dud), each by brt::sweep_root, the sweep's own
//     arithmetic, so t_ub never lands below the winner's t;
//   * tests its ray against every chunk's bounding sphere, each operation
//     rounded on its own (no contraction); a chunk is live when far > t_min
//     and near <= t_ub (<=: a tight bound's near root can round onto t_ub);
//   * sweeps the members of the live chunks only, keeping the (t, scene
//     index)-least valid root: the dense sweep's winner, tie rule included,
//     since the bounds are conservative (clusters.py widens every radius).
// So the image and len are the dense kernel's bit for bit.  The cull is per
// thread, as K2's port does it: a lane skips a chunk its own ray misses and
// the warp's divergence does what the TPU kernel's tile-wide worklist did;
// no pad row is visited.  With live != nullptr each lane also writes its
// count of live chunks summed over its rounds; max_rounds > 0 ends a lane
// after that many rounds (the reference's probe cap, tools/livechunks.py).
//
// The sphere rows are staged in dynamic shared memory once a block
// (table_mode 1; the rate probe V3 ran the same loop 1.30x faster from
// there), before any thread may leave, and with them (CULLED) the bounds and
// the priority rows; tables larger than the plan allows
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
// similar-cost pixels.
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

// A table row: from shared memory (SMEM, staged once a block) or through
// the read-only cache.
template <bool SMEM>
__device__ __forceinline__ float4 row4(const float4* __restrict__ p, int i) {
  return SMEM ? p[i] : __ldg(p + i);
}

// The culled nearest hit of the ray (o, d) -> (best_t, best), best the ROW
// (-1 on a miss); adds the round's live chunks to `live`.  rows [n_rows] in
// the plan's order, bnds [n_chunks], prio [n_prio], prev the row of the
// lane's previous winner or -1.
template <bool SMEM>
__device__ __forceinline__ void culled_nearest(
    const float4* __restrict__ rows, int n_rows,
    const float4* __restrict__ bnds, int n_chunks, int chunk,
    const int* __restrict__ members, const float4* __restrict__ prio,
    int n_prio, int prev, const float (&o)[3], const float (&d)[3],
    float t_min, float& best_t, int& best, float& live) {
  float t_ub = 1e30f;
  for (int k = 0; k < n_prio; ++k) {
    const float t = brt::sweep_root(row4<SMEM>(prio, k), o, d, t_min);
    if (t > t_min && t < t_ub) t_ub = t;  // NaN: no bound
  }
  if (prev >= 0) {
    const float t = brt::sweep_root(row4<SMEM>(rows, prev), o, d, t_min);
    if (t > t_min && t < t_ub) t_ub = t;
  }
  best_t = 0.f;
  best = -1;
  for (int c = 0; c < n_chunks; ++c) {
    const float4 b = row4<SMEM>(bnds, c);
    const float bx = __fsub_rn(o[0], b.x), by = __fsub_rn(o[1], b.y),
                bz = __fsub_rn(o[2], b.z);
    const float bhb = __fadd_rn(__fadd_rn(__fmul_rn(bx, d[0]),
                                          __fmul_rn(by, d[1])),
                                __fmul_rn(bz, d[2]));
    const float bcq = __fsub_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(bx, bx), __fmul_rn(by, by)),
                  __fmul_rn(bz, bz)),
        b.w);
    const float disc = __fsub_rn(__fmul_rn(bhb, bhb), bcq);
    // A ray that misses the bound (disc < 0, or NaN) takes no root: the
    // root's NaN would fail both compares anyway, and a negative argument
    // sends an IEEE square root down its slow path.
    if (!(disc >= 0.f)) continue;
    const float bsq = __fsqrt_rn(disc);
    if (!(__fsub_rn(bsq, bhb) > t_min && __fsub_rn(-bhb, bsq) <= t_ub))
      continue;
    live += 1.f;
    const int hi = min(c * chunk + chunk, n_rows);
    for (int i = c * chunk; i < hi; ++i) {
      const float tn = brt::sweep_root(row4<SMEM>(rows, i), o, d, t_min);
      if (tn > t_min) {
        if (best < 0 || tn < best_t) {
          best_t = tn;
          best = i;
        } else if (tn == best_t && __ldg(members + i) < __ldg(members + best)) {
          best = i;  // the dense sweep's tie rule: the lower scene index
        }
      }
    }
  }
}

// geom[i] = (cx, cy, cz, r^2); attr[2i] = (1/r, albedo r, g, b),
// attr[2i+1] = (kind, fuzz, ior, 0).  1/r keeps the radius sign (hollow glass).
// CULLED: rows in the plan's order, bounds [n_chunks], members [n_spheres],
// prio [n_prio]; live [n_lanes] or nullptr.
// SMEM: geom (and, CULLED, the bounds and priority rows after it) is staged
// into dynamic shared memory before any thread leaves, and the loops and the
// winner's row read it there.
template <bool CULLED, bool SMEM>
__global__ void __launch_bounds__(kThreads)
    k1_render_kernel(const float4* __restrict__ geom,
                     const float4* __restrict__ attr, int n_spheres,
                     const float4* __restrict__ bounds,
                     const int* __restrict__ members,
                     const float4* __restrict__ prio, int n_chunks, int chunk,
                     int n_prio, const float* __restrict__ cam_in,
                     const int* __restrict__ pids, int n_lanes,
                     float* __restrict__ fb, float* __restrict__ len_out,
                     float* __restrict__ live_out, uint32_t seed,
                     uint32_t sample_base, int spp, int max_depth, float t_min,
                     int width, int height, int max_rounds) {
  extern __shared__ float4 staged[];
  if (SMEM) {
    for (int j = threadIdx.x; j < n_spheres; j += kThreads)
      staged[j] = __ldg(geom + j);
    if (CULLED) {
      for (int j = threadIdx.x; j < n_chunks; j += kThreads)
        staged[n_spheres + j] = __ldg(bounds + j);
      for (int j = threadIdx.x; j < n_prio; j += kThreads)
        staged[n_spheres + n_chunks + j] = __ldg(prio + j);
    }
    __syncthreads();
  }
  const float4* rows = SMEM ? staged : geom;
  const float4* bnds = SMEM ? staged + n_spheres : bounds;
  const float4* prs = SMEM ? staged + n_spheres + n_chunks : prio;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int pid = pids[lane];
  const uint32_t upid = static_cast<uint32_t>(pid);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, rounds = 0.f, live = 0.f;
  // The lane's path: sample s, its bounce, ray (o, d) and throughput.
  int s = max_depth > 0 ? 0 : spp;  // depth 0: no round, black
  int bounce = 0;
  uint32_t su = 0;
  float o[3], d[3];
  float tp_r = 1.f, tp_g = 1.f, tp_b = 1.f;
  int prev = -1;  // CULLED: the row of the lane's last winner

  while (s < spp) {
    if (CULLED && max_rounds > 0 && rounds >= static_cast<float>(max_rounds))
      break;
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
    }
    rounds += 1.0f;
    // ---- nearest hit: first index wins ties ------------------------------
    float best_t;
    int best;
    if (CULLED)
      culled_nearest<SMEM>(rows, n_spheres, bnds, n_chunks, chunk, members,
                           prs, n_prio, prev, o, d, t_min, best_t, best, live);
    else
      brt::sweep_nearest<1, SMEM>(rows, n_spheres, o, d, t_min, best_t, best);
    bool ended = true;
    if (best < 0) {  // miss: sky, and the path ends
      float sk_r, sk_g;
      brt::sky(d[1], sk_r, sk_g);
      acc_r += tp_r * sk_r;
      acc_g += tp_g * sk_g;
      acc_b += tp_b;
    } else {
      if (CULLED) prev = best;
      // ---- exact t of the winner, hit frame -------------------------------
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
      // ---- shade: a fuzzed metal reflection below the surface is absorbed
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
        // Depth exhaustion kills the path with black.
        ended = ++bounce == max_depth;
      }
    }
    if (ended) {  // the lane takes its next sample in the next round
      ++s;
      bounce = 0;
    }
  }
  fb[3 * lane + 0] = acc_r;
  fb[3 * lane + 1] = acc_g;
  fb[3 * lane + 2] = acc_b;
  len_out[lane] = rounds;
  if (CULLED && live_out != nullptr) live_out[lane] = live;
}

template <bool CULLED>
int launch(const void* geom, const void* attr, int n_spheres,
           const void* bounds, const void* members, const void* prio,
           int n_chunks, int chunk, int n_prio, const void* cam,
           const void* pids, int n_lanes, void* fb, void* len, void* live,
           unsigned int seed, unsigned int sample_base, int spp, int max_depth,
           float t_min, int width, int height, int max_rounds, int table_mode,
           void* stream) {
  if (n_lanes <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BRT_K1_ARGS                                                           \
  static_cast<const float4*>(geom), static_cast<const float4*>(attr),         \
      n_spheres, static_cast<const float4*>(bounds),                          \
      static_cast<const int*>(members), static_cast<const float4*>(prio),     \
      n_chunks, chunk, n_prio, static_cast<const float*>(cam),                \
      static_cast<const int*>(pids), n_lanes, static_cast<float*>(fb),        \
      static_cast<float*>(len), static_cast<float*>(live), seed, sample_base, \
      spp, max_depth, t_min, width, height, max_rounds
  if (table_mode == 1) {
    size_t smem = 0;
    const cudaError_t err = brt::prepare_staged_launch(
        k1_render_kernel<CULLED, true>, n_spheres + n_chunks + n_prio, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    k1_render_kernel<CULLED, true><<<blocks, kThreads, smem, st>>>(BRT_K1_ARGS);
  } else {
    k1_render_kernel<CULLED, false><<<blocks, kThreads, 0, st>>>(BRT_K1_ARGS);
  }
#undef BRT_K1_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most bytes of sphere rows K1 stages in shared memory while keeping
// min_blocks blocks resident on an SM (or as many as its registers allow, if
// fewer): see brt::table_bytes_limit.  Writes it to *out; returns a
// cudaError_t.  kernels/common.py::forward_table_plan reads it.
extern "C" int brt_k1_table_bytes_limit(int min_blocks, int* out) {
  return static_cast<int>(brt::table_bytes_limit(
      k1_render_kernel<false, true>, kThreads, min_blocks, out));
}

// The same for the culled kernel, whose staged table holds the rows, the
// bounds and the priority rows (16 bytes each).
extern "C" int brt_k1_culled_table_bytes_limit(int min_blocks, int* out) {
  return static_cast<int>(brt::table_bytes_limit(
      k1_render_kernel<true, true>, kThreads, min_blocks, out));
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
  return launch<false>(geom, attr, n_spheres, nullptr, nullptr, nullptr, 0, 0,
                       0, cam, pids, n_lanes, fb, len, nullptr, seed,
                       sample_base, spp, max_depth, t_min, width, height, 0,
                       table_mode, stream);
}

// Launches the chunk-culled K1: as brt_k1_render, with geom and attr in the
// plan's order, bounds [n_chunks] float4 (bx, by, bz, br^2), members [S]
// int32 (row -> scene index), prio [n_prio] float4 (cx, cy, cz, r^2), chunk
// >= 1 rows a chunk and n_chunks = ceil(S / chunk); live [n_lanes] float
// (each lane's live chunks summed over its rounds) or nullptr; max_rounds 0
// or the rounds after which a lane stops.  table_mode 1 stages S + n_chunks
// + n_prio rows.
extern "C" int brt_k1_render_culled(
    const void* geom, const void* attr, int n_spheres, const void* bounds,
    const void* members, const void* prio, int n_chunks, int chunk,
    int n_prio, const void* cam, const void* pids, int n_lanes, void* fb,
    void* len, void* live, unsigned int seed, unsigned int sample_base,
    int spp, int max_depth, float t_min, int width, int height,
    int max_rounds, int table_mode, void* stream) {
  if (n_spheres < 1 || (table_mode != 0 && table_mode != 1) || chunk < 1 ||
      n_chunks != (n_spheres + chunk - 1) / chunk || n_prio < 0 ||
      max_rounds < 0 || bounds == nullptr || members == nullptr ||
      (n_prio > 0 && prio == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(geom, attr, n_spheres, bounds, members, prio, n_chunks,
                      chunk, n_prio, cam, pids, n_lanes, fb, len, live, seed,
                      sample_base, spp, max_depth, t_min, width, height,
                      max_rounds, table_mode, stream);
}
