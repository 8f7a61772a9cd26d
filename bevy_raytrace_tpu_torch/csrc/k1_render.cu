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
// The sphere rows are staged in dynamic shared memory once a block
// (table_mode 1; the rate probe V3 ran the same loop 1.30x faster from
// there), before any thread may leave; tables larger than the plan allows
// (kernels/common.py::forward_table_plan, from brt_k1_table_bytes_limit) are
// read through the read-only cache (table_mode 0).  Both modes compute the
// same bits.
//
// Left out, as TPU devices: the bf16 limb split and one-hot MXU gather, the
// 10-bit packed (t|idx) key and its 1,024-sphere cap, f32 lane counters,
// v_planes/tile_rows/chunking, the plan= culling and the debug probes.
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
    // ---- dense sweep: nearest hit, first index wins ties ------------------
    float best_t;
    int best;
    brt::sweep_nearest<1, SMEM>(rows, n_spheres, o, d, t_min, best_t, best);
    bool ended = true;
    if (best < 0) {  // miss: sky, and the path ends
      float sk_r, sk_g;
      brt::sky(d[1], sk_r, sk_g);
      acc_r += tp_r * sk_r;
      acc_g += tp_g * sk_g;
      acc_b += tp_b;
    } else {
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
}

}  // namespace

// The most bytes of sphere rows K1 stages in shared memory while keeping
// min_blocks blocks resident on an SM (or as many as its registers allow, if
// fewer): see brt::table_bytes_limit.  Writes it to *out; returns a
// cudaError_t.  kernels/common.py::forward_table_plan reads it.
extern "C" int brt_k1_table_bytes_limit(int min_blocks, int* out) {
  return static_cast<int>(brt::table_bytes_limit(
      k1_render_kernel<true>, kThreads, min_blocks, out));
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
  if (n_lanes <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BRT_K1_ARGS                                                           \
  static_cast<const float4*>(geom), static_cast<const float4*>(attr),         \
      n_spheres, static_cast<const float*>(cam),                              \
      static_cast<const int*>(pids), n_lanes, static_cast<float*>(fb),        \
      static_cast<float*>(len), seed, sample_base, spp, max_depth, t_min,     \
      width, height
  if (table_mode == 1) {
    size_t smem = 0;
    const cudaError_t err =
        brt::prepare_staged_launch(k1_render_kernel<true>, n_spheres, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    k1_render_kernel<true><<<blocks, kThreads, smem, st>>>(BRT_K1_ARGS);
  } else {
    k1_render_kernel<false><<<blocks, kThreads, 0, st>>>(BRT_K1_ARGS);
  }
#undef BRT_K1_ARGS
  return static_cast<int>(cudaGetLastError());
}
