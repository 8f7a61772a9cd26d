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
//   * the sweep uses the centered half-b quadratic with near/far root choice
//     and valid = t > t_min (no t_max test).  The nearest hit keeps a
//     (best_t, best_idx) register pair updated with a strict < in ascending
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
// The TPU kernel's persistent-lane refill (a dead path starts its lane's
// next sample in the same round) is, on a GPU, simply a per-thread `break`
// out of the bounce loop into the next sample.  Left out, as TPU devices:
// the bf16 limb split and one-hot MXU gather, the 10-bit packed (t|idx) key
// and its 1,024-sphere cap, f32 lane counters, v_planes/tile_rows/chunking,
// the plan= culling and the debug probes.
//
// What bounds it on an H100: fp32 issue in the sweep (about 20 flops per
// ray-sphere test) and warp divergence, not bytes: the sphere table (16 B
// of geometry per sphere, read as one broadcast float4 load by the whole
// warp) stays in L1/L2, and the only device-memory traffic is pids in and
// 16 B per lane out.  Divergence comes from lanes of one warp whose paths
// have different lengths; balance_perm sorts pixels by measured path length
// so a warp holds similar-cost pixels.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3.  No
// --use_fast_math.  --fmad is left at its default (on): a*b+c contracts to
// fma, which flips rare borderline discrete choices against the PyTorch twin;
// the bench's compiled-parity thresholds absorb that.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// geom[i] = (cx, cy, cz, r^2); attr[2i] = (1/r, albedo r, g, b),
// attr[2i+1] = (kind, fuzz, ior, 0).  1/r keeps the radius sign (hollow glass).
__global__ void __launch_bounds__(kThreads)
    k1_render_kernel(const float4* __restrict__ geom,
                     const float4* __restrict__ attr, int n_spheres,
                     const float* __restrict__ cam_in,
                     const int* __restrict__ pids, int n_lanes,
                     float* __restrict__ fb, float* __restrict__ len_out,
                     uint32_t seed, uint32_t sample_base, int spp,
                     int max_depth, float t_min, int width, int height) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const brt::Cam c = brt::load_cam(cam_in);
  const int pid = pids[lane];
  const uint32_t upid = static_cast<uint32_t>(pid);
  const float px = static_cast<float>(pid % width);
  const float py = static_cast<float>(pid / width);
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, rounds = 0.f;

  for (int s = 0; s < spp; ++s) {
    const uint32_t su = sample_base + static_cast<uint32_t>(s);
    uint32_t ca = upid, cb = su, cc = brt::CAMERA_STREAM, cd = seed;
    brt::pcg4d(ca, cb, cc, cd);
    float o[3], d[3];
    brt::camera_ray(c, px, py, fw, fh, brt::to_unit(ca), brt::to_unit(cb),
                    brt::to_unit(cc), brt::to_unit(cd), o, d);
    float tp_r = 1.f, tp_g = 1.f, tp_b = 1.f;

    for (int bounce = 0; bounce < max_depth; ++bounce) {
      rounds += 1.0f;
      // ---- dense sweep: nearest hit, first index wins ties ----------------
      float best_t = 0.f;
      int best = -1;
      for (int i = 0; i < n_spheres; ++i) {
        const float4 g = __ldg(geom + i);
        const float ocx = o[0] - g.x, ocy = o[1] - g.y, ocz = o[2] - g.z;
        const float hb = ocx * d[0] + ocy * d[1] + ocz * d[2];
        const float cq = (ocx * ocx + ocy * ocy + ocz * ocz) - g.w;
        const float disc = hb * hb - cq;
        if (disc > 0.f) {
          const float sq = disc * rsqrtf(disc);
          const float rn = -hb - sq;
          const float tn = rn > t_min ? rn : sq - hb;
          if (tn > t_min && (best < 0 || tn < best_t)) {
            best_t = tn;
            best = i;
          }
        }
      }
      if (best < 0) {  // miss: sky, and the path ends
        float sk_r, sk_g;
        brt::sky(d[1], sk_r, sk_g);
        acc_r += tp_r * sk_r;
        acc_g += tp_g * sk_g;
        acc_b += tp_b;
        break;
      }
      // ---- exact t of the winner, hit frame -------------------------------
      const float4 g = __ldg(geom + best);
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
      // ---- shade -----------------------------------------------------------
      uint32_t ba = upid, bb = su, bc = static_cast<uint32_t>(bounce),
               bd = seed;
      brt::pcg4d(ba, bb, bc, bd);
      float sdir[3];
      if (!brt::scatter(d, n, front, a1.x, a1.y, a1.z, brt::to_unit(ba),
                        brt::to_unit(bb), brt::to_unit(bc), brt::to_unit(bd),
                        sdir))
        break;  // a fuzzed metal reflection below the surface: absorbed
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
    }
  }
  fb[3 * lane + 0] = acc_r;
  fb[3 * lane + 1] = acc_g;
  fb[3 * lane + 2] = acc_b;
  len_out[lane] = rounds;
}

}  // namespace

// Launches K1 on `stream`.  Pointers are device pointers: geom [S] float4,
// attr [2S] float4, cam [16] float, pids [n_lanes] int32, fb [n_lanes, 3]
// and len [n_lanes] float sums over the spp samples.  Returns the launch's
// cudaError_t (0 on success); the kernel itself runs asynchronously.
extern "C" int brt_k1_render(const void* geom, const void* attr, int n_spheres,
                             const void* cam, const void* pids, int n_lanes,
                             void* fb, void* len, unsigned int seed,
                             unsigned int sample_base, int spp, int max_depth,
                             float t_min, int width, int height,
                             void* stream) {
  if (n_lanes <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  k1_render_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(geom), static_cast<const float4*>(attr),
      n_spheres, static_cast<const float*>(cam),
      static_cast<const int*>(pids), n_lanes, static_cast<float*>(fb),
      static_cast<float*>(len), seed, sample_base, spp, max_depth, t_min,
      width, height);
  return static_cast<int>(cudaGetLastError());
}
