// K4 on Hopper: the recording forward on the dense sweep, one thread per
// pixel of the stripe.
//
// Replaces bevy_raytrace_tpu/kernels/sweep_record.py::_make_kernel (the
// TPU's dense-sweep recorder, launched by render_sweep_record).  It computes
// what that kernel computes, in the natural SIMT form: K1's body
// (k1_render.cu) with a recording store.
//
//   * thread i < n_local renders the ABSOLUTE pixel pixel_base + i: the RNG
//     counters and (px, py) come from the absolute id, the outputs are
//     indexed by the local i (stripe mode; a whole frame is pixel_base 0,
//     n_local = width * height);
//   * for each sample s in order: a thin-lens camera ray keyed on
//     CAMERA_STREAM, then up to max_depth rounds of (dense sweep -> shade);
//   * the sweep is K1's: the centered half-b quadratic, disc * rsqrt(disc)
//     (so an exact tangency, disc == 0, is a miss, as in the TPU kernel),
//     near root when > t_min else far root, valid = t > t_min with NO t_max
//     test (unlike K2).  The nearest hit is a (t, index) register pair
//     updated with a strict < in ascending sphere order, so the first index
//     wins ties and there is no cap on the sphere count (the TPU kernel's
//     10-bit packed key caps it at 1,024 and breaks near-ties on a t
//     truncated to 22 bits; here ties break on the full float32 t);
//   * with RECORD == 2 a second (t, index) pair keeps the runner-up by K2's
//     sequential rule: a sphere that beats the winner demotes it to
//     runner-up; an exact tie with the current winner never becomes
//     runner-up;
//   * the winner's t is recomputed with an exact sqrt (K3 replays a path
//     with the same centered quadratic and exact sqrt, so what K4 records
//     replays closely), then Lambertian / metal / dielectric shading and the
//     sky on a miss, all from common.cuh, shared with K1 and K2;
//   * res[s, b, i] holds the winner's index in the UNPERMUTED scene order
//     (-1: a miss, or the path was already dead), res2[s, b, i] the
//     runner-up's (-1 where there is none).  K3 reads every entry, so a
//     path that ends before max_depth stores -1 into its later bounces;
//   * each sample's radiance joins the pixel's sum in sample order; the sum
//     is divided by spp once.
//
// The schedule is K1's round loop (k1_render.cu), the TPU kernel's
// persistent-lane refill, which the TPU's K4 could not have ("per-lane
// scatters Mosaic cannot express"): one loop over rounds per thread, its
// path state (sample s, bounce, o, d, throughput) in registers; a path that
// ends starts the thread's next sample in the next round, and the thread
// leaves when s == spp.  So every thread with samples left runs the sweep
// each round instead of waiting for its warp's longest path.  Each thread
// walks its own samples and bounces in order, so the image's sums are added
// in the order of a nested sample / bounce loop, bit for bit, and each
// residual lands in its own (s, b) slot.  The stores pay for it: the threads
// of a warp now sit at different (s, b), so a warp's store is up to 32
// scattered 2- or 4-byte writes instead of one coalesced line (PERF.md
// section 6: at most 1% at depth 8, winners only).  A -1 prefill of both
// buffers (a memset of 0xFF bytes) in place of the dead paths' stores gave
// the same bits and no steady gain (4.6% faster in one run and 5.0% slower
// in another at the gradient bench, 0-0.5% faster on the flagship frame),
// and a 3.9 GB memset per flagship gradient, so the stores stay in the
// kernel.
//
// The sphere rows are staged in dynamic shared memory once a block
// (table_mode 1), before any thread leaves (n_local is not a multiple of the
// block); tables larger than kernels/common.py::forward_table_plan allows are
// read through the read-only cache (table_mode 0).  Both modes compute the
// same bits.
//
// Left out, as TPU devices: the (tile, sample) grid and its aligned
// (tile_rows, 128) stores, the bf16 limb split and one-hot MXU gather, the
// packed (t | idx) key, sphere_chunk, and the 2^24-pixel guard (pixel ids
// are integers here).
//
// What bounds it on an H100: fp32 instruction throughput in the sweep (16
// operations per ray-sphere test, about 10 more where the discriminant is
// positive), as for K1; not bytes.  The residual stores are 2 (int16) or 4
// (int32) bytes per (sample, bounce, pixel).  Pixels stay in identity order
// (no cost-balancing permutation: the residuals are unpermuted in both
// senses).
//
// Build: as K1 (no --use_fast_math, --fmad at its default).  Built with
// -fmad=false the kernel reproduces its plain PyTorch twin bit for bit on
// the card (image and residuals) and the torch replay of its residuals
// comes a little closer to its image, but it takes 12-18% longer
// (PERF.md); either build replays far inside the parity thresholds, so the
// faster one is kept.  To repeat the comparison, add the flag under this
// kernel's name in build.py's EXTRA_FLAGS.  The nearest-hit update is two
// nested `if`s, not one joint condition: see k1_render.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// geom[i] = (cx, cy, cz, r^2); attr[2i] = (1/r, albedo r, g, b),
// attr[2i+1] = (kind, fuzz, ior, 0).  1/r keeps the radius sign (hollow glass).
// SMEM: geom is staged into dynamic shared memory before any thread leaves,
// and the sweep and the winner's row read it there.
template <typename ResT, int RECORD, bool SMEM>
__global__ void __launch_bounds__(kThreads)
    k4_sweep_record_kernel(const float4* __restrict__ geom,
                           const float4* __restrict__ attr, int n_spheres,
                           const float* __restrict__ cam_in, int pixel_base,
                           int n_local, float* __restrict__ img,
                           ResT* __restrict__ res, ResT* __restrict__ res2,
                           uint32_t seed, uint32_t sample_base, int spp,
                           int max_depth, float t_min, int width, int height) {
  extern __shared__ float4 staged[];
  if (SMEM) {
    for (int j = threadIdx.x; j < n_spheres; j += kThreads)
      staged[j] = __ldg(geom + j);
    __syncthreads();
  }
  const float4* rows = SMEM ? staged : geom;
  const int i_loc = blockIdx.x * blockDim.x + threadIdx.x;
  if (i_loc >= n_local) return;
  const int pid = pixel_base + i_loc;
  const uint32_t upid = static_cast<uint32_t>(pid);
  const size_t stride = static_cast<size_t>(n_local);
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  // The thread's path: sample s, its bounce, ray (o, d) and throughput;
  // slot indexes res[s, bounce, i_loc].
  int s = max_depth > 0 ? 0 : spp;  // depth 0: no round, black
  int bounce = 0;
  uint32_t su = 0;
  size_t slot = i_loc;
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
      slot = static_cast<size_t>(s) * max_depth * stride + i_loc;
    }
    // ---- dense sweep: nearest hit (first index wins ties), runner-up ------
    float best_t = 0.f, t2 = 0.f;
    int best = -1, idx2 = -1;
    for (int i = 0; i < n_spheres; ++i) {
      const float4 g = SMEM ? rows[i] : __ldg(geom + i);
      const float ocx = o[0] - g.x, ocy = o[1] - g.y, ocz = o[2] - g.z;
      const float hb = ocx * d[0] + ocy * d[1] + ocz * d[2];
      const float cq = (ocx * ocx + ocy * ocy + ocz * ocz) - g.w;
      const float disc = hb * hb - cq;
      if (disc > 0.f) {
        const float sq = disc * rsqrtf(disc);
        const float rn = -hb - sq;
        const float tn = rn > t_min ? rn : sq - hb;
        if (tn > t_min) {
          if (best < 0 || tn < best_t) {
            if (RECORD == 2) {
              t2 = best_t;
              idx2 = best;
            }
            best_t = tn;
            best = i;
          } else if (RECORD == 2 && tn != best_t &&
                     (idx2 < 0 || tn < t2)) {
            t2 = tn;
            idx2 = i;
          }
        }
      }
    }
    res[slot] = static_cast<ResT>(best);
    if (RECORD == 2) res2[slot] = static_cast<ResT>(best < 0 ? -1 : idx2);
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
        slot += stride;
      }
    }
    if (ended) {
      // ---- the dead path's later bounces: -1 ------------------------------
      for (int b = bounce + 1; b < max_depth; ++b) {
        slot += stride;
        res[slot] = static_cast<ResT>(-1);
        if (RECORD == 2) res2[slot] = static_cast<ResT>(-1);
      }
      ++s;  // the thread takes its next sample in the next round
      bounce = 0;
    }
  }
  const float fspp = static_cast<float>(spp);
  img[3 * i_loc + 0] = acc_r / fspp;
  img[3 * i_loc + 1] = acc_g / fspp;
  img[3 * i_loc + 2] = acc_b / fspp;
}

template <typename ResT, int RECORD, bool SMEM>
int launch(const void* geom, const void* attr, int n_spheres, const void* cam,
           int pixel_base, int n_local, void* img, void* res, void* res2,
           unsigned int seed, unsigned int sample_base, int spp, int max_depth,
           float t_min, int width, int height, cudaStream_t stream) {
  const auto kernel = k4_sweep_record_kernel<ResT, RECORD, SMEM>;
  size_t smem = 0;
  if (SMEM) {
    const cudaError_t err =
        brt::prepare_staged_launch(kernel, n_spheres, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_local + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const float4*>(geom), static_cast<const float4*>(attr),
      n_spheres, static_cast<const float*>(cam), pixel_base, n_local,
      static_cast<float*>(img), static_cast<ResT*>(res),
      static_cast<ResT*>(res2), seed, sample_base, spp, max_depth, t_min,
      width, height);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most bytes of sphere rows K4 stages in shared memory while keeping
// min_blocks blocks resident on an SM (or as many as its registers allow, if
// fewer), measured on the instantiation with the runner-up: see
// brt::table_bytes_limit.  Writes it to *out; returns a cudaError_t.
extern "C" int brt_k4_table_bytes_limit(int min_blocks, int* out) {
  return static_cast<int>(brt::table_bytes_limit(
      k4_sweep_record_kernel<int16_t, 2, true>, kThreads, min_blocks, out));
}

// Launches K4 on `stream`.  Device pointers: geom [S] float4, attr [2S]
// float4, cam [16] float, img [n_local, 3] float (the mean over spp), res and
// res2 [spp, max_depth, n_local] of res_bytes (2: int16, 4: int32) each.
// record: 1 = res, 2 = res and res2.  Thread i renders the absolute pixel
// pixel_base + i.  table_mode: 1 = the rows staged in shared memory (16 x S
// bytes must fit what a block may take on the device), 0 = read through the
// read-only cache.  Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for arguments it does not take; the kernel itself
// runs asynchronously.
extern "C" int brt_k4_sweep_record(const void* geom, const void* attr,
                                   int n_spheres, const void* cam,
                                   int pixel_base, int n_local, void* img,
                                   void* res, void* res2, int res_bytes,
                                   int record, unsigned int seed,
                                   unsigned int sample_base, int spp,
                                   int max_depth, float t_min, int width,
                                   int height, int table_mode, void* stream) {
  if (n_spheres < 1 || (table_mode != 0 && table_mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_local <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BRT_K4_ARGS                                                          \
  geom, attr, n_spheres, cam, pixel_base, n_local, img, res, res2, seed,    \
      sample_base, spp, max_depth, t_min, width, height, st
#define BRT_K4_LAUNCH(T, R)                                 \
  return table_mode == 1 ? launch<T, R, true>(BRT_K4_ARGS)  \
                         : launch<T, R, false>(BRT_K4_ARGS)
  if (res_bytes == 2 && record == 1) BRT_K4_LAUNCH(int16_t, 1);
  if (res_bytes == 2 && record == 2) BRT_K4_LAUNCH(int16_t, 2);
  if (res_bytes == 4 && record == 1) BRT_K4_LAUNCH(int32_t, 1);
  if (res_bytes == 4 && record == 2) BRT_K4_LAUNCH(int32_t, 2);
#undef BRT_K4_LAUNCH
#undef BRT_K4_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
