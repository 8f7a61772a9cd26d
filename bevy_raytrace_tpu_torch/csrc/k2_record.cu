// K2 on Hopper: the recording forward of the fast gradient path, one thread
// per pixel.
//
// Replaces bevy_raytrace_tpu/kernels/pallas_render.py::_make_kernel (the
// TPU's v1 kernel, launched by render_pallas) in its with_residuals form.  It
// computes what that kernel computes:
//
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
//     stored in res[s, b, pid] (-1 = miss, or a path already dead), and with
//     RECORD == 2 the runner-up in res2: the nearest other hit, by the v1
//     kernel's rule (a sphere that beats the winner demotes it to runner-up;
//     an exact tie with the current winner never becomes runner-up);
//   * Lambertian, metal and dielectric shading (common.cuh::scatter), sky on
//     a miss; each sample's radiance is added to the pixel's sum in sample
//     order, and the sum is divided by spp once, as the v1 kernel's
//     accumulation across its spp grid axis does.
//
// Left out, as TPU devices or later work: the (tile_rows, 128) plane layout
// and unroll padding, skip_dead_tiles, the cluster-culled broad phase
// (`clusters=`) and stripe mode (`pixel_base`/`num_local`).
//
// What bounds it on an H100: fp32 issue in the sphere loop and divergence
// between the paths of a warp, as for K1.  The residual stores are 2 (int16)
// or 4 (int32) bytes per (sample, bounce, pixel), written with consecutive
// threads on consecutive pids, so each warp store is one coalesced
// transaction; at 1200x800x256x8 that is 3.9 GB of int16, written once.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// geom[i] = (cx, cy, cz, |c|^2 - r^2); attr[2i] = (1/r, albedo r, g, b),
// attr[2i+1] = (kind, fuzz, ior, 0).
template <typename ResT, int RECORD>
__global__ void __launch_bounds__(kThreads)
    k2_record_kernel(const float4* __restrict__ geom,
                     const float4* __restrict__ attr, int n_spheres,
                     const float* __restrict__ cam_in, int n_pix,
                     float* __restrict__ img, ResT* __restrict__ res,
                     ResT* __restrict__ res2, uint32_t seed,
                     uint32_t sample_base, int spp, int max_depth, float t_min,
                     float t_max, int width, int height) {
  const int pid = blockIdx.x * blockDim.x + threadIdx.x;
  if (pid >= n_pix) return;
  const brt::Cam c = brt::load_cam(cam_in);
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
          (static_cast<size_t>(s) * max_depth + b) * n_pix + pid;
      if (!alive) {
        if (RECORD >= 1) res[slot] = static_cast<ResT>(-1);
        if (RECORD == 2) res2[slot] = static_cast<ResT>(-1);
        continue;
      }
      // ---- per-sphere loop, expanded quadratic ---------------------------
      const float o_dot_d = o[0] * d[0] + o[1] * d[1] + o[2] * d[2];
      const float o2 = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
      float bt = t_max, bt2 = t_max;
      int bidx = -1, bidx2 = -1;
      for (int i = 0; i < n_spheres; ++i) {
        const float4 g = __ldg(geom + i);
        const float c_dot_d = g.x * d[0] + g.y * d[1] + g.z * d[2];
        const float o_dot_c = o[0] * g.x + o[1] * g.y + o[2] * g.z;
        const float half_b = o_dot_d - c_dot_d;
        const float cq = o2 - 2.0f * o_dot_c + g.w;
        const float disc = half_b * half_b - cq;
        const float sq = sqrtf(disc);  // NaN on a miss: every compare fails
        const float rn = -half_b - sq;
        const float tn = rn > t_min ? rn : -half_b + sq;
        const bool better = tn > t_min && tn < bt;
        if (RECORD == 2) {
          if (better) {
            bt2 = bt;
            bidx2 = bidx;
          } else if (tn > t_min && tn < bt2 && tn != bt) {
            bt2 = tn;
            bidx2 = i;
          }
        }
        if (better) {
          bt = tn;
          bidx = i;
        }
      }
      const bool hit = bt < t_max;
      if (RECORD >= 1) res[slot] = static_cast<ResT>(hit ? bidx : -1);
      if (RECORD == 2)
        res2[slot] = static_cast<ResT>(hit && bt2 < t_max ? bidx2 : -1);
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
      const float4 g = __ldg(geom + bidx);
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
  img[3 * pid + 0] = acc_r / fspp;
  img[3 * pid + 1] = acc_g / fspp;
  img[3 * pid + 2] = acc_b / fspp;
}

template <typename ResT, int RECORD>
int launch(const void* geom, const void* attr, int n_spheres, const void* cam,
           int n_pix, void* img, void* res, void* res2, unsigned int seed,
           unsigned int sample_base, int spp, int max_depth, float t_min,
           float t_max, int width, int height, cudaStream_t stream) {
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  k2_record_kernel<ResT, RECORD><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(geom), static_cast<const float4*>(attr),
      n_spheres, static_cast<const float*>(cam), n_pix,
      static_cast<float*>(img), static_cast<ResT*>(res),
      static_cast<ResT*>(res2), seed, sample_base, spp, max_depth, t_min,
      t_max, width, height);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K2 on `stream`.  Device pointers: geom [S] float4, attr [2S]
// float4, cam [16] float, img [n_pix, 3] float (the mean over spp), res and
// res2 [spp, max_depth, n_pix] of res_bytes (2: int16, 4: int32) each.
// record: 0 = image only (res, res2 unused), 1 = res, 2 = res and res2.
// Returns the launch's cudaError_t, or cudaErrorInvalidValue for arguments
// it does not take; the kernel itself runs asynchronously.
extern "C" int brt_k2_record(const void* geom, const void* attr,
                             int n_spheres, const void* cam, int n_pix,
                             void* img, void* res, void* res2, int res_bytes,
                             int record, unsigned int seed,
                             unsigned int sample_base, int spp, int max_depth,
                             float t_min, float t_max, int width, int height,
                             void* stream) {
  if (n_pix <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BRT_K2_ARGS                                                          \
  geom, attr, n_spheres, cam, n_pix, img, res, res2, seed, sample_base, spp, \
      max_depth, t_min, t_max, width, height, st
  if (record == 0) return launch<int16_t, 0>(BRT_K2_ARGS);
  if (res_bytes == 2 && record == 1) return launch<int16_t, 1>(BRT_K2_ARGS);
  if (res_bytes == 2 && record == 2) return launch<int16_t, 2>(BRT_K2_ARGS);
  if (res_bytes == 4 && record == 1) return launch<int32_t, 1>(BRT_K2_ARGS);
  if (res_bytes == 4 && record == 2) return launch<int32_t, 2>(BRT_K2_ARGS);
#undef BRT_K2_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
