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
//   * with CLUSTERED the per-sphere loop is culled (the v1 kernel's
//     `clusters=` broad phase): the sphere rows arrive gathered into the
//     plan's Morton order, cluster c owning rows [c L, min((c + 1) L, S)),
//     and each bounce tests the ray against every cluster's bounding sphere
//     (bounds[c] = (bx, by, bz, |b|^2 - br^2), recomputed from live geometry
//     by the host for every launch) with the expanded quadratic: the cluster
//     is walked when sqrt(hb^2 - cq) - hb > t_min (NaN compares false), else
//     skipped.  The members go through the SAME per-sphere test as the
//     brute-force loop (test_sphere below), so the result differs from it
//     only where two different spheres tie exactly (members are visited in
//     Morton order, not scene order) or where a bound is not conservative,
//     which would be a bug.  Residuals store members[row], the SCENE index,
//     so the replay needs no plan.
//
// The TPU kernel's cull is per tile: hit bits of 1024+ rays are OR-ed into
// bit-mask words, compacted into an SMEM worklist, and every ray of the tile
// walks every flagged cluster in unroll-sized blocks (hence its padded
// clusters).  Here a thread owns a ray: it skips a cluster its own ray
// misses, and the warp's divergence does what the worklist did.  The cull is
// per thread on purpose: no warp-wide primitive is used, since the last
// block's warp is partly retired by the bounds check and dead paths leave
// the bounce body early.  No pad rows are visited.
//
// Left out, as TPU devices: the (tile_rows, 128) plane layout and unroll
// padding, skip_dead_tiles, the bit-mask words and the SMEM worklist.
//
// What bounds it on an H100: fp32 issue in the sphere loop and divergence
// between the paths of a warp, as for K1.  The residual stores are 2 (int16)
// or 4 (int32) bytes per (sample, bounce, pixel), written with consecutive
// threads on consecutive pixels, so each warp store is one coalesced
// transaction; at 1200x800x256x8 that is 3.9 GB of int16, written once.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// The nearest hit (bt, bidx) and, with RECORD == 2, the runner-up (bt2,
// bidx2) of one bounce.
struct Nearest {
  float bt, bt2;
  int bidx, bidx2;
};

// One ray-sphere test of the expanded quadratic against row i, g =
// geom[i], folded into the nearest hit: strict <, so the first row visited
// wins an exact tie.  `tn != bt` keeps a row that ties the winner exactly
// from becoming its runner-up.
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
  const float sq = sqrtf(disc);  // NaN on a miss: every compare fails
  const float rn = -half_b - sq;
  const float tn = rn > t_min ? rn : -half_b + sq;
  const bool better = tn > t_min && tn < nh.bt;
  if (RECORD == 2) {
    if (better) {
      nh.bt2 = nh.bt;
      nh.bidx2 = nh.bidx;
    } else if (tn > t_min && tn < nh.bt2 && tn != nh.bt) {
      nh.bt2 = tn;
      nh.bidx2 = i;
    }
  }
  if (better) {
    nh.bt = tn;
    nh.bidx = i;
  }
}

// geom[i] = (cx, cy, cz, |c|^2 - r^2); attr[2i] = (1/r, albedo r, g, b),
// attr[2i+1] = (kind, fuzz, ior, 0).  CLUSTERED: rows in the plan's order,
// bounds [n_clusters] float4, members [n_spheres] row -> scene index.
template <typename ResT, int RECORD, bool CLUSTERED>
__global__ void __launch_bounds__(kThreads)
    k2_record_kernel(const float4* __restrict__ geom,
                     const float4* __restrict__ attr, int n_spheres,
                     const float4* __restrict__ bounds,
                     const int* __restrict__ members, int n_clusters,
                     int cluster_size,
                     const float* __restrict__ cam_in, int pixel_base,
                     int n_pix, float* __restrict__ img,
                     ResT* __restrict__ res,
                     ResT* __restrict__ res2, uint32_t seed,
                     uint32_t sample_base, int spp, int max_depth, float t_min,
                     float t_max, int width, int height) {
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
      if (CLUSTERED) {
        for (int ci = 0; ci < n_clusters; ++ci) {
          const float4 bs = __ldg(bounds + ci);
          const float c_dot_d = bs.x * d[0] + bs.y * d[1] + bs.z * d[2];
          const float o_dot_c = o[0] * bs.x + o[1] * bs.y + o[2] * bs.z;
          const float hb = o_dot_d - c_dot_d;
          const float cq = o2 - 2.0f * o_dot_c + bs.w;
          const float rfar = sqrtf(hb * hb - cq) - hb;
          if (!(rfar > t_min)) continue;  // NaN: the ray misses the bound
          const int lo = ci * cluster_size;
          const int hi = min(lo + cluster_size, n_spheres);
          for (int i = lo; i < hi; ++i)
            test_sphere<RECORD>(__ldg(geom + i), i, o, d, o_dot_d, o2, t_min,
                                nh);
        }
      } else {
        for (int i = 0; i < n_spheres; ++i)
          test_sphere<RECORD>(__ldg(geom + i), i, o, d, o_dot_d, o2, t_min,
                              nh);
      }
      const float bt = nh.bt;
      const int bidx = nh.bidx;
      const bool hit = bt < t_max;
      if (RECORD >= 1) {
        const int widx = CLUSTERED && hit ? __ldg(members + bidx) : bidx;
        res[slot] = static_cast<ResT>(hit ? widx : -1);
      }
      if (RECORD == 2) {
        const bool hit2 = hit && nh.bt2 < t_max;
        const int widx2 =
            CLUSTERED && hit2 ? __ldg(members + nh.bidx2) : nh.bidx2;
        res2[slot] = static_cast<ResT>(hit2 ? widx2 : -1);
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
  img[3 * i_loc + 0] = acc_r / fspp;
  img[3 * i_loc + 1] = acc_g / fspp;
  img[3 * i_loc + 2] = acc_b / fspp;
}

template <typename ResT, int RECORD, bool CLUSTERED>
int launch(const void* geom, const void* attr, int n_spheres,
           const void* bounds, const void* members, int n_clusters,
           int cluster_size, const void* cam,
           int pixel_base, int n_pix, void* img, void* res, void* res2,
           unsigned int seed,
           unsigned int sample_base, int spp, int max_depth, float t_min,
           float t_max, int width, int height, cudaStream_t stream) {
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  k2_record_kernel<ResT, RECORD, CLUSTERED><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(geom), static_cast<const float4*>(attr),
      n_spheres, static_cast<const float4*>(bounds),
      static_cast<const int*>(members), n_clusters, cluster_size,
      static_cast<const float*>(cam), pixel_base, n_pix,
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
// Thread i renders the absolute pixel pixel_base + i.
// bounds != nullptr selects the cluster-culled loop: geom/attr rows are then
// in the plan's order, bounds is [n_clusters] float4, members [n_spheres]
// int32 (row -> scene index) and cluster_size >= 1 the rows per cluster;
// otherwise the three are unused.
// Returns the launch's cudaError_t, or cudaErrorInvalidValue for arguments
// it does not take; the kernel itself runs asynchronously.
extern "C" int brt_k2_record(const void* geom, const void* attr,
                             int n_spheres, const void* bounds,
                             const void* members, int n_clusters,
                             int cluster_size, const void* cam, int pixel_base,
                             int n_pix, void* img, void* res, void* res2,
                             int res_bytes,
                             int record, unsigned int seed,
                             unsigned int sample_base, int spp, int max_depth,
                             float t_min, float t_max, int width, int height,
                             void* stream) {
  if (n_pix <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool clustered = bounds != nullptr;
  if (clustered && (members == nullptr || n_clusters < 1 || cluster_size < 1))
    return static_cast<int>(cudaErrorInvalidValue);
#define BRT_K2_ARGS                                                        \
  geom, attr, n_spheres, bounds, members, n_clusters, cluster_size, cam,   \
      pixel_base, n_pix, img, res, res2, seed, sample_base, spp, max_depth, \
      t_min, t_max, width, height, st
#define BRT_K2_DISPATCH(T, R)                                   \
  return clustered ? launch<T, R, true>(BRT_K2_ARGS)            \
                   : launch<T, R, false>(BRT_K2_ARGS)
  if (record == 0) BRT_K2_DISPATCH(int16_t, 0);
  if (res_bytes == 2 && record == 1) BRT_K2_DISPATCH(int16_t, 1);
  if (res_bytes == 2 && record == 2) BRT_K2_DISPATCH(int16_t, 2);
  if (res_bytes == 4 && record == 1) BRT_K2_DISPATCH(int32_t, 1);
  if (res_bytes == 4 && record == 2) BRT_K2_DISPATCH(int32_t, 2);
#undef BRT_K2_DISPATCH
#undef BRT_K2_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
