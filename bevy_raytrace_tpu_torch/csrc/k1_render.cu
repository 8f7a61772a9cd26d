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
//     Schlick); sky on a miss; depth exhaustion kills the path with black;
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

struct Cam {
  float ox, oy, oz, ux, uy, uz, vx, vy, vz, wx, wy, wz, half_w, half_h, lens_r,
      focus;
};

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
  Cam c;
  {
    float* cp = reinterpret_cast<float*>(&c);
#pragma unroll
    for (int k = 0; k < 16; ++k) cp[k] = __ldg(cam_in + k);
  }
  const int pid = pids[lane];
  const uint32_t upid = static_cast<uint32_t>(pid);
  const float px = static_cast<float>(pid % width);
  const float py = static_cast<float>(pid / width);
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, rounds = 0.f;

  for (int s = 0; s < spp; ++s) {
    const uint32_t su = sample_base + static_cast<uint32_t>(s);
    // ---- camera ray (thin lens) -------------------------------------------
    uint32_t ca = upid, cb = su, cc = brt::CAMERA_STREAM, cd = seed;
    brt::pcg4d(ca, cb, cc, cd);
    const float cu1 = brt::to_unit(ca), cu2 = brt::to_unit(cb);
    const float cu3 = brt::to_unit(cc), cu4 = brt::to_unit(cd);
    const float s_im = (px + cu1) / fw;
    const float t_im = 1.0f - (py + cu2) / fh;
    const float ru = sqrtf(cu3);
    const float phi = brt::TWO_PI * cu4;
    const float du = ru * cosf(phi) * c.lens_r;
    const float dv = ru * sinf(phi) * c.lens_r;
    float ox = c.ox + du * c.ux + dv * c.vx;
    float oy = c.oy + du * c.uy + dv * c.vy;
    float oz = c.oz + du * c.uz + dv * c.vz;
    const float sx_ = (2.0f * s_im - 1.0f) * c.half_w * c.focus;
    const float tv_ = (2.0f * t_im - 1.0f) * c.half_h * c.focus;
    const float tx = c.ox - c.focus * c.wx + sx_ * c.ux + tv_ * c.vx - ox;
    const float ty = c.oy - c.focus * c.wy + sx_ * c.uy + tv_ * c.vy - oy;
    const float tz = c.oz - c.focus * c.wz + sx_ * c.uz + tv_ * c.vz - oz;
    const float ginv = brt::rsqrt_guard(tx * tx + ty * ty + tz * tz);
    float dx = tx * ginv, dy = ty * ginv, dz = tz * ginv;
    float tp_r = 1.f, tp_g = 1.f, tp_b = 1.f;

    for (int bounce = 0; bounce < max_depth; ++bounce) {
      rounds += 1.0f;
      // ---- dense sweep: nearest hit, first index wins ties ----------------
      float best_t = 0.f;
      int best = -1;
      for (int i = 0; i < n_spheres; ++i) {
        const float4 g = __ldg(geom + i);
        const float ocx = ox - g.x, ocy = oy - g.y, ocz = oz - g.z;
        const float hb = ocx * dx + ocy * dy + ocz * dz;
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
        const float tsky = 0.5f * (dy + 1.0f);
        acc_r += tp_r * (1.0f - 0.5f * tsky);
        acc_g += tp_g * (1.0f - 0.3f * tsky);
        acc_b += tp_b;
        break;
      }
      // ---- exact t of the winner, hit frame -------------------------------
      const float4 g = __ldg(geom + best);
      const float4 a0 = __ldg(attr + 2 * best);
      const float4 a1 = __ldg(attr + 2 * best + 1);
      const float rocx = ox - g.x, rocy = oy - g.y, rocz = oz - g.z;
      const float hb_r = rocx * dx + rocy * dy + rocz * dz;
      const float cq_r = (rocx * rocx + rocy * rocy + rocz * rocz) - g.w;
      const float sq_r = sqrtf(fmaxf(hb_r * hb_r - cq_r, 0.f));
      const float rn_r = -hb_r - sq_r;
      const float bt = rn_r > t_min ? rn_r : sq_r - hb_r;
      const float hx = ox + bt * dx, hy = oy + bt * dy, hz = oz + bt * dz;
      float nx = (hx - g.x) * a0.x, ny = (hy - g.y) * a0.x,
            nz = (hz - g.z) * a0.x;
      const bool front = (dx * nx + dy * ny + dz * nz) < 0.f;
      if (!front) {
        nx = -nx;
        ny = -ny;
        nz = -nz;
      }
      const float kind = a1.x;
      // ---- shade -----------------------------------------------------------
      uint32_t ba = upid, bb = su, bc = static_cast<uint32_t>(bounce),
               bd = seed;
      brt::pcg4d(ba, bb, bc, bd);
      const float u1 = brt::to_unit(ba), u2 = brt::to_unit(bb);
      const float u3 = brt::to_unit(bc), u4 = brt::to_unit(bd);
      const float zs = 1.0f - 2.0f * u1;
      const float rs = sqrtf(fmaxf(0.f, 1.0f - zs * zs));
      const float ph = brt::TWO_PI * u2;
      const float rux = rs * cosf(ph), ruy = rs * sinf(ph), ruz = zs;

      float sx, sy, sz, at_r, at_g, at_b;
      if (kind < 0.5f) {  // Lambertian
        float lx = nx + rux, ly = ny + ruy, lz = nz + ruz;
        if ((fabsf(lx) + fabsf(ly) + fabsf(lz)) < 1e-8f) {
          lx = nx;
          ly = ny;
          lz = nz;
        }
        const float linv = brt::rsqrt_guard(lx * lx + ly * ly + lz * lz);
        sx = lx * linv;
        sy = ly * linv;
        sz = lz * linv;
        at_r = a0.y;
        at_g = a0.z;
        at_b = a0.w;
      } else {
        const float ddn = dx * nx + dy * ny + dz * nz;
        const float rx = dx - 2.0f * ddn * nx;
        const float ry = dy - 2.0f * ddn * ny;
        const float rz = dz - 2.0f * ddn * nz;
        if (kind < 1.5f) {  // metal
          const float fz = a1.y * brt::cbrt_pos(u3);
          float mx = rx + fz * rux, my = ry + fz * ruy, mz = rz + fz * ruz;
          const float minv = brt::rsqrt_guard(mx * mx + my * my + mz * mz);
          mx *= minv;
          my *= minv;
          mz *= minv;
          if (!((mx * nx + my * ny + mz * nz) > 0.f)) break;  // absorbed
          sx = mx;
          sy = my;
          sz = mz;
          at_r = a0.y;
          at_g = a0.z;
          at_b = a0.w;
        } else {  // dielectric
          const float ior = a1.z;
          const float ratio = front ? 1.0f / ior : ior;
          const float cos_t = fminf(-(dx * nx + dy * ny + dz * nz), 1.0f);
          const float sin_t = sqrtf(fmaxf(0.f, 1.0f - cos_t * cos_t));
          const bool cannot = ratio * sin_t > 1.0f;
          float r0 = (1.0f - ratio) / (1.0f + ratio);
          r0 = r0 * r0;
          const float m1 = 1.0f - cos_t;
          const float m2 = m1 * m1;
          const float schlick = r0 + (1.0f - r0) * (m2 * m2 * m1);
          float ex, ey, ez;
          if (cannot || schlick > u4) {
            ex = rx;
            ey = ry;
            ez = rz;
          } else {
            const float ppx = ratio * (dx + cos_t * nx);
            const float ppy = ratio * (dy + cos_t * ny);
            const float ppz = ratio * (dz + cos_t * nz);
            const float sqk =
                sqrtf(fabsf(1.0f - (ppx * ppx + ppy * ppy + ppz * ppz)));
            ex = ppx - sqk * nx;
            ey = ppy - sqk * ny;
            ez = ppz - sqk * nz;
          }
          const float einv = brt::rsqrt_guard(ex * ex + ey * ey + ez * ez);
          sx = ex * einv;
          sy = ey * einv;
          sz = ez * einv;
          at_r = at_g = at_b = 1.0f;
        }
      }
      tp_r *= at_r;
      tp_g *= at_g;
      tp_b *= at_b;
      ox = hx;
      oy = hy;
      oz = hz;
      dx = sx;
      dy = sy;
      dz = sz;
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
