// Device helpers shared by the port's CUDA kernels.
//
// CUDA counterparts of kernels/common.py (and of the helpers the JAX
// package's Pallas kernels use): PCG4D in native uint32_t arithmetic,
// the 24-bit unit-float map, the guarded rsqrt, the positive cube root, the
// thin-lens camera ray, the sky and the material scatter.  Keep the two in
// step: the kernels' plain PyTorch twins use the Python side.  K1 and K2
// shade with camera_ray and scatter; K3 replays the same steps in its own
// form (hit_forward), which keeps the intermediates its adjoint reads and
// normalizes with a correctly rounded 1/sqrt instead of rsqrtf.
#pragma once

#include <cstdint>

namespace brt {

// RNG stream of camera-ray generation; bounce events use stream = bounce.
constexpr uint32_t CAMERA_STREAM = 0x9E3779B9u;
constexpr float TWO_PI = 6.28318530717958647692f;  // rounds to float32(2*pi)
constexpr float INV_2POW24 = 1.0f / 16777216.0f;

__device__ __forceinline__ void pcg4d(uint32_t& x, uint32_t& y, uint32_t& z,
                                      uint32_t& w) {
  const uint32_t mul = 1664525u, add = 1013904223u;
  x = x * mul + add;
  y = y * mul + add;
  z = z * mul + add;
  w = w * mul + add;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return static_cast<float>(bits >> 8) * INV_2POW24;
}

__device__ __forceinline__ float rsqrt_guard(float n2) {
  return rsqrtf(fmaxf(n2, 1e-20f));
}

__device__ __forceinline__ float cbrt_pos(float v) {
  return v < 1e-30f ? 0.0f : expf(logf(fmaxf(v, 1e-30f)) * (1.0f / 3.0f));
}

// Material kinds, as sphere_table's column 7 stores them (floats).
__device__ __forceinline__ bool is_lambertian(float kind) { return kind < 0.5f; }
__device__ __forceinline__ bool is_metal(float kind) {
  return kind > 0.5f && kind < 1.5f;
}

// Camera.pack()'s 16 floats.
struct Cam {
  float ox, oy, oz, ux, uy, uz, vx, vy, vz, wx, wy, wz, half_w, half_h, lens_r,
      focus;
};

__device__ __forceinline__ Cam load_cam(const float* __restrict__ p) {
  Cam c;
  float* cp = reinterpret_cast<float*>(&c);
#pragma unroll
  for (int k = 0; k < 16; ++k) cp[k] = __ldg(p + k);
  return c;
}

// Thin-lens camera ray of pixel (px, py) with the CAMERA_STREAM uniforms
// cu1..cu4 (jitter, then lens): Camera.generate_rays in the kernels' form.
__device__ __forceinline__ void camera_ray(const Cam& c, float px, float py,
                                           float fw, float fh, float cu1,
                                           float cu2, float cu3, float cu4,
                                           float o[3], float d[3]) {
  const float s_im = (px + cu1) / fw;
  const float t_im = 1.0f - (py + cu2) / fh;
  const float ru = sqrtf(cu3);
  const float phi = TWO_PI * cu4;
  const float du = ru * cosf(phi) * c.lens_r;
  const float dv = ru * sinf(phi) * c.lens_r;
  o[0] = c.ox + du * c.ux + dv * c.vx;
  o[1] = c.oy + du * c.uy + dv * c.vy;
  o[2] = c.oz + du * c.uz + dv * c.vz;
  const float su = (2.0f * s_im - 1.0f) * c.half_w * c.focus;
  const float tv = (2.0f * t_im - 1.0f) * c.half_h * c.focus;
  const float tx = c.ox - c.focus * c.wx + su * c.ux + tv * c.vx - o[0];
  const float ty = c.oy - c.focus * c.wy + su * c.uy + tv * c.vy - o[1];
  const float tz = c.oz - c.focus * c.wz + su * c.uz + tv * c.vz - o[2];
  const float ginv = rsqrt_guard(tx * tx + ty * ty + tz * tz);
  d[0] = tx * ginv;
  d[1] = ty * ginv;
  d[2] = tz * ginv;
}

// Sky radiance of a unit direction with y component dy: (r, g, 1).
__device__ __forceinline__ void sky(float dy, float& r, float& g) {
  const float t = 0.5f * (dy + 1.0f);
  r = 1.0f - 0.5f * t;
  g = 1.0f - 0.3f * t;
}

// The unit-sphere sample of the bounce uniforms u1, u2.
__device__ __forceinline__ void unit_vector(float u1, float u2, float ru[3]) {
  const float zs = 1.0f - 2.0f * u1;
  const float rs = sqrtf(fmaxf(0.f, 1.0f - zs * zs));
  const float ph = TWO_PI * u2;
  ru[0] = rs * cosf(ph);
  ru[1] = rs * sinf(ph);
  ru[2] = zs;
}

// Scatter at a hit (core/materials.py::scatter): unit incoming direction d,
// normal n facing the ray, front face flag, the winner's kind/fuzz/ior and
// the bounce uniforms.  Writes the new unit direction; returns scatter_ok
// (false when a fuzzed metal reflection points below the surface).  The
// attenuation is the albedo, or 1 for a dielectric.
__device__ __forceinline__ bool scatter(const float d[3], const float n[3],
                                        bool front, float kind, float fuzz,
                                        float ior, float u1, float u2,
                                        float u3, float u4, float out[3]) {
  float ru[3];
  unit_vector(u1, u2, ru);
  float e[3];
  if (is_lambertian(kind)) {
    e[0] = n[0] + ru[0];
    e[1] = n[1] + ru[1];
    e[2] = n[2] + ru[2];
    if ((fabsf(e[0]) + fabsf(e[1]) + fabsf(e[2])) < 1e-8f) {
      e[0] = n[0];
      e[1] = n[1];
      e[2] = n[2];
    }
  } else {
    const float ddn = d[0] * n[0] + d[1] * n[1] + d[2] * n[2];
    const float rx = d[0] - 2.0f * ddn * n[0];
    const float ry = d[1] - 2.0f * ddn * n[1];
    const float rz = d[2] - 2.0f * ddn * n[2];
    if (is_metal(kind)) {
      const float fz = fuzz * cbrt_pos(u3);
      e[0] = rx + fz * ru[0];
      e[1] = ry + fz * ru[1];
      e[2] = rz + fz * ru[2];
    } else {  // dielectric
      const float ratio = front ? 1.0f / ior : ior;
      const float cos_t = fminf(-(d[0] * n[0] + d[1] * n[1] + d[2] * n[2]), 1.0f);
      const float sin_t = sqrtf(fmaxf(0.f, 1.0f - cos_t * cos_t));
      float r0 = (1.0f - ratio) / (1.0f + ratio);
      r0 = r0 * r0;
      const float m1 = 1.0f - cos_t;
      const float m2 = m1 * m1;
      const float schlick = r0 + (1.0f - r0) * (m2 * m2 * m1);
      if (ratio * sin_t > 1.0f || schlick > u4) {
        e[0] = rx;
        e[1] = ry;
        e[2] = rz;
      } else {
        const float ppx = ratio * (d[0] + cos_t * n[0]);
        const float ppy = ratio * (d[1] + cos_t * n[1]);
        const float ppz = ratio * (d[2] + cos_t * n[2]);
        const float sqk =
            sqrtf(fabsf(1.0f - (ppx * ppx + ppy * ppy + ppz * ppz)));
        e[0] = ppx - sqk * n[0];
        e[1] = ppy - sqk * n[1];
        e[2] = ppz - sqk * n[2];
      }
    }
  }
  const float inv = rsqrt_guard(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]);
  out[0] = e[0] * inv;
  out[1] = e[1] * inv;
  out[2] = e[2] * inv;
  return !is_metal(kind) || (out[0] * n[0] + out[1] * n[1] + out[2] * n[2]) > 0.f;
}

}  // namespace brt
