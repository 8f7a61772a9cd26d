// K3 on Hopper: the replay-gradient backward of the fast gradient path.  A
// persistent grid of 128-thread blocks; each thread walks recorded (pixel,
// sample) paths with a grid stride.
//
// Replaces bevy_raytrace_tpu/kernels/replay_grad.py::_make_kernel (the TPU's
// fused backward, launched by replay_grad).  Given the image cotangent g and
// the winner residuals K2 recorded, it returns the cotangents of the sphere
// table [S, 11] and of the 16 packed camera scalars, with 1/spp folded in.
// In stripe mode (pixel_base, n_pix = the stripe's pixel count) g and the
// residuals hold one stripe, indexed by the local pixel, while the path's
// RNG counters and camera ray come from the absolute pixel pixel_base + i;
// the result is then the stripe's partial sum, which the caller adds to the
// other stripes' (one all-reduce in inverse/shard_grad.py).
// The TPU kernel takes jax.vjp of its replayed trace inside the kernel; CUDA
// has no autodiff, so the adjoint below is derived by hand from
// inverse/fast_grad.py::replay_paths, step by step, with the same derivative
// policy as autograd of the PyTorch replay (the plain version it is held
// against):
//
//   forward sweep  replay the path from the residuals: per bounce, read the
//                  winner row, recompute its exact t with the centered
//                  quadratic (no sphere search), shade with the same PCG4D
//                  counters.  The state entering each bounce (origin,
//                  direction, throughput: 9 floats) is kept in a per-thread
//                  array of at most kMaxDepth entries;
//   reverse sweep  from the last bounce to the first, recompute the bounce's
//                  intermediates from its stored state and apply the adjoint
//                  of every step, then the adjoint of the thin-lens camera.
//                  The warp walks its bounces together, from the deepest
//                  path's last bounce down: a lane past its own path, or on
//                  the sky, adds no row that round.
//
// The forward replay is the plain version's arithmetic operation for
// operation (inverse/fast_grad.py::replay_paths on component planes): this
// file is built with -fmad=false, divisions and square roots are correctly
// rounded, and sums run in the same order.  So on the card both replay the
// SAME paths: a last-ulp difference could flip a discrete choice (a grazing
// metal bounce's scatter_ok, a tangent hit) and change a path's whole
// gradient, which no tolerance absorbs.
//
// Discrete choices are frozen at their replayed values: the recorded winner,
// hit or miss, the near/far root, the material branch, the Schlick choice and
// scatter_ok.  Guards, as in the replay: the sqrt of the quadratic has no
// gradient where the replayed discriminant is <= 0 (a tangency the recorder
// saw as a hit); the refraction sqrt none below k = 1e-12; rsqrt_guard none
// below 1e-20.  With edge_softness > 0 the two-sided silhouette term adds
// ds * (L_path - L_bg), with L_bg the runner-up's albedo times the sky (or
// the sky) from res2, the runner-up's albedo held constant.
//
// Accumulation, in float64 across paths: a row of the flagship frame gathers
// ~1e8 path terms, and a float32 running sum loses about 1% of it (measured
// on the H100 as the gap between the chunked and unchunked flagship
// gradients); the wrapper rounds the result to float32 once.  Columns 7
// (kind) and 10 (material id) get no gradient, so a row's cotangent is 9
// floats.  Per bounce, the warp's lanes are grouped by row
// (__match_any_sync); each group's 9 cotangents are summed in float64 by its
// members from a per-warp staging area (ascending lane order), and one add
// per group and column goes to the table.  40-65% of an rtiow frame's hits,
// and nearly all of config1's, land on one row (the ground), so a warp adds
// a handful of rows where 32 lanes each added one.  The table is:
//   shared (table_mode 1)  a block-private float64 [S, 9] table in dynamic
//                          shared memory, zeroed once, flushed into d_table
//                          with one float64 atomicAdd per nonzero entry after
//                          the block's last path.  The grid is persistent
//                          (SMs x resident blocks, from the occupancy API at
//                          the table's size), so the zeroing and the flush
//                          are paid a few hundred times, not once per 128
//                          paths;
//   global (table_mode 0)  the group adds go straight to d_table with float64
//                          atomics: tables above what a block may hold in
//                          shared memory (~3,150 rows on an H100).
// The wrapper picks the mode from S (kernels/replay_grad.py::table_plan); both
// are the kernel.  The camera's 16 sums are float32 within a path, reduced
// over the warp with shuffles after each grid-stride round, added by lane 0
// into its warp's float64 slots in shared memory, and flushed once a block.
// The order of the atomics varies from run to run, so the result is not
// bit-deterministic.
//
// SASS (cuobjdump -sass of the sm_90a build, nvcc 12.9): a float64
// atomicAdd to shared memory has no native instruction; it compiles into a
// compare-and-swap loop (LDS, DADD, ATOMS.CAST.SPIN.64, retry on a lost
// race), while the same add to device memory is one REDG.E.ADD.F64.RN, done
// at the L2.  With the aggregation in front, a loop iteration races only the
// block's other warps on that row and column.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md): with
// the adds aggregated it runs at 1.1-1.45x the BRT_K3_TABLE_ADD = 0 probe,
// so what is left is the replay's own arithmetic (no fused multiply-add,
// correctly rounded divisions and square roots, the per-thread state array
// in local memory, hit_forward twice a bounce), far above the bytes it must
// move.  No sphere search runs: the cost does not grow with the sphere
// count.  The residual reads are coalesced (consecutive threads, consecutive
// pids of one sample, in every grid-stride round).
//
// Measurement probes, built only by profile_grad.py (the default build is
// the kernel): BRT_K3_TABLE_ADD = 0 adds every cotangent into a per-thread
// register instead of the table (no staging, no atomics: the floor; its
// d_table is wrong).  BRT_K3_STEP selects a design step for the A/B: 2 (the
// kernel), 1 without the warp aggregation (each lane adds its own row, into
// the block's table or d_table), 0 neither persistence nor aggregation nor a
// block table: one block per 128 paths, every lane's float64 atomics
// straight into d_table whatever the table mode (the A/B's baseline).

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

#ifndef BRT_K3_TABLE_ADD
#define BRT_K3_TABLE_ADD 64
#endif
#ifndef BRT_K3_STEP
#define BRT_K3_STEP 2
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDepth = 16;  // replay_grad.MAX_DEPTH must equal this
constexpr int kCols = 11;      // sphere_table columns
constexpr int kGradCols = 9;   // the columns that get a gradient: 0-6, 8, 9

// sphere_table column of gradient column c.
__device__ __forceinline__ int table_col(int c) { return c < 7 ? c : c + 1; }

struct Row {
  float c[3], r, alb[3], kind, fuzz, ior;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ tbl, int i) {
  const float* p = tbl + static_cast<size_t>(kCols) * i;
  Row w;
  w.c[0] = __ldg(p + 0);
  w.c[1] = __ldg(p + 1);
  w.c[2] = __ldg(p + 2);
  w.r = __ldg(p + 3);
  w.alb[0] = __ldg(p + 4);
  w.alb[1] = __ldg(p + 5);
  w.alb[2] = __ldg(p + 6);
  w.kind = __ldg(p + 7);
  w.fuzz = __ldg(p + 8);
  w.ior = __ldg(p + 9);
  return w;
}

// 1 / sqrt(max(n2, 1e-20)), each step correctly rounded: the plain
// version's two operations, where rsqrtf would differ in the last ulp.
__device__ __forceinline__ float inv_sqrt_guard(float n2) {
  return 1.0f / sqrtf(fmaxf(n2, 1e-20f));
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// The forward of one replayed bounce at a recorded hit, keeping every
// intermediate the adjoint reads.
struct HitFwd {
  float oc[3], hb, oc2, sq, t, h[3], inv_r, sgn, n[3], ru[3];
  bool pos, near, front, refl;
  float ddn, cb;                              // reflect, metal fuzz
  float ratio, dn, cos_t, pp[3], pdot, sqk;   // dielectric
  float v[3], vv, q;  // the scatter vector before normalizing, |v|^2, 1/|v|
  float sdir[3];
  bool ok;
};

__device__ __forceinline__ void hit_forward(const float o[3], const float d[3],
                                            const Row& w, float t_min,
                                            const float u[4], HitFwd& f) {
#pragma unroll
  for (int k = 0; k < 3; ++k) f.oc[k] = o[k] - w.c[k];
  f.hb = f.oc[0] * d[0] + f.oc[1] * d[1] + f.oc[2] * d[2];
  f.oc2 = f.oc[0] * f.oc[0] + f.oc[1] * f.oc[1] + f.oc[2] * f.oc[2];
  const float cq = f.oc2 - w.r * w.r;
  const float disc = f.hb * f.hb - cq;
  f.pos = disc > 0.f;
  f.sq = f.pos ? sqrtf(disc) : 0.f;
  const float rn = -f.hb - f.sq;
  f.near = rn > t_min;
  f.t = f.near ? rn : f.sq - f.hb;
#pragma unroll
  for (int k = 0; k < 3; ++k) f.h[k] = o[k] + f.t * d[k];
  f.inv_r = 1.0f / (w.r == 0.f ? 1.f : w.r);
  float ow[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) ow[k] = (f.h[k] - w.c[k]) * f.inv_r;
  f.front = dot3(d, ow) < 0.f;
  f.sgn = f.front ? 1.f : -1.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) f.n[k] = ow[k] * f.sgn;
  brt::unit_vector(u[0], u[1], f.ru);

  if (brt::is_lambertian(w.kind)) {
#pragma unroll
    for (int k = 0; k < 3; ++k) f.v[k] = f.n[k] + f.ru[k];
    if ((fabsf(f.v[0]) + fabsf(f.v[1]) + fabsf(f.v[2])) < 1e-8f) {
#pragma unroll
      for (int k = 0; k < 3; ++k) f.v[k] = f.n[k];
    }
  } else {
    f.ddn = dot3(d, f.n);
    float rr[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) rr[k] = d[k] - 2.0f * f.ddn * f.n[k];
    if (brt::is_metal(w.kind)) {
      f.cb = brt::cbrt_pos(u[2]);
      const float fz = w.fuzz * f.cb;
#pragma unroll
      for (int k = 0; k < 3; ++k) f.v[k] = rr[k] + fz * f.ru[k];
    } else {
      f.ratio = f.front ? 1.0f / w.ior : w.ior;
      f.dn = -(d[0] * f.n[0] + d[1] * f.n[1] + d[2] * f.n[2]);
      f.cos_t = fminf(f.dn, 1.0f);
      const float sin_t = sqrtf(fmaxf(0.f, 1.0f - f.cos_t * f.cos_t));
      float r0 = (1.0f - f.ratio) / (1.0f + f.ratio);
      r0 = r0 * r0;
      const float m1 = 1.0f - f.cos_t;
      const float m2 = m1 * m1;
      const float schlick = r0 + (1.0f - r0) * (m2 * m2 * m1);
      f.refl = f.ratio * sin_t > 1.0f || schlick > u[3];
      if (f.refl) {
#pragma unroll
        for (int k = 0; k < 3; ++k) f.v[k] = rr[k];
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          f.pp[k] = f.ratio * (d[k] + f.cos_t * f.n[k]);
        f.pdot = f.pp[0] * f.pp[0] + f.pp[1] * f.pp[1] + f.pp[2] * f.pp[2];
        f.sqk = sqrtf(fabsf(1.0f - f.pdot));
#pragma unroll
        for (int k = 0; k < 3; ++k) f.v[k] = f.pp[k] - f.sqk * f.n[k];
      }
    }
  }
  f.vv = f.v[0] * f.v[0] + f.v[1] * f.v[1] + f.v[2] * f.v[2];
  f.q = inv_sqrt_guard(f.vv);
#pragma unroll
  for (int k = 0; k < 3; ++k) f.sdir[k] = f.v[k] * f.q;
  f.ok = !brt::is_metal(w.kind) || dot3(f.sdir, f.n) > 0.f;
}

// Adjoint of reflect: rr = d - 2 (d.n) n.
__device__ __forceinline__ void reflect_adjoint(const float d[3],
                                                const float n[3], float ddn,
                                                const float g_rr[3],
                                                float g_d[3], float g_n[3]) {
  const float g_ddn = -2.0f * dot3(g_rr, n);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_d[k] += g_rr[k] + g_ddn * n[k];
    g_n[k] += -2.0f * ddn * g_rr[k] + g_ddn * d[k];
  }
}

// Reverse of one replayed hit bounce.  On entry go, gd, gtp hold the
// adjoints of the NEXT bounce's origin (the hit point), direction (the
// scatter direction) and throughput; on return those of this bounce's.  The
// row's cotangent lands in grow, the 9 columns that get one (kGradCols).
template <bool kEdge>
__device__ __forceinline__ void hit_adjoint(const float o[3], const float d[3],
                                            const float tp[3], const Row& w,
                                            const HitFwd& f, float edge_soft,
                                            const float bg[3],
                                            const float G[3], float go[3],
                                            float gd[3], float gtp[3],
                                            float grow[kGradCols]) {
  const bool lam = brt::is_lambertian(w.kind);
  const bool met = brt::is_metal(w.kind);
  const bool die = !lam && !met;
  float g_h[3], g_o[3] = {0.f, 0.f, 0.f}, g_d[3] = {0.f, 0.f, 0.f};
  float g_n[3] = {0.f, 0.f, 0.f}, g_c[3] = {0.f, 0.f, 0.f};
  float g_r = 0.f, g_hb = 0.f, g_oc2 = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) g_h[k] = go[k];

  // ---- throughput: tp' = tp * at * st (st == 1 in value) -----------------
  float g_st = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float at = die ? 1.0f : w.alb[k];
    g_st += gtp[k] * tp[k] * at;
    if (!die) grow[4 + k] += gtp[k] * tp[k];
    gtp[k] *= at;
  }

  // ---- two-sided silhouette term -----------------------------------------
  if (kEdge) {
    // rad += (1 - st) tp L_bg: (1 - st) is 0 in value, so only st moves.
    g_st -= G[0] * tp[0] * bg[0] + G[1] * tp[1] * bg[1] + G[2] * tp[2] * bg[2];
    const float bperp2 = f.oc2 - f.hb * f.hb;
    const float r2 = w.r * w.r;
    const float r2m = fmaxf(r2, 1e-12f);
    const float em = 1.0f - bperp2 / r2m;
    const float s = 1.0f / (1.0f + expf(-(em / edge_soft)));
    const float g_em = g_st * ((1.0f - s) * s) / edge_soft;
    const float g_bperp2 = -g_em / r2m;
    if (r2 > 1e-12f) g_r += g_em * bperp2 / (r2m * r2m) * 2.0f * w.r;
    g_oc2 += g_bperp2;
    g_hb += -2.0f * f.hb * g_bperp2;
  }

  // ---- the scatter direction: sdir = v / |v| -----------------------------
  float g_v[3];
  {
    const float dq = f.vv > 1e-20f ? -0.5f * f.q * f.q * f.q : 0.f;
    const float c2 = 2.0f * dot3(gd, f.v) * dq;
#pragma unroll
    for (int k = 0; k < 3; ++k) g_v[k] = gd[k] * f.q + f.v[k] * c2;
  }
  if (lam) {  // v = n + ru (or n where degenerate)
#pragma unroll
    for (int k = 0; k < 3; ++k) g_n[k] += g_v[k];
  } else if (met) {  // v = reflect(d, n) + fuzz cbrt(u3) ru
    grow[7] += dot3(g_v, f.ru) * f.cb;  // fuzz
    reflect_adjoint(d, f.n, f.ddn, g_v, g_d, g_n);
  } else if (f.refl) {  // dielectric, reflected
    reflect_adjoint(d, f.n, f.ddn, g_v, g_d, g_n);
  } else {  // dielectric, refracted: v = pp - sqrt(|1 - pp.pp|) n
    float g_pp[3];
    const float g_sqk = -dot3(g_v, f.n);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_pp[k] = g_v[k];
      g_n[k] += -f.sqk * g_v[k];
    }
    if (fabsf(1.0f - f.pdot) > 1e-12f) {
      const float g_kk = g_sqk * 0.5f / f.sqk;
      const float g_p = (1.0f - f.pdot) > 0.f ? -g_kk : g_kk;
#pragma unroll
      for (int k = 0; k < 3; ++k) g_pp[k] += 2.0f * f.pp[k] * g_p;
    }
    // pp = ratio (d + cos_t n)
    float qv[3], g_qv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      qv[k] = d[k] + f.cos_t * f.n[k];
      g_qv[k] = f.ratio * g_pp[k];
      g_d[k] += g_qv[k];
      g_n[k] += f.cos_t * g_qv[k];
    }
    const float g_ratio = dot3(g_pp, qv);
    const float g_cos = dot3(g_qv, f.n);
    if (f.dn <= 1.0f) {  // cos_t = min(-(d.n), 1)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g_d[k] += -g_cos * f.n[k];
        g_n[k] += -g_cos * d[k];
      }
    }
    grow[8] += f.front ? -g_ratio * f.ratio * f.ratio : g_ratio;  // ior
  }

  // ---- normal: n = sgn (h - c) / r ---------------------------------------
  float g_inv_r = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float g_ow = f.sgn * g_n[k];
    g_inv_r += g_ow * (f.h[k] - w.c[k]);
    g_h[k] += g_ow * f.inv_r;
    g_c[k] -= g_ow * f.inv_r;
  }
  if (w.r != 0.f) g_r -= g_inv_r * f.inv_r * f.inv_r;

  // ---- hit point: h = o + t d, t the recorded winner's exact root --------
  float g_t = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_o[k] += g_h[k];
    g_d[k] += f.t * g_h[k];
    g_t += g_h[k] * d[k];
  }
  g_hb -= g_t;  // t = -hb -+ sq
  if (f.pos) {
    const float g_disc = (f.near ? -g_t : g_t) * 0.5f / f.sq;
    g_hb += 2.0f * f.hb * g_disc;  // disc = hb^2 - (oc2 - r^2)
    g_oc2 -= g_disc;
    g_r += 2.0f * w.r * g_disc;
  }
  // hb = oc.d, oc2 = oc.oc, oc = o - c
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float g_oc = g_hb * d[k] + 2.0f * f.oc[k] * g_oc2;
    g_d[k] += g_hb * f.oc[k];
    g_o[k] += g_oc;
    g_c[k] -= g_oc;
  }

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    grow[k] += g_c[k];
    go[k] = g_o[k];
    gd[k] = g_d[k];
  }
  grow[3] += g_r;
}


// One float64 add into the table: the block's [S, 9] table in shared memory
// (kShared) or d_table's [S, 11] rows.
template <bool kShared>
__device__ __forceinline__ void add_entry(double* tbl, int row, int c,
                                          double v) {
  if (kShared)
    atomicAdd(tbl + row * kGradCols + c, v);
  else
    atomicAdd(tbl + static_cast<size_t>(row) * kCols + table_col(c), v);
}

// Adds one bounce's row cotangents of the whole warp: every lane calls it
// (full mask), with row = -1 where it adds nothing.  stage is the warp's
// [kGradCols][32] staging area; `sink` is the register the
// BRT_K3_TABLE_ADD == 0 probe adds into.
template <bool kShared>
__device__ __forceinline__ void add_rows(double* tbl, int row,
                                         const float grow[kGradCols],
                                         float (*stage)[32], int lane,
                                         float& sink) {
#if BRT_K3_TABLE_ADD == 0
#pragma unroll
  for (int c = 0; c < kGradCols; ++c) sink += grow[c];
#elif BRT_K3_STEP < 2
  if (row >= 0) {
#pragma unroll
    for (int c = 0; c < kGradCols; ++c)
      if (grow[c] != 0.f)
        add_entry<kShared>(tbl, row, c, static_cast<double>(grow[c]));
  }
#else
  const unsigned peers = __match_any_sync(0xffffffffu, row);
#pragma unroll
  for (int c = 0; c < kGradCols; ++c) stage[c][lane] = grow[c];
  __syncwarp();
  if (row >= 0) {
    // The group's members share its 9 columns: member `rank` sums columns
    // rank, rank + n, ... over the group, lowest lane first.
    const int n = __popc(peers);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    for (int c = rank; c < kGradCols; c += n) {
      double s = 0.0;
      for (unsigned m = peers; m != 0u; m &= m - 1u)
        s += static_cast<double>(stage[c][__ffs(m) - 1]);
      if (s != 0.0) add_entry<kShared>(tbl, row, c, s);
    }
  }
  __syncwarp();  // the next bounce overwrites the staging area
#endif
}

// The gradient of path (s, pid) when `active`; an inactive lane (past the
// last path) takes part in the warp's adds only.
template <typename ResT, bool kEdge, bool kShared>
__device__ __forceinline__ void path_grad(
    bool active, const float* __restrict__ tbl, const brt::Cam& c,
    const ResT* __restrict__ res, const ResT* __restrict__ res2,
    const float* __restrict__ g, double* add_tbl, int pixel_base, int n_pix,
    int s, int pid, uint32_t seed, uint32_t sample, int max_depth,
    float t_min, float edge_soft, float inv_spp, int width, int height,
    float (*stage)[32], int lane, float gc[16], float& sink) {
  float G[3] = {0.f, 0.f, 0.f};
  if (active) {
    G[0] = g[3 * pid] * inv_spp;
    G[1] = g[3 * pid + 1] * inv_spp;
    G[2] = g[3 * pid + 2] * inv_spp;
  }
  // g and the residuals are indexed by the local pid; the RNG counters and
  // the pixel's coordinates come from its absolute id.
  const int apid = pixel_base + pid;
  const uint32_t upid = static_cast<uint32_t>(apid);

  // ---- camera ray, keeping what its adjoint reads ------------------------
  uint32_t ca = upid, cb = sample, cc = brt::CAMERA_STREAM, cd = seed;
  brt::pcg4d(ca, cb, cc, cd);
  const float px = static_cast<float>(apid % width);
  const float py = static_cast<float>(apid / width);
  const float s_im = (px + brt::to_unit(ca)) / static_cast<float>(width);
  const float t_im = 1.0f - (py + brt::to_unit(cb)) / static_cast<float>(height);
  const float ru = sqrtf(brt::to_unit(cc));
  const float phi = brt::TWO_PI * brt::to_unit(cd);
  const float lcos = ru * cosf(phi), lsin = ru * sinf(phi);
  const float du = lcos * c.lens_r, dv = lsin * c.lens_r;
  const float cu[3] = {c.ux, c.uy, c.uz}, cv[3] = {c.vx, c.vy, c.vz};
  const float cw[3] = {c.wx, c.wy, c.wz}, co[3] = {c.ox, c.oy, c.oz};
  const float sf = 2.0f * s_im - 1.0f, tf = 2.0f * t_im - 1.0f;
  const float su = sf * c.half_w * c.focus, tv = tf * c.half_h * c.focus;
  float o[3], tvec[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = co[k] + du * cu[k] + dv * cv[k];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    tvec[k] = co[k] - c.focus * cw[k] + su * cu[k] + tv * cv[k] - o[k];
  const float tn2 = dot3(tvec, tvec);
  const float tq = inv_sqrt_guard(tn2);
  float d[3] = {tvec[0] * tq, tvec[1] * tq, tvec[2] * tq};

  // ---- forward sweep -----------------------------------------------------
  float state[kMaxDepth][9];
  float tp[3] = {1.f, 1.f, 1.f};
  int nb = 0;
  const size_t stride = static_cast<size_t>(n_pix);
  const size_t base = static_cast<size_t>(s) * max_depth * stride + pid;
  for (int b = 0; active && b < max_depth; ++b) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      state[b][k] = o[k];
      state[b][3 + k] = d[k];
      state[b][6 + k] = tp[k];
    }
    nb = b + 1;
    const int rec = static_cast<int>(res[base + b * stride]);
    if (rec < 0) break;  // a miss: the sky, and the path ends
    const Row w = load_row(tbl, rec);
    uint32_t ba = upid, bb = sample, bc = static_cast<uint32_t>(b), bd = seed;
    brt::pcg4d(ba, bb, bc, bd);
    const float u[4] = {brt::to_unit(ba), brt::to_unit(bb), brt::to_unit(bc),
                        brt::to_unit(bd)};
    HitFwd f;
    hit_forward(o, d, w, t_min, u, f);
    if (brt::is_lambertian(w.kind) || brt::is_metal(w.kind)) {
#pragma unroll
      for (int k = 0; k < 3; ++k) tp[k] *= w.alb[k];
    }
    if (!f.ok) break;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = f.h[k];
      d[k] = f.sdir[k];
    }
  }

  // ---- reverse sweep, the warp's bounces together ------------------------
  float go[3] = {0.f, 0.f, 0.f}, gd[3] = {0.f, 0.f, 0.f};
  float gtp[3] = {0.f, 0.f, 0.f};
  const int nb_warp = __reduce_max_sync(0xffffffffu, nb);
  for (int b = nb_warp - 1; b >= 0; --b) {
    int row = -1;
    float grow[kGradCols] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (b < nb) {
      float bo[3], bdir[3], btp[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bo[k] = state[b][k];
        bdir[k] = state[b][3 + k];
        btp[k] = state[b][6 + k];
      }
      const int rec = static_cast<int>(res[base + b * stride]);
      float sk_r, sk_g;
      brt::sky(bdir[1], sk_r, sk_g);
      if (rec < 0) {  // rad += tp * sky(d): the path's last bounce
        gtp[0] = G[0] * sk_r;
        gtp[1] = G[1] * sk_g;
        gtp[2] = G[2];
        gd[0] = 0.f;
        gd[1] = -0.25f * G[0] * btp[0] - 0.15f * G[1] * btp[1];
        gd[2] = 0.f;
        go[0] = go[1] = go[2] = 0.f;
      } else {
        const Row w = load_row(tbl, rec);
        uint32_t ba = upid, bb = sample, bc = static_cast<uint32_t>(b),
                 bd = seed;
        brt::pcg4d(ba, bb, bc, bd);
        const float u[4] = {brt::to_unit(ba), brt::to_unit(bb),
                            brt::to_unit(bc), brt::to_unit(bd)};
        HitFwd f;
        hit_forward(bo, bdir, w, t_min, u, f);
        float bg[3] = {sk_r, sk_g, 1.0f};
        if (kEdge) {
          const int rec2 = static_cast<int>(res2[base + b * stride]);
          if (rec2 >= 0) {
            const float* p2 = tbl + static_cast<size_t>(kCols) * rec2;
            bg[0] *= __ldg(p2 + 4);
            bg[1] *= __ldg(p2 + 5);
            bg[2] *= __ldg(p2 + 6);
          }
        }
        hit_adjoint<kEdge>(bo, bdir, btp, w, f, edge_soft, bg, G, go, gd, gtp,
                           grow);
        row = rec;
      }
    }
    add_rows<kShared>(add_tbl, row, grow, stage, lane, sink);
  }
  if (!active) return;

  // ---- camera adjoint: o = co + du u + dv v;  d = T / |T| ----------------
  float g_t[3];
  {
    const float dq = tn2 > 1e-20f ? -0.5f * tq * tq * tq : 0.f;
    const float c2 = 2.0f * dot3(gd, tvec) * dq;
#pragma unroll
    for (int k = 0; k < 3; ++k) g_t[k] = gd[k] * tq + tvec[k] * c2;
  }
  // T = co - focus w + su u + tv v - o
  const float g_su = dot3(g_t, cu), g_tv = dot3(g_t, cv);
  float g_o[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_o[k] = go[k] - g_t[k];
    gc[k] += g_t[k] + g_o[k];                   // origin
    gc[3 + k] += su * g_t[k] + du * g_o[k];     // u
    gc[6 + k] += tv * g_t[k] + dv * g_o[k];     // v
    gc[9 + k] += -c.focus * g_t[k];             // w
  }
  gc[12] += sf * c.focus * g_su;                // half_width
  gc[13] += tf * c.focus * g_tv;                // half_height
  gc[14] += lcos * dot3(g_o, cu) + lsin * dot3(g_o, cv);  // lens_radius
  gc[15] += -dot3(cw, g_t) + sf * c.half_w * g_su + tf * c.half_h * g_tv;
}

template <typename ResT, bool kEdge, bool kShared>
__global__ void __launch_bounds__(kThreads)
    k3_replay_grad_kernel(const float* __restrict__ tbl,
                          const float* __restrict__ cam_in,
                          const ResT* __restrict__ res,
                          const ResT* __restrict__ res2,
                          const float* __restrict__ g,
                          double* __restrict__ d_tbl,
                          double* __restrict__ d_cam, int n_rows,
                          int pixel_base, int n_pix, long long n_paths,
                          uint32_t seed, uint32_t sample_base, int max_depth,
                          float t_min, float edge_soft, float inv_spp,
                          int width, int height) {
  extern __shared__ double block_tbl[];  // kShared: [n_rows][kGradCols]
  __shared__ double cam_acc[kWarps][16];
  __shared__ float stage[kWarps][kGradCols][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (kShared) {
    for (int i = threadIdx.x; i < n_rows * kGradCols; i += kThreads)
      block_tbl[i] = 0.0;
  }
  if (threadIdx.x < kWarps * 16) (&cam_acc[0][0])[threadIdx.x] = 0.0;
  __syncthreads();

  const brt::Cam c = brt::load_cam(cam_in);
  double* add_tbl = kShared ? block_tbl : d_tbl;
  float sink = 0.f;
  // Every lane of a block runs the same rounds (the bound is the block's
  // first path), so the warp-wide primitives see a full mask.
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long first = static_cast<long long>(blockIdx.x) * kThreads;
       first < n_paths; first += step) {
    const long long path = first + threadIdx.x;
    const bool active = path < n_paths;
    const int s = active ? static_cast<int>(path / n_pix) : 0;
    const int pid = active ? static_cast<int>(path % n_pix) : 0;
    float gc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) gc[k] = 0.f;
    path_grad<ResT, kEdge, kShared>(
        active, tbl, c, res, res2, g, add_tbl, pixel_base, n_pix, s, pid,
        seed, sample_base + static_cast<uint32_t>(s), max_depth, t_min,
        edge_soft, inv_spp, width, height, stage[warp], lane, gc, sink);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float v = gc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) cam_acc[warp][k] += static_cast<double>(v);
    }
  }
#if BRT_K3_TABLE_ADD == 0
  if (sink == -1.2345e-38f) d_tbl[0] = sink;  // keeps the probe's adds live
#endif
  __syncthreads();
  if (kShared) {
    for (int i = threadIdx.x; i < n_rows * kGradCols; i += kThreads) {
      const double v = block_tbl[i];
      if (v != 0.0)
        atomicAdd(d_tbl + static_cast<size_t>(i / kGradCols) * kCols +
                      table_col(i % kGradCols),
                  v);
    }
  }
  if (threadIdx.x < 16) {
    double v = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += cam_acc[w][threadIdx.x];
    if (v != 0.0) atomicAdd(d_cam + threadIdx.x, v);
  }
}

template <typename ResT, bool kEdge, bool kShared>
int launch(const void* tbl, const void* cam, const void* res,
           const void* res2, const void* g, void* d_tbl, void* d_cam,
           int n_rows, int pixel_base, int n_pix, int spp, unsigned int seed,
           unsigned int sample_base, int max_depth, float t_min,
           float edge_soft, float inv_spp, int width, int height,
           cudaStream_t stream) {
  const auto kernel = k3_replay_grad_kernel<ResT, kEdge, kShared>;
  const long long n_paths = static_cast<long long>(spp) * n_pix;
  long long blocks = (n_paths + kThreads - 1) / kThreads;
  const size_t smem =
      kShared ? static_cast<size_t>(n_rows) * kGradCols * sizeof(double) : 0;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
#if BRT_K3_STEP >= 1
  // The persistent grid: as many blocks as the SMs hold at this table size.
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  blocks = blocks < static_cast<long long>(sms) * per_sm
               ? blocks
               : static_cast<long long>(sms) * per_sm;
#endif
  k3_replay_grad_kernel<ResT, kEdge, kShared>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(tbl), static_cast<const float*>(cam),
      static_cast<const ResT*>(res), static_cast<const ResT*>(res2),
      static_cast<const float*>(g), static_cast<double*>(d_tbl),
      static_cast<double*>(d_cam), n_rows, pixel_base, n_pix, n_paths, seed,
      sample_base, max_depth, t_min, edge_soft, inv_spp, width, height);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most bytes of dynamic shared memory a K3 block may take for its table
// on the current device: the per-block opt-in maximum less the kernel's
// static shared memory.  Writes it to *out; returns a cudaError_t.
extern "C" int brt_k3_table_bytes_limit(int* out) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (err = cudaFuncGetAttributes(
           &attr, k3_replay_grad_kernel<int16_t, true, true>)) != cudaSuccess)
    return static_cast<int>(err);
  *out = optin - static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaSuccess);
}

// Launches K3 on `stream`.  Device pointers: tbl [S, 11] float (row-major),
// cam [16] float, res and res2 [spp, max_depth, n_pix] of res_bytes (2:
// int16, 4: int32), g [n_pix, 3] float, d_tbl [S, 11] and d_cam [16] double,
// which the kernel ADDS into (the caller zeroes them).  n_rows = S.
// table_mode: 1 = the block's table in shared memory (n_rows x 72 bytes must
// fit brt_k3_table_bytes_limit), 0 = adds straight into d_tbl.  res2 is read
// only when edge_soft > 0.  Path (s, i) is the absolute pixel pixel_base + i.
// Returns the launch's cudaError_t, or cudaErrorInvalidValue for arguments
// it does not take; the kernel itself runs asynchronously.
extern "C" int brt_k3_replay_grad(const void* tbl, const void* cam,
                                  const void* res, const void* res2,
                                  int res_bytes, const void* g, void* d_tbl,
                                  void* d_cam, int n_rows, int table_mode,
                                  int pixel_base, int n_pix, int spp,
                                  unsigned int seed, unsigned int sample_base,
                                  int max_depth, float t_min, float edge_soft,
                                  float inv_spp, int width, int height,
                                  void* stream) {
  if (max_depth > kMaxDepth || max_depth < 0 || n_rows < 0 ||
      (table_mode != 0 && table_mode != 1) ||
      (res_bytes != 2 && res_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pix <= 0 || spp <= 0 || max_depth == 0)
    return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BRT_K3_ARGS                                                           \
  tbl, cam, res, res2, g, d_tbl, d_cam, n_rows, pixel_base, n_pix, spp, seed, \
      sample_base, max_depth, t_min, edge_soft, inv_spp, width, height, st
#define BRT_K3_DISPATCH(T, E)                                       \
  return shared ? launch<T, E, true>(BRT_K3_ARGS)                   \
                : launch<T, E, false>(BRT_K3_ARGS)
  // The BRT_K3_STEP == 0 probe adds into d_tbl whatever the mode.
  const bool shared = table_mode == 1 && BRT_K3_STEP >= 1;
  const bool edge = edge_soft > 0.f;
  if (res_bytes == 2) {
    if (edge) BRT_K3_DISPATCH(int16_t, true);
    BRT_K3_DISPATCH(int16_t, false);
  }
  if (edge) BRT_K3_DISPATCH(int32_t, true);
  BRT_K3_DISPATCH(int32_t, false);
#undef BRT_K3_DISPATCH
#undef BRT_K3_ARGS
}
