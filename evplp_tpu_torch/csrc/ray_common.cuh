// Ray I/O, the slab test and the ray-triangle test of the three BVH
// traversal kernels (traverse.cu, packet7.cu, packet.cu).  traverse.cu
// uses the slab interval on its own and the kTies form of the triangle
// test; packet7.cu and packet.cu use slab_enter and the strict form.
//
// The kernels are held to each other hit for hit, which holds only if they
// round alike, so each test is written once, here.  Numerics: the kernels
// are built with -fmad=false, sums run in the order ((x + y) + z), division
// is IEEE; the plain PyTorch versions in evplp_tpu_torch/trace/ use the same
// formulas.  native/build.py hashes this header with each kernel's source,
// so an edit here rebuilds all three.

#pragma once

#include <cuda_runtime.h>

namespace evplp {

constexpr float kTriEps = 1e-9f;  // |det| cutoff of the triangle test
constexpr float kBig = 3.4e38f;

// The ray batch the wrapper hands over, and the outputs it allocated.
struct Rays {
  const float* __restrict__ o;      // (R, 3)
  const float* __restrict__ d;      // (R, 3)
  const float* __restrict__ t_min;  // (R,)
  const float* __restrict__ t_max;  // (R,)
  int num_rays;
  float* __restrict__ t;            // (R,)
  int* __restrict__ prim;           // (R,)
  float* __restrict__ u;            // (R,)
  float* __restrict__ v;            // (R,)
};

// One ray: origin, direction, 1/direction, t_min.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, lo;
};

// 1/x, or +-kBig where |x| <= 1e-20.
__device__ __forceinline__ float inv_dir(float x) {
  return fabsf(x) > 1e-20f ? 1.0f / x : (x >= 0.0f ? kBig : -kBig);
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float lo) {
  return Ray{ox, oy, oz, dx, dy, dz, inv_dir(dx), inv_dir(dy), inv_dir(dz),
             lo};
}

// Ray i of the batch.
__device__ __forceinline__ Ray load_ray(const Rays& r, int i) {
  return make_ray(r.o[3 * i], r.o[3 * i + 1], r.o[3 * i + 2], r.d[3 * i],
                  r.d[3 * i + 1], r.d[3 * i + 2], r.t_min[i]);
}

// The ray's slab interval [t_near, t_far] through the box [lo, hi].
__device__ __forceinline__ void slab(const Ray& r, float lox, float loy,
                                     float loz, float hix, float hiy,
                                     float hiz, float& t_near, float& t_far) {
  const float ax = (lox - r.ox) * r.ix, bx = (hix - r.ox) * r.ix;
  const float ay = (loy - r.oy) * r.iy, by = (hiy - r.oy) * r.iy;
  const float az = (loz - r.oz) * r.iz, bz = (hiz - r.oz) * r.iz;
  t_near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  t_far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
}

// Whether the slab interval [t_near, t_far] admits the ray at some
// t_near <= t.
__device__ __forceinline__ bool slab_admits(float t_near, float t_far,
                                            float t) {
  return t_near <= t_far && t_far >= 0.0f && t_near <= t;
}

// Whether the ray enters the box [lo, hi] at some t_near <= t.
__device__ __forceinline__ bool slab_enter(const Ray& r, float lox, float loy,
                                           float loz, float hix, float hiy,
                                           float hiz, float t) {
  float t_near, t_far;
  slab(r, lox, loy, loz, hix, hiy, hiz, t_near, t_far);
  return slab_admits(t_near, t_far, t);
}

// Double-sided Moller-Trumbore against the triangle (v0, e1, e2): whether
// the ray hits it with |det| > kTriEps at tt in (r.lo, t), or with kTies in
// (r.lo, t], so that the caller can break an exact tie in t; sets tt, uu,
// vv.
template <bool kTies = false>
__device__ __forceinline__ bool ray_tri(const Ray& r, float v0x, float v0y,
                                        float v0z, float e1x, float e1y,
                                        float e1z, float e2x, float e2y,
                                        float e2z, float t, float& tt,
                                        float& uu, float& vv) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = (e1x * px + e1y * py) + e1z * pz;
  const bool good = fabsf(det) > kTriEps;
  const float inv_det = good ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  uu = ((tx * px + ty * py) + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  vv = ((r.dx * qx + r.dy * qy) + r.dz * qz) * inv_det;
  tt = ((e2x * qx + e2y * qy) + e2z * qz) * inv_det;
  return good && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > r.lo &&
         (kTies ? tt <= t : tt < t);
}

// The same test with v0, e1, e2 read as three floats each.
__device__ __forceinline__ bool ray_tri(const Ray& r,
                                        const float* __restrict__ v0,
                                        const float* __restrict__ e1,
                                        const float* __restrict__ e2,
                                        float t, float& tt, float& uu,
                                        float& vv) {
  return ray_tri(r, v0[0], v0[1], v0[2], e1[0], e1[1], e1[2], e2[0], e2[1],
                 e2[2], t, tt, uu, vv);
}

}  // namespace evplp
