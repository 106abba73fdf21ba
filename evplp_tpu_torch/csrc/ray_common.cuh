// What the three BVH traversal kernels (traverse.cu, packet7.cu,
// packet.cu) share: the ray I/O, the slab test and the ray-triangle test,
// and the one-ray walk over the BVH's walk records
// (evplp_tpu_torch/accel/bvh.py:walk_layout): its record loads and child
// tests, the conservative leaf-box test, the leaf test that keeps the
// least (t, slot), and the ordered step and walk that traverse.cu runs for
// every ray, packet.cu for the lanes of a packet that falls apart, and
// packet7.cu as its inner loop.
//
// The kernels are held to each other and to trace/traverse.py:
// traverse_plain hit for hit, which holds only if they round alike and
// cull alike, so each test is written once, here.  Numerics: the kernels
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

// Double-sided Moller-Trumbore against the triangle (v0, e1, e2): whether
// the ray hits it with |det| > kTriEps at tt in (r.lo, t], so that the
// caller can break an exact tie in t (better_hit); sets tt, uu, vv.
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
         tt <= t;
}

// ---- The ordered walk over the walk records ----
//
// Record m (64 bytes, four float4) holds both children of an internal
// node: [left box min3 max3, right box min3 max3, left ref, right ref, left
// count, right count], the last four as int32.  A ref >= 0 is an internal
// child's record; a ref < 0 is a leaf whose first triangle (slot) is ~ref
// and whose triangle count is the count word.  Record 0 is a super-root
// whose left child is the root.  Triangle record s (48 bytes) is
// [v0, 0, e1, 0, e2, 0].  Slot ids grow with DFS leaf order, so the JAX
// CPU walk's "first triangle on ties" is the least slot among the hits at
// the least t, whatever order a walk visits the leaves in.

constexpr int kStackDepth = 64;  // trace/traverse.py STACK_DEPTH
constexpr int kQueueCap = 8;     // trace/traverse.py QUEUE_CAP
// float32 roundings of 1 + 2 gamma_3 and (1 + 2 gamma_3)^2 (trace/traverse.py
// LEAF_WIDEN, LEAF_WIDEN_T)
constexpr float kLeafWiden = 1.0f + 0x3p-23f;
constexpr float kLeafWidenT = 1.0f + 0x6p-23f;

struct Walk {
  const float4* __restrict__ nodes;  // (M, 16) f32 = 4 float4 per record
  const float4* __restrict__ tris;   // (T, 12) f32 = 3 float4 per triangle
};

// The conservative leaf-box test on the slab interval [t_near, t_far]:
// t_far is widened by 1 + 2 gamma_3 (gamma_3 = 3u / (1 - 3u), u = 2^-24;
// Ize, "Robust BVH Ray Traversal", JCGT 2013), so that a ray that grazes a
// leaf box's silhouette to within rounding still tests the leaf, and t by
// (1 + 2 gamma_3)^2, room for the rounding of both the box's t_near and the
// triangle's t, so that a leaf whose box face holds a hit at a tie in t is
// still tested.  Internal boxes keep the exact slab_admits, as the JAX CPU
// walk tests them.
__device__ __forceinline__ bool leaf_admits(float t_near, float t_far,
                                            float t) {
  return t_near <= t_far * kLeafWiden && t_far >= 0.0f &&
         t_near <= t * kLeafWidenT;
}

// Load record rec and slab-test both children against the ray at t: their
// t_near and whether the ray wants each (leaf_admits for a leaf child,
// slab_admits for an internal one, at t or, with kWide, at t * kLeafWidenT).
// Returns the record's int words (refs, counts).
//
// kWide is for walks that visit nodes in another order than the ray's own
// near-first one (packet.cu): with exact internal tests, a tie hit found
// first on one face could cull the subtree of a coincident triangle of a
// lower slot, whose box's t_near rounds above that t.
template <bool kWide = false>
__device__ __forceinline__ int4 test_children(const Walk& s, const Ray& r,
                                              int rec, float t, float& nl,
                                              float& nr, bool& want_l,
                                              bool& want_r) {
  const float4* p = s.nodes + 4 * rec;
  const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  const int4 m = __ldg(reinterpret_cast<const int4*>(p + 3));
  float fl, fr;
  slab(r, a.x, a.y, a.z, a.w, b.x, b.y, nl, fl);
  slab(r, b.z, b.w, c.x, c.y, c.z, c.w, nr, fr);
  const float ti = kWide ? t * kLeafWidenT : t;
  want_l = m.x < 0 ? leaf_admits(nl, fl, t) : slab_admits(nl, fl, ti);
  want_r = m.y < 0 ? leaf_admits(nr, fr, t) : slab_admits(nr, fr, ti);
  return m;
}

// Whether a hit at tt on triangle `slot`, admitted by ray_tri at t
// (tt <= t), replaces the best (t, prim): the least (t, slot) wins, and a
// ray without a hit (prim = -1) takes no hit at t = t_max.
__device__ __forceinline__ bool better_hit(float tt, int slot, float t,
                                           int prim) {
  return tt < t || slot < prim;
}

// Test the leaf of `count` triangles from slot `first`; keep the least
// (t, slot).  Returns true at an any-hit walk's first hit.
template <bool kAnyHit>
__device__ __forceinline__ bool test_leaf(const Walk& s, const Ray& r,
                                          int first, int count, float& t,
                                          int& prim, float& hu, float& hv) {
  for (int k = 0; k < count; ++k) {
    const float4* p = s.tris + 3 * (first + k);
    const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    float tt, uu, vv;
    if (ray_tri(r, a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z, t, tt, uu,
                vv) &&
        better_hit(tt, first + k, t, prim)) {
      t = tt;
      prim = first + k;
      hu = uu;
      hv = vv;
      if (kAnyHit) return true;
    }
  }
  return false;
}

// One ray's walk state: the current record (-1: none), the node stack
// (record, t_near) and the queue of postponed leaves (first, count,
// t_near).
struct State {
  int cur, sp, qn;
  int stack_ref[kStackDepth];
  float stack_near[kStackDepth];
  int queue_first[kQueueCap], queue_count[kQueueCap];
  float queue_near[kQueueCap];
};

__device__ __forceinline__ void enqueue(State& w, int ref, int count,
                                        float t_near) {
  w.queue_first[w.qn] = ~ref;
  w.queue_count[w.qn] = count;
  w.queue_near[w.qn] = t_near;
  ++w.qn;
}

// One step at internal record w.cur: test both children, queue the wanted
// leaves near first, descend into the nearer wanted internal child (by
// t_near, left on equality) and push the other with its t_near, or pop the
// next stacked node that t (kWide: t * kLeafWidenT) still admits.
template <bool kWide = false>
__device__ __forceinline__ void step(const Walk& s, const Ray& r, float t,
                                     State& w) {
  float nl, nr;
  bool want_l, want_r;
  const int4 m =
      test_children<kWide>(s, r, w.cur, t, nl, nr, want_l, want_r);
  const bool leaf_l = m.x < 0, leaf_r = m.y < 0;
  const bool l_first = nl <= nr;
  if (l_first) {
    if (want_l && leaf_l) enqueue(w, m.x, m.z, nl);
    if (want_r && leaf_r) enqueue(w, m.y, m.w, nr);
  } else {
    if (want_r && leaf_r) enqueue(w, m.y, m.w, nr);
    if (want_l && leaf_l) enqueue(w, m.x, m.z, nl);
  }
  const bool go_l = want_l && !leaf_l, go_r = want_r && !leaf_r;
  if (go_l && go_r) {
    w.stack_ref[w.sp] = l_first ? m.y : m.x;
    w.stack_near[w.sp] = l_first ? nr : nl;
    ++w.sp;
    w.cur = l_first ? m.x : m.y;
  } else if (go_l || go_r) {
    w.cur = go_l ? m.x : m.y;
  } else {
    w.cur = -1;
    while (w.sp > 0) {
      --w.sp;
      if (w.stack_near[w.sp] <= (kWide ? t * kLeafWidenT : t)) {
        w.cur = w.stack_ref[w.sp];
        break;
      }
    }
  }
}

// Walk one ray from internal record `root` (0: the whole tree); t, prim,
// u, v hold the best hit so far.  Steps run while the walk is alive and
// the leaf queue has room for a step's two leaves; then the queue is
// drained in order, each leaf skipped if t no longer admits it
// ("while-while", Aila and Laine: the warp's threads reconverge before
// they drain, and run their triangle tests together).
template <bool kAnyHit, bool kWide = false>
__device__ void walk(const Walk& s, const Ray& r, int root, float& t,
                     int& prim, float& hu, float& hv) {
  State w;
  w.cur = root;
  w.sp = 0;
  w.qn = 0;
  while (w.cur >= 0 || w.qn > 0) {
    while (w.cur >= 0 && w.qn + 2 <= kQueueCap) step<kWide>(s, r, t, w);
    for (int q = 0; q < w.qn; ++q) {
      if (w.queue_near[q] <= t * kLeafWidenT &&
          test_leaf<kAnyHit>(s, r, w.queue_first[q], w.queue_count[q], t,
                             prim, hu, hv))
        return;
    }
    w.qn = 0;
  }
}

}  // namespace evplp
