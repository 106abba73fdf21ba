// BVH ray traversal over the packed node layout, two-level loop, for
// Hopper (sm_90a): closest hit and any hit.
//
// Replaces the JAX package's Pallas kernel evplp_tpu/trace/packet7.py:_kernel
// (entry packet7_trace), which runs a packet of rows x 128 rays through an
// inner loop of slab tests, near-child-first steering and leaf enqueues, and
// drains the queued leaf rows in an outer loop.  This kernel is the GPU form
// of that loop with one thread per ray, in the "while-while" style of Aila
// and Laine:
//   inner loop: at internal node `cur`, slab-test both children against the
//     ray's own (t_min, t), append wanted leaf children (left, then right)
//     to a per-thread queue of kQueueCap leaves, descend into the wanted
//     internal child nearer along the node's split axis and push the other
//     (stack of kStackDepth), or pop; it runs while the walk is alive and
//     the queue has room for one more step's two leaves;
//   outer loop: drain the queued leaves in queue order, rpl rows of 14 slots
//     each, Moller-Trumbore with tt in (t_min, t) and tt < best, the first
//     slot winning ties; then loop back into the inner loop.
// Near first is decided by the sign of the ray's own direction on the split
// axis (the TPU kernel uses the sign of the packet's summed direction).  The
// order of the leaves only decides which triangle wins an exact tie in t.
// Leaves are culled by their own box, as in the TPU kernel; traverse.cu
// tests a leaf's triangles without its box, so a ray that touches a box's
// silhouette edge to within rounding may hit a triangle there that this
// kernel skips.  Any hit returns at its first hit.  Lanes with
// t_max <= t_min are not traced and report t = t_max, prim = -1 (the TPU
// kernel reports them as hits; the port's callers need them to report no
// hit).
//
// Inputs are the packed arrays of evplp_tpu_torch/accel/bvh.py: bounds
// (N, 8) f32 [min3, max3, -, -] read as two float4, meta (N, 4) i32
// [count, leaf_row, right_child, split_axis] read as one int4, and the slot
// rows (L, 128) f32, 14 slots of (v0, e1, e2) per row.  The result is the
// slot id row * 14 + k, which is the triangle id of a slot-ordered scene.
// The plain PyTorch version (evplp_tpu_torch/trace/packet7.py:packet7_plain)
// runs the same walk, step for step.
//
// Numerics as in traverse.cu: -fmad=false, and the slab and triangle tests
// of ray_common.cuh (sums ((x + y) + z), IEEE division, |det| > 1e-9).
//
// What bounds it on an H100: like traverse.cu, dependent loads along each
// ray's path and divergence between the 32 rays of a warp; the BVH stays in
// the 50 MB L2 and only the ray I/O must move through HBM.  Splitting the
// loop keeps the slab-test body small and groups the triangle tests into
// bursts, so that the warp's threads spend more of their steps in the same
// phase; the stack and queue live in local memory (L1).
//
// C interface: the wrapper allocates every output, launches on PyTorch's
// current stream, and checks the returned cudaGetLastError().

#include "ray_common.cuh"

namespace {

using evplp::Ray;
using evplp::Rays;

constexpr int kBlock = 128;
constexpr int kRowTris = 14;
constexpr int kSlotFloats = 9;
constexpr int kRowFloats = 128;
constexpr int kStackDepth = 64;
constexpr int kQueueCap = 8;

struct PackedScene {
  const float4* __restrict__ bounds;  // (N, 8) f32 = 2 float4 per node
  const int4* __restrict__ meta;      // (N, 4) i32
  const float* __restrict__ rows;     // (L, 128) f32
};

// the ray enters node's box at some t_near <= t
__device__ __forceinline__ bool box_hit(const PackedScene& s, int node,
                                        const Ray& r, float t) {
  const float4 a = s.bounds[2 * node];      // min x, y, z, max x
  const float4 b = s.bounds[2 * node + 1];  // max y, z, (meta words)
  return evplp::slab_enter(r, a.x, a.y, a.z, a.w, b.x, b.y, t);
}

// Walk one ray; t, prim, u, v hold the best hit so far.
template <bool kAnyHit>
__device__ void walk(const PackedScene& s, const Ray& r, float& t, int& prim,
                     float& hu, float& hv) {
  int stack[kStackDepth];
  int queue[kQueueCap];
  int sp = 0, qn = 0, cur = 0;
  if (s.meta[0].x > 0) {  // the root is a leaf
    queue[qn++] = 0;
    cur = -1;
  }
  while (cur >= 0 || sp > 0 || qn > 0) {
    // ---- inner: slab tests, steering, leaf enqueues ----
    while ((cur >= 0 || sp > 0) && qn < kQueueCap - 1) {
      const int4 m = s.meta[cur];
      const int left = cur + 1, right = m.z;
      const bool want_l = box_hit(s, left, r, t);
      const bool want_r = box_hit(s, right, r, t);
      const bool l_leaf = s.meta[left].x > 0;
      const bool r_leaf = s.meta[right].x > 0;
      if (want_l && l_leaf) queue[qn++] = left;
      if (want_r && r_leaf) queue[qn++] = right;
      const bool wl = want_l && !l_leaf, wr = want_r && !r_leaf;
      const float da = m.w == 0 ? r.dx : (m.w == 1 ? r.dy : r.dz);
      const bool pos = da >= 0.0f;
      const int first = pos ? left : right, second = pos ? right : left;
      const bool wf = pos ? wl : wr, ws = pos ? wr : wl;
      cur = wf ? first : (ws ? second : -1);
      if (wf && ws) stack[sp++] = second;
      if (cur < 0 && sp > 0) cur = stack[--sp];
    }
    // ---- outer: drain the queued leaves in order ----
    for (int q = 0; q < qn; ++q) {
      const int4 m = s.meta[queue[q]];
      for (int k = 0; k < m.x; ++k) {
        const float* p = s.rows + (m.y + k / kRowTris) * kRowFloats +
                         (k % kRowTris) * kSlotFloats;
        float tt, uu, vv;
        if (evplp::ray_tri(r, p, p + 3, p + 6, t, tt, uu, vv)) {
          t = tt;
          prim = m.y * kRowTris + k;
          hu = uu;
          hv = vv;
          if (kAnyHit) return;
        }
      }
    }
    qn = 0;
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
packet7_kernel(PackedScene s, Rays r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r.num_rays) return;
  const Ray ray = evplp::load_ray(r, i);
  float t = r.t_max[i];
  int prim = -1;
  float hu = 0.0f, hv = 0.0f;
  if (t > ray.lo) walk<kAnyHit>(s, ray, t, prim, hu, hv);
  r.t[i] = t;
  r.prim[i] = prim;
  r.u[i] = hu;
  r.v[i] = hv;
}

template <bool kAnyHit>
int launch(const void* bounds, const void* meta, const void* rows,
           const void* o, const void* d, const void* t_min, const void* t_max,
           int num_rays, void* t, void* prim, void* u, void* v,
           void* stream) {
  PackedScene s{static_cast<const float4*>(bounds),
                static_cast<const int4*>(meta),
                static_cast<const float*>(rows)};
  Rays r{static_cast<const float*>(o),     static_cast<const float*>(d),
         static_cast<const float*>(t_min), static_cast<const float*>(t_max),
         num_rays,                         static_cast<float*>(t),
         static_cast<int*>(prim),          static_cast<float*>(u),
         static_cast<float*>(v)};
  const int grid = (num_rays + kBlock - 1) / kBlock;
  packet7_kernel<kAnyHit>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(s, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evplp_packet7_closest(const void* bounds, const void* meta,
                                     const void* rows, const void* o,
                                     const void* d, const void* t_min,
                                     const void* t_max, int num_rays, void* t,
                                     void* prim, void* u, void* v,
                                     void* stream) {
  return launch<false>(bounds, meta, rows, o, d, t_min, t_max, num_rays, t,
                       prim, u, v, stream);
}

extern "C" int evplp_packet7_any(const void* bounds, const void* meta,
                                 const void* rows, const void* o,
                                 const void* d, const void* t_min,
                                 const void* t_max, int num_rays, void* t,
                                 void* prim, void* u, void* v, void* stream) {
  return launch<true>(bounds, meta, rows, o, d, t_min, t_max, num_rays, t,
                      prim, u, v, stream);
}
