// BVH ray traversal for Hopper (sm_90a): closest hit and any hit.
//
// Replaces the JAX package's Pallas packet kernel
// evplp_tpu/trace/packet3.py:_kernel (entry packet3_trace), an ordered
// packet walk: both children of the current node tested per step, the
// near child visited first, wanted leaves queued and drained in bursts.
// This kernel is the GPU form of that design with one thread per ray, and
// computes the function of the JAX CPU walk `_traverse_one` (and of the
// port's plain version, evplp_tpu_torch/trace/traverse.py:traverse_plain):
// the least t in (t_min, t_max), the first triangle in DFS order on ties;
// any hit stops at its first hit; lanes with t_max <= t_min are not traced
// and report t = t_max, prim = -1.
//
// What bounds it on an H100: not bytes.  The records of a ~24k-triangle
// scene (~1.8 MB) stay in the 50 MB L2, and only the ray I/O, about 48 B a
// ray, must cross HBM.  Its time is set by the chain of dependent loads
// along each ray's path and by divergence between the 32 rays of a warp.
// What the design does about it:
//   * Layout (evplp_tpu_torch/accel/bvh.py:walk_layout): one 64-byte record
//     per internal node, read as four 16-byte loads through the read-only
//     path, holds both children's boxes and references; a leaf child's
//     reference carries its (first triangle, count).  One dependent load
//     step per node, and none to reach a leaf's triangles, which are
//     48-byte records (v0, e1, e2 as float4) read as three 16-byte loads.
//   * Ordered walk: both children are slab-tested per step; the nearer by
//     t_near (left on equality) is visited first and the other pushed with
//     its t_near, so that a far subtree is skipped once a nearer hit has
//     cut t.  Record 0 is a super-root whose left child is the root, so the
//     root box is tested as _traverse_one tests it.
//   * Leaves are culled by their box, which _traverse_one never tests, so
//     the test is conservative: t_far is widened by 1 + 2 gamma_3
//     (gamma_3 = 3u / (1 - 3u), u = 2^-24; Ize, "Robust BVH Ray
//     Traversal", JCGT 2013), so that a ray that grazes a leaf box's
//     silhouette to within rounding still tests the leaf, and t by
//     (1 + 2 gamma_3)^2, room for the rounding of both the box's t_near and
//     the triangle's t, so that a leaf whose box face holds a triangle hit
//     at a tie in t is still tested.  Internal boxes keep the exact slab
//     test of ray_common.cuh, as _traverse_one tests them.
//   * Exact ties whatever the visiting order: slot ids grow with DFS leaf
//     order, so _traverse_one's "first triangle on ties" is the least slot
//     among the hits at the least t.  The kernel keeps the least (t, slot):
//     a hit replaces the best when tt < t, or tt == t and its slot is
//     lower (the kTies triangle test of ray_common.cuh admits tt == t), and
//     every box test admits t_near == t.
//   * Wanted leaves are postponed into a per-thread queue of kQueueCap and
//     drained when it has no room for a step's two leaves or the walk ends
//     (Aila and Laine's "while-while", the leaf queue of packet3), so that
//     the warp's threads run their triangle tests together.  On the H100
//     this is 1.6-1.9x faster than testing each leaf right after the step
//     that found it; persistent warps that take their rays from a global
//     counter were measured within the 1-3% run-to-run spread of a plain
//     grid, so the grid stays (PERF.md).
//   The walk, its step and its tests are ray_common.cuh's, shared with
//   packet.cu and packet7.cu.
//
// Built with -fmad=false so that no multiply-add is fused and every float
// operation rounds as the plain PyTorch ops do; triangle test sums in the
// order ((x + y) + z), IEEE division (ray_common.cuh).
//
// C interface: the wrapper allocates every output, launches on PyTorch's
// current stream, and checks the returned cudaError_t.

#include "ray_common.cuh"

namespace {

using evplp::Ray;
using evplp::Rays;
using evplp::Walk;

// 128 threads a block (46 / 48 registers for any / closest hit, no
// spills); 64, 256, and 128 capped at 40 registers by __launch_bounds__
// were measured within the run-to-run spread (PERF.md)
constexpr int kBlock = 128;

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
traverse_kernel(Walk s, Rays r) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= r.num_rays) return;
  const Ray ray = evplp::load_ray(r, i);
  float t = r.t_max[i];
  int prim = -1;
  float hu = 0.0f, hv = 0.0f;
  if (t > ray.lo) evplp::walk<kAnyHit>(s, ray, 0, t, prim, hu, hv);
  r.t[i] = t;
  r.prim[i] = prim;
  r.u[i] = hu;
  r.v[i] = hv;
}

}  // namespace

extern "C" int evplp_traverse(const void* nodes, const void* tris,
                              const void* o, const void* d,
                              const void* t_min, const void* t_max,
                              int num_rays, void* t, void* prim, void* u,
                              void* v, int any_hit, void* stream) {
  const Walk s{static_cast<const float4*>(nodes),
               static_cast<const float4*>(tris)};
  const Rays r{static_cast<const float*>(o),
               static_cast<const float*>(d),
               static_cast<const float*>(t_min),
               static_cast<const float*>(t_max),
               num_rays,
               static_cast<float*>(t),
               static_cast<int*>(prim),
               static_cast<float*>(u),
               static_cast<float*>(v)};
  const int grid = (num_rays + kBlock - 1) / kBlock;
  const auto st = static_cast<cudaStream_t>(stream);
  if (any_hit)
    traverse_kernel<true><<<grid, kBlock, 0, st>>>(s, r);
  else
    traverse_kernel<false><<<grid, kBlock, 0, st>>>(s, r);
  return static_cast<int>(cudaGetLastError());
}
