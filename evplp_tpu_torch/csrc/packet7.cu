// BVH ray traversal as a two-level loop over the walk records, for Hopper
// (sm_90a): closest hit and any hit.
//
// Replaces the JAX package's Pallas kernel evplp_tpu/trace/packet7.py:_kernel
// (entry packet7_trace), which runs a packet of rows x 128 rays through an
// inner loop of slab tests, near-child-first steering and leaf enqueues, and
// drains the queued leaf rows in an outer loop.  This kernel keeps that
// two-level loop, one thread a ray, and computes the function of the JAX
// CPU walk `_traverse_one` (and of evplp_tpu_torch/trace/traverse.py:
// traverse_plain) exactly, as traverse.cu does: the least t in
// (t_min, t_max), the least slot on ties, with t, prim, u and v equal bit
// for bit; any hit stops at a ray's first hit; lanes with t_max <= t_min
// are not traced and report t = t_max, prim = -1.  The ids are the slots of
// the packed layout, which on a slot-ordered BVH are the walk records'
// triangle ids (trace/packet7.py maps them otherwise).
//
// What bounds it on an H100: not bytes (the walk records stay in the 50 MB
// L2; only the ray I/O must cross HBM), but the dependent loads along each
// ray's path and the lanes that idle while others work.  The design:
//   * Inner loop: ray_common.cuh's ordered step, one 64-byte walk record a
//     step (evplp_tpu_torch/accel/bvh.py:walk_layout), near child by t_near
//     first, wanted leaves culled by the ray's own conservative test
//     (leaf_admits) and queued, up to kQueueCap.  The warp steps together
//     while any lane can still step and has room in its queue
//     (__any_sync), so that its lanes enter the outer loop together.
//   * Outer loop: each lane drains its own queue in order, skipping the
//     leaves its shrinking t no longer admits, so that the warp's triangle
//     tests run in one burst.  Each lane works its own queue although the
//     queues differ in length: a drain worked by the whole warp together
//     (the (ray, triangle) pairs laid out in shared memory, 32 a round,
//     each against its ray's t at the drain's start) measured slower, as
//     it tests every admitted leaf at that t and its layout costs more
//     than the idle lanes it saves (PERF.md).
//
// Numerics as in traverse.cu: -fmad=false, and the tests of ray_common.cuh
// (sums ((x + y) + z), IEEE division, |det| > 1e-9).  The plain PyTorch
// version (evplp_tpu_torch/trace/packet7.py:packet7_plain) takes the same
// steps and drains, warp by warp.
//
// C interface: the wrapper allocates every output, launches on PyTorch's
// current stream, and checks the returned cudaGetLastError().

#include "ray_common.cuh"

namespace {

using evplp::kQueueCap;
using evplp::Ray;
using evplp::Rays;
using evplp::Walk;

constexpr int kWarps = 4;
constexpr int kBlock = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
packet7_kernel(Walk s, Rays r) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool in_range = i < r.num_rays;
  // lanes past the last ray: a ray that is not traced (t_max <= t_min)
  const Ray ray = in_range
      ? evplp::load_ray(r, i)
      : evplp::make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 1.0f);
  float t = in_range ? r.t_max[i] : 0.0f;
  int prim = -1;
  float hu = 0.0f, hv = 0.0f;
  evplp::State w;
  w.cur = t > ray.lo ? 0 : -1;
  w.sp = 0;
  w.qn = 0;
  while (__any_sync(kFull, w.cur >= 0)) {
    // inner: the warp steps while any lane can
    while (true) {
      const bool can = w.cur >= 0 && w.qn + 2 <= kQueueCap;
      if (!__any_sync(kFull, can)) break;
      if (can) evplp::step(s, ray, t, w);
    }
    // outer: each lane drains its queue in order, skipping the leaves its
    // shrinking t no longer admits
    for (int k = 0; k < w.qn; ++k) {
      if (w.queue_near[k] <= t * evplp::kLeafWidenT &&
          evplp::test_leaf<kAnyHit>(s, ray, w.queue_first[k],
                                    w.queue_count[k], t, prim, hu, hv)) {
        w.cur = -1;
        break;
      }
    }
    w.qn = 0;
  }
  if (in_range) {
    r.t[i] = t;
    r.prim[i] = prim;
    r.u[i] = hu;
    r.v[i] = hv;
  }
}

}  // namespace

extern "C" int evplp_packet7(const void* nodes, const void* tris,
                             const void* o, const void* d, const void* t_min,
                             const void* t_max, int num_rays, void* t,
                             void* prim, void* u, void* v, int any_hit,
                             void* stream) {
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
    packet7_kernel<true><<<grid, kBlock, 0, st>>>(s, r);
  else
    packet7_kernel<false><<<grid, kBlock, 0, st>>>(s, r);
  return static_cast<int>(cudaGetLastError());
}
