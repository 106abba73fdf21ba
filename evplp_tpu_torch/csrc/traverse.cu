// BVH ray traversal for Hopper (sm_90a): closest hit and any hit.
//
// Replaces the JAX package's Pallas packet kernel
// evplp_tpu/trace/packet3.py:_kernel (entry packet3_trace), which computes
// the same function for ray packets on a TPU.  This kernel computes it with
// one thread per ray and the stackless skip-pointer walk over the flattened
// DFS node arrays, node for node as the plain PyTorch version
// (evplp_tpu_torch/trace/traverse.py:traverse_plain) walks them:
//   leaf node:     test its triangles in (t_min, t), go to skip[node];
//   internal node: go to node + 1 if the ray enters the box before t,
//                  else to skip[node].
// Triangles are slot-ordered v0, e1, e2 rows of (T, 3) float32; the slab
// and double-sided Moller-Trumbore tests (|det| > 1e-9, sums in the order
// ((x + y) + z)) are those of ray_common.cuh, shared with packet7.cu and
// packet.cu.  The closest-hit and any-hit kernels are two instantiations
// of one template; any hit stops at its first hit.  Lanes with
// t_max <= t_min return at once (t = t_max, prim = -1).
//
// Built with -fmad=false so that no multiply-add is fused and every float
// operation rounds as the plain PyTorch ops do; the two then agree prim for
// prim.  Allowing fused multiply-adds is a later choice.
//
// What bounds it on an H100: it is latency-bound pointer chasing.  The BVH
// of a ~24k-triangle scene is a few MB and stays in the 50 MB L2, so the
// bytes that must move are only the ray I/O, about 48 B per ray in and out
// (o, d, t_min, t_max in; t, prim, u, v out) over 3.35 TB/s.  Its time is
// set by dependent loads along each ray's path and by divergence between
// the 32 rays of a warp; packets, ordered descent, shared-memory node
// caches and a wider BVH are the ways to cut it.
//
// C interface: the wrapper allocates every output, launches on PyTorch's
// current stream, and checks the returned cudaGetLastError().

#include "ray_common.cuh"

namespace {

using evplp::Ray;
using evplp::Rays;

constexpr int kBlock = 256;

struct Scene {
  const float* __restrict__ nmin;   // (N, 3)
  const float* __restrict__ nmax;   // (N, 3)
  const int* __restrict__ skip;     // (N,)
  const int* __restrict__ first;    // (N,)
  const int* __restrict__ count;    // (N,)
  int num_nodes;
  const float* __restrict__ v0;     // (T, 3)
  const float* __restrict__ e1;     // (T, 3)
  const float* __restrict__ e2;     // (T, 3)
};

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
traverse_kernel(Scene s, Rays r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r.num_rays) return;
  const Ray ray = evplp::load_ray(r, i);
  float t = r.t_max[i];
  int prim = -1;
  float hu = 0.0f, hv = 0.0f;
  if (t > ray.lo) {
    int node = 0;
    while (node < s.num_nodes) {
      const int cnt = s.count[node];
      if (cnt > 0) {
        const int f = s.first[node];
        for (int k = 0; k < cnt; ++k) {
          const int j = 3 * (f + k);
          float tt, uu, vv;
          if (evplp::ray_tri(ray, s.v0 + j, s.e1 + j, s.e2 + j, t, tt, uu,
                             vv)) {
            t = tt;
            prim = f + k;
            hu = uu;
            hv = vv;
            if (kAnyHit) break;
          }
        }
        if (kAnyHit && prim >= 0) break;
        node = s.skip[node];
      } else {
        const int b = 3 * node;
        const bool enter =
            evplp::slab_enter(ray, s.nmin[b], s.nmin[b + 1], s.nmin[b + 2],
                              s.nmax[b], s.nmax[b + 1], s.nmax[b + 2], t);
        node = enter ? node + 1 : s.skip[node];
      }
    }
  }
  r.t[i] = t;
  r.prim[i] = prim;
  r.u[i] = hu;
  r.v[i] = hv;
}

template <bool kAnyHit>
int launch(const void* nmin, const void* nmax, const void* skip,
           const void* first, const void* count, int num_nodes,
           const void* v0, const void* e1, const void* e2, const void* o,
           const void* d, const void* t_min, const void* t_max, int num_rays,
           void* t, void* prim, void* u, void* v, void* stream) {
  Scene s{static_cast<const float*>(nmin), static_cast<const float*>(nmax),
          static_cast<const int*>(skip),   static_cast<const int*>(first),
          static_cast<const int*>(count),  num_nodes,
          static_cast<const float*>(v0),   static_cast<const float*>(e1),
          static_cast<const float*>(e2)};
  Rays r{static_cast<const float*>(o),     static_cast<const float*>(d),
         static_cast<const float*>(t_min), static_cast<const float*>(t_max),
         num_rays,                         static_cast<float*>(t),
         static_cast<int*>(prim),          static_cast<float*>(u),
         static_cast<float*>(v)};
  const int grid = (num_rays + kBlock - 1) / kBlock;
  traverse_kernel<kAnyHit>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(s, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evplp_traverse_closest(
    const void* nmin, const void* nmax, const void* skip, const void* first,
    const void* count, int num_nodes, const void* v0, const void* e1,
    const void* e2, const void* o, const void* d, const void* t_min,
    const void* t_max, int num_rays, void* t, void* prim, void* u, void* v,
    void* stream) {
  return launch<false>(nmin, nmax, skip, first, count, num_nodes, v0, e1, e2,
                       o, d, t_min, t_max, num_rays, t, prim, u, v, stream);
}

extern "C" int evplp_traverse_any(
    const void* nmin, const void* nmax, const void* skip, const void* first,
    const void* count, int num_nodes, const void* v0, const void* e1,
    const void* e2, const void* o, const void* d, const void* t_min,
    const void* t_max, int num_rays, void* t, void* prim, void* u, void* v,
    void* stream) {
  return launch<true>(nmin, nmax, skip, first, count, num_nodes, v0, e1, e2,
                      o, d, t_min, t_max, num_rays, t, prim, u, v, stream);
}
