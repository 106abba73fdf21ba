// BVH ray traversal with one shared stack per packet, for Hopper (sm_90a):
// closest hit and any hit.
//
// Replaces the JAX package's Pallas kernel
// evplp_tpu/trace/packet.py:_packet_kernel (entry packet_trace), the v1
// packet traversal: a packet of 64 x 128 rays shares one node stack in SMEM,
// every popped node is slab-tested against all its rays, and the packet
// descends if any ray wants the node.  Here a packet is one warp (32
// consecutive rays) and its stack of kStackDepth nodes lives in shared
// memory; every lane computes the same stack pointer from warp votes:
//   pop node; each lane slab-tests it against its own (t_min, t);
//   wanted = __any_sync of the lanes' wants (a lane that is not traced, or
//     with any hit already hit, wants nothing);
//   wanted leaf: every lane tests every triangle of the leaf in order with
//     tt in (t_min, t) and tt < best (any hit: only while it has no hit),
//     whether or not its own box test passed, as the TPU kernel does;
//   wanted internal node: push the right child skip[node + 1], then the left
//     child node + 1, so the left is popped first (depth-first order);
//   any hit: the packet stops when __all_sync says every lane has a hit or
//     is not traced.
// A leaf is tested only when some lane's slab test enters its box;
// traverse.cu tests a leaf without its box, so at a box's silhouette edge,
// to within rounding, the two can report different hits.
// Lanes with t_max <= t_min, and the lanes past the last ray, are not
// traced and report t = t_max, prim = -1.
//
// Inputs are the skip-pointer node arrays and the slot-ordered triangle SoA
// of evplp_tpu_torch/accel/bvh.py and scene/scene.py, the arrays traverse.cu
// reads.  The plain PyTorch version
// (evplp_tpu_torch/trace/packet.py:packet_plain) runs the same walk, packet
// by packet.
//
// Numerics as in traverse.cu: -fmad=false, and the slab and triangle tests
// of ray_common.cuh (sums ((x + y) + z), IEEE division, |det| > 1e-9).
//
// What bounds it on an H100: node and triangle loads are warp-uniform (one
// address per warp, broadcast), so a coherent packet moves few bytes; an
// incoherent packet visits the union of its rays' nodes, and every lane
// pays for every node and triangle any lane wants.  Its time is set by the
// length of that union and by the dependent loads along it; the ray I/O is
// all that must move through HBM.
//
// C interface: the wrapper allocates every output, launches on PyTorch's
// current stream, and checks the returned cudaGetLastError().

#include "ray_common.cuh"

namespace {

using evplp::Ray;
using evplp::Rays;

constexpr int kWarps = 4;
constexpr int kBlock = 32 * kWarps;
constexpr int kStackDepth = 96;
constexpr unsigned kFull = 0xffffffffu;

struct Scene {
  const float* __restrict__ nmin;   // (N, 3)
  const float* __restrict__ nmax;   // (N, 3)
  const int* __restrict__ skip;     // (N,)
  const int* __restrict__ first;    // (N,)
  const int* __restrict__ count;    // (N,)
  const float* __restrict__ v0;     // (T, 3)
  const float* __restrict__ e1;     // (T, 3)
  const float* __restrict__ e2;     // (T, 3)
};

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
packet_kernel(Scene s, Rays r) {
  __shared__ int stacks[kWarps][kStackDepth];
  int* stack = stacks[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool in_range = i < r.num_rays;
  // lanes past the last ray: a ray that is not traced (t_max <= t_min)
  const Ray ray = in_range
      ? evplp::load_ray(r, i)
      : evplp::make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 1.0f);
  float t = in_range ? r.t_max[i] : 0.0f;
  const bool live = t > ray.lo;
  int prim = -1;
  float hu = 0.0f, hv = 0.0f;

  if (lane == 0) stack[0] = 0;
  __syncwarp();
  int sp = __any_sync(kFull, live) ? 1 : 0;
  while (sp > 0) {
    --sp;
    const int node = stack[sp];
    const int b = 3 * node;
    bool want = live && evplp::slab_enter(ray, s.nmin[b], s.nmin[b + 1],
                                          s.nmin[b + 2], s.nmax[b],
                                          s.nmax[b + 1], s.nmax[b + 2], t);
    if (kAnyHit) want = want && prim < 0;
    const bool wanted = __any_sync(kFull, want);
    const int cnt = s.count[node];
    if (wanted && cnt > 0) {
      const int f = s.first[node];
      for (int k = 0; k < cnt; ++k) {
        const int j = 3 * (f + k);
        float tt, uu, vv;
        bool ok = evplp::ray_tri(ray, s.v0 + j, s.e1 + j, s.e2 + j, t, tt, uu,
                                 vv);
        if (kAnyHit) ok = ok && prim < 0;
        if (ok) {
          t = tt;
          prim = f + k;
          hu = uu;
          hv = vv;
        }
      }
    }
    if (wanted && cnt == 0) {
      __syncwarp();  // every lane has read stack[sp]
      if (lane == 0) {
        stack[sp] = s.skip[node + 1];  // right child
        stack[sp + 1] = node + 1;      // left child, popped first
      }
      __syncwarp();
      sp += 2;
    }
    if (kAnyHit && __all_sync(kFull, prim >= 0 || !live)) sp = 0;
  }
  if (in_range) {
    r.t[i] = t;
    r.prim[i] = prim;
    r.u[i] = hu;
    r.v[i] = hv;
  }
}

template <bool kAnyHit>
int launch(const void* nmin, const void* nmax, const void* skip,
           const void* first, const void* count, const void* v0,
           const void* e1, const void* e2, const void* o, const void* d,
           const void* t_min, const void* t_max, int num_rays, void* t,
           void* prim, void* u, void* v, void* stream) {
  Scene s{static_cast<const float*>(nmin), static_cast<const float*>(nmax),
          static_cast<const int*>(skip),   static_cast<const int*>(first),
          static_cast<const int*>(count),  static_cast<const float*>(v0),
          static_cast<const float*>(e1),   static_cast<const float*>(e2)};
  Rays r{static_cast<const float*>(o),     static_cast<const float*>(d),
         static_cast<const float*>(t_min), static_cast<const float*>(t_max),
         num_rays,                         static_cast<float*>(t),
         static_cast<int*>(prim),          static_cast<float*>(u),
         static_cast<float*>(v)};
  const int grid = (num_rays + kBlock - 1) / kBlock;
  packet_kernel<kAnyHit>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(s, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evplp_packet_closest(
    const void* nmin, const void* nmax, const void* skip, const void* first,
    const void* count, const void* v0, const void* e1, const void* e2,
    const void* o, const void* d, const void* t_min, const void* t_max,
    int num_rays, void* t, void* prim, void* u, void* v, void* stream) {
  return launch<false>(nmin, nmax, skip, first, count, v0, e1, e2, o, d,
                       t_min, t_max, num_rays, t, prim, u, v, stream);
}

extern "C" int evplp_packet_any(
    const void* nmin, const void* nmax, const void* skip, const void* first,
    const void* count, const void* v0, const void* e1, const void* e2,
    const void* o, const void* d, const void* t_min, const void* t_max,
    int num_rays, void* t, void* prim, void* u, void* v, void* stream) {
  return launch<true>(nmin, nmax, skip, first, count, v0, e1, e2, o, d,
                      t_min, t_max, num_rays, t, prim, u, v, stream);
}
