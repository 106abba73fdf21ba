// BVH ray traversal by warp packets, for Hopper (sm_90a): closest hit and
// any hit.
//
// Replaces the JAX package's Pallas kernel
// evplp_tpu/trace/packet.py:_packet_kernel (entry packet_trace), the v1
// packet traversal: a packet of rays shares one node stack, every popped
// node is tested against all its rays, and the packet descends if any ray
// wants the node.  Here a packet is one warp of 32 consecutive rays, and
// it computes the function of the JAX CPU walk `_traverse_one` (and of
// evplp_tpu_torch/trace/traverse.py:traverse_plain) exactly, as
// traverse.cu does: the least t in (t_min, t_max), the least slot on ties,
// with t, prim, u and v equal bit for bit; any hit stops at a ray's first
// hit; lanes with t_max <= t_min are not traced and report t = t_max,
// prim = -1.
//
// What bounds it on an H100: not bytes.  The walk records of a
// ~24k-triangle scene (1.7 MB) stay in the 50 MB L2; the ray I/O is all
// that must cross HBM.  Its time is set by the dependent loads along the
// packet's path and by the lanes that sit out each step.  What the design
// does about it:
//   * One step reads one walk record (evplp_tpu_torch/accel/bvh.py:
//     walk_layout): both children's boxes and references in 64 bytes, at
//     one address for the whole warp, so a coherent packet pays one load
//     per step for 32 rays.
//   * Each lane tests both children against its own (t_min, t) and culls
//     leaves by its own conservative test (ray_common.cuh leaf_admits), so
//     every lane walks its own walk, whatever its packet-mates want: the
//     packet only shares the records.  Lanes outside the step's mask, the
//     lanes that wanted the node, do no work on it.  The packet visits
//     nodes in another order than a lane's own near-first walk, so it tests
//     internal boxes and stacked nodes at t * kLeafWidenT (test_children
//     kWide): exactly, a tie hit found first could cull the box of a
//     coincident triangle of a lower slot whose t_near rounds above t.
//   * __ballot_sync gives the masks of the lanes that want each child.
//     The packet descends into the child that more of its wanting lanes
//     reach first (by t_near) and pushes the other with its mask on a
//     stack in shared memory; each lane keeps its own t_near of every
//     stacked node, and a popped node keeps only the lanes whose t still
//     admits it.
//   * A wanted leaf is tested by the lanes whose own leaf test passed, the
//     leaf more lanes reach first first; each lane keeps the least
//     (t, slot) (ray_common.cuh test_leaf), so the visiting order never
//     changes a result.  (Copying a leaf's triangles to shared memory for
//     the lanes that test it was measured 3-7% slower; PERF.md.)
//   * When fewer than kSolo lanes want a node, each of them walks that
//     subtree alone with ray_common.cuh's one-ray walk (its own stack and
//     leaf queue), and the packet resumes after that: the hybrid of
//     Benthin, Wald et al., "Combining Single and Packet Ray Tracing for
//     Arbitrary Ray Distributions on the Intel MIC Architecture" (2012).
//     On the H100 the packet pays only while every lane wants the node:
//     kSolo = 32 was the fastest of 0, 4, 8, 12, 16, 24 and 32 on the
//     bounce and shadow samples and the PT frame, and within the spread on
//     primary rays (PERF.md), so the packet shares the records of the top
//     of the tree, where coherent rays agree, and each lane walks on alone
//     where they part.
//   * Any hit: a lane leaves every mask at its first hit; the packet ends
//     when no lane wants a stacked node.
//
// Numerics as in traverse.cu: -fmad=false, and the tests of ray_common.cuh
// (sums ((x + y) + z), IEEE division, |det| > 1e-9).  The plain PyTorch
// version (evplp_tpu_torch/trace/packet.py:packet_plain) takes the same
// steps, packet by packet.
//
// C interface: the wrapper allocates every output, launches on PyTorch's
// current stream, and checks the returned cudaGetLastError().

#include "ray_common.cuh"

namespace {

using evplp::Ray;
using evplp::Rays;
using evplp::Walk;

constexpr int kWarps = 4;
constexpr int kBlock = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// a node that fewer than kSolo lanes want is walked by each of them alone
// (trace/packet.py SOLO; 0: a pure packet)
constexpr int kSolo = 32;

// Whether the packet takes the left child first: the lanes that want only
// one child vote for it, the lanes that want both for the nearer (left on
// equal t_near); left wins a tie of votes.
__device__ __forceinline__ bool left_first(bool want_l, bool want_r,
                                           float nl, float nr) {
  const int l = __popc(__ballot_sync(kFull, want_l && (!want_r || nl <= nr)));
  const int r = __popc(__ballot_sync(kFull, want_r && (!want_l || nr < nl)));
  return l >= r;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
packet_kernel(Walk s, Rays r) {
  __shared__ int stack_ref[kWarps][evplp::kStackDepth];
  __shared__ unsigned stack_mask[kWarps][evplp::kStackDepth];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* sref = stack_ref[warp];
  unsigned* smask = stack_mask[warp];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool in_range = i < r.num_rays;
  // lanes past the last ray: a ray that is not traced (t_max <= t_min)
  const Ray ray = in_range
      ? evplp::load_ray(r, i)
      : evplp::make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 1.0f);
  float t = in_range ? r.t_max[i] : 0.0f;
  int prim = -1;
  float hu = 0.0f, hv = 0.0f;
  float stack_near[evplp::kStackDepth];  // this lane's t_near of each entry

  int cur = 0, sp = 0;  // the current record (-1: pop) and the stack size
  unsigned mask = __ballot_sync(kFull, t > ray.lo);
  while (true) {
    if (cur < 0) {
      mask = 0;
      while (sp > 0 && mask == 0) {
        --sp;
        const bool mine = (smask[sp] >> lane) & 1u;
        const bool keep = stack_near[sp] <= t * evplp::kLeafWidenT;
        mask = __ballot_sync(kFull, mine && keep && (!kAnyHit || prim < 0));
        cur = sref[sp];
      }
      if (mask == 0) break;
    }
    const bool in = (mask >> lane) & 1u;
    if (__popc(mask) < kSolo) {
      if (in) evplp::walk<kAnyHit, true>(s, ray, cur, t, prim, hu, hv);
      cur = -1;
      continue;
    }
    // one packet step at record cur
    float nl, nr;
    bool want_l, want_r;
    const int4 m =
        evplp::test_children<true>(s, ray, cur, t, nl, nr, want_l, want_r);
    const bool leaf_l = m.x < 0, leaf_r = m.y < 0;
    want_l = want_l && in;
    want_r = want_r && in;
    const bool lw_l = want_l && leaf_l, lw_r = want_r && leaf_r;
    if (__any_sync(kFull, lw_l || lw_r)) {
      const bool lf = left_first(lw_l, lw_r, nl, nr);
      if (lf ? lw_l : lw_r)
        evplp::test_leaf<kAnyHit>(s, ray, ~(lf ? m.x : m.y), lf ? m.z : m.w,
                                  t, prim, hu, hv);
      // the second leaf, if t still admits it
      if ((lf ? lw_r : lw_l) && (lf ? nr : nl) <= t * evplp::kLeafWidenT &&
          (!kAnyHit || prim < 0))
        evplp::test_leaf<kAnyHit>(s, ray, ~(lf ? m.y : m.x), lf ? m.w : m.z,
                                  t, prim, hu, hv);
    }
    const bool alive = !kAnyHit || prim < 0;
    const bool go_l = want_l && !leaf_l && alive;
    const bool go_r = want_r && !leaf_r && alive;
    const unsigned ml = __ballot_sync(kFull, go_l);
    const unsigned mr = __ballot_sync(kFull, go_r);
    if (ml && mr) {
      const bool lf = left_first(go_l, go_r, nl, nr);
      __syncwarp();  // every lane has read the entry this one overwrites
      if (lane == 0) {
        sref[sp] = lf ? m.y : m.x;
        smask[sp] = lf ? mr : ml;
      }
      stack_near[sp] = lf ? nr : nl;
      ++sp;
      __syncwarp();
      cur = lf ? m.x : m.y;
      mask = lf ? ml : mr;
    } else if (ml | mr) {
      cur = ml ? m.x : m.y;
      mask = ml | mr;
    } else {
      cur = -1;
    }
  }
  if (in_range) {
    r.t[i] = t;
    r.prim[i] = prim;
    r.u[i] = hu;
    r.v[i] = hv;
  }
}

}  // namespace

extern "C" int evplp_packet(const void* nodes, const void* tris,
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
    packet_kernel<true><<<grid, kBlock, 0, st>>>(s, r);
  else
    packet_kernel<false><<<grid, kBlock, 0, st>>>(s, r);
  return static_cast<int>(cudaGetLastError());
}
