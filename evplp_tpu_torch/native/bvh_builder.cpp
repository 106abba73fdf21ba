// Native BVH builder (binned SAH), a copy of the JAX package's
// native/bvh_builder.cpp kept byte-for-byte in its algorithm so both packages
// emit the same flattened skip-pointer DFS tree (the port never imports the
// JAX package).  Loaded with ctypes by evplp_tpu_torch/native/bvh_native.py.
//
// Primitives live in a contiguous array of 32-byte PrimRef records that is
// partitioned in place; each split costs one fused 3-axis binning pass and
// one partition pass.  SAH semantics: 16 bins, area*count cost, first-best
// split, centroid binning.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libbvh.so bvh_builder.cpp

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

constexpr int kBins = 16;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Aabb {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const Aabb& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

// 32-byte record, partitioned in place; centroid derived as (lo+hi)*0.5
// (identical to the former precomputed-centroid convention).
struct PrimRef {
  float lox, loy, loz;
  float hix, hiy, hiz;
  int32_t index;
  int32_t pad;
  inline float centroid(int axis) const {
    const float* lo = &lox;
    const float* hi = &hix;
    return (lo[axis] + hi[axis]) * 0.5f;
  }
  inline Vec3 lo() const { return {lox, loy, loz}; }
  inline Vec3 hi() const { return {hix, hiy, hiz}; }
};

struct Node {
  Aabb box;
  int first = -1;   // leaf: first triangle in perm order
  int count = 0;    // leaf: triangle count; 0 = internal
  int left = -1;    // internal children
  int right = -1;
};

struct Builder {
  std::vector<PrimRef> prims;
  std::vector<Node> nodes;
  int leaf_size;

  int new_node(const Aabb& box, int lo, int hi) {
    Node n;
    n.box = box;
    n.first = lo;
    n.count = hi - lo;
    nodes.push_back(n);
    return static_cast<int>(nodes.size()) - 1;
  }

  // One sequential pass computing geometry + centroid bounds of [lo, hi).
  void scan_bounds(int lo, int hi, Aabb* geom, Aabb* cent) const {
    Aabb g, c;
    for (int i = lo; i < hi; ++i) {
      const PrimRef& p = prims[i];
      g.grow(p.lo());
      g.grow(p.hi());
      c.grow(Vec3{p.centroid(0), p.centroid(1), p.centroid(2)});
    }
    *geom = g;
    *cent = c;
  }

  void build(int root_lo, int root_hi) {
    struct Item {
      int node, lo, hi;
      Aabb cent;  // centroid bounds of [lo, hi), propagated from the parent
    };
    Aabb root_geom, root_cent;
    scan_bounds(root_lo, root_hi, &root_geom, &root_cent);
    std::vector<Item> stack;
    stack.push_back({new_node(root_geom, root_lo, root_hi),
                     root_lo, root_hi, root_cent});

    while (!stack.empty()) {
      Item it = std::move(stack.back());
      stack.pop_back();
      int n = it.hi - it.lo;
      if (n <= leaf_size) continue;

      const Aabb& cb = it.cent;
      float cmin[3] = {cb.lo.x, cb.lo.y, cb.lo.z};
      float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y,
                      cb.hi.z - cb.lo.z};

      // Fused 3-axis binning: one pass over the records computes all three
      // axes' bin boxes/counts.
      Aabb bbox[3][kBins];
      int bcount[3][kBins] = {{0}};
      float scale[3];
      bool live[3];
      for (int a = 0; a < 3; ++a) {
        live[a] = ext[a] > 1e-12f;
        scale[a] = live[a] ? float(kBins) / ext[a] : 0.f;
      }
      for (int i = it.lo; i < it.hi; ++i) {
        const PrimRef& p = prims[i];
        Aabb pb;
        pb.lo = p.lo();
        pb.hi = p.hi();
        for (int a = 0; a < 3; ++a) {
          if (!live[a]) continue;
          int b = std::min(int((p.centroid(a) - cmin[a]) * scale[a]),
                           kBins - 1);
          bbox[a][b].grow(pb);
          ++bcount[a][b];
        }
      }

      float best_cost = FLT_MAX;
      int best_axis = -1;
      float best_thr = 0.f;
      for (int axis = 0; axis < 3; ++axis) {
        if (!live[axis]) continue;
        Aabb right_acc[kBins];
        Aabb acc;
        for (int b = kBins - 1; b >= 0; --b) {
          if (bcount[axis][b]) acc.grow(bbox[axis][b]);
          right_acc[b] = acc;
        }
        Aabb lacc;
        int lcount = 0;
        for (int b = 0; b < kBins - 1; ++b) {
          if (bcount[axis][b]) lacc.grow(bbox[axis][b]);
          lcount += bcount[axis][b];
          int rcount = n - lcount;
          if (!lcount || !rcount) continue;
          float cost = lacc.area() * lcount + right_acc[b + 1].area() * rcount;
          if (cost < best_cost) {
            best_cost = cost;
            best_axis = axis;
            best_thr = cmin[axis] + ext[axis] * float(b + 1) / kBins;
          }
        }
      }

      int mid;
      Aabb lgeom, rgeom, lcent, rcent;
      if (best_axis >= 0) {
        // Two-pointer partition that also accumulates both children's
        // geometry and centroid bounds (saves the per-child rescan).
        int i = it.lo, j = it.hi;
        while (i < j) {
          while (i < j && prims[i].centroid(best_axis) < best_thr) ++i;
          while (i < j && prims[j - 1].centroid(best_axis) >= best_thr) --j;
          if (i < j) {
            std::swap(prims[i], prims[j - 1]);
            ++i;
            --j;
          }
        }
        mid = i;
      } else {
        // coincident centroids: arbitrary index split (no fat leaves — the
        // packet layout requires count <= leaf_size)
        mid = it.lo + n / 2;
      }
      if (mid == it.lo || mid == it.hi) {  // degenerate: median split
        int axis = best_axis >= 0 ? best_axis : 0;
        std::nth_element(prims.data() + it.lo, prims.data() + it.lo + n / 2,
                         prims.data() + it.hi,
                         [axis](const PrimRef& a, const PrimRef& b) {
                           return a.centroid(axis) < b.centroid(axis);
                         });
        mid = it.lo + n / 2;
      }
      for (int i = it.lo; i < mid; ++i) {
        const PrimRef& p = prims[i];
        lgeom.grow(p.lo());
        lgeom.grow(p.hi());
        lcent.grow(Vec3{p.centroid(0), p.centroid(1), p.centroid(2)});
      }
      for (int i = mid; i < it.hi; ++i) {
        const PrimRef& p = prims[i];
        rgeom.grow(p.lo());
        rgeom.grow(p.hi());
        rcent.grow(Vec3{p.centroid(0), p.centroid(1), p.centroid(2)});
      }

      int left = new_node(lgeom, it.lo, mid);
      int right = new_node(rgeom, mid, it.hi);
      nodes[it.node].left = left;
      nodes[it.node].right = right;
      nodes[it.node].first = -1;
      nodes[it.node].count = 0;
      stack.push_back({right, mid, it.hi, rcent});
      stack.push_back({left, it.lo, mid, lcent});
    }
  }
};

}  // namespace

extern "C" int evplp_build_bvh(
    const float* v0, const float* v1, const float* v2, int num_tris,
    int leaf_size, int max_nodes,
    float* out_node_min, float* out_node_max, int* out_skip,
    int* out_first, int* out_count, int* out_perm) {
  Builder b;
  b.leaf_size = leaf_size;
  b.prims.resize(num_tris);
  for (int i = 0; i < num_tris; ++i) {
    Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    Vec3 c{v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]};
    Vec3 d{v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]};
    Aabb box;
    box.grow(a);
    box.grow(c);
    box.grow(d);
    PrimRef& p = b.prims[i];
    p.lox = box.lo.x;
    p.loy = box.lo.y;
    p.loz = box.lo.z;
    p.hix = box.hi.x;
    p.hiy = box.hi.y;
    p.hiz = box.hi.z;
    p.index = i;
    p.pad = 0;
  }
  // Expected node count ~ 4*N/leaf; the caller's retry loop handles overflow.
  b.nodes.reserve(std::max<size_t>(64, 4 * size_t(num_tris) /
                                           std::max(leaf_size, 1)));
  b.build(0, num_tris);

  const int total = static_cast<int>(b.nodes.size());
  if (total > max_nodes) return -total;  // caller re-allocates

  // DFS flatten + skip pointers
  std::vector<int> order;
  order.reserve(total);
  std::vector<int> subtree(total, 0);
  {
    // iterative postorder for subtree sizes
    std::vector<std::pair<int, bool>> st;
    st.push_back({0, false});
    while (!st.empty()) {
      auto [nd, done] = st.back();
      st.pop_back();
      const Node& n = b.nodes[nd];
      if (n.count > 0) {
        subtree[nd] = 1;
      } else if (done) {
        subtree[nd] = 1 + subtree[n.left] + subtree[n.right];
      } else {
        st.push_back({nd, true});
        st.push_back({n.left, false});
        st.push_back({n.right, false});
      }
    }
  }
  {
    std::vector<int> st;
    st.push_back(0);
    while (!st.empty()) {
      int nd = st.back();
      st.pop_back();
      order.push_back(nd);
      const Node& n = b.nodes[nd];
      if (n.count == 0) {
        st.push_back(n.right);
        st.push_back(n.left);
      }
    }
  }
  for (int pos = 0; pos < total; ++pos) {
    const Node& n = b.nodes[order[pos]];
    out_node_min[3 * pos] = n.box.lo.x;
    out_node_min[3 * pos + 1] = n.box.lo.y;
    out_node_min[3 * pos + 2] = n.box.lo.z;
    out_node_max[3 * pos] = n.box.hi.x;
    out_node_max[3 * pos + 1] = n.box.hi.y;
    out_node_max[3 * pos + 2] = n.box.hi.z;
    out_skip[pos] = pos + subtree[order[pos]];
    out_first[pos] = n.count > 0 ? n.first : -1;
    out_count[pos] = n.count;
  }
  for (int i = 0; i < num_tris; ++i) out_perm[i] = b.prims[i].index;
  return total;
}
