// Native BVH builder: preorder flat skip-pointer layout.
//
// rfx's equivalent of the C++/CUDA LBVH that warp-lang
// builds inside wp.Mesh (reference tracer.py:24 calls into the warp
// dependency; there is no native code in the reference repo itself). Output
// layout matches rfx/bvh.py's NumPy builder exactly (DFS preorder nodes,
// skip pointers, leaf_size-padded leaf-reordered triangle SoA) so the two
// builders are interchangeable; this one is for large meshes where the
// Python recursion dominates scene-load time.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)
// Binding: rfx/ops/native_lib.py via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kSahBins = 16;  // matches rfx/bvh.py _SAH_BINS

struct Builder {
  int leaf_size;
  int num_tris;
  int split_mode;     // 0 = centroid median, 1 = binned SAH (numpy parity)
  const float* tris;  // (F, 9): v0 v1 v2

  std::vector<float> tmin, tmax, centroid;  // (F, 3) each
  std::vector<int64_t> order;

  // Flat output
  std::vector<float> aabb_min, aabb_max;  // (n_nodes, 3)
  std::vector<int32_t> tri_start, tri_count, skip;
  struct LeafRange { int64_t padded_start, order_lo; int32_t count; };
  std::vector<LeafRange> leaves;
  int64_t padded_cursor = 0;

  void precompute() {
    tmin.resize(num_tris * 3);
    tmax.resize(num_tris * 3);
    centroid.resize(num_tris * 3);
    for (int i = 0; i < num_tris; ++i) {
      const float* t = tris + i * 9;
      for (int a = 0; a < 3; ++a) {
        float v0 = t[a], v1 = t[3 + a], v2 = t[6 + a];
        float lo = std::min(v0, std::min(v1, v2));
        float hi = std::max(v0, std::max(v1, v2));
        tmin[i * 3 + a] = lo;
        tmax[i * 3 + a] = hi;
        centroid[i * 3 + a] = (v0 + v1 + v2) / 3.0f;
      }
    }
    order.resize(num_tris);
    for (int i = 0; i < num_tris; ++i) order[i] = i;
  }

  // Centroid-median split on the widest axis; returns the mid index.
  int64_t median_split(int64_t lo, int64_t hi) {
    float cmin[3] = {1e30f, 1e30f, 1e30f}, cmax[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t k = lo; k < hi; ++k) {
      int64_t t = order[k];
      for (int a = 0; a < 3; ++a) {
        cmin[a] = std::min(cmin[a], centroid[t * 3 + a]);
        cmax[a] = std::max(cmax[a], centroid[t * 3 + a]);
      }
    }
    int axis = 0;
    float best = cmax[0] - cmin[0];
    for (int a = 1; a < 3; ++a)
      if (cmax[a] - cmin[a] > best) { best = cmax[a] - cmin[a]; axis = a; }
    int64_t mid = (lo + hi) / 2;
    std::nth_element(
        order.begin() + lo, order.begin() + mid, order.begin() + hi,
        [&](int64_t a, int64_t b) {
          return centroid[a * 3 + axis] < centroid[b * 3 + axis];
        });
    return mid;
  }

  // Binned SAH split (16 bins x 3 axes), same heuristic as the numpy
  // builder's _sah_split (rfx/bvh.py): minimize SA_L*n_L + SA_R*n_R over bin
  // boundaries with per-bin bounds accumulated from triangle AABBs in
  // double precision; falls back to the median split when SAH degenerates.
  int64_t sah_split(int64_t lo, int64_t hi) {
    int64_t n = hi - lo;
    double cmin[3] = {1e300, 1e300, 1e300}, cmax[3] = {-1e300, -1e300, -1e300};
    for (int64_t k = lo; k < hi; ++k) {
      int64_t t = order[k];
      for (int a = 0; a < 3; ++a) {
        cmin[a] = std::min(cmin[a], (double)centroid[t * 3 + a]);
        cmax[a] = std::max(cmax[a], (double)centroid[t * 3 + a]);
      }
    }
    double best_cost = 1e300;
    int best_axis = -1, best_bin = -1;
    for (int axis = 0; axis < 3; ++axis) {
      double ext = cmax[axis] - cmin[axis];
      if (ext <= 0.0) continue;
      int64_t counts[kSahBins] = {0};
      double bmin[kSahBins][3], bmax[kSahBins][3];
      for (int b = 0; b < kSahBins; ++b)
        for (int a = 0; a < 3; ++a) { bmin[b][a] = 1e300; bmax[b][a] = -1e300; }
      for (int64_t k = lo; k < hi; ++k) {
        int64_t t = order[k];
        int b = (int)((centroid[t * 3 + axis] - cmin[axis]) / ext * kSahBins);
        b = std::min(b, kSahBins - 1);
        counts[b]++;
        for (int a = 0; a < 3; ++a) {
          bmin[b][a] = std::min(bmin[b][a], (double)tmin[t * 3 + a]);
          bmax[b][a] = std::max(bmax[b][a], (double)tmax[t * 3 + a]);
        }
      }
      // prefix (left) sweep
      double lmin[3] = {1e300, 1e300, 1e300}, lmax[3] = {-1e300, -1e300, -1e300};
      int64_t lcnt = 0;
      double la[kSahBins], lc[kSahBins];
      for (int b = 0; b < kSahBins - 1; ++b) {
        for (int a = 0; a < 3; ++a) {
          lmin[a] = std::min(lmin[a], bmin[b][a]);
          lmax[a] = std::max(lmax[a], bmax[b][a]);
        }
        lcnt += counts[b];
        double d0 = std::max(lmax[0] - lmin[0], 0.0);
        double d1 = std::max(lmax[1] - lmin[1], 0.0);
        double d2 = std::max(lmax[2] - lmin[2], 0.0);
        la[b] = d0 * d1 + d1 * d2 + d2 * d0;
        lc[b] = (double)lcnt;
      }
      // suffix (right) sweep + cost
      double rmin[3] = {1e300, 1e300, 1e300}, rmax[3] = {-1e300, -1e300, -1e300};
      int64_t rcnt = 0;
      for (int b = kSahBins - 1; b >= 1; --b) {
        for (int a = 0; a < 3; ++a) {
          rmin[a] = std::min(rmin[a], bmin[b][a]);
          rmax[a] = std::max(rmax[a], bmax[b][a]);
        }
        rcnt += counts[b];
        double d0 = std::max(rmax[0] - rmin[0], 0.0);
        double d1 = std::max(rmax[1] - rmin[1], 0.0);
        double d2 = std::max(rmax[2] - rmin[2], 0.0);
        double ra = d0 * d1 + d1 * d2 + d2 * d0;
        int k = b - 1;  // split after bin k
        if (lc[k] > 0 && rcnt > 0) {
          double cost = la[k] * lc[k] + ra * (double)rcnt;
          if (cost < best_cost) { best_cost = cost; best_axis = axis; best_bin = k; }
        }
      }
    }
    if (best_axis < 0) return median_split(lo, hi);
    double ext = cmax[best_axis] - cmin[best_axis];
    int64_t mid = lo + (int64_t)(std::stable_partition(
        order.begin() + lo, order.begin() + hi,
        [&](int64_t t) {
          int b = (int)((centroid[t * 3 + best_axis] - cmin[best_axis]) / ext * kSahBins);
          return std::min(b, kSahBins - 1) <= best_bin;
        }) - (order.begin() + lo));
    if (mid == lo || mid == hi) return median_split(lo, hi);
    return mid;
  }

  int64_t split(int64_t lo, int64_t hi) {
    return split_mode == 1 ? sah_split(lo, hi) : median_split(lo, hi);
  }

  // Iterative preorder build with an explicit stack. A frame is either a
  // span to emit (lo, hi) or a fixup marking "subtree of node idx ended".
  struct Frame { int64_t lo, hi; int32_t fixup_node; bool is_fixup; };

  void build() {
    precompute();
    std::vector<Frame> stack;
    stack.push_back({0, num_tris, -1, false});
    while (!stack.empty()) {
      Frame f = stack.back();
      stack.pop_back();
      if (f.is_fixup) {
        skip[f.fixup_node] = (int32_t)aabb_min.size() / 3;
        continue;
      }
      int64_t lo = f.lo, hi = f.hi;
      int32_t idx = (int32_t)(aabb_min.size() / 3);
      // Node AABB over the span
      float bmin[3] = {1e30f, 1e30f, 1e30f}, bmax[3] = {-1e30f, -1e30f, -1e30f};
      for (int64_t k = lo; k < hi; ++k) {
        int64_t t = order[k];
        for (int a = 0; a < 3; ++a) {
          bmin[a] = std::min(bmin[a], tmin[t * 3 + a]);
          bmax[a] = std::max(bmax[a], tmax[t * 3 + a]);
        }
      }
      for (int a = 0; a < 3; ++a) {
        aabb_min.push_back(bmin[a]);
        aabb_max.push_back(bmax[a]);
      }
      tri_start.push_back(0);
      tri_count.push_back(0);
      skip.push_back(0);
      stack.push_back({0, 0, idx, true});  // fixup fires after the subtree

      int64_t n = hi - lo;
      if (n <= leaf_size) {
        int64_t padded = (n + leaf_size - 1) / leaf_size * leaf_size;
        tri_start[idx] = (int32_t)padded_cursor;
        tri_count[idx] = (int32_t)n;
        leaves.push_back({padded_cursor, lo, (int32_t)n});
        padded_cursor += padded;
      } else {
        int64_t mid = split(lo, hi);
        // Right child pushed first so the left lands at idx+1 (preorder).
        stack.push_back({mid, hi, -1, false});
        stack.push_back({lo, mid, -1, false});
      }
    }
  }
};

}  // namespace

extern "C" {

void* rfx_bvh_build(const float* tris, int num_tris, int leaf_size,
                    int split_mode) {
  Builder* b = new Builder();
  b->leaf_size = leaf_size;
  b->num_tris = num_tris;
  b->split_mode = split_mode;
  b->tris = tris;
  b->build();
  return b;
}

int rfx_bvh_n_nodes(void* h) { return (int)(((Builder*)h)->aabb_min.size() / 3); }
long long rfx_bvh_n_padded(void* h) { return ((Builder*)h)->padded_cursor; }

void rfx_bvh_fill(void* h, float* aabb_min, float* aabb_max, int32_t* tri_start,
                  int32_t* tri_count, int32_t* skip, float* tri_v0, float* tri_e1,
                  float* tri_e2, int32_t* tri_face) {
  Builder* b = (Builder*)h;
  size_t nn = b->aabb_min.size();
  std::memcpy(aabb_min, b->aabb_min.data(), nn * sizeof(float));
  std::memcpy(aabb_max, b->aabb_max.data(), nn * sizeof(float));
  size_t n_nodes = nn / 3;
  std::memcpy(tri_start, b->tri_start.data(), n_nodes * sizeof(int32_t));
  std::memcpy(tri_count, b->tri_count.data(), n_nodes * sizeof(int32_t));
  std::memcpy(skip, b->skip.data(), n_nodes * sizeof(int32_t));
  // Leaf-reordered, padded triangle SoA; padding rows zero / face -1.
  int64_t P = b->padded_cursor;
  std::memset(tri_v0, 0, P * 3 * sizeof(float));
  std::memset(tri_e1, 0, P * 3 * sizeof(float));
  std::memset(tri_e2, 0, P * 3 * sizeof(float));
  for (int64_t i = 0; i < P; ++i) tri_face[i] = -1;
  for (const auto& lr : b->leaves) {
    for (int32_t k = 0; k < lr.count; ++k) {
      int64_t src = b->order[lr.order_lo + k];
      int64_t dst = lr.padded_start + k;
      const float* t = b->tris + src * 9;
      for (int a = 0; a < 3; ++a) {
        tri_v0[dst * 3 + a] = t[a];
        tri_e1[dst * 3 + a] = t[3 + a] - t[a];
        tri_e2[dst * 3 + a] = t[6 + a] - t[a];
      }
      tri_face[dst] = (int32_t)src;
    }
  }
}

void rfx_bvh_free(void* h) { delete (Builder*)h; }

}  // extern "C"
