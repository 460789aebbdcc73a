// Native host runtime: the port's copy of the KD-tree of native/dc_native.cpp.
//
// A C++ replacement for the reference's scipy cKDTree neighbour index
// (reference: src/depth_correction/nearest_neighbors.py:22-80), exposed
// through a plain C ABI and loaded with ctypes by
// depth_correction_tpu_torch/utils/native.py, which builds this file with
// g++ at first use into depth_correction_tpu_torch/_build/. It serves
// nn_backend = "native" (host-side neighbourhood establishment in prep).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC dc_native.cpp -o libdcnative.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <limits>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// KD-tree (median-split, 3-D) for kNN and radius queries.

namespace {

struct KDTree {
  // Flattened nodes over a permutation of point indices.
  // Node i covers perm[start, end); leaf if end - start <= kLeaf.
  static constexpr int kLeaf = 16;
  const double* pts;
  int64_t n;
  std::vector<int64_t> perm;

  struct Node {
    int64_t start, end;
    int axis;
    double split;
    int32_t left, right;  // -1 for leaf
  };
  std::vector<Node> nodes;

  double coord(int64_t idx, int axis) const { return pts[3 * idx + axis]; }

  int32_t build(int64_t start, int64_t end) {
    Node node{start, end, 0, 0.0, -1, -1};
    int32_t id = (int32_t)nodes.size();
    nodes.push_back(node);
    if (end - start <= kLeaf) return id;
    // Split on the widest axis at the median.
    double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
    for (int64_t i = start; i < end; ++i) {
      for (int a = 0; a < 3; ++a) {
        double v = coord(perm[i], a);
        lo[a] = std::min(lo[a], v);
        hi[a] = std::max(hi[a], v);
      }
    }
    int axis = 0;
    for (int a = 1; a < 3; ++a)
      if (hi[a] - lo[a] > hi[axis] - lo[axis]) axis = a;
    int64_t mid = (start + end) / 2;
    std::nth_element(perm.begin() + start, perm.begin() + mid, perm.begin() + end,
                     [&](int64_t a, int64_t b) { return coord(a, axis) < coord(b, axis); });
    nodes[id].axis = axis;
    nodes[id].split = coord(perm[mid], axis);
    int32_t l = build(start, mid);
    int32_t r = build(mid, end);
    nodes[id].left = l;
    nodes[id].right = r;
    return id;
  }

  explicit KDTree(const double* p, int64_t num) : pts(p), n(num), perm(num) {
    for (int64_t i = 0; i < num; ++i) perm[i] = i;
    nodes.reserve((size_t)(2 * num / kLeaf + 8));
    if (num > 0) build(0, num);
  }

  // k nearest neighbors of q within optional radius bound r (r < 0 = none).
  void knn(const double* q, int k, double r, int64_t* out_idx, double* out_dist) const {
    // Empty tree or k <= 0: all-miss output. Visiting node 0 of an empty
    // nodes vector (or heap.top() with k == 0) is undefined behavior.
    if (nodes.empty() || k <= 0) {
      for (int64_t i = 0; i < k; ++i) {
        out_idx[i] = -1;
        out_dist[i] = std::numeric_limits<double>::infinity();
      }
      return;
    }
    // Max-heap of (dist2, idx) of current best k.
    using Entry = std::pair<double, int64_t>;
    std::priority_queue<Entry> heap;
    double bound2 = r < 0 ? std::numeric_limits<double>::infinity() : r * r;

    struct Visit { int32_t node; double dist2; };
    std::vector<Visit> stack;
    stack.push_back({0, 0.0});
    while (!stack.empty()) {
      Visit v = stack.back();
      stack.pop_back();
      double worst = heap.size() == (size_t)k ? heap.top().first : bound2;
      if (v.dist2 > worst) continue;
      const Node& node = nodes[v.node];
      if (node.left < 0) {
        for (int64_t i = node.start; i < node.end; ++i) {
          int64_t p = perm[i];
          double d2 = 0;
          for (int a = 0; a < 3; ++a) {
            double d = q[a] - pts[3 * p + a];
            d2 += d * d;
          }
          if (d2 > bound2) continue;
          if (heap.size() < (size_t)k) {
            heap.push({d2, p});
          } else if (d2 < heap.top().first ||
                     (d2 == heap.top().first && p < heap.top().second)) {
            heap.pop();
            heap.push({d2, p});
          }
        }
        continue;
      }
      double delta = q[node.axis] - node.split;
      int32_t near = delta <= 0 ? node.left : node.right;
      int32_t far = delta <= 0 ? node.right : node.left;
      stack.push_back({far, delta * delta});
      stack.push_back({near, 0.0});
    }
    int64_t found = (int64_t)heap.size();
    for (int64_t i = found - 1; i >= 0; --i) {
      out_idx[i] = heap.top().second;
      out_dist[i] = std::sqrt(heap.top().first);
      heap.pop();
    }
    for (int64_t i = found; i < k; ++i) {
      out_idx[i] = -1;
      out_dist[i] = std::numeric_limits<double>::infinity();
    }
  }

  // Up to kmax neighbors within radius r, sorted by distance; returns count.
  int64_t radius(const double* q, double r, int kmax, int64_t* out_idx) const {
    if (nodes.empty()) {
      for (int64_t i = 0; i < kmax; ++i) out_idx[i] = -1;
      return 0;
    }
    std::vector<std::pair<double, int64_t>> found;
    double r2 = r * r;
    std::vector<int32_t> stack{0};
    while (!stack.empty()) {
      const Node& node = nodes[stack.back()];
      stack.pop_back();
      if (node.left < 0) {
        for (int64_t i = node.start; i < node.end; ++i) {
          int64_t p = perm[i];
          double d2 = 0;
          for (int a = 0; a < 3; ++a) {
            double d = q[a] - pts[3 * p + a];
            d2 += d * d;
          }
          if (d2 <= r2) found.push_back({d2, p});
        }
        continue;
      }
      double delta = q[node.axis] - node.split;
      if (delta <= r) stack.push_back(node.left);
      if (-delta <= r) stack.push_back(node.right);
    }
    std::sort(found.begin(), found.end());
    int64_t m = std::min<int64_t>((int64_t)found.size(), kmax);
    for (int64_t i = 0; i < m; ++i) out_idx[i] = found[i].second;
    for (int64_t i = m; i < kmax; ++i) out_idx[i] = -1;
    return (int64_t)found.size();
  }
};

}  // namespace

void* dc_kdtree_build(const double* pts, int64_t n) { return new KDTree(pts, n); }

void dc_kdtree_free(void* tree) { delete (KDTree*)tree; }

// kNN for nq queries; out_idx (nq, k) with -1 padding, out_dist (nq, k).
void dc_kdtree_knn(void* tree, const double* queries, int64_t nq, int k,
                   double r, int64_t* out_idx, double* out_dist) {
  KDTree* t = (KDTree*)tree;
  for (int64_t i = 0; i < nq; ++i)
    t->knn(queries + 3 * i, k, r, out_idx + (int64_t)k * i, out_dist + (int64_t)k * i);
}

// Radius search; out_idx (nq, kmax) with -1 padding, out_count (nq,) holds
// true neighbor counts (may exceed kmax, signalling truncation).
void dc_kdtree_radius(void* tree, const double* queries, int64_t nq, double r,
                      int kmax, int64_t* out_idx, int64_t* out_count) {
  KDTree* t = (KDTree*)tree;
  for (int64_t i = 0; i < nq; ++i)
    out_count[i] = t->radius(queries + 3 * i, r, kmax, out_idx + (int64_t)kmax * i);
}

}  // extern "C"
