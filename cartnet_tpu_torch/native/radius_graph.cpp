// PBC radius graph on the host (the port's own copy of
// cartnet_tpu/native/radius_graph.cpp, with a plain C interface for ctypes
// in place of the CPython module).
//
// Same semantics as cartnet_tpu_torch/data/radius_graph.py's numpy path:
// per-crystal image repetitions from reciprocal plane distances, all-pairs
// distance test over the image grid, 0.0001 < d^2 <= r^2 keep rule,
// optional soft max-neighbor cap with 0.01 squared-distance degeneracy
// tolerance. Nothing O(n^2 * num_cells) is materialized: pairs stream
// through registers. Edge order is the numpy builder's (dst-major, then
// src, then image index), and the arithmetic is the JAX package's native
// builder's, so the same flags give the same bits.
//
//   void* rg_build(const double* pos, int n, const double* cell,
//                  double radius, int max_neighbors, int64_t* n_edges)
//   void  rg_fetch(void* graph, int32_t* src, int32_t* dst, float* dist,
//                  float* dir)   // copies the edges out and frees graph
//   void  rg_free(void* graph)
//
// rg_build returns nullptr when it cannot allocate.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <new>
#include <vector>

namespace {

struct Edge {
  int32_t src;
  int32_t dst;
  double d2;
  double dx, dy, dz;
};

inline void cross3(const double a[3], const double b[3], double out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// Soft per-atom neighbor cap (degeneracy tolerance 0.01 on SQUARED
// distances): per dst, every edge within 0.01 of the max_neighbors-th
// smallest d^2 stays.
void apply_soft_cap(std::vector<Edge>& edges, int n_atoms, int max_neighbors) {
  std::vector<int> counts(n_atoms, 0);
  for (const auto& e : edges) counts[e.dst]++;
  int maxc = 0;
  for (int c : counts) maxc = std::max(maxc, c);
  if (maxc <= max_neighbors) return;

  std::vector<double> cutoff(n_atoms,
                             std::numeric_limits<double>::infinity());
  // edges are grouped by dst already (dst-major emission order)
  std::vector<double> buf;
  size_t i = 0;
  while (i < edges.size()) {
    int a = edges[i].dst;
    size_t j = i;
    while (j < edges.size() && edges[j].dst == a) j++;
    if ((int)(j - i) > max_neighbors) {
      buf.clear();
      for (size_t k = i; k < j; k++) buf.push_back(edges[k].d2);
      std::nth_element(buf.begin(), buf.begin() + max_neighbors, buf.end());
      cutoff[a] = buf[max_neighbors] + 0.01;
    }
    i = j;
  }
  edges.erase(std::remove_if(edges.begin(), edges.end(),
                             [&](const Edge& e) {
                               return e.d2 > cutoff[e.dst];
                             }),
              edges.end());
}

void build(const double* P, int n, const double* C, double radius,
           int max_neighbors, std::vector<Edge>& edges) {
  // image repetitions per axis: ceil(radius / plane distance)
  const double a1[3] = {C[0], C[1], C[2]};
  const double a2[3] = {C[3], C[4], C[5]};
  const double a3[3] = {C[6], C[7], C[8]};
  double c23[3], c31[3], c12[3];
  cross3(a2, a3, c23);
  cross3(a3, a1, c31);
  cross3(a1, a2, c12);
  double vol = std::fabs(a1[0] * c23[0] + a1[1] * c23[1] + a1[2] * c23[2]);
  int reps[3] = {0, 0, 0};
  const double* crosses[3] = {c23, c31, c12};
  for (int k = 0; k < 3 && vol > 0; k++) {
    double norm = std::sqrt(crosses[k][0] * crosses[k][0] +
                            crosses[k][1] * crosses[k][1] +
                            crosses[k][2] * crosses[k][2]);
    reps[k] = (int)std::ceil(radius * norm / vol);
  }

  const double r2 = radius * radius;
  edges.reserve((size_t)n * 40);
  // dst-major, then src, then image: the numpy builder's nonzero() order
  for (int i = 0; i < n; i++) {
    const double pi[3] = {P[3 * i], P[3 * i + 1], P[3 * i + 2]};
    for (int j = 0; j < n; j++) {
      const double pj[3] = {P[3 * j], P[3 * j + 1], P[3 * j + 2]};
      for (int ia = -reps[0]; ia <= reps[0]; ia++)
        for (int ib = -reps[1]; ib <= reps[1]; ib++)
          for (int ic = -reps[2]; ic <= reps[2]; ic++) {
            const double ox = ia * a1[0] + ib * a2[0] + ic * a3[0];
            const double oy = ia * a1[1] + ib * a2[1] + ic * a3[1];
            const double oz = ia * a1[2] + ib * a2[2] + ic * a3[2];
            const double dx = pi[0] - (pj[0] + ox);
            const double dy = pi[1] - (pj[1] + oy);
            const double dz = pi[2] - (pj[2] + oz);
            const double d2 = dx * dx + dy * dy + dz * dz;
            if (d2 <= r2 && d2 > 0.0001) {
              edges.push_back({(int32_t)j, (int32_t)i, d2, dx, dy, dz});
            }
          }
    }
  }
  if (max_neighbors > 0) apply_soft_cap(edges, n, max_neighbors);
}

}  // namespace

extern "C" {

void* rg_build(const double* pos, int n, const double* cell, double radius,
               int max_neighbors, int64_t* n_edges) {
  auto* edges = new (std::nothrow) std::vector<Edge>();
  if (edges == nullptr) return nullptr;
  try {
    build(pos, n, cell, radius, max_neighbors, *edges);
  } catch (const std::bad_alloc&) {
    delete edges;
    return nullptr;
  }
  *n_edges = (int64_t)edges->size();
  return edges;
}

void rg_fetch(void* graph, int32_t* src, int32_t* dst, float* dist,
              float* dir) {
  auto* edges = static_cast<std::vector<Edge>*>(graph);
  const size_t e = edges->size();
  for (size_t k = 0; k < e; k++) {
    const Edge& ed = (*edges)[k];
    const double d = std::sqrt(ed.d2);
    src[k] = ed.src;
    dst[k] = ed.dst;
    dist[k] = (float)d;
    const double inv = d > 1e-12 ? 1.0 / d : 0.0;
    dir[3 * k] = (float)(ed.dx * inv);
    dir[3 * k + 1] = (float)(ed.dy * inv);
    dir[3 * k + 2] = (float)(ed.dz * inv);
  }
  delete edges;
}

void rg_free(void* graph) { delete static_cast<std::vector<Edge>*>(graph); }

}  // extern "C"
