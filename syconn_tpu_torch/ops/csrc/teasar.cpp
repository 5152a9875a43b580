// TEASAR skeletonization over the implicit voxel grid (no materialized
// CSR graph): the host kernel of syconn_tpu_torch/skeleton/teasar.py, a copy
// of the JAX package's syconn_tpu/csrc/teasar.cpp (the code below is
// unchanged, so both packages' skeletons are equal). Penalty-weighted
// Dijkstra from the geodesically farthest root, repeated farthest-point path
// peeling, rolling-ball invalidation r = const + scale * DBF.
//
// Built with kernels.cpp into the port's host library (utils/native.py),
// extern "C".

#include <cmath>
#include <cstdint>
#include <limits>
#include <queue>
#include <vector>

namespace {

struct QItem {
  float d;
  int64_t v;
  bool operator<(const QItem& o) const { return d > o.d; }  // min-heap
};

// Penalty-weighted Dijkstra over the 26-neighborhood of mask voxels.
// dist/pred are dense over the volume; unreachable/unmasked stay inf/-1.
void dijkstra_grid(const uint8_t* mask, int64_t nx, int64_t ny, int64_t nz,
                   const float* pen, const double* scale, int64_t src,
                   float* dist, int64_t* pred) {
  const int64_t n = nx * ny * nz;
  const float INF = std::numeric_limits<float>::infinity();
  for (int64_t i = 0; i < n; ++i) {
    dist[i] = INF;
    pred[i] = -1;
  }
  // 26 neighbor offsets: coordinate deltas + euclidean step length
  int dx[26], dy[26], dz[26];
  float step[26];
  int m = 0;
  for (int a = -1; a <= 1; ++a)
    for (int b = -1; b <= 1; ++b)
      for (int c = -1; c <= 1; ++c) {
        if (a == 0 && b == 0 && c == 0) continue;
        dx[m] = a;
        dy[m] = b;
        dz[m] = c;
        const double lx = a * scale[0], ly = b * scale[1], lz = c * scale[2];
        step[m] = (float)std::sqrt(lx * lx + ly * ly + lz * lz);
        ++m;
      }
  std::priority_queue<QItem> pq;
  dist[src] = 0.0f;
  pq.push({0.0f, src});
  while (!pq.empty()) {
    const QItem it = pq.top();
    pq.pop();
    if (it.d > dist[it.v]) continue;
    const int64_t v = it.v;
    const int64_t x = v / (ny * nz), y = (v / nz) % ny, z = v % nz;
    const float pv = pen[v];
    for (int k = 0; k < 26; ++k) {
      const int64_t qx = x + dx[k], qy = y + dy[k], qz = z + dz[k];
      if (qx < 0 || qx >= nx || qy < 0 || qy >= ny || qz < 0 || qz >= nz)
        continue;
      const int64_t q = (qx * ny + qy) * nz + qz;
      if (!mask[q]) continue;
      const float nd = it.d + step[k] + 0.5f * (pv + pen[q]);
      if (nd < dist[q]) {
        dist[q] = nd;
        pred[q] = v;
        pq.push({nd, q});
      }
    }
  }
}

}  // namespace

extern "C" {

// Skeletonize ONE connected component. Returns 0 on success, -1 when the
// node/edge capacity is exceeded (caller falls back). dbf in nm.
// out_nodes: (node_cap, 3) int32 voxel coords; out_edges: (edge_cap, 2);
// out_diam: (node_cap,) nm.
int32_t teasar_grid(const uint8_t* mask, int64_t nx, int64_t ny, int64_t nz,
                    const float* dbf, const double* scale,
                    double penalty_k, int32_t penalty_exp,
                    double inval_const_nm, double inval_scale,
                    int64_t max_paths, int32_t* out_nodes, int64_t node_cap,
                    int32_t* out_edges, int64_t edge_cap, float* out_diam,
                    int64_t* n_nodes_out, int64_t* n_edges_out) {
  const int64_t n = nx * ny * nz;
  // penalty field (matches teasar.py: K * (1 - dbf/(1.01*max))^exp)
  float dmax = 0.0f;
  for (int64_t i = 0; i < n; ++i)
    if (mask[i] && dbf[i] > dmax) dmax = dbf[i];
  if (dmax <= 0.0f) dmax = 1.0f;
  std::vector<float> pen(n, 0.0f);
  const double inv = 1.0 / (1.01 * dmax);
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    double b = 1.0 - dbf[i] * inv;
    double p = 1.0;
    for (int32_t e = 0; e < penalty_exp; ++e) p *= b;
    pen[i] = (float)(penalty_k * p);
  }
  // first masked voxel as the arbitrary start
  int64_t start = -1;
  for (int64_t i = 0; i < n; ++i)
    if (mask[i]) {
      start = i;
      break;
    }
  if (start < 0) {
    *n_nodes_out = 0;
    *n_edges_out = 0;
    return 0;
  }
  std::vector<float> dist(n);
  std::vector<int64_t> pred(n);
  dijkstra_grid(mask, nx, ny, nz, pen.data(), scale, start, dist.data(),
                pred.data());
  int64_t root = start;
  float best = -1.0f;
  for (int64_t i = 0; i < n; ++i)
    if (mask[i] && std::isfinite(dist[i]) && dist[i] > best) {
      best = dist[i];
      root = i;
    }
  dijkstra_grid(mask, nx, ny, nz, pen.data(), scale, root, dist.data(),
                pred.data());

  std::vector<uint8_t> visited(n, 0), on_tree(n, 0);
  std::vector<int32_t> node_id(n, -1);
  for (int64_t i = 0; i < n; ++i)
    if (!mask[i] || !std::isfinite(dist[i])) visited[i] = 1;
  int64_t n_nodes = 0, n_edges = 0;
  auto add_node = [&](int64_t v) -> int32_t {
    if (n_nodes >= node_cap) return -1;
    const int32_t id = (int32_t)n_nodes++;
    node_id[v] = id;
    out_nodes[id * 3 + 0] = (int32_t)(v / (ny * nz));
    out_nodes[id * 3 + 1] = (int32_t)((v / nz) % ny);
    out_nodes[id * 3 + 2] = (int32_t)(v % nz);
    out_diam[id] = 2.0f * dbf[v];
    return id;
  };
  if (add_node(root) < 0) return -1;
  on_tree[root] = 1;

  std::vector<int64_t> path;
  for (int64_t it = 0; it < max_paths; ++it) {
    // farthest unvisited voxel
    int64_t target = -1;
    float bd = -1.0f;
    for (int64_t i = 0; i < n; ++i)
      if (!visited[i] && dist[i] > bd) {
        bd = dist[i];
        target = i;
      }
    if (target < 0) break;
    // walk predecessors to the tree
    path.clear();
    int64_t v = target;
    while (v >= 0 && !on_tree[v]) {
      path.push_back(v);
      v = pred[v];
    }
    if (v < 0) {
      visited[target] = 1;
      continue;
    }
    int64_t prev = v;  // anchor on the tree
    for (auto itp = path.rbegin(); itp != path.rend(); ++itp) {
      const int64_t p = *itp;
      if (node_id[p] < 0 && add_node(p) < 0) return -1;
      if (n_edges >= edge_cap) return -1;
      out_edges[n_edges * 2 + 0] = node_id[prev];
      out_edges[n_edges * 2 + 1] = node_id[p];
      ++n_edges;
      on_tree[p] = 1;
      prev = p;
    }
    // rolling-ball invalidation: box scan around each path node
    for (const int64_t p : path) {
      const double r = inval_const_nm + inval_scale * dbf[p];
      const int64_t px = p / (ny * nz), py = (p / nz) % ny, pz = p % nz;
      const int64_t rx = (int64_t)(r / scale[0]) + 1;
      const int64_t ry = (int64_t)(r / scale[1]) + 1;
      const int64_t rz = (int64_t)(r / scale[2]) + 1;
      const double r2 = r * r;
      for (int64_t x = std::max<int64_t>(0, px - rx);
           x <= std::min(nx - 1, px + rx); ++x) {
        const double ddx = (x - px) * scale[0];
        for (int64_t y = std::max<int64_t>(0, py - ry);
             y <= std::min(ny - 1, py + ry); ++y) {
          const double ddy = (y - py) * scale[1];
          const double dxy = ddx * ddx + ddy * ddy;
          if (dxy > r2) continue;
          const int64_t base = (x * ny + y) * nz;
          for (int64_t z = std::max<int64_t>(0, pz - rz);
               z <= std::min(nz - 1, pz + rz); ++z) {
            const double ddz = (z - pz) * scale[2];
            if (dxy + ddz * ddz <= r2) visited[base + z] = 1;
          }
        }
      }
    }
    visited[target] = 1;
  }
  *n_nodes_out = n_nodes;
  *n_edges_out = n_edges;
  return 0;
}

}  // extern "C"
