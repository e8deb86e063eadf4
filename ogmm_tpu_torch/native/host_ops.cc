// Host-side native ops of the ogmm_tpu_torch input pipeline (C ABI, bound
// with ctypes by native/__init__.py): radius overlap labels, 1-NN and the
// sequential FPS of one cloud. The original leans on third-party C++ for
// these jobs (Open3D's KDTreeFlann radius search for the ground-truth overlap
// labels, sklearn/scipy KD-trees for 1-NN, a Python FPS loop). They run in
// the loader's worker threads on the host, never on the card.
//
// A copy of the JAX package's host library, built with the same flags, so
// that both packages give the same labels, indices and distances.
//
// All neighbour queries use a uniform voxel grid hash rather than a KD-tree:
// point counts are small (<= ~50k), queries are fixed-radius or 1-NN over
// clouds with bounded spread, and a flat grid has better cache behaviour and
// trivially correct semantics (scan the 27 neighbouring cells).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC host_ops.cc -o libogmm_host.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Grid {
  float cell;            // cell edge length
  float ox, oy, oz;      // origin
  int nx, ny, nz;        // grid dims
  std::vector<int32_t> cell_start;   // size nx*ny*nz+1, prefix offsets
  std::vector<int32_t> order;        // point ids sorted by cell

  inline int clampi(int v, int lo, int hi) const {
    return v < lo ? lo : (v > hi ? hi : v);
  }
  inline int cell_of(float x, float y, float z) const {
    int ix = clampi(static_cast<int>((x - ox) / cell), 0, nx - 1);
    int iy = clampi(static_cast<int>((y - oy) / cell), 0, ny - 1);
    int iz = clampi(static_cast<int>((z - oz) / cell), 0, nz - 1);
    return (ix * ny + iy) * nz + iz;
  }

  void build(const float* pts, int n, float cell_size) {
    cell = cell_size;
    float mn[3] = {std::numeric_limits<float>::max(),
                   std::numeric_limits<float>::max(),
                   std::numeric_limits<float>::max()};
    float mx[3] = {-mn[0], -mn[1], -mn[2]};
    for (int i = 0; i < n; ++i) {
      for (int d = 0; d < 3; ++d) {
        mn[d] = std::min(mn[d], pts[3 * i + d]);
        mx[d] = std::max(mx[d], pts[3 * i + d]);
      }
    }
    ox = mn[0]; oy = mn[1]; oz = mn[2];
    auto dim = [&](float lo, float hi) {
      int d = static_cast<int>((hi - lo) / cell) + 1;
      return d < 1 ? 1 : d;
    };
    nx = dim(mn[0], mx[0]); ny = dim(mn[1], mx[1]); nz = dim(mn[2], mx[2]);
    // guard absurd grids (degenerate cell size vs spread): cap total cells
    const int64_t max_cells = 1 << 24;
    while (static_cast<int64_t>(nx) * ny * nz > max_cells) {
      cell *= 2.0f;
      nx = dim(mn[0], mx[0]); ny = dim(mn[1], mx[1]); nz = dim(mn[2], mx[2]);
    }
    int ncells = nx * ny * nz;
    std::vector<int32_t> counts(ncells + 1, 0);
    std::vector<int32_t> cid(n);
    for (int i = 0; i < n; ++i) {
      cid[i] = cell_of(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]);
      counts[cid[i] + 1]++;
    }
    for (int c = 0; c < ncells; ++c) counts[c + 1] += counts[c];
    cell_start = counts;
    order.resize(n);
    std::vector<int32_t> cursor(cell_start.begin(), cell_start.end() - 1);
    for (int i = 0; i < n; ++i) order[cursor[cid[i]]++] = i;
  }

  // visit every point within `radius` of (x,y,z); F(j, d2)
  template <typename F>
  void for_each_in_radius(const float* pts, float x, float y, float z,
                          float radius, F&& f) const {
    float r2 = radius * radius;
    int ix0 = clampi(static_cast<int>((x - radius - ox) / cell), 0, nx - 1);
    int ix1 = clampi(static_cast<int>((x + radius - ox) / cell), 0, nx - 1);
    int iy0 = clampi(static_cast<int>((y - radius - oy) / cell), 0, ny - 1);
    int iy1 = clampi(static_cast<int>((y + radius - oy) / cell), 0, ny - 1);
    int iz0 = clampi(static_cast<int>((z - radius - oz) / cell), 0, nz - 1);
    int iz1 = clampi(static_cast<int>((z + radius - oz) / cell), 0, nz - 1);
    for (int ix = ix0; ix <= ix1; ++ix)
      for (int iy = iy0; iy <= iy1; ++iy)
        for (int iz = iz0; iz <= iz1; ++iz) {
          int c = (ix * ny + iy) * nz + iz;
          for (int s = cell_start[c]; s < cell_start[c + 1]; ++s) {
            int j = order[s];
            float dx = pts[3 * j] - x, dy = pts[3 * j + 1] - y,
                  dz = pts[3 * j + 2] - z;
            float d2 = dx * dx + dy * dy + dz * dz;
            if (d2 <= r2) f(j, d2);
          }
        }
  }
};

}  // namespace

extern "C" {

// GT overlap labels (reference lib/o3dutils.py:217-226 semantics):
// src_t is the GT-transformed source; a src point overlaps if any tgt point
// lies within thresh; a tgt point overlaps if any src_t point hit it.
void ogmm_radius_overlap(const float* src_t, int32_t n_src,
                         const float* tgt, int32_t n_tgt, float thresh,
                         float* src_label, float* tgt_label) {
  Grid g;
  g.build(tgt, n_tgt, std::max(thresh, 1e-6f));
  std::memset(tgt_label, 0, sizeof(float) * n_tgt);
  for (int i = 0; i < n_src; ++i) {
    bool hit = false;
    g.for_each_in_radius(tgt, src_t[3 * i], src_t[3 * i + 1], src_t[3 * i + 2],
                         thresh, [&](int j, float) {
                           hit = true;
                           tgt_label[j] = 1.0f;
                         });
    src_label[i] = hit ? 1.0f : 0.0f;
  }
}

// 1-NN: for each src point, index + distance of its nearest dst point
// (reference datasets/datautils.py:23-39). Grid search with expanding radius.
void ogmm_nearest_neighbor(const float* src, int32_t n_src,
                           const float* dst, int32_t n_dst,
                           float* out_dist, int32_t* out_idx) {
  // cell size ~ average spacing so typical queries touch few cells
  float mn[3], mx[3];
  for (int d = 0; d < 3; ++d) { mn[d] = dst[d]; mx[d] = dst[d]; }
  for (int i = 0; i < n_dst; ++i)
    for (int d = 0; d < 3; ++d) {
      mn[d] = std::min(mn[d], dst[3 * i + d]);
      mx[d] = std::max(mx[d], dst[3 * i + d]);
    }
  float vol = std::max((mx[0] - mn[0]) * (mx[1] - mn[1]) * (mx[2] - mn[2]),
                       1e-12f);
  float cell = std::cbrt(vol / std::max(n_dst, 1));
  cell = std::max(cell, 1e-6f);
  Grid g;
  g.build(dst, n_dst, cell);
  float diag = std::sqrt((mx[0] - mn[0]) * (mx[0] - mn[0]) +
                         (mx[1] - mn[1]) * (mx[1] - mn[1]) +
                         (mx[2] - mn[2]) * (mx[2] - mn[2]));
  for (int i = 0; i < n_src; ++i) {
    float x = src[3 * i], y = src[3 * i + 1], z = src[3 * i + 2];
    float best = std::numeric_limits<float>::max();
    int besti = -1;
    for (float r = cell; ; r *= 2.0f) {
      g.for_each_in_radius(dst, x, y, z, r, [&](int j, float d2) {
        if (d2 < best) { best = d2; besti = j; }
      });
      // found one and the ring is conclusive (nearest can't be outside r)
      if (besti >= 0 && best <= r * r) break;
      if (r > diag + cell) {  // fallback: brute force (degenerate spread)
        for (int j = 0; j < n_dst; ++j) {
          float dx = dst[3 * j] - x, dy = dst[3 * j + 1] - y,
                dz = dst[3 * j + 2] - z;
          float d2 = dx * dx + dy * dy + dz * dz;
          if (d2 < best) { best = d2; besti = j; }
        }
        break;
      }
    }
    out_dist[i] = std::sqrt(best);
    out_idx[i] = besti;
  }
}

// Sequential farthest-point sampling over one cloud, explicit start index
// (reference datasets/datautils.py:249-272; the Python loop is the input
// pipeline's latency pole for ModelNetDV's 768/1536-point resamples).
void ogmm_fps(const float* xyz, int32_t n, int32_t npoint, int32_t start,
              int32_t* out_idx) {
  std::vector<float> dist(n, std::numeric_limits<float>::max());
  int32_t farthest = start < 0 ? 0 : (start >= n ? n - 1 : start);
  for (int s = 0; s < npoint; ++s) {
    out_idx[s] = farthest;
    float fx = xyz[3 * farthest], fy = xyz[3 * farthest + 1],
          fz = xyz[3 * farthest + 2];
    float best = -1.0f;
    int32_t besti = 0;
    for (int i = 0; i < n; ++i) {
      float dx = xyz[3 * i] - fx, dy = xyz[3 * i + 1] - fy,
            dz = xyz[3 * i + 2] - fz;
      float d = dx * dx + dy * dy + dz * dz;
      if (d < dist[i]) dist[i] = d;
      if (dist[i] > best) { best = dist[i]; besti = i; }
    }
    farthest = besti;
  }
}

}  // extern "C"
