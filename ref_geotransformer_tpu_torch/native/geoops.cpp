// Host-side geometry kernels of the PyTorch port, a C ABI for ctypes (no
// torch, no pybind11): the port's own copy of the JAX package's
// `native/geoops.cpp`, with the same arithmetic, so that both builds give the
// same bits. The per-pair pyramid runs on the card; these serve offline
// dataset preprocessing (voxel-downsampling raw scans,
// `tools/downsample_kitti.py`) and an independent oracle for the card's
// pyramid. Voxel hash for subsampling, uniform-grid bucketing for radius
// search.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct VoxelAccum {
  double x = 0.0, y = 0.0, z = 0.0;
  int64_t count = 0;
};

inline int64_t floor_div(float v, float size) {
  return static_cast<int64_t>(std::floor(v / size));
}

}  // namespace

extern "C" {

// Voxel-grid subsample: centroid per occupied voxel, origin at
// floor(min/voxel)*voxel. Returns the number of voxels written (<= capacity;
// the true voxel count is stored in *total_voxels so callers can detect
// overflow when calibrating capacities).
int64_t gt_grid_subsample(const float* points, int64_t n, float voxel_size,
                          float* out_points, int64_t capacity,
                          int64_t* total_voxels) {
  if (n <= 0) {
    if (total_voxels) *total_voxels = 0;
    return 0;
  }
  float minv[3] = {points[0], points[1], points[2]};
  for (int64_t i = 1; i < n; ++i) {
    for (int d = 0; d < 3; ++d) minv[d] = std::min(minv[d], points[i * 3 + d]);
  }
  float origin[3];
  for (int d = 0; d < 3; ++d) {
    origin[d] = std::floor(minv[d] / voxel_size) * voxel_size;
  }

  std::unordered_map<uint64_t, VoxelAccum> voxels;
  voxels.reserve(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t ix = static_cast<uint64_t>(floor_div(points[i * 3 + 0] - origin[0], voxel_size));
    const uint64_t iy = static_cast<uint64_t>(floor_div(points[i * 3 + 1] - origin[1], voxel_size));
    const uint64_t iz = static_cast<uint64_t>(floor_div(points[i * 3 + 2] - origin[2], voxel_size));
    const uint64_t key = (ix & 0x1FFFFF) | ((iy & 0x1FFFFF) << 21) | ((iz & 0x1FFFFF) << 42);
    VoxelAccum& acc = voxels[key];
    acc.x += points[i * 3 + 0];
    acc.y += points[i * 3 + 1];
    acc.z += points[i * 3 + 2];
    acc.count += 1;
  }

  // deterministic output order: sort by voxel key
  std::vector<std::pair<uint64_t, const VoxelAccum*>> items;
  items.reserve(voxels.size());
  for (const auto& kv : voxels) items.emplace_back(kv.first, &kv.second);
  std::sort(items.begin(), items.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });

  const int64_t written = std::min<int64_t>(items.size(), capacity);
  for (int64_t i = 0; i < written; ++i) {
    const VoxelAccum& acc = *items[i].second;
    out_points[i * 3 + 0] = static_cast<float>(acc.x / acc.count);
    out_points[i * 3 + 1] = static_cast<float>(acc.y / acc.count);
    out_points[i * 3 + 2] = static_cast<float>(acc.z / acc.count);
  }
  if (total_voxels) *total_voxels = static_cast<int64_t>(items.size());
  return written;
}

// Radius neighbors via uniform-grid bucketing: for each query, the `limit`
// nearest supports within `radius`, distance-sorted, sentinel == ns for
// empty slots.
void gt_radius_neighbors(const float* q_points, int64_t nq,
                         const float* s_points, int64_t ns, float radius,
                         int64_t limit, int32_t* out_indices) {
  const float r2 = radius * radius;
  const float cell = radius;

  float minv[3] = {1e30f, 1e30f, 1e30f};
  for (int64_t i = 0; i < ns; ++i) {
    for (int d = 0; d < 3; ++d) minv[d] = std::min(minv[d], s_points[i * 3 + d]);
  }

  auto cell_of = [&](const float* p, int64_t* c) {
    for (int d = 0; d < 3; ++d) c[d] = floor_div(p[d] - minv[d], cell);
  };
  auto cell_key = [](const int64_t* c) -> uint64_t {
    return (static_cast<uint64_t>(c[0]) & 0x1FFFFF) |
           ((static_cast<uint64_t>(c[1]) & 0x1FFFFF) << 21) |
           ((static_cast<uint64_t>(c[2]) & 0x1FFFFF) << 42);
  };

  std::unordered_map<uint64_t, std::vector<int32_t>> buckets;
  buckets.reserve(static_cast<size_t>(ns));
  for (int64_t i = 0; i < ns; ++i) {
    int64_t c[3];
    cell_of(s_points + i * 3, c);
    buckets[cell_key(c)].push_back(static_cast<int32_t>(i));
  }

  std::vector<std::pair<float, int32_t>> found;
  for (int64_t qi = 0; qi < nq; ++qi) {
    found.clear();
    const float* q = q_points + qi * 3;
    int64_t c[3];
    cell_of(q, c);
    for (int64_t dx = -1; dx <= 1; ++dx) {
      for (int64_t dy = -1; dy <= 1; ++dy) {
        for (int64_t dz = -1; dz <= 1; ++dz) {
          const int64_t nc[3] = {c[0] + dx, c[1] + dy, c[2] + dz};
          if (nc[0] < 0 || nc[1] < 0 || nc[2] < 0) continue;
          auto it = buckets.find(cell_key(nc));
          if (it == buckets.end()) continue;
          for (int32_t si : it->second) {
            const float* s = s_points + si * 3;
            const float d0 = q[0] - s[0], d1 = q[1] - s[1], d2 = q[2] - s[2];
            const float d = d0 * d0 + d1 * d1 + d2 * d2;
            if (d < r2) found.emplace_back(d, si);
          }
        }
      }
    }
    const int64_t k = std::min<int64_t>(found.size(), limit);
    std::partial_sort(found.begin(), found.begin() + k, found.end());
    for (int64_t j = 0; j < limit; ++j) {
      out_indices[qi * limit + j] =
          (j < k) ? found[j].second : static_cast<int32_t>(ns);
    }
  }
}

}  // extern "C"
