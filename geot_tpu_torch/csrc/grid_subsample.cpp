// Voxel-grid subsampling, host-side.
//
// Native equivalent of the reference's ``grid_subsampling`` C++ extension
// (``openpoints/cpp/subsampling/grid_subsampling/grid_subsampling.cpp``):
// per-voxel barycenters, feature means and majority labels.  Re-designed
// around a flat open-addressing hash table keyed by the packed voxel coord
// (the reference uses std::unordered_map per SampledData).
//
// C ABI for ctypes:
//   long grid_subsample(const float* points, long n, long fdim,
//                       const float* features, const int* labels,
//                       int num_classes, float dl,
//                       float* out_points, float* out_features, int* out_labels,
//                       long capacity);
// Returns the number of voxels written (or -needed if capacity too small).
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Slot {
  uint64_t key = UINT64_MAX;
  int64_t index = -1;  // voxel output index
};

inline uint64_t hash_key(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  return k;
}

}  // namespace

extern "C" {

long grid_subsample(const float* points, long n, long fdim,
                    const float* features, const int* labels, int num_classes,
                    float dl, float* out_points, float* out_features,
                    int* out_labels, long capacity) {
  if (n <= 0 || dl <= 0) return 0;
  float minv[3] = {points[0], points[1], points[2]};
  for (long i = 1; i < n; ++i)
    for (int d = 0; d < 3; ++d)
      if (points[i * 3 + d] < minv[d]) minv[d] = points[i * 3 + d];

  size_t table_size = 1;
  while (table_size < static_cast<size_t>(n) * 2) table_size <<= 1;
  std::vector<Slot> table(table_size);

  std::vector<double> acc_pts;                    // capacity*3 barycenters
  std::vector<double> acc_feats;                  // capacity*fdim
  std::vector<int32_t> acc_counts;
  std::vector<int32_t> label_hist;                // capacity*num_classes

  acc_pts.reserve(1024 * 3);
  long voxels = 0;

  for (long i = 0; i < n; ++i) {
    uint64_t vx = static_cast<uint64_t>(
        std::floor((points[i * 3 + 0] - minv[0]) / dl));
    uint64_t vy = static_cast<uint64_t>(
        std::floor((points[i * 3 + 1] - minv[1]) / dl));
    uint64_t vz = static_cast<uint64_t>(
        std::floor((points[i * 3 + 2] - minv[2]) / dl));
    uint64_t key = (vx << 42) | (vy << 21) | vz;

    size_t slot = hash_key(key) & (table_size - 1);
    while (table[slot].key != UINT64_MAX && table[slot].key != key)
      slot = (slot + 1) & (table_size - 1);

    long idx;
    if (table[slot].key == UINT64_MAX) {
      idx = voxels++;
      table[slot].key = key;
      table[slot].index = idx;
      acc_pts.resize(voxels * 3, 0.0);
      acc_counts.resize(voxels, 0);
      if (features) acc_feats.resize(voxels * fdim, 0.0);
      if (labels) label_hist.resize(voxels * num_classes, 0);
    } else {
      idx = table[slot].index;
    }
    for (int d = 0; d < 3; ++d) acc_pts[idx * 3 + d] += points[i * 3 + d];
    acc_counts[idx] += 1;
    if (features)
      for (long d = 0; d < fdim; ++d)
        acc_feats[idx * fdim + d] += features[i * fdim + d];
    if (labels && labels[i] >= 0 && labels[i] < num_classes)
      label_hist[idx * num_classes + labels[i]] += 1;
  }

  if (voxels > capacity) return -voxels;

  for (long v = 0; v < voxels; ++v) {
    const double inv = 1.0 / acc_counts[v];
    for (int d = 0; d < 3; ++d)
      out_points[v * 3 + d] = static_cast<float>(acc_pts[v * 3 + d] * inv);
    if (features && out_features)
      for (long d = 0; d < fdim; ++d)
        out_features[v * fdim + d] =
            static_cast<float>(acc_feats[v * fdim + d] * inv);
    if (labels && out_labels) {
      int best = 0, best_count = -1;
      for (int c = 0; c < num_classes; ++c)
        if (label_hist[v * num_classes + c] > best_count) {
          best_count = label_hist[v * num_classes + c];
          best = c;
        }
      out_labels[v] = best;
    }
  }
  return voxels;
}

}  // extern "C"
