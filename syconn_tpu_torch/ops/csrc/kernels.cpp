// Host kernels of the port (C++ with OpenMP, plain C interface for ctypes).
//
// Exact per-voxel scans, counterparts of the same functions in the JAX
// package's syconn_tpu/csrc/kernels.cpp. They are not device kernels: the
// port uses them for the boundary gate, for the columns whose label
// diversity overflows the CUDA kernel's candidate table, for chunks whose
// ids need more than 31 bits, and for the label remaps of object extraction.

#include <cstddef>
#include <cstdint>
#include <unordered_map>

#if defined(_OPENMP)
#include <omp.h>
#endif

// In-place label remap through a hash map; labels missing from the map are
// kept, or set to 0 with nonexist2zero.
template <typename T>
static void relabel(T* vol, int64_t n, const T* keys, const T* vals, int64_t n_map,
                    int nonexist2zero) {
  std::unordered_map<T, T> m;
  m.reserve(static_cast<std::size_t>(n_map) * 2);
  for (int64_t i = 0; i < n_map; ++i) m[keys[i]] = vals[i];
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    auto it = m.find(vol[i]);
    if (it != m.end()) {
      vol[i] = it->second;
    } else if (nonexist2zero) {
      vol[i] = 0;
    }
  }
}

extern "C" {

// 6-neighborhood boundary mask; background (0) voxels are never flagged.
void detect_seg_boundaries_u32(const uint32_t* seg, int64_t nx, int64_t ny,
                               int64_t nz, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t x = 0; x < nx; ++x) {
    for (int64_t y = 0; y < ny; ++y) {
      for (int64_t z = 0; z < nz; ++z) {
        const int64_t idx = (x * ny + y) * nz + z;
        const uint32_t c = seg[idx];
        if (c == 0) {
          out[idx] = 0;
          continue;
        }
        uint8_t b = 0;
        if (x > 0 && seg[idx - ny * nz] != c) b = 1;
        if (!b && x + 1 < nx && seg[idx + ny * nz] != c) b = 1;
        if (!b && y > 0 && seg[idx - nz] != c) b = 1;
        if (!b && y + 1 < ny && seg[idx + nz] != c) b = 1;
        if (!b && z > 0 && seg[idx - 1] != c) b = 1;
        if (!b && z + 1 < nz && seg[idx + 1] != c) b = 1;
        out[idx] = b;
      }
    }
  }
}

// Contact-partner detection with window-majority vote.
// Output has valid-convolution shape (n - stencil + 1 per axis). For every
// voxel whose boundary flag is set, the most frequent ID in the
// (sx, sy, sz) window that is neither 0 nor the center ID is selected
// (ties -> smallest ID) and the sorted pair is packed as
// (min(center, partner) << 32) | max(center, partner).
void detect_cs_u32(const uint32_t* seg, const uint8_t* bdry, int64_t nx,
                   int64_t ny, int64_t nz, int sx, int sy, int sz,
                   uint64_t* out) {
  const int ox = sx / 2, oy = sy / 2, oz = sz / 2;
  const int64_t onx = nx - 2 * ox, ony = ny - 2 * oy, onz = nz - 2 * oz;

#pragma omp parallel
  {
    std::unordered_map<uint32_t, int> counts;
    counts.reserve(64);
#pragma omp for schedule(dynamic, 4)
    for (int64_t x = 0; x < onx; ++x) {
      for (int64_t y = 0; y < ony; ++y) {
        for (int64_t z = 0; z < onz; ++z) {
          const int64_t cidx = ((x + ox) * ny + (y + oy)) * nz + (z + oz);
          const int64_t oidx = (x * ony + y) * onz + z;
          if (bdry[cidx] == 0) {
            out[oidx] = 0;
            continue;
          }
          const uint32_t center = seg[cidx];
          counts.clear();
          for (int dx = 0; dx < sx; ++dx) {
            for (int dy = 0; dy < sy; ++dy) {
              const uint32_t* row = seg + ((x + dx) * ny + (y + dy)) * nz + z;
              for (int dz = 0; dz < sz; ++dz) {
                const uint32_t v = row[dz];
                if (v != 0 && v != center) ++counts[v];
              }
            }
          }
          uint32_t best = 0;
          int best_cnt = 0;
          for (const auto& kv : counts) {
            if (kv.second > best_cnt ||
                (kv.second == best_cnt && best_cnt > 0 && kv.first < best)) {
              best = kv.first;
              best_cnt = kv.second;
            }
          }
          if (best_cnt > 0) {
            const uint64_t lo = center < best ? center : best;
            const uint64_t hi = center < best ? best : center;
            out[oidx] = (lo << 32) | hi;
          } else {
            out[oidx] = 0;
          }
        }
      }
    }
  }
}

void relabel_u64(uint64_t* vol, int64_t n, const uint64_t* keys, const uint64_t* vals,
                 int64_t n_map, int nonexist2zero) {
  relabel(vol, n, keys, vals, n_map, nonexist2zero);
}

void relabel_u32(uint32_t* vol, int64_t n, const uint32_t* keys, const uint32_t* vals,
                 int64_t n_map, int nonexist2zero) {
  relabel(vol, n, keys, vals, n_map, nonexist2zero);
}

}  // extern "C"
