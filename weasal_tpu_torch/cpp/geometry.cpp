// Native host geometry kernels for the host-pyramid input path.
//
// The port's own copy of weasal_tpu/cpp/geometry.cpp, kept identical in
// code so that both packages subsample and search alike: a voxel grid
// subsample (barycenter points, mean features, majority labels, output in
// ascending linear voxel order) and a fixed-width radius search over a
// uniform bucket grid of cell size = radius (rows sorted by distance,
// ties by index, padded with the support count).
//
// Plain C ABI loaded with ctypes (weasal_tpu_torch/ops/native.py), which
// builds it with g++ at first use; no Python.h dependency.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Cell {
    double sum[3] = {0, 0, 0};
    std::vector<double> fsum;
    std::unordered_map<int32_t, int32_t> label_counts;
    int32_t count = 0;
};

inline int64_t cell_key(int64_t vx, int64_t vy, int64_t vz,
                        int64_t dy, int64_t dz) {
    return (vx * dy + vy) * dz + vz;
}

}  // namespace

extern "C" {

// Voxel-grid subsample: barycenter points, mean features, majority labels.
// Outputs in ascending linear-voxel-key order (min-corner anchored), the
// same canonical order as the numpy implementation.
// Returns the number of occupied voxels (<= max_out after truncation).
int wsl_grid_subsample(const float* points, int64_t n,
                       const float* features, int64_t fdim,
                       const int32_t* labels,
                       float dl,
                       float* out_points, float* out_features,
                       int32_t* out_labels, int64_t max_out) {
    if (n <= 0) return 0;

    float mins[3] = {points[0], points[1], points[2]};
    float maxs[3] = {points[0], points[1], points[2]};
    for (int64_t i = 1; i < n; ++i) {
        for (int d = 0; d < 3; ++d) {
            const float v = points[3 * i + d];
            mins[d] = std::min(mins[d], v);
            maxs[d] = std::max(maxs[d], v);
        }
    }
    int64_t dims[3];
    for (int d = 0; d < 3; ++d) {
        dims[d] = static_cast<int64_t>(
            std::floor((maxs[d] - mins[d]) / dl)) + 1;
    }

    std::unordered_map<int64_t, Cell> cells;
    cells.reserve(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        int64_t v[3];
        for (int d = 0; d < 3; ++d) {
            v[d] = static_cast<int64_t>(
                std::floor((points[3 * i + d] - mins[d]) / dl));
            if (v[d] >= dims[d]) v[d] = dims[d] - 1;
        }
        Cell& c = cells[cell_key(v[0], v[1], v[2], dims[1], dims[2])];
        if (features && c.fsum.empty()) c.fsum.assign(fdim, 0.0);
        for (int d = 0; d < 3; ++d) c.sum[d] += points[3 * i + d];
        if (features) {
            for (int64_t f = 0; f < fdim; ++f)
                c.fsum[f] += features[fdim * i + f];
        }
        if (labels) c.label_counts[labels[i]] += 1;
        c.count += 1;
    }

    std::vector<int64_t> keys;
    keys.reserve(cells.size());
    for (const auto& kv : cells) keys.push_back(kv.first);
    std::sort(keys.begin(), keys.end());

    int64_t n_out = std::min<int64_t>(
        static_cast<int64_t>(keys.size()),
        max_out > 0 ? max_out : static_cast<int64_t>(keys.size()));
    for (int64_t o = 0; o < n_out; ++o) {
        const Cell& c = cells[keys[o]];
        for (int d = 0; d < 3; ++d)
            out_points[3 * o + d] =
                static_cast<float>(c.sum[d] / c.count);
        if (features && out_features) {
            for (int64_t f = 0; f < fdim; ++f)
                out_features[fdim * o + f] =
                    static_cast<float>(c.fsum[f] / c.count);
        }
        if (labels && out_labels) {
            int32_t best_label = 0, best_count = -1;
            // Majority vote; ties resolve to the smallest label value
            std::vector<std::pair<int32_t, int32_t>> sorted(
                c.label_counts.begin(), c.label_counts.end());
            std::sort(sorted.begin(), sorted.end());
            for (const auto& lc : sorted) {
                if (lc.second > best_count) {
                    best_count = lc.second;
                    best_label = lc.first;
                }
            }
            out_labels[o] = best_label;
        }
    }
    return static_cast<int>(n_out);
}

// Radius neighbors via uniform bucket grid (cell size = radius).
// Rows are distance-sorted (ties by index), shadow index = ns, row width =
// max_count — the exact contract of the reference's batch search
// (sorted rows + supports.size() padding, neighbors.cpp:265,324).
void wsl_radius_search(const float* queries, int64_t nq,
                       const float* supports, int64_t ns,
                       float radius, int64_t max_count,
                       int32_t* out /* [nq, max_count] */) {
    for (int64_t i = 0; i < nq * max_count; ++i)
        out[i] = static_cast<int32_t>(ns);
    if (ns == 0 || nq == 0) return;

    float mins[3] = {supports[0], supports[1], supports[2]};
    float maxs[3] = {supports[0], supports[1], supports[2]};
    for (int64_t i = 1; i < ns; ++i) {
        for (int d = 0; d < 3; ++d) {
            const float v = supports[3 * i + d];
            mins[d] = std::min(mins[d], v);
            maxs[d] = std::max(maxs[d], v);
        }
    }
    const float cell = radius;
    int64_t dims[3];
    for (int d = 0; d < 3; ++d) {
        dims[d] = static_cast<int64_t>(
            std::floor((maxs[d] - mins[d]) / cell)) + 1;
    }

    // Bucket fill (counting sort layout: offsets + flat index array)
    const int64_t n_cells = dims[0] * dims[1] * dims[2];
    std::vector<int64_t> vox(ns);
    std::vector<int32_t> counts(n_cells + 1, 0);
    for (int64_t i = 0; i < ns; ++i) {
        int64_t v[3];
        for (int d = 0; d < 3; ++d) {
            v[d] = static_cast<int64_t>(
                std::floor((supports[3 * i + d] - mins[d]) / cell));
            if (v[d] >= dims[d]) v[d] = dims[d] - 1;
            if (v[d] < 0) v[d] = 0;
        }
        vox[i] = cell_key(v[0], v[1], v[2], dims[1], dims[2]);
        counts[vox[i] + 1] += 1;
    }
    std::vector<int64_t> offsets(n_cells + 1, 0);
    for (int64_t c = 0; c < n_cells; ++c)
        offsets[c + 1] = offsets[c] + counts[c + 1];
    std::vector<int32_t> bucket(ns);
    std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
    for (int64_t i = 0; i < ns; ++i)
        bucket[cursor[vox[i]]++] = static_cast<int32_t>(i);

    const float r2 = radius * radius;
    std::vector<std::pair<float, int32_t>> cand;
    for (int64_t q = 0; q < nq; ++q) {
        const float* qp = &queries[3 * q];
        int64_t v[3];
        bool in_grid = true;
        for (int d = 0; d < 3; ++d) {
            v[d] = static_cast<int64_t>(std::floor((qp[d] - mins[d]) / cell));
            if (v[d] < -1 || v[d] > dims[d]) in_grid = false;
        }
        if (!in_grid) continue;   // farther than one cell outside: no hits

        cand.clear();
        for (int64_t dx = -1; dx <= 1; ++dx) {
            const int64_t cx = v[0] + dx;
            if (cx < 0 || cx >= dims[0]) continue;
            for (int64_t dy = -1; dy <= 1; ++dy) {
                const int64_t cy = v[1] + dy;
                if (cy < 0 || cy >= dims[1]) continue;
                for (int64_t dz = -1; dz <= 1; ++dz) {
                    const int64_t cz = v[2] + dz;
                    if (cz < 0 || cz >= dims[2]) continue;
                    const int64_t key = cell_key(cx, cy, cz,
                                                 dims[1], dims[2]);
                    for (int64_t bi = offsets[key];
                         bi < offsets[key + 1]; ++bi) {
                        const int32_t s = bucket[bi];
                        const float* sp = &supports[3 * s];
                        const float ddx = sp[0] - qp[0];
                        const float ddy = sp[1] - qp[1];
                        const float ddz = sp[2] - qp[2];
                        const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
                        if (d2 <= r2) cand.emplace_back(d2, s);
                    }
                }
            }
        }
        const int64_t k = std::min<int64_t>(
            static_cast<int64_t>(cand.size()), max_count);
        std::partial_sort(cand.begin(), cand.begin() + k, cand.end());
        for (int64_t j = 0; j < k; ++j)
            out[q * max_count + j] = cand[j].second;
    }
}

}  // extern "C"
