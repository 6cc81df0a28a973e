// Connected-component decomposition of the dataset/live-point bipartite
// graph. Native replacement for the reference's igraph dependency
// (multi_nested_sampler.py:175-355: clusters() over "n%d"/"p%d" vertices) —
// identified there as the #2 wall-clock cost (TODO.rst:31-36).
//
// Union-find with path halving + union by size over a column-major
// live-point index matrix live_idx[K, D] (entry = pile index of live point
// k of dataset d). Two datasets join when they share any pile index.
//
// C ABI, called from Python via ctypes (massivedatans_tpu_torch/ns/subsets.py),
// built with the host C++ compiler on first use (ops/_build.py). A copy of
// massivedatans_tpu/native/unionfind.cpp.

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// live_idx: [K * D] column-major (Fortran order: entry (k, d) at k + K*d)
// selected: [D] 0/1 mask of datasets to decompose
// point_ids: [K * D] scratch mapping (input: sorted unique pile indices,
//            see Python wrapper) — here we instead receive pre-localized
//            indices in [0, n_points) to keep the kernel allocation-free.
// out_labels: [D] component id per selected dataset (-1 if not selected)
// returns number of components
int32_t decompose_components(
    const int32_t* live_idx_local,  // [K * D] values in [0, n_points)
    const uint8_t* selected,        // [D]
    int32_t K, int32_t D, int32_t n_points,
    int32_t* out_labels             // [D]
) {
    // parents: datasets occupy [0, D), points occupy [D, D + n_points)
    std::vector<int32_t> parent(static_cast<size_t>(D) + n_points);
    std::vector<int32_t> size(parent.size(), 1);
    for (size_t i = 0; i < parent.size(); i++) parent[i] = static_cast<int32_t>(i);

    auto find = [&](int32_t a) {
        while (parent[a] != a) {
            parent[a] = parent[parent[a]];  // path halving
            a = parent[a];
        }
        return a;
    };
    auto unite = [&](int32_t a, int32_t b) {
        a = find(a); b = find(b);
        if (a == b) return;
        if (size[a] < size[b]) { int32_t t = a; a = b; b = t; }
        parent[b] = a;
        size[a] += size[b];
    };

    for (int32_t d = 0; d < D; d++) {
        if (!selected[d]) continue;
        const int32_t* col = live_idx_local + static_cast<size_t>(d) * K;
        for (int32_t k = 0; k < K; k++) {
            int32_t p = col[k];
            if (p >= 0 && p < n_points) unite(d, D + p);
        }
    }

    // relabel roots to dense component ids over selected datasets
    std::vector<int32_t> remap(parent.size(), -1);
    int32_t n_components = 0;
    for (int32_t d = 0; d < D; d++) {
        if (!selected[d]) { out_labels[d] = -1; continue; }
        int32_t r = find(d);
        if (remap[r] < 0) remap[r] = n_components++;
        out_labels[d] = remap[r];
    }
    return n_components;
}

}  // extern "C"
