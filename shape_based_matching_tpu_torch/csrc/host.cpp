// Host helpers of template training: the two order-dependent greedy
// passes of feature extraction, with a plain C interface for ctypes.
//
//   * sbm_greedy_accept: the row-major 5x5 magnitude-NMS acceptance scan
//     (line2Dup.cpp:466-511, reduced to its order-equivalent rule);
//   * sbm_select_scattered: selectScatteredFeatures (line2Dup.cpp:163-212).
//
// Built with the host C++ compiler at first use by ops/host.py; the
// Python loops there are the plain versions the tests hold these against.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// For each point (ys[i], xs[i]) in the given (row-major) order: accept it
// iff no previously accepted point lies within Chebyshev distance 2.
// Writes 0/1 flags to out.
void sbm_greedy_accept(int h, int w, int n, const int32_t* ys,
                       const int32_t* xs, uint8_t* out) {
    std::vector<uint8_t> occupied((size_t)h * w, 0);
    for (int i = 0; i < n; ++i) {
        int r = ys[i], c = xs[i];
        int r0 = r - 2 < 0 ? 0 : r - 2;
        int r1 = r + 3 > h ? h : r + 3;
        int c0 = c - 2 < 0 ? 0 : c - 2;
        int c1 = c + 3 > w ? w : c + 3;
        uint8_t hit = 0;
        for (int rr = r0; rr < r1 && !hit; ++rr) {
            const uint8_t* row = occupied.data() + (size_t)rr * w;
            for (int cc = c0; cc < c1; ++cc) {
                if (row[cc]) { hit = 1; break; }
            }
        }
        out[i] = !hit;
        if (!hit) occupied[(size_t)r * w + c] = 1;
    }
}

// Candidates come sorted by score. Keeps a candidate unless a kept one
// lies closer than `distance`; the first pass that keeps enough restarts
// at distance + 1, later passes shrink it by 1 until enough are kept or
// it falls below 3. Writes the kept indices to out_idx (room for n) and
// returns their count.
int sbm_select_scattered(int n, const int32_t* xs, const int32_t* ys,
                         int num_features, float distance,
                         int32_t* out_idx) {
    std::vector<int32_t> features;
    features.reserve((size_t)num_features * 2);
    float distance_sq = distance * distance;
    int i = 0;
    bool first_select = true;
    while (true) {
        int cx = xs[i], cy = ys[i];
        bool keep = true;
        for (size_t j = 0; j < features.size(); ++j) {
            int f = features[j];
            float dx = (float)(cx - xs[f]);
            float dy = (float)(cy - ys[f]);
            if (dx * dx + dy * dy < distance_sq) { keep = false; break; }
        }
        if (keep) features.push_back(i);
        if (++i == n) {
            bool num_ok = (int)features.size() >= num_features;
            if (first_select) {
                if (num_ok) {
                    features.clear();
                    i = 0;
                    distance += 1.0f;
                    distance_sq = distance * distance;
                    continue;
                }
                first_select = false;
            }
            i = 0;
            distance -= 1.0f;
            distance_sq = distance * distance;
            if (num_ok || distance < 3) break;
        }
    }
    int cnt = (int)features.size();
    std::memcpy(out_idx, features.data(), sizeof(int32_t) * cnt);
    return cnt;
}

}  // extern "C"
