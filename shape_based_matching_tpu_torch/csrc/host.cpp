// Host helpers: the order-dependent greedy passes of feature extraction
// and of detection NMS, with a plain C interface for ctypes.
//
//   * sbm_greedy_accept: the row-major 5x5 magnitude-NMS acceptance scan
//     (line2Dup.cpp:466-511, reduced to its order-equivalent rule);
//   * sbm_select_scattered: selectScatteredFeatures (line2Dup.cpp:163-212);
//   * sbm_nms_boxes: greedy IoU NMS over match boxes (nms.hpp:21-96).
//
// Built with the host C++ compiler at first use by models/native.py; the
// Python loops in models/training.py and utils/nms.py are the plain
// versions the tests hold these against.

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

// Greedy IoU NMS (cv_dnn::NMSBoxes semantics). boxes: [n][4] (x, y, w, h)
// float; order: the candidate indices sorted by score, descending and
// stable. Keeps a candidate unless its overlap with a kept one exceeds
// the threshold, which eta < 1 shrinks after each keep while it is above
// 0.5. Writes the kept indices to out_idx (room for n_order) and returns
// their count.
int sbm_nms_boxes(int n, const float* boxes, const int32_t* order,
                  int n_order, float nms_threshold, float eta,
                  int32_t* out_idx) {
    (void)n;
    std::vector<int32_t> keep;
    float adaptive = nms_threshold;
    for (int oi = 0; oi < n_order; ++oi) {
        int i = order[oi];
        const float* a = boxes + (size_t)i * 4;
        bool ok = true;
        for (size_t kj = 0; kj < keep.size(); ++kj) {
            const float* b = boxes + (size_t)keep[kj] * 4;
            float area_a = a[2] * a[3];
            float area_b = b[2] * b[3];
            float overlap;
            if (area_a + area_b <= 1.192092896e-07f) {
                overlap = 1.0f;
            } else {
                float ix0 = a[0] > b[0] ? a[0] : b[0];
                float iy0 = a[1] > b[1] ? a[1] : b[1];
                float ix1 = (a[0] + a[2]) < (b[0] + b[2]) ? a[0] + a[2]
                                                          : b[0] + b[2];
                float iy1 = (a[1] + a[3]) < (b[1] + b[3]) ? a[1] + a[3]
                                                          : b[1] + b[3];
                float iw = ix1 - ix0 > 0 ? ix1 - ix0 : 0;
                float ih = iy1 - iy0 > 0 ? iy1 - iy0 : 0;
                float inter = iw * ih;
                overlap = inter / (area_a + area_b - inter);
            }
            if (overlap > adaptive) { ok = false; break; }
        }
        if (ok) {
            keep.push_back(i);
            if (eta < 1 && adaptive > 0.5f) adaptive *= eta;
        }
    }
    std::memcpy(out_idx, keep.data(), sizeof(int32_t) * keep.size());
    return (int)keep.size();
}

}  // extern "C"
