// Native helpers for host-side sequential hot loops.
//
// largest_rectangle: maximal all-valid axis-aligned rectangle in a binary
// mask via the classic histogram-of-heights + monotonic stack algorithm,
// O(H*W). Replacement for the reference's Numba-compiled crop_mosaic
// (stitcher.py:340-369) — same algorithm family, C++ instead of
// LLVM-JIT, no runtime dependency. A copy of pano360_tpu/native/crop.cpp.
//
// Build: pano360_tpu_torch/native/__init__.py runs g++ at first use into
// build/native/ at the repository root.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <queue>
#include <tuple>
#include <vector>

extern "C" {

// valid: row-major H*W uint8 (nonzero = valid). out4: {top, left, bottom,
// right} inclusive bounds of the best rectangle (all zero if none).
void largest_rectangle(const uint8_t* valid, int height, int width,
                       int* out4) {
    std::vector<int> heights(width, 0);
    std::vector<int> stack(width + 1);

    long best_area = 0;
    int best_top = 0, best_left = 0, best_bottom = -1, best_right = -1;

    for (int i = 0; i < height; ++i) {
        const uint8_t* row = valid + (long)i * width;
        for (int j = 0; j < width; ++j)
            heights[j] = row[j] ? heights[j] + 1 : 0;

        // monotonic stack over the histogram (sentinel column at the end)
        int top = 0;  // stack size
        for (int j = 0; j <= width; ++j) {
            int h = (j < width) ? heights[j] : 0;
            int left = j;
            while (top > 0 && heights[stack[top - 1]] >= h) {
                int k = stack[--top];
                int hk = heights[k];
                int lk = (top > 0) ? stack[top - 1] + 1 : 0;
                long area = (long)hk * (j - lk);
                if (area > best_area) {
                    best_area = area;
                    best_top = i - hk + 1;
                    best_bottom = i;
                    best_left = lk;
                    best_right = j - 1;
                }
            }
            (void)left;
            stack[top++] = j;
        }
    }
    out4[0] = best_top;
    out4[1] = best_left;
    out4[2] = best_bottom;
    out4[3] = best_right;
}

// Graph-cut style two-source flood seam (blend.py:56-100 equivalent):
// priority-flood from left(-1)/right(+1) seeds over a cost map; result
// mask tells which side each pixel belongs to. Implemented with a binary
// heap over (cost, order) for determinism.
void seam_flood(const float* diff, int rows, int cols, int border,
                int8_t* mask) {
    // mask: 0 unknown, -1 left, +1 right (pre-seeded columns by caller or
    // here)
    using Node = std::tuple<float, long, int, int, int>;  // -cost,seq,clr,x,y
    std::priority_queue<Node, std::vector<Node>> heap;
    long seq = 0;

    for (int y = 0; y < rows; ++y) {
        for (int x = 0; x < border && x < cols; ++x) mask[(long)y*cols+x] = -1;
        for (int x = cols - border + 1; x < cols; ++x)
            if (x >= 0) mask[(long)y*cols+x] = 1;
    }
    const float kSeed = 1e3f;
    for (int y = 0; y < rows; ++y) {
        if (border < cols)
            heap.emplace(kSeed, -(seq++), -1, border, y);
        if (cols - border >= 0)
            heap.emplace(kSeed, -(seq++), 1, cols - border, y);
    }

    const int dd[4][2] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0}};
    while (!heap.empty()) {
        auto [negc, s, clr, x, y] = heap.top();
        heap.pop();
        long idx = (long)y * cols + x;
        if (mask[idx] != 0) continue;
        mask[idx] = (int8_t)clr;
        for (auto& d : dd) {
            int nx = x + d[0], ny = y + d[1];
            if (nx < 0 || nx >= cols || ny < 0 || ny >= rows) continue;
            long nidx = (long)ny * cols + nx;
            // max-heap: pop the LARGEST color difference first, matching
            // the reference's heapq min-heap over -diff (blend.py:86-97)
            // and the Python fallback _seam_flood_py
            if (mask[nidx] == 0)
                heap.emplace(diff[nidx], -(seq++), clr, nx, ny);
        }
    }
}

// SSC adaptive non-maximal suppression (Bailo et al. 2018; the
// features.py:28-99 algorithm). Binary search over the suppression
// radius; each trial greedily keeps score-ordered keypoints whose grid
// cell is uncovered. The greedy pass is a host-sequential loop over up
// to ~100k candidates per pyramid level — the one MSOP stage that
// cannot batch onto the device. kpts_xy: (n, 2) float (x, y), score-
// ordered best first. Writes selected indices to out_idx, returns count.
int ssc_select(const float* kpts_xy, int n_kpts, int cols, int rows,
               int n_points, float tol, int* out_idx) {
    if (n_kpts <= n_points) {
        for (int i = 0; i < n_kpts; ++i) out_idx[i] = i;
        return n_kpts;
    }
    double exp1 = rows + cols + 2.0 * n_points;
    double exp2 = 4.0 * cols + 4.0 * n_points + 4.0 * (double)rows * n_points
                  + (double)rows * rows + (double)cols * cols
                  - 2.0 * (double)rows * cols
                  + 4.0 * (double)rows * cols * n_points;
    double exp3 = std::sqrt(std::max(exp2, 0.0));
    double exp4 = std::max(n_points - 1, 1);
    double high = std::max(-std::round((exp1 + exp3) / exp4),
                           -std::round((exp1 - exp3) / exp4));
    double low = std::floor(std::sqrt((double)n_kpts / n_points));

    long k_min = std::lround(n_points - n_points * (double)tol);
    long k_max = std::lround(n_points + n_points * (double)tol);

    double prev_width = -1.0;
    int count = std::min(n_kpts, n_points);
    for (int i = 0; i < count; ++i) out_idx[i] = i;

    std::vector<char> covered;
    std::vector<int> sel;
    while (true) {
        double width = low + (high - low) / 2.0;
        if (width == prev_width || low > high) break;
        double cgr = width / 2.0;
        int n_cc = (int)(cols / cgr);
        int n_cr = (int)(rows / cgr);
        covered.assign((size_t)(n_cr + 1) * (n_cc + 1), 0);
        sel.clear();
        int span = (int)(width / cgr);
        for (int i = 0; i < n_kpts; ++i) {
            int row = (int)(kpts_xy[2 * i + 1] / cgr);
            int col = (int)(kpts_xy[2 * i] / cgr);
            if (!covered[(size_t)row * (n_cc + 1) + col]) {
                sel.push_back(i);
                int r0 = std::max(row - span, 0);
                int r1 = std::min(row + span, n_cr);
                int c0 = std::max(col - span, 0);
                int c1 = std::min(col + span, n_cc);
                for (int r = r0; r <= r1; ++r)
                    for (int c = c0; c <= c1; ++c)
                        covered[(size_t)r * (n_cc + 1) + c] = 1;
            }
        }
        count = (int)sel.size();
        for (int i = 0; i < count; ++i) out_idx[i] = sel[i];
        if ((long)sel.size() >= k_min && (long)sel.size() <= k_max) break;
        if ((long)sel.size() < k_min) high = width - 1.0;
        else low = width + 1.0;
        prev_width = width;
    }
    return count;
}

}  // extern "C"
