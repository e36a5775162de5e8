// Host ops of the data and eval paths, with a plain C interface for ctypes
// (no CPython API): built by the host compiler at first use
// (ops/_build.py::build_host) and bound in data/native_ops.py.
//
//   snipper_warp_affine: one pass of horizontal flip, inverse-mapped
//     bilinear affine warp with a zero border (cv2.warpAffine INTER_LINEAR),
//     division by 255, a scale per channel and a clip to [0, 1], from a
//     uint8 [h, w, 3] frame into a float32 [out_h, out_w, 3] buffer the
//     caller owns.
//   snipper_warp_patch_exact: serving's warp of a snippet's n frames by one
//     affine, bit-equal to numpy's transforms.generate_patch_image (no
//     flip): the same inverse-mapped bilinear zero-border warp and /255,
//     numpy's arithmetic step for step, from the inverse affine the caller
//     computed; uint8 [n, h, w, 3] in, float32 [n, out_h, out_w, 3] out.
//   snipper_lsa: minimum-cost assignment of each row of an [m, n] double
//     cost (m <= n) to a distinct column, by Jonker-Volgenant shortest
//     augmenting paths.
//
// Each returns 0, or a negative code the Python side turns into an error.
// None touches Python state, so ctypes runs them without the GIL.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <limits>
#include <utility>
#include <vector>

// numpy rounds every product before it adds it; a compiler that fuses
// `a + b * c` into one FMA (GCC does under -march=native) rounds once, and
// bit-equality is gone. `rounded` hides a product from the optimizer behind
// an empty asm that emits no instruction, so it cannot be fused.
template <typename T>
static inline T rounded(T v) {
#if defined(__x86_64__) || defined(__i386__)
    asm("" : "+x"(v));
#elif defined(__aarch64__)
    asm("" : "+w"(v));
#else
    volatile T kept = v;
    v = kept;
#endif
    return v;
}

extern "C" {

enum { SNIPPER_OK = 0, SNIPPER_SINGULAR = -1, SNIPPER_BAD_SHAPE = -2 };

int snipper_warp_affine(const uint8_t* src, int h, int w, const double* M,
                        int out_h, int out_w, int flip, float cs_r,
                        float cs_g, float cs_b, float* out) {
    if (h <= 0 || w <= 0 || out_h < 0 || out_w < 0) return SNIPPER_BAD_SHAPE;
    // M maps source to output: out = M @ [x, y, 1]. Each output pixel reads
    // the source at Minv @ [x, y, 1].
    const double a = M[0], b = M[1], tx = M[2];
    const double d = M[3], e = M[4], ty = M[5];
    const double det = a * e - b * d;
    if (std::fabs(det) < 1e-12) return SNIPPER_SINGULAR;
    const double ia = e / det, ib = -b / det;
    const double id = -d / det, ie = a / det;
    const double itx = -(ia * tx + ib * ty);
    const double ity = -(id * tx + ie * ty);
    const float scale[3] = {cs_r, cs_g, cs_b};
    const double inv255 = 1.0 / 255.0;

    for (int y = 0; y < out_h; ++y) {
        float* row = out + (size_t)y * out_w * 3;
        for (int x = 0; x < out_w; ++x) {
            const double sx = ia * x + ib * y + itx;
            const double sy = id * x + ie * y + ity;
            const double fx = std::floor(sx), fy = std::floor(sy);
            const int x0 = (int)fx, y0 = (int)fy;
            const float wx[2] = {1.0f - (float)(sx - fx), (float)(sx - fx)};
            const float wy[2] = {1.0f - (float)(sy - fy), (float)(sy - fy)};
            float acc[3] = {0.f, 0.f, 0.f};
            // the four corners; a corner outside the frame adds nothing
            for (int dy = 0; dy < 2; ++dy) {
                const int yy = y0 + dy;
                if (yy < 0 || yy >= h) continue;
                for (int dx = 0; dx < 2; ++dx) {
                    const int xx = x0 + dx;
                    if (xx < 0 || xx >= w) continue;
                    // the flip mirrors the source before the warp
                    const int col = flip ? w - 1 - xx : xx;
                    const uint8_t* px = src + ((size_t)yy * w + col) * 3;
                    const float wgt = wy[dy] * wx[dx];
                    acc[0] += wgt * px[0];
                    acc[1] += wgt * px[1];
                    acc[2] += wgt * px[2];
                }
            }
            float* o = row + (size_t)x * 3;
            for (int c = 0; c < 3; ++c) {
                const float v = (float)(acc[c] * inv255) * scale[c];
                o[c] = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
            }
        }
    }
    return SNIPPER_OK;
}

int snipper_warp_patch_exact(const uint8_t* src, int n, int h, int w,
                             const double* Minv, int out_h, int out_w,
                             float* out) {
    if (n < 0 || h <= 0 || w <= 0 || out_h < 0 || out_w < 0)
        return SNIPPER_BAD_SHAPE;
    // transforms.warp_affine: the source point in float64, the weights in
    // float32, the corners added dy outer, dx inner, as float32 w * px
    for (int y = 0; y < out_h; ++y) {
        const double by = rounded(Minv[1] * y), ey = rounded(Minv[4] * y);
        for (int x = 0; x < out_w; ++x) {
            const double sx = rounded(Minv[0] * x) + by + Minv[2];
            const double sy = rounded(Minv[3] * x) + ey + Minv[5];
            const double fx = std::floor(sx), fy = std::floor(sy);
            const int64_t x0 = (int64_t)fx, y0 = (int64_t)fy;
            const float ax = (float)(sx - fx), ay = (float)(sy - fy);
            const float wx[2] = {1.0f - ax, ax};
            const float wy[2] = {1.0f - ay, ay};
            // the same point in every frame of the snippet
            for (int f = 0; f < n; ++f) {
                const uint8_t* frame = src + (size_t)f * h * w * 3;
                float acc[3] = {0.f, 0.f, 0.f};
                // a corner outside the frame adds numpy's +0
                for (int dy = 0; dy < 2; ++dy) {
                    const int64_t yy = y0 + dy;
                    if (yy < 0 || yy >= h) continue;
                    for (int dx = 0; dx < 2; ++dx) {
                        const int64_t xx = x0 + dx;
                        if (xx < 0 || xx >= w) continue;
                        const uint8_t* px = frame + ((size_t)yy * w + xx) * 3;
                        const float wgt = wx[dx] * wy[dy];
                        for (int c = 0; c < 3; ++c)
                            acc[c] += rounded(wgt * (float)px[c]);
                    }
                }
                float* o = out + (((size_t)f * out_h + y) * out_w + x) * 3;
                for (int c = 0; c < 3; ++c) o[c] = acc[c] / 255.0f;
            }
        }
    }
    return SNIPPER_OK;
}

int snipper_lsa(const double* cost, int m, int n, int64_t* col4row) {
    if (m < 0 || n < 0 || m > n) return SNIPPER_BAD_SHAPE;
    const double inf = std::numeric_limits<double>::infinity();
    // dual potentials of rows (u) and columns (v); row4col[j] is the row
    // that holds column j, path[j] the row the shortest path reached j from
    std::vector<double> u(m, 0.0), v(n, 0.0), dist(n);
    std::vector<int> row4col(n, -1), path(n, -1), rows(m, -1);
    std::vector<char> row_done(m), col_done(n);

    for (int start = 0; start < m; ++start) {
        // Dijkstra on reduced costs from the free row `start` until it
        // reaches a free column
        std::fill(dist.begin(), dist.end(), inf);
        std::fill(row_done.begin(), row_done.end(), 0);
        std::fill(col_done.begin(), col_done.end(), 0);
        int i = start, sink = -1;
        double shortest = 0.0;
        while (sink < 0) {
            row_done[i] = 1;
            const double* ci = cost + (size_t)i * n;
            for (int j = 0; j < n; ++j) {
                if (col_done[j]) continue;
                const double r = shortest + ci[j] - u[i] - v[j];
                if (r < dist[j]) {
                    dist[j] = r;
                    path[j] = i;
                }
            }
            int jmin = -1;
            double best = inf;
            for (int j = 0; j < n; ++j) {
                if (!col_done[j] && dist[j] < best) {
                    best = dist[j];
                    jmin = j;
                }
            }
            if (jmin < 0) break;  // no finite path: the row stays free
            shortest = best;
            col_done[jmin] = 1;
            if (row4col[jmin] < 0) sink = jmin;
            else i = row4col[jmin];
        }
        if (sink < 0) continue;
        // update the potentials, then flip the path's assignments
        u[start] += shortest;
        for (int r = 0; r < m; ++r)
            if (row_done[r] && r != start) u[r] += shortest - dist[rows[r]];
        for (int j = 0; j < n; ++j)
            if (col_done[j]) v[j] -= shortest - dist[j];
        for (int j = sink;;) {
            const int r = path[j];
            row4col[j] = r;
            std::swap(rows[r], j);
            if (r == start) break;
        }
    }
    for (int r = 0; r < m; ++r) col4row[r] = rows[r];
    return SNIPPER_OK;
}

}  // extern "C"
