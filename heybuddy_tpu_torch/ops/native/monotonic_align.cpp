// Monotonic alignment search for VITS training.
//
// Native-equivalent of the reference's `monotonic_align` Cython extension
// (reference setup.py:8; used by piper/models.py:663-722 `maximum_path` in the
// VITS training forward). Computes, per batch element, the maximum-likelihood
// monotonic path through a (t_text, t_mel) log-likelihood matrix by dynamic
// programming with backtracking.
//
// Exposed as a C ABI for ctypes (no pybind11 dependency in the image):
//   maximum_path_batch(values, paths, t_xs, t_ys, batch, max_tx, max_ty)
// where `values` is float32 [batch, max_tx, max_ty] (log-likelihoods, will be
// overwritten with DP sums) and `paths` is int32 [batch, max_tx, max_ty]
// receiving the 0/1 alignment.

#include <cstdint>
#include <cstring>
#include <limits>

extern "C" {

static void maximum_path_single(
    float* value,        // [max_tx, max_ty] row-major, modified in place
    int32_t* path,       // [max_tx, max_ty] output
    int t_x, int t_y,
    int max_ty
) {
    const float neg_inf = -std::numeric_limits<float>::infinity();

    // Forward DP: value[x][y] += max(value[x-1][y-1], value[x][y-1]),
    // restricted to the feasible band.
    for (int y = 0; y < t_y; ++y) {
        int x_lo = (y + t_x - t_y > 0) ? (y + t_x - t_y) : 0;
        int x_hi = (y + 1 < t_x) ? (y + 1) : t_x;
        for (int x = x_lo; x < x_hi; ++x) {
            float v_cur = neg_inf;   // stay on same text token (x, y-1)
            float v_prev = neg_inf;  // advance text token (x-1, y-1)
            if (y > 0) {
                if (x < t_x) v_cur = value[x * max_ty + (y - 1)];
                if (x > 0) v_prev = value[(x - 1) * max_ty + (y - 1)];
            } else {
                v_prev = (x == 0) ? 0.0f : neg_inf;
                v_cur = neg_inf;
            }
            float best = (v_prev > v_cur) ? v_prev : v_cur;
            if (y == 0 && x == 0) best = 0.0f;
            value[x * max_ty + y] += best;
        }
    }

    // Backtrack.
    int index = t_x - 1;
    for (int y = t_y - 1; y >= 0; --y) {
        path[index * max_ty + y] = 1;
        if (index != 0) {
            float stay = value[index * max_ty + (y - 1)];
            float step = value[(index - 1) * max_ty + (y - 1)];
            if (y == index || step >= stay) {
                index -= 1;
            }
        }
    }
}

void maximum_path_batch(
    float* values,   // [batch, max_tx, max_ty]
    int32_t* paths,  // [batch, max_tx, max_ty], zero-initialized by caller
    const int32_t* t_xs,
    const int32_t* t_ys,
    int batch,
    int max_tx,
    int max_ty
) {
    for (int b = 0; b < batch; ++b) {
        maximum_path_single(
            values + static_cast<int64_t>(b) * max_tx * max_ty,
            paths + static_cast<int64_t>(b) * max_tx * max_ty,
            t_xs[b], t_ys[b], max_ty);
    }
}

}  // extern "C"
