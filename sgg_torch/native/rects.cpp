// Native reference implementation of the anti-aliased box-pair rasterizer.
//
// The reference framework's only hand-written native component is a Cython
// kernel (reference lib/draw_rectangles/draw_rectangles.pyx:27-67) that
// rasterizes subject/object box pairs into (N, 2, P, P) coverage masks. This
// C++ translation unit has the same semantics and is the host-side oracle
// for the port's rasterizer (sgg_torch/ops/rects.py): no training or eval
// path calls it; tests and chip_smoke.py hold the card's rasterizer
// against it. The port's copy of sgg_tpu/native/rects.cpp, kept byte for
// byte in its code. Built and bound by sgg_torch/native/__init__.py.

#include <algorithm>
#include <cstdint>

namespace {
inline float minmax01(float x) { return std::min(std::max(x, 0.0f), 1.0f); }
}  // namespace

extern "C" {

// box_pairs: N x 8 row-major floats [sx1 sy1 sx2 sy2 ox1 oy1 ox2 oy2].
// out: N x 2 x P x P row-major floats, coverage in [0, 1].
void draw_union_rects(const float* box_pairs, int64_t n, int64_t pooling_size,
                      float* out) {
  const int64_t P = pooling_size;
  for (int64_t i = 0; i < n; ++i) {
    const float* bp = box_pairs + i * 8;
    const float x1u = std::min(bp[0], bp[4]);
    const float y1u = std::min(bp[1], bp[5]);
    const float x2u = std::max(bp[2], bp[6]);
    const float y2u = std::max(bp[3], bp[7]);
    const float w = x2u - x1u;
    const float h = y2u - y1u;
    for (int64_t b = 0; b < 2; ++b) {
      const float x1 = (bp[4 * b + 0] - x1u) * P / w;
      const float y1 = (bp[4 * b + 1] - y1u) * P / h;
      const float x2 = (bp[4 * b + 2] - x1u) * P / w;
      const float y2 = (bp[4 * b + 3] - y1u) * P / h;
      float* dst = out + ((i * 2 + b) * P) * P;
      for (int64_t j = 0; j < P; ++j) {
        const float yc = minmax01(j + 1 - y1) * minmax01(y2 - j);
        for (int64_t k = 0; k < P; ++k) {
          const float xc = minmax01(k + 1 - x1) * minmax01(x2 - k);
          dst[j * P + k] = xc * yc;
        }
      }
    }
  }
}

}  // extern "C"
