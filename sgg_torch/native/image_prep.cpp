// Native host-side image preparation: uint8 HWC decode output -> resized,
// flipped, mean-padded uint8 canvas in ONE pass (no float round trips).
//
// The uint8 route of the port's prepare_example
// (sgg_torch/data/pipeline.py) calls it for every uint8 image; the
// reference's analogue is torchvision's transforms on DataLoader workers
// (reference dataloaders/image_transforms.py). The resampler is the
// separable triangle (bilinear-with-antialias) filter PIL uses for
// Image.BILINEAR: support scales with the downscale factor, so
// minification area-averages instead of point-sampling. The port's copy of
// sgg_tpu/native/image_prep.cpp, kept byte for byte in its code, so that
// the same compiler and flags give the same canvases.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Coeffs {
    // for each output index: window [lo, hi) into the input and normalized
    // weights at [wofs[i] .. wofs[i] + (hi - lo))
    std::vector<int32_t> lo, hi;
    std::vector<float> w;
    std::vector<int64_t> wofs;
};

Coeffs triangle_coeffs(int64_t in, int64_t out) {
    Coeffs c;
    c.lo.resize(out);
    c.hi.resize(out);
    c.wofs.resize(out);
    const double scale = static_cast<double>(in) / out;
    const double filterscale = std::max(scale, 1.0);
    const double support = filterscale;  // triangle radius 1 * filterscale
    for (int64_t i = 0; i < out; ++i) {
        const double center = (i + 0.5) * scale;
        int64_t lo = static_cast<int64_t>(std::floor(center - support));
        int64_t hi = static_cast<int64_t>(std::ceil(center + support));
        lo = std::max<int64_t>(lo, 0);
        hi = std::min<int64_t>(hi, in);
        c.lo[i] = static_cast<int32_t>(lo);
        c.hi[i] = static_cast<int32_t>(hi);
        c.wofs[i] = static_cast<int64_t>(c.w.size());
        double total = 0.0;
        for (int64_t j = lo; j < hi; ++j) {
            const double x = (j + 0.5 - center) / filterscale;
            const double t = 1.0 - std::abs(x);
            const double wj = t > 0.0 ? t : 0.0;
            c.w.push_back(static_cast<float>(wj));
            total += wj;
        }
        if (total > 0.0) {
            for (int64_t j = lo; j < hi; ++j)
                c.w[c.wofs[i] + (j - lo)] /= static_cast<float>(total);
        }
    }
    return c;
}

inline uint8_t clamp_u8(float v) {
    const float r = v + 0.5f;
    return static_cast<uint8_t>(r < 0.f ? 0.f : (r > 255.f ? 255.f : r));
}

}  // namespace

extern "C" {

// src: (h, w, 3) uint8. canvas: (S, S, 3) uint8, fully overwritten: the
// (ch, cw) top-left region receives the resized (and, when flip != 0,
// horizontally mirrored) image; the rest is filled with fill[0..2].
void prepare_image_u8(const uint8_t* src, int64_t h, int64_t w,
                      uint8_t* canvas, int64_t S, int64_t ch, int64_t cw,
                      int64_t flip, const uint8_t* fill) {
    const Coeffs cx = triangle_coeffs(w, cw);
    const Coeffs cy = triangle_coeffs(h, ch);

    // horizontal pass: (h, w, 3) -> (h, cw, 3) float
    std::vector<float> tmp(static_cast<size_t>(h) * cw * 3);
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* row = src + y * w * 3;
        float* trow = tmp.data() + y * cw * 3;
        for (int64_t x = 0; x < cw; ++x) {
            float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
            const float* wts = cx.w.data() + cx.wofs[x];
            for (int32_t j = cx.lo[x]; j < cx.hi[x]; ++j) {
                const float wj = wts[j - cx.lo[x]];
                const uint8_t* p = row + static_cast<int64_t>(j) * 3;
                acc0 += wj * p[0];
                acc1 += wj * p[1];
                acc2 += wj * p[2];
            }
            trow[x * 3 + 0] = acc0;
            trow[x * 3 + 1] = acc1;
            trow[x * 3 + 2] = acc2;
        }
    }

    // vertical pass directly into the canvas (+ optional mirror)
    for (int64_t y = 0; y < ch; ++y) {
        uint8_t* crow = canvas + y * S * 3;
        const float* wts = cy.w.data() + cy.wofs[y];
        for (int64_t x = 0; x < cw; ++x) {
            float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
            for (int32_t j = cy.lo[y]; j < cy.hi[y]; ++j) {
                const float wj = wts[j - cy.lo[y]];
                const float* p = tmp.data()
                    + (static_cast<int64_t>(j) * cw + x) * 3;
                acc0 += wj * p[0];
                acc1 += wj * p[1];
                acc2 += wj * p[2];
            }
            const int64_t ox = flip ? (cw - 1 - x) : x;
            crow[ox * 3 + 0] = clamp_u8(acc0);
            crow[ox * 3 + 1] = clamp_u8(acc1);
            crow[ox * 3 + 2] = clamp_u8(acc2);
        }
        // right padding
        for (int64_t x = cw; x < S; ++x) {
            crow[x * 3 + 0] = fill[0];
            crow[x * 3 + 1] = fill[1];
            crow[x * 3 + 2] = fill[2];
        }
    }
    // bottom padding
    for (int64_t y = ch; y < S; ++y) {
        uint8_t* crow = canvas + y * S * 3;
        for (int64_t x = 0; x < S; ++x) {
            crow[x * 3 + 0] = fill[0];
            crow[x * 3 + 1] = fill[1];
            crow[x * 3 + 2] = fill[2];
        }
    }
}

}  // extern "C"
