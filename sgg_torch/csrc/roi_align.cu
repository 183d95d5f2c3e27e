// RoIAlign forward for Hopper (sm_90a), channels-last.
//
// Replaces the TPU kernel sgg_tpu/ops/roi_align_pallas.py:roi_align_pallas
// (Pallas body `_kernel`). It computes torchvision roi_align(aligned=False):
// ROI extents floored at 1 feature-map pixel, `ratio` x `ratio` bilinear
// samples per bin, torchvision's edge rules (a sample is valid in
// [-1, dim], clamped at 0, capped at dim-1), f32 accumulation, output in the
// feature map's type.
//
// Layout: fmap (B, H, W, C) NHWC, boxes (B, R, 4) f32 image pixels,
// out (B, R, P, P, C).
//
// What bounds it on an H100: at the main path's shapes (fmap 16x37x37x512
// bf16 = 22 MB, fits the 50 MB L2) the bytes the function must move are
// dominated by the output (16x256x49x512 bf16 = 205 MB for the union
// pooling), so its bound is the output write at HBM rate. Each output
// value costs 4 samples x 4 taps of multiply-add in f32.
//
// Design: one block per (ROI, 128-channel tile); each thread owns one
// channel, so every tap read and every output write is a coalesced
// channel-contiguous access of the warp. The sample coordinates and
// bilinear weights of the ROI (2 x P x ratio entries) are built once per
// block into shared memory by the first threads, then every thread walks
// the P x P bins from them. The taps are re-read from L2 (the feature map
// stays resident); the output is written exactly once. The TPU kernel's
// two-stage MXU/VPU split does not carry over: a GPU thread per channel
// needs no matmul to stay busy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSamples = 64;  // pooled * ratio per axis

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

template <typename T>
__device__ __forceinline__ T store_cast(float v);
template <>
__device__ __forceinline__ float store_cast<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sample i of S along one axis: start + extent * (i + 0.5) / S, then
// torchvision's bilinear edge handling.
__device__ __forceinline__ void axis_taps(float start, float extent, int i,
                                          int S, int dim, int* lo, int* hi,
                                          float* w_lo, float* w_hi) {
  const float y = start + extent * (static_cast<float>(i) + 0.5f) /
                              static_cast<float>(S);
  const bool valid = (y >= -1.0f) && (y <= static_cast<float>(dim));
  const float yc = fmaxf(y, 0.0f);
  int l = static_cast<int>(floorf(yc));
  const bool cap = l >= dim - 1;
  if (cap) l = dim - 1;
  const float frac = cap ? 0.0f : yc - static_cast<float>(l);
  *lo = l;
  *hi = cap ? dim - 1 : l + 1;
  *w_lo = valid ? 1.0f - frac : 0.0f;
  *w_hi = valid ? frac : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    roi_align_kernel(const T* __restrict__ fmap,
                     const float* __restrict__ boxes, T* __restrict__ out,
                     int R, int H, int W, int C, float scale, int P,
                     int ratio) {
  __shared__ int s_lo[2][kMaxSamples];
  __shared__ int s_hi[2][kMaxSamples];
  __shared__ float s_wlo[2][kMaxSamples];
  __shared__ float s_whi[2][kMaxSamples];

  const int roi = blockIdx.x;  // b * R + r
  const int b = roi / R;
  const int S = P * ratio;
  const int t = threadIdx.x;
  if (t < 2 * S) {
    const float* bx = boxes + static_cast<size_t>(roi) * 4;
    const float x1 = bx[0] * scale;
    const float y1 = bx[1] * scale;
    const float x2 = bx[2] * scale;
    const float y2 = bx[3] * scale;
    const int axis = t < S ? 0 : 1;  // 0: y (rows), 1: x (columns)
    const int i = axis == 0 ? t : t - S;
    if (axis == 0) {
      axis_taps(y1, fmaxf(y2 - y1, 1.0f), i, S, H, &s_lo[0][i], &s_hi[0][i],
                &s_wlo[0][i], &s_whi[0][i]);
    } else {
      axis_taps(x1, fmaxf(x2 - x1, 1.0f), i, S, W, &s_lo[1][i], &s_hi[1][i],
                &s_wlo[1][i], &s_whi[1][i]);
    }
  }
  __syncthreads();

  const int c = blockIdx.y * kThreads + t;
  if (c >= C) return;
  const T* fm = fmap + static_cast<size_t>(b) * H * W * C + c;
  T* o = out + static_cast<size_t>(roi) * P * P * C + c;
  const float inv = 1.0f / static_cast<float>(ratio * ratio);
  const size_t row = static_cast<size_t>(W) * C;

  for (int p = 0; p < P; ++p) {
    for (int q = 0; q < P; ++q) {
      float acc = 0.0f;
      for (int iy = 0; iy < ratio; ++iy) {
        const int sy = p * ratio + iy;
        const size_t ylo = s_lo[0][sy] * row, yhi = s_hi[0][sy] * row;
        const float wylo = s_wlo[0][sy], wyhi = s_whi[0][sy];
        for (int ix = 0; ix < ratio; ++ix) {
          const int sx = q * ratio + ix;
          const size_t xlo = static_cast<size_t>(s_lo[1][sx]) * C;
          const size_t xhi = static_cast<size_t>(s_hi[1][sx]) * C;
          const float wxlo = s_wlo[1][sx], wxhi = s_whi[1][sx];
          acc += wylo * (wxlo * load_f(fm + ylo + xlo) +
                         wxhi * load_f(fm + ylo + xhi)) +
                 wyhi * (wxlo * load_f(fm + yhi + xlo) +
                         wxhi * load_f(fm + yhi + xhi));
        }
      }
      o[static_cast<size_t>(p * P + q) * C] = store_cast<T>(acc * inv);
    }
  }
}

}  // namespace

extern "C" {

const char* sgg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (fmap and out).
int sgg_roi_align(const void* fmap, const void* boxes, void* out, int B,
                  int H, int W, int C, int R, float scale, int pooled,
                  int ratio, int dtype, void* stream) {
  if (pooled * ratio > kMaxSamples || 2 * pooled * ratio > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || R == 0 || C == 0) return 0;
  const dim3 grid(B * R, (C + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    roi_align_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(fmap),
        static_cast<const float*>(boxes), static_cast<__nv_bfloat16*>(out),
        R, H, W, C, scale, pooled, ratio);
  } else {
    roi_align_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(fmap), static_cast<const float*>(boxes),
        static_cast<float*>(out), R, H, W, C, scale, pooled, ratio);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
