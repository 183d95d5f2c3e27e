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
// bf16 = 22 MB, resident in the 50 MB L2) the bytes the function must move
// are the output (16x256x49x512 bf16 = 205 MB for the union pooling), so
// its bound is the output write at HBM rate. What a kernel can lose beyond
// that is the SMs' dispatch rate and L1/L2 traffic for the taps: ratio^2
// samples of 4 taps each per output value, all re-read from cache.
//
// Design: one block of 256 threads per ROI.
//  - A thread owns V adjacent channels of one bin at a time: V = 8 where
//    C % 8 == 0 and both base pointers are 16-byte aligned, so a tap is one
//    16-byte read-only load (bf16; two for f32), a bin is one 16-byte
//    store, and a warp's access is 512 contiguous bytes. Other C or
//    alignments take the same kernel at V = 2 or V = 1; the C entry point
//    picks V from C and the pointers.
//  - The bin average is folded into per-axis tap tables, as the plain
//    version's Wy and Wx are: per axis and bin the distinct (index, weight)
//    taps of its `ratio` samples, weights scaled by 1/ratio, equal indices
//    merged and zero weights dropped, built once per block in shared
//    memory. A bin then costs ny * nx <= (2 * ratio)^2 taps, far fewer for
//    a ROI whose bins are narrower than a feature-map pixel or whose
//    samples fall outside the map.
//  - Work items (bin, channel group) are dealt to the threads in order, so
//    a warp's 32 items are one bin's neighbouring channel groups; a thread
//    steps from item to item by constants, without a division.
//  - With at most 4 taps a bin and axis (ratio <= 2) a bin's column taps
//    are read with two 16-byte shared-memory loads and the walk switches
//    on their count, so that the loads of one tap row are started together
//    with no predicated-off slots; other ratios take a plain double loop
//    in the same kernel. Sums are f32 for both types; the output goes out
//    with streaming stores, which leave the feature map in L2.
// What was measured on the card (PERF.md): the kernel is held back by the
// latency of dependent tap loads and by the SMs' dispatch rate (per tap and
// thread one load, 8 conversions, 8 multiply-adds), not by its stores.
// Sharing a row stage between bins, in registers or in shared memory,
// padding every bin to 4 x 4 predicated taps, more blocks per SM at fewer
// registers and two blocks per ROI were all slower.
// The TPU kernel's two-stage MXU/VPU split does not carry over: with a
// channel vector per thread no matmul is needed to stay busy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSamples = 64;            // pooled * ratio per axis
constexpr int kSlots = 4;  // least table slots a bin (one 16-byte read)
constexpr int kMaxTaps = kSlots * kMaxSamples;  // table slots per axis

__device__ __forceinline__ void unpack_bf16x2(unsigned r, float& lo,
                                              float& hi) {
  lo = __uint_as_float(r << 16);
  hi = __uint_as_float(r & 0xffff0000u);
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// V adjacent channels at p as f32, through the read-only path.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 8) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else if constexpr (V == 2) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = a.x, v[1] = a.y;
    } else {
      v[0] = __ldg(p);
    }
  } else {
    if constexpr (V == 8) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
      unpack_bf16x2(r.x, v[0], v[1]);
      unpack_bf16x2(r.y, v[2], v[3]);
      unpack_bf16x2(r.z, v[4], v[5]);
      unpack_bf16x2(r.w, v[6], v[7]);
    } else if constexpr (V == 2) {
      unpack_bf16x2(__ldg(reinterpret_cast<const unsigned*>(p)), v[0], v[1]);
    } else {
      v[0] = __bfloat162float(__ldg(p));
    }
  }
}

// V adjacent channels to p in T, written once and not read again here.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 8) {
      __stcs(reinterpret_cast<float4*>(p),
             make_float4(v[0], v[1], v[2], v[3]));
      __stcs(reinterpret_cast<float4*>(p) + 1,
             make_float4(v[4], v[5], v[6], v[7]));
    } else if constexpr (V == 2) {
      __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
    } else {
      __stcs(p, v[0]);
    }
  } else {
    if constexpr (V == 8) {
      __stcs(reinterpret_cast<uint4*>(p),
             make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                        pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7])));
    } else if constexpr (V == 2) {
      __stcs(reinterpret_cast<unsigned*>(p), pack_bf16x2(v[0], v[1]));
    } else {
      *p = __float2bfloat16(v[0]);
    }
  }
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

// Adds tap (index, w) to a bin's table of n taps; equal indices merge and
// a zero weight adds nothing.
__device__ __forceinline__ void add_tap(int* idx, float* wts, int* n,
                                        int index, float w) {
  if (w == 0.0f) return;
  for (int k = 0; k < *n; ++k) {
    if (idx[k] == index) {
      wts[k] += w;
      return;
    }
  }
  idx[*n] = index;
  wts[*n] = w;
  ++*n;
}

// The taps of NX columns over ny rows of one bin: a row's NX loads are
// started together, then summed.
template <typename T, int V, int NX>
__device__ __forceinline__ void bin_taps(const T* fm_c, size_t row, int C,
                                         int ny, const int* yi,
                                         const float* yw, const int4 xi4,
                                         const float4 xw4, float (&acc)[V]) {
  const int xi[4] = {xi4.x, xi4.y, xi4.z, xi4.w};
  const float xw[4] = {xw4.x, xw4.y, xw4.z, xw4.w};
#pragma unroll 1
  for (int a = 0; a < ny; ++a) {
    const T* src = fm_c + static_cast<size_t>(yi[a]) * row;
    const float wy = yw[a];
    float v[NX][V];
#pragma unroll
    for (int e = 0; e < NX; ++e)
      load_vec<T, V>(src + static_cast<size_t>(xi[e]) * C, v[e]);
#pragma unroll
    for (int e = 0; e < NX; ++e) {
      const float w = wy * xw[e];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = fmaf(w, v[e][k], acc[k]);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    roi_align_kernel(const T* __restrict__ fmap,
                     const float* __restrict__ boxes, T* __restrict__ out,
                     int R, int H, int W, int C, float scale, int P,
                     int ratio) {
  // Folded taps per axis (0: y / rows, 1: x / columns): bin i owns the
  // slots [i * slots, i * slots + s_n[axis][i]), slots = max(2 * ratio, 4);
  // its unused slots among the first 4 hold index 0 and weight 0.
  __shared__ __align__(16) int s_idx[2][kMaxTaps];
  __shared__ __align__(16) float s_w[2][kMaxTaps];
  __shared__ int s_n[2][kMaxSamples];

  const int roi = blockIdx.x;  // b * R + r
  const int b = roi / R;
  const int t = threadIdx.x;
  const int slots = max(2 * ratio, kSlots);
  if (t < 2 * P) {
    const float* bx = boxes + static_cast<size_t>(roi) * 4;
    const int axis = t < P ? 0 : 1;
    const int bin = t - axis * P;
    // y1, y2 for rows and x1, x2 for columns; products rounded before the
    // difference (no fused multiply-add), as the plain version rounds them
    const float lo_edge = __fmul_rn(bx[1 - axis], scale);
    const float extent =
        fmaxf(__fmul_rn(bx[3 - axis], scale) - lo_edge, 1.0f);
    const int dim = axis == 0 ? H : W;
    int* idx = s_idx[axis] + bin * slots;
    float* wts = s_w[axis] + bin * slots;
    const float inv = 1.0f / static_cast<float>(ratio);
    for (int k = 0; k < kSlots; ++k) idx[k] = 0, wts[k] = 0.0f;
    int n = 0;
    for (int s = 0; s < ratio; ++s) {
      int lo, hi;
      float w_lo, w_hi;
      axis_taps(lo_edge, extent, bin * ratio + s, P * ratio, dim, &lo, &hi,
                &w_lo, &w_hi);
      add_tap(idx, wts, &n, lo, w_lo * inv);
      add_tap(idx, wts, &n, hi, w_hi * inv);
    }
    s_n[axis][bin] = n;
  }
  __syncthreads();

  const int groups = C / V;
  const int items = P * P * groups;
  const T* fm = fmap + static_cast<size_t>(b) * H * W * C;
  T* o = out + static_cast<size_t>(roi) * P * P * C;
  const size_t row = static_cast<size_t>(W) * C;

  // Item = bin * groups + group, bin = p * P + q. The divisions are done
  // once; a step of kThreads items then moves (p, q, group) by constants.
  const int bin0 = t / groups;
  int g = t - bin0 * groups;
  int p = bin0 / P, q = bin0 - p * P;
  const int step_bins = kThreads / groups;
  const int dg = kThreads - step_bins * groups;
  const int dp = step_bins / P, dq = step_bins - dp * P;
  for (int item = t; item < items; item += kThreads) {
    const int c = g * V;
    const int bin = p * P + q;
    const int ny = s_n[0][p], nx = s_n[1][q];
    const int* yi = s_idx[0] + p * slots;
    const float* yw = s_w[0] + p * slots;
    const int* xi = s_idx[1] + q * slots;
    const float* xw = s_w[1] + q * slots;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    if (slots == kSlots) {
      const int4 xi4 = *reinterpret_cast<const int4*>(xi);
      const float4 xw4 = *reinterpret_cast<const float4*>(xw);
      switch (nx) {
        case 1:
          bin_taps<T, V, 1>(fm + c, row, C, ny, yi, yw, xi4, xw4, acc);
          break;
        case 2:
          bin_taps<T, V, 2>(fm + c, row, C, ny, yi, yw, xi4, xw4, acc);
          break;
        case 3:
          bin_taps<T, V, 3>(fm + c, row, C, ny, yi, yw, xi4, xw4, acc);
          break;
        case 4:
          bin_taps<T, V, 4>(fm + c, row, C, ny, yi, yw, xi4, xw4, acc);
          break;
        default:
          break;
      }
    } else {
      for (int a = 0; a < ny; ++a) {
        const T* src = fm + static_cast<size_t>(yi[a]) * row + c;
        const float wy = yw[a];
#pragma unroll 4
        for (int e = 0; e < nx; ++e) {
          float v[V];
          load_vec<T, V>(src + static_cast<size_t>(xi[e]) * C, v);
          const float w = wy * xw[e];
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = fmaf(w, v[k], acc[k]);
        }
      }
    }
    store_vec<T, V>(o + static_cast<size_t>(bin) * C + c, acc);
    g += dg;
    const int carry = g >= groups;
    g -= carry * groups;
    q += dq + carry;
    p += dp;
    if (q >= P) q -= P, ++p;
  }
}

template <typename T>
int launch(const void* fmap, const void* boxes, void* out, int B, int H,
           int W, int C, int R, float scale, int pooled, int ratio,
           cudaStream_t s) {
  const T* f = static_cast<const T*>(fmap);
  const float* bx = static_cast<const float*>(boxes);
  T* o = static_cast<T*>(out);
  // Widest channel vector that C and both base pointers allow.
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(fmap) | reinterpret_cast<uintptr_t>(out);
  const int grid = B * R;
  if (C % 8 == 0 && addr % 16 == 0) {
    roi_align_kernel<T, 8><<<grid, kThreads, 0, s>>>(f, bx, o, R, H, W, C,
                                                     scale, pooled, ratio);
  } else if (C % 2 == 0 && addr % (2 * sizeof(T)) == 0) {
    roi_align_kernel<T, 2><<<grid, kThreads, 0, s>>>(f, bx, o, R, H, W, C,
                                                     scale, pooled, ratio);
  } else {
    roi_align_kernel<T, 1><<<grid, kThreads, 0, s>>>(f, bx, o, R, H, W, C,
                                                     scale, pooled, ratio);
  }
  return static_cast<int>(cudaGetLastError());
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
  if (pooled < 1 || ratio < 1 || pooled * ratio > kMaxSamples)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || R == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(fmap, boxes, out, B, H, W, C, R, scale,
                                 pooled, ratio, s);
  return launch<float>(fmap, boxes, out, B, H, W, C, R, scale, pooled, ratio,
                       s);
}

}  // extern "C"
