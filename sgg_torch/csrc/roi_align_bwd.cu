// RoIAlign backward for Hopper (sm_90a), channels-last: the gradients of
// roi_align (csrc/roi_align.cu) in the feature map and in the boxes.
//
// Replaces the backward of the TPU kernel sgg_tpu/ops/roi_align_pallas.py:
// roi_align_pallas, its custom VJP `_bwd` (two XLA einsums, grad_fmap only),
// and adds the box gradient that XLA's autodiff of the separable
// sgg_tpu/ops/roi_align.py:roi_align gives, which the JAX detector's train
// step differentiates through (its proposals are not detached).
//
// Layout: g (B, R, P, P, C) in the feature map's type, fmap (B, H, W, C)
// NHWC, boxes (B, R, 4) f32 image pixels [x1, y1, x2, y2].
//
// Sample i of S = P * ratio along an axis sits at
// y_i = start + extent * (i + 0.5) / S (divided, not multiplied by a
// reciprocal, as the forward and the plain version do); start = y1 * scale,
// extent = max(y2 * scale - y1 * scale, 1).
//
// sgg_roi_align_bwd_fmap: grad_fmap[b, y, x, c] =
//   sum_{r, p, q} Wy[b, r, p, y] Wx[b, r, q, x] g[b, r, p, q, c].
//   What bounds it: reading g once (3 x 512 x 49 x 512 bf16 = 77 MB at the
//   detector's training shape) and writing the gradient. Design: one block
//   per ROI; the per-bin folded tap tables of the forward (the bin average
//   in the weights, equal taps merged, zero weights dropped) in shared
//   memory; a thread owns V adjacent channels of one bin at a time, reads
//   its g vector once and adds w_y * w_x * g into every (y, x) tap of the
//   bin. ROIs overlap, so the adds are f32 atomics (16-byte vector atomics
//   where C % 4 == 0) into f32 scratch that the entry point zeroes first;
//   a second pass casts the scratch to bfloat16 for a bf16 map. The order
//   of the atomic adds, and so the rounding of the sums, varies from run
//   to run.
//
// sgg_roi_align_bwd_boxes: d loss / d boxes, f32, as XLA differentiates
//   the separable roi_align: per sample along y,
//   d/dy_i = (1/ratio) [valid, not capped] clip'(y_i)
//            * sum_{q, x taps, c} w_x g[p(i), q, c] (f[hi_i, x, c] - f[lo_i, x, c])
//   (clip' = 1 above 0, 1/2 at 0, 0 below, as jnp.clip's gradient), the
//   same along x with the roles swapped, then chained through
//   y_i = start + extent (i + 0.5) / S and extent = max(., 1) (a gradient
//   of 1/2 at the floor, 0 below it) and the spatial scale. Design: one
//   block per ROI; a thread owns V channels and walks the samples, a warp
//   reduces each sample's partial with shuffles into shared memory, and
//   the per-warp partials are summed in a fixed order, so the result does
//   not depend on scheduling. What bounds it: reading g and, from L2, the
//   taps of the map (2 rows x up to 4 taps x P bins per sample).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSamples = 64;  // pooled * ratio per axis
constexpr int kMaxTapsPerBin = 2 * 8;  // 2 * ratio, ratio <= 8
constexpr int kMaxTaps = kMaxTapsPerBin * kMaxSamples;

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

// V adjacent channels at p as f32.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(__ldg(p));
  } else if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    } else {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = a.x, v[1] = a.y;
    }
  } else {
    if constexpr (V == 4) {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = __uint_as_float(r.x << 16), v[1] = __uint_as_float(r.x & 0xffff0000u);
      v[2] = __uint_as_float(r.y << 16), v[3] = __uint_as_float(r.y & 0xffff0000u);
    } else {
      const unsigned r = __ldg(reinterpret_cast<const unsigned*>(p));
      v[0] = __uint_as_float(r << 16), v[1] = __uint_as_float(r & 0xffff0000u);
    }
  }
}

// Adds V f32 values at p atomically: one 16-byte vector atomic for V == 4.
template <int V>
__device__ __forceinline__ void atomic_add_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) atomicAdd(p + k, v[k]);
  }
}

struct Sample {
  int lo, hi;
  float w_lo, w_hi;
  float dmask;  // d w_hi / d y (= - d w_lo / d y), 0 where no gradient
};

// Sample i of S along one axis, torchvision's edge rules, and the
// derivative of its weights in y.
__device__ __forceinline__ Sample axis_sample(float start, float extent, int i,
                                              int S, int dim) {
  const float y = start + extent * (static_cast<float>(i) + 0.5f) /
                              static_cast<float>(S);
  const bool valid = (y >= -1.0f) && (y <= static_cast<float>(dim));
  const float yc = fmaxf(y, 0.0f);
  int l = static_cast<int>(floorf(yc));
  const bool cap = l >= dim - 1;
  if (cap) l = dim - 1;
  const float frac = cap ? 0.0f : yc - static_cast<float>(l);
  Sample s;
  s.lo = l;
  s.hi = cap ? dim - 1 : l + 1;
  s.w_lo = valid ? 1.0f - frac : 0.0f;
  s.w_hi = valid ? frac : 0.0f;
  const float clip_grad = y > 0.0f ? 1.0f : (y == 0.0f ? 0.5f : 0.0f);
  s.dmask = (valid && !cap) ? clip_grad : 0.0f;
  return s;
}

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

// start and extent of one axis of a ROI, rounded as the forward rounds
// them; raw = the extent before its floor at 1.
__device__ __forceinline__ void axis_frame(const float* bx, int axis,
                                           float scale, float* start,
                                           float* extent, float* raw) {
  // axis 0: rows (y1, y2), axis 1: columns (x1, x2)
  *start = __fmul_rn(bx[1 - axis], scale);
  *raw = __fmul_rn(bx[3 - axis], scale) - *start;
  *extent = fmaxf(*raw, 1.0f);
}

// Folded tap tables of both axes into shared memory (threads 0 .. 2P-1).
__device__ __forceinline__ void build_tables(const float* bx, float scale,
                                             int P, int ratio, int H, int W,
                                             int (*s_idx)[kMaxTaps],
                                             float (*s_w)[kMaxTaps],
                                             int (*s_n)[kMaxSamples]) {
  const int t = threadIdx.x;
  if (t < 2 * P) {
    const int axis = t < P ? 0 : 1;
    const int bin = t - axis * P;
    float start, extent, raw;
    axis_frame(bx, axis, scale, &start, &extent, &raw);
    const int dim = axis == 0 ? H : W;
    const int slots = 2 * ratio;
    int* idx = s_idx[axis] + bin * slots;
    float* wts = s_w[axis] + bin * slots;
    const float inv = 1.0f / static_cast<float>(ratio);
    int n = 0;
    for (int s = 0; s < ratio; ++s) {
      const Sample a = axis_sample(start, extent, bin * ratio + s, P * ratio,
                                   dim);
      add_tap(idx, wts, &n, a.lo, a.w_lo * inv);
      add_tap(idx, wts, &n, a.hi, a.w_hi * inv);
    }
    s_n[axis][bin] = n;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    roi_align_bwd_fmap_kernel(const T* __restrict__ g,
                              const float* __restrict__ boxes,
                              float* __restrict__ scratch, int R, int H,
                              int W, int C, float scale, int P, int ratio) {
  __shared__ int s_idx[2][kMaxTaps];
  __shared__ float s_w[2][kMaxTaps];
  __shared__ int s_n[2][kMaxSamples];
  const int roi = blockIdx.x;  // b * R + r
  const int b = roi / R;
  build_tables(boxes + static_cast<size_t>(roi) * 4, scale, P, ratio, H, W,
               s_idx, s_w, s_n);
  __syncthreads();

  const int slots = 2 * ratio;
  const int groups = C / V;
  const int items = P * P * groups;
  const T* gr = g + static_cast<size_t>(roi) * P * P * C;
  float* dst = scratch + static_cast<size_t>(b) * H * W * C;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int bin = item / groups;
    const int c = (item - bin * groups) * V;
    const int p = bin / P, q = bin - p * P;
    float gv[V];
    load_vec<T, V>(gr + static_cast<size_t>(bin) * C + c, gv);
    const int ny = s_n[0][p], nx = s_n[1][q];
    const int* yi = s_idx[0] + p * slots;
    const float* yw = s_w[0] + p * slots;
    const int* xi = s_idx[1] + q * slots;
    const float* xw = s_w[1] + q * slots;
    for (int a = 0; a < ny; ++a) {
      float* row = dst + static_cast<size_t>(yi[a]) * W * C + c;
      for (int e = 0; e < nx; ++e) {
        const float w = yw[a] * xw[e];
        float v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = w * gv[k];
        atomic_add_vec<V>(row + static_cast<size_t>(xi[e]) * C, v);
      }
    }
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ src,
                                 __nv_bfloat16* __restrict__ dst, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    roi_align_bwd_boxes_kernel(const T* __restrict__ g,
                               const T* __restrict__ fmap,
                               const float* __restrict__ boxes,
                               float* __restrict__ grad_boxes, int R, int H,
                               int W, int C, float scale, int P, int ratio) {
  __shared__ int s_idx[2][kMaxTaps];
  __shared__ float s_w[2][kMaxTaps];
  __shared__ int s_n[2][kMaxSamples];
  __shared__ int s_lo[2][kMaxSamples], s_hi[2][kMaxSamples];
  __shared__ float s_dm[2][kMaxSamples];
  __shared__ float s_part[kWarps][2][kMaxSamples];
  __shared__ float s_val[2][kMaxSamples];

  const int roi = blockIdx.x;
  const int b = roi / R;
  const int t = threadIdx.x;
  const int S = P * ratio;
  const float* bx = boxes + static_cast<size_t>(roi) * 4;
  build_tables(bx, scale, P, ratio, H, W, s_idx, s_w, s_n);
  if (t < 2 * S) {
    const int axis = t < S ? 0 : 1;
    const int i = t - axis * S;
    float start, extent, raw;
    axis_frame(bx, axis, scale, &start, &extent, &raw);
    const Sample a = axis_sample(start, extent, i, S, axis == 0 ? H : W);
    s_lo[axis][i] = a.lo;
    s_hi[axis][i] = a.hi;
    s_dm[axis][i] = a.dmask / static_cast<float>(ratio);
  }
  __syncthreads();

  const int slots = 2 * ratio;
  const int lane = t & 31, warp = t >> 5;
  const T* gr = g + static_cast<size_t>(roi) * P * P * C;
  const T* fm = fmap + static_cast<size_t>(b) * H * W * C;
  const size_t row = static_cast<size_t>(W) * C;
  for (int axis = 0; axis < 2; ++axis) {
    for (int i = 0; i < S; ++i) {
      if (s_dm[axis][i] == 0.0f) continue;  // block-uniform
      const int bin = i / ratio;
      const int lo = s_lo[axis][i], hi = s_hi[axis][i];
      float part = 0.0f;
      for (int c = t * V; c < C; c += kThreads * V) {
        for (int o = 0; o < P; ++o) {  // the other axis' bins
          const int p = axis == 0 ? bin : o, q = axis == 0 ? o : bin;
          float gv[V];
          load_vec<T, V>(gr + static_cast<size_t>(p * P + q) * C + c, gv);
          const int n = s_n[1 - axis][o];
          const int* oi = s_idx[1 - axis] + o * slots;
          const float* ow = s_w[1 - axis] + o * slots;
          for (int e = 0; e < n; ++e) {
            // axis 0 (rows): taps f[hi, x_e] - f[lo, x_e];
            // axis 1 (columns): f[y_e, hi] - f[y_e, lo]
            const T* a_hi = axis == 0
                ? fm + hi * row + static_cast<size_t>(oi[e]) * C + c
                : fm + oi[e] * row + static_cast<size_t>(hi) * C + c;
            const T* a_lo = axis == 0
                ? fm + lo * row + static_cast<size_t>(oi[e]) * C + c
                : fm + oi[e] * row + static_cast<size_t>(lo) * C + c;
            float vh[V], vl[V];
            load_vec<T, V>(a_hi, vh);
            load_vec<T, V>(a_lo, vl);
            float s = 0.0f;
#pragma unroll
            for (int k = 0; k < V; ++k) s = fmaf(gv[k], vh[k] - vl[k], s);
            part = fmaf(ow[e], s, part);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_down_sync(0xffffffffu, part, off);
      if (lane == 0) s_part[warp][axis][i] = part;
    }
  }
  __syncthreads();
  if (t < 2 * S) {
    const int axis = t < S ? 0 : 1;
    const int i = t - axis * S;
    float v = 0.0f;
    if (s_dm[axis][i] != 0.0f) {
      for (int w = 0; w < kWarps; ++w) v += s_part[w][axis][i];
      v *= s_dm[axis][i];
    }
    s_val[axis][i] = v;
  }
  __syncthreads();
  if (t < 2) {  // t == 0: rows (y1, y2); t == 1: columns (x1, x2)
    const int axis = t;
    float start, extent, raw;
    axis_frame(bx, axis, scale, &start, &extent, &raw);
    float d_start = 0.0f, d_extent = 0.0f;
    for (int i = 0; i < S; ++i) {
      const float v = s_val[axis][i];
      d_start += v;
      d_extent = fmaf(v / static_cast<float>(S),
                      static_cast<float>(i) + 0.5f, d_extent);
    }
    const float floor_grad = raw > 1.0f ? 1.0f : (raw == 1.0f ? 0.5f : 0.0f);
    const float d_hi = d_extent * floor_grad;
    float* out = grad_boxes + static_cast<size_t>(roi) * 4;
    out[1 - axis] = (d_start - d_hi) * scale;
    out[3 - axis] = d_hi * scale;
  }
}

template <typename T>
int launch_fmap(const void* g, const void* boxes, float* scratch,
                void* grad_fmap, int B, int H, int W, int C, int R,
                float scale, int P, int ratio, cudaStream_t s) {
  const size_t n = static_cast<size_t>(B) * H * W * C;
  cudaError_t err = cudaMemsetAsync(scratch, 0, n * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* gp = static_cast<const T*>(g);
  const float* bx = static_cast<const float*>(boxes);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(g);
  if (R > 0) {
    if (C % 4 == 0 && addr % (4 * sizeof(T)) == 0)
      roi_align_bwd_fmap_kernel<T, 4><<<B * R, kThreads, 0, s>>>(
          gp, bx, scratch, R, H, W, C, scale, P, ratio);
    else
      roi_align_bwd_fmap_kernel<T, 1><<<B * R, kThreads, 0, s>>>(
          gp, bx, scratch, R, H, W, C, scale, P, ratio);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int blocks = static_cast<int>(
        (n + kThreads - 1) / kThreads < 4096 ? (n + kThreads - 1) / kThreads
                                             : 4096);
    cast_bf16_kernel<<<blocks, kThreads, 0, s>>>(
        scratch, static_cast<__nv_bfloat16*>(grad_fmap), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_boxes(const void* g, const void* fmap, const void* boxes,
                 float* grad_boxes, int B, int H, int W, int C, int R,
                 float scale, int P, int ratio, cudaStream_t s) {
  const T* gp = static_cast<const T*>(g);
  const T* fp = static_cast<const T*>(fmap);
  const float* bx = static_cast<const float*>(boxes);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(fmap);
  if (C % 2 == 0 && addr % (2 * sizeof(T)) == 0)
    roi_align_bwd_boxes_kernel<T, 2><<<B * R, kThreads, 0, s>>>(
        gp, fp, bx, grad_boxes, R, H, W, C, scale, P, ratio);
  else
    roi_align_bwd_boxes_kernel<T, 1><<<B * R, kThreads, 0, s>>>(
        gp, fp, bx, grad_boxes, R, H, W, C, scale, P, ratio);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int pooled, int ratio) {
  return pooled < 1 || ratio < 1 || ratio > kMaxTapsPerBin / 2 ||
         pooled * ratio > kMaxSamples;
}

}  // namespace

extern "C" {

const char* sgg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// grad_fmap (B, H, W, C) of roi_align from g (B, R, P, P, C); scratch is
// B * H * W * C f32, zeroed here; for dtype 0 (float32) grad_fmap must be
// scratch itself, for dtype 1 (bfloat16) the scratch is cast into it.
int sgg_roi_align_bwd_fmap(const void* g, const void* boxes, float* scratch,
                           void* grad_fmap, int B, int H, int W, int C, int R,
                           float scale, int pooled, int ratio, int dtype,
                           void* stream) {
  if (bad_args(pooled, ratio)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && grad_fmap != scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || C == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_fmap<__nv_bfloat16>(g, boxes, scratch, grad_fmap, B, H, W,
                                      C, R, scale, pooled, ratio, s);
  return launch_fmap<float>(g, boxes, scratch, grad_fmap, B, H, W, C, R,
                            scale, pooled, ratio, s);
}

// grad_boxes (B, R, 4) f32 of roi_align from g (B, R, P, P, C) and fmap.
int sgg_roi_align_bwd_boxes(const void* g, const void* fmap,
                            const void* boxes, float* grad_boxes, int B,
                            int H, int W, int C, int R, float scale,
                            int pooled, int ratio, int dtype, void* stream) {
  if (bad_args(pooled, ratio)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0)
    return static_cast<int>(cudaMemsetAsync(
        grad_boxes, 0, static_cast<size_t>(B) * R * 4 * sizeof(float), s));
  if (dtype == 1)
    return launch_boxes<__nv_bfloat16>(g, fmap, boxes, grad_boxes, B, H, W, C,
                                       R, scale, pooled, ratio, s);
  return launch_boxes<float>(g, fmap, boxes, grad_boxes, B, H, W, C, R,
                             scale, pooled, ratio, s);
}

}  // extern "C"
