// The frozen VGG16 trunk's conv epilogue for Hopper (sm_90a), on the
// channels-last output of a bias-less cuDNN convolution:
//   pool = 0:  out = relu(y + b)                 (in place: out == y)
//   pool = 1:  out = relu(max_2x2(y) + b)        (H / 2 x W / 2, floored)
//
// Replaces no TPU kernel: on the TPU XLA fuses the bias, the ReLU and the
// 2x2 max-pool into the convolution. On the card PyTorch adds the bias
// after cuDNN's kernel in a broadcast pass that channels-last memory keeps
// from vectorising, then runs the ReLU and the pool as two more passes
// over the whole map: three reads and two writes of every conv output.
//
// Arithmetic: each element and the bias (f32 or bf16) are widened to f32
// (exact) and added in f32 (one f32 rounding); a bf16 map's sum is then
// narrowed once to bf16 (round to nearest even).
// Rounding and "+ b" are monotone, so pooling first gives the bits of
// bias -> ReLU -> pool in this arithmetic. The max keeps the first of equal
// values and lets a NaN win, as PyTorch's max_pool2d does; the ReLU keeps a
// NaN.
//
// What bounds it on an H100: bytes. Each input byte is read once and each
// output byte written once: 2 x the map in place, or the map plus a quarter
// of it with the pool. For the trunk at B = 24, 592 px in bf16 that is
// 5.42 GB over the 12 convs after conv1_1, 1.62 ms at 3.35 TB/s.
//
// Design: a grid-stride loop over 16-byte vectors (8 bf16 or 4 f32
// channels), neighbouring threads on neighbouring vectors. A thread keeps
// one channel group for its whole life (the grid's thread count is a
// multiple of C / vector width, which divides 256), so its bias values
// are loaded once, into registers. The in-place pass issues 4 vectors'
// loads before any store; the pooled pass loads the window's four
// vectors (two of each input row, both rows in contiguous runs across a
// warp) and stores one. The grid is what the card holds resident (the
// occupancy query times the SMs), so every thread runs to the end in one
// wave.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // in-place pass: vectors in flight a thread

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const uint4& v, float (&f)[kN]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 store(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const uint4& v, float (&f)[kN]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pair(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static uint4 store(const float (&f)[kN]) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                      pair(f[6], f[7]));
  }
};

// the bias in f32 (0) or bf16 (1), widened to f32 (exact)
__device__ __forceinline__ float bias_at(const void* bias, int bias_bf16,
                                         int c) {
  return bias_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[c])
             : static_cast<const float*>(bias)[c];
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// PyTorch's max_pool2d rule: a later value replaces the max if greater or
// NaN
__device__ __forceinline__ float pool_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_bias_relu_kernel(const uint4* y, const void* __restrict__ bias,
                          int bias_bf16, uint4* out, uint32_t n_vecs,
                          uint32_t cv) {
  constexpr int N = Vec<T>::kN;
  const uint32_t stride = gridDim.x * kThreads;
  uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  const int c0 = static_cast<int>(i % cv) * N;
  float b[N];
#pragma unroll
  for (int k = 0; k < N; ++k) b[k] = bias_at(bias, bias_bf16, c0 + k);
  for (; i < n_vecs; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t j = i + u * stride;
      if (j < n_vecs) v[u] = y[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t j = i + u * stride;
      if (j < n_vecs) {
        float f[N];
        Vec<T>::load(v[u], f);
#pragma unroll
        for (int k = 0; k < N; ++k) f[k] = relu(f[k] + b[k]);
        out[j] = Vec<T>::store(f);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_bias_relu_pool_kernel(const uint4* __restrict__ y,
                               const void* __restrict__ bias,
                               int bias_bf16, uint4* __restrict__ out,
                               uint32_t n_vecs,
                               uint32_t cv, int H, int W, int Ho, int Wo) {
  constexpr int N = Vec<T>::kN;
  const uint32_t stride = gridDim.x * kThreads;
  uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t c = i % cv;
  float b[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    b[k] = bias_at(bias, bias_bf16, static_cast<int>(c) * N + k);
  const size_t row = static_cast<size_t>(W) * cv;  // vectors an input row
  for (; i < n_vecs; i += stride) {
    const uint32_t p = i / cv;  // output pixel
    const uint32_t wo = p % Wo, t = p / Wo;
    const uint32_t ho = t % Ho, n = t / Ho;
    const size_t at =
        ((static_cast<size_t>(n) * H + 2 * ho) * W + 2 * wo) * cv + c;
    const uint4 v00 = y[at], v01 = y[at + cv];
    const uint4 v10 = y[at + row], v11 = y[at + row + cv];
    float m[N], f[N];
    Vec<T>::load(v00, m);
    Vec<T>::load(v01, f);
#pragma unroll
    for (int k = 0; k < N; ++k) m[k] = pool_max(m[k], f[k]);
    Vec<T>::load(v10, f);
#pragma unroll
    for (int k = 0; k < N; ++k) m[k] = pool_max(m[k], f[k]);
    Vec<T>::load(v11, f);
#pragma unroll
    for (int k = 0; k < N; ++k) m[k] = relu(pool_max(m[k], f[k]) + b[k]);
    out[i] = Vec<T>::store(m);
  }
}

// the blocks of ``kernel`` the card holds at once, cached by device
template <typename K>
cudaError_t resident_blocks(K kernel, int* blocks) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    if (sms * per_sm <= 0) return cudaErrorInvalidConfiguration;
    cached[dev] = sms * per_sm;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

template <typename T>
int launch(const void* y, const void* bias, int bias_bf16, void* out, int B,
           int H, int W, int C, int pool, cudaStream_t stream) {
  constexpr int N = Vec<T>::kN;
  if (C <= 0 || C % N != 0 || kThreads % (C / N) != 0)
    return cudaErrorInvalidValue;
  const uint32_t cv = C / N;
  const int Ho = pool ? H / 2 : H, Wo = pool ? W / 2 : W;
  const uint64_t n = static_cast<uint64_t>(B) * Ho * Wo * cv;
  if (n >= (1ull << 31)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto y4 = static_cast<const uint4*>(y);
  const auto out4 = static_cast<uint4*>(out);
  const int need = static_cast<int>((n + kThreads - 1) / kThreads);
  int most = 0;
  cudaError_t err;
  if (pool) {
    err = resident_blocks(conv_bias_relu_pool_kernel<T>, &most);
    if (err != cudaSuccess) return err;
    conv_bias_relu_pool_kernel<T><<<need < most ? need : most, kThreads, 0,
                                    stream>>>(
        y4, bias, bias_bf16, out4, static_cast<uint32_t>(n), cv, H, W, Ho,
        Wo);
  } else {
    err = resident_blocks(conv_bias_relu_kernel<T>, &most);
    if (err != cudaSuccess) return err;
    conv_bias_relu_kernel<T><<<need < most ? need : most, kThreads, 0,
                               stream>>>(y4, bias, bias_bf16, out4,
                                         static_cast<uint32_t>(n), cv);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sgg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y (B, H, W, C) and out (B, H/2, W/2, C) with pool, else (B, H, W, C)
// (out may be y), both 16-byte aligned, in the type ``dtype`` names
// (0 f32, 1 bf16); bias (C,) in the type ``bias_dtype`` names. C / (16
// bytes / element size) must divide 256.
int sgg_conv_epilogue(const void* y, const void* bias, void* out, int B,
                      int H, int W, int C, int dtype, int bias_dtype,
                      int pool, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (bias_dtype != 0 && bias_dtype != 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(y, bias, bias_dtype, out, B, H, W, C, pool, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(y, bias, bias_dtype, out, B, H, W, C, pool,
                                 s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
