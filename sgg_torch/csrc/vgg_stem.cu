// VGG16 conv1_1 for Hopper (sm_90a): relu(conv3x3(x, w, pad=1) + b),
// 3 -> 64 channels, channels-last in and out.
//
// Replaces the TPU kernel sgg_tpu/ops/vgg_stem_pallas.py:vgg_conv1_pallas
// (Pallas body `_stem_kernel`), which built a 27-wide patch tensor in VMEM
// per row tile and ran one (rows*W, 27) @ (27, 64) product. Unlike it, any
// H and W work here: the image edge and the ragged last tile are masked.
//
// Layout: x (B, H, W, 3), w (3, 3, 3, 64) HWIO flattened to (27, 64) in
// (dy, dx, c) order as f32, b (64,) f32, out (B, H, W, 64) in x's type:
// the channels-last layout that the next convolution takes without a copy.
//
// What bounds it on an H100: per 16-image batch at 592x592 in bf16 it reads
// ~34 MB and writes ~718 MB against ~19 GFLOP, so the output write bounds
// it (~0.21 ms at 3.35 TB/s) if its arithmetic ran at the tensor-core bf16
// rate. This kernel does its arithmetic as f32 FMAs on the CUDA cores
// (67 TFLOP/s peak, ~0.29 ms for 19 GFLOP), which is simple and exact to
// f32 but leaves it above the byte bound; a tensor-core (mma/wgmma) version
// is later work.
//
// Design: one block per 8 x 32 output tile of one image. The block stages
// the (8+2) x (32+2) x 3 input halo in shared memory as f32 (zero outside
// the image). Each thread owns one channel pair for the whole tile and keeps
// its 2 x 27 weights and 2 biases in registers; a warp computes one pixel at
// a time (64 channels, the 27 inputs read as shared-memory broadcasts) and
// writes the pixel's 64 outputs as one contiguous 128-byte (bf16) or
// 256-byte (f32) store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kThreads = 256;  // 8 warps x 32 channel pairs
constexpr int kCout = 64;
constexpr int kTaps = 27;

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

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    vgg_conv1_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int H, int W) {
  constexpr int kHaloW = kTileW + 2;
  constexpr int kTileElems = (kTileH + 2) * kHaloW * 3;
  __shared__ float tile[kTileElems];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const T* xb = x + static_cast<size_t>(b) * H * W * 3;
  for (int i = threadIdx.x; i < kTileElems; i += kThreads) {
    const int ch = i % 3;
    const int pix = i / 3;
    const int gy = y0 + pix / kHaloW - 1;
    const int gx = x0 + pix % kHaloW - 1;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = load_f(xb + (static_cast<size_t>(gy) * W + gx) * 3 + ch);
    tile[i] = v;
  }

  const int co = 2 * (threadIdx.x & 31);
  const int warp = threadIdx.x >> 5;
  float w0[kTaps], w1[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    w0[k] = __ldg(w + k * kCout + co);
    w1[k] = __ldg(w + k * kCout + co + 1);
  }
  const float b0 = __ldg(bias + co), b1 = __ldg(bias + co + 1);
  __syncthreads();

  for (int pix = warp; pix < kTileH * kTileW; pix += kThreads / 32) {
    const int ty = pix / kTileW, tx = pix % kTileW;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= H || gx >= W) continue;  // warp-uniform
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* src = tile + ((ty + dy) * kHaloW + tx + dx) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int k = (dy * 3 + dx) * 3 + c;
          a0 = fmaf(src[c], w0[k], a0);
          a1 = fmaf(src[c], w1[k], a1);
        }
      }
    }
    T* dst = out + ((static_cast<size_t>(b) * H + gy) * W + gx) * kCout + co;
    store_pair(dst, fmaxf(a0 + b0, 0.0f), fmaxf(a1 + b1, 0.0f));
  }
}

}  // namespace

extern "C" {

const char* sgg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (x and out); w and b are float32.
int sgg_vgg_conv1(const void* x, const void* w, const void* b, void* out,
                  int B, int H, int W, int dtype, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    vgg_conv1_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), H, W);
  } else {
    vgg_conv1_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(out), H, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
