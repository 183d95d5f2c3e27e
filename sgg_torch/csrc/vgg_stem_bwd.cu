// VGG16 conv1_1 backward for Hopper (sm_90a): the weight and bias
// gradients of relu(conv3x3(x, w, pad 1) + b), 3 -> 64, channels-last.
//
// Replaces the gradient of the TPU kernel sgg_tpu/ops/vgg_stem_pallas.py:
// vgg_conv1_pallas (which has no VJP: the JAX trunk trains an XLA nn.Conv,
// and XLA differentiates it), for the port's forward kernel csrc/vgg_stem.cu.
//
//   gm[b, y, x, o] = g[b, y, x, o] * [out[b, y, x, o] > 0]   (the ReLU)
//   grad_w[dy, dx, c, o] = sum_{b, y, x} x[b, y + dy - 1, x + dx - 1, c] gm
//   grad_b[o] = sum_{b, y, x} gm[b, y, x, o]
// in f32 whatever the inputs' type (float32 or bfloat16; x, out and g share
// it). The images get no gradient.
//
// What bounds it on an H100: reading g and out once (2 x B x H x W x 64
// elements: 2 x 134.6 MB in bf16 at 3 x 592 x 592) and the images; 2 x 28
// flops an element of g on the CUDA cores (55 flops a byte of bf16 read).
//
// Design, deterministic in two passes:
//  1. a fixed grid of blocks of 256 threads; block k takes the row segments
//     k, k + grid, ... (a segment: TW pixels of one image row). Per segment
//     the block stages gm (TW x 64, f32) and the 3 x (TW + 2) x 3 image
//     halo in shared memory. Thread (o, j) owns output channel o and 7 of
//     the 28 "taps" (27 weights and the bias, whose patch value is 1) and
//     keeps their sums in registers over all its segments; the block then
//     writes its 28 x 64 partial sums once.
//  2. one thread per (tap, o) sums the blocks' partials in block order.
// Neither pass uses atomics, so the result does not vary from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kCout = 64;
constexpr int kTaps = 28;        // 27 weights + the bias
constexpr int kTapsPerThread = 7;  // kTaps / (kThreads / kCout)
constexpr int kTW = 32;          // pixels a segment

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    vgg_conv1_bwd_partials(const T* __restrict__ x, const T* __restrict__ out,
                           const T* __restrict__ g,
                           float* __restrict__ partials, int B, int H,
                           int W) {
  __shared__ float s_gm[kTW * kCout];
  // image halo rows y-1 .. y+1, columns x0-1 .. x0+kTW, channels, and one
  // constant 1 (the bias tap's patch value) at the end
  __shared__ float s_img[3 * (kTW + 2) * 3 + 1];

  const int t = threadIdx.x;
  const int o = t % kCout;
  const int j = t / kCout;  // tap group 0..3
  // offset of each tap's patch value for pixel 0, and its stride a pixel
  int off[kTapsPerThread], stride[kTapsPerThread];
#pragma unroll
  for (int k = 0; k < kTapsPerThread; ++k) {
    const int tap = j * kTapsPerThread + k;
    if (tap < 27) {
      const int dy = tap / 9, dx = (tap / 3) % 3, c = tap % 3;
      off[k] = (dy * (kTW + 2) + dx) * 3 + c;
      stride[k] = 3;
    } else {
      off[k] = 3 * (kTW + 2) * 3;
      stride[k] = 0;
    }
  }
  float acc[kTapsPerThread];
#pragma unroll
  for (int k = 0; k < kTapsPerThread; ++k) acc[k] = 0.0f;
  if (t == 0) s_img[3 * (kTW + 2) * 3] = 1.0f;

  const int seg_w = (W + kTW - 1) / kTW;
  const long long n_seg = static_cast<long long>(B) * H * seg_w;
  for (long long seg = blockIdx.x; seg < n_seg; seg += gridDim.x) {
    const int sx = static_cast<int>(seg % seg_w);
    const long long by = seg / seg_w;
    const int y = static_cast<int>(by % H);
    const int b = static_cast<int>(by / H);
    const int x0 = sx * kTW;
    const int npx = min(kTW, W - x0);
    __syncthreads();  // the previous segment's reads are done
    const size_t pix0 = (static_cast<size_t>(b) * H + y) * W + x0;
    for (int e = t; e < kTW * kCout; e += kThreads) {
      const int px = e / kCout;
      float v = 0.0f;
      if (px < npx) {
        const size_t i = pix0 * kCout + e;
        v = to_f32(out[i]) > 0.0f ? to_f32(g[i]) : 0.0f;
      }
      s_gm[e] = v;
    }
    for (int e = t; e < 3 * (kTW + 2) * 3; e += kThreads) {
      const int c = e % 3;
      const int col = (e / 3) % (kTW + 2);
      const int r = e / (3 * (kTW + 2));
      const int yy = y + r - 1, xx = x0 + col - 1;
      float v = 0.0f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = to_f32(x[((static_cast<size_t>(b) * H + yy) * W + xx) * 3 + c]);
      s_img[e] = v;
    }
    __syncthreads();
    for (int px = 0; px < npx; ++px) {
      const float gv = s_gm[px * kCout + o];
#pragma unroll
      for (int k = 0; k < kTapsPerThread; ++k)
        acc[k] = fmaf(s_img[off[k] + px * stride[k]], gv, acc[k]);
    }
  }
  float* dst = partials + static_cast<size_t>(blockIdx.x) * kTaps * kCout;
#pragma unroll
  for (int k = 0; k < kTapsPerThread; ++k)
    dst[(j * kTapsPerThread + k) * kCout + o] = acc[k];
}

__global__ void vgg_conv1_bwd_reduce(const float* __restrict__ partials,
                                     float* __restrict__ grad, int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kTaps * kCout) return;
  float s = 0.0f;
  for (int k = 0; k < blocks; ++k)
    s += partials[static_cast<size_t>(k) * kTaps * kCout + i];
  grad[i] = s;
}

template <typename T>
int launch(const void* x, const void* out, const void* g, float* partials,
           float* grad, int B, int H, int W, int blocks, cudaStream_t s) {
  vgg_conv1_bwd_partials<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(out),
      static_cast<const T*>(g), partials, B, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vgg_conv1_bwd_reduce<<<(kTaps * kCout + kThreads - 1) / kThreads, kThreads,
                         0, s>>>(partials, grad, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* sgg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, H, W, 3), out and g (B, H, W, 64), all of type dtype (0 = float32,
// 1 = bfloat16); partials: blocks x 28 x 64 f32 scratch; grad: 28 x 64 f32,
// rows 0..26 grad_w in (dy, dx, c) order, row 27 grad_b.
int sgg_vgg_conv1_bwd(const void* x, const void* out, const void* g,
                      float* partials, float* grad, int B, int H, int W,
                      int blocks, int dtype, void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, out, g, partials, grad, B, H, W, blocks,
                                 s);
  return launch<float>(x, out, g, partials, grad, B, H, W, blocks, s);
}

}  // extern "C"
