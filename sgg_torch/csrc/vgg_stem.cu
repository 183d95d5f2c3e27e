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
// Two routes, chosen by the input type inside the one entry point; neither
// gives way to the other:
//  - bf16 x: the weights are rounded to bf16 (nearest even) on load and the
//    product runs on the tensor cores, bf16 x bf16 with f32 accumulation
//    (mma.sync m16n8k16 and m16n8k8); the bias stays f32. This is the
//    rounding of the JAX package's bf16 convolution and of the plain
//    version.
//  - f32 x: exact f32 fused multiply-adds on the CUDA cores, no TF32.
//
// What bounds it on an H100: per 16-image batch at 592x592 in bf16 it reads
// ~34 MB and writes ~718 MB against ~19 GFLOP, so the output write bounds
// it (~0.22 ms at 3.35 TB/s) as long as the product runs at the tensor
// cores' rate; as f32 FMAs on the CUDA cores the arithmetic alone is above
// that (~0.29 ms at 67 TFLOP/s).
//
// Design of the bf16 route: a persistent grid, two blocks of 8 warps per
// SM, each block striding over the 8 x 32 pixel output tiles of the batch.
//  - The (8+2) x (32+2) halo of a tile is staged in shared memory as bf16,
//    4 elements a pixel (3 channels and a zero), zero outside the image.
//    A thread keeps its share of the halos of the next two tiles in
//    registers, loaded two tiles ahead, and the two halo buffers alternate,
//    so a tile costs one barrier and no wait for its input.
//  - The product is (pixels, 36 -> 40) x (40, 64) with K index
//    dy * 12 + dx * 4 + c. A warp owns one tile row (32 pixels = two m16
//    tiles). The 12 K indices of a dy are 24 contiguous, 4-byte aligned
//    bytes of the halo, so a lane reads each A fragment register as one
//    32-bit word straight from the halo: 10 reads an m16 tile, two k16
//    steps and a k8 tail (m16n8k8). The B fragments of all 8 n-tiles stay
//    in registers for the block's whole life.
//  - The columns of B are dealt to the output channels so that a lane's
//    accumulators of n-tiles 4s .. 4s+3 are 8 adjacent channels: the
//    epilogue (accumulators start from the f32 bias; ReLU; round to bf16)
//    stays in registers and ends in 16-byte streaming stores, two a pixel
//    and lane, 64 contiguous bytes a pixel and store, with no
//    exchange between lanes and no staging in shared memory.
// The write bounds it: PyTorch's fill of the output's bytes takes 0.22 ms on
// an H100 80GB HBM3 at 700 W, this kernel 0.28 ms. With the stores cut out
// it takes 0.15 ms; with its input served from L2 0.24 ms: the 34 MB of
// input reads cost 0.04 ms because they reach the memory in the middle of
// the write stream (PERF.md).
// Design of the f32 route: one block per 8 x 32 tile, the halo staged as
// f32; each thread owns one channel pair with its 2 x 27 weights in
// registers, a warp computes one pixel at a time (the 27 inputs read as
// shared-memory broadcasts) and writes its 64 outputs as one 256-byte store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kThreads = 256;  // 8 warps
constexpr int kCout = 64;
constexpr int kTaps = 27;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloRow = kHaloW * 3;                 // elements a halo row
constexpr int kHaloElems = (kTileH + 2) * kHaloRow;  // 1020
constexpr int kPrefetch = (kHaloElems + kThreads - 1) / kThreads;
// bf16 route: a staged pixel is 4 elements (3 channels and a zero), so that
// tap k of the product sits at K index dy * 12 + dx * 4 + c: 36 of 40 used.
constexpr int kPix = 4;
constexpr int kStagedRow = kHaloW * kPix;                // elements
constexpr int kStagedElems = (kTileH + 2) * kStagedRow;  // 1360
constexpr int kKUsed = 36;

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col).
__device__ __forceinline__ void mma_k16(float (&d)[4], const unsigned (&a)[4],
                                        const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D (16x8, f32) += A (16x8, bf16, row) * B (8x8, bf16, col).
__device__ __forceinline__ void mma_k8(float (&d)[4], const unsigned (&a)[2],
                                       unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Offset of tap k = (dy * 3 + dx) * 3 + c from a pixel's f32 halo base.
__device__ __forceinline__ int tap_offset(int k) {
  return (k / 9) * kHaloRow + k % 9;
}

// Weight of K index kk = dy * 12 + dx * 4 + c for output channel ch; the
// pad channel c = 3 and kk >= 36 are zero.
__device__ __forceinline__ float weight_at(const float* __restrict__ w,
                                           int kk, int ch) {
  const int r = kk % 12;
  if (kk >= kKUsed || r % 4 == 3) return 0.0f;
  return __ldg(w + ((kk / 12 * 3 + r / 4) * 3 + r % 4) * kCout + ch);
}

// 32-bit word of the staged halo that holds K indices kk, kk + 1 (kk even),
// from a pixel's word base.
__device__ __forceinline__ int word_offset(int kk) {
  return (kk / 12) * (kStagedRow / 2) + (kk % 12) / 2;
}

// Output channel of column j of n-tile nt. The columns are dealt so that a
// lane's accumulators (columns 2 * tig + {0, 1} of every n-tile) are the
// 8 adjacent channels 32 * s + 8 * tig .. + 7 for n-tiles 4 * s .. 4 * s + 3:
// one 16-byte store each, with no exchange between lanes.
__device__ __forceinline__ int channel_of(int nt, int j) {
  return 32 * (nt / 4) + 8 * (j / 2) + 2 * (nt % 4) + j % 2;
}

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile decode_tile(int tile, int tiles_x,
                                            int tiles_y) {
  Tile t;
  t.x0 = (tile % tiles_x) * kTileW;
  const int rest = tile / tiles_x;
  t.y0 = (rest % tiles_y) * kTileH;
  t.b = rest / tiles_y;
  return t;
}

// This thread's share of a tile's halo, as bf16 bits, zero outside the image.
__device__ __forceinline__ void load_halo(const unsigned short* __restrict__ x,
                                          Tile t, int H, int W,
                                          unsigned short (&pre)[kPrefetch]) {
  const unsigned short* xb = x + static_cast<size_t>(t.b) * H * W * 3;
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int gy = t.y0 + i / kHaloRow - 1;
    const int ge = (t.x0 - 1) * 3 + i % kHaloRow;  // element within the row
    unsigned short v = 0;
    if (i < kHaloElems && gy >= 0 && gy < H && ge >= 0 && ge < W * 3)
      v = __ldg(xb + static_cast<size_t>(gy) * W * 3 + ge);
    pre[j] = v;
  }
}

__device__ __forceinline__ unsigned relu_pack(float a, float b) {
  return pack_bf16x2(fmaxf(a, 0.0f), fmaxf(b, 0.0f));
}

__global__ void __launch_bounds__(kThreads, 2)
    vgg_conv1_bf16_kernel(const unsigned short* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, int H, int W,
                          int tiles_x, int tiles_y, int total_tiles) {
  __shared__ __align__(16) unsigned short halo[2][kStagedElems];
  __shared__ __align__(16) float s_bias[4][16];  // a lane's 16, by tig

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;    // fragment row (pixel) / B column
  const int tig = lane & 3;   // fragment column pair

  unsigned short* halo_flat = &halo[0][0];  // both buffers, end to end
  for (int i = threadIdx.x; i < 2 * kStagedElems; i += kThreads)
    halo_flat[i] = 0;
  if (threadIdx.x < kCout) {
    const int idx = threadIdx.x % 16;  // (nt, i) of lane tig = threadIdx.x / 16
    s_bias[threadIdx.x / 16][idx] = __ldg(
        bias + channel_of(idx / 2, 2 * (threadIdx.x / 16) + idx % 2));
  }

  // B fragments of the (40, 64) weight matrix, kept for the block's life:
  // two k16 steps (rows kk0, kk0 + 1 and + 8) and the k8 tail (rows 32..39).
  unsigned b16[kCout / 8][2][2], b8[kCout / 8];
#pragma unroll
  for (int nt = 0; nt < kCout / 8; ++nt) {
    const int ch = channel_of(nt, g);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kk = ks * 16 + half * 8 + 2 * tig;
        b16[nt][ks][half] =
            pack_bf16x2(weight_at(w, kk, ch), weight_at(w, kk + 1, ch));
      }
    }
    b8[nt] = pack_bf16x2(weight_at(w, 32 + 2 * tig, ch),
                         weight_at(w, 33 + 2 * tig, ch));
  }

  // A fragment words, from a pixel's word base: K indices kk0, kk0 + 1 with
  // kk0 = ks * 16 + half * 8 + 2 * tig, and the tail 32 + 2 * tig (< 36).
  int aoff[2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      aoff[ks][half] = word_offset(ks * 16 + half * 8 + 2 * tig);
  const bool tail_ok = 32 + 2 * tig < kKUsed;
  const int aoff_tail = tail_ok ? word_offset(32 + 2 * tig) : 0;

  const int stride = static_cast<int>(gridDim.x);  // tiles a step

  // One tile: stage the halo that `pre` holds into buffer `buf`, refill
  // `pre` with the halo of the tile two steps ahead, multiply, store. The
  // two halo buffers alternate, so one barrier a tile is enough: a warp
  // that writes buffer `buf` again has passed the next tile's barrier,
  // which every warp reaches only after its reads of `buf`.
  auto step = [&](int tile, int buf, unsigned short (&pre)[kPrefetch]) {
    const Tile t = decode_tile(tile, tiles_x, tiles_y);
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int e = i % kHaloRow;
      if (i < kHaloElems)
        halo[buf][(i / kHaloRow) * kStagedRow + (e / 3) * kPix + e % 3] =
            pre[j];
    }
    __syncthreads();
    if (tile + 2 * stride < total_tiles)
      load_halo(x, decode_tile(tile + 2 * stride, tiles_x, tiles_y), H, W,
                pre);
    const unsigned* halo_w = reinterpret_cast<const unsigned*>(halo[buf]);

    const int gy = t.y0 + warp;  // this warp's tile row
#pragma unroll
    for (int mt = 0; mt < kTileW / 16; ++mt) {
      // pixels mt*16 + g (fragment rows g) and + 8 (rows g + 8)
      const unsigned* p0 =
          halo_w + (warp * kHaloW + mt * 16 + g) * (kPix / 2);
      const unsigned* p1 = p0 + 8 * (kPix / 2);
      unsigned a16[2][4], a8[2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        a16[ks][0] = p0[aoff[ks][0]];
        a16[ks][1] = p1[aoff[ks][0]];
        a16[ks][2] = p0[aoff[ks][1]];
        a16[ks][3] = p1[aoff[ks][1]];
      }
      a8[0] = tail_ok ? p0[aoff_tail] : 0u;
      a8[1] = tail_ok ? p1[aoff_tail] : 0u;

      // acc[nt]: channels channel_of(nt, 2*tig + {0,1}) of pixels g ([0],
      // [1]) and g + 8 ([2], [3]), started from the f32 bias
      float acc[kCout / 8][4];
#pragma unroll
      for (int nt = 0; nt < kCout / 8; nt += 2) {
        const float4 bb =
            *reinterpret_cast<const float4*>(&s_bias[tig][2 * nt]);
        acc[nt][0] = acc[nt][2] = bb.x;
        acc[nt][1] = acc[nt][3] = bb.y;
        acc[nt + 1][0] = acc[nt + 1][2] = bb.z;
        acc[nt + 1][1] = acc[nt + 1][3] = bb.w;
      }
#pragma unroll
      for (int nt = 0; nt < kCout / 8; ++nt) {
        mma_k16(acc[nt], a16[0], b16[nt][0]);
        mma_k16(acc[nt], a16[1], b16[nt][1]);
        mma_k8(acc[nt], a8, b8[nt]);
      }
      // ReLU, round to bf16, and 16 bytes a store: n-tiles 4*s .. 4*s + 3
      // are this lane's channels 32*s + 8*tig .. + 7
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // fragment rows g and g + 8
        const int gx = t.x0 + mt * 16 + g + 8 * r;
        if (gy < H && gx < W) {
          __nv_bfloat16* dst =
              out + ((static_cast<size_t>(t.b) * H + gy) * W + gx) * kCout +
              8 * tig;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const uint4 v = make_uint4(
                relu_pack(acc[4 * s][2 * r], acc[4 * s][2 * r + 1]),
                relu_pack(acc[4 * s + 1][2 * r], acc[4 * s + 1][2 * r + 1]),
                relu_pack(acc[4 * s + 2][2 * r], acc[4 * s + 2][2 * r + 1]),
                relu_pack(acc[4 * s + 3][2 * r], acc[4 * s + 3][2 * r + 1]));
            __stcs(reinterpret_cast<uint4*>(dst + 32 * s), v);
          }
        }
      }
    }
  };

  unsigned short pre_a[kPrefetch], pre_b[kPrefetch];
  int tile = blockIdx.x;
  if (tile < total_tiles)
    load_halo(x, decode_tile(tile, tiles_x, tiles_y), H, W, pre_a);
  if (tile + stride < total_tiles)
    load_halo(x, decode_tile(tile + stride, tiles_x, tiles_y), H, W,
              pre_b);
  __syncthreads();  // the zeroing is done
  while (tile < total_tiles) {
    step(tile, 0, pre_a);
    tile += stride;
    if (tile >= total_tiles) break;
    step(tile, 1, pre_b);
    tile += stride;
  }
}

__global__ void __launch_bounds__(kThreads)
    vgg_conv1_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int H, int W) {
  __shared__ float tile[kHaloElems];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const float* xb = x + static_cast<size_t>(b) * H * W * 3;
  for (int i = threadIdx.x; i < kHaloElems; i += kThreads) {
    const int gy = y0 + i / kHaloRow - 1;
    const int ge = (x0 - 1) * 3 + i % kHaloRow;  // element within the row
    float v = 0.0f;
    if (gy >= 0 && gy < H && ge >= 0 && ge < W * 3)
      v = __ldg(xb + static_cast<size_t>(gy) * W * 3 + ge);
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
    for (int k = 0; k < kTaps; ++k) {
      const float v = tile[(ty * kHaloW + tx) * 3 + tap_offset(k)];
      a0 = fmaf(v, w0[k], a0);
      a1 = fmaf(v, w1[k], a1);
    }
    float* dst =
        out + ((static_cast<size_t>(b) * H + gy) * W + gx) * kCout + co;
    *reinterpret_cast<float2*>(dst) =
        make_float2(fmaxf(a0 + b0, 0.0f), fmaxf(a1 + b1, 0.0f));
  }
}

// The current device's SM count, asked of the runtime once per device: the
// persistent grid is sized on every launch, and the launching thread is
// what the evaluation loop waits for.
cudaError_t sm_count(int* sms) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];  // 0 = not asked yet
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool slot = device >= 0 && device < kMaxDevices;
  if (slot && (*sms = cached[device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && slot)
    cached[device].store(*sms, std::memory_order_relaxed);
  return err;
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
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = static_cast<long long>(B) * tiles_y * tiles_x;
    if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = total < 2LL * sms ? static_cast<int>(total) : 2 * sms;
    vgg_conv1_bf16_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const unsigned short*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), H, W,
        tiles_x, tiles_y, static_cast<int>(total));
  } else {
    const dim3 grid(tiles_x, tiles_y, B);
    vgg_conv1_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(out), H, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
