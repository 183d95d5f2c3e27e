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
// elements: 2 x 134.6 MB in bf16 at 3 x 592 x 592, 0.082 ms at 3.35 TB/s).
// The arithmetic is a GEMM, grad (64 x 32) = gm^T (64 x N) . P (N x 32)
// over the N = B * H * W pixels, where P's columns are the 27 patch taps in
// (dy, dx, c) order, a constant 1 (the bias) and 4 zeros: 4.3 GFLOP, which
// the tensor cores do in 0.004 ms and the CUDA cores in 0.06 ms.
//
// Two routes, chosen by the inputs' type inside the one entry point; the
// wrapper names them in its launch counter:
//  - "bf16-mma" (bf16 inputs): the GEMM on the tensor cores, mma.sync
//    m16n8k16 bf16 x bf16 -> f32. gm is exact in bf16 and each product is
//    exact in f32, so only the order of the f32 sums differs from the plain
//    version. A fixed, persistent grid (2 blocks an SM, chosen by the
//    wrapper); block k takes the tiles k, k + grid, ... of 128 pixels in
//    the flattened (b, y, x) order, so a tile of g and of out is 16 KB of
//    contiguous memory:
//      * g and out reach shared memory by cp.async, 16 bytes a thread and
//        chunk, three stages deep (two tiles in flight while one is
//        multiplied), rows XOR-swizzled by 16-byte chunk so that ldmatrix
//        reads 8 pixels' rows on distinct banks; a ragged tile is
//        zero-filled by the copy itself; the same copy group brings the
//        three image row segments (130 pixels each) that the tile's
//        patches read;
//      * the A operand (gm^T, M = 64 channels, K = pixels) comes from
//        ldmatrix.trans of g and of out, masked in registers (a bf16 word
//        of out in [1, 0x7f80] is > 0, so g passes);
//      * the B operand (P, K = pixels, N = 32) is built per tile in shared
//        memory as P^T (tap rows of 128 pixels, padded to 136 so ldmatrix
//        rows fall on distinct banks) from the staged row segments, each
//        thread 14 taps of one pixel (zero outside the image and past the
//        last pixel);
//      * warp w multiplies channels 16 (w % 4) .. + 15 over pixels
//        64 (w / 4) .. + 63 of a tile: 4 k-steps x 4 n-tiles; its tile sum
//        starts at zero and is added into the warp's running f32 sums once
//        a tile, so the tensor cores' own adder sums at most 64 products;
//      * at the end the two warps of a channel group are added in a fixed
//        order in shared memory and the block writes one 28 x 64 partial.
//  - "f32" (f32 inputs): exact f32 FMAs on the CUDA cores, as the forward
//    keeps f32 (the card-vs-CPU f32 checks take it). A fixed grid of blocks
//    of 256 threads; block k takes the row segments k, k + grid, ... (32
//    pixels of one image row), stages gm (f32) and the 3 x 34 x 3 image
//    halo in shared memory; thread (o, j) owns output channel o and 7 of
//    the 28 taps and keeps their sums in registers; the block then writes
//    its 28 x 64 partial sums once.
// Then one thread per (tap, o) sums the blocks' partials in block order.
// No pass uses atomics, so two runs give the same bits. Times on the card
// against the bound and cuDNN's weight gradient: PERF.md (chip_smoke.py
// phase 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCout = 64;
constexpr int kTaps = 28;        // 27 weights + the bias

// ---- f32 route ----------------------------------------------------------
constexpr int kTapsPerThread = 7;  // kTaps / (kThreads / kCout)
constexpr int kTW = 32;          // pixels a segment

__global__ void __launch_bounds__(kThreads)
    vgg_conv1_bwd_f32(const float* __restrict__ x,
                      const float* __restrict__ out,
                      const float* __restrict__ g,
                      float* __restrict__ partials, int B, int H, int W) {
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
        v = out[i] > 0.0f ? g[i] : 0.0f;
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
        v = x[((static_cast<size_t>(b) * H + yy) * W + xx) * 3 + c];
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

// ---- bf16-mma route -----------------------------------------------------
constexpr int kTP = 128;                  // pixels a tile
constexpr int kStages = 3;
constexpr int kTileBytes = kTP * kCout * 2;     // one tensor's tile: 16 KB
// The images' three row segments a tile's patches read: pixels n0 + (dy - 1)
// W - 1 .. + kTP + 1 for dy = 0, 1, 2, from an even element on, in 4-byte
// pieces.
constexpr int kSegPieces = (3 * (kTP + 2) + 2) / 2;  // 196
constexpr int kSegBytes = 800;                       // a segment, padded
constexpr int kStageBytes = 2 * kTileBytes + 3 * kSegBytes;  // g, out, x
constexpr int kPRows = 32;                // 27 taps, the bias's 1, 4 zeros
constexpr int kPRow = kTP + 8;            // elements a P^T row (272 bytes)
constexpr int kTapsPerPixel = 14;         // a thread's share of 28 rows
constexpr int kMmaSmem = kStages * kStageBytes + kPRows * kPRow * 2;
constexpr unsigned short kBf16One = 0x3f80;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) where !pred.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr,
                                              unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col).
__device__ __forceinline__ void mma_k16(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Both bf16 halves of g where the matching half of out is > 0 (bits in
// [1, 0x7f80]: positive, finite or +inf, not NaN), else 0: the ReLU's mask.
__device__ __forceinline__ unsigned relu_mask(unsigned g, unsigned out) {
  return g & __vcmpleu2(__vsub2(out, 0x00010001u), 0x7f7f7f7fu);
}

// 4 bytes global -> shared, of which the first `bytes` (0, 2 or 4) are
// read and the rest zero-filled.
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// First element of row segment dy of the tile at pixel n0, rounded down to
// an even element (a 4-byte piece).
__device__ __forceinline__ long long seg_start(unsigned n0, int dy, int W) {
  const long long e = (static_cast<long long>(n0) + (dy - 1) * W - 1) * 3;
  return e - (e & 1);
}

// Copy tile `tile`'s g and out (16 KB each) and its three image row
// segments into a stage, as one group: g and out in 8 chunks of 16 bytes a
// thread, chunk c of pixel row r stored at chunk c ^ (r & 7), zero past
// pixel n_px; the segments in 4-byte pieces, zero outside the images. The
// loops are not unrolled: unrolled, the offsets they hoist out of the tile
// loop spill.
__device__ __forceinline__ void issue_tile(unsigned stage,
                                           const unsigned short* x,
                                           const __nv_bfloat16* g,
                                           const __nv_bfloat16* out,
                                           unsigned tile, unsigned n_px,
                                           int W) {
  const size_t base = static_cast<size_t>(tile) * kTP * kCout;
#pragma unroll 1
  for (int i = 0; i < 2 * kTP * 8 / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int tensor = e / (kTP * 8);  // 0: g, 1: out
    const int px = (e / 8) % kTP, chunk = e % 8;
    const bool ok = tile * kTP + px < n_px;
    const __nv_bfloat16* src =
        (tensor ? out : g) + (ok ? base + px * kCout + chunk * 8 : 0);
    cp_async16(stage + tensor * kTileBytes + px * 128 +
                   ((chunk ^ (px & 7)) << 4),
               src, ok);
  }
  const long long n_el = 3LL * n_px;
#pragma unroll 1
  for (int i = threadIdx.x; i < 3 * kSegPieces; i += kThreads) {
    const int dy = i / kSegPieces, k = i % kSegPieces;
    const long long e = seg_start(tile * kTP, dy, W) + 2 * k;
    const int bytes = e < 0 || e >= n_el ? 0 : (e + 1 < n_el ? 4 : 2);
    cp_async4(stage + 2 * kTileBytes + dy * kSegBytes + 4 * k,
              x + (bytes ? e : 0), bytes);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// This thread's 14 rows of P^T for pixel p = threadIdx.x % kTP of the tile
// at pixel n0, from the stage's row segments: taps 14 h .. 14 h + 13 (h =
// threadIdx.x / kTP; tap 27 is the bias's 1), zero outside the image.
__device__ __forceinline__ void build_patch(const unsigned short* seg,
                                            unsigned short* s_pt,
                                            unsigned n0, unsigned n_px,
                                            int H, int W) {
  const int p = threadIdx.x % kTP, h = threadIdx.x / kTP;
  const unsigned n = n0 + p;
  const bool valid = n < n_px;
  const unsigned rem = valid ? n % (static_cast<unsigned>(H) * W) : 0;
  const int y = static_cast<int>(rem / W);
  const int xx = static_cast<int>(rem) - y * W;
#pragma unroll
  for (int i = 0; i < kTapsPerPixel; ++i) {
    const int k = h * kTapsPerPixel + i;
    unsigned short v = 0;
    if (k == 27) {
      v = valid ? kBf16One : 0;
    } else {
      const int dy = k / 9, dx = (k / 3) % 3, c = k % 3;
      const int yy = y + dy - 1, xc = xx + dx - 1;
      // element (n0 + (dy - 1) W - 1 + p + dx) * 3 + c of the images
      const long long e0 =
          (static_cast<long long>(n0) + (dy - 1) * W - 1) * 3;
      if (valid && yy >= 0 && yy < H && xc >= 0 && xc < W)
        v = seg[dy * (kSegBytes / 2) + static_cast<int>(e0 & 1) +
                (p + dx) * 3 + c];
    }
    s_pt[k * kPRow + p] = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    vgg_conv1_bwd_mma(const unsigned short* __restrict__ x,
                      const __nv_bfloat16* __restrict__ out,
                      const __nv_bfloat16* __restrict__ g,
                      float* __restrict__ partials, int H, int W,
                      unsigned n_px) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned short* s_pt =
      reinterpret_cast<unsigned short*>(smem + kStages * kStageBytes);
  const unsigned stage0 = smem_addr(smem);
  const unsigned pt0 = smem_addr(s_pt);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = warp & 3;          // channels 16 mt .. 16 mt + 15
  const int px0 = (warp >> 2) * 64;  // pixels px0 .. px0 + 63 of a tile
  const int lj = lane >> 3, lr = lane & 7;  // ldmatrix: matrix, row

  for (int i = threadIdx.x; i < (kPRows - 28) * kPRow; i += kThreads)
    s_pt[28 * kPRow + i] = 0;  // the zero rows, never written again

  const unsigned tiles = (n_px + kTP - 1) / kTP;
  const unsigned step = gridDim.x;
  unsigned tile = blockIdx.x;
  issue_tile(stage0, x, g, out, tile, n_px, W);
  issue_tile(stage0 + kStageBytes, x, g, out, tile + step, n_px, W);

  float run[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) run[nt][i] = 0.0f;

  for (int j = 0; tile < tiles; ++j, tile += step) {
    // the stage of tile j + 2 was read by tile j - 1, behind the barrier
    issue_tile(stage0 + ((j + 2) % kStages) * kStageBytes, x, g, out,
               tile + 2 * step, n_px, W);
    asm volatile("cp.async.wait_group 2;\n" ::);  // tile j has landed
    __syncthreads();
    build_patch(reinterpret_cast<const unsigned short*>(
                    smem + (j % kStages) * kStageBytes + 2 * kTileBytes),
                s_pt, tile * kTP, n_px, H, W);
    __syncthreads();

    const unsigned st = stage0 + (j % kStages) * kStageBytes;
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
#pragma unroll 1
    for (int ks = 0; ks < 4; ++ks) {  // not unrolled: fewer live fragments
      const int k0 = px0 + ks * 16;
      // A = gm^T: matrix lj holds pixels k0 + 8 (lj / 2) + row, channels
      // 16 mt + 8 (lj % 2) .. + 7, transposed
      const int apx = k0 + 8 * (lj >> 1) + lr;
      const unsigned a_off =
          apx * 128 + (((2 * mt + (lj & 1)) ^ (apx & 7)) << 4);
      unsigned ag[4], ao[4], a[4];
      ldsm_x4_trans(st + a_off, ag);
      ldsm_x4_trans(st + kTileBytes + a_off, ao);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = relu_mask(ag[i], ao[i]);
      // B = P: matrix lj holds taps 8 (2 q + lj / 2) + row, pixels
      // k0 + 8 (lj % 2) .. + 7, from P^T
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        unsigned b[4];
        ldsm_x4(pt0 + ((8 * (2 * q + (lj >> 1)) + lr) * kPRow + k0 +
                       8 * (lj & 1)) * 2,
                b);
        mma_k16(acc[2 * q], a, b[0], b[1]);
        mma_k16(acc[2 * q + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) run[nt][i] += acc[nt][i];
    __syncthreads();  // stage j % 3 and P^T are free again
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // empty groups only
  __syncthreads();

  // warp sums -> shared memory (over the stages), then the two warps of a
  // channel group in a fixed order: red[warp][lane][nt * 4 + i]
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(warp * 32 + lane) * 16 + nt * 4 + i] = run[nt][i];
  __syncthreads();
  float* dst = partials + static_cast<size_t>(blockIdx.x) * kTaps * kCout;
  for (int e = threadIdx.x; e < kTaps * kCout; e += kThreads) {
    const int k = e / kCout, o = e % kCout;
    // accumulator element i of lane (gq, t): channel 16 mt + gq + 8 (i / 2),
    // tap 8 nt + 2 t + i % 2
    const int m = o / 16, ol = o % 16;
    const int ln = (ol & 7) * 4 + (k % 8) / 2;
    const int idx = (k / 8) * 4 + (ol >> 3) * 2 + (k & 1);
    dst[e] = red[(m * 32 + ln) * 16 + idx] +
             red[((m + 4) * 32 + ln) * 16 + idx];
  }
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

int reduce(const float* partials, float* grad, int blocks, cudaStream_t s) {
  vgg_conv1_bwd_reduce<<<(kTaps * kCout + kThreads - 1) / kThreads, kThreads,
                         0, s>>>(partials, grad, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* sgg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, H, W, 3), out and g (B, H, W, 64), all of type dtype (0 = float32:
// the "f32" route; 1 = bfloat16: the "bf16-mma" route, out and g 16-byte
// aligned); partials: blocks x 28 x 64 f32 scratch; grad: 28 x 64 f32,
// rows 0..26 grad_w in (dy, dx, c) order, row 27 grad_b.
int sgg_vgg_conv1_bwd(const void* x, const void* out, const void* g,
                      float* partials, float* grad, int B, int H, int W,
                      int blocks, int dtype, void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(g)) %
            16 ||
        reinterpret_cast<uintptr_t>(x) % 4)
      return static_cast<int>(cudaErrorMisalignedAddress);
    const long long n_px = static_cast<long long>(B) * H * W;
    if (n_px > 0x7fffff00LL) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        vgg_conv1_bwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMmaSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    vgg_conv1_bwd_mma<<<blocks, kThreads, kMmaSmem, s>>>(
        static_cast<const unsigned short*>(x),
        static_cast<const __nv_bfloat16*>(out),
        static_cast<const __nv_bfloat16*>(g), partials, H, W,
        static_cast<unsigned>(n_px));
  } else {
    vgg_conv1_bwd_f32<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(out),
        static_cast<const float*>(g), partials, B, H, W);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(partials, grad, blocks, s);
}

}  // extern "C"
