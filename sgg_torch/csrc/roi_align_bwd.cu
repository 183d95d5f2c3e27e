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
//   detector's training shape) and writing the gradient once, in the map's
//   type. Design: an output-stationary gather, which replaces a scatter of
//   f32 atomics (one block a ROI) into scratch that had to be cleared first
//   and cast after. The map is cut into tiles of kTileH x kTileW cells
//   (ragged at the right and bottom edges). (1) Per ROI and axis, a bit
//   mask of the tiles that hold one of its taps of nonzero weight, and (2)
//   per ROI, axis and map index, the P bins' weights there (the bin average
//   folded in, a bin's taps of equal index merged, as the forward's tables
//   hold them): one launch. (3) One block per (image, tile) tests the ROIs
//   32 a warp (__ballot_sync, __popc) and lists those whose row and column
//   masks both hold the tile, in ascending order, each with the bins that
//   can reach the tile along either axis (np x nq of them: the ROI's
//   "k-rows" there) and a prefix sum of the k-rows. (4) The gather, one
//   unit per (image, tile, channel chunk), images outermost so that one
//   image's g stays in L2 while its tiles run. Every cell is written once,
//   zeros included: no atomics, no f32 scratch, no clearing or cast pass,
//   and two runs give the same bits.
//   A unit's work is a product over its k-rows in (r, p, q) order, D (cells
//   x C) += K (cells x k) G (k x C), with K's entries the weights Wy[y][p]
//   Wx[x][q] and G's rows g[r, p, q, :]; most of K is 0 (a bin's taps cover
//   a few cells). On the CUDA cores that is a load and 4 FMAs a nonzero
//   entry, held by latency, and the tiles that crowded proposals fill hold
//   several times the mean's work. So bf16 maps take the tensor cores: 128
//   channels a unit, g's rows by cp.async kStages - 1 batches ahead, K
//   built in shared memory as bf16 hi + lo (the split keeps ~16 bits of
//   every weight; g is bf16 already), mma.sync into f32. Units of up to
//   kHeavyBatches batches get a block each; the heavier ones a cluster of
//   kSplit blocks, which split the batches and add their partial sums in
//   block order through distributed shared memory, launched on a side
//   stream beside the light ones. f32 maps (C % 4 == 0, 16-byte aligned g)
//   take the CUDA cores in f32 with the same units and batches: 128
//   channels a unit, g's rows by cp.async kF32Stages - 1 batches ahead, a
//   warp a tile row and a lane 4 channels x the row's 4 cells (16 f32
//   accumulators); per batch each warp forms its row's weights Wy[y][p]
//   Wx[x][q] (one k-row a lane) in shared memory, keeps the k-rows whose
//   weights there are not all 0 (ballot; a k-row's taps reach ~2 of the
//   tile's 4 rows) and adds w g by fmaf over those, in k-row order; the
//   heavy units a cluster of kF32Split blocks, as many clusters as the card
//   holds at once. Crowded tiles are the norm there: the GAN's empty edge
//   slots repeat a few boxes hundreds of times an image. The maps and bf16
//   ones that neither route takes go through the CUDA cores unstaged: a
//   warp a tile row, a lane V channels of its cells, w_y w_x g added in f32
//   registers in (r, p, q) order. Times: chip_smoke.py phases 8 and 11,
//   bench_kernels.py --k1bwd (PERF.md).
//
// sgg_roi_align_bwd_boxes: d loss / d boxes, f32, as XLA differentiates
//   the separable roi_align. Per bin (p, q) and map cell (y, x) let
//   D[p, q, y, x] = sum_c g[p, q, c] f[y, x, c]. Then per sample i along y
//   (bin p(i)),
//     d/dy_i = dm_i sum_q sum_x Wx[q, x]
//                   (D[p(i), q, hi_i, x] - D[p(i), q, lo_i, x])
//   with dm_i = (1/ratio) [valid, not capped] clip'(y_i) (clip' = 1 above
//   0, 1/2 at 0, 0 below, as jnp.clip's gradient) and Wx the other axis'
//   bin weights; the same along x with the roles swapped; then chained
//   through y_i = start + extent (i + 0.5) / S and extent = max(., 1) (a
//   gradient of 1/2 at the floor, 0 below it) and the spatial scale.
//   A bin's cells are its samples' unfolded lo and hi rows times their lo
//   and hi columns ("slots": (2 ratio)^2 = 16 at ratio 2), not the folded
//   taps of the forward: a sample on an integer coordinate has w_hi = 0
//   but dm_i != 0, so its derivative still needs D at its hi row.
//   What bounds it: reading g once and, from L2, the bins' cells of the map
//   (16 cells x C a bin at ratio 2, shared between neighbouring bins).
//   Design: one block per ROI, one warp per bin at a time (bins warp,
//   warp + 8, ...). A lane holds its channels of g[p, q, :] in registers
//   (16-byte loads: 8 bf16 or 4 f32 a chunk; 2- or 1-channel loads where C
//   or the alignment does not allow that) and issues the bin's 16 cell
//   loads of a chunk together; the warp reduces the 16 partial dot products
//   with one transposing butterfly of shuffles (16 shuffles: lane l ends
//   with cell (l / 2) % 16); lanes then combine the cells into the bin's
//   per-sample terms, which each warp adds into its own per-sample sums in
//   its fixed bin order; the warps' sums are added in warp order. No
//   atomics, so two runs give the same bits. Copying a small ROI's
//   footprint to shared memory first (with g in registers) measured slower
//   on the card than these L1-served reads (PERF.md); times: chip_smoke.py
//   phase 8.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSamples = 64;  // pooled * ratio per axis
constexpr int kMaxTapsPerBin = 2 * 8;  // 2 * ratio, ratio <= 8
// K1-bwd-fmap's tiles of map cells (rows x columns; kTileH % 4 == 0)
constexpr int kTileH = 4;
constexpr int kTileW = 4;
constexpr int kCells = kTileH * kTileW;
constexpr int kTileThreads = 256;  // both gathers: 8 warps

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

// V (1 or 4) f32 values at p in T, rounded to nearest even: one store.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 1) {
      p[0] = v[0];
    } else {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else if constexpr (V == 1) {
    p[0] = __float2bfloat16(v[0]);
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                   *reinterpret_cast<const unsigned*>(&hi));
  }
}

// V adjacent channels at p as one load of V * sizeof(T) bytes, kept raw
// until unpack: a bin's loads are all issued before the first is used.
template <int kBytes> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned; };
template <> struct RawOf<2> { using type = unsigned short; };
template <typename T, int V>
using Raw = typename RawOf<V * sizeof(T)>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  return __ldg(reinterpret_cast<const Raw<T, V>*>(p));
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& r, float (&v)[V]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = to_f32(e[k]);
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

// K1-bwd-fmap's workspace, in 4-byte words: per (image, tile) its count of
// ROIs and its k-rows (sum over its ROIs of np nq), then per (image, tile)
// three arrays of R (the first `count` used): its ROIs, their bin ranges
// (p0 | np << 8 | q0 << 16 | nq << 24) and their first k-row; then per ROI
// the tile masks of its rows (my words) and of its columns (mx words); then
// per ROI its H + W lines (rows, then columns) of P f32 bin weights.
struct Layout {
  int nty, ntx, my, mx;
  size_t krows, lists, infos, koffs, masks, lines, words;  // counts at 0
};

Layout fmap_layout(int B, int H, int W, int R, int P) {
  Layout L;
  L.nty = (H + kTileH - 1) / kTileH;
  L.ntx = (W + kTileW - 1) / kTileW;
  L.my = (L.nty + 31) / 32;
  L.mx = (L.ntx + 31) / 32;
  const size_t tiles = static_cast<size_t>(B) * L.nty * L.ntx;
  L.krows = tiles;
  L.lists = 2 * tiles;
  L.infos = L.lists + tiles * R;
  L.koffs = L.infos + tiles * R;
  L.masks = L.koffs + tiles * R;
  L.lines = L.masks + static_cast<size_t>(B) * R * (L.my + L.mx);
  L.words = L.lines + static_cast<size_t>(B) * R * (H + W) * P;
  return L;
}

// (1) Per ROI (b R + r) and axis, the tiles along the axis that hold one of
// its taps of nonzero weight (the index set of the forward's folded tap
// tables: a bin's merged taps have positive weights), as bits.
__device__ __forceinline__ void tile_masks(const float* __restrict__ boxes,
                                           unsigned* __restrict__ masks,
                                           int t, int H, int W, float scale,
                                           int P, int ratio, int my,
                                           int mx) {
  const int roi = t >> 1, axis = t & 1;
  float start, extent, raw;
  axis_frame(boxes + static_cast<size_t>(roi) * 4, axis, scale, &start,
             &extent, &raw);
  const int dim = axis == 0 ? H : W;
  unsigned* m = masks + static_cast<size_t>(roi) * (my + mx) +
                (axis == 0 ? 0 : my);
  for (int w = 0; w < (axis == 0 ? my : mx); ++w) m[w] = 0u;
  const float inv = 1.0f / static_cast<float>(ratio);
  const int S = P * ratio;
  for (int i = 0; i < S; ++i) {
    const Sample a = axis_sample(start, extent, i, S, dim);
    const int tile = axis == 0 ? kTileH : kTileW;
    const int tl = a.lo / tile, th = a.hi / tile;
    if (__fmul_rn(a.w_lo, inv) != 0.0f) m[tl >> 5] |= 1u << (tl & 31);
    if (__fmul_rn(a.w_hi, inv) != 0.0f) m[th >> 5] |= 1u << (th & 31);
  }
}

// The first bin whose last sample's high tap reaches index a (both the
// sample index and the taps only grow along the axis).
__device__ __forceinline__ int first_bin_reaching(float start, float extent,
                                                  int S, int dim, int P,
                                                  int ratio, int a) {
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (axis_sample(start, extent, mid * ratio + ratio - 1, S, dim).hi < a)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// (2) Per ROI, axis and map index idx along the axis, its line: the weight
// of each of the P bins at idx (0 for most): per bin its samples' weights
// at idx summed in sample order, low tap before high, zero weights dropped,
// as add_tap in csrc/roi_align.cu folds a bin's taps.
__device__ __forceinline__ void tile_lines(const float* __restrict__ boxes,
                                           float* __restrict__ lines, int t,
                                           int H, int W, float scale, int P,
                                           int ratio) {
  const int HW = H + W;
  const int roi = t / HW;
  const int axis = t - roi * HW < H ? 0 : 1;
  const int idx = t - roi * HW - axis * H;
  const int dim = axis == 0 ? H : W;
  float start, extent, raw;
  axis_frame(boxes + static_cast<size_t>(roi) * 4, axis, scale, &start,
             &extent, &raw);
  const float inv = 1.0f / static_cast<float>(ratio);
  const int S = P * ratio;
  const int first = first_bin_reaching(start, extent, S, dim, P, ratio, idx);
  float* line = lines + static_cast<size_t>(t) * P;
  bool past = false;  // samples only move on: no later tap reaches idx
  for (int p = 0; p < P; ++p) {
    float w = 0.0f;
    for (int s = 0; p >= first && !past && s < ratio; ++s) {
      const Sample a = axis_sample(start, extent, p * ratio + s, S, dim);
      if (a.lo > idx) {
        past = true;
      } else {
        if (a.lo == idx) w += __fmul_rn(a.w_lo, inv);
        if (a.hi == idx) w += __fmul_rn(a.w_hi, inv);
      }
    }
    line[p] = w;
  }
}

// (1) and (2) in one launch: threads 0 .. 2 rois - 1 the masks, the rest
// the lines.
__global__ void tile_masks_lines_kernel(const float* __restrict__ boxes,
                                        unsigned* __restrict__ masks,
                                        float* __restrict__ lines, int rois,
                                        int H, int W, float scale, int P,
                                        int ratio, int my, int mx) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < 2 * rois)
    tile_masks(boxes, masks, t, H, W, scale, P, ratio, my, mx);
  else if (t - 2 * rois < rois * (H + W))
    tile_lines(boxes, lines, t - 2 * rois, H, W, scale, P, ratio);
}

// (3) One block per (image, tile): the ROIs whose row mask holds the tile's
// row and whose column mask holds its column, in ascending order; for each
// the range of bins along each axis whose taps can reach the tile (first
// bin whose last sample reaches its first row, up to the last bin whose
// first sample has not passed its last), and its first k-row. Each warp
// tests 32 ROIs (ballot) at a time; the warps' counts and k-rows are
// prefix-summed in warp order, so the order is the ROIs'.
constexpr int kListThreads = 256;
__global__ void __launch_bounds__(kListThreads)
    tile_lists_kernel(const float* __restrict__ boxes,
                      const unsigned* __restrict__ masks,
                      int* __restrict__ counts, int* __restrict__ krows,
                      int* __restrict__ lists, int* __restrict__ infos,
                      int* __restrict__ koffs, int R, int H, int W,
                      float scale, int P, int ratio, int nty, int ntx,
                      int my, int mx) {
  constexpr int kWarpsL = kListThreads / 32;
  __shared__ int s_n[kWarpsL], s_k[kWarpsL];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;  // b nt + t
  const int nt = nty * ntx;
  const int b = tile / nt;
  const int ty = (tile - b * nt) / ntx, tx = (tile - b * nt) % ntx;
  const int S = P * ratio;
  const size_t base = static_cast<size_t>(tile) * R;
  int n = 0, ktot = 0;  // before this pass of kListThreads ROIs
  for (int r0 = 0; r0 < R; r0 += kListThreads) {
    const int r = r0 + threadIdx.x;
    bool in = false;
    int info = 0, kb = 0;
    if (r < R) {
      const unsigned* m = masks + static_cast<size_t>(b * R + r) * (my + mx);
      in = ((m[ty >> 5] >> (ty & 31)) & (m[my + (tx >> 5)] >> (tx & 31)) &
            1u) != 0;
    }
    if (in) {
      const float* bx = boxes + static_cast<size_t>(b * R + r) * 4;
      int first[2], count[2];
      for (int axis = 0; axis < 2; ++axis) {
        float start, extent, raw;
        axis_frame(bx, axis, scale, &start, &extent, &raw);
        const int dim = axis == 0 ? H : W;
        const int tile_cells = axis == 0 ? kTileH : kTileW;
        const int a = (axis == 0 ? ty : tx) * tile_cells;
        const int z = min(a + tile_cells, dim) - 1;
        first[axis] = first_bin_reaching(start, extent, S, dim, P, ratio, a);
        int lo = first[axis], hi = P;  // the first bin starting past z
        while (lo < hi) {
          const int mid = (lo + hi) / 2;
          if (axis_sample(start, extent, mid * ratio, S, dim).lo <= z)
            lo = mid + 1;
          else
            hi = mid;
        }
        count[axis] = lo - first[axis];
      }
      info = first[0] | count[0] << 8 | first[1] << 16 | count[1] << 24;
      kb = count[0] * count[1];
    }
    int incl = kb;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, in);
    if (lane == 31) {
      s_n[warp] = __popc(ball);
      s_k[warp] = incl;
    }
    __syncthreads();
    int wn = n, wk = ktot;  // this warp's start
    for (int w = 0; w < kWarpsL; ++w) {
      if (w < warp) wn += s_n[w], wk += s_k[w];
      n += s_n[w], ktot += s_k[w];
    }
    if (in) {
      const int k = wn + __popc(ball & ((1u << lane) - 1u));
      lists[base + k] = r;
      infos[base + k] = info;
      koffs[base + k] = wk + incl - kb;
    }
    __syncthreads();  // s_n, s_k are read before the next pass
  }
  if (threadIdx.x == 0) {
    counts[tile] = n;
    krows[tile] = ktot;
  }
}

// (4a) The CUDA-core gather (f32 maps; bf16 maps whose C or alignment the
// tensor-core route does not take): one block per (image, tile, chunk of
// 32 V channels); warp w owns tile row w, a lane V channels of the row's
// kTileW cells, and adds w_y w_x g[r, p, q, c .. c + V] into f32 registers
// in (r, p, q) order over the bin ranges of the tile's list.
template <typename T, int V>
__global__ void __launch_bounds__(32 * kTileH)
    fmap_gather_kernel(const T* __restrict__ g,
                       const int* __restrict__ counts,
                       const int* __restrict__ lists,
                       const int* __restrict__ infos,
                       const float* __restrict__ lines,
                       T* __restrict__ grad, int R, int H, int W, int C,
                       int P, int nty, int ntx, int chunks) {
  const int tile = blockIdx.x / chunks;  // b nt + t: images outermost
  const int chunk = blockIdx.x - tile * chunks;
  const int nt = nty * ntx;
  const int b = tile / nt;
  const int y0 = (tile - b * nt) / ntx * kTileH;
  const int x0 = (tile - b * nt) % ntx * kTileW;
  const int lane = threadIdx.x & 31, y = y0 + (threadIdx.x >> 5);
  const int c = (chunk * 32 + lane) * V;
  // lanes past C read channel 0 and store nothing
  const T* gb = g + static_cast<size_t>(b) * R * P * P * C + (c < C ? c : 0);
  const size_t base = static_cast<size_t>(tile) * R;
  const int n = y < H ? counts[tile] : 0;
  const size_t HW = H + W;

  float acc[kTileW][V];
#pragma unroll
  for (int lx = 0; lx < kTileW; ++lx)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[lx][v] = 0.0f;
  for (int k = 0; k < n; ++k) {
    const int r = __ldg(lists + base + k), info = __ldg(infos + base + k);
    const int p0 = info & 255, np = (info >> 8) & 255;
    const int q0 = (info >> 16) & 255, nq = info >> 24;
    const float* lw = lines + (b * R + r) * HW * P;
    const T* gr = gb + static_cast<size_t>(r) * P * P * C;
    for (int p = p0; p < p0 + np; ++p) {
      const float wy = __ldg(lw + y * P + p);
      if (wy == 0.0f) continue;  // the whole warp
      const T* gp = gr + static_cast<size_t>(p) * P * C;
#pragma unroll
      for (int lx = 0; lx < kTileW; ++lx) {
        if (x0 + lx >= W) continue;
        const float* wx = lw + (H + x0 + lx) * P;
        for (int q = q0; q < q0 + nq; ++q) {
          const float w = __ldg(wx + q);
          if (w == 0.0f) continue;
          float gv[V];
          unpack<T, V>(load_raw<T, V>(gp + static_cast<size_t>(q) * C), gv);
          const float wyx = wy * w;
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[lx][v] = fmaf(wyx, gv[v], acc[lx][v]);
        }
      }
    }
  }
  if (c >= C || y >= H) return;
  T* out = grad + ((static_cast<size_t>(b) * H + y) * W + x0) * C + c;
#pragma unroll
  for (int lx = 0; lx < kTileW; ++lx)
    if (x0 + lx < W)
      store_vec<T, V>(out + static_cast<size_t>(lx) * C, acc[lx]);
}

// The tensor-core route: the tile's k-rows are its list's (ROI, bin p, bin
// q) over each ROI's bin ranges, in (r, p, q) order; per k-row the tile's
// cells' weights Wy[y][p] Wx[x][q] (a row of K, split into bf16 hi + lo)
// and the bin's row of g. A block of 8 warps owns a chunk of kMmaChannels
// channels, warp w kMTiles x 16 of them against all of the tile's cells:
// D^T (16 x cells) += G^T (16 x k) K (k x cells).
constexpr int kKRows = 64;          // k-rows staged at a time (a batch)
constexpr int kMmaChannels = 128;   // 8 warps x kMTiles x 16
constexpr int kMTiles = kMmaChannels / 128;
constexpr int kNTiles = kCells / 8;  // mma n-tiles of 8 cells
constexpr int kGPiecesPerRow = kMmaChannels / 8;
constexpr int kGRowBytes = kMmaChannels * 2;
constexpr int kKRowBytes = kCells * 2;
constexpr int kStages = 3;          // batches of g in flight
constexpr int kGStage = kKRows * kGRowBytes;  // bytes, one stage
constexpr int kKBytes = kKRows * kKRowBytes;  // K, hi or lo
constexpr int kMmaSmemFixed =
    kStages * kGStage + 4 * kKBytes + kStages * kKRows * 16;
constexpr int kMmaMaxR = 4096;  // ROIs an image the route stages (12 B each)
// a thread's share of a batch: kGPieces 16-byte pieces of a G row; the
// weights of one k-row for kGroupRows full tile rows
constexpr int kThreadsPerGRow = kTileThreads / kKRows;
constexpr int kGPieces = kGPiecesPerRow / kThreadsPerGRow;
constexpr int kGroupRows = kTileH * kKRows / kTileThreads;
// a unit of more than kHeavyBatches batches is split between the kSplit
// blocks of a cluster
constexpr int kHeavyBatches = 16;
constexpr int kSplit = 8;
static_assert(kCells % 16 == 0 && kCells % kSplit == 0 &&
                  kTileThreads % kKRows == 0 &&
                  kTileH * kKRows % kTileThreads == 0 &&
                  kCells * kMmaChannels * 4 <= kStages * kGStage,
              "tile, batch and channel chunk do not fit");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) where !pred.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
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

// Byte offset of 16-byte piece `piece` of row `row`, the pieces XOR-
// swizzled so that ldmatrix's 8 consecutive rows hit 8 different 16-byte
// bank groups.
template <int kRowBytes>
__device__ __forceinline__ int swz(int row, int piece) {
  if constexpr (kRowBytes >= 128) {
    return row * kRowBytes + ((piece ^ (row & 7)) << 4);
  } else {
    constexpr int kPieces = kRowBytes / 16, kPer = 128 / kRowBytes;
    return row * kRowBytes + ((piece ^ ((row / kPer) & (kPieces - 1))) << 4);
  }
}

// k-row k of the tile: (ROI, bin p, bin q), or roi -1 from kend on. `e`
// is the caller's cursor into the staged first k-rows: the last entry at or
// before its previous k, which only grows.
__device__ __forceinline__ int4 k_row(int k, int kend, int n, int& e,
                                      const int* s_koff, const int* s_roi,
                                      const int* s_info) {
  if (k >= kend) return make_int4(-1, 0, 0, 0);
  while (e + 1 < n && s_koff[e + 1] <= k) ++e;
  const int info = s_info[e], nq = info >> 24;
  const int local = k - s_koff[e], pi = local / nq;
  return make_int4(s_roi[e], (info & 255) + pi,
                   ((info >> 16) & 255) + local - pi * nq, 0);
}

// Shared memory of a tensor-core gather block: kStages stages of g's rows,
// two of K (hi, lo), kStages row maps, and the unit's list (first k-rows,
// ROIs, bin ranges: R each).
struct MmaSmem {
  unsigned char* g;
  unsigned char* kh;
  unsigned char* kl;
  int4* row;
  int* koff;
  int* roi;
  int* info;
};

__device__ __forceinline__ MmaSmem mma_smem(uint4* base, int R) {
  MmaSmem m;
  m.g = reinterpret_cast<unsigned char*>(base);
  m.kh = m.g + kStages * kGStage;  // [2][kKBytes]
  m.kl = m.kh + 2 * kKBytes;        // [2][kKBytes]
  m.row = reinterpret_cast<int4*>(m.kl + 2 * kKBytes);
  m.koff = reinterpret_cast<int*>(m.row + kStages * kKRows);
  m.roi = m.koff + R;
  m.info = m.roi + R;
  return m;
}

// Arguments of both tensor-core gather kernels.
struct MmaArgs {
  const __nv_bfloat16* g;
  const int* counts;
  const int* krows;
  const int* lists;
  const int* infos;
  const int* koffs;
  const float* lines;
  __nv_bfloat16* grad;
  int R, H, W, C, P, nty, ntx, chunks;
};

// The tensor-core gather of one unit (image, tile, chunk of kMmaChannels),
// or of batches [b_lo, b_hi) of it into `acc`. Per batch of kKRows k-rows:
// g's rows arrive by cp.async (kStages stages: the next two batches' in
// flight during this one's products), the weights two batches on are loaded
// into registers, K is built in shared memory (hi = bf16(w), lo = bf16(w -
// hi): the products keep ~16 bits of each weight; two buffers, so one
// barrier fewer), and each warp runs ldmatrix.trans and mma.sync, hi then
// lo, k-step by k-step, into f32 accumulators: a cell's sums in k-row
// order, each k-step's 16 products added by the tensor core.
__device__ __forceinline__ void mma_unit(const MmaArgs& A, const MmaSmem& S,
                                         int unit, int b_lo, int b_hi,
                                         float (&acc)[kMTiles][kNTiles][4]) {
  const int tile = unit / A.chunks;  // b nt + t
  const int chunk = unit - tile * A.chunks;
  const int nt = A.nty * A.ntx, R = A.R, P = A.P, C = A.C;
  const int b = tile / nt;
  const int y0 = (tile - b * nt) / A.ntx * kTileH;
  const int x0 = (tile - b * nt) % A.ntx * kTileW;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c0 = chunk * kMmaChannels;
  const int n = A.counts[tile], ktot = A.krows[tile];
  const size_t base = static_cast<size_t>(tile) * R;
  const size_t HW = A.H + A.W;
  const __nv_bfloat16* gb = A.g + static_cast<size_t>(b) * R * P * P * C;
  const int kbeg = b_lo * kKRows, kend = min(b_hi * kKRows, ktot);
  for (int e = t; e < n; e += kTileThreads) {
    S.koff[e] = __ldg(A.koffs + base + e);
    S.roi[e] = __ldg(A.lists + base + e);
    S.info[e] = __ldg(A.infos + base + e);
  }
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[m][j][v] = 0.0f;
  __syncthreads();

  const int gr_row = t / kThreadsPerGRow, kr = t % kKRows;
  const int grp = t / kKRows;  // tile rows grp kGroupRows ..
  auto issue_g = [&](int stage, int4 row) {
    const unsigned dst = smem_addr(S.g + stage * kGStage);
    const int s0 = (t % kThreadsPerGRow) * kGPieces;
    const __nv_bfloat16* src =
        gb + ((static_cast<size_t>(max(row.x, 0)) * P + row.y) * P + row.z) *
                 C + c0 + s0 * 8;
#pragma unroll
    for (int i = 0; i < kGPieces; ++i)
      cp_async16(dst + swz<kGRowBytes>(gr_row, s0 + i), src + i * 8,
                 row.x >= 0 && c0 + (s0 + i) * 8 < C);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // the weights of this batch's k-row kr (wy, wx) and of the next (wy2,
  // wx2): loads two batches ahead of their use
  float wy[kGroupRows], wx[kTileW], wy2[kGroupRows], wx2[kTileW];
  auto load_w = [&](int4 row, float (&ly)[kGroupRows], float (&lx_)[kTileW]) {
    const float* lw = A.lines + (b * R + max(row.x, 0)) * HW * P;
#pragma unroll
    for (int h = 0; h < kGroupRows; ++h) {
      const int y = y0 + grp * kGroupRows + h;
      ly[h] = row.x >= 0 && y < A.H ? __ldg(lw + y * P + row.y) : 0.0f;
    }
#pragma unroll
    for (int lx = 0; lx < kTileW; ++lx)
      lx_[lx] = row.x >= 0 && x0 + lx < A.W
                    ? __ldg(lw + (A.H + x0 + lx) * P + row.z) : 0.0f;
  };

  const int batches = b_hi - b_lo;
  // k-row kbeg + kKRows j + t's entry: a binary search once, then a cursor
  int cur_e = 0;
  if (t < kKRows && kbeg + t < kend) {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (S.koff[mid] <= kbeg + t)
        lo = mid;
      else
        hi = mid - 1;
    }
    cur_e = lo;
  }
  auto row_map = [&](int jb) {  // batch jb's row map into its buffer
    if (t < kKRows)
      S.row[(jb % kStages) * kKRows + t] =
          k_row(kbeg + jb * kKRows + t, kend, n, cur_e, S.koff, S.roi,
                S.info);
  };
  row_map(0);
  row_map(1);
  __syncthreads();
  issue_g(0, S.row[gr_row]);
  issue_g(1, S.row[kKRows + gr_row]);
  load_w(S.row[kr], wy, wx);
  load_w(S.row[kKRows + kr], wy2, wx2);
  // ldmatrix rows of k-step 0 (k-step ks: 16 ks rows on, the same
  // swizzle): G^T's for this warp's channels, K's for n-tile pairs
  const int mj = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  int a_off[kMTiles], b_off[kNTiles / 2];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
    a_off[m] = swz<kGRowBytes>((mj >> 1) * 8 + mr,
                               (warp * kMTiles + m) * 2 + (mj & 1));
#pragma unroll
  for (int jj = 0; jj < kNTiles / 2; ++jj)
    b_off[jj] = swz<kKRowBytes>((mj & 1) * 8 + mr, 2 * jj + (mj >> 1));
  for (int j = 0; j < batches; ++j) {
    const int cur = j % kStages, far = (j + 2) % kStages;
    unsigned char* kh_j = S.kh + (j & 1) * kKBytes;
    unsigned char* kl_j = S.kl + (j & 1) * kKBytes;
    // this batch's k-row kr of K, from the weights in registers
#pragma unroll
    for (int i = 0; i < kGroupRows * kTileW; i += 2) {
      const int cell = grp * kGroupRows * kTileW + i;
      const float w0 = wy[i / kTileW] * wx[i % kTileW];
      const float w1 = wy[(i + 1) / kTileW] * wx[(i + 1) % kTileW];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(w0, w1);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          w0 - __low2float(hi), w1 - __high2float(hi));
      const int off = swz<kKRowBytes>(kr, cell >> 3) + (cell & 7) * 2;
      *reinterpret_cast<__nv_bfloat162*>(kh_j + off) = hi;
      *reinterpret_cast<__nv_bfloat162*>(kl_j + off) = lo;
    }
    row_map(j + 2);
    __syncthreads();  // K and the row map two batches on are in place
    issue_g(far, S.row[far * kKRows + gr_row]);
    // wy, wx: consumed above; the next batch's (loaded an iteration ago)
    // move in, and batch j + 2's loads start
#pragma unroll
    for (int h = 0; h < kGroupRows; ++h) wy[h] = wy2[h];
#pragma unroll
    for (int lx = 0; lx < kTileW; ++lx) wx[lx] = wx2[lx];
    load_w(S.row[far * kKRows + kr], wy2, wx2);
    asm volatile("cp.async.wait_group 2;\n" ::);  // this batch's g landed
    __syncthreads();
    const unsigned gs = smem_addr(S.g + cur * kGStage);
    const unsigned kh = smem_addr(kh_j), kl = smem_addr(kl_j);
    const int steps = (min(kKRows, kend - kbeg - j * kKRows) + 15) / 16;
#pragma unroll
    for (int ks = 0; ks < kKRows / 16; ++ks) {
      if (ks >= steps) break;
      unsigned a[kMTiles][4];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m)
        ldsm_x4_trans(gs + a_off[m] + ks * 16 * kGRowBytes, a[m]);
#pragma unroll
      for (int jj = 0; jj < kNTiles / 2; ++jj) {
        const int off = b_off[jj] + ks * 16 * kKRowBytes;
        unsigned bh[4], bl[4];
        ldsm_x4_trans(kh + off, bh);
        ldsm_x4_trans(kl + off, bl);
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
          mma_k16(acc[m][2 * jj], a[m], bh[0], bh[1]);
          mma_k16(acc[m][2 * jj], a[m], bl[0], bl[1]);
          mma_k16(acc[m][2 * jj + 1], a[m], bh[2], bh[3]);
          mma_k16(acc[m][2 * jj + 1], a[m], bl[2], bl[3]);
        }
      }
    }
    // no barrier: the next batch writes the other K, and its first
    // barrier comes after this one's products in every thread
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // empty groups only
  __syncthreads();  // and every thread's: the stages are reused after
}

// Cell and channel (within the unit's chunk) of accumulator acc[m][j][v].
__device__ __forceinline__ int acc_cell(int j, int v) {
  return j * 8 + (threadIdx.x & 3) * 2 + (v & 1);
}
__device__ __forceinline__ int acc_channel(int m, int v) {
  return ((threadIdx.x >> 5) * kMTiles + m) * 16 +
         ((threadIdx.x & 31) >> 2) + (v >> 1) * 8;
}

// The block's accumulators into shared memory as f32 [cell][channel].
__device__ __forceinline__ void put_partials(
    float* s_part, const float (&acc)[kMTiles][kNTiles][4]) {
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        s_part[acc_cell(j, v) * kMmaChannels + acc_channel(m, v)] =
            acc[m][j][v];
}

// 8 channels of the unit's cell `cell` (8 f32) into grad as one 16-byte
// store, where the cell and channels lie in the map.
__device__ __forceinline__ void store8(const MmaArgs& A, int unit, int cell,
                                       int s, const float (&v)[8]) {
  const int tile = unit / A.chunks, chunk = unit - tile * A.chunks;
  const int nt = A.nty * A.ntx, b = tile / nt;
  const int y = (tile - b * nt) / A.ntx * kTileH + cell / kTileW;
  const int x = (tile - b * nt) % A.ntx * kTileW + cell % kTileW;
  const int c = chunk * kMmaChannels + s * 8;
  if (y >= A.H || x >= A.W || c >= A.C) return;
  __nv_bfloat162 o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(
      A.grad + ((static_cast<size_t>(b) * A.H + y) * A.W + x) * A.C + c) =
      *reinterpret_cast<const uint4*>(o);
}

// (4b) The tensor-core gather (bf16 maps, C % 8 == 0, 16-byte aligned g),
// for the units of at most kHeavyBatches batches: one block per (image,
// tile, chunk of kMmaChannels), images outermost; the others' blocks leave.
// The results go through shared memory (f32 [cell][channel]) to 16-byte
// stores.
__global__ void __launch_bounds__(kTileThreads, 3)
    fmap_gather_mma_kernel(MmaArgs A) {
  extern __shared__ uint4 s_dyn[];
  const MmaSmem S = mma_smem(s_dyn, A.R);
  const int unit = blockIdx.x;
  const int nb = (A.krows[unit / A.chunks] + kKRows - 1) / kKRows;
  if (nb > kHeavyBatches) return;
  float acc[kMTiles][kNTiles][4];
  mma_unit(A, S, unit, 0, nb, acc);
  float* s_part = reinterpret_cast<float*>(S.g);
  put_partials(s_part, acc);
  __syncthreads();
  for (int item = threadIdx.x; item < kCells * kGPiecesPerRow;
       item += kTileThreads) {
    const int cell = item / kGPiecesPerRow, s = item % kGPiecesPerRow;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = s_part[cell * kMmaChannels + s * 8 + i];
    store8(A, unit, cell, s, v);
  }
}

// (4c) The same for the units of more than kHeavyBatches batches (a tile
// that crowded proposals fill): a persistent grid of clusters of kSplit
// blocks. Cluster c takes the heavy ones among units c, c + clusters, ...
// (32 tested at a time, by ballot), in order; its blocks split a unit's
// batches into kSplit equal runs and add their partial sums in block order
// through distributed shared memory, each block then storing kCells /
// kSplit cells. Launched on a side stream beside (4b).
__global__ void __cluster_dims__(kSplit, 1, 1)
    __launch_bounds__(kTileThreads, 3) fmap_gather_mma_heavy_kernel(
        MmaArgs A, int units) {
  namespace cg = cooperative_groups;
  extern __shared__ uint4 s_dyn[];
  const MmaSmem S = mma_smem(s_dyn, A.R);
  cg::cluster_group cluster = cg::this_cluster();
  const int seg = blockIdx.x % kSplit;
  const int clusters = gridDim.x / kSplit, c = blockIdx.x / kSplit;
  const int lane = threadIdx.x & 31;
  float* s_part = reinterpret_cast<float*>(S.g);
  auto batches = [&](int u) {
    return (__ldg(A.krows + u / A.chunks) + kKRows - 1) / kKRows;
  };
  for (int u0 = c; u0 < units; u0 += 32 * clusters) {
    const int u = u0 + lane * clusters;
    unsigned todo =
        __ballot_sync(0xffffffffu, u < units && batches(u) > kHeavyBatches);
    while (todo) {
      const int unit = u0 + (__ffs(todo) - 1) * clusters;
      todo &= todo - 1;
      const int nb = batches(unit);
      float acc[kMTiles][kNTiles][4];
      mma_unit(A, S, unit, seg * nb / kSplit, (seg + 1) * nb / kSplit, acc);
      put_partials(s_part, acc);
      cluster.sync();
      constexpr int kShare = kCells / kSplit;
      for (int item = threadIdx.x; item < kShare * kGPiecesPerRow;
           item += kTileThreads) {
        const int cell = seg * kShare + item / kGPiecesPerRow;
        const int s = item % kGPiecesPerRow;
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.0f;
        for (int r = 0; r < kSplit; ++r) {
          const float4* part = reinterpret_cast<const float4*>(
              cluster.map_shared_rank(s_part, r) + cell * kMmaChannels +
              s * 8);
          const float4 p0 = part[0], p1 = part[1];
          v[0] += p0.x, v[1] += p0.y, v[2] += p0.z, v[3] += p0.w;
          v[4] += p1.x, v[5] += p1.y, v[6] += p1.z, v[7] += p1.w;
        }
        store8(A, unit, cell, s, v);
      }
      cluster.sync();  // the partials are read before the next unit
    }
  }
}

// The staged f32 route (4d, 4e): the units, the tile's k-rows and the
// cluster split of the tensor-core route, the products on the CUDA cores.
// A block of kTileH warps owns a chunk of kF32Channels channels: warp w
// tile row w, its lane l channels 4 l .. 4 l + 3 in the row's kTileW cells
// (16 f32 accumulators).
constexpr int kF32Channels = 128;
constexpr int kF32Threads = 32 * kTileH;
constexpr int kF32KRows = 32;   // k-rows a batch: one a lane
constexpr int kF32Stages = 4;   // batches of g in the ring, 3 in flight
constexpr int kF32RowBytes = kF32Channels * 4;
constexpr int kF32Stage = kF32KRows * kF32RowBytes;  // bytes, one stage
constexpr int kF32CopyRows = kF32KRows / kTileH;     // a warp's copies
// a unit of more than kF32HeavyBatches batches is split between the
// kF32Split blocks of a cluster
constexpr int kF32HeavyBatches = 32;
constexpr int kF32Split = 4;
// the stages; the warps' products; two batches' wy and wx
constexpr int kF32SmemFixed =
    kF32Stages * kF32Stage + (kTileH + 2 + 2) * kF32KRows * 16;
static_assert(kTileW == 4 && kF32Channels == 32 * 4 && kF32KRows == 32 &&
                  kF32KRows % kTileH == 0 && kCells % kF32Split == 0 &&
                  kCells * kF32Channels * 4 <= kF32Stages * kF32Stage,
              "the staged f32 gather's tile, batch and chunk do not fit");

// Arguments of both staged f32 gather kernels.
struct F32Args {
  const float* g;
  const int* counts;
  const int* krows;
  const int* lists;
  const int* infos;
  const int* koffs;
  const float* lines;
  float* grad;
  int R, H, W, C, P, nty, ntx, chunks;
};

// Shared memory of a staged f32 gather block: kF32Stages stages of g's
// rows; per warp its row's weights of a batch (a float4 a k-row); the bin
// weights of two batches' k-rows at the tile's 4 rows (wy) and 4 columns
// (wx); the unit's list (first k-rows, ROIs, bin ranges: R each).
struct F32Smem {
  unsigned char* g;
  float4* w;
  float4* wy;
  float4* wx;
  int* koff;
  int* roi;
  int* info;
};

__device__ __forceinline__ F32Smem f32_smem(uint4* base, int R) {
  F32Smem m;
  m.g = reinterpret_cast<unsigned char*>(base);
  m.w = reinterpret_cast<float4*>(m.g + kF32Stages * kF32Stage);
  m.wy = m.w + kTileH * kF32KRows;
  m.wx = m.wy + 2 * kF32KRows;
  m.koff = reinterpret_cast<int*>(m.wx + 2 * kF32KRows);
  m.roi = m.koff + R;
  m.info = m.roi + R;
  return m;
}

// acc[lx] += w[lx] g over the tile row's 4 cells, 4 channels each.
__device__ __forceinline__ void fma_row(float (&acc)[kTileW][4],
                                        const float4& w, const float4& g) {
  const float wv[kTileW] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int lx = 0; lx < kTileW; ++lx) {
    acc[lx][0] = fmaf(wv[lx], g.x, acc[lx][0]);
    acc[lx][1] = fmaf(wv[lx], g.y, acc[lx][1]);
    acc[lx][2] = fmaf(wv[lx], g.z, acc[lx][2]);
    acc[lx][3] = fmaf(wv[lx], g.w, acc[lx][3]);
  }
}

// The staged f32 gather of one unit (image, tile, chunk of kF32Channels),
// or of batches [b_lo, b_hi) of it, into `acc` (this thread's row and
// channels). Per batch of kF32KRows k-rows, lane l holding k-row l's (ROI,
// p, q): g's rows arrive by cp.async into a ring of kF32Stages stages
// (issued kF32Stages - 1 batches ahead; warp w copies rows w kF32CopyRows
// ..., a lane a 16-byte piece of each); warp w < kTileH loads, two batches
// ahead, its lane's k-row's weights at the tile's row w and column w, which
// meet in shared memory; each warp writes its row's products wy wx
// (rounded as the CUDA-core gather rounds them) and keeps, by ballot, the
// k-rows where one is not 0; then adds w g by fmaf over those in ascending
// order, four rows' loads before their products: a cell's sum in k-row
// order, as the unstaged gather adds it, the products that are 0 left out
// as it leaves them out. One barrier a batch.
__device__ __forceinline__ void staged_unit(const F32Args& A,
                                            const F32Smem& S, int unit,
                                            int b_lo, int b_hi,
                                            float (&acc)[kTileW][4]) {
  const int tile = unit / A.chunks;  // b nt + t
  const int chunk = unit - tile * A.chunks;
  const int nt = A.nty * A.ntx, R = A.R, P = A.P, C = A.C;
  const int b = tile / nt;
  const int y0 = (tile - b * nt) / A.ntx * kTileH;
  const int x0 = (tile - b * nt) % A.ntx * kTileW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = chunk * kF32Channels + lane * 4;
  const int n = A.counts[tile], ktot = A.krows[tile];
  const size_t base = static_cast<size_t>(tile) * R;
  const size_t HW = A.H + A.W;
  // lanes past C copy nothing (their pieces are zero-filled)
  const float* gb = A.g + static_cast<size_t>(b) * R * P * P * C + c;
  const int kbeg = b_lo * kF32KRows, kend = min(b_hi * kF32KRows, ktot);
#pragma unroll
  for (int lx = 0; lx < kTileW; ++lx)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[lx][v] = 0.0f;
  if (kbeg >= kend) return;  // the whole block
  for (int e = threadIdx.x; e < n; e += kF32Threads) {
    S.koff[e] = __ldg(A.koffs + base + e);
    S.roi[e] = __ldg(A.lists + base + e);
    S.info[e] = __ldg(A.infos + base + e);
  }
  __syncthreads();

  // k-row kbeg + kF32KRows j + lane's entry: a binary search once, then a
  // cursor
  int cur = 0;
  if (kbeg + lane < kend) {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (S.koff[mid] <= kbeg + lane)
        lo = mid;
      else
        hi = mid - 1;
    }
    cur = lo;
  }
  auto row_of = [&](int jb) {
    return k_row(kbeg + jb * kF32KRows + lane, kend, n, cur, S.koff, S.roi,
                 S.info);
  };
  auto issue_g = [&](int jb, int4 row) {
    const unsigned dst =
        smem_addr(S.g + (jb % kF32Stages) * kF32Stage) + lane * 16;
#pragma unroll
    for (int i = 0; i < kF32CopyRows; ++i) {
      const int k = warp * kF32CopyRows + i;
      const int r = __shfl_sync(0xffffffffu, row.x, k);
      const int p = __shfl_sync(0xffffffffu, row.y, k);
      const int q = __shfl_sync(0xffffffffu, row.z, k);
      cp_async16(dst + k * kF32RowBytes,
                 gb + ((static_cast<size_t>(max(r, 0)) * P + p) * P + q) * C,
                 r >= 0 && c < C);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // warp w's share of a k-row's weights: at tile row w and column w
  const int ly = y0 + warp, lx = x0 + warp;
  auto load_w = [&](int4 row, float& wy, float& wx) {
    const float* lw = A.lines + (b * R + max(row.x, 0)) * HW * P;
    wy = row.x >= 0 && ly < A.H ? __ldg(lw + ly * P + row.y) : 0.0f;
    wx = row.x >= 0 && lx < A.W ? __ldg(lw + (A.H + lx) * P + row.z) : 0.0f;
  };
  auto put_w = [&](int buf, float wy, float wx) {
    reinterpret_cast<float*>(S.wy + buf * kF32KRows + lane)[warp] = wy;
    reinterpret_cast<float*>(S.wx + buf * kF32KRows + lane)[warp] = wx;
  };

  const int batches = (kend - kbeg + kF32KRows - 1) / kF32KRows;
  int4 ring[kF32Stages - 1];  // the row maps of batches j .. j + 2
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    ring[s] = row_of(s);
    issue_g(s, ring[s]);
  }
  // batch 0's weights in shared memory, batch 1's in registers
  float wy, wx;
  load_w(ring[0], wy, wx);
  put_w(0, wy, wx);
  load_w(ring[1], wy, wx);
  float4* sw = S.w + warp * kF32KRows;
  for (int j = 0; j < batches; ++j) {
    // this thread's copies of batch j landed, then every thread's; and
    // every warp is done with batch j - 1's stage and weights, which
    // batches j + kF32Stages - 1 and j + 1 take
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kF32Stages - 2));
    __syncthreads();
    const int4 ahead = row_of(j + kF32Stages - 1);
    issue_g(j + kF32Stages - 1, ahead);
    put_w((j + 1) & 1, wy, wx);  // batch j + 1's, read after the next barrier
    const float wyj =
        reinterpret_cast<const float*>(S.wy + (j & 1) * kF32KRows + lane)[warp];
    const float4 wxj = S.wx[(j & 1) * kF32KRows + lane];
    const float4 w = make_float4(wyj * wxj.x, wyj * wxj.y, wyj * wxj.z,
                                 wyj * wxj.w);
    sw[lane] = w;
    unsigned live = __ballot_sync(
        0xffffffffu, w.x != 0.0f || w.y != 0.0f || w.z != 0.0f ||
                         w.w != 0.0f);
#pragma unroll
    for (int s = 0; s < kF32Stages - 2; ++s) ring[s] = ring[s + 1];
    ring[kF32Stages - 2] = ahead;
    load_w(ring[1], wy, wx);  // batch j + 2's
    __syncwarp();
    const unsigned char* gs =
        S.g + (j % kF32Stages) * kF32Stage + lane * 16;
    while (live) {
      int k[4];
      bool on[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        on[i] = live != 0;
        k[i] = on[i] ? __ffs(live) - 1 : 0;
        live &= live - 1;
      }
      float4 gv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gv[i] = *reinterpret_cast<const float4*>(gs + k[i] * kF32RowBytes);
        wv[i] = sw[k[i]];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (on[i]) fma_row(acc, wv[i], gv[i]);
    }
    __syncwarp();  // sw is rewritten next batch
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // zero-filled tails only
  __syncthreads();  // and every thread's: the stages are reused after
}

// Row, first column and first channel of a unit's cell.
struct F32Cell {
  int b, y, x0, c;
};

__device__ __forceinline__ F32Cell f32_cell(const F32Args& A, int unit,
                                            int cell) {
  const int tile = unit / A.chunks, chunk = unit - tile * A.chunks;
  const int nt = A.nty * A.ntx, b = tile / nt;
  F32Cell o;
  o.b = b;
  o.y = (tile - b * nt) / A.ntx * kTileH + cell / kTileW;
  o.x0 = (tile - b * nt) % A.ntx * kTileW + cell % kTileW;
  o.c = chunk * kF32Channels;
  return o;
}

// 4 channels of a cell into grad as one 16-byte store, where the cell and
// channels lie in the map.
__device__ __forceinline__ void store_f32x4(const F32Args& A, int b, int y,
                                            int x, int c, const float4& v) {
  if (y >= A.H || x >= A.W || c >= A.C) return;
  *reinterpret_cast<float4*>(
      A.grad + ((static_cast<size_t>(b) * A.H + y) * A.W + x) * A.C + c) = v;
}

// (4d) The staged f32 gather (f32 maps, C % 4 == 0, 16-byte aligned g, R <=
// kMmaMaxR) for the units of at most kF32HeavyBatches batches: one block
// per (image, tile, chunk of kF32Channels), images outermost; the others'
// blocks leave. Each thread stores its row's 4 cells from registers.
__global__ void __launch_bounds__(kF32Threads)
    staged_fmap_gather_kernel(F32Args A) {
  extern __shared__ uint4 s_dyn[];
  const F32Smem S = f32_smem(s_dyn, A.R);
  const int unit = blockIdx.x;
  const int nb = (A.krows[unit / A.chunks] + kF32KRows - 1) / kF32KRows;
  if (nb > kF32HeavyBatches) return;
  float acc[kTileW][4];
  staged_unit(A, S, unit, 0, nb, acc);
  const F32Cell o = f32_cell(A, unit, (threadIdx.x >> 5) * kTileW);
  const int c = o.c + (threadIdx.x & 31) * 4;
#pragma unroll
  for (int lx = 0; lx < kTileW; ++lx)
    store_f32x4(A, o.b, o.y, o.x0 + lx, c,
                make_float4(acc[lx][0], acc[lx][1], acc[lx][2], acc[lx][3]));
}

// (4e) The same for the units of more than kF32HeavyBatches batches: a
// persistent grid of as many clusters of kF32Split blocks as the card
// holds at once. Cluster c takes the heavy ones among units c, c +
// clusters, ... (32 tested at a time, by ballot), in order; its blocks
// split a unit's batches into kF32Split equal runs and add their partial
// sums in block order through distributed shared memory, each block then
// storing kCells / kF32Split cells. Launched on a side stream beside (4d).
__global__ void __cluster_dims__(kF32Split, 1, 1)
    __launch_bounds__(kF32Threads) staged_heavy_fmap_gather_kernel(
        F32Args A, int units) {
  namespace cg = cooperative_groups;
  extern __shared__ uint4 s_dyn[];
  const F32Smem S = f32_smem(s_dyn, A.R);
  cg::cluster_group cluster = cg::this_cluster();
  const int seg = blockIdx.x % kF32Split;
  const int clusters = gridDim.x / kF32Split, c = blockIdx.x / kF32Split;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // f32 [cell][channel] partial sums, over the stages once they are idle
  constexpr int kQuads = kF32Channels / 4;  // float4s a cell
  float4* s_part = reinterpret_cast<float4*>(S.g);
  auto batches = [&](int u) {
    return (__ldg(A.krows + u / A.chunks) + kF32KRows - 1) / kF32KRows;
  };
  for (int u0 = c; u0 < units; u0 += 32 * clusters) {
    const int u = u0 + lane * clusters;
    unsigned todo = __ballot_sync(
        0xffffffffu, u < units && batches(u) > kF32HeavyBatches);
    while (todo) {
      const int unit = u0 + (__ffs(todo) - 1) * clusters;
      todo &= todo - 1;
      const int nb = batches(unit);
      float acc[kTileW][4];
      staged_unit(A, S, unit, seg * nb / kF32Split,
                  (seg + 1) * nb / kF32Split, acc);
#pragma unroll
      for (int lx = 0; lx < kTileW; ++lx)
        s_part[(warp * kTileW + lx) * kQuads + lane] =
            make_float4(acc[lx][0], acc[lx][1], acc[lx][2], acc[lx][3]);
      cluster.sync();
      constexpr int kShare = kCells / kF32Split;
      for (int item = threadIdx.x; item < kShare * kQuads;
           item += kF32Threads) {
        const int cell = seg * kShare + item / kQuads, s = item % kQuads;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int r = 0; r < kF32Split; ++r) {
          const float4 p =
              cluster.map_shared_rank(s_part, r)[cell * kQuads + s];
          v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
        }
        const F32Cell o = f32_cell(A, unit, cell);
        store_f32x4(A, o.b, o.y, o.x0, o.c + s * 4, v);
      }
      cluster.sync();  // the partials are read before the next unit
    }
  }
}

constexpr int kCellGroup = 16;  // cells reduced by one butterfly
constexpr int kMaxSlots = kMaxTapsPerBin;  // lo, hi of a bin's samples
// Sum of the warp's 32 values of each v[j]: lane l ends with v[(l / 2) % 16]
// in v[0] (a transposing butterfly: each step halves the values a lane
// keeps and swaps the other half with its partner).
__device__ __forceinline__ float warp_sum16(float (&v)[kCellGroup],
                                            int lane) {
#pragma unroll
  for (int m = 16, n = kCellGroup; m >= 2; m >>= 1, n >>= 1) {
    const bool upper = lane & m;
#pragma unroll
    for (int j = 0; j < n / 2; ++j) {
      const float send = upper ? v[j] : v[j + n / 2];
      const float keep = upper ? v[j + n / 2] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// Bin (p, q)'s terms from its cells D (ns x ns, written by this warp) into
// the warp's per-sample sums: lane s < ratio takes y-sample p ratio + s,
// lane 16 + s x-sample q ratio + s.
__device__ __forceinline__ void combine_bin(
    const float* D, int ns, int ratio, int p, int q, int lane,
    const float (*s_w)[2 * kMaxSamples], float (*part)[kMaxSamples]) {
  __syncwarp();
  const int s = lane & 15;
  if (s < ratio) {
    const int axis = lane >> 4;
    const float* ow = s_w[1 - axis] + 2 * (axis == 0 ? q : p) * ratio;
    float v = 0.0f;
    for (int o = 0; o < ns; ++o) {
      const float d = axis == 0
          ? D[(2 * s + 1) * ns + o] - D[2 * s * ns + o]
          : D[o * ns + 2 * s + 1] - D[o * ns + 2 * s];
      v = fmaf(ow[o], d, v);
    }
    part[axis][(axis == 0 ? p : q) * ratio + s] += v;
  }
  __syncwarp();
}

// two blocks an SM (at most 128 registers a thread)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    roi_align_bwd_boxes_kernel(const T* __restrict__ g,
                               const T* __restrict__ fmap,
                               const float* __restrict__ boxes,
                               float* __restrict__ grad_boxes, int R, int H,
                               int W, int C, float scale, int P, int ratio) {
  // element offsets of the slots: row slots (W C a row) and column slots (C
  // a column); sample i's lo tap at 2 i, its hi tap at 2 i + 1, so bin p's
  // slots are p ns .. p ns + ns - 1
  __shared__ int s_off[2][2 * kMaxSamples];
  // slot weights of sample i: w_lo / ratio at 2 i, w_hi / ratio at 2 i + 1
  __shared__ float s_w[2][2 * kMaxSamples];
  __shared__ float s_dm[2][kMaxSamples];
  __shared__ float s_D[kWarps][kMaxSlots * kMaxSlots];
  __shared__ float s_part[kWarps][2][kMaxSamples];
  __shared__ float s_val[2][kMaxSamples];

  const int roi = blockIdx.x;
  const int b = roi / R;
  const int t = threadIdx.x;
  const int S = P * ratio;
  const float* bx = boxes + static_cast<size_t>(roi) * 4;
  if (t < 2 * S) {
    const int axis = t < S ? 0 : 1;
    const int i = t - axis * S;
    float start, extent, raw;
    axis_frame(bx, axis, scale, &start, &extent, &raw);
    const Sample a = axis_sample(start, extent, i, S, axis == 0 ? H : W);
    const float inv = 1.0f / static_cast<float>(ratio);
    const int stride = axis == 0 ? W * C : C;
    s_off[axis][2 * i] = a.lo * stride;
    s_off[axis][2 * i + 1] = a.hi * stride;
    s_w[axis][2 * i] = a.w_lo * inv;
    s_w[axis][2 * i + 1] = a.w_hi * inv;
    s_dm[axis][i] = a.dmask / static_cast<float>(ratio);
  }
  for (int e = t; e < kWarps * 2 * kMaxSamples; e += kThreads)
    (&s_part[0][0][0])[e] = 0.0f;
  __syncthreads();

  const int lane = t & 31, warp = t >> 5;
  const int ns = 2 * ratio, ncells = ns * ns;
  const T* gr = g + static_cast<size_t>(roi) * P * P * C;
  const T* fm = fmap + static_cast<size_t>(b) * H * W * C;
  const int chunks = C / V;
  float* D = s_D[warp];
  for (int bin = warp; bin < P * P; bin += kWarps) {
    const int p = bin / P, q = bin - p * P;
    const T* gb = gr + static_cast<size_t>(bin) * C;
    for (int grp = 0; grp < ncells; grp += kCellGroup) {
      int off[kCellGroup];
#pragma unroll
      for (int j = 0; j < kCellGroup; ++j) {
        const int cell = min(grp + j, ncells - 1);  // row slot, column slot
        off[j] = s_off[0][p * ns + cell / ns] + s_off[1][q * ns + cell % ns];
      }
      float part[kCellGroup];
#pragma unroll
      for (int j = 0; j < kCellGroup; ++j) part[j] = 0.0f;
      for (int ch = lane; ch < chunks; ch += 32) {
        const int c = ch * V;
        // all 17 loads in flight before the first use (a cell past
        // ncells repeats the last one and is dropped below)
        const Raw<T, V> graw = load_raw<T, V>(gb + c);
        Raw<T, V> fraw[kCellGroup];
#pragma unroll
        for (int j = 0; j < kCellGroup; ++j)
          fraw[j] = load_raw<T, V>(fm + off[j] + c);
        float gv[V];
        unpack<T, V>(graw, gv);
#pragma unroll
        for (int j = 0; j < kCellGroup; ++j) {
          float fv[V];
          unpack<T, V>(fraw[j], fv);
#pragma unroll
          for (int k = 0; k < V; ++k)
            part[j] = fmaf(gv[k], fv[k], part[j]);
        }
      }
      const float total = warp_sum16(part, lane);
      const int cell = grp + ((lane >> 1) & (kCellGroup - 1));
      if ((lane & 1) == 0 && cell < ncells) D[cell] = total;
    }
    combine_bin(D, ns, ratio, p, q, lane, s_w, s_part[warp]);
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

template <typename T, int V>
void launch_gather(const void* g, const int* ws, const Layout& L,
                   void* grad_fmap, int B, int H, int W, int C, int R, int P,
                   cudaStream_t s) {
  const int chunks = (C + 32 * V - 1) / (32 * V);
  fmap_gather_kernel<T, V><<<B * L.nty * L.ntx * chunks, 32 * kTileH, 0,
                             s>>>(
      static_cast<const T*>(g), ws, ws + L.lists, ws + L.infos,
      reinterpret_cast<const float*>(ws + L.lines), static_cast<T*>(grad_fmap),
      R, H, W, C, P, L.nty, L.ntx, chunks);
}

// Once a process: the tensor-core kernels' shared memory limit (above the
// default 48 KB), a side stream and two events for the heavy units' launch,
// and the card's SM count (returned), or -(CUDA error). One card, the
// port's.
cudaStream_t g_side;
cudaEvent_t g_fork, g_join;
int mma_setup() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaStreamCreateWithFlags(&g_side,
                                         cudaStreamNonBlocking)) !=
            cudaSuccess ||
        (err = cudaEventCreateWithFlags(&g_fork, cudaEventDisableTiming)) !=
            cudaSuccess ||
        (err = cudaEventCreateWithFlags(&g_join, cudaEventDisableTiming)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             fmap_gather_mma_kernel,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             kMmaSmemFixed + 12 * kMmaMaxR)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             fmap_gather_mma_heavy_kernel,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             kMmaSmemFixed + 12 * kMmaMaxR)) != cudaSuccess)
      return -static_cast<int>(err);
    return n;
  }();
  return sms;
}

// Once a process, after mma_setup: the staged f32 kernels' shared memory
// limit. The card's SM count (returned), or -(CUDA error).
int f32_setup() {
  static const int sms = [] {
    const int n = mma_setup();
    if (n < 0) return n;
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(
             staged_fmap_gather_kernel,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             kF32SmemFixed + 12 * kMmaMaxR)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             staged_heavy_fmap_gather_kernel,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             kF32SmemFixed + 12 * kMmaMaxR)) != cudaSuccess)
      return -static_cast<int>(err);
    return n;
  }();
  return sms;
}

// K1-bwd-fmap's routes, chosen from what the launcher sees: the map's type
// (dtype 0 float32, 1 bfloat16), C, g's address and R (ROIs an image);
// sgg_torch/ops/roi_align.py:fmap_route mirrors it.
enum FmapRoute {
  kF32Staged = 0,   // (4d, 4e)
  kF32Gather = 1,   // (4a)
  kBf16Mma = 2,     // (4b, 4c)
  kBf16Gather = 3,  // (4a)
};

int fmap_route(int dtype, int C, const void* g, int R) {
  const bool staged =
      reinterpret_cast<uintptr_t>(g) % 16 == 0 && R <= kMmaMaxR;
  if (dtype == 1) return C % 8 == 0 && staged ? kBf16Mma : kBf16Gather;
  return C % 4 == 0 && staged ? kF32Staged : kF32Gather;
}

// The staged f32 gather: the heavy units on the side stream, forked from
// and joined back into s, beside the light ones, as the tensor-core route.
int launch_staged(const void* g, const int* ws, const Layout& L,
                  void* grad_fmap, int B, int H, int W, int C, int R, int P,
                  cudaStream_t s) {
  const int chunks = (C + kF32Channels - 1) / kF32Channels;
  const F32Args A{static_cast<const float*>(g), ws, ws + L.krows,
                  ws + L.lists, ws + L.infos, ws + L.koffs,
                  reinterpret_cast<const float*>(ws + L.lines),
                  static_cast<float*>(grad_fmap), R, H, W, C, P, L.nty,
                  L.ntx, chunks};
  const int units = B * L.nty * L.ntx * chunks;
  const size_t smem = kF32SmemFixed + 3 * sizeof(int) * static_cast<size_t>(R);
  const int sms = f32_setup();
  if (sms < 0) return -sms;
  // as many clusters as the card holds at once at this shared memory (a
  // persistent cluster that waits for a slot would run its units after
  // the others')
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kF32Split * sms, 1, 1);
  cfg.blockDim = dim3(kF32Threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(
      &clusters, staged_heavy_fmap_gather_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  clusters = max(clusters, 1);
  if ((err = cudaEventRecord(g_fork, s)) != cudaSuccess ||
      (err = cudaStreamWaitEvent(g_side, g_fork, 0)) != cudaSuccess)
    return static_cast<int>(err);
  staged_heavy_fmap_gather_kernel<<<clusters * kF32Split, kF32Threads, smem,
                                    g_side>>>(A, units);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = cudaEventRecord(g_join, g_side)) != cudaSuccess)
    return static_cast<int>(err);
  staged_fmap_gather_kernel<<<units, kF32Threads, smem, s>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = cudaStreamWaitEvent(s, g_join, 0)) != cudaSuccess)
    return static_cast<int>(err);
  return 0;
}

template <typename T>
int launch_fmap(const void* g, const void* boxes, void* workspace,
                size_t workspace_bytes, void* grad_fmap, int B, int H, int W,
                int C, int R, float scale, int P, int ratio, cudaStream_t s) {
  const Layout L = fmap_layout(B, H, W, R, P);
  if (workspace_bytes < L.words * sizeof(int))
    return static_cast<int>(cudaErrorInvalidValue);
  int* ws = static_cast<int*>(workspace);
  unsigned* masks = reinterpret_cast<unsigned*>(ws + L.masks);
  float* lines = reinterpret_cast<float*>(ws + L.lines);
  const float* bx = static_cast<const float*>(boxes);
  cudaError_t err;
  if (R > 0) {
    const int n = B * R * (2 + H + W);
    tile_masks_lines_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        bx, masks, lines, B * R, H, W, scale, P, ratio, L.my, L.mx);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  const int tiles = B * L.nty * L.ntx;
  tile_lists_kernel<<<tiles, kListThreads, 0, s>>>(
      bx, masks, ws, ws + L.krows, ws + L.lists, ws + L.infos, ws + L.koffs,
      R, H, W, scale, P, ratio, L.nty, L.ntx, L.my, L.mx);
  if ((err = cudaGetLastError()) != cudaSuccess)
    return static_cast<int>(err);
  const size_t smem = kMmaSmemFixed + 3 * sizeof(int) * static_cast<size_t>(R);
  const int route =
      fmap_route(std::is_same<T, float>::value ? 0 : 1, C, g, R);
  if (route == kBf16Mma) {
    const int chunks = (C + kMmaChannels - 1) / kMmaChannels;
    const MmaArgs A{static_cast<const __nv_bfloat16*>(g), ws, ws + L.krows,
                    ws + L.lists, ws + L.infos, ws + L.koffs, lines,
                    static_cast<__nv_bfloat16*>(grad_fmap), R, H, W, C, P,
                    L.nty, L.ntx, chunks};
    const int units = tiles * chunks;
    const int sms = mma_setup();
    if (sms < 0) return -sms;
    // the heavy units on a side stream, forked from and joined back into
    // s, beside the light ones (the two write disjoint units): three
    // clusters for every kSplit SMs (three blocks an SM)
    const int clusters = sms / kSplit > 0 ? 3 * (sms / kSplit) : 1;
    if ((err = cudaEventRecord(g_fork, s)) != cudaSuccess ||
        (err = cudaStreamWaitEvent(g_side, g_fork, 0)) != cudaSuccess)
      return static_cast<int>(err);
    fmap_gather_mma_heavy_kernel<<<clusters * kSplit, kTileThreads, smem,
                                   g_side>>>(A, units);
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (err = cudaEventRecord(g_join, g_side)) != cudaSuccess)
      return static_cast<int>(err);
    fmap_gather_mma_kernel<<<units, kTileThreads, smem, s>>>(A);
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (err = cudaStreamWaitEvent(s, g_join, 0)) != cudaSuccess)
      return static_cast<int>(err);
  } else if (route == kF32Staged) {
    if ((err = static_cast<cudaError_t>(launch_staged(
             g, ws, L, grad_fmap, B, H, W, C, R, P, s))) != cudaSuccess)
      return static_cast<int>(err);
  } else if (C % 4 == 0 &&
             reinterpret_cast<uintptr_t>(g) % (4 * sizeof(T)) == 0) {
    launch_gather<T, 4>(g, ws, L, grad_fmap, B, H, W, C, R, P, s);
  } else {
    launch_gather<T, 1>(g, ws, L, grad_fmap, B, H, W, C, R, P, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
void launch_boxes_v(const void* g, const void* fmap, const void* boxes,
                    float* grad_boxes, int B, int H, int W, int C, int R,
                    float scale, int P, int ratio, cudaStream_t s) {
  roi_align_bwd_boxes_kernel<T, V><<<B * R, kThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(fmap),
      static_cast<const float*>(boxes), grad_boxes, R, H, W, C, scale, P,
      ratio);
}

// 16-byte chunks (8 bf16 or 4 f32 channels) where C and both tensors'
// alignment allow, else pairs, else single channels.
template <typename T>
int launch_boxes(const void* g, const void* fmap, const void* boxes,
                 float* grad_boxes, int B, int H, int W, int C, int R,
                 float scale, int P, int ratio, cudaStream_t s) {
  constexpr int kWide = 16 / sizeof(T);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(fmap);
  if (C % kWide == 0 && addr % 16 == 0)
    launch_boxes_v<T, kWide>(g, fmap, boxes, grad_boxes, B, H, W, C, R,
                             scale, P, ratio, s);
  else if (C % 2 == 0 && addr % (2 * sizeof(T)) == 0)
    launch_boxes_v<T, 2>(g, fmap, boxes, grad_boxes, B, H, W, C, R, scale,
                         P, ratio, s);
  else
    launch_boxes_v<T, 1>(g, fmap, boxes, grad_boxes, B, H, W, C, R, scale,
                         P, ratio, s);
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

// K1-bwd-fmap's workspace for (B, H, W, R, pooled): out[0] and out[1] the
// tile's rows and columns of map cells, out[2] and out[3] the tiles along y
// and x, out[4] its bytes, out[5] and out[6] the word offsets of the tile
// lists and of the ROI masks (the tiles' counts at word 0). Launches
// nothing.
int sgg_roi_align_bwd_fmap_layout(int B, int H, int W, int R, int pooled,
                                  long long* out) {
  const Layout L = fmap_layout(B, H, W, R, pooled);
  out[0] = kTileH;
  out[1] = kTileW;
  out[2] = L.nty;
  out[3] = L.ntx;
  out[4] = static_cast<long long>(L.words * sizeof(int));
  out[5] = static_cast<long long>(L.lists);
  out[6] = static_cast<long long>(L.masks);
  return 0;
}

// K1-bwd-fmap's route for a map of `dtype` (0 float32, 1 bfloat16) with C
// channels, g at `g` and R ROIs an image: 0 f32-staged, 1 f32-gather, 2
// bf16-mma, 3 bf16-gather; *heavy the k-rows of a tile past which the
// route splits a unit between the blocks of a cluster (0 where it never
// does). Launches nothing.
int sgg_roi_align_bwd_fmap_route(int dtype, int C, const void* g, int R,
                                 long long* heavy) {
  const int route = fmap_route(dtype, C, g, R);
  *heavy = route == kF32Staged ? kF32HeavyBatches * kF32KRows
           : route == kBf16Mma ? kHeavyBatches * kKRows : 0;
  return route;
}

// grad_fmap (B, H, W, C) in the map's type (dtype 0 float32, 1 bfloat16)
// of roi_align from g (B, R, P, P, C); workspace: at least the bytes that
// sgg_roi_align_bwd_fmap_layout gives, which need no clearing.
int sgg_roi_align_bwd_fmap(const void* g, const void* boxes, void* workspace,
                           size_t workspace_bytes, void* grad_fmap, int B,
                           int H, int W, int C, int R, float scale,
                           int pooled, int ratio, int dtype, void* stream) {
  if (bad_args(pooled, ratio)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || C == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_fmap<__nv_bfloat16>(g, boxes, workspace, workspace_bytes,
                                      grad_fmap, B, H, W, C, R, scale, pooled,
                                      ratio, s);
  return launch_fmap<float>(g, boxes, workspace, workspace_bytes, grad_fmap,
                            B, H, W, C, R, scale, pooled, ratio, s);
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
