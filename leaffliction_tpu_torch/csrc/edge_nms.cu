// Canny front end K5: 5x5 Gaussian blur (sigma 1.4), Sobel 3x3, L1 or L2
// magnitude and 4-sector non-maximum suppression, f32 [n, h, w] -> f32
// [n, h, w], h, w >= 3.
//
// Replaces the Pallas TPU kernel
// leaffliction_tpu/ops/pallas/edge.py::edge_nms_batch (_edge_kernel). Its
// answer is the one of leaffliction_tpu/ops/filters.py::_edge_nms_jnp, which is
// cv2's: reflect-101 borders for the blur and the Sobel taps, and NMS
// neighbours that wrap around the image. (The Pallas kernel pads with zeros
// only because Mosaic cannot lower a reflect; its interior is the same.)
//
// The arithmetic follows the plain PyTorch twin
// (leaffliction_tpu_torch/ops/kernels/edge.py::edge_nms_plain) operation by
// operation: each separable pass runs vertical first, then horizontal, and
// sums its taps in the twin's order, one rounded multiply and one rounded
// add per tap. The library is compiled with -fmad=false so no multiply-add
// is contracted, and the result is bit-equal to the twin, so NMS ties
// cannot flip between the two.
//
// What bounds it on an H100: latency. A 224x224 image is 200 KB of f32 in
// and out, 0.12 us of HBM time at 3.35 TB/s. So a call is one launch that
// allocates nothing: a block owns a 16x32 output tile of one image (98
// blocks at 224^2, one an SM) and keeps every intermediate in shared
// memory, as grids indexed by virtual (padded) coordinates around the tile:
//   gray  24x40: ring 4, each cell the gray value at its reflect-101 image
//                position;
//   vert  20x40: the blur's vertical pass at the in-image rows of ring 2;
//   blur  20x36: the blur at the in-image cells of ring 2;
//   mag   18x34: the magnitude on the tile and its ring 1, and the sector of
//                each tile pixel.
// Two border rules keep it bit-equal to the twin:
//   - a blur or Sobel tap outside the image reads the value at the
//     reflected position, computed there (blur of an out-of-image cell is
//     never formed around the virtual cell: its five taps would be the same
//     values summed in another order);
//   - an NMS neighbour outside the image is the magnitude at the wrapped
//     position, on the opposite edge. A border tile also loads the gray
//     values that those cells' blur reaches (four rows or columns at the
//     opposite edge, a 4x4 patch at the opposite corner) in the same batch
//     of loads as its own, computes from them the few blur values the
//     cells need with the same operations in the same order, and their
//     magnitudes with the rest.
// Each thread issues all of its loads before its first store, then takes
// one grid cell at a time in each stage, four barriers between the stages.
// A tile whose gray grid lies inside the image runs the same stages
// without reflecting an index or testing a bound (tile_stages<true>).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "device_guard.cuh"

namespace {

// gaussian_kernel_1d(5, 1.4) of ops/filters.py in f32
#define LEAF_GAUSS5                                            \
  {                                                            \
    0x1.c36afep-4f, 0x1.e53220p-3f, 0x1.391860p-2f,            \
        0x1.e53220p-3f, 0x1.c36afep-4f                         \
  }
__constant__ float kGauss[5] = LEAF_GAUSS5;
const float kGaussHost[5] = LEAF_GAUSS5;

constexpr int kTH = 16;          // output tile rows
constexpr int kTW = 32;          // output tile columns
constexpr int kThreads = 256;
constexpr int kGH = kTH + 8;     // gray grid: ring 4
constexpr int kGW = kTW + 8;
constexpr int kBH = kTH + 4;     // blur grid: ring 2
constexpr int kBW = kTW + 4;
constexpr int kMH = kTH + 2;     // magnitude grid: ring 1
constexpr int kMW = kTW + 2;

// Gray values in shared memory, one pool in load-slot order:
//   the grid            kGH x kGW, at virtual (y0 - 4 + i, x0 - 4 + j);
//   two row strips      4 x kGW each: image rows h - 4 .. h - 1 (for the
//                       top side's ring) and 0 .. 3 (bottom), the grid's
//                       columns;
//   two column strips   kGH x 4 each: image columns w - 4 .. w - 1 (left)
//                       and 0 .. 3 (right), the grid's rows;
//   four corner patches 4 x 4: the opposite corner's rows and columns.
constexpr int kPoolGrid = 0;
constexpr int kPoolRows = kPoolGrid + kGH * kGW;
constexpr int kPoolCols = kPoolRows + 2 * 4 * kGW;
constexpr int kPoolCorners = kPoolCols + 2 * kGH * 4;
constexpr int kPool = kPoolCorners + 4 * 4 * 4;
constexpr int kLoadIters = (kPool + kThreads - 1) / kThreads;

__device__ __forceinline__ int reflect101(int i, int n) {
  // cv2 BORDER_REFLECT_101 for offsets of at most 2 beyond the edge (n >= 3)
  if (i < 0) return -i;
  if (i >= n) return 2 * n - 2 - i;
  return i;
}

// gradient of a 3x3 blur neighbourhood b[row][col] -> magnitude; sector of
// the gradient (0 ~horizontal, 2 ~vertical, 1 and 3 the diagonals).
// Sobel gx: vertical [1,2,1], horizontal [-1,0,1]; gy: vertical [-1,0,1],
// horizontal [1,2,1]; each in the twin's tap order.
__device__ __forceinline__ float sobel_mag(const float (&b)[3][3], int l2,
                                           uint8_t* sector) {
  const float smooth[3] = {1.0f, 2.0f, 1.0f};
  const float diff[3] = {-1.0f, 0.0f, 1.0f};
  float gx = 0.0f, gy = 0.0f;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    float vs = smooth[0] * b[0][s];
    float vd = diff[0] * b[0][s];
#pragma unroll
    for (int t = 1; t < 3; ++t) {
      vs = vs + smooth[t] * b[t][s];
      vd = vd + diff[t] * b[t][s];
    }
    gx = s == 0 ? diff[0] * vs : gx + diff[s] * vs;
    gy = s == 0 ? smooth[0] * vd : gy + smooth[s] * vd;
  }
  const float ax = fabsf(gx), ay = fabsf(gy);
  if (sector) {
    if (ay <= 0.41421356f * ax) *sector = 0;
    else if (ay > 2.41421356f * ax) *sector = 2;
    else *sector = (gx * gy) >= 0.0f ? 1 : 3;
  }
  return l2 ? sqrtf(gx * gx + gy * gy) : ax + ay;
}

// The blur sum_s G[s] * (sum_t G[t] * g(t, s)) of a 5x5 neighbourhood,
// vertical pass first, in the twin's order.
template <typename Tap>
__device__ __forceinline__ float blur5(Tap g) {
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    float col = kGauss[0] * g(0, s);
#pragma unroll
    for (int t = 1; t < 5; ++t) col = col + kGauss[t] * g(t, s);
    acc = s == 0 ? kGauss[0] * col : acc + kGauss[s] * col;
  }
  return acc;
}

// The NMS ring of a border tile: magnitude cells outside the image, each
// the magnitude at its wrapped image position. On a row side (virtual row
// -1 or h, wrapped to image row R = h - 1 or 0) the 3x3 blur around (R, x)
// takes image rows refl(R - 1), R, refl(R + 1): two rows, L0 = refl(R - 1)
// = refl(R + 1) and L1 = R, at the columns around x, which lie in the
// tile's blur-grid columns. So a side keeps two blur lines along the tile
// (rows on a row side, columns on a column side), and a corner cell
// (virtual row and column both outside) its own 3x3.
// Sides: 0 top (row -1), 1 bottom (row h), 2 left (column -1), 3 right
// (column w); corners 2 * (row == h) + (column == w).
__device__ __forceinline__ bool has_side(int side, int y0, int x0, int h,
                                         int w) {
  switch (side) {
    case 0: return y0 == 0;
    case 1: return y0 + kTH >= h;
    case 2: return x0 == 0;
    default: return x0 + kTW >= w;
  }
}

// the wrapped image row (sides 0, 1) or column (2, 3) of a side's ring
__device__ __forceinline__ int side_r(int side, int h, int w) {
  return side == 0 ? h - 1 : side == 2 ? w - 1 : 0;
}

// the first image row (sides 0, 1) or column (2, 3) of a side's strip
__device__ __forceinline__ int strip_base(int side, int h, int w) {
  return side == 0 ? h - 4 : side == 2 ? w - 4 : 0;
}

// load slot e of the pool -> global offset in the image, or -1
__device__ __forceinline__ int64_t pool_source(int e, int y0, int x0, int h,
                                               int w) {
  if (e < kPoolRows) {  // the grid
    const int y = y0 - 4 + e / kGW, x = x0 - 4 + e % kGW;
    if (y < -2 || y > h + 1 || x < -2 || x > w + 1) return -1;
    return (int64_t)reflect101(y, h) * w + reflect101(x, w);
  }
  if (e < kPoolCols) {  // a row strip: side, strip row, grid column
    const int k = e - kPoolRows;
    const int side = k / (4 * kGW);
    const int y = strip_base(side, h, w) + (k / kGW) % 4;
    const int x = x0 - 4 + k % kGW;
    if (!has_side(side, y0, x0, h, w) || y < 0 || y >= h || x < -2 ||
        x > w + 1)
      return -1;
    return (int64_t)y * w + reflect101(x, w);
  }
  if (e < kPoolCorners) {  // a column strip: side, grid row, strip column
    const int k = e - kPoolCols;
    const int side = 2 + k / (4 * kGH);
    const int y = y0 - 4 + (k / 4) % kGH;
    const int x = strip_base(side, h, w) + k % 4;
    if (!has_side(side, y0, x0, h, w) || x < 0 || x >= w || y < -2 ||
        y > h + 1)
      return -1;
    return (int64_t)reflect101(y, h) * w + x;
  }
  if (e < kPool) {  // a corner patch
    const int k = e - kPoolCorners;
    const int c = k / 16;
    const int y = strip_base(c >> 1, h, w) + (k / 4) % 4;
    const int x = strip_base(2 + (c & 1), h, w) + k % 4;
    if (!has_side(c >> 1, y0, x0, h, w) ||
        !has_side(2 + (c & 1), y0, x0, h, w) || y < 0 || y >= h || x < 0 ||
        x >= w)
      return -1;
    return (int64_t)y * w + x;
  }
  return -1;
}

// The block's shared memory.
struct TileSmem {
  float pool[kPool];
  float vt[kBH][kGW];
  float bs[kBH][kBW];
  float ms[kMH][kMW];
  float side_row[2][2][kBW];  // the ring's blur lines
  float side_col[2][2][kBH];
  float corner_blur[4][3][3];
  uint8_t sec[kTH][kTW];
};

// reflect-101, the identity on a tile whose reach lies inside the image
template <bool kIn>
__device__ __forceinline__ int refl(int i, int n) {
  return kIn ? i : reflect101(i, n);
}

// The stages of one tile. kIn: the tile's gray grid lies inside the image
// (rows y0 - 4 .. y0 + kTH + 3, columns x0 - 4 .. x0 + kTW + 3), so no
// index reflects and no cell is outside; the same arithmetic either way.
template <bool kIn>
__device__ __forceinline__ void tile_stages(const float* __restrict__ img,
                                            float* __restrict__ dst, int h,
                                            int w, int y0, int x0, int l2,
                                            TileSmem& sm) {
  const bool border =
      !kIn && (y0 == 0 || x0 == 0 || y0 + kTH >= h || x0 + kTW >= w);

  // every gray value the block reads, its loads issued before any store
  {
    float v[kLoadIters];
    int64_t src[kLoadIters];
#pragma unroll
    for (int it = 0; it < kLoadIters; ++it) {
      const int e = threadIdx.x + it * kThreads;
      if (kIn) {
        src[it] = e < kPoolRows ? (int64_t)(y0 - 4 + e / kGW) * w + x0 - 4 +
                                      e % kGW
                                : -1;
      } else {
        src[it] = e < kPoolRows || border ? pool_source(e, y0, x0, h, w) : -1;
      }
      if (src[it] >= 0) v[it] = __ldg(img + src[it]);
    }
#pragma unroll
    for (int it = 0; it < kLoadIters; ++it)
      if (src[it] >= 0) sm.pool[threadIdx.x + it * kThreads] = v[it];
  }
  __syncthreads();
  const float* gs = sm.pool + kPoolGrid;

  // the vertical pass at in-image rows y0 - 2 + i, virtual columns
  // x0 - 4 + j (each the column at its reflected position)
  for (int k = threadIdx.x; k < kBH * kGW; k += kThreads) {
    const int i = k / kGW, j = k - (k / kGW) * kGW;
    const int y = y0 - 2 + i, x = x0 - 4 + j;
    if (kIn || (y >= 0 && y < h && x >= -2 && x <= w + 1)) {
      float col = kGauss[0] * gs[i * kGW + j];
#pragma unroll
      for (int t = 1; t < 5; ++t) col = col + kGauss[t] * gs[(i + t) * kGW + j];
      sm.vt[i][j] = col;
    }
  }
  // a border tile's ring blur values, from the strips and patches
  if (border) {
    constexpr int kRowSlots = 2 * 2 * kBW, kColSlots = 2 * 2 * kBH;
    for (int k = threadIdx.x; k < kRowSlots + kColSlots + 4 * 9;
         k += kThreads) {
      if (k < kRowSlots) {  // row side, line, grid column q
        const int side = k / (2 * kBW), line = (k / kBW) & 1;
        const int q = k % kBW, x = x0 - 2 + q;
        if (!has_side(side, y0, x0, h, w) || x < 0 || x >= w) continue;
        const int r = side_r(side, h, w);
        const int l = line ? r : reflect101(r - 1, h);
        const float* strip = sm.pool + kPoolRows + side * 4 * kGW;
        const int base = strip_base(side, h, w);
        sm.side_row[side][line][q] = blur5([&](int t, int s) {
          return strip[(reflect101(l + t - 2, h) - base) * kGW + q + s];
        });
      } else if (k < kRowSlots + kColSlots) {  // column side, line, grid row
        const int kk = k - kRowSlots;
        const int side = 2 + kk / (2 * kBH), line = (kk / kBH) & 1;
        const int q = kk % kBH, y = y0 - 2 + q;
        if (!has_side(side, y0, x0, h, w) || y < 0 || y >= h) continue;
        const int r = side_r(side, h, w);
        const int l = line ? r : reflect101(r - 1, w);
        const float* strip = sm.pool + kPoolCols + (side - 2) * kGH * 4;
        const int base = strip_base(side, h, w);
        sm.side_col[side - 2][line][q] = blur5([&](int t, int s) {
          return strip[(q + t) * 4 + reflect101(l + s - 2, w) - base];
        });
      } else {  // corner c, blur tap (t, s)
        const int kk = k - kRowSlots - kColSlots;
        const int c = kk / 9, t = (kk % 9) / 3, s = kk % 3;
        if (!has_side(c >> 1, y0, x0, h, w) ||
            !has_side(2 + (c & 1), y0, x0, h, w))
          continue;
        const int by = reflect101(side_r(c >> 1, h, w) + t - 1, h);
        const int bx = reflect101(side_r(2 + (c & 1), h, w) + s - 1, w);
        const int ry = strip_base(c >> 1, h, w);
        const int rx = strip_base(2 + (c & 1), h, w);
        const float* patch = sm.pool + kPoolCorners + c * 16;
        sm.corner_blur[c][t][s] = blur5([&](int t2, int s2) {
          return patch[(reflect101(by + t2 - 2, h) - ry) * 4 +
                       reflect101(bx + s2 - 2, w) - rx];
        });
      }
    }
  }
  __syncthreads();

  // the horizontal pass: blur at in-image cells (y0 - 2 + i, x0 - 2 + j)
  for (int k = threadIdx.x; k < kBH * kBW; k += kThreads) {
    const int i = k / kBW, j = k - (k / kBW) * kBW;
    const int y = y0 - 2 + i, x = x0 - 2 + j;
    if (kIn || (y >= 0 && y < h && x >= 0 && x < w)) {
      float acc = kGauss[0] * sm.vt[i][j];
#pragma unroll
      for (int s = 1; s < 5; ++s) acc = acc + kGauss[s] * sm.vt[i][j + s];
      sm.bs[i][j] = acc;
    }
  }
  __syncthreads();

  // magnitude at virtual (y0 - 1 + i, x0 - 1 + j): in the image from the
  // blur grid at reflected rows and columns, outside it (the NMS ring of a
  // border tile) at the wrapped position from the ring's blur values
  for (int k = threadIdx.x; k < kMH * kMW; k += kThreads) {
    const int i = k / kMW, j = k - (k / kMW) * kMW;
    const int y = y0 - 1 + i, x = x0 - 1 + j;
    if (!kIn && (y < -1 || y > h || x < -1 || x > w)) continue;
    float nb[3][3];
    uint8_t* sector = nullptr;
    const bool row_in = kIn || (y >= 0 && y < h);
    const bool col_in = kIn || (x >= 0 && x < w);
    if (row_in && col_in) {
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int r = refl<kIn>(y + t - 1, h) - (y0 - 2);
#pragma unroll
        for (int s = 0; s < 3; ++s)
          nb[t][s] = sm.bs[r][refl<kIn>(x + s - 1, w) - (x0 - 2)];
      }
      if (i >= 1 && i <= kTH && j >= 1 && j <= kTW)
        sector = &sm.sec[i - 1][j - 1];
    } else if (row_in) {  // a column side: lines L0, L1, L0 across
      const int side = x < 0 ? 0 : 1;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int q = reflect101(y + t - 1, h) - (y0 - 2);
#pragma unroll
        for (int s = 0; s < 3; ++s) nb[t][s] = sm.side_col[side][s == 1][q];
      }
    } else if (col_in) {  // a row side: lines L0, L1, L0 down
      const int side = y < 0 ? 0 : 1;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int q = reflect101(x + s - 1, w) - (x0 - 2);
#pragma unroll
        for (int t = 0; t < 3; ++t) nb[t][s] = sm.side_row[side][t == 1][q];
      }
    } else {
      const int c = 2 * (y >= h) + (x >= w);
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int s = 0; s < 3; ++s) nb[t][s] = sm.corner_blur[c][t][s];
    }
    sm.ms[i][j] = sobel_mag(nb, l2, sector);
  }
  __syncthreads();

  // NMS of the tile's in-image pixels
  for (int k = threadIdx.x; k < kTH * kTW; k += kThreads) {
    const int i = k / kTW, j = k - (k / kTW) * kTW;
    const int y = y0 + i, x = x0 + j;
    if (!kIn && (y >= h || x >= w)) continue;
    int ay, ax, by, bx;  // the two neighbours along the gradient
    switch (sm.sec[i][j]) {
      case 0: ay = 0; ax = -1; by = 0; bx = 1; break;
      case 1: ay = 1; ax = -1; by = -1; bx = 1; break;
      case 2: ay = -1; ax = 0; by = 1; bx = 0; break;
      default: ay = -1; ax = -1; by = 1; bx = 1; break;
    }
    const float m = sm.ms[i + 1][j + 1];
    const float na = sm.ms[i + 1 + ay][j + 1 + ax];
    const float nb = sm.ms[i + 1 + by][j + 1 + bx];
    dst[(int64_t)y * w + x] = (m >= na && m >= nb) ? m : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    edge_nms_tile(const float* __restrict__ gray, float* __restrict__ out,
                  int h, int w, int tiles_x, int tiles_y, int l2) {
  __shared__ TileSmem sm;
  const int tx = blockIdx.x % tiles_x;
  const int rest = blockIdx.x / tiles_x;
  const int ty = rest % tiles_y;
  const int b = rest / tiles_y;
  const int y0 = ty * kTH;
  const int x0 = tx * kTW;
  const float* img = gray + (int64_t)b * h * w;
  float* dst = out + (int64_t)b * h * w;
  if (y0 >= 4 && x0 >= 4 && y0 + kTH + 4 <= h && x0 + kTW + 4 <= w)
    tile_stages<true>(img, dst, h, w, y0, x0, l2, sm);
  else
    tile_stages<false>(img, dst, h, w, y0, x0, l2, sm);
}

}  // namespace

// the Gaussian taps the kernel uses, f32 [5] (for the tests)
extern "C" int leaf_edge_taps(float* taps) {
  memcpy(taps, kGaussHost, sizeof(kGaussHost));
  return 0;
}

// output tiles of one image (blocks per image) for h x w
extern "C" int leaf_edge_nms_tiles(int h, int w) {
  return ((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW);
}

// gray, out: f32 [n, h, w] contiguous on device `device`; h, w >= 3; l2: 0
// or 1. One launch of n * leaf_edge_nms_tiles(h, w) blocks; no scratch.
// Returns cudaGetLastError() after the launch.
extern "C" int leaf_edge_nms(const float* gray, float* out, int n, int h,
                             int w, int l2, int device, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n < 0 || h < 3 || w < 3) return (int)cudaErrorInvalidValue;
  const int tiles_x = (w + kTW - 1) / kTW;
  const int tiles_y = (h + kTH - 1) / kTH;
  const int64_t blocks = (int64_t)n * tiles_x * tiles_y;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  return on_device(device, [&] {
    edge_nms_tile<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        gray, out, h, w, tiles_x, tiles_y, l2);
    return cudaGetLastError();
  });
}
