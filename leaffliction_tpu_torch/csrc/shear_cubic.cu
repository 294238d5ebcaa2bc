// Cubic shear K3: uint8 NHWC [n, h, w, 3] -> uint8 [n, h, w, 3], the
// origin-anchored PIL shear [1,s,0,0,1,0] (horizontal) or [1,0,0,s,1,0]
// (vertical) with Keys bicubic (a = -0.5) taps and black fill.
//
// Replaces the Pallas TPU kernel shear_batch_pallas (_shear_slab_kernel) of
// leaffliction_tpu/ops/pallas/rotate.py. That kernel runs a row pass with
// coefficient s*horizontal and a column pass with s*(1-horizontal); the
// inactive one has coefficient 0 and is an exact identity (Keys weights
// w(0) = 1, w(1) = w(2) = 0), so here each image runs its active pass only.
//
// For a horizontal shear, output (y, x) samples row y at x + g with
// g = s*(y + 0.5), k = floor(g), f = g - k, from the four taps
// x + k + {-1, 0, 1, 2} weighted w(1+f), w(f), w(1-f), w(2-f). A tap outside
// [0, w-1] is dropped (weight 0) and the sum is divided by the kept weights'
// sum `den` (by 1 where |den| <= 1e-6). The output is the fill (0) unless
// the source is inside the band (x + 0.5) + s*(y + 0.5) in [0, w], tested
// sign-exactly from the 12-bit split of s (warp_common.cuh). That band is
// closed at w (a source exactly on w - 0.5 is kept), as in the Pallas
// kernel; ops/resample.py's `_in_bounds` is half-open there. The vertical
// shear is the same along columns. Result: round half to even, clip, uint8.
// With -fmad=false the arithmetic repeats the plain twin's
// (ops/kernels/warp.py) operation for operation. The kernel computes s's
// 12-bit split itself (shear_of, the operations of the twin's
// shear_controls), so the wrapper hands in the shears and the direction
// flags as they come; leaf_shear_controls runs that code alone for a test.
//
// What bounds it on an H100: bytes in principle (at 64 x 224^2 the call
// reads and writes 9.6 MB of uint8 each: 5.75 us at 3.35 TB/s), instruction
// issue in practice (about 140 instructions a pixel, three IEEE divisions
// among them). A shear moves pixels along one axis only. A horizontal
// shear's block takes a band of whole rows, one run of memory in and out,
// and needs no other input. A vertical shear's block takes a tile of 32
// columns by a band of rows and stages the input rows its columns' shifts
// reach (96-byte row runs; thin bands of whole columns made 12-byte runs
// and ran several times slower). A block stages its input in shared memory
// with 16-byte loads, computes each line's tap offset, weights, their sum
// and its valid lanes once, gives a thread a pixel (its three channels from
// one set of tap positions and weights), writes its output into shared
// memory and stores it with 16-byte stores. The blocks an image takes are
// sized at launch so that the call fills the card in one wave
// (leaf_shear_cubic_blocks_per_image). A line longer than shared memory
// holds (leaf_shear_cubic_smem_bytes = 0) takes the simple kernel, one
// thread per output pixel reading global memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "device_guard.cuh"
#include "warp_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;    // Hopper's opt-in shared memory
constexpr int kSmemDefault = 49152; // without cudaFuncSetAttribute
constexpr int kMaxDevices = 64;

// s and its 12-bit head and tail, as shear_controls (ops/kernels/warp.py)
struct Shear {
  float s, hi, lo;
};

__device__ __forceinline__ Shear shear_of(float s) {
  Shear r;
  r.s = s;
  r.hi = head12(s);
  r.lo = s - r.hi;
  return r;
}

// One line's taps: output lane j reads lanes j + t0 .. j + t0 + 3.
struct __align__(16) CubicLine {
  int t0;       // floor(s * (coord + 0.5)), clamped to +-(size + 4), less 1
  float wt[4];  // w(1 + f), w(f), w(1 - f), w(2 - f)
  float den;    // their sum in tap order (1 if |sum| <= 1e-6): the divisor
                // with every tap inside
  int lo;       // first lane whose source is inside the band (size if none)
  int hi;       // last lane whose source is inside the band (-1 if none)
};

// the first lane's t0 alone (for the rows a vertical tile reaches)
__device__ __forceinline__ int cubic_t0(float sh, int coord, int size) {
  const float k = floorf(sh * ((float)coord + 0.5f));
  return (int)fminf(fmaxf(k, -(float)(size + 4)), (float)(size + 4)) - 1;
}

__device__ __forceinline__ CubicLine cubic_line(const Shear& sh, int coord,
                                                int size) {
  CubicLine c;
  const float idx = (float)coord + 0.5f;
  const float g = sh.s * idx;
  const float k = floorf(g);
  const float f = g - k;
  const float kc = fminf(fmaxf(k, -(float)(size + 4)), (float)(size + 4));
  c.t0 = (int)kc - 1;
  c.wt[0] = keys_cubic(1.0f + f);
  c.wt[1] = keys_cubic(f);
  c.wt[2] = keys_cubic(1.0f - f);
  c.wt[3] = keys_cubic(2.0f - f);
  c.den = ((c.wt[0] + c.wt[1]) + c.wt[2]) + c.wt[3];
  c.den = fabsf(c.den) > 1e-6f ? c.den : 1.0f;
  // The band tests of lane j, at pos = j + 0.5, are monotone in j: from an
  // estimate, step to the exact first and last lane that pass them.
  const float fsize = (float)size;
  auto above = [&](int j) {
    return pos_at_least_zero((float)j + 0.5f, idx, sh.hi, sh.lo);
  };
  auto below = [&](int j) {
    return pos_at_most((float)j + 0.5f, idx, fsize, sh.hi, sh.lo);
  };
  int a = (int)fminf(fmaxf(ceilf(-g - 0.5f), 0.0f), fsize);
  while (a > 0 && above(a - 1)) --a;
  while (a < size && !above(a)) ++a;
  int b = (int)fminf(fmaxf(floorf(fsize - 0.5f - g), -1.0f), fsize - 1.0f);
  while (b < size - 1 && below(b + 1)) ++b;
  while (b >= 0 && !below(b)) --b;
  c.lo = a;
  c.hi = b;
  return c;
}

// One output pixel, three channels: lane `lane` of a line of `size`,
// tap i's channel ch read by sample(t, ch) for lanes t in [0, size - 1].
template <typename Sample>
__device__ __forceinline__ void cubic_pixel(const CubicLine& c, int lane,
                                            int size, Sample sample,
                                            uint8_t* o) {
  if (lane < c.lo || lane > c.hi) {  // the source is outside the band
    o[0] = o[1] = o[2] = 0;
    return;
  }
  const int t0 = lane + c.t0;
  float num[3];
  float den;
  if (t0 >= 0 && t0 + 3 <= size - 1) {  // every tap kept: weight * 1
    den = c.den;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float v = u8_to_float(sample(t0 + i, ch));
        num[ch] = i == 0 ? v * c.wt[i] : num[ch] + v * c.wt[i];
      }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + i;
      const float ok = (t >= 0 && t <= size - 1) ? 1.0f : 0.0f;
      const float wok = c.wt[i] * ok;
      const int tc = clampi(t, 0, size - 1);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float v = u8_to_float(sample(tc, ch));
        num[ch] = i == 0 ? v * wok : num[ch] + v * wok;
      }
      den = i == 0 ? wok : den + wok;
    }
  }
  den = fabsf(den) > 1e-6f ? den : 1.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) o[ch] = round_clip_u8(num[ch] / den);
}

// ---- the band kernel ------------------------------------------------------

constexpr int kColBand = 32;  // columns of a vertical-shear tile
// Input rows a vertical tile stages beyond its own: its columns' shifts
// differ by at most |s| * kColBand + 1 rows, and the taps add 3 (|s| <= 1).
// A tile that reaches further reads its taps from global memory.
constexpr int kReach = kColBand + 4;

// Blocks and shared bytes for k blocks per image of h x w (k >= col_bands).
// A horizontal shear's block takes `rows` whole rows (one run of global
// memory). A vertical shear's block takes a tile of kColBand columns by
// `tile_rows` rows (k / col_bands row bands of col_bands tiles) and stages
// the input rows its columns reach, at most tile_rows + kReach runs of
// `pitch` bytes. Each
// run sits in shared memory at its global address's offset within 16
// bytes, so that 16-byte loads and stores line up.
struct BandLayout {
  int rows;       // rows of a horizontal band: ceil(h / k)
  int col_bands;  // vertical tiles across: ceil(w / kColBand)
  int tile_rows;  // rows of a vertical tile: ceil(h / (k / col_bands))
  int pitch;      // bytes of one row run of a vertical tile
  int in_slab;    // bytes of the input slab
  int out_slab;   // bytes of the output slab
  int bytes;      // dynamic shared memory: the slabs and the line controls
};

__host__ __device__ inline BandLayout band_layout(int h, int w, int k) {
  BandLayout L;
  L.rows = (h + k - 1) / k;
  L.col_bands = (w + kColBand - 1) / kColBand;
  const int row_bands = k / L.col_bands > 0 ? k / L.col_bands : 1;
  L.tile_rows = (h + row_bands - 1) / row_bands;
  L.pitch = (kColBand * 3 + 15 + 15) / 16 * 16;
  const int64_t horiz = ((int64_t)L.rows * w * 3 + 15 + 15) / 16 * 16;
  const int64_t vin =
      (int64_t)(h < L.tile_rows + kReach ? h : L.tile_rows + kReach) *
      L.pitch;
  const int64_t vout = (int64_t)L.tile_rows * L.pitch;
  const int64_t in_slab = horiz > vin ? horiz : vin;
  const int64_t out_slab = horiz > vout ? horiz : vout;
  const int lines = L.rows > kColBand ? L.rows : kColBand;
  const int64_t bytes =
      in_slab + out_slab + (int64_t)lines * sizeof(CubicLine);
  const bool fits = bytes <= kSmemMax;
  L.in_slab = fits ? (int)in_slab : 0;
  L.out_slab = fits ? (int)out_slab : 0;
  L.bytes = fits ? (int)bytes : 0;
  return L;
}

// The fewest and the most blocks per image: every vertical tile column
// has a block; at most one row a horizontal band (or one row band of
// vertical tiles).
__host__ __device__ inline int min_blocks(int w) {
  return (w + kColBand - 1) / kColBand;
}
__host__ __device__ inline int max_blocks(int h, int w) {
  const int c = min_blocks(w);
  return h > c ? h : c;
}

// Copies the run of `bytes` at global `src` into shared `dst` at the same
// offset within 16 bytes (dst is 16-byte aligned); chunk `c` of the run's
// aligned span. The span's chunks all hold a byte of the run, so no load
// leaves the run's 16-byte granules.
__device__ __forceinline__ void load_chunk(uint8_t* dst, const uint8_t* src,
                                           int c) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(src) & ~(uintptr_t)15;
  reinterpret_cast<uint4*>(dst)[c] =
      __ldg(reinterpret_cast<const uint4*>(base) + c);
}

// Stores chunk c of the run of `bytes` at global `dst` from shared `src`
// (laid out as load_chunk's): 16 bytes at once where the chunk lies inside
// the run, byte by byte at its two ends.
__device__ __forceinline__ void store_chunk(uint8_t* dst, const uint8_t* src,
                                            int bytes, int c) {
  const int a = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  uint8_t* base = dst - a;
  const int lo = max(c * 16, a);
  const int hi = min(c * 16 + 16, a + bytes);
  if (lo == c * 16 && hi == c * 16 + 16) {
    reinterpret_cast<uint4*>(base)[c] = reinterpret_cast<const uint4*>(src)[c];
  } else {
    for (int i = lo; i < hi; ++i) base[i] = src[i];
  }
}

__device__ __forceinline__ int chunks_of(const void* p, int bytes) {
  return ((int)(reinterpret_cast<uintptr_t>(p) & 15) + bytes + 15) / 16;
}

// Each thread walks pixels (q, r) of a block's d-wide grid by kThreads:
// q the row of the grid, r the position in it.
struct Walk {
  int q, r, d, step_q, step_r;
  __device__ Walk(int d_) : d(d_) {
    q = threadIdx.x / d;
    r = threadIdx.x - q * d;
    step_q = kThreads / d;
    step_r = kThreads - step_q * d;
  }
  __device__ void next() {
    r += step_r;
    q += step_q;
    if (r >= d) {
      r -= d;
      ++q;
    }
  }
};

__device__ __forceinline__ int offset16(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

__global__ void __launch_bounds__(kThreads)
    shear_cubic_band(const uint8_t* __restrict__ in,
                     const float* __restrict__ shears,
                     const uint8_t* __restrict__ horizontal,
                     uint8_t* __restrict__ out, int h, int w, int k) {
  extern __shared__ __align__(16) uint8_t smem[];
  const BandLayout L = band_layout(h, w, k);
  uint8_t* in_s = smem;
  uint8_t* out_s = smem + L.in_slab;
  CubicLine* lines = reinterpret_cast<CubicLine*>(out_s + L.out_slab);

  const int b = blockIdx.x / k;
  const int band = blockIdx.x - b * k;
  const int row = w * 3;  // bytes of an image row
  const uint8_t* src = in + (int64_t)b * h * row;
  uint8_t* dst = out + (int64_t)b * h * row;
  const Shear sh = shear_of(shears[b]);

  if (horizontal[b] != 0) {
    // rows [l0, l0 + n) whole: one run in, one run out
    const int l0 = band * L.rows;
    const int n = min(L.rows, h - l0);
    if (n <= 0) return;
    const uint8_t* run_in = src + (int64_t)l0 * row;
    uint8_t* run_out = dst + (int64_t)l0 * row;
    const int bytes = n * row;
    for (int c = threadIdx.x; c < chunks_of(run_in, bytes); c += kThreads)
      load_chunk(in_s, run_in, c);
    for (int i = threadIdx.x; i < n; i += kThreads)
      lines[i] = cubic_line(sh, l0 + i, w);
    __syncthreads();
    const uint8_t* line0 = in_s + offset16(run_in);
    uint8_t* out0 = out_s + offset16(run_out);
    Walk p(w);  // (row q, column r)
    for (int i = threadIdx.x; i < n * w; i += kThreads, p.next()) {
      const uint8_t* line = line0 + p.q * row;
      cubic_pixel(lines[p.q], p.r, w,
                  [&](int t, int ch) { return (uint32_t)line[t * 3 + ch]; },
                  out0 + p.q * row + p.r * 3);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < chunks_of(run_out, bytes); c += kThreads)
      store_chunk(run_out, out_s, bytes, c);
    return;
  }

  // a tile of columns [c0, c0 + nc) by rows [r0, r0 + nr)
  const int row_bands = k / L.col_bands;
  if (band >= row_bands * L.col_bands) return;
  const int c0 = (band % L.col_bands) * kColBand;
  const int r0 = (band / L.col_bands) * L.tile_rows;
  const int nc = min(kColBand, w - c0);
  const int nr = min(L.tile_rows, h - r0);
  if (nr <= 0) return;
  // the input rows the tile's taps reach (t0 is monotone in the column),
  // clamped to the image as the taps are
  const int ta = cubic_t0(sh.s, c0, h);
  const int tb = cubic_t0(sh.s, c0 + nc - 1, h);
  const int first = clampi(r0 + min(ta, tb), 0, h - 1);
  const int last = clampi(r0 + nr - 1 + max(ta, tb) + 3, 0, h - 1);
  const bool staged = last - first + 1 <= min(h, L.tile_rows + kReach);
  const int bytes = nc * 3;
  const int cpr = L.pitch / 16;
  const uint8_t* in0 = src + c0 * 3;  // the tile's column run in row 0
  uint8_t* out0 = dst + c0 * 3;
  // a run's offset within 16 bytes in row t: (offset of row 0 + t * row)
  const int row16 = row & 15;
  const int a_in = offset16(in0), a_out = offset16(out0);
  if (staged) {
    for (int i = threadIdx.x; i < (last - first + 1) * cpr; i += kThreads) {
      const int y = first + i / cpr, c = i - (i / cpr) * cpr;
      const uint8_t* run = in0 + (int64_t)y * row;
      if (c < chunks_of(run, bytes))
        load_chunk(in_s + (y - first) * L.pitch, run, c);
    }
  }
  for (int i = threadIdx.x; i < nc; i += kThreads)
    lines[i] = cubic_line(sh, c0 + i, h);
  __syncthreads();
  auto tile = [&](auto sample_at) {  // sample_at(row t, byte j of the run)
    Walk p(nc);  // (row r0 + q, column c0 + r)
    for (int i = threadIdx.x; i < nr * nc; i += kThreads, p.next()) {
      const int c3 = p.r * 3;
      const int y = r0 + p.q;
      cubic_pixel(lines[p.r], y, h,
                  [&](int t, int ch) { return sample_at(t, c3 + ch); },
                  out_s + p.q * L.pitch + ((a_out + y * row16) & 15) + c3);
    }
  };
  if (staged) {
    tile([&](int t, int j) {
      return (uint32_t)in_s[(t - first) * L.pitch + ((a_in + t * row16) & 15)
                            + j];
    });
  } else {  // |s| > 1: the taps reach past the slab
    tile([&](int t, int j) {
      return (uint32_t)__ldg(in0 + (int64_t)t * row + j);
    });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * cpr; i += kThreads) {
    const int q = i / cpr, c = i - (i / cpr) * cpr;
    uint8_t* run = out0 + (int64_t)(r0 + q) * row;
    if (c < chunks_of(run, bytes))
      store_chunk(run, out_s + q * L.pitch, bytes, c);
  }
}

// Blocks of 256 threads the device runs at once (registers and threads;
// cached per device).
int resident_blocks() {
  static std::mutex mu;
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  std::lock_guard<std::mutex> lock(mu);
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, shear_cubic_band, kThreads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

// Blocks per image for n images of h x w: enough for one full wave of
// resident blocks, rounded up to whole rows of vertical tiles (so that a
// vertical image's tiles are as many as a horizontal image's bands), within
// [min_blocks, max_blocks], and few enough rows a horizontal band for
// shared memory; 0 if the most blocks do not fit.
int pick_bands(int n, int h, int w) {
  const int lo = min_blocks(w), hi = max_blocks(h, w);
  if (n <= 0 || !band_layout(h, w, hi).bytes) return 0;
  const int resident = resident_blocks();
  if (resident <= 0) return 0;
  int k = (resident + n - 1) / n;
  k = (k + lo - 1) / lo * lo;
  k = k < lo ? lo : (k > hi ? hi : k);
  while (k < hi && !band_layout(h, w, k).bytes) ++k;
  return k;
}

// ---- the simple kernel (lines longer than shared memory holds) -----------

__global__ void shear_cubic_simple(const uint8_t* __restrict__ in,
                                   const float* __restrict__ shears,
                                   const uint8_t* __restrict__ horizontal,
                                   uint8_t* __restrict__ out, int n, int h,
                                   int w) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * h * w) return;
  const int x = (int)(idx % w);
  const int64_t r = idx / w;
  const int y = (int)(r % h);
  const int b = (int)(r / h);
  const Shear sh = shear_of(shears[b]);
  const bool horiz = horizontal[b] != 0;
  const int size = horiz ? w : h;
  const uint8_t* line =
      horiz ? in + ((int64_t)b * h + y) * w * 3
            : in + (int64_t)b * h * w * 3 + (int64_t)x * 3;
  const int64_t stride = horiz ? 3 : (int64_t)w * 3;
  const CubicLine c = cubic_line(sh, horiz ? y : x, size);
  cubic_pixel(c, horiz ? x : y, size,
              [&](int t, int ch) { return (uint32_t)line[t * stride + ch]; },
              out + idx * 3);
}

// one thread per shear -> f32 [3, n]: s, s_hi, s_lo
__global__ void shear_controls_kernel(const float* __restrict__ shears,
                                      float* __restrict__ ctrl, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const Shear sh = shear_of(shears[b]);
  ctrl[b] = sh.s;
  ctrl[n + b] = sh.hi;
  ctrl[2 * n + b] = sh.lo;
}

}  // namespace

// shears: f32 [n] on the device -> ctrl f32 [3, n] (s, s_hi, s_lo) as the
// kernels compute them, on device `device`. Returns cudaGetLastError()
// after the launch.
extern "C" int leaf_shear_controls(const float* shears, float* ctrl, int n,
                                   int device, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    shear_controls_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        shears, ctrl, n);
    return cudaGetLastError();
  });
}

// h, w -> dynamic shared-memory bytes of the band kernel at one line a band;
// 0 = a line does not fit and the simple kernel runs
extern "C" int leaf_shear_cubic_smem_bytes(int h, int w) {
  if (h <= 0 || w <= 0) return 0;
  return band_layout(h, w, max_blocks(h, w)).bytes;
}

// bands (blocks) per image of the band kernel for n images of h x w; 0 when
// the simple kernel runs
extern "C" int leaf_shear_cubic_blocks_per_image(int n, int h, int w) {
  return pick_bands(n, h, w);
}

// in, out: uint8 [n, h, w, 3]; shears: f32 [n]; horizontal: one byte per
// image (bool or uint8; non-zero: rows, zero: columns); all on device
// `device`. One launch; no scratch. Returns cudaGetLastError() after the
// launch.
extern "C" int leaf_shear_cubic(const uint8_t* in, const float* shears,
                                const uint8_t* horizontal, uint8_t* out,
                                int n, int h, int w, int device,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = (int64_t)n * h * w;
  if (total == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    const int k = pick_bands(n, h, w);
    if (k > 0) {
      const BandLayout L = band_layout(h, w, k);
      if (L.bytes > kSmemDefault) {
        const cudaError_t err = cudaFuncSetAttribute(
            shear_cubic_band, cudaFuncAttributeMaxDynamicSharedMemorySize,
            L.bytes);
        if (err != cudaSuccess) return err;
      }
      if ((int64_t)n * k > 0x7fffffff) return cudaErrorInvalidConfiguration;
      shear_cubic_band<<<(unsigned)(n * k), kThreads, L.bytes, s>>>(
          in, shears, horizontal, out, h, w, k);
      return cudaGetLastError();
    }
    if (band_layout(h, w, max_blocks(h, w)).bytes)  // the band kernel fits
      return cudaErrorInvalidConfiguration;
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    shear_cubic_simple<<<blocks, threads, 0, s>>>(in, shears, horizontal, out,
                                                  n, h, w);
    return cudaGetLastError();
  });
}
