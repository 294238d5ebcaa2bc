// Device helpers shared by the shear-based warps: K1 (train_aug.cu), K2
// (rotate_expand.cu) and K3 (shear_cubic.cu).
//
// Sign-exact source-position tests, after _scaled_positions in
// leaffliction_tpu/ops/pallas/rotate.py: a shear factor sh is split into a
// 12-bit head `hi` and a tail `lo`, so that hi * idx is exact on integer or
// half-integer grids up to ~2^11, and the cancellation near each bound is
// exact. A source position that truly sits within 1e-8 of an edge then lands
// on the same side as in exact arithmetic. The library is built with
// -fmad=false, so every product and sum is rounded on its own, as in the
// plain PyTorch twins.
//
// The rotation helpers below (rotation_of, shear_line, shear3_sweep) are the
// streaming three-shear rotation of K1 and K2: one block holds one uint8
// three-channel image in shared memory and produces canvas rows from it,
// pass 1 computed on the fly, pass 2 into a shared row buffer, pass 3
// straight to the caller, one thread per canvas column and row slice.

#pragma once

#include <stdint.h>

// coord + sh * idx >= 0, from the split sh = hi + lo
__device__ __forceinline__ bool pos_at_least_zero(float coord, float idx,
                                                  float hi, float lo) {
  return (coord + hi * idx) + lo * idx >= 0.0f;
}

// coord + sh * idx <= upper, from the split sh = hi + lo
__device__ __forceinline__ bool pos_at_most(float coord, float idx,
                                            float upper, float hi, float lo) {
  return ((coord - upper) + hi * idx) + lo * idx <= 0.0f;
}

// Keys cubic weight, a = -0.5 (PIL BICUBIC), for |d| <= 2
__device__ __forceinline__ float keys_cubic(float d) {
  float ad = fabsf(d);
  float ad2 = ad * ad;
  float ad3 = ad2 * ad;
  if (ad <= 1.0f) return (1.5f * ad3 - 2.5f * ad2) + 1.0f;
  return -0.5f * (((ad3 - 5.0f * ad2) + 8.0f * ad) - 4.0f);
}

// float -> uint8 with round half to even, then clip to [0, 255]
__device__ __forceinline__ unsigned char round_clip_u8(float v) {
  return (unsigned char)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// ---- rotation by three shears -------------------------------------------

// t = -tan(theta/2), s = sin(theta) and their 12-bit heads and tails
struct Rotation {
  float t, t_hi, t_lo, s, s_hi, s_lo;
};

__device__ __forceinline__ float head12(float v) {
  return rintf(v * 4096.0f) / 4096.0f;
}

// The operations of rotation_controls (ops/kernels/rotate.py) in PyTorch on
// the card: theta = angle * f32(pi / 180), tanf of theta / 2, sinf, and
// rintf, which is torch.round's half to even; the / 4096 is exact.
__device__ __forceinline__ Rotation rotation_of(float angle_deg) {
  const float theta = angle_deg * (float)(3.14159265358979323846 / 180.0);
  Rotation r;
  r.t = -tanf(theta / 2.0f);
  r.t_hi = head12(r.t);
  r.t_lo = r.t - r.t_hi;
  r.s = sinf(theta);
  r.s_hi = head12(r.s);
  r.s_lo = r.s - r.s_hi;
  return r;
}

// one thread per image -> f32 [6, n]: t, t_hi, t_lo, s, s_hi, s_lo
namespace {
__global__ void rotation_controls_kernel(const float* __restrict__ angles,
                                         float* __restrict__ ctrl, int n) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  Rotation r = rotation_of(angles[b]);
  ctrl[b] = r.t;
  ctrl[n + b] = r.t_hi;
  ctrl[2 * n + b] = r.t_lo;
  ctrl[3 * n + b] = r.s;
  ctrl[4 * n + b] = r.s_hi;
  ctrl[5 * n + b] = r.s_lo;
}
}  // namespace

// One line of a shear pass: out[lane] = lerp of src at lane + sh * off, a
// floor shift k plus a 2-tap lerp by f. The sign-exact source tests are
// monotone in the lane, so they reduce to the lane range [lo, hi] whose
// source lies inside [0, size - 1].
struct __align__(16) ShearLine {
  int k;      // floor(sh * off), clamped to +-(size + 1)
  float f;    // weight of the second tap
  float omf;  // 1 - f
  short lo;   // first lane with source >= 0 (size if none)
  short hi;   // last lane with source <= size - 1 (-1 if none)
};

__device__ __forceinline__ ShearLine shear_line(float sh, float hi, float lo,
                                                float off, int size) {
  const float g = sh * off;
  const float k = floorf(g);
  ShearLine r;
  r.f = g - k;
  r.omf = 1.0f - r.f;
  r.k = (int)fminf(fmaxf(k, -(float)(size + 1)), (float)(size + 1));
  // start from the estimate, then step to the exact edge of each test
  int a = (int)fminf(fmaxf(ceilf(-g), 0.0f), (float)size);
  while (a > 0 && pos_at_least_zero((float)(a - 1), off, hi, lo)) --a;
  while (a < size && !pos_at_least_zero((float)a, off, hi, lo)) ++a;
  const float upper = (float)(size - 1);
  int b = (int)fminf(fmaxf(floorf(upper - g), -1.0f), upper);
  while (b < size - 1 && pos_at_most((float)(b + 1), off, upper, hi, lo)) ++b;
  while (b >= 0 && !pos_at_most((float)b, off, upper, hi, lo)) --b;
  r.lo = (short)a;
  r.hi = (short)b;
  return r;
}

// v0 * (1 - f) + v1 * f, each product rounded on its own
__device__ __forceinline__ float lerp2(float v0, float v1, const ShearLine& r) {
  return v0 * r.omf + v1 * r.f;
}

// The block copies `bytes` of global memory into shared memory, 16 bytes a
// load where the source is 16-byte aligned.
__device__ __forceinline__ void copy_to_shared(uint8_t* __restrict__ dst,
                                               const uint8_t* __restrict__ src,
                                               int bytes) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int vec = bytes / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (int i = threadIdx.x; i < vec; i += blockDim.x) d4[i] = __ldg(s4 + i);
    done = vec * 16;
  }
  for (int i = done + threadIdx.x; i < bytes; i += blockDim.x) dst[i] = src[i];
}

// A byte as a float, exactly: 2^23 + v read as a float, less 2^23 (an
// integer op and an add on the full-rate pipes, where a conversion runs at
// a quarter of their rate)
__device__ __forceinline__ float u8_to_float(uint32_t v) {
  return __int_as_float(0x4B000000u | v) - 8388608.0f;
}

constexpr int kMaxRpt = 4;  // canvas rows a thread takes in pass 2 a group

// How a block's threads share the sweep: thread (r, x) = (threadIdx.x / ow,
// threadIdx.x % ow) takes canvas column x (all three channels) and slice r
// of each group of split * rpt canvas rows, rows r * rpt .. r * rpt + rpt-1.
struct SweepShape {
  int split;  // row slices of a group; threads = ow * split (to a warp)
  int rpt;    // rows of a slice, 1 .. kMaxRpt
};

// Rows [y_begin, y_end) of the rotated canvas [oh, ow, 3] of one image:
//
//   pass1(j, x, v): pass 1 (rows by t) at canvas row j and column x, its
//                   three channels into v, from the image in shared memory,
//                   on the fly;
//   rows[j]:        pass 1's and pass 3's line controls of canvas row j;
//   pass 2 (columns by s) goes into the row buffer `buf` (group * ow * 3
//     floats), a group of canvas rows at a time: a slice's rows y = s0 + i
//     take the pass-1 values of rows clamp(s0 + k + i) and clamp(s0 + k +
//     i + 1), so a slice of rpt rows needs rpt + 1 pass-1 values, computed
//     side by side;
//   pass 3 (rows by t) reads the buffer and hands each pixel's three values
//     to emit(y, x, v).
//
// A source outside a line takes the line's edge sample (kClamp, K1) or 255
// (K2). The column controls, the pass-1 edge samples and the index
// arithmetic of each tap serve all three channels. Every block thread must
// call it; it ends with a barrier after the last read of `buf`.
template <bool kClamp, typename Pass1, typename Emit>
__device__ __forceinline__ void shear3_sweep(const ShearLine* __restrict__ rows,
                                             float* __restrict__ buf,
                                             SweepShape sh, const Rotation& rot,
                                             int oh, int ow, int y_begin,
                                             int y_end, Pass1 pass1,
                                             Emit emit) {
  const int line = ow * 3;
  const int r = threadIdx.x / ow;
  const int x = threadIdx.x - r * ow;
  const bool active = r < sh.split;
  const int group = sh.split * sh.rpt;
  const float cx = (float)(ow - 1) * 0.5f;
  ShearLine col = {0, 0.0f, 1.0f, 0, -1};
  float e0[3] = {255.0f, 255.0f, 255.0f};
  float e1[3] = {255.0f, 255.0f, 255.0f};
  if (active) {
    col = shear_line(rot.s, rot.s_hi, rot.s_lo, (float)x - cx, oh);
    if (kClamp) {
      pass1(0, x, e0);
      pass1(oh - 1, x, e1);
    }
  }
  for (int g0 = y_begin; g0 < y_end; g0 += group) {
    const int s0 = g0 + r * sh.rpt;
    const int n_rows = active ? max(0, min(sh.rpt, y_end - s0)) : 0;
    // pass 2: this slice's canvas rows of column x
    if (n_rows > 0) {
      float p[kMaxRpt + 1][3];
      const bool inside = s0 <= col.hi && s0 + n_rows - 1 >= col.lo;
#pragma unroll
      for (int i = 0; i <= kMaxRpt; ++i) {
        if (inside && i <= n_rows) {
          pass1(clampi(s0 + col.k + i, 0, oh - 1), x, p[i]);
        } else {
          p[i][0] = p[i][1] = p[i][2] = 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxRpt; ++i) {
        if (i >= n_rows) break;
        const int y = s0 + i;
        float* dst = buf + (y - g0) * line + x * 3;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          dst[ch] = y < col.lo   ? e0[ch]
                    : y > col.hi ? e1[ch]
                                 : lerp2(p[i][ch], p[i + 1][ch], col);
      }
    }
    __syncthreads();
    // pass 3: the same rows from the buffer
#pragma unroll
    for (int i = 0; i < kMaxRpt; ++i) {
      if (i >= n_rows) break;
      const int y = s0 + i;
      const ShearLine rl = rows[y];
      const float* src = buf + (y - g0) * line;
      float v[3];
      if (x < rl.lo || x > rl.hi) {
        const float* e = src + (x < rl.lo ? 0 : (ow - 1) * 3);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) v[ch] = kClamp ? e[ch] : 255.0f;
      } else {
        const int i0 = x + rl.k;
        const float* a = src + clampi(i0, 0, ow - 1) * 3;
        const float* b = src + clampi(i0 + 1, 0, ow - 1) * 3;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) v[ch] = lerp2(a[ch], b[ch], rl);
      }
      emit(y, x, v);
    }
    __syncthreads();
  }
}

// The sweep's shape for canvas rows ow wide, given the shared bytes left
// for the row buffer: the most rows a slice, then the most slices (up to
// 1024 threads and 8 slices) whose buffer fits; {0, 0} if none does.
__host__ __device__ inline SweepShape sweep_shape(int ow, int64_t free_bytes) {
  const int fit = 1024 / (ow > 0 ? ow : 1);
  const int max_split = fit < 8 ? fit : 8;
  for (int rpt = kMaxRpt; rpt >= 1; --rpt)
    for (int split = max_split; split >= 1; --split)
      if (4 * (int64_t)split * rpt * ow * 3 <= free_bytes)
        return SweepShape{split, rpt};
  return SweepShape{0, 0};
}

// ---- splitting an image's canvas rows over blocks ------------------------

// A block's fixed cost (loading the image, the line controls, K1's
// reduction) counted in canvas rows of the sweep, read off K1's and K2's
// times on an H100 at 28 to 306 rows a block (chip_smoke.py's by-batch
// timings).
constexpr int kFixedRows = 16;

// Blocks per image when each of n images' `rows` canvas rows are split into
// k bands, one block each, and up to images_per_wave(k) images run at once:
// the fewest band-times over the waves, ties to fewer blocks; 0 if no k
// runs at all.
template <typename Capacity>
inline int pick_split(int n, int rows, int max_k, Capacity images_per_wave) {
  int best = 0;
  int64_t best_cost = -1;
  for (int k = 1; k <= max_k; ++k) {
    const int64_t cap = images_per_wave(k);
    if (cap <= 0) continue;
    const int64_t cost =
        ((int64_t)n + cap - 1) / cap * ((rows + k - 1) / k + kFixedRows);
    if (best_cost < 0 || cost < best_cost) {
      best = k;
      best_cost = cost;
    }
  }
  return best;
}
