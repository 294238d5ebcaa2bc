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
// (ops/kernels/warp.py) operation for operation.
//
// What bounds it on an H100: memory traffic, about 10 bytes a pixel-channel
// (4 uint8 taps, mostly from L1/L2, and one uint8 store) at 9.6 M elements
// for 64 x 224^2; one thread per output element, no scratch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace {

// ctrl rows: 0 s, 1 s_hi, 2 s_lo (each [n]); horizontal: uint8 [n]
__global__ void shear_cubic_kernel(const uint8_t* __restrict__ in,
                                   uint8_t* __restrict__ out,
                                   const float* __restrict__ ctrl,
                                   const uint8_t* __restrict__ horizontal,
                                   int n, int h, int w) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * h * w * 3) return;
  int ch = (int)(idx % 3);
  int64_t r = idx / 3;
  int x = (int)(r % w);
  r /= w;
  int y = (int)(r % h);
  int b = (int)(r / h);
  float sh = ctrl[b];
  float hi = ctrl[n + b];
  float lo = ctrl[2 * n + b];
  bool horiz = horizontal[b] != 0;
  // lane: index along the pass; coord: the index the shift scales with
  int lane = horiz ? x : y;
  int coord = horiz ? y : x;
  int size = horiz ? w : h;
  const uint8_t* line =
      horiz ? in + ((int64_t)b * h + y) * w * 3 + ch
            : in + (int64_t)b * h * w * 3 + (int64_t)x * 3 + ch;
  int64_t stride = horiz ? 3 : (int64_t)w * 3;

  float g = sh * ((float)coord + 0.5f);
  float k = floorf(g);
  float f = g - k;
  float kc = fminf(fmaxf(k, -(float)(size + 4)), (float)(size + 4));
  int t0 = lane + (int)kc - 1;
  float wt[4] = {keys_cubic(1.0f + f), keys_cubic(f), keys_cubic(1.0f - f),
                 keys_cubic(2.0f - f)};
  float num = 0.0f;
  float den = 0.0f;
  for (int i = 0; i < 4; ++i) {
    int t = t0 + i;
    float ok = (t >= 0 && t <= size - 1) ? 1.0f : 0.0f;
    float wok = wt[i] * ok;
    float v = (float)line[(int64_t)min(max(t, 0), size - 1) * stride];
    num = i == 0 ? v * wok : num + v * wok;
    den = i == 0 ? wok : den + wok;
  }
  den = fabsf(den) > 1e-6f ? den : 1.0f;
  float idxf = (float)coord + 0.5f;
  float pos = (float)lane + 0.5f;
  bool valid = pos_at_least_zero(pos, idxf, hi, lo) &&
               pos_at_most(pos, idxf, (float)size, hi, lo);
  out[idx] = round_clip_u8(valid ? num / den : 0.0f);
}

}  // namespace

// in, out: uint8 [n, h, w, 3]; ctrl: f32 [3, n] (s, s_hi, s_lo);
// horizontal: uint8 [n] (1: rows, 0: columns).
// Returns cudaGetLastError() after the launch.
extern "C" int leaf_shear_cubic(const uint8_t* in, const float* ctrl,
                                const uint8_t* horizontal, uint8_t* out,
                                int n, int h, int w, void* stream) {
  int64_t total = (int64_t)n * h * w * 3;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  shear_cubic_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      in, out, ctrl, horizontal, n, h, w);
  return (int)cudaGetLastError();
}
