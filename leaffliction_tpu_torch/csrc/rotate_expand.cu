// Expand-canvas rotation K2: uint8 NHWC [n, h, w, 3] -> uint8 [n, OH, OW, 3]
// by three shears with a white fill in every pass.
//
// Replaces the Pallas TPU kernels of leaffliction_tpu/ops/pallas/rotate.py:
//   rotate_batch_pallas_nhwc (_rotate_nhwc_kernel), channels interleaved;
//   rotate_batch_pallas      (_rotate_kernel), one plane per program.
// Both compute one function, the balancing `rotate` op's warp.
//
// Per image, the input is placed at ((OH - h) / 2, (OW - w) / 2) on a white
// (255) canvas. With t = -tan(theta/2) and s = sin(theta) about the canvas
// centre ((OH-1)/2, (OW-1)/2), each pass is a floor shift plus a 2-tap lerp:
//   pass 1, rows:    out[y, x] = lerp of src[y, .] at x + t*(y - cy)
//   pass 2, columns: out[y, x] = lerp of src[., x] at y + s*(x - cx)
//   pass 3, rows:    as pass 1, then round half to even and clip to uint8.
// A source position outside [0, OW-1] (rows) or [0, OH-1] (columns) gives
// 255. The bounds are tested sign-exactly from the 12-bit head and tail of
// the shear factor (warp_common.cuh). The lerp's second tap has weight 0 at
// the upper edge; its index is clamped so it never reads past the row.
// t, s and their heads and tails are computed once per image by the plain
// twin's code (leaffliction_tpu_torch/ops/kernels/rotate.py,
// rotation_controls) and passed in, so tanf/sinf cannot move a floor. With
// -fmad=false the arithmetic repeats the twin's (ops/kernels/warp.py)
// operation for operation.
//
// What bounds it on an H100: memory traffic. At 64 x 224^2 the canvas is
// 64 x 306^2 x 3 (18 M elements); each pass reads two taps and writes one
// f32, about 72 MB per f32 pass, most of it in the 50 MB L2. The design is
// the simple one, as K1: one thread per canvas element per pass, through two
// f32 scratch canvases the wrapper allocates. The TPU kernel's barrel
// shifter, shift-bias trick and (8, 128) padding have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace {

// canvas value before pass 1: the input where it is placed, else white
__device__ __forceinline__ float placed(const uint8_t* in, int b, int y, int x,
                                        int ch, int h, int w, int y0, int x0) {
  int iy = y - y0;
  int ix = x - x0;
  if (iy < 0 || iy >= h || ix < 0 || ix >= w) return 255.0f;
  return (float)in[(((int64_t)b * h + iy) * w + ix) * 3 + ch];
}

struct Lerp {
  int j0, j1;   // clamped tap indices along the pass
  float f;      // weight of the second tap
  bool valid;   // source inside [0, size-1]
};

// lane: output index along the pass; off: offset of the other axis from
// its centre; size: extent along the pass; sh, hi, lo: shear factor split
__device__ __forceinline__ Lerp lerp_taps(int lane, float off, int size,
                                          float sh, float hi, float lo) {
  float g = sh * off;
  float k = floorf(g);
  Lerp r;
  r.f = g - k;
  float kc = fminf(fmaxf(k, -(float)(size + 1)), (float)(size + 1));
  int i0 = lane + (int)kc;
  r.j0 = min(max(i0, 0), size - 1);
  r.j1 = min(max(i0 + 1, 0), size - 1);
  r.valid = pos_at_least_zero((float)lane, off, hi, lo) &&
            pos_at_most((float)lane, off, (float)(size - 1), hi, lo);
  return r;
}

__device__ __forceinline__ float mix(float v0, float v1, float f) {
  return v0 * (1.0f - f) + v1 * f;
}

// pass 1: rows of the placed input -> f32 canvas
__global__ void row_pass_in(const uint8_t* __restrict__ in,
                            float* __restrict__ dst,
                            const float* __restrict__ ctrl, int n, int h,
                            int w, int oh, int ow) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * oh * ow * 3) return;
  int ch = (int)(idx % 3);
  int64_t r = idx / 3;
  int x = (int)(r % ow);
  r /= ow;
  int y = (int)(r % oh);
  int b = (int)(r / oh);
  int y0 = (oh - h) / 2;
  int x0 = (ow - w) / 2;
  float off = (float)y - (float)(oh - 1) * 0.5f;
  Lerp t = lerp_taps(x, off, ow, ctrl[b], ctrl[n + b], ctrl[2 * n + b]);
  float v0 = placed(in, b, y, t.j0, ch, h, w, y0, x0);
  float v1 = placed(in, b, y, t.j1, ch, h, w, y0, x0);
  float out = mix(v0, v1, t.f);
  dst[idx] = t.valid ? out : 255.0f;
}

// pass 2: columns, f32 -> f32
__global__ void col_pass(const float* __restrict__ src,
                         float* __restrict__ dst,
                         const float* __restrict__ ctrl, int n, int oh,
                         int ow) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * oh * ow * 3) return;
  int ch = (int)(idx % 3);
  int64_t r = idx / 3;
  int x = (int)(r % ow);
  r /= ow;
  int y = (int)(r % oh);
  int b = (int)(r / oh);
  float off = (float)x - (float)(ow - 1) * 0.5f;
  Lerp t = lerp_taps(y, off, oh, ctrl[3 * n + b], ctrl[4 * n + b],
                     ctrl[5 * n + b]);
  const float* col = src + (int64_t)b * oh * ow * 3 + (int64_t)x * 3 + ch;
  int64_t stride = (int64_t)ow * 3;
  float out = mix(col[t.j0 * stride], col[t.j1 * stride], t.f);
  dst[idx] = t.valid ? out : 255.0f;
}

// pass 3: rows, f32 -> uint8
__global__ void row_pass_out(const float* __restrict__ src,
                             uint8_t* __restrict__ out,
                             const float* __restrict__ ctrl, int n, int oh,
                             int ow) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * oh * ow * 3) return;
  int ch = (int)(idx % 3);
  int64_t r = idx / 3;
  int x = (int)(r % ow);
  r /= ow;
  int y = (int)(r % oh);
  int b = (int)(r / oh);
  float off = (float)y - (float)(oh - 1) * 0.5f;
  Lerp t = lerp_taps(x, off, ow, ctrl[b], ctrl[n + b], ctrl[2 * n + b]);
  const float* row = src + ((int64_t)b * oh + y) * ow * 3 + ch;
  float v = mix(row[t.j0 * 3], row[t.j1 * 3], t.f);
  out[idx] = round_clip_u8(t.valid ? v : 255.0f);
}

}  // namespace

// in: uint8 [n, h, w, 3]; ctrl: f32 [6, n] (t, t_hi, t_lo, s, s_hi, s_lo);
// a, b: f32 scratch [n, oh, ow, 3]; out: uint8 [n, oh, ow, 3].
// Returns cudaGetLastError() after the launches.
extern "C" int leaf_rotate_expand(const uint8_t* in, const float* ctrl,
                                  float* a, float* b, uint8_t* out, int n,
                                  int h, int w, int oh, int ow,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int64_t total = (int64_t)n * oh * ow * 3;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  row_pass_in<<<blocks, threads, 0, s>>>(in, a, ctrl, n, h, w, oh, ow);
  col_pass<<<blocks, threads, 0, s>>>(a, b, ctrl, n, oh, ow);
  row_pass_out<<<blocks, threads, 0, s>>>(b, out, ctrl, n, oh, ow);
  return (int)cudaGetLastError();
}
