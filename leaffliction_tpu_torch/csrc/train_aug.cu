// Fused training augmentation K1: dequantise -> same-size rotation by three
// shears with edge clamp -> per-channel contrast, NHWC [n, h, w, c].
//
// Replaces the Pallas TPU kernels of leaffliction_tpu/ops/pallas/rotate.py:
//   train_aug_rotate_contrast_nhwc_pallas (_train_aug_nhwc_kernel),
//   train_aug_rotate_contrast_pallas      (_train_aug_kernel),
//   rotate_batch_pallas_clamp_f32         (_rotate_clamp_kernel).
// One kernel family covers all three, in two modes:
//   uint8 in, contrast on, f32 or bf16 out   (the first two);
//   f32 in, contrast off, f32 out            (the third).
//
// Per image, with t = -tan(theta/2) and s = sin(theta) about the centre
// ((h-1)/2, (w-1)/2), each pass is a floor shift plus a 2-tap lerp:
//   pass 1, rows:    out[y, x] = lerp of src[y, .] at x + t*(y - cy)
//   pass 2, columns: out[y, x] = lerp of src[., x] at y + s*(x - cx)
//   pass 3, rows:    as pass 1
// A source position outside [0, size-1] takes the content edge sample of its
// own row (column) and channel. The edge tests use the 12-bit head/tail
// split of the shear factor (rotate.py::_scaled_positions, shared with K2
// and K3 in warp_common.cuh), so a position
// within 1e-8 of an edge lands on the same side as in exact arithmetic. Then
//   out = clip(mean_c + (x - mean_c) * factor, 0, 1)
// with mean_c the mean of channel c over the h x w image.
//
// t, s and their heads and tails are computed once per image by the plain
// twin's code (leaffliction_tpu_torch/ops/kernels/rotate.py) and passed in
// as f32 arrays, so tanf/sinf differences between the two cannot move a
// floor. The arithmetic repeats the twin's operations in its order, and the
// library is built with -fmad=false, so the rotation passes agree with the
// twin bit for bit; the channel mean is summed in another order.
//
// What bounds it on an H100: memory traffic and launch latency. At
// 32x224x224x3 a pass reads and writes about 19 MB of f32 (the uint8 input
// is a quarter of that), five passes about 100 MB, most of it L2-resident
// (50 MB L2). The design is the simple one: one thread per output element
// for each pass through f32 scratch buffers the wrapper allocates, one block
// per (channel, image) for the mean (a fixed-order tree, deterministic), and
// an elementwise contrast pass. The TPU kernel's barrel shifter, shift-bias
// trick, (8, 128) canvas padding and VMEM gate are TPU devices with no
// counterpart here; keeping the canvas in shared memory is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace {

__device__ __forceinline__ float load_px(const uint8_t* p, int64_t i) {
  return __fdiv_rn((float)p[i], 255.0f);
}

__device__ __forceinline__ float load_px(const float* p, int64_t i) {
  return p[i];
}

__device__ __forceinline__ void store_px(float* p, int64_t i, float v) {
  p[i] = v;
}

__device__ __forceinline__ void store_px(__nv_bfloat16* p, int64_t i,
                                         float v) {
  p[i] = __float2bfloat16_rn(v);
}

// One shear pass along `size` samples spaced `stride` apart. `lane` is the
// output's index along the pass, `off` its offset from the centre of the
// other axis; sh, hi, lo are the shear factor and its 12-bit head and tail.
template <typename T>
__device__ __forceinline__ float shear_sample(const T* line, int64_t stride,
                                              int size, int lane, float off,
                                              float sh, float hi, float lo) {
  float g = sh * off;
  float k = floorf(g);
  float f = g - k;
  float kc = fminf(fmaxf(k, -(float)(size + 1)), (float)(size + 1));
  int i0 = lane + (int)kc;
  int j0 = min(max(i0, 0), size - 1);
  int j1 = min(max(i0 + 1, 0), size - 1);
  float v0 = load_px(line, (int64_t)j0 * stride);
  float v1 = load_px(line, (int64_t)j1 * stride);
  float out = v0 * (1.0f - f) + v1 * f;
  if (!pos_at_least_zero((float)lane, off, hi, lo)) return load_px(line, 0);
  if (!pos_at_most((float)lane, off, (float)(size - 1), hi, lo))
    return load_px(line, (int64_t)(size - 1) * stride);
  return out;
}

// ctrl rows: 0 t, 1 t_hi, 2 t_lo, 3 s, 4 s_hi, 5 s_lo (each [n])
template <typename T>
__global__ void row_pass(const T* __restrict__ src, float* __restrict__ dst,
                         const float* __restrict__ ctrl, int n, int h, int w,
                         int c) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * h * w * c) return;
  int ch = (int)(idx % c);
  int64_t r = idx / c;
  int x = (int)(r % w);
  r /= w;
  int y = (int)(r % h);
  int b = (int)(r / h);
  float off = (float)y - (float)(h - 1) * 0.5f;
  const T* line = src + ((int64_t)b * h + y) * w * c + ch;
  dst[idx] = shear_sample(line, c, w, x, off, ctrl[b], ctrl[n + b],
                          ctrl[2 * n + b]);
}

__global__ void col_pass(const float* __restrict__ src,
                         float* __restrict__ dst,
                         const float* __restrict__ ctrl, int n, int h, int w,
                         int c) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * h * w * c) return;
  int ch = (int)(idx % c);
  int64_t r = idx / c;
  int x = (int)(r % w);
  r /= w;
  int y = (int)(r % h);
  int b = (int)(r / h);
  float off = (float)x - (float)(w - 1) * 0.5f;
  const float* line = src + (int64_t)b * h * w * c + (int64_t)x * c + ch;
  dst[idx] = shear_sample(line, (int64_t)w * c, h, y, off, ctrl[3 * n + b],
                          ctrl[4 * n + b], ctrl[5 * n + b]);
}

constexpr int kMeanThreads = 256;

// one block per (channel, image): fixed-order strided sums, then a tree
__global__ void channel_mean(const float* __restrict__ src,
                             float* __restrict__ mean, int h, int w, int c) {
  int ch = blockIdx.x;
  int b = blockIdx.y;
  int64_t hw = (int64_t)h * w;
  const float* img = src + (int64_t)b * hw * c + ch;
  float acc = 0.0f;
  for (int64_t p = threadIdx.x; p < hw; p += kMeanThreads) acc += img[p * c];
  __shared__ float part[kMeanThreads];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kMeanThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) mean[b * c + ch] = part[0] / (float)hw;
}

template <typename O>
__global__ void contrast(const float* __restrict__ src,
                         const float* __restrict__ mean,
                         const float* __restrict__ factor, O* __restrict__ out,
                         int n, int h, int w, int c) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * h * w * c) return;
  int ch = (int)(idx % c);
  int b = (int)(idx / ((int64_t)h * w * c));
  float m = mean[b * c + ch];
  float v = m + (src[idx] - m) * factor[b];
  store_px(out, idx, fminf(fmaxf(v, 0.0f), 1.0f));
}

}  // namespace

// in: uint8 (in_u8 = 1) or f32 [n, h, w, c]; ctrl: f32 [6, n]; factors: f32
// [n] (read only with contrast = 1); a, b: f32 scratch [n, h, w, c]; mean:
// f32 scratch [n, c]; out: [n, h, w, c], bf16 when out_bf16 = 1 else f32.
// contrast = 0 writes pass 3 straight to out, which must then be f32.
// Returns cudaGetLastError() after the launches.
extern "C" int leaf_train_aug(const void* in, const float* ctrl,
                              const float* factors, float* a, float* b,
                              float* mean, void* out, int in_u8, int contrast_on,
                              int out_bf16, int n, int h, int w, int c,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int64_t total = (int64_t)n * h * w * c;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (in_u8)
    row_pass<<<blocks, threads, 0, s>>>((const uint8_t*)in, a, ctrl, n, h, w,
                                        c);
  else
    row_pass<<<blocks, threads, 0, s>>>((const float*)in, a, ctrl, n, h, w, c);
  col_pass<<<blocks, threads, 0, s>>>(a, b, ctrl, n, h, w, c);
  if (!contrast_on) {
    row_pass<<<blocks, threads, 0, s>>>((const float*)b, (float*)out, ctrl, n,
                                        h, w, c);
    return (int)cudaGetLastError();
  }
  row_pass<<<blocks, threads, 0, s>>>((const float*)b, a, ctrl, n, h, w, c);
  channel_mean<<<dim3(c, n), kMeanThreads, 0, s>>>(a, mean, h, w, c);
  if (out_bf16)
    contrast<<<blocks, threads, 0, s>>>(a, mean, factors, (__nv_bfloat16*)out,
                                        n, h, w, c);
  else
    contrast<<<blocks, threads, 0, s>>>(a, mean, factors, (float*)out, n, h,
                                        w, c);
  return (int)cudaGetLastError();
}
