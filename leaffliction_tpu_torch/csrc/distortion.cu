// Fused distortion K6: uint8 NHWC [n, h, w, 3] -> uint8 [n, h, w, 3],
// additive noise then per-channel autocontrast, one block per
// (image, channel) plane.
//
// Replaces the Pallas TPU kernel distortion_batch_pallas
// (_distortion_kernel) of leaffliction_tpu/ops/pallas/distortion.py. Per
// plane, with its 32-bit seed and cutoff percentage:
//   noise  = Irwin-Hall(12): sum of twelve 23-bit uniforms, minus 6
//            (mean 0, variance 1, support +-6);
//   x      = clip(v + 5 * noise, 0, 255);
//   lo, hi = 8-step binary search of the autocontrast cutoff bins over the
//            256-bin histogram of rint(x): lo the least value with
//            count(q <= lo) > cut, hi the greatest with count(q >= hi) > cut,
//            cut = cutoff * h * w / 100 (photometric.autocontrast's cut);
//   out    = rint(clip(x * scale + offset)) with scale = 255 / (hi - lo),
//            offset = -lo * scale where hi > lo, else x.
// The TPU kernel draws its bits from the TPU's per-core PRNG. Here they come
// from Philox4x32-10, written out: key (seed, 0), counter (pixel, j, 0, 0)
// for j = 0, 1, 2 gives the 12 words a pixel needs; each word's top 23 bits
// are one uniform. The 12 are summed as integers (exact, order-free), then
// converted once. The plain twin (ops/kernels/distortion.py) computes the
// same words with 16-bit limbs in torch integer ops, so kernel and twin agree
// bit for bit. The histogram is built with integer atomics in shared memory
// (deterministic counts); the noise is drawn again for the remap instead of
// being stored.
//
// What bounds it on an H100: integer arithmetic, 3 Philox calls (30 rounds)
// per pixel-channel, twice; at 64 x 224^2 x 3 that is ~6 G integer ops
// against one uint8 read per pass and one uint8 write.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "warp_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    uint32_t lo0 = 0xD2511F53u * c[0];
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    uint32_t lo1 = 0xCD9E8D57u * c[2];
    uint32_t n0 = hi1 ^ c[1] ^ k0;
    uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// clip(v + 5 * noise, 0, 255) for pixel p of the plane keyed by `seed`
__device__ __forceinline__ float noisy(float v, uint32_t seed, uint32_t p) {
  int sum = 0;
  for (uint32_t j = 0; j < 3; ++j) {
    uint32_t c[4] = {p, j, 0u, 0u};
    philox4x32_10(c, seed, 0u);
    for (int l = 0; l < 4; ++l) sum += (int)(c[l] >> 9);
  }
  float noise = (float)sum * (1.0f / 8388608.0f) - 6.0f;
  return fminf(fmaxf(v + 5.0f * noise, 0.0f), 255.0f);
}

__global__ void __launch_bounds__(kThreads)
    distortion_kernel(const uint8_t* __restrict__ in,
                      uint8_t* __restrict__ out,
                      const uint32_t* __restrict__ seeds,
                      const float* __restrict__ cutoffs, int h, int w) {
  int plane = blockIdx.x;  // b * 3 + ch
  int b = plane / 3;
  int ch = plane % 3;
  int hw = h * w;
  uint32_t seed = seeds[plane];
  const uint8_t* src = in + (int64_t)b * hw * 3 + ch;
  uint8_t* dst = out + (int64_t)b * hw * 3 + ch;

  __shared__ unsigned int hist[256];
  __shared__ int bounds[2];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0u;
  __syncthreads();
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    float x = noisy((float)src[(int64_t)p * 3], seed, (uint32_t)p);
    atomicAdd(&hist[(int)rintf(x)], 1u);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double cut = (double)(cutoffs[b] * (float)hw / 100.0f);
    int lo_lo = 0, lo_hi = 255, hi_lo = 0, hi_hi = 255;
    for (int step = 0; step < 8; ++step) {
      int lo_mid = (lo_lo + lo_hi) / 2;
      int hi_mid = (hi_lo + hi_hi + 1) / 2;
      long long le = 0, ge = 0;
      for (int v = 0; v <= lo_mid; ++v) le += hist[v];
      for (int v = hi_mid; v < 256; ++v) ge += hist[v];
      if ((double)le > cut) lo_hi = lo_mid; else lo_lo = lo_mid + 1;
      if ((double)ge > cut) hi_lo = hi_mid; else hi_hi = hi_mid - 1;
    }
    bounds[0] = lo_lo;
    bounds[1] = hi_lo;
  }
  __syncthreads();
  float lo = (float)bounds[0];
  float hi = (float)bounds[1];
  bool live = hi > lo;
  float scale = live ? 255.0f / fmaxf(hi - lo, 1e-6f) : 1.0f;
  float offset = live ? -lo * scale : 0.0f;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    float x = noisy((float)src[(int64_t)p * 3], seed, (uint32_t)p);
    dst[(int64_t)p * 3] = round_clip_u8(live ? x * scale + offset : x);
  }
}

}  // namespace

// in, out: uint8 [n, h, w, 3]; seeds: uint32 [n, 3]; cutoffs: f32 [n]; all
// on device `device`. Returns cudaGetLastError() after the launch.
extern "C" int leaf_distortion(const uint8_t* in, const uint32_t* seeds,
                               const float* cutoffs, uint8_t* out, int n,
                               int h, int w, int device, void* stream) {
  if ((int64_t)n * h * w == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    distortion_kernel<<<n * 3, kThreads, 0, (cudaStream_t)stream>>>(
        in, out, seeds, cutoffs, h, w);
    return cudaGetLastError();
  });
}
