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
// t, s and their heads and tails are computed from each image's angle in
// the kernel (warp_common.cuh rotation_of, the operations of the twin's
// rotation_controls). With -fmad=false the arithmetic repeats the twin's
// (leaffliction_tpu_torch/ops/kernels/warp.py) operation for operation, so
// kernel and twin agree exactly.
//
// What bounds it on an H100: bytes. At 64 x 224^2 the call reads 9.6 MB of
// uint8 and writes the 64 x 306^2 x 3 canvas, 18.0 MB: 8.2 us at 3.35 TB/s.
// The shared-memory kernel (rotate_expand_smem) is one launch that moves
// just those bytes: one block holds one image's uint8 plane in shared
// memory (150,528 B at 224^2) and produces a band of canvas rows; pass 1 is
// computed on the fly from the plane, pass 2 goes a group of rows at a time
// into a shared row buffer, pass 3 reads it and writes uint8 (the streaming
// sweep of warp_common.cuh, white fill: one thread per pixel column and row
// slice, its three channels sharing the controls and tap indices). What
// bounds it in practice is the instruction rate of those shared-memory
// gathers.
// The canvas rows of an image are split over as many blocks as fill the
// card in the fewest waves (pick_split: two at 64 images on 132 SMs, one
// block an SM; leaf_rotate_expand_blocks_per_image reports it). Images
// whose plane does not fit (leaf_rotate_expand_smem_bytes = 0) take the
// multi-pass kernels: one thread per canvas element per pass, through two
// f32 scratch canvases.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "warp_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemMax = 232448;      // Hopper's opt-in shared memory
constexpr int kMaxBands = 8;          // blocks per image

// canvas value before pass 1: the input where it is placed, else white
__device__ __forceinline__ float placed(const uint8_t* in, int b, int y, int x,
                                        int ch, int h, int w, int y0, int x0) {
  int iy = y - y0;
  int ix = x - x0;
  if (iy < 0 || iy >= h || ix < 0 || ix >= w) return 255.0f;
  return (float)in[(((int64_t)b * h + iy) * w + ix) * 3 + ch];
}

// ---- the shared-memory kernel ------------------------------------------

// Shared memory of rotate_expand_smem: the uint8 image (rounded up to 16 B),
// oh row controls and the sweep's row buffer.
struct SmemLayout {
  int threads;     // ow * split, rounded up to a warp
  SweepShape sh;   // the sweep's row slices
  int img_bytes;   // the image, rounded up to 16 B
  int bytes;       // 0 when the image does not fit
};

__host__ __device__ inline SmemLayout smem_layout(int h, int w, int oh,
                                                  int ow) {
  SmemLayout s = {0, {0, 0}, 0, 0};
  if (h <= 0 || w <= 0 || oh < h || ow < w || oh > 32767 || ow > kMaxThreads)
    return s;
  const int64_t img = ((int64_t)h * w * 3 + 15) / 16 * 16;
  const int64_t fixed = img + 16 * (int64_t)oh;
  const SweepShape sh = sweep_shape(ow, kSmemMax - fixed);
  if (sh.split == 0) return s;
  s.threads = (ow * sh.split + 31) / 32 * 32;
  s.sh = sh;
  s.img_bytes = (int)img;
  s.bytes = (int)(fixed + 4 * (int64_t)sh.split * sh.rpt * ow * 3);
  return s;
}

__global__ void __launch_bounds__(kMaxThreads)
    rotate_expand_smem(const uint8_t* __restrict__ in,
                       const float* __restrict__ angles,
                       uint8_t* __restrict__ out, int h, int w, int oh, int ow,
                       int bands) {
  extern __shared__ __align__(16) uint8_t smem[];
  const SmemLayout s = smem_layout(h, w, oh, ow);
  uint8_t* img = smem;
  ShearLine* rows = reinterpret_cast<ShearLine*>(smem + s.img_bytes);
  float* buf = reinterpret_cast<float*>(rows + oh);

  const int b = blockIdx.x / bands;
  const int band = blockIdx.x - b * bands;
  copy_to_shared(img, in + (int64_t)b * h * w * 3, h * w * 3);
  const Rotation rot = rotation_of(angles[b]);
  const float cy = (float)(oh - 1) * 0.5f;
  for (int y = threadIdx.x; y < oh; y += blockDim.x)
    rows[y] = shear_line(rot.t, rot.t_hi, rot.t_lo, (float)y - cy, ow);
  __syncthreads();

  const int y0 = (oh - h) / 2;
  const int x0 = (ow - w) / 2;
  // pass 1 at (canvas row j, column x), three channels: the placed input in
  // shared memory, white around it and outside the row's source range
  auto pass1 = [&](int j, int x, float* v) {
    const ShearLine r = rows[j];
    const int iy = j - y0;
    if (x < r.lo || x > r.hi) {
      v[0] = v[1] = v[2] = 255.0f;
      return;
    }
    if (iy < 0 || iy >= h) {  // a white canvas row, lerped as the twin does
      v[0] = v[1] = v[2] = lerp2(255.0f, 255.0f, r);
      return;
    }
    const int i0 = clampi(x + r.k, 0, ow - 1) - x0;
    const int i1 = clampi(x + r.k + 1, 0, ow - 1) - x0;
    const uint8_t* row = img + iy * w * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float v0 = i0 >= 0 && i0 < w ? u8_to_float(row[i0 * 3 + ch])
                                         : 255.0f;
      const float v1 = i1 >= 0 && i1 < w ? u8_to_float(row[i1 * 3 + ch])
                                         : 255.0f;
      v[ch] = lerp2(v0, v1, r);
    }
  };

  const int per = (oh + bands - 1) / bands;
  const int y_begin = min(oh, band * per);
  const int y_end = min(oh, y_begin + per);
  uint8_t* dst = out + (int64_t)b * oh * ow * 3;
  shear3_sweep<false>(rows, buf, s.sh, rot, oh, ow, y_begin, y_end, pass1,
                      [&](int y, int x, const float* v) {
                        uint8_t* o = dst + ((int64_t)y * ow + x) * 3;
#pragma unroll
                        for (int ch = 0; ch < 3; ++ch)
                          o[ch] = round_clip_u8(v[ch]);
                      });
}

// Blocks per image (bands of canvas rows) for n images of h x w on an
// oh x ow canvas: pick_split over the images each band count lets the card
// run at once (one block an SM at 224^2); 0 if the kernel cannot run.
int pick_bands(int n, int oh, const SmemLayout& s) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rotate_expand_smem, s.threads, s.bytes) != cudaSuccess)
    return 0;
  return pick_split(n, oh, kMaxBands,
                    [&](int k) { return sms * per_sm / k; });
}

// ---- the multi-pass kernels (large images) ------------------------------

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

// h, w, oh, ow -> dynamic shared-memory bytes of the single-launch kernel;
// 0 = the image does not fit and the multi-pass kernels run
extern "C" int leaf_rotate_expand_smem_bytes(int h, int w, int oh, int ow) {
  return smem_layout(h, w, oh, ow).bytes;
}

// blocks per image of the single-launch kernel for n images; 0 when the
// multi-pass kernels run; a negative cudaError_t on failure
extern "C" int leaf_rotate_expand_blocks_per_image(int n, int h, int w, int oh,
                                                   int ow) {
  const SmemLayout lay = smem_layout(h, w, oh, ow);
  if (n <= 0 || !lay.bytes) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      rotate_expand_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.bytes);
  if (err != cudaSuccess) return -(int)err;
  const int bands = pick_bands(n, oh, lay);
  return bands > 0 ? bands : -(int)cudaErrorInvalidConfiguration;
}

// in: uint8 [n, h, w, 3]; angles: f32 [n] degrees; out: uint8 [n, oh, ow,
// 3]. With leaf_rotate_expand_smem_bytes(h, w, oh, ow) > 0 the call is one
// launch of rotate_expand_smem and scratch is unused (may be null);
// otherwise scratch is f32 [6 n + 2 n oh ow 3] for the multi-pass kernels.
// All on device `device`. Returns cudaGetLastError() after the launches.
extern "C" int leaf_rotate_expand(const uint8_t* in, const float* angles,
                                  float* scratch, uint8_t* out, int n, int h,
                                  int w, int oh, int ow, int device,
                                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = (int64_t)n * oh * ow * 3;
  if (total == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    const SmemLayout lay = smem_layout(h, w, oh, ow);
    if (lay.bytes) {
      const cudaError_t err = cudaFuncSetAttribute(
          rotate_expand_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
          lay.bytes);
      if (err != cudaSuccess) return err;
      const int bands = pick_bands(n, oh, lay);
      if (bands == 0) return cudaErrorInvalidConfiguration;
      rotate_expand_smem<<<n * bands, lay.threads, lay.bytes, s>>>(
          in, angles, out, h, w, oh, ow, bands);
      return cudaGetLastError();
    }
    float* ctrl = scratch;
    float* a = ctrl + 6 * (int64_t)n;
    float* b = a + total;
    rotation_controls_kernel<<<(n + 127) / 128, 128, 0, s>>>(angles, ctrl, n);
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    row_pass_in<<<blocks, threads, 0, s>>>(in, a, ctrl, n, h, w, oh, ow);
    col_pass<<<blocks, threads, 0, s>>>(a, b, ctrl, n, oh, ow);
    row_pass_out<<<blocks, threads, 0, s>>>(b, out, ctrl, n, oh, ow);
    return cudaGetLastError();
  });
}
