// Fused training augmentation K1: dequantise -> same-size rotation by three
// shears with edge clamp -> per-channel contrast, NHWC [n, h, w, c].
//
// Replaces the Pallas TPU kernels of leaffliction_tpu/ops/pallas/rotate.py:
//   train_aug_rotate_contrast_nhwc_pallas (_train_aug_nhwc_kernel),
//   train_aug_rotate_contrast_pallas      (_train_aug_kernel),
//   rotate_batch_pallas_clamp_f32         (_rotate_clamp_kernel).
// Two modes:
//   uint8 in, contrast on, f32 or bf16 out   (the first two);
//   f32 in, contrast off, f32 out            (the third).
//
// Per image, with t = -tan(theta/2) and s = sin(theta) about the centre
// ((h-1)/2, (w-1)/2), each pass is a floor shift plus a 2-tap lerp:
//   pass 1, rows:    out[y, x] = lerp of src[y, .] at x + t*(y - cy)
//   pass 2, columns: out[y, x] = lerp of src[., x] at y + s*(x - cx)
//   pass 3, rows:    as pass 1
// A source position outside [0, size-1] takes the content edge sample of its
// own row (column) and channel, decided by the sign-exact 12-bit tests of
// warp_common.cuh (rotate.py::_scaled_positions). Then
//   out = clip(mean_c + (x - mean_c) * factor, 0, 1)
// with mean_c the mean of channel c over the h x w image.
//
// Each image's t, s and their heads and tails come from its angle, computed
// in the kernel by rotation_of (warp_common.cuh) with the operations of the
// PyTorch twin's rotation_controls (leaffliction_tpu_torch/ops/kernels/
// rotate.py), as the Pallas kernel computes theta from the angle in the
// kernel; leaf_rotation_controls exposes it so a test holds the two equal.
// The library is built with -fmad=false and repeats the twin's operations in
// its order, so the rotation is bit-equal to the twin's; the channel mean is
// summed in another order.
//
// What bounds it on an H100: bytes. At [32, 224, 224, 3] -> bf16 the call
// must read 4.8 MB of uint8 and write 9.6 MB, 4.3 us at 3.35 TB/s; its
// arithmetic (about 25 f32 operations a value, twice) is a few us at the
// card's f32 rate. The shared-memory kernel (train_aug_smem) is one launch
// that keeps nothing but the input and the output in device memory; what
// bounds it in practice is the instruction rate of the sweep's shared-memory
// gathers and index arithmetic.
//   - A thread-block cluster of k blocks takes one image; each block holds
//     the whole uint8 image in shared memory (150,528 B at 224^2, of the
//     227 KB a block may have) and owns 1/k of the output rows. One block
//     fits on an SM, and a cluster's blocks must share a GPC, so fewer
//     clusters of 4 fit at once than 132 / 4: k is chosen at launch from
//     the occupancy query, the fewest rows a block over the waves the card
//     runs (pick_split in warp_common.cuh; leaf_train_aug_blocks_per_image
//     reports it).
//   - Pass 1 is never stored: each value is computed from the image when
//     pass 2 needs it. One thread takes one pixel column (its three
//     channels share the line controls, the tap indices and the edge tests)
//     and a slice of 4 rows of each group of 16; it computes its slice's
//     five pass-1 values side by side into a shared row buffer; pass 3 reads
//     the buffer after a barrier.
//   - A byte becomes a float by an integer or and an add (exact), and the
//     dequantisation is the product with the rounded reciprocal and one
//     fma correction, exact for every byte (a true division costs ~10
//     instructions a tap).
//   - The contrast needs each channel's mean before any value is written.
//     Sweep 1 sums each thread's pixels in row order, then per channel in a
//     fixed tree; the k blocks' sums meet through distributed shared memory
//     after one cluster barrier, each block adding them in rank order
//     (deterministic, no atomics). Sweep 2 computes the rows again and
//     writes the contrast. Recomputing costs arithmetic, not bytes.
// Images whose uint8 plane does not fit (leaf_train_aug_smem_bytes = 0,
// above about 275^2), channel counts other than three, and the f32 mode,
// whose f32 image does not fit either, take the multi-pass kernels: one
// thread per output element for each pass through f32 scratch canvases,
// one block per (channel, image) for the mean (a fixed-order tree), and an
// elementwise contrast pass.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "device_guard.cuh"
#include "warp_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;     // blocks per image, the portable limit
constexpr int kMaxThreads = 1024;
constexpr int kSmemMax = 232448;   // Hopper's opt-in shared memory per block

// v / 255 correctly rounded, as a true division gives it: the product with
// the rounded reciprocal, then one exact residual and correction (exact for
// every byte value; each fma is explicit, so -fmad=false leaves it be)
__device__ __forceinline__ float dequant(uint8_t v) {
  const float x = u8_to_float(v);
  const float r = 1.0f / 255.0f;
  const float q = x * r;
  return __fmaf_rn(__fmaf_rn(-q, 255.0f, x), r, q);
}

__device__ __forceinline__ float load_px(const uint8_t* p, int64_t i) {
  return dequant(p[i]);
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

// ---- the shared-memory kernel ------------------------------------------

// Shared memory of train_aug_smem: the uint8 image (rounded up to 16 B), h
// row controls, the sweep's row buffer and three channel sums. Three
// channels only; other channel counts take the multi-pass kernels.
struct SmemLayout {
  int threads;     // w * split, rounded up to a warp
  SweepShape sh;   // the sweep's row slices
  int img_bytes;   // the image, rounded up to 16 B
  int bytes;       // 0 when the image does not fit
};

__host__ __device__ inline SmemLayout smem_layout(int h, int w, int c) {
  SmemLayout s = {0, {0, 0}, 0, 0};
  if (h <= 0 || w <= 0 || c != 3 || w > kMaxThreads || h > 32767) return s;
  const int64_t img = ((int64_t)h * w * 3 + 15) / 16 * 16;
  const int64_t fixed = img + 16 * (int64_t)h + 16;
  const SweepShape sh = sweep_shape(w, kSmemMax - fixed);
  if (sh.split == 0) return s;
  s.threads = (w * sh.split + 31) / 32 * 32;
  s.sh = sh;
  s.img_bytes = (int)img;
  s.bytes = (int)(fixed + 4 * (int64_t)sh.split * sh.rpt * w * 3);
  return s;
}

// launched as clusters of k blocks per image, k chosen at launch
template <typename O>
__global__ void __launch_bounds__(kMaxThreads)
    train_aug_smem(const uint8_t* __restrict__ in,
                   const float* __restrict__ angles,
                   const float* __restrict__ factors, O* __restrict__ out,
                   int h, int w) {
  extern __shared__ __align__(16) uint8_t smem[];
  const SmemLayout s = smem_layout(h, w, 3);
  const int line = w * 3;
  uint8_t* img = smem;
  ShearLine* rows = reinterpret_cast<ShearLine*>(smem + s.img_bytes);
  float* buf = reinterpret_cast<float*>(rows + h);
  float* csum = buf + s.sh.split * s.sh.rpt * line;

  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / k;

  copy_to_shared(img, in + (int64_t)b * h * line, h * line);
  const Rotation rot = rotation_of(angles[b]);
  const float cy = (float)(h - 1) * 0.5f;
  for (int y = threadIdx.x; y < h; y += blockDim.x)
    rows[y] = shear_line(rot.t, rot.t_hi, rot.t_lo, (float)y - cy, w);
  __syncthreads();

  // pass 1 at (row j, column x), three channels, clamped to the row's edges
  auto pass1 = [&](int j, int x, float* v) {
    const ShearLine r = rows[j];
    const uint8_t* src = img + j * line;
    if (x < r.lo || x > r.hi) {
      const uint8_t* e = src + (x < r.lo ? 0 : (w - 1) * 3);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) v[ch] = dequant(e[ch]);
    } else {
      const int i0 = x + r.k;
      const uint8_t* a = src + clampi(i0, 0, w - 1) * 3;
      const uint8_t* b1 = src + clampi(i0 + 1, 0, w - 1) * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        v[ch] = lerp2(dequant(a[ch]), dequant(b1[ch]), r);
    }
  };

  const int band = (h + k - 1) / k;
  const int y_begin = min(h, rank * band);
  const int y_end = min(h, y_begin + band);

  // sweep 1: this thread's pixels summed per channel over its rows
  float acc[3] = {0.0f, 0.0f, 0.0f};
  shear3_sweep<true>(rows, buf, s.sh, rot, h, w, y_begin, y_end, pass1,
                     [&](int, int, const float* v) {
#pragma unroll
                       for (int ch = 0; ch < 3; ++ch) acc[ch] += v[ch];
                     });

  // the block's channel sums: threads in a fixed order, one warp a channel
  const int n_sum = w * s.sh.split;
  if ((int)threadIdx.x < n_sum)
    for (int ch = 0; ch < 3; ++ch) buf[threadIdx.x * 3 + ch] = acc[ch];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ch = warp; ch < 3; ch += blockDim.x / 32) {
    float t = 0.0f;
    for (int i = lane; i < n_sum; i += 32) t += buf[i * 3 + ch];
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) csum[ch] = t;
  }
  cluster.sync();
  // the image's means from the k blocks' sums, in rank order
  if (threadIdx.x < 3) {
    float t = 0.0f;
    for (int r = 0; r < k; ++r)
      t += cluster.map_shared_rank(csum, r)[threadIdx.x];
    buf[threadIdx.x] = t / (float)(h * w);
  }
  cluster.sync();  // every block has read every block's sums
  const float mean[3] = {buf[0], buf[1], buf[2]};
  const float factor = factors[b];
  __syncthreads();  // the means are read before sweep 2 reuses buf

  // sweep 2: the same rows again, with the contrast, to the output
  O* dst = out + (int64_t)b * h * line;
  shear3_sweep<true>(
      rows, buf, s.sh, rot, h, w, y_begin, y_end, pass1,
      [&](int y, int x, const float* v) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float o = mean[ch] + (v[ch] - mean[ch]) * factor;
          store_px(dst, ((int64_t)y * w + x) * 3 + ch,
                   fminf(fmaxf(o, 0.0f), 1.0f));
        }
      });
}

// ---- the multi-pass kernels (large images, f32 mode) --------------------

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

cudaLaunchAttribute cluster_of(int k) {
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = k;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

// Blocks per image (the cluster size) for n images of h rows: pick_split
// over the clusters of each size the card can run at once, which the
// occupancy query gives (a cluster's blocks share a GPC, so fewer clusters
// of 4 fit than 132 / 4). The query runs once per device and layout.
template <typename O>
int pick_cluster(const cudaLaunchConfig_t& base, int n, int h) {
  static std::mutex mu;
  static int key[3] = {-1, 0, 0};  // device, shared bytes, threads
  static int fits[kMaxCluster + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  if (key[0] != dev || key[1] != (int)base.dynamicSmemBytes ||
      key[2] != (int)base.blockDim.x) {
    for (int k = 1; k <= kMaxCluster; ++k) {
      cudaLaunchConfig_t cfg = base;
      cudaLaunchAttribute attr = cluster_of(k);
      cfg.gridDim = dim3(k);
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&fits[k], train_aug_smem<O>, &cfg) !=
          cudaSuccess) {
        fits[k] = 0;
        cudaGetLastError();  // a size the card refuses is not an error
      }
    }
    key[0] = dev;
    key[1] = (int)base.dynamicSmemBytes;
    key[2] = (int)base.blockDim.x;
  }
  return pick_split(n, h, kMaxCluster, [](int k) { return fits[k]; });
}

// The launch of train_aug_smem<O> for n images of h x w x c, but for its
// grid and cluster: sets the kernel's shared-memory limit and returns the
// cluster size k, or a negative cudaError_t.
template <typename O>
int smem_config(int n, int h, int w, int c, cudaStream_t st,
                cudaLaunchConfig_t* cfg) {
  const SmemLayout s = smem_layout(h, w, c);
  cudaError_t err = cudaFuncSetAttribute(
      train_aug_smem<O>, cudaFuncAttributeMaxDynamicSharedMemorySize, s.bytes);
  if (err != cudaSuccess) return -(int)err;
  *cfg = cudaLaunchConfig_t{};
  cfg->blockDim = dim3(s.threads);
  cfg->dynamicSmemBytes = s.bytes;
  cfg->stream = st;
  const int k = pick_cluster<O>(*cfg, n, h);
  return k > 0 ? k : -(int)cudaErrorInvalidConfiguration;
}

template <typename O>
int launch_smem(const uint8_t* in, const float* angles, const float* factors,
                O* out, int n, int h, int w, int c, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  const int k = smem_config<O>(n, h, w, c, st, &cfg);
  if (k < 0) return -k;
  cudaLaunchAttribute attr = cluster_of(k);
  cfg.gridDim = dim3(n * k);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, train_aug_smem<O>, in,
                                             angles, factors, out, h, w);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launches of leaf_train_aug on the current device.
int launch_train_aug(const void* in, const float* angles, const float* factors,
                     float* scratch, void* out, int in_u8, int out_bf16, int n,
                     int h, int w, int c, cudaStream_t s) {
  const int64_t total = (int64_t)n * h * w * c;
  if (in_u8 && smem_layout(h, w, c).bytes) {
    const uint8_t* u8 = (const uint8_t*)in;
    return out_bf16 ? launch_smem(u8, angles, factors, (__nv_bfloat16*)out, n,
                                  h, w, c, s)
                    : launch_smem(u8, angles, factors, (float*)out, n, h, w,
                                  c, s);
  }
  float* ctrl = scratch;
  float* mean = ctrl + 6 * (int64_t)n;
  float* a = mean + (int64_t)n * c;
  float* b = a + total;
  rotation_controls_kernel<<<(n + 127) / 128, 128, 0, s>>>(angles, ctrl, n);
  const int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (in_u8)
    row_pass<<<blocks, threads, 0, s>>>((const uint8_t*)in, a, ctrl, n, h, w,
                                        c);
  else
    row_pass<<<blocks, threads, 0, s>>>((const float*)in, a, ctrl, n, h, w, c);
  col_pass<<<blocks, threads, 0, s>>>(a, b, ctrl, n, h, w, c);
  if (!in_u8) {
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

}  // namespace

// h, w, c -> dynamic shared-memory bytes of the single-launch uint8 kernel;
// 0 = the image does not fit and the multi-pass kernels run
extern "C" int leaf_train_aug_smem_bytes(int h, int w, int c) {
  return smem_layout(h, w, c).bytes;
}

// blocks per image (the cluster size) of the single-launch uint8 kernel
// for n images of h x w x c, bf16 out when out_bf16 = 1 else f32; 0 when
// the multi-pass kernels run; a negative cudaError_t on failure
extern "C" int leaf_train_aug_blocks_per_image(int n, int h, int w, int c,
                                               int out_bf16) {
  if (n <= 0 || !smem_layout(h, w, c).bytes) return 0;
  cudaLaunchConfig_t cfg;
  return out_bf16 ? smem_config<__nv_bfloat16>(n, h, w, c, 0, &cfg)
                  : smem_config<float>(n, h, w, c, 0, &cfg);
}

// angles: f32 [n] degrees -> ctrl: f32 [6, n] (t, t_hi, t_lo, s, s_hi, s_lo),
// the kernels' own controls, for tests against rotation_controls
extern "C" int leaf_rotation_controls(const float* angles, float* ctrl, int n,
                                      int device, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    rotation_controls_kernel<<<(n + 127) / 128, 128, 0,
                               (cudaStream_t)stream>>>(angles, ctrl, n);
    return cudaGetLastError();
  });
}

// in: uint8 (in_u8 = 1, with the contrast) or f32 (in_u8 = 0, rotation
// only) [n, h, w, c]; angles: f32 [n] degrees; factors: f32 [n] (read only
// with in_u8 = 1); out: [n, h, w, c], bf16 when out_bf16 = 1 else f32 (f32
// when in_u8 = 0). uint8 input with leaf_train_aug_smem_bytes(h, w, c) > 0
// is one launch of train_aug_smem, and scratch is unused (may be null);
// otherwise scratch is f32 [6 n + n c + 2 n h w c] for the multi-pass
// kernels. All on device `device`. Returns cudaGetLastError() after the
// launches.
extern "C" int leaf_train_aug(const void* in, const float* angles,
                              const float* factors, float* scratch, void* out,
                              int in_u8, int out_bf16, int n, int h, int w,
                              int c, int device, void* stream) {
  if ((int64_t)n * h * w * c == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    return (cudaError_t)launch_train_aug(in, angles, factors, scratch, out,
                                         in_u8, out_bf16, n, h, w, c,
                                         (cudaStream_t)stream);
  });
}
