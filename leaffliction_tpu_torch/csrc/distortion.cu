// Fused distortion K6: uint8 NHWC [n, h, w, 3] -> uint8 [n, h, w, 3],
// additive noise then per-channel autocontrast.
//
// Replaces the Pallas TPU kernel distortion_batch_pallas
// (_distortion_kernel) of leaffliction_tpu/ops/pallas/distortion.py. Per
// (image, channel) plane, with its 32-bit seed and the image's cutoff
// percentage:
//   noise  = Irwin-Hall(12): sum of twelve 23-bit uniforms, minus 6
//            (mean 0, variance 1, support +-6);
//   x      = clip(v + 5 * noise, 0, 255);
//   lo, hi = the autocontrast cutoff bins of the 256-bin histogram of
//            rint(x): lo the least value with count(q <= lo) > cut, hi the
//            greatest with count(q >= hi) > cut, cut = cutoff * h * w / 100
//            (photometric.autocontrast's cut);
//   out    = rint(clip(x * scale + offset)) with scale = 255 / (hi - lo),
//            offset = -lo * scale where hi > lo, else x.
// The TPU kernel draws its bits from the TPU's per-core PRNG. Here they come
// from Philox4x32-10, written out: key (seed, 0), counter (pixel, j, 0, 0)
// for j = 0, 1, 2 gives the 12 words a pixel needs; each word's top 23 bits
// are one uniform. The 12 are summed as integers (exact, order-free), then
// converted once. The plain twin (ops/kernels/distortion.py) computes the
// same words with 16-bit limbs in torch integer ops, and the library is
// built with -fmad=false, so kernel and twin agree bit for bit.
//
// The bins come from a parallel count, not the Pallas kernel's 8-step
// binary search: both predicates are monotone in the value, so
//   lo = #{v : count(q <= v) <= cut},  hi = 255 - #{v : count(q >= v) <= cut}
// (the twin's photometric.cutoff_bins). One warp a channel counts them, a
// lane per 8 bins, the cumulative counts from a shuffle scan.
//
// What bounds it on an H100: operations. Three Philox calls a value, each
// 10 rounds of two 32 x 32 -> 64-bit products and two three-way xors (8
// 32-bit operations a round; the round keys are per plane, and the first
// three rounds start from the counter's constant words, so a pixel's nine
// streams share most of their products: about 64 operations a call), plus
// the noise sum, clip and remap: about 222 operations a value against one
// uint8 read and one uint8 write. At 64 x 224^2 x 3 that is 2.1 G
// operations (32 us at 67 T/s) against 19 MB (5.8 us at 3.35 TB/s). In
// SASS a pixel's three values take about 390 instructions, 142 of them
// IMAD.WIDE.U32 (tools/kernel_sass.py), and those products issue slower
// than the xors: they are the floor, not the bytes. The design:
//   - A thread-block cluster of k blocks takes one image; each block a band
//     of ceil(h*w / k) pixels, a thread a pixel's three channels (its three
//     bytes, its three seeds' round keys, computed once a thread).
//   - The noise is drawn once: each value's x is kept from the histogram
//     to the remap, a thread's first kRegPx pixels in registers, the rest
//     in the block's shared memory (12 bytes a pixel). 64 images of 224^2
//     need 38.5 MB of x, more than the card's 30 MB of shared memory, but
//     registers and shared memory together hold them in one wave of
//     clusters of 2.
//   - Each block counts its band into three 256-bin histograms in shared
//     memory (integer atomics: any order is exact); after a cluster barrier
//     every block sums the k blocks' bins through distributed shared memory
//     and counts the cutoffs itself, then remaps its band.
//   - k is picked per call from the clusters the card runs at once
//     (cudaOccupancyMaxActiveClusters: a cluster's blocks share a GPC) and
//     the busiest SM's pixels over the waves (pick_blocks;
//     leaf_distortion_blocks_per_image reports it); above 8 blocks a
//     cluster is non-portable, allowed by
//     cudaFuncAttributeNonPortableClusterSizeAllowed.
// Images whose band does not fit at 16 blocks (leaf_distortion_smem_bytes
// = 0, above about 660^2) take the simple kernel: one block per (image,
// channel) plane that draws the noise twice, once for the histogram and
// once for the remap, since keeping x would need a scratch plane in device
// memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "device_guard.cuh"
#include "warp_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;        // cluster kernel, a block
constexpr int kRegPx = 16;           // pixels a thread keeps in registers
constexpr int kSimpleThreads = 1024;
constexpr int kMaxCluster = 16;      // blocks an image; above 8 non-portable
constexpr int kSmemMax = 232448;     // Hopper's opt-in shared memory
constexpr int kHistWords = 3 * 256;  // three 256-bin histograms
constexpr int kHeadWords = kHistWords + 8;  // + the six bins found
// a wave's fixed cost (launch, barriers, the histogram merge), in pixels of
// work a block: about 7 us against 3.2 ns a pixel on an H100
constexpr int kFixedPx = 2048;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr unsigned kFull = 0xffffffffu;

// one Philox4x32 round with round keys k0, k1
__device__ __forceinline__ void philox_round(uint32_t c[4], uint32_t k0,
                                             uint32_t k1) {
  const uint32_t hi0 = __umulhi(kM0, c[0]);
  const uint32_t lo0 = kM0 * c[0];
  const uint32_t hi1 = __umulhi(kM1, c[2]);
  const uint32_t lo1 = kM1 * c[2];
  c[0] = hi1 ^ c[1] ^ k0;
  c[1] = lo1;
  c[2] = hi0 ^ c[3] ^ k1;
  c[3] = lo0;
}

// The round keys' first halves of a seed: seed + r * W0 (the second halves,
// r * W1, are constants)
struct RoundKeys {
  uint32_t k0[10];
};

__device__ __forceinline__ RoundKeys round_keys(uint32_t seed) {
  RoundKeys rk;
#pragma unroll
  for (int r = 0; r < 10; ++r) rk.k0[r] = seed + (uint32_t)r * kW0;
  return rk;
}

// clip(v + 5 * noise, 0, 255) for pixel p of the plane keyed by rk: the
// twelve words of Philox4x32-10 at counters (p, j, 0, 0), j = 0, 1, 2, side
// by side (their first rounds share products), summed as integers
__device__ __forceinline__ float noisy(float v, const RoundKeys& rk,
                                       uint32_t p) {
  uint32_t c[3][4];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    c[j][0] = p;
    c[j][1] = (uint32_t)j;
    c[j][2] = 0u;
    c[j][3] = 0u;
  }
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int j = 0; j < 3; ++j) philox_round(c[j], rk.k0[r], (uint32_t)r * kW1);
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int l = 0; l < 4; ++l) sum += (int)(c[j][l] >> 9);
  const float noise = (float)sum * (1.0f / 8388608.0f) - 6.0f;
  return fminf(fmaxf(v + 5.0f * noise, 0.0f), 255.0f);
}

// cut = cutoff * h * w / 100 in f32, as the twin's cutoff_count, widened
__device__ __forceinline__ double cutoff_cut(float cutoff, int hw) {
  return (double)(cutoff * (float)hw / 100.0f);
}

// The cutoff bins of one channel, counted by a warp: lane l holds bins
// 8l .. 8l + 7 of the plane's histogram in cnt. Every lane gets (lo, hi).
__device__ __forceinline__ int2 cutoff_bins_warp(const uint32_t cnt[8],
                                                 int hw, double cut) {
  const int lane = threadIdx.x % 32;
  uint32_t run[8];
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) run[i] = acc += cnt[i];
  uint32_t incl = acc;  // count(q < 8 (l + 1)), by an inclusive scan
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  const uint32_t before = incl - acc;  // count(q < 8 l)
  uint32_t n_lo = 0, n_hi = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t le = before + run[i];           // count(q <= v)
    const uint32_t ge = (uint32_t)hw - (le - cnt[i]);  // count(q >= v)
    n_lo += (double)le <= cut;
    n_hi += (double)ge <= cut;
  }
  return make_int2((int)__reduce_add_sync(kFull, n_lo),
                   255 - (int)__reduce_add_sync(kFull, n_hi));
}

// x -> the output byte, from the plane's bins (photometric.remap)
struct Remap {
  bool live;
  float scale, offset;
};

__device__ __forceinline__ Remap remap_of(int lo_bin, int hi_bin) {
  const float lo = (float)lo_bin, hi = (float)hi_bin;
  Remap m;
  m.live = hi > lo;
  m.scale = m.live ? 255.0f / fmaxf(hi - lo, 1e-6f) : 1.0f;
  m.offset = m.live ? -lo * m.scale : 0.0f;
  return m;
}

__device__ __forceinline__ uint8_t remap_u8(float x, const Remap& m) {
  return round_clip_u8(m.live ? x * m.scale + m.offset : x);
}

// ---- the cluster kernel ---------------------------------------------------

// pixels of a block's band when an image of hw pixels takes k blocks
__host__ __device__ inline int64_t band_px(int64_t hw, int k) {
  return (hw + k - 1) / k;
}

// dynamic shared memory of that block: the histograms, the bins found and
// the x values of the band's pixels beyond the kRegPx * kThreads its
// threads keep in registers
__host__ __device__ inline int64_t cluster_bytes(int64_t hw, int k) {
  const int64_t spill = band_px(hw, k) - (int64_t)kRegPx * kThreads;
  return 4 * (int64_t)kHeadWords + 12 * (spill > 0 ? spill : 0);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// launched as clusters of k blocks per image, k chosen at launch; a
// thread's pixels are p0 + threadIdx.x + j * kThreads, the first kRegPx of
// them with x in registers, the rest with x in shared memory
__global__ void __launch_bounds__(kThreads, 1)
    distortion_cluster(const uint8_t* __restrict__ in,
                       const int64_t* __restrict__ seeds,
                       const float* __restrict__ cutoffs,
                       uint8_t* __restrict__ out, int hw) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* hist = smem;                       // [3][256]
  int* bins = (int*)(smem + kHistWords);       // lo[3], hi[3]
  float* xs = (float*)(smem + kHeadWords);     // [band - kRegPx kThreads][3]

  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / k;
  const int band = (int)band_px(hw, k);
  const int p0 = min(hw, rank * band);
  const int p1 = min(hw, p0 + band);
  const int first = p0 + threadIdx.x;                  // in registers
  const int spilled = p0 + kRegPx * kThreads;          // x in shared memory

  for (int i = threadIdx.x; i < kHistWords; i += kThreads) hist[i] = 0u;
  RoundKeys rk[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    rk[ch] = round_keys((uint32_t)seeds[b * 3 + ch]);
  __syncthreads();

  // the noise, once: x kept, rint(x) into the histograms
  const uint8_t* src = in + (int64_t)b * hw * 3;
  auto draw = [&](int p, float* x) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      x[ch] = noisy(u8_to_float(src[(int64_t)p * 3 + ch]), rk[ch],
                    (uint32_t)p);
      atomicAdd(&hist[ch * 256 + (int)rintf(x[ch])], 1u);
    }
  };
  float xr[kRegPx][3];
#pragma unroll
  for (int j = 0; j < kRegPx; ++j)
    if (first + j * kThreads < p1) draw(first + j * kThreads, xr[j]);
  for (int p = spilled + threadIdx.x; p < p1; p += kThreads)
    draw(p, xs + (p - spilled) * 3);
  cluster.sync();

  // the image's bins: warp ch sums the k blocks' histograms of channel ch
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < 3) {
    uint32_t cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int r = 0; r < k; ++r) {
      const uint4* h4 = reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(hist, r) + warp * 256 + lane * 8);
      const uint4 a = h4[0], c = h4[1];
      cnt[0] += a.x; cnt[1] += a.y; cnt[2] += a.z; cnt[3] += a.w;
      cnt[4] += c.x; cnt[5] += c.y; cnt[6] += c.z; cnt[7] += c.w;
    }
    const int2 lh = cutoff_bins_warp(cnt, hw, cutoff_cut(cutoffs[b], hw));
    if (lane == 0) {
      bins[warp] = lh.x;
      bins[3 + warp] = lh.y;
    }
  }
  cluster_arrive();  // this block has read every block's histograms
  __syncthreads();   // the bins are written

  const Remap m[3] = {remap_of(bins[0], bins[3]), remap_of(bins[1], bins[4]),
                      remap_of(bins[2], bins[5])};
  uint8_t* dst = out + (int64_t)b * hw * 3;
  auto store = [&](int p, const float* x) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      dst[(int64_t)p * 3 + ch] = remap_u8(x[ch], m[ch]);
  };
#pragma unroll
  for (int j = 0; j < kRegPx; ++j)
    if (first + j * kThreads < p1) store(first + j * kThreads, xr[j]);
  for (int p = spilled + threadIdx.x; p < p1; p += kThreads)
    store(p, xs + (p - spilled) * 3);
  cluster_wait();  // no block leaves while another may read its histograms
}

// ---- the simple kernel (images too large for a cluster) -----------------

// one block per (image, channel) plane; the noise drawn twice
__global__ void __launch_bounds__(kSimpleThreads)
    distortion_simple(const uint8_t* __restrict__ in,
                      const int64_t* __restrict__ seeds,
                      const float* __restrict__ cutoffs,
                      uint8_t* __restrict__ out, int hw) {
  const int plane = blockIdx.x;  // b * 3 + ch
  const int b = plane / 3;
  const int ch = plane % 3;
  const RoundKeys rk = round_keys((uint32_t)seeds[plane]);
  const uint8_t* src = in + (int64_t)b * hw * 3 + ch;
  uint8_t* dst = out + (int64_t)b * hw * 3 + ch;

  __shared__ __align__(16) uint32_t hist[256];
  __shared__ int bins[2];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0u;
  __syncthreads();
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float x = noisy(u8_to_float(src[(int64_t)p * 3]), rk, (uint32_t)p);
    atomicAdd(&hist[(int)rintf(x)], 1u);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    uint32_t cnt[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) cnt[i] = hist[threadIdx.x * 8 + i];
    const int2 lh = cutoff_bins_warp(cnt, hw, cutoff_cut(cutoffs[b], hw));
    if (threadIdx.x == 0) {
      bins[0] = lh.x;
      bins[1] = lh.y;
    }
  }
  __syncthreads();
  const Remap m = remap_of(bins[0], bins[1]);
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float x = noisy(u8_to_float(src[(int64_t)p * 3]), rk, (uint32_t)p);
    dst[(int64_t)p * 3] = remap_u8(x, m);
  }
}

// ---- the launch -----------------------------------------------------------

cudaLaunchAttribute cluster_of(int k) {
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = k;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

// the fewest blocks an image whose band fits in shared memory; 0 if none
int min_blocks(int64_t hw) {
  for (int k = 1; k <= kMaxCluster; ++k)
    if (cluster_bytes(hw, k) <= kSmemMax) return k;
  return 0;
}

// Blocks per image (the cluster size) for n images of hw pixels, or a
// negative cudaError_t: the k with the fewest pixels on the busiest SM over
// the waves, each wave
// as many images as clusters of k run at once
// (cudaOccupancyMaxActiveClusters: a cluster's blocks share a GPC, so
// fewer clusters of k run at once than 132 / k), the busiest SM running as
// many of its blocks as fit on one SM, a wave's fixed cost counted as
// kFixedPx pixels; ties to fewer blocks. The occupancy queries run once
// per device and image size, and set the kernel's attributes (shared
// memory, cluster sizes above 8).
int pick_blocks(int n, int64_t hw) {
  static std::mutex mu;
  static int key_dev = -1;
  static int64_t key_hw = -1;
  static int fits[kMaxCluster + 1];   // clusters of k blocks at once
  static int per_sm[kMaxCluster + 1]; // blocks of that size on one SM
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  std::lock_guard<std::mutex> lock(mu);
  if (key_dev != dev || key_hw != hw) {
    key_dev = -1;
    err = cudaFuncSetAttribute(distortion_cluster,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          distortion_cluster,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return -(int)err;
    for (int k = 1; k <= kMaxCluster; ++k) {
      fits[k] = per_sm[k] = 0;
      const int64_t bytes = cluster_bytes(hw, k);
      if (bytes > kSmemMax) continue;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm[k], distortion_cluster, kThreads, (size_t)bytes) !=
          cudaSuccess) {
        per_sm[k] = 0;
        cudaGetLastError();
        continue;
      }
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr = cluster_of(k);
      cfg.gridDim = dim3(k);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = (size_t)bytes;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&fits[k], distortion_cluster,
                                         &cfg) != cudaSuccess) {
        fits[k] = 0;
        cudaGetLastError();  // a size the card refuses is not an error
      }
    }
    key_dev = dev;
    key_hw = hw;
  }
  int best = 0;
  int64_t best_cost = -1;
  for (int k = 1; k <= kMaxCluster; ++k) {
    const int64_t cap = fits[k];
    if (cap <= 0 || per_sm[k] <= 0) continue;
    // a wave's busiest SM runs per_sm[k] blocks (a cluster's blocks are
    // packed onto as few SMs of their GPC as fit)
    const int64_t cost = (n + cap - 1) / cap *
                         (per_sm[k] * band_px(hw, k) + kFixedPx);
    if (best_cost < 0 || cost < best_cost) {
      best = k;
      best_cost = cost;
    }
  }
  return best > 0 ? best : -(int)cudaErrorInvalidConfiguration;
}

int launch_distortion(const uint8_t* in, const int64_t* seeds,
                      const float* cutoffs, uint8_t* out, int n, int64_t hw,
                      cudaStream_t s) {
  if (!min_blocks(hw)) {
    distortion_simple<<<n * 3, kSimpleThreads, 0, s>>>(in, seeds, cutoffs,
                                                       out, (int)hw);
    return (int)cudaGetLastError();
  }
  const int k = pick_blocks(n, hw);
  if (k < 0) return -k;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = cluster_of(k);
  cfg.gridDim = dim3(n * k);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)cluster_bytes(hw, k);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, distortion_cluster, in,
                                             seeds, cutoffs, out, (int)hw);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// h, w -> dynamic shared-memory bytes of a cluster block at the fewest
// blocks an image that fit (the most a block of the cluster kernel takes);
// 0 = the image does not fit at 16 blocks and the simple kernel runs
extern "C" int leaf_distortion_smem_bytes(int h, int w) {
  const int64_t hw = (int64_t)h * w;
  if (h <= 0 || w <= 0) return 0;
  const int k = min_blocks(hw);
  return k ? (int)cluster_bytes(hw, k) : 0;
}

// blocks per image (the cluster size) of the cluster kernel for n images
// of h x w; 0 when the simple kernel runs; a negative cudaError_t when no
// cluster size runs
extern "C" int leaf_distortion_blocks_per_image(int n, int h, int w) {
  const int64_t hw = (int64_t)h * w;
  if (n <= 0 || h <= 0 || w <= 0 || !min_blocks(hw)) return 0;
  return pick_blocks(n, hw);
}

// in, out: uint8 [n, h, w, 3]; seeds: int64 [n, 3], the low 32 bits of each
// the plane's seed; cutoffs: f32 [n]; all on device `device`. The cluster
// size is picked at launch (leaf_distortion_blocks_per_image). One launch;
// no scratch. Returns cudaGetLastError() after the launch.
extern "C" int leaf_distortion(const uint8_t* in, const int64_t* seeds,
                               const float* cutoffs, uint8_t* out, int n,
                               int h, int w, int device, void* stream) {
  const int64_t hw = (int64_t)h * w;
  if (n <= 0 || hw == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    return (cudaError_t)launch_distortion(in, seeds, cutoffs, out, n, hw,
                                          (cudaStream_t)stream);
  });
}
