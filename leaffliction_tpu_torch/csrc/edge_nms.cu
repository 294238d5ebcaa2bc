// Canny front end: 5x5 Gaussian blur, Sobel 3x3, L1 or L2 magnitude and
// 4-sector non-maximum suppression, f32 [n, h, w] -> f32 [n, h, w].
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
// operation: each separable pass sums its taps in the same order, one rounded
// multiply and one rounded add per tap. The library is compiled with
// -fmad=false so no multiply-add is contracted, and the result is then
// bit-equal to the twin, so NMS ties cannot flip between the two.
//
// What bounds it on an H100: memory traffic and launch latency. A 224x224
// image is 200 KB of f32; three passes read and write about 1.2 MB per image,
// well under a microsecond of HBM time each at 3.35 TB/s, so the cost is
// three launches plus L2-resident stencil reads. Simple one-thread-per-pixel
// passes through scratch buffers (blur; magnitude and sector; NMS) keep the
// code short; fusing them with shared-memory halos is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int reflect101(int i, int n) {
  // cv2 BORDER_REFLECT_101 for offsets of at most 2 beyond the edge (n >= 3)
  if (i < 0) return -i;
  if (i >= n) return 2 * n - 2 - i;
  return i;
}

__device__ __forceinline__ int wrap(int i, int n) {
  if (i < 0) return i + n;
  if (i >= n) return i - n;
  return i;
}

struct Taps5 {
  float k[5];
};

// blur[y, x] = sum_s k[s] * (sum_t k[t] * g[y + t - 2, x + s - 2]):
// the vertical pass first, then the horizontal pass, as the twin does.
__global__ void gauss5(const float* __restrict__ g, float* __restrict__ out,
                       int n, int h, int w, Taps5 taps) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * h * w) return;
  int x = (int)(idx % w);
  int y = (int)((idx / w) % h);
  const float* img = g + (idx - (int64_t)y * w - x);
  float acc = 0.0f;
  for (int s = 0; s < 5; ++s) {
    int xx = reflect101(x + s - 2, w);
    float col = taps.k[0] * img[(int64_t)reflect101(y - 2, h) * w + xx];
    for (int t = 1; t < 5; ++t)
      col = col + taps.k[t] * img[(int64_t)reflect101(y + t - 2, h) * w + xx];
    acc = s == 0 ? taps.k[0] * col : acc + taps.k[s] * col;
  }
  out[idx] = acc;
}

// Sobel gx (vertical [1,2,1], horizontal [-1,0,1]) and gy (vertical
// [-1,0,1], horizontal [1,2,1]) → magnitude and gradient sector.
__global__ void sobel_mag(const float* __restrict__ b, float* __restrict__ mag,
                          uint8_t* __restrict__ sector, int n, int h, int w,
                          int l2) {
  const float smooth[3] = {1.0f, 2.0f, 1.0f};
  const float diff[3] = {-1.0f, 0.0f, 1.0f};
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * h * w) return;
  int x = (int)(idx % w);
  int y = (int)((idx / w) % h);
  const float* img = b + (idx - (int64_t)y * w - x);
  float gx = 0.0f, gy = 0.0f;
  for (int s = 0; s < 3; ++s) {
    int xx = reflect101(x + s - 1, w);
    float vs = smooth[0] * img[(int64_t)reflect101(y - 1, h) * w + xx];
    float vd = diff[0] * img[(int64_t)reflect101(y - 1, h) * w + xx];
    for (int t = 1; t < 3; ++t) {
      float v = img[(int64_t)reflect101(y + t - 1, h) * w + xx];
      vs = vs + smooth[t] * v;
      vd = vd + diff[t] * v;
    }
    gx = s == 0 ? diff[0] * vs : gx + diff[s] * vs;
    gy = s == 0 ? smooth[0] * vd : gy + smooth[s] * vd;
  }
  float ax = fabsf(gx), ay = fabsf(gy);
  float m = l2 ? sqrtf(gx * gx + gy * gy) : ax + ay;
  uint8_t sec;
  if (ay <= 0.41421356f * ax) sec = 0;        // ~horizontal gradient
  else if (ay > 2.41421356f * ax) sec = 2;    // ~vertical
  else sec = (gx * gy) >= 0.0f ? 1 : 3;       // diagonals
  mag[idx] = m;
  sector[idx] = sec;
}

__global__ void nms(const float* __restrict__ mag,
                    const uint8_t* __restrict__ sector,
                    float* __restrict__ out, int n, int h, int w) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * h * w) return;
  int x = (int)(idx % w);
  int y = (int)((idx / w) % h);
  const float* img = mag + (idx - (int64_t)y * w - x);
  int ay, ax, by, bx;  // the two neighbours along the gradient (wrapped)
  switch (sector[idx]) {
    case 0: ay = y; ax = x - 1; by = y; bx = x + 1; break;
    case 1: ay = y + 1; ax = x - 1; by = y - 1; bx = x + 1; break;
    case 2: ay = y - 1; ax = x; by = y + 1; bx = x; break;
    default: ay = y - 1; ax = x - 1; by = y + 1; bx = x + 1; break;
  }
  float m = mag[idx];
  float na = img[(int64_t)wrap(ay, h) * w + wrap(ax, w)];
  float nb = img[(int64_t)wrap(by, h) * w + wrap(bx, w)];
  out[idx] = (m >= na && m >= nb) ? m : 0.0f;
}

}  // namespace

// gray, blur, mag, out: f32 [n, h, w] contiguous; sector: uint8 [n, h, w].
// blur, mag and sector are scratch. g0..g4 are the Gaussian taps. h, w >= 3.
// Returns cudaGetLastError() after the three launches.
extern "C" int leaf_edge_nms(const float* gray, float* blur, float* mag,
                             uint8_t* sector, float* out, int n, int h, int w,
                             int l2, float g0, float g1, float g2, float g3,
                             float g4, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int64_t pixels = (int64_t)n * h * w;
  if (pixels == 0) return (int)cudaSuccess;
  const int threads = 256;
  unsigned blocks = (unsigned)((pixels + threads - 1) / threads);
  Taps5 taps = {{g0, g1, g2, g3, g4}};
  gauss5<<<blocks, threads, 0, s>>>(gray, blur, n, h, w, taps);
  sobel_mag<<<blocks, threads, 0, s>>>(blur, mag, sector, n, h, w, l2);
  nms<<<blocks, threads, 0, s>>>(mag, sector, out, n, h, w);
  return (int)cudaGetLastError();
}
