// One connected-components propagation round on int32 label images.
//
// Replaces the Pallas TPU kernel
// leaffliction_tpu/ops/pallas/components.py::propagate_round_pallas
// (_round_kernel). Same phases, in the same order, integer-only so the result
// is bit-exact with the plain PyTorch twin
// (leaffliction_tpu_torch/ops/kernels/components.py::cc_round_plain):
//
//   1. grown = 3x3 max of lab (zero beyond the image edge), masked;
//   2. rows: forward and backward inclusive max-scans of (seg_f1 | grown) and
//      (seg_b1 | grown), low label bits kept, max of both, masked;
//   3. columns: the same along axis 0 with seg_f0 / seg_b0.
//
// The segment planes hold a barrier count shifted above `label_bits`, so a
// plain prefix max restarts at every background pixel (see
// leaffliction_tpu/ops/components.py::_propagate).
//
// What bounds it on an H100: nothing but launch latency and the serial depth
// of the scans. At 224x224 a round reads and writes about 1.4 MB per image,
// a few microseconds of HBM time at 3.35 TB/s. The design therefore keeps each
// phase a single simple pass: one thread per pixel for the stencil; one warp
// per row for the row scans (32-lane shuffle scans carrying the running max
// from chunk to chunk, coalesced loads); one thread per column walking down
// the rows for the column scans (neighbouring threads read neighbouring
// addresses, so every row step is one coalesced load per warp). Three launches
// per round on the caller's stream; no allocation, no synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void grow3x3(const int32_t* __restrict__ lab,
                        const uint8_t* __restrict__ mask,
                        int32_t* __restrict__ out, int n, int h, int w) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t total = (int64_t)n * h * w;
  if (idx >= total) return;
  int x = (int)(idx % w);
  int y = (int)((idx / w) % h);
  int64_t base = idx - (int64_t)y * w - x;  // start of this image
  int32_t m = 0;
  for (int dy = -1; dy <= 1; ++dy) {
    int yy = y + dy;
    if (yy < 0 || yy >= h) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      int xx = x + dx;
      if (xx < 0 || xx >= w) continue;
      int32_t v = lab[base + (int64_t)yy * w + xx];
      m = v > m ? v : m;
    }
  }
  out[idx] = mask[idx] ? m : 0;
}

// One warp per row: forward then backward segmented max-scan.
__global__ void row_scans(const int32_t* __restrict__ lab,
                          const uint8_t* __restrict__ mask,
                          const int32_t* __restrict__ seg_f,
                          const int32_t* __restrict__ seg_b,
                          int32_t* __restrict__ out, int n, int h, int w,
                          int32_t low) {
  const unsigned full = 0xffffffffu;
  int lane = threadIdx.x & 31;
  int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= (int64_t)n * h) return;  // whole warp leaves together
  int64_t base = row * w;

  int32_t carry = 0;
  for (int start = 0; start < w; start += 32) {
    int i = start + lane;
    int32_t v = i < w ? (seg_f[base + i] | lab[base + i]) : 0;
    for (int off = 1; off < 32; off <<= 1) {
      int32_t t = __shfl_up_sync(full, v, off);
      if (lane >= off) v = t > v ? t : v;
    }
    v = carry > v ? carry : v;
    if (i < w) out[base + i] = v & low;
    carry = __shfl_sync(full, v, 31);
  }

  carry = 0;
  for (int start = ((w - 1) / 32) * 32; start >= 0; start -= 32) {
    int i = start + lane;
    int32_t v = i < w ? (seg_b[base + i] | lab[base + i]) : 0;
    for (int off = 1; off < 32; off <<= 1) {
      int32_t t = __shfl_down_sync(full, v, off);
      if (lane + off < 32) v = t > v ? t : v;
    }
    v = carry > v ? carry : v;
    if (i < w) {
      int32_t f = out[base + i];
      int32_t b = v & low;
      out[base + i] = mask[base + i] ? (f > b ? f : b) : 0;
    }
    carry = __shfl_sync(full, v, 0);
  }
}

// One thread per (image, column): forward walk down, backward walk up.
__global__ void col_scans(const int32_t* __restrict__ lab,
                          const uint8_t* __restrict__ mask,
                          const int32_t* __restrict__ seg_f,
                          const int32_t* __restrict__ seg_b,
                          int32_t* __restrict__ out, int n, int h, int w,
                          int32_t low) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)n * w) return;
  int x = (int)(t % w);
  int64_t base = (t / w) * h * w + x;

  int32_t carry = 0;
  for (int y = 0; y < h; ++y) {
    int64_t i = base + (int64_t)y * w;
    int32_t v = seg_f[i] | lab[i];
    carry = v > carry ? v : carry;
    out[i] = carry & low;
  }
  carry = 0;
  for (int y = h - 1; y >= 0; --y) {
    int64_t i = base + (int64_t)y * w;
    int32_t v = seg_b[i] | lab[i];
    carry = v > carry ? v : carry;
    int32_t f = out[i];
    int32_t b = carry & low;
    out[i] = mask[i] ? (f > b ? f : b) : 0;
  }
}

}  // namespace

// lab, seg planes, grown, rows, out: int32 [n, h, w] contiguous; mask: uint8
// [n, h, w] (0 = background). grown and rows are scratch of the same shape.
// Returns cudaGetLastError() after the three launches.
extern "C" int leaf_cc_round(const int32_t* lab, const uint8_t* mask,
                             const int32_t* seg_f0, const int32_t* seg_b0,
                             const int32_t* seg_f1, const int32_t* seg_b1,
                             int32_t* grown, int32_t* rows, int32_t* out,
                             int n, int h, int w, int label_bits,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int32_t low = (int32_t)((1u << label_bits) - 1u);
  const int threads = 256;

  int64_t pixels = (int64_t)n * h * w;
  if (pixels == 0) return (int)cudaSuccess;
  grow3x3<<<(unsigned)((pixels + threads - 1) / threads), threads, 0, s>>>(
      lab, mask, grown, n, h, w);

  int64_t row_threads = (int64_t)n * h * 32;
  row_scans<<<(unsigned)((row_threads + threads - 1) / threads), threads, 0,
              s>>>(grown, mask, seg_f1, seg_b1, rows, n, h, w, low);

  int64_t cols = (int64_t)n * w;
  col_scans<<<(unsigned)((cols + threads - 1) / threads), threads, 0, s>>>(
      rows, mask, seg_f0, seg_b0, out, n, h, w, low);
  return (int)cudaGetLastError();
}
