// Connected-components label propagation to its fixpoint, one launch.
//
// Replaces the Pallas TPU kernel
// leaffliction_tpu/ops/pallas/components.py::propagate_round_pallas
// (_round_kernel) together with the convergence loop around it
// (leaffliction_tpu/ops/components.py::_propagate, a lax.while_loop). The
// result is bit-exact with the plain PyTorch twin
// (leaffliction_tpu_torch/ops/kernels/components.py::cc_propagate_plain), a
// host loop over the round as the Pallas kernel orders it:
//
//   1. grown = 3x3 max of lab (zero beyond the image edge), masked;
//   2. rows: forward and backward segmented max-scans of grown, restarting at
//      every background pixel; max of both, masked;
//   3. columns: the same along axis 0.
//
// Rounds are Jacobi rounds (each reads only the previous round's labels). The
// loop stops after the first round that changes nothing, or after 1 + limit
// rounds, so labels and round counts equal the host loop's. Labels are in
// [0, h*w], as the component functions seed them.
//
// The forward and backward inclusive scans of one run of foreground pixels
// together cover the whole run, so their max is the run's max. Phase 2 is
// therefore a forward segmented scan followed by a backward one over its
// (non-decreasing) output, and phase 3 the same down each column. The mask
// restarts the scans directly: no segment planes, any h*w < 2^31 in int32.
//
// What bounds it on an H100: latency and serial depth, not bytes. At
// [1,224,224] one call reads 0.25 MB and writes 0.2 MB, 0.13 us at 3.35 TB/s,
// while every round is three dependent phases and a row or column scan is a
// chain of w or h dependent maxima, twice. The design removes what the host
// loop added around that depth (three launches, segment planes, allocations
// and a host synchronisation per round) and keeps each round's chains short
// of memory latency. One block of 1,024 threads per image runs every round;
// __syncthreads separates the phases and __syncthreads_or decides whether
// the round changed anything. Two kernels:
//
// - cc_smem_kernel, for h*w <= 65534 when its planes fit the 227 KB of shared
//   memory (224^2: 205 KB): the whole image lives in shared memory as 16-bit
//   labels. The labels L sit in a zero frame (so the 3x3 max reads no
//   bounds), the row plane R holds 0xFFFF on the background (the column phase
//   reads no mask), and the mask is one bit per pixel. A round is one thread
//   per row, walking the row once forward (a sliding window of column maxima
//   gives the 3x3 max, then the running max) and once backward, then one
//   thread per column, down and up, each walk issuing the shared-memory loads
//   of eight pixels before their chain of maxima. The planes' row stride is
//   an odd number of 32-bit words, so the 32 rows a warp walks side by side
//   fall in 32 different banks.
// - cc_global_kernel, for larger images: the labels stay in the output
//   buffer (L2 resident) and the row phase writes a global scratch plane. A
//   warp per row computes the 3x3 max on the fly and scans with 32-lane
//   shuffles, carrying the running max from chunk to chunk; one thread per
//   column then scans, its loads issued eight rows ahead of the max chain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kSmemMax = 232448;  // Hopper's opt-in shared memory per block
constexpr int kAhead = 8;         // loads a scanning thread issues ahead
constexpr uint16_t kBg = 0xFFFF;  // background in the row plane R

__device__ __forceinline__ int32_t imax(int32_t a, int32_t b) {
  return a > b ? a : b;
}

// ---- the shared-memory kernel ------------------------------------------

struct SmemLayout {
  int stride;      // row stride of L and R, in 16-bit labels
  int mask_words;  // row stride of the mask bit plane, in 32-bit words
  int bytes;       // 0 when the image does not fit
};

__host__ __device__ inline SmemLayout smem_layout(int h, int w) {
  SmemLayout s;
  // w + 2 for the zero frame, rounded up to an odd number of words
  s.stride = ((w + 2 + 1) / 2) | 1;
  s.stride *= 2;
  s.mask_words = ((w + 31) / 32) | 1;
  int64_t bytes = (int64_t)(h + 2) * s.stride * 2  // L, framed
                  + (int64_t)h * s.stride * 2      // R
                  + (int64_t)h * s.mask_words * 4; // mask bits
  s.bytes = ((int64_t)h * w <= 65534 && bytes <= kSmemMax) ? (int)bytes : 0;
  return s;
}

__device__ __forceinline__ bool mask_bit(const uint32_t* m, int x) {
  return (m[x >> 5] >> (x & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
    cc_smem_kernel(const int32_t* __restrict__ lab_in,
                   const uint8_t* __restrict__ mask,
                   int32_t* __restrict__ lab_out,
                   int32_t* __restrict__ rounds_out, int h, int w,
                   int limit) {
  extern __shared__ uint32_t smem_words[];
  const SmemLayout s = smem_layout(h, w);
  const int st = s.stride;
  uint16_t* L = reinterpret_cast<uint16_t*>(smem_words);
  uint16_t* R = L + (h + 2) * st;
  uint32_t* M = reinterpret_cast<uint32_t*>(R + h * st);
  const int64_t base = (int64_t)blockIdx.x * h * w;

  // load: the zero frame, the labels inside it, the mask bits
  for (int i = threadIdx.x; i < (h + 2) * st; i += kThreads) L[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < h * w; i += kThreads) {
    int y = i / w, x = i - y * w;
    L[(y + 1) * st + x + 1] = (uint16_t)lab_in[base + i];
  }
  for (int i = threadIdx.x; i < h * s.mask_words; i += kThreads) {
    int y = i / s.mask_words, x0 = (i - y * s.mask_words) * 32;
    const uint8_t* m = mask + base + (int64_t)y * w;
    uint32_t bits = 0;
    for (int k = 0; k < 32 && x0 + k < w; ++k)
      bits |= (uint32_t)(m[x0 + k] != 0) << k;
    M[i] = bits;
  }
  __syncthreads();

  int rounds = 0;
  while (true) {
    // phases 1 and 2, one thread per row: R = the max of the masked 3x3
    // max over the row's run holding each pixel, kBg on the background
    for (int y = threadIdx.x; y < h; y += kThreads) {
      const uint16_t* __restrict__ a = L + y * st;  // rows y-1, y, y+1
      const uint16_t* __restrict__ b = a + st;      // (framed, x + 1)
      const uint16_t* __restrict__ c = b + st;
      const uint32_t* __restrict__ m = M + y * s.mask_words;
      uint16_t* __restrict__ r = R + y * st;
      int32_t prev = 0;
      int32_t cur = imax(imax(a[1], b[1]), c[1]);
      int32_t run = 0;
      // forward, kAhead pixels at a time: their loads first, then the chain
      auto fwd = [&](int32_t next, bool fg) {
        run = fg ? imax(run, imax(imax(prev, cur), next)) : 0;
        prev = cur;
        cur = next;
        return fg ? (uint16_t)run : kBg;
      };
      int x = 0;
      for (; x + kAhead <= w; x += kAhead) {
        int32_t next[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k)
          next[k] = imax(imax(a[x + k + 2], b[x + k + 2]), c[x + k + 2]);
        uint32_t bits = m[x >> 5] >> (x & 31);  // kAhead divides 32
        uint16_t out[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k)
          out[k] = fwd(next[k], (bits >> k) & 1u);
#pragma unroll
        for (int k = 0; k < kAhead; ++k) r[x + k] = out[k];
      }
      for (; x < w; ++x)
        r[x] = fwd(imax(imax(a[x + 2], b[x + 2]), c[x + 2]), mask_bit(m, x));
      // backward over the forward maxima
      run = 0;
      x = w;
      for (; x >= kAhead; x -= kAhead) {
        uint16_t v[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) v[k] = r[x - 1 - k];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          run = v[k] == kBg ? 0 : imax(run, v[k]);
          if (v[k] != kBg) v[k] = (uint16_t)run;
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k) r[x - 1 - k] = v[k];
      }
      for (; x > 0; --x) {
        uint16_t v = r[x - 1];
        run = v == kBg ? 0 : imax(run, v);
        if (v != kBg) r[x - 1] = (uint16_t)run;
      }
    }
    __syncthreads();

    // phase 3, one thread per column: L = the max of R over the column's
    // run holding each pixel, 0 on the background
    bool changed = false;
    for (int x = threadIdx.x; x < w; x += kThreads) {
      uint16_t* __restrict__ col = R + x;
      uint16_t* __restrict__ lab = L + st + x + 1;
      int32_t run = 0;
      int y = 0;
      for (; y + kAhead <= h; y += kAhead) {
        uint16_t v[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) v[k] = col[(y + k) * st];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          run = v[k] == kBg ? 0 : imax(run, v[k]);
          if (v[k] != kBg) v[k] = (uint16_t)run;
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k) col[(y + k) * st] = v[k];
      }
      for (; y < h; ++y) {
        uint16_t v = col[y * st];
        run = v == kBg ? 0 : imax(run, v);
        if (v != kBg) col[y * st] = (uint16_t)run;
      }
      run = 0;
      y = h;
      for (; y >= kAhead; y -= kAhead) {
        uint16_t v[kAhead], old[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          v[k] = col[(y - 1 - k) * st];
          old[k] = lab[(y - 1 - k) * st];
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          run = v[k] == kBg ? 0 : imax(run, v[k]);
          changed |= old[k] != (uint16_t)run;
          old[k] = (uint16_t)run;
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k) lab[(y - 1 - k) * st] = old[k];
      }
      for (; y > 0; --y) {
        uint16_t v = col[(y - 1) * st];
        run = v == kBg ? 0 : imax(run, v);
        changed |= lab[(y - 1) * st] != (uint16_t)run;
        lab[(y - 1) * st] = (uint16_t)run;
      }
    }
    ++rounds;
    if (!__syncthreads_or(changed) || rounds > limit) break;
  }

  for (int i = threadIdx.x; i < h * w; i += kThreads) {
    int y = i / w, x = i - y * w;
    lab_out[base + i] = L[(y + 1) * st + x + 1];
  }
  if (threadIdx.x == 0) rounds_out[blockIdx.x] = rounds;
}

// ---- the global-memory kernel -------------------------------------------

// 3x3 max of lab around (y, x), zero beyond the image edge.
__device__ __forceinline__ int32_t max3x3(const int32_t* lab, int y, int x,
                                          int h, int w) {
  int32_t m = 0;
  for (int dy = -1; dy <= 1; ++dy) {
    int yy = y + dy;
    if (yy < 0 || yy >= h) continue;
    const int32_t* row = lab + (int64_t)yy * w;
    if (x > 0) m = imax(m, row[x - 1]);
    m = imax(m, row[x]);
    if (x + 1 < w) m = imax(m, row[x + 1]);
  }
  return m;
}

// Phases 1 and 2, one warp per row: rows[y, x] = the max of the masked 3x3
// max over the horizontal run of foreground pixels holding (y, x), 0 on the
// background.
__device__ void row_phase(const int32_t* lab,
                          const uint8_t* __restrict__ mask, int32_t* rows,
                          int h, int w) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned at_or_below = full >> (31 - lane);
  const unsigned at_or_above = full << lane;
  for (int y = threadIdx.x >> 5; y < h; y += kThreads / 32) {
    const uint8_t* m = mask + (int64_t)y * w;
    int32_t* r = rows + (int64_t)y * w;

    // forward: running max since the last background pixel
    int32_t carry = 0;
    for (int x0 = 0; x0 < w; x0 += 32) {
      int x = x0 + lane;
      bool fg = x < w && __ldg(m + x);
      int32_t v = fg ? max3x3(lab, y, x, h, w) : 0;
      unsigned bar = __ballot_sync(full, !fg) & at_or_below;
      int start = bar ? 31 - __clz(bar) : -1;  // last barrier <= lane
      for (int off = 1; off < 32; off <<= 1) {
        int32_t t = __shfl_up_sync(full, v, off);
        if (lane - off >= start) v = imax(v, t);
      }
      if (start < 0) v = imax(v, carry);
      if (x < w) r[x] = v;
      carry = __shfl_sync(full, v, 31);
    }

    // backward over the forward maxima: each run's last one is its max
    carry = 0;
    for (int x0 = ((w - 1) >> 5) << 5; x0 >= 0; x0 -= 32) {
      int x = x0 + lane;
      bool fg = x < w && __ldg(m + x);
      int32_t v = fg ? r[x] : 0;
      unsigned bar = __ballot_sync(full, !fg) & at_or_above;
      int end = bar ? __ffs(bar) - 1 : 32;  // first barrier >= lane
      for (int off = 1; off < 32; off <<= 1) {
        int32_t t = __shfl_down_sync(full, v, off);
        if (lane + off <= end) v = imax(v, t);
      }
      if (end == 32) v = imax(v, carry);
      if (x < w) r[x] = v;
      carry = __shfl_sync(full, v, 0);
    }
  }
}

// Phase 3, one thread per column: lab[y, x] = the max of rows over the
// vertical run holding (y, x), 0 on the background. `rows` is overwritten
// with the forward running maxima. Returns whether any label changed.
__device__ bool col_phase(int32_t* rows, const uint8_t* __restrict__ mask,
                          int32_t* lab, int h, int w) {
  bool changed = false;
  for (int x = threadIdx.x; x < w; x += kThreads) {
    int32_t carry = 0;
    int y = 0;
    for (; y + kAhead <= h; y += kAhead) {
      int32_t v[kAhead];
      bool fg[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        int64_t i = (int64_t)(y + k) * w + x;
        v[k] = rows[i];
        fg[k] = __ldg(mask + i);
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        carry = fg[k] ? imax(carry, v[k]) : 0;
        rows[(int64_t)(y + k) * w + x] = carry;
      }
    }
    for (; y < h; ++y) {
      int64_t i = (int64_t)y * w + x;
      carry = __ldg(mask + i) ? imax(carry, rows[i]) : 0;
      rows[i] = carry;
    }

    carry = 0;
    y = h;
    for (; y >= kAhead; y -= kAhead) {
      int32_t v[kAhead], old[kAhead];
      bool fg[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        int64_t i = (int64_t)(y - 1 - k) * w + x;
        v[k] = rows[i];
        old[k] = lab[i];
        fg[k] = __ldg(mask + i);
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        carry = fg[k] ? imax(carry, v[k]) : 0;
        changed |= carry != old[k];
        lab[(int64_t)(y - 1 - k) * w + x] = carry;
      }
    }
    for (; y > 0; --y) {
      int64_t i = (int64_t)(y - 1) * w + x;
      carry = __ldg(mask + i) ? imax(carry, rows[i]) : 0;
      changed |= carry != lab[i];
      lab[i] = carry;
    }
  }
  return changed;
}

// One block per image; scratch is an int32 [n, h, w] row plane.
__global__ void __launch_bounds__(kThreads)
    cc_global_kernel(const int32_t* __restrict__ lab_in,
                     const uint8_t* __restrict__ mask, int32_t* lab_out,
                     int32_t* scratch, int32_t* __restrict__ rounds_out,
                     int h, int w, int limit) {
  const int64_t hw = (int64_t)h * w;
  const int64_t base = (int64_t)blockIdx.x * hw;
  const uint8_t* m = mask + base;
  int32_t* lab = lab_out + base;
  int32_t* rows = scratch + base;

  for (int64_t i = threadIdx.x; i < hw; i += kThreads) lab[i] = lab_in[base + i];
  __syncthreads();

  int rounds = 0;
  while (true) {
    row_phase(lab, m, rows, h, w);
    __syncthreads();
    bool changed = col_phase(rows, m, lab, h, w);
    ++rounds;
    if (!__syncthreads_or(changed) || rounds > limit) break;
  }
  if (threadIdx.x == 0) rounds_out[blockIdx.x] = rounds;
}

}  // namespace

// Shared memory the fast kernel takes for an h x w image, or 0 when the
// global kernel runs it (and needs a scratch plane).
extern "C" int leaf_cc_propagate_smem_bytes(int h, int w) {
  return smem_layout(h, w).bytes;
}

// lab, out: int32 [n, h, w] contiguous, labels in [0, h*w]; mask: uint8
// [n, h, w] (0 = background); rounds: int32 [n]. scratch: int32 [n, h, w]
// when leaf_cc_propagate_smem_bytes(h, w) is 0, else unused (may be null).
// At most 1 + limit rounds per image. All on device `device`. Returns
// cudaGetLastError() after the launch, or the error of the shared-memory
// request.
extern "C" int leaf_cc_propagate(const int32_t* lab, const uint8_t* mask,
                                 int32_t* out, int32_t* scratch,
                                 int32_t* rounds, int n, int h, int w,
                                 int limit, int device, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int smem = smem_layout(h, w).bytes;
  if (!smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    if (smem) {
      const cudaError_t err = cudaFuncSetAttribute(
          cc_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      cc_smem_kernel<<<n, kThreads, smem, st>>>(lab, mask, out, rounds, h, w,
                                                limit);
    } else {
      cc_global_kernel<<<n, kThreads, 0, st>>>(lab, mask, out, scratch,
                                               rounds, h, w, limit);
    }
    return cudaGetLastError();
  });
}
