// Device helpers shared by the kernels over tensors held channels-last,
// [rows, c] row-major: the BatchNorm kernels (batch_norm.cu) and the
// residual blocks' exit (block_exit.cu).
//
// A thread owns a fixed group of V channels (V = 8: one 16-byte access of
// bf16, two of f32; V = 1 when c % 8 != 0 or a pointer is not 16-byte
// aligned) and walks rows, so a warp reads whole contiguous rows. A block
// is kThreads threads: kThreads / (c / V) rows a pass, in tiles of at most
// kThreads groups along c (Tiling).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWaves = 4;       // blocks an SM, at most, along the rows
constexpr int kMinPasses = 8;   // passes a thread, at least, before more blocks
constexpr int kMaxDevices = 64;

template <typename T>
struct Tag {
  using type = T;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T, as a float
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_float(from_float<T>(v));
}

// V consecutive elements as they sit in memory (one or two 16-byte words
// for V = 8), unpacked to and packed from floats
template <typename T, int V>
struct Pack;

template <typename T>
struct Pack<T, 1> {
  T v;
  __device__ __forceinline__ void unpack(float* f) const { f[0] = to_float(v); }
  __device__ __forceinline__ void pack(const float* f) { v = from_float<T>(f[0]); }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  uint4 u;
  __device__ __forceinline__ void unpack(float* f) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 p = __bfloat1622float2(h[k]);
      f[2 * k] = p.x;
      f[2 * k + 1] = p.y;
    }
  }
  __device__ __forceinline__ void pack(const float* f) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  }
};

template <>
struct Pack<float, 8> {
  float4 a, b;
  __device__ __forceinline__ void unpack(float* f) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  __device__ __forceinline__ void pack(const float* f) {
    a = make_float4(f[0], f[1], f[2], f[3]);
    b = make_float4(f[4], f[5], f[6], f[7]);
  }
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* f) {
  Pack<T, V> w;
  w.pack(f);
  *reinterpret_cast<Pack<T, V>*>(p) = w;
}

struct Tiling {
  int groups;  // V-channel groups a row
  int tile;    // groups a block (along c)
  int rows;    // rows a pass of a block
};

__host__ __device__ inline Tiling tiling(int c, int vec) {
  Tiling s;
  s.groups = c / vec;
  s.tile = s.groups < kThreads ? s.groups : kThreads;
  s.rows = kThreads / s.tile;
  return s;
}

__host__ __device__ inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline int sm_count(int device) {
  static int cached[kMaxDevices] = {0};
  if (device >= 0 && device < kMaxDevices && cached[device])
    return cached[device];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return -1;
  if (device >= 0 && device < kMaxDevices) cached[device] = n;
  return n;
}

}  // namespace
