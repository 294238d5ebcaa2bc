// BatchNorm (+ReLU) with flax's numerics, training and eval, over a tensor
// held channels-last: [rows, c] row-major, rows = n * (h * w), the layout
// the models' convolutions hand over. The wrapper copies any other layout
// it takes into this one (ops/kernels/batch_norm.py).
//
// Replaces no Pallas kernel: the JAX package's training BatchNorm is the
// custom-VJP op leaffliction_tpu/ops/fused_bn.py::bn_train, which XLA fuses
// on the TPU. The plain twin is leaffliction_tpu_torch/ops/fused_bn.py
// (_BNTrain and the eval arithmetic of BatchNorm.forward).
//
// The arithmetic is the twin's, per channel and per element:
//   Σx, Σx² in f32; mean = Σx / M; var = max(Σx²/M - mean², 0);
//   inv = 1 / sqrt(var + eps); mul = inv · γ;
//   y = T((x - mean) · mul + β), then ReLU (a value <= 0 gives 0) where the
//   model applies one right after the BatchNorm;
//   running: m · ra + (1 - m) · batch;
//   backward: dy' = dy where the ReLU kept its value (threshold_backward's
//   mask, rebuilt from the same arithmetic as y, so y is not saved);
//   x̂ = (x - mean) · inv; Σdy', Σdy'·x̂;
//   dx = T(γ·inv · ((dy' - Σdy'/M) - x̂ · Σdy'x̂/M)).
// The library is built with -fmad=false, so every element's arithmetic is
// the twin's to the bit; only the f32 sums are taken in another order.
//
// What bounds it on an H100: bytes. Each pass reads its inputs once and
// writes its output once (x read twice forward, dy and x twice backward),
// at 3.35 TB/s; the arithmetic is a few operations a value.
//   - Each thread owns a fixed group of V channels (V = 8: one 16-byte
//     access of bf16, two of f32; V = 1 when c % 8 != 0 or a pointer is not
//     16-byte aligned) and walks the rows with a stride, so a warp reads
//     whole contiguous rows; its coefficients stay in registers. A block is
//     256 threads: 256 / (c / V) rows a pass (tiles of 256 groups along c
//     beyond that).
//   - The grid along the rows comes from the shape alone (row_blocks): at
//     least 8 passes a thread, at most 4 blocks an SM, so the late 7² layers
//     fill the card too.
//   - Reductions are deterministic: each thread sums its rows in order, each
//     block sums its threads in a fixed tree and writes its partials
//     [block][2][c]; bn_finalize sums the partials in a fixed order. No
//     atomics: two calls on the same inputs give the same bits.
//   - Nothing is allocated or synchronised here: the wrapper allocates
//     outputs and partials, and every launch takes the caller's stream, so
//     the calls are captured by CUDA graphs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "channels_last.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kFinLanes = 32;   // bn_finalize: channels a block
constexpr int kFinSlices = 8;   // bn_finalize: threads a channel

// What every kernel of a call reads per channel: f32 [c] each.
struct Params {
  const float* mean;
  const float* var;
  const float* scale;
  const float* bias;
  const float* sums;  // dx: Σdy' then Σdy'·x̂ over the batch, [2][c]
  float eps;
  float count;        // M, the rows of the batch (all ranks' with a group)
  int c;
};

// A channel's coefficients, derived the same way by every kernel, so the
// backward rebuilds the forward's values bit for bit
struct Coef {
  float mean, inv, mul, bias;
};

__device__ __forceinline__ Coef coef_of(const Params& p, int ch) {
  Coef k;
  k.mean = p.mean[ch];
  k.inv = 1.0f / sqrtf(p.var[ch] + p.eps);
  k.mul = k.inv * p.scale[ch];
  k.bias = p.bias[ch];
  return k;
}

__device__ __forceinline__ float affine(float x, const Coef& k) {
  return (x - k.mean) * k.mul + k.bias;
}

// the output value in T: rounded, then the ReLU of `torch.relu`
template <typename T, bool RELU>
__device__ __forceinline__ float out_value(float z) {
  const float r = to_float(from_float<T>(z));
  return (RELU && r <= 0.0f) ? 0.0f : r;
}

// dy where the forward's ReLU kept its value (threshold_backward: a zero
// where the output is <= 0)
template <typename T, bool RELU>
__device__ __forceinline__ float kept(float dy, float x, const Coef& k) {
  if (!RELU) return dy;
  return to_float(from_float<T>(affine(x, k))) <= 0.0f ? 0.0f : dy;
}

// ---- the per-element work of each kernel ---------------------------------

struct StatsOp {  // Σx, Σx²
  static constexpr bool kTwo = false;
  struct Chan {};
  __device__ __forceinline__ Chan chan(const Params&, int) const { return {}; }
  __device__ __forceinline__ void add(const Chan&, float x, float, float& a,
                                      float& b) const {
    a += x;
    b += x * x;
  }
};

template <typename T, bool RELU>
struct GradOp {  // Σdy', Σdy'·x̂
  static constexpr bool kTwo = true;
  using Chan = Coef;
  __device__ __forceinline__ Chan chan(const Params& p, int ch) const {
    return coef_of(p, ch);
  }
  __device__ __forceinline__ void add(const Coef& k, float x, float dy,
                                      float& a, float& b) const {
    const float d = kept<T, RELU>(dy, x, k);
    a += d;
    b += d * ((x - k.mean) * k.inv);
  }
};

template <typename T, bool RELU>
struct ApplyOp {  // y
  static constexpr bool kTwo = false;
  using Chan = Coef;
  __device__ __forceinline__ Chan chan(const Params& p, int ch) const {
    return coef_of(p, ch);
  }
  __device__ __forceinline__ float map(const Coef& k, float x, float) const {
    return out_value<T, RELU>(affine(x, k));
  }
};

template <typename T, bool RELU>
struct DxOp {  // dx
  static constexpr bool kTwo = true;
  struct Chan {
    Coef k;
    float gain, db, dg;  // γ·inv, Σdy'/M, Σdy'x̂/M
  };
  __device__ __forceinline__ Chan chan(const Params& p, int ch) const {
    Chan c;
    c.k = coef_of(p, ch);
    c.gain = p.scale[ch] * c.k.inv;
    c.db = p.sums[ch] / p.count;
    c.dg = p.sums[p.c + ch] / p.count;
    return c;
  }
  __device__ __forceinline__ float map(const Chan& c, float x, float dy) const {
    const float d = kept<T, RELU>(dy, x, c.k);
    const float xh = (x - c.k.mean) * c.k.inv;
    return c.gain * ((d - c.db) - xh * c.dg);
  }
};

// ---- the kernels: [rows, c] ----------------------------------------------

// Unrolled loads a thread keeps in flight: four passes with one input, two
// with two (registers)
#define BN_UNROLL(Op) ((Op::kTwo) ? 2 : 4)

// Each thread's V channels summed over its rows, in row order, then the
// block's rows in a fixed tree; partials[blockIdx.x][2][c].
template <typename T, int V, class Op>
__global__ void __launch_bounds__(kThreads)
    bn_reduce(const T* __restrict__ x, const T* __restrict__ dy, Op op,
                 Params p, float* __restrict__ partials, int64_t m) {
  constexpr int U = BN_UNROLL(Op);
  const Tiling s = tiling(p.c, V);
  const int tid = threadIdx.x, col = tid % s.tile, r = tid / s.tile;
  const int group = blockIdx.y * s.tile + col;
  const bool active = r < s.rows && group < s.groups;
  float a[V], b[V];
#pragma unroll
  for (int v = 0; v < V; ++v) a[v] = b[v] = 0.0f;
  if (active) {
    typename Op::Chan k[V];
#pragma unroll
    for (int v = 0; v < V; ++v) k[v] = op.chan(p, group * V + v);
    const int64_t step = (int64_t)gridDim.x * s.rows;
    const T* xs = x + group * V;
    const T* ds = dy + group * V;
    int64_t row = (int64_t)blockIdx.x * s.rows + r;
    auto add = [&](const Pack<T, V>& px, const Pack<T, V>& pd) {
      float xv[V], dv[V];
      px.unpack(xv);
      if (Op::kTwo) pd.unpack(dv);
#pragma unroll
      for (int v = 0; v < V; ++v) op.add(k[v], xv[v], Op::kTwo ? dv[v] : 0.0f, a[v], b[v]);
    };
    for (; row + (U - 1) * step < m; row += U * step) {
      Pack<T, V> px[U], pd[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        px[u] = load<T, V>(xs + (row + u * step) * p.c);
        if (Op::kTwo) pd[u] = load<T, V>(ds + (row + u * step) * p.c);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) add(px[u], pd[u]);
    }
    for (; row < m; row += step) {
      Pack<T, V> px = load<T, V>(xs + row * p.c), pd = px;
      if (Op::kTwo) pd = load<T, V>(ds + row * p.c);
      add(px, pd);
    }
  }
  __shared__ float sa[kThreads * V], sb[kThreads * V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    sa[tid * V + v] = a[v];
    sb[tid * V + v] = b[v];
  }
  __syncthreads();
  for (int half = pow2_at_least(s.rows) / 2; half > 0; half >>= 1) {
    if (active && r < half && r + half < s.rows) {
      const int o = (tid + half * s.tile) * V;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sa[tid * V + v] += sa[o + v];
        sb[tid * V + v] += sb[o + v];
      }
    }
    __syncthreads();
  }
  if (active && r == 0) {
    float* out = partials + (int64_t)blockIdx.x * 2 * p.c + group * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      out[v] = sa[tid * V + v];
      out[p.c + v] = sb[tid * V + v];
    }
  }
}

template <typename T, int V, class Op>
__global__ void __launch_bounds__(kThreads)
    bn_map(const T* __restrict__ x, const T* __restrict__ dy,
              T* __restrict__ out, Op op, Params p, int64_t m) {
  constexpr int U = BN_UNROLL(Op);
  const Tiling s = tiling(p.c, V);
  const int tid = threadIdx.x, col = tid % s.tile, r = tid / s.tile;
  const int group = blockIdx.y * s.tile + col;
  if (r >= s.rows || group >= s.groups) return;
  typename Op::Chan k[V];
#pragma unroll
  for (int v = 0; v < V; ++v) k[v] = op.chan(p, group * V + v);
  const int64_t step = (int64_t)gridDim.x * s.rows;
  const int64_t first = group * V;
  auto put = [&](int64_t row, const Pack<T, V>& px, const Pack<T, V>& pd) {
    float xv[V], dv[V], o[V];
    px.unpack(xv);
    if (Op::kTwo) pd.unpack(dv);
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = op.map(k[v], xv[v], Op::kTwo ? dv[v] : 0.0f);
    store<T, V>(out + first + row * p.c, o);
  };
  int64_t row = (int64_t)blockIdx.x * s.rows + r;
  for (; row + (U - 1) * step < m; row += U * step) {
    Pack<T, V> px[U], pd[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      px[u] = load<T, V>(x + first + (row + u * step) * p.c);
      if (Op::kTwo) pd[u] = load<T, V>(dy + first + (row + u * step) * p.c);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) put(row + u * step, px[u], pd[u]);
  }
  for (; row < m; row += step) {
    Pack<T, V> px = load<T, V>(x + first + row * p.c), pd = px;
    if (Op::kTwo) pd = load<T, V>(dy + first + row * p.c);
    put(row, px, pd);
  }
}

// ---- the partials' sums, and the moments with the running update --------

// A block per 32 channels: 8 threads a channel sum every 8th partial in
// order, then one thread sums the 8 in order. moments = 0 writes the sums
// (out0 = Σa, out1 = Σb); moments = 1 writes mean and the biased var from
// Σx, Σx², and moves the running statistics when run_mean is given.
__global__ void __launch_bounds__(kFinLanes * kFinSlices)
    bn_finalize(const float* __restrict__ partials, int blocks, int c,
                float count, float* __restrict__ out0,
                float* __restrict__ out1, float* __restrict__ run_mean,
                float* __restrict__ run_var, float momentum, float keep,
                int moments) {
  const int lane = threadIdx.x % kFinLanes, slice = threadIdx.x / kFinLanes;
  const int ch = blockIdx.x * kFinLanes + lane;
  float a = 0.0f, b = 0.0f;
  if (ch < c)
    for (int g = slice; g < blocks; g += kFinSlices) {
      a += partials[(int64_t)g * 2 * c + ch];
      b += partials[(int64_t)g * 2 * c + c + ch];
    }
  __shared__ float sa[kFinSlices][kFinLanes], sb[kFinSlices][kFinLanes];
  sa[slice][lane] = a;
  sb[slice][lane] = b;
  __syncthreads();
  if (slice != 0 || ch >= c) return;
  for (int k = 1; k < kFinSlices; ++k) {
    a += sa[k][lane];
    b += sb[k][lane];
  }
  if (!moments) {
    out0[ch] = a;
    out1[ch] = b;
    return;
  }
  const float mean = a / count;
  const float q = b / count - mean * mean;
  const float var = q < 0.0f ? 0.0f : q;  // clamp_min: NaN stays NaN
  out0[ch] = mean;
  out1[ch] = var;
  if (run_mean) {
    run_mean[ch] = momentum * run_mean[ch] + keep * mean;
    run_var[ch] = momentum * run_var[ch] + keep * var;
  }
}

// ---- grids and launches -------------------------------------------------

struct Shape {
  int64_t rows;
  int c, vec;
};

int tiles(const Shape& s) {
  const Tiling cs = tiling(s.c, s.vec);
  return (int)ceil_div(cs.groups, cs.tile);
}

// Blocks along the rows (grid.x): enough for kMinPasses passes a thread, at
// most kWaves blocks an SM over the whole grid.
int row_blocks(const Shape& s, int sms) {
  const Tiling cs = tiling(s.c, s.vec);
  int64_t want = ceil_div(ceil_div(s.rows, cs.rows), kMinPasses);
  int64_t cap = (int64_t)kWaves * sms / tiles(s);
  if (cap < 1) cap = 1;
  if (want > cap) want = cap;
  return (int)(want < 1 ? 1 : want);
}

template <typename T, int V, class Op>
cudaError_t launch_map(const void* x, const void* dy, void* out, Op op,
                       const Params& p, const Shape& s, int device,
                       cudaStream_t st) {
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  bn_map<T, V, Op><<<dim3(row_blocks(s, sms), tiles(s)), kThreads, 0, st>>>(
      (const T*)x, (const T*)dy, (T*)out, op, p, s.rows);
  return cudaGetLastError();
}

template <typename T, int V, class Op>
cudaError_t launch_reduce(const void* x, const void* dy, float* partials,
                          Op op, const Params& p, const Shape& s, int blocks,
                          cudaStream_t st) {
  bn_reduce<T, V, Op><<<dim3(blocks, tiles(s)), kThreads, 0, st>>>(
      (const T*)x, (const T*)dy, op, p, partials, s.rows);
  return cudaGetLastError();
}

// f(Tag<T>, integral_constant V, bool_constant relu) for the call's flags
template <class F>
cudaError_t dispatch(int bf16, int vec, int relu, F f) {
  using V1 = std::integral_constant<int, 1>;
  using V8 = std::integral_constant<int, 8>;
  using R0 = std::false_type;
  using R1 = std::true_type;
  if (bf16) {
    if (vec == 8) return relu ? f(Tag<__nv_bfloat16>{}, V8{}, R1{}) : f(Tag<__nv_bfloat16>{}, V8{}, R0{});
    return relu ? f(Tag<__nv_bfloat16>{}, V1{}, R1{}) : f(Tag<__nv_bfloat16>{}, V1{}, R0{});
  }
  if (vec == 8) return relu ? f(Tag<float>{}, V8{}, R1{}) : f(Tag<float>{}, V8{}, R0{});
  return relu ? f(Tag<float>{}, V1{}, R1{}) : f(Tag<float>{}, V1{}, R0{});
}

Shape shape_of(int rows, int c, int vec) {
  return Shape{rows, c, vec == 8 ? 8 : 1};
}

Params params_of(const float* mean, const float* var, const float* scale,
                 const float* bias, const float* sums, float eps, float count,
                 int c) {
  return Params{mean, var, scale, bias, sums, eps, count, c};
}

}  // namespace

// The rows' blocks (grid.x) of leaf_bn_stats and leaf_bn_grad_reduce, which
// is the number of partials [blocks][2][c] they write; a negative
// cudaError_t on failure. vec = 8 or 1.
extern "C" int leaf_bn_blocks(int rows, int c, int vec, int device) {
  if (c <= 0) return 1;
  const int sms = sm_count(device);
  if (sms <= 0) return -(int)cudaErrorInvalidDevice;
  return row_blocks(shape_of(rows, c, vec), sms);
}

// x: [rows, c], bf16 when bf16 = 1 else f32 -> partials f32 [blocks][2][c]:
// each block's Σx and Σx²
extern "C" int leaf_bn_stats(const void* x, float* partials, int rows, int c,
                             int vec, int bf16, int blocks, int device,
                             void* stream) {
  if (c == 0) return (int)cudaSuccess;
  const Shape s = shape_of(rows, c, vec);
  const Params p = params_of(nullptr, nullptr, nullptr, nullptr, nullptr, 0.0f,
                             0.0f, c);
  return on_device(device, [&] {
    return dispatch(bf16, s.vec, 0, [&](auto t, auto v, auto) {
      using T = typename decltype(t)::type;
      return launch_reduce<T, decltype(v)::value>(
          x, nullptr, partials, StatsOp{}, p, s, blocks, (cudaStream_t)stream);
    });
  });
}

// partials f32 [blocks][2][c] -> with moments = 0, out0 = Σ first halves,
// out1 = Σ second halves; with moments = 1 (the halves being Σx and Σx² of
// `count` rows), out0 = mean, out1 = biased var, and, when run_mean is not
// null, run_mean and run_var move to momentum * run + keep * batch.
extern "C" int leaf_bn_finalize(const float* partials, float* out0,
                                float* out1, float* run_mean, float* run_var,
                                int blocks, int c, float count,
                                float momentum, float keep, int moments,
                                int device, void* stream) {
  if (c == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    bn_finalize<<<(unsigned)ceil_div(c, kFinLanes), kFinLanes * kFinSlices, 0,
                  (cudaStream_t)stream>>>(partials, blocks, c, count, out0,
                                          out1, run_mean, run_var, momentum,
                                          keep, moments);
    return cudaGetLastError();
  });
}

// y = ((x - mean) * (inv * scale) + bias) in x's type, ReLU'd when
// relu = 1; mean, var, scale, bias f32 [c]
extern "C" int leaf_bn_apply(const void* x, void* y, const float* mean,
                             const float* var, const float* scale,
                             const float* bias, float eps, int rows, int c,
                             int vec, int bf16, int relu, int device,
                             void* stream) {
  if ((int64_t)rows * c == 0) return (int)cudaSuccess;
  const Shape s = shape_of(rows, c, vec);
  const Params p = params_of(mean, var, scale, bias, nullptr, eps, 0.0f, c);
  return on_device(device, [&] {
    return dispatch(bf16, s.vec, relu, [&](auto t, auto v, auto r) {
      using T = typename decltype(t)::type;
      return launch_map<T, decltype(v)::value>(
          x, nullptr, y, ApplyOp<T, decltype(r)::value>{}, p, s, device,
          (cudaStream_t)stream);
    });
  });
}

// x, dy: [rows, c] as leaf_bn_stats -> partials f32 [blocks][2][c]: each
// block's Σdy' and Σdy'·x̂ (dy' masked by the forward's ReLU when relu = 1)
extern "C" int leaf_bn_grad_reduce(const void* x, const void* dy,
                                   float* partials, const float* mean,
                                   const float* var, const float* scale,
                                   const float* bias, float eps, int rows,
                                   int c, int vec, int bf16, int relu,
                                   int blocks, int device, void* stream) {
  if (c == 0) return (int)cudaSuccess;
  const Shape s = shape_of(rows, c, vec);
  const Params p = params_of(mean, var, scale, bias, nullptr, eps, 0.0f, c);
  return on_device(device, [&] {
    return dispatch(bf16, s.vec, relu, [&](auto t, auto v, auto r) {
      using T = typename decltype(t)::type;
      return launch_reduce<T, decltype(v)::value>(
          x, dy, partials, GradOp<T, decltype(r)::value>{}, p, s, blocks,
          (cudaStream_t)stream);
    });
  });
}

// dx = (scale * inv) * ((dy' - sums[0]/count) - x̂ * sums[1]/count) in x's
// type; sums f32 [2][c] are the batch's Σdy' and Σdy'·x̂
extern "C" int leaf_bn_dx(const void* x, const void* dy, void* dx,
                          const float* mean, const float* var,
                          const float* scale, const float* bias,
                          const float* sums, float eps, float count, int rows,
                          int c, int vec, int bf16, int relu, int device,
                          void* stream) {
  if ((int64_t)rows * c == 0) return (int)cudaSuccess;
  const Shape s = shape_of(rows, c, vec);
  const Params p = params_of(mean, var, scale, bias, sums, eps, count, c);
  return on_device(device, [&] {
    return dispatch(bf16, s.vec, relu, [&](auto t, auto v, auto r) {
      using T = typename decltype(t)::type;
      return launch_map<T, decltype(v)::value>(
          x, dy, dx, DxOp<T, decltype(r)::value>{}, p, s, device,
          (cudaStream_t)stream);
    });
  });
}
