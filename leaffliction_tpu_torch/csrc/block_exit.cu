// The exit of a residual block, forward and backward, over tensors held
// channels-last: [n * h * w, c] row-major, the layout the models'
// convolutions and BatchNorm kernels hand over. The wrapper copies any
// other layout it takes into this one (ops/kernels/block_exit.py).
//
//   out = pool( drop( relu( shortcut + y * se ) ) )
//
// each part optional: se a per-(n, c) scale (the SE gate, in y's type),
// shortcut a tensor like y, relu on or off, drop a per-(n, c) keep mask
// with 1 / keep as an f32, pool a k x k / s max-pool whose windows may reach
// past the edges by pad_h, pad_w (flax SAME, the padding -inf) or not
// (VALID; k = s = 1 is no pool).
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA's
// fusion. The plain twin is leaffliction_tpu_torch/ops/block_exit.py
// (block_exit_plain: the models' eager expressions).
//
// The arithmetic is the twin's on the card, step by step, each step
// rounded to T (bf16 or f32) where PyTorch's eager op rounds:
//   p = T(y * se); a = T(shortcut + p); r = a <= 0 ? 0 : a (torch.relu);
//   d = kept ? T(r * inv) : 0 (PyTorch's CUDA division by a Python scalar
//   multiplies by its reciprocal inv, computed in double and rounded to
//   f32);
//   out = the window's first strict maximum in row-major order, a NaN
//   always taking the pick (max_pool2d's rule); the pick is written as a
//   one-byte code, its offset ky * k + kx in the window.
// Backward, g the output gradient:
//   g_d = T(the sum of g over the windows that picked the element, in
//   row-major window order), as max_pool2d's backward gathers it;
//   g_a = kept ? T(g_d * inv) : 0, then 0 where a <= 0 (threshold_backward,
//   a rebuilt from y, shortcut and se as the forward computed it, so no
//   tensor before the pool is saved);
//   d_shortcut = g_a; dy = T(g_a * se); d_se = T(sum over the image's
//   positions of g_a * y), in f32 (the eager chain rounds each product to T
//   before its sum).
// The library is built with -fmad=false, so out, the picks, d_shortcut and
// dy are the twin's to the bit; d_se differs by its terms' rounding and the
// sum's order.
//
// What bounds it on an H100: bytes, at 3.35 TB/s; a few operations a value.
//   - Forward: a thread per output element and V channels (channels_last.cuh)
//     reads its window of y and shortcut once and writes out and the codes:
//     at a 2 x 2 / 2 pool 4.75 bytes an input element in bf16, where the
//     eager chain's six passes and int64 indices moved about 26.
//   - Backward: a block per slab of one image's positions; each thread walks
//     positions with a stride, gathers its windows' codes and gradients,
//     reads y and shortcut once and writes dy and d_shortcut once (about 9
//     bytes an element at 2 x 2 / 2), summing g_a * y for its channels.
//   - The d_se sums are deterministic: each thread sums its positions in
//     order, each block its threads in a fixed tree into partials
//     [n][block][c]; exit_finalize sums the partials in a fixed order. No
//     atomics: two calls on the same inputs give the same bits.
//   - Nothing is allocated or synchronised here: the wrapper allocates
//     outputs, codes and partials, and every launch takes the caller's
//     stream, so CUDA graphs capture the calls.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "channels_last.cuh"
#include "device_guard.cuh"

namespace {

// A call's shapes and flags. Every tensor holds fewer than 2^31 elements
// (the wrapper refuses more), so indices are 32-bit.
struct Exit {
  int n, h, w, c;          // the input
  int oh, ow;              // the output
  int k, s, pad_h, pad_w;  // the pool (k = s = 1 and no padding: none)
  int relu;
  float inv;               // 1 / keep, an f32
};

// V picks as they sit in memory (8 bytes or 1): loaded raw, read one by one
template <int V>
struct Codes;

template <>
struct Codes<1> {
  using Raw = uint8_t;
  __device__ __forceinline__ static Raw get(const uint8_t* p) { return *p; }
  __device__ __forceinline__ static int at(Raw r, int) { return r; }
  __device__ __forceinline__ static void put(uint8_t* p, const int* c) {
    p[0] = (uint8_t)c[0];
  }
};

template <>
struct Codes<8> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw get(const uint8_t* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ static int at(Raw r, int v) {
    return ((v < 4 ? r.x : r.y) >> (8 * (v & 3))) & 0xff;
  }
  __device__ __forceinline__ static void put(uint8_t* p, const int* c) {
    uint2 u = make_uint2(0u, 0u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      u.x |= (unsigned)c[k] << (8 * k);
      u.y |= (unsigned)c[4 + k] << (8 * k);
    }
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// Per channel: the SE scale (1 without one) and whether the dropout kept it
template <typename T, int V>
__device__ __forceinline__ void channels(const T* se, const uint8_t* keep,
                                         int at, float* scale,
                                         bool* kept) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    scale[v] = se ? to_float(se[at + v]) : 1.0f;
    kept[v] = keep ? keep[at + v] != 0 : true;
  }
}

// a = T(shortcut + T(y * se)), the value the ReLU sees
template <typename T>
__device__ __forceinline__ float summed(float y, float sc, float se,
                                        bool has_se, bool has_sc) {
  const float p = has_se ? rounded<T>(y * se) : y;
  return has_sc ? rounded<T>(sc + p) : p;
}

// ---- the kernels -----------------------------------------------------------

// Where a kernel knows the pool's k (and s) when it is compiled (K > 0),
// each thread starts all of its window's loads before it uses one, so
// their latencies overlap; K = 0 walks any window at run time. Both visit
// the window's positions, and the backward its candidate windows, in
// row-major order. POOL_ONLY compiles the exit that is a pool alone (no
// se, shortcut, ReLU or dropout: the ResNet's stem), whose threads then
// hold only the window's values and picks (twice the blocks an SM).

// One window position's values folded into the running maximum: the first
// strict maximum, or the last NaN, keeps the pick
template <typename T, int V>
__device__ __forceinline__ void consider(const Pack<T, V>& py,
                                         const Pack<T, V>& ps, bool has_sc,
                                         bool has_se, const uint8_t* keep,
                                         const float* scale, const bool* kept,
                                         const Exit& e, int offset,
                                         float* best, int* pick) {
  float yv[V], sv[V];
  py.unpack(yv);
  if (has_sc) ps.unpack(sv);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float d = summed<T>(yv[v], has_sc ? sv[v] : 0.0f, scale[v], has_se,
                        has_sc);
    if (e.relu && d <= 0.0f) d = 0.0f;
    if (keep) d = kept[v] ? rounded<T>(d * e.inv) : 0.0f;
    if (d > best[v] || isnan(d)) {
      best[v] = d;
      pick[v] = offset;
    }
  }
}

// A thread per output element and V channels: its window's values, the
// first strict maximum (or the last NaN) and its offset.
template <typename T, int V, int K, bool POOL_ONLY>
__global__ void __launch_bounds__(kThreads)
    exit_forward(const T* __restrict__ y, const T* __restrict__ sc_in,
                 const T* __restrict__ se_in,
                 const uint8_t* __restrict__ keep_in, T* __restrict__ out,
                 uint8_t* __restrict__ code, Exit e) {
  const T* __restrict__ sc = POOL_ONLY ? nullptr : sc_in;
  const T* __restrict__ se = POOL_ONLY ? nullptr : se_in;
  const uint8_t* __restrict__ keep = POOL_ONLY ? nullptr : keep_in;
  if (POOL_ONLY) e.relu = 0;
  const int groups = e.c / V;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= e.n * e.oh * e.ow * groups) return;
  const int ch = (i % groups) * V;
  const int orow = i / groups;
  const int ox = orow % e.ow, rest = orow / e.ow;
  const int oy = rest % e.oh, n = rest / e.oh;
  float scale[V];
  bool kept[V];
  channels<T, V>(se, keep, n * e.c + ch, scale, kept);
  const int y0 = oy * e.s - e.pad_h, x0 = ox * e.s - e.pad_w;
  const int ky0 = max(0, -y0), ky1 = min(e.k, e.h - y0);
  const int kx0 = max(0, -x0), kx1 = min(e.k, e.w - x0);
  const int corner = ((n * e.h + y0) * e.w + x0) * e.c + ch;
  float best[V];
  int pick[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    best[v] = -INFINITY;
    pick[v] = ky0 * e.k + kx0;
  }
  if constexpr (K > 0) {
    Pack<T, V> py[K * K], ps[K * K];
    bool in[K * K];
#pragma unroll
    for (int j = 0; j < K * K; ++j) {
      const int ky = j / K, kx = j % K;
      in[j] = ky >= ky0 && ky < ky1 && kx >= kx0 && kx < kx1;
      if (in[j]) {
        const int at = corner + (ky * e.w + kx) * e.c;
        py[j] = load<T, V>(y + at);
        if (sc) ps[j] = load<T, V>(sc + at);
      }
    }
#pragma unroll
    for (int j = 0; j < K * K; ++j)
      if (in[j])
        consider<T, V>(py[j], ps[j], sc != nullptr, se != nullptr, keep,
                       scale, kept, e, j, best, pick);
  } else {
    for (int ky = ky0; ky < ky1; ++ky)
      for (int kx = kx0; kx < kx1; ++kx) {
        const int at = corner + (ky * e.w + kx) * e.c;
        const Pack<T, V> py = load<T, V>(y + at);
        const Pack<T, V> ps = sc ? load<T, V>(sc + at) : py;
        consider<T, V>(py, ps, sc != nullptr, se != nullptr, keep, scale,
                       kept, e, ky * e.k + kx, best, pick);
      }
  }
  store<T, V>(out + orow * e.c + ch, best);
  if (code) Codes<V>::put(code + orow * e.c + ch, pick);
}

// Blocks (blockIdx.x, channel tile blockIdx.y, image blockIdx.z); each
// thread walks its image's positions with a stride. K = 1 (S = 1): no
// pool, an element's gradient is the output gradient at it (code null);
// K > 1: a k x k / s pool of those sizes; K = 0: any of the three.
template <typename T, int V, int K, int S, bool POOL_ONLY>
__global__ void __launch_bounds__(kThreads)
    exit_backward(const T* __restrict__ gout, const uint8_t* __restrict__ code,
                  const T* __restrict__ y_in, const T* __restrict__ sc_in,
                  const T* __restrict__ se_in,
                  const uint8_t* __restrict__ keep_in, T* __restrict__ dy,
                  T* __restrict__ dsc_in, float* __restrict__ partials_in,
                  Exit e) {
  const T* __restrict__ y = POOL_ONLY ? nullptr : y_in;
  const T* __restrict__ sc = POOL_ONLY ? nullptr : sc_in;
  const T* __restrict__ se = POOL_ONLY ? nullptr : se_in;
  const uint8_t* __restrict__ keep = POOL_ONLY ? nullptr : keep_in;
  T* __restrict__ dsc = POOL_ONLY ? nullptr : dsc_in;
  float* __restrict__ partials = POOL_ONLY ? nullptr : partials_in;
  if (POOL_ONLY) e.relu = 0;
  const Tiling s = tiling(e.c, V);
  const int tid = threadIdx.x, col = tid % s.tile, r = tid / s.tile;
  const int group = blockIdx.y * s.tile + col;
  const int n = blockIdx.z;
  const bool active = r < s.rows && group < s.groups;
  const bool relu_sc = sc != nullptr && e.relu;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  if (active) {
    const int ch = group * V;
    float scale[V];
    bool kept[V];
    channels<T, V>(se, keep, n * e.c + ch, scale, kept);
    const int hw = e.h * e.w;
    const int step = gridDim.x * s.rows;
    const int first = n * e.oh * e.ow * e.c + ch;
    for (int p = blockIdx.x * s.rows + r; p < hw; p += step) {
      const int iy = p / e.w, ix = p % e.w;
      const int at = (n * hw + p) * e.c + ch;
      Pack<T, V> py, ps;
      if (y) py = load<T, V>(y + at);
      if (relu_sc) ps = load<T, V>(sc + at);
      float g[V];
      if constexpr (K == 1) {
        load<T, V>(gout + at).unpack(g);
      } else if constexpr (K > 1) {
        // the windows oy * S - pad_h <= iy < oy * S - pad_h + K: at most
        // M a dimension
        constexpr int M = (K + S - 1) / S;
        const int ny = iy + e.pad_h - K + 1, nx = ix + e.pad_w - K + 1;
        const int oy0 = ny <= 0 ? 0 : (ny + S - 1) / S;
        const int ox0 = nx <= 0 ? 0 : (nx + S - 1) / S;
        const int oy1 = min(e.oh - 1, (iy + e.pad_h) / S);
        const int ox1 = min(e.ow - 1, (ix + e.pad_w) / S);
        typename Codes<V>::Raw pk[M * M];
        Pack<T, V> pg[M * M];
        bool in[M * M];
#pragma unroll
        for (int j = 0; j < M * M; ++j) {
          const int oy = oy0 + j / M, ox = ox0 + j % M;
          in[j] = oy <= oy1 && ox <= ox1;
          if (in[j]) {
            const int o = first + (oy * e.ow + ox) * e.c;
            pk[j] = Codes<V>::get(code + o);
            pg[j] = load<T, V>(gout + o);
          }
        }
#pragma unroll
        for (int v = 0; v < V; ++v) g[v] = 0.0f;
#pragma unroll
        for (int j = 0; j < M * M; ++j)
          if (in[j]) {
            const int oy = oy0 + j / M, ox = ox0 + j % M;
            const int want =
                (iy - (oy * S - e.pad_h)) * K + (ix - (ox * S - e.pad_w));
            float gv[V];
            pg[j].unpack(gv);
#pragma unroll
            for (int v = 0; v < V; ++v)
              if (Codes<V>::at(pk[j], v) == want) g[v] += gv[v];
          }
#pragma unroll
        for (int v = 0; v < V; ++v) g[v] = rounded<T>(g[v]);
      } else if (!code) {
        load<T, V>(gout + at).unpack(g);
      } else {
        // the windows oy * s - pad_h <= iy < oy * s - pad_h + k
        const int ny = iy + e.pad_h - e.k + 1, nx = ix + e.pad_w - e.k + 1;
        const int oy0 = ny <= 0 ? 0 : (ny + e.s - 1) / e.s;
        const int ox0 = nx <= 0 ? 0 : (nx + e.s - 1) / e.s;
        const int oy1 = min(e.oh - 1, (iy + e.pad_h) / e.s);
        const int ox1 = min(e.ow - 1, (ix + e.pad_w) / e.s);
#pragma unroll
        for (int v = 0; v < V; ++v) g[v] = 0.0f;
        for (int oy = oy0; oy <= oy1; ++oy)
          for (int ox = ox0; ox <= ox1; ++ox) {
            const int o = first + (oy * e.ow + ox) * e.c;
            const int want = (iy - (oy * e.s - e.pad_h)) * e.k +
                             (ix - (ox * e.s - e.pad_w));
            const typename Codes<V>::Raw pk = Codes<V>::get(code + o);
            float gv[V];
            load<T, V>(gout + o).unpack(gv);
#pragma unroll
            for (int v = 0; v < V; ++v)
              if (Codes<V>::at(pk, v) == want) g[v] += gv[v];
          }
#pragma unroll
        for (int v = 0; v < V; ++v) g[v] = rounded<T>(g[v]);
      }
      float yv[V], sv[V];
      if (y) py.unpack(yv);
      if (relu_sc) ps.unpack(sv);
      float d[V], dyv[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        d[v] = g[v];
        if (keep) d[v] = kept[v] ? rounded<T>(d[v] * e.inv) : 0.0f;
        if (e.relu &&
            summed<T>(yv[v], relu_sc ? sv[v] : 0.0f, scale[v], se != nullptr,
                      relu_sc) <= 0.0f)
          d[v] = 0.0f;
        dyv[v] = se ? d[v] * scale[v] : d[v];
        if (se) acc[v] += d[v] * yv[v];
      }
      store<T, V>(dy + at, dyv);
      if (dsc) store<T, V>(dsc + at, d);
    }
  }
  if (!partials) return;
  __shared__ float sa[kThreads * V];
#pragma unroll
  for (int v = 0; v < V; ++v) sa[tid * V + v] = acc[v];
  __syncthreads();
  for (int half = pow2_at_least(s.rows) / 2; half > 0; half >>= 1) {
    if (active && r < half && r + half < s.rows) {
      const int o = (tid + half * s.tile) * V;
#pragma unroll
      for (int v = 0; v < V; ++v) sa[tid * V + v] += sa[o + v];
    }
    __syncthreads();
  }
  if (active && r == 0) {
    float* to = partials + (n * gridDim.x + blockIdx.x) * e.c + group * V;
#pragma unroll
    for (int v = 0; v < V; ++v) to[v] = sa[tid * V + v];
  }
}

// d_se[n][c] = T(the image's partials summed in order)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    exit_finalize(const float* __restrict__ partials, T* __restrict__ out,
                  int n, int blocks, int c) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)n * c) return;
  const int64_t img = i / c;
  const int ch = (int)(i % c);
  float a = 0.0f;
  for (int b = 0; b < blocks; ++b) a += partials[(img * blocks + b) * c + ch];
  out[i] = from_float<T>(a);
}

// ---- grids and launches ----------------------------------------------------

int channel_tiles(int c, int vec) {
  const Tiling s = tiling(c, vec);
  return (int)ceil_div(s.groups, s.tile);
}

// Blocks an image along its positions (grid.x of exit_backward): enough for
// kMinPasses passes a thread, at most kWaves blocks an SM over the grid.
int image_blocks(int n, int64_t hw, int c, int vec, int sms) {
  const Tiling s = tiling(c, vec);
  int64_t want = ceil_div(ceil_div(hw, s.rows), kMinPasses);
  int64_t cap = (int64_t)kWaves * sms / ((int64_t)channel_tiles(c, vec) * n);
  if (cap < 1) cap = 1;
  if (want > cap) want = cap;
  return (int)(want < 1 ? 1 : want);
}

// f(Tag<T>, V, K, S, POOL_ONLY), each an integral_constant, for the call's
// type, access width and pool: the pools the models run (none, 2 x 2 / 2,
// 3 x 3 / 2) compiled in at 16-byte accesses, any other (and every pool at
// one element a thread) walked at run time (K = S = 0); POOL_ONLY where the
// exit is the pool alone
template <int N>
using Int = std::integral_constant<int, N>;
template <bool B>
using Bool = std::integral_constant<bool, B>;

template <class F>
cudaError_t dispatch(int bf16, int vec, int k, int s, bool pool_only, F f) {
  auto window = [&](auto t, auto only) {
    if (vec != 8) return f(t, Int<1>{}, Int<0>{}, Int<0>{}, Bool<false>{});
    if (k == 1 && s == 1) return f(t, Int<8>{}, Int<1>{}, Int<1>{}, only);
    if (k == 2 && s == 2) return f(t, Int<8>{}, Int<2>{}, Int<2>{}, only);
    if (k == 3 && s == 2) return f(t, Int<8>{}, Int<3>{}, Int<2>{}, only);
    return f(t, Int<8>{}, Int<0>{}, Int<0>{}, only);
  };
  auto typed = [&](auto t) {
    return pool_only ? window(t, Bool<true>{}) : window(t, Bool<false>{});
  };
  return bf16 ? typed(Tag<__nv_bfloat16>{}) : typed(Tag<float>{});
}

Exit exit_of(int n, int h, int w, int c, int oh, int ow, int k, int s,
             int pad_h, int pad_w, int relu, float inv) {
  return Exit{n, h, w, c, oh, ow, k, s, pad_h, pad_w, relu, inv};
}

}  // namespace

// The blocks an image of leaf_exit_backward (grid.x), which with n and c
// sizes its partials [n][blocks][c]; a negative cudaError_t on failure.
// vec = 8 or 1.
extern "C" int leaf_exit_blocks(int n, int h, int w, int c, int vec,
                                int device) {
  if ((int64_t)n * c == 0) return 1;
  const int sms = sm_count(device);
  if (sms <= 0) return -(int)cudaErrorInvalidDevice;
  return image_blocks(n, (int64_t)h * w, c, vec == 8 ? 8 : 1, sms);
}

// y, sc: [n, h, w, c]; se, keep: [n, c] (null: none); out: [n, oh, ow, c];
// code: [n, oh, ow, c] picks (null: not written), bf16 when bf16 = 1 else
// f32 (keep and code uint8)
extern "C" int leaf_exit_forward(const void* y, const void* sc,
                                 const void* se, const uint8_t* keep,
                                 void* out, uint8_t* code, float inv, int n,
                                 int h, int w, int c, int oh, int ow, int k,
                                 int s, int pad_h, int pad_w, int relu,
                                 int vec, int bf16, int device,
                                 void* stream) {
  const int64_t items = (int64_t)n * oh * ow * (c / (vec == 8 ? 8 : 1));
  if (items == 0) return (int)cudaSuccess;
  const Exit e = exit_of(n, h, w, c, oh, ow, k, s, pad_h, pad_w, relu, inv);
  return on_device(device, [&] {
    const bool pool_only = !sc && !se && !keep && !relu;
    return dispatch(bf16, vec, k, s, pool_only,
                    [&](auto t, auto v, auto kk, auto, auto only) {
      using T = typename decltype(t)::type;
      exit_forward<T, decltype(v)::value, decltype(kk)::value,
                   decltype(only)::value>
          <<<(unsigned)ceil_div(items, kThreads), kThreads, 0,
             (cudaStream_t)stream>>>((const T*)y, (const T*)sc, (const T*)se,
                                     keep, (T*)out, code, e);
      return cudaGetLastError();
    });
  });
}

// gout, code: as leaf_exit_forward's out and code (code null: no pool);
// y, sc, se, keep: its inputs (y null when neither relu nor se reads it, sc
// null when relu does not); dy, dsc: [n, h, w, c] (dsc null: no shortcut);
// partials: f32 [n][blocks][c] of each block's sum of d_shortcut * y (null
// without se)
extern "C" int leaf_exit_backward(const void* gout, const uint8_t* code,
                                  const void* y, const void* sc,
                                  const void* se, const uint8_t* keep,
                                  void* dy, void* dsc, float* partials,
                                  float inv, int n, int h, int w, int c,
                                  int oh, int ow, int k, int s, int pad_h,
                                  int pad_w, int relu, int vec, int bf16,
                                  int blocks, int device, void* stream) {
  if ((int64_t)n * h * w * c == 0) return (int)cudaSuccess;
  const int v8 = vec == 8 ? 8 : 1;
  const Exit e = exit_of(n, h, w, c, oh, ow, k, s, pad_h, pad_w, relu, inv);
  return on_device(device, [&] {
    const bool pool_only = !sc && !se && !keep && !relu && !dsc;
    return dispatch(bf16, v8, k, s, pool_only,
                    [&](auto t, auto v, auto kk, auto ss, auto only) {
      using T = typename decltype(t)::type;
      exit_backward<T, decltype(v)::value, decltype(kk)::value,
                    decltype(ss)::value, decltype(only)::value>
          <<<dim3(blocks, channel_tiles(c, v8), n), kThreads, 0,
             (cudaStream_t)stream>>>((const T*)gout, code, (const T*)y,
                                     (const T*)sc, (const T*)se, keep,
                                     (T*)dy, (T*)dsc, partials, e);
      return cudaGetLastError();
    });
  });
}

// partials f32 [n][blocks][c] -> out [n, c] in y's type: each image's
// partials summed in block order
extern "C" int leaf_exit_finalize(const float* partials, void* out, int n,
                                  int blocks, int c, int bf16, int device,
                                  void* stream) {
  const int64_t items = (int64_t)n * c;
  if (items == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    const unsigned grid = (unsigned)ceil_div(items, kThreads);
    if (bf16)
      exit_finalize<__nv_bfloat16><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          partials, (__nv_bfloat16*)out, n, blocks, c);
    else
      exit_finalize<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          partials, (float*)out, n, blocks, c);
    return cudaGetLastError();
  });
}
