// Device helpers shared by the shear-based warps: K1 (train_aug.cu), K2
// (rotate_expand.cu) and K3 (shear_cubic.cu).
//
// Sign-exact source-position tests, after _scaled_positions in
// leaffliction_tpu/ops/pallas/rotate.py: a shear factor sh is split into a
// 12-bit head `hi` and a tail `lo` (computed once per image on the host
// side), so that hi * idx is exact on integer or half-integer grids up to
// ~2^11, and the cancellation near each bound is exact. A source position
// that truly sits within 1e-8 of an edge then lands on the same side as in
// exact arithmetic. The library is built with -fmad=false, so every product
// and sum is rounded on its own, as in the plain PyTorch twins.

#pragma once

// coord + sh * idx >= 0, from the split sh = hi + lo
__device__ __forceinline__ bool pos_at_least_zero(float coord, float idx,
                                                  float hi, float lo) {
  return (coord + hi * idx) + lo * idx >= 0.0f;
}

// coord + sh * idx <= upper, from the split sh = hi + lo
__device__ __forceinline__ bool pos_at_most(float coord, float idx,
                                            float upper, float hi, float lo) {
  return ((coord - upper) + hi * idx) + lo * idx <= 0.0f;
}

// Keys cubic weight, a = -0.5 (PIL BICUBIC), for |d| <= 2
__device__ __forceinline__ float keys_cubic(float d) {
  float ad = fabsf(d);
  float ad2 = ad * ad;
  float ad3 = ad2 * ad;
  if (ad <= 1.0f) return (1.5f * ad3 - 2.5f * ad2) + 1.0f;
  return -0.5f * (((ad3 - 5.0f * ad2) + 8.0f * ad) - 4.0f);
}

// float -> uint8 with round half to even, then clip to [0, 255]
__device__ __forceinline__ unsigned char round_clip_u8(float v) {
  return (unsigned char)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}
