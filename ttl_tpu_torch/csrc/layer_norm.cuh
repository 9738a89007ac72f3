// The layernorm's arithmetic on one row, as every kernel of the package that
// normalises a row computes it:
//   mu   = sum_k x_k / K                       (f32)
//   rstd = rsqrt(sum_k (x_k - mu)^2 / K + eps)  (f32, the centered variance;
//          or rsqrt(max(sum_k x_k^2 / K - mu^2, 0) + eps) where the variance
//          is E[x^2] - mu^2, TTL_LN_STATS=ex2)
//   y_k  = ((x_k - mu) * rstd) * scale_k + bias_k
// or, with RMS statistics (an RMSNorm: AIMv2's), mu taken as 0 and no bias:
//   rstd = rsqrt(sum_k x_k^2 / K + eps),   y_k = (x_k * rstd) * scale_k
// with the multiply and the add of the affine separate, correctly rounded
// operations (no contraction into an FMA), as the chain of elementwise
// tensor operations of models/clip.py::layer_norm rounds them; the caller
// rounds y once to its output type. How the sums are taken (which lanes,
// which order) is the caller's.
//
// Users: ln_matmul.cu (K6's row prologue), layer_norm.cu.
#pragma once
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mu from the row's sum over its k columns
__device__ __forceinline__ float ln_mean(float sum, float k) {
  return __fdiv_rn(sum, k);
}

// rstd from the sum of the squared deviations from mu
__device__ __forceinline__ float ln_rstd(float sq_sum, float k, float eps) {
  return rsqrtf(__fdiv_rn(sq_sum, k) + eps);
}

// rstd from the sum of the squares and mu: E[x^2] - mu^2, floored at 0
__device__ __forceinline__ float ln_rstd_ex2(float sq_sum, float mu, float k,
                                             float eps) {
  return rsqrtf(fmaxf(__fsub_rn(__fdiv_rn(sq_sum, k), __fmul_rn(mu, mu)),
                      0.f) + eps);
}

// ((v - mu) * rstd) * scale + bias, each operation rounded on its own
__device__ __forceinline__ float ln_affine(float v, float mu, float rstd,
                                           float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(v - mu, rstd), scale), bias);
}

// the RMS statistics' affine: (v * rstd) * scale, rounded apart; rstd is
// ln_rstd of the sum of the squares (the deviations from a mean of 0)
__device__ __forceinline__ float rms_affine(float v, float rstd,
                                            float scale) {
  return __fmul_rn(__fmul_rn(v, rstd), scale);
}

}  // namespace
