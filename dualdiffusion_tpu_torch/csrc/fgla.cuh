// The real-FFT split and merge shared by K2's kernels (fgla_frame.cu,
// fgla_frame_hopper.cu): a real n-point DFT is one complex m = n/2-point
// DFT of the (even, odd) sample pairs plus a step that pairs bins k, m - k.
#pragma once

#include "common.cuh"

// Bin k of the real DFT of an n-point frame, from the n/2-point complex DFT
// z of its (even, odd) sample pairs: (za + conj(zb) - i w (za - conj(zb))) / 2
// with za = z[k], zb = z[n/2 - k], w = exp(-2 pi i k / n).
__device__ __forceinline__ float2 split_bin(float2 za, float2 zb, float2 w) {
  const float2 sum = make_float2(za.x + zb.x, za.y - zb.y);
  const float2 wd = dd::cmul(w, make_float2(za.x - zb.x, za.y + zb.y));
  return make_float2(0.5f * (sum.x + wd.y), 0.5f * (sum.y - wd.x));
}

// The inverse of split_bin: entry k of the n/2-point spectrum whose inverse
// DFT holds the (even, odd) sample pairs of irfft(x), from real-DFT bins
// xa = x[k], xb = x[n/2 - k] and wc = exp(+2 pi i k / n).
__device__ __forceinline__ float2 merge_bin(float2 xa, float2 xb, float2 wc) {
  const float2 sum = make_float2(xa.x + xb.x, xa.y - xb.y);
  const float2 v = dd::cmul(wc, make_float2(xa.x - xb.x, xa.y + xb.y));
  return make_float2(0.5f * (sum.x - v.y), 0.5f * (sum.y + v.x));
}
