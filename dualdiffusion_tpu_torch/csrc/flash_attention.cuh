// What K7's kernels share (flash_attention.cu, flash_attention_wide.cu):
// the parameters of one call, its masks, and their host-side checks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dd_attn {

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t sq[3], sk[3], sv[3], so[3];  // element strides of b, h, l; d has stride 1
  int H, L, D;
  float scale_log2;  // scale * log2(e)
  int window;        // < 0: no band
  int causal;
};

// the key range [k_lo, k_hi] that rows [q0, q_hi] can see
__device__ __forceinline__ void key_range(const Params& p, int q0, int q_hi, int& k_lo,
                                          int& k_hi) {
  k_lo = 0;
  k_hi = p.L - 1;
  if (p.window >= 0) {
    k_lo = max(q0 - p.window, 0);
    k_hi = min(q_hi + p.window, p.L - 1);
  }
  if (p.causal) k_hi = min(k_hi, q_hi);
}

__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  return col < p.L && (p.window < 0 || abs(row - col) <= p.window) && (!p.causal || col <= row);
}

// fills p from dd_flash_attention's arguments; returns a CUDA error code,
// or 0 when the arguments are ones the kernels take
inline int make_params(Params& p, const void* q, const void* k, const void* v, void* o,
                       const long long* strides, int B, int H, int L, int D, float scale,
                       int window, int causal, int is_bf16) {
  if (B <= 0 || H <= 0 || L <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  if (is_bf16) {
    bool ok = D % 8 == 0;
    for (int i = 0; i < 12; ++i) ok = ok && strides[i] > 0 && strides[i] % 8 == 0;
    const void* ptrs[4] = {q, k, v, o};
    for (int i = 0; i < 4; ++i) ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
    if (!ok) return (int)cudaErrorMisalignedAddress;
  }
  p.H = H;
  p.L = L;
  p.D = D;
  p.scale_log2 = scale * kLog2e;
  p.window = window;
  p.causal = causal;
  return 0;
}

}  // namespace dd_attn
