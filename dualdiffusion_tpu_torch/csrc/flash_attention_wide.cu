// K7 for heads wider than 256: online-softmax attention over (B, H, L, D),
// bf16 or fp32 in and out, fp32 softmax and sums, on the CUDA cores.
//
// Replaces dualdiffusion_tpu/ops/pallas/flash_attention.py _attn_kernel (via
// flash_attention) for D > 256, which the JAX wrapper pads to lanes of 128;
// flash_attention.cu takes D <= 256. The wrapper
// (ops/kernels/flash_attention.py) picks the entry point by D.
//
// What bounds it on the H100: its fp32 FMAs (4 B H L^2 D flops at 67
// TFLOP/s). No configuration of the repo has a head this wide, so the design
// is simple, not fast: one block of 4 threads per q row for 64 rows, 32-key
// tiles in shared memory, D walked in chunks of 128 for both S and O.

#include "common.cuh"
#include "flash_attention.cuh"

#include <math.h>

namespace {

using namespace dd_attn;
using bf16 = __nv_bfloat16;

constexpr int kWideRows = 64;               // q rows per block, 4 threads per row
constexpr int kWideThreads = 4 * kWideRows;
constexpr int kWideKeys = 32;               // keys per tile
constexpr int kWideChunk = 128;             // head dims per chunk, 32 per thread

// No configuration of the repo has a head this wide, so this kernel is
// simple, not fast: O's columns go in passes of kWideChunk, and each pass
// runs the whole online softmax again, with S = q . k summed over D in
// chunks of kWideChunk (q from global memory, the K chunk in shared memory)
// into a shared-memory score tile. Everything is fp32; o is stored in T.
// The key loops are unrolled only by 4, which keeps its build short.
template <typename T>
__global__ void __launch_bounds__(kWideThreads) flash_attn_wide_kernel(const Params p) {
  constexpr int NP = kWideChunk / 4;
  __shared__ float sKV[kWideKeys][kWideChunk];
  __shared__ float sS[kWideRows][kWideKeys + 1];  // scores of the key tile, one row a quad

  const int L = p.L, D = p.D;
  const int nq = (L + kWideRows - 1) / kWideRows;
  const int q0 = (blockIdx.x % nq) * kWideRows;
  const int b = blockIdx.x / nq / p.H, h = blockIdx.x / nq % p.H;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* kb = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[1];
  T* ob = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1];

  const int c = threadIdx.x & 3, r = threadIdx.x >> 2;
  const int row = q0 + r;
  const bool live = row < L;
  float* srow = sS[r];
  int k_lo, k_hi;
  key_range(p, q0, min(q0 + kWideRows, L) - 1, k_lo, k_hi);

  for (int o0 = 0; o0 < D; o0 += kWideChunk) {
    float o[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) o[i] = 0.f;
    float m = -INFINITY, l = 0.f;
    for (int k0 = k_lo / kWideKeys * kWideKeys; k0 <= k_hi; k0 += kWideKeys) {
      for (int d0 = 0; d0 < D; d0 += kWideChunk) {
        float qr[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int d = d0 + c + 4 * i;
          qr[i] = live && d < D ? dd::load_f(qb, (int64_t)row * p.sq[2] + d) : 0.f;
        }
        __syncthreads();  // the previous chunk is consumed
        for (int i = threadIdx.x; i < kWideKeys * kWideChunk; i += kWideThreads) {
          const int kr = i / kWideChunk, d = d0 + i % kWideChunk;
          sKV[kr][i % kWideChunk] =
              k0 + kr < L && d < D ? dd::load_f(kb, (int64_t)(k0 + kr) * p.sk[2] + d) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int jj = 0; jj < kWideKeys; ++jj) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < NP; ++i) acc = fmaf(qr[i], sKV[jj][c + 4 * i], acc);
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          acc += __shfl_xor_sync(0xffffffffu, acc, 2);
          if (c == 0) srow[jj] = (d0 == 0 ? 0.f : srow[jj]) + acc;
        }
      }
      __syncwarp();  // the quad's scores are written
      float mx = m;
#pragma unroll 4
      for (int jj = 0; jj < kWideKeys; ++jj) {
        const float x = visible(p, row, k0 + jj) ? srow[jj] * p.scale_log2 : -INFINITY;
        mx = fmaxf(mx, x);
      }
      const float m_use = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f(m - m_use);
      m = mx;
      l *= alpha;
#pragma unroll
      for (int i = 0; i < NP; ++i) o[i] *= alpha;
      __syncthreads();  // the last K chunk is consumed
      for (int i = threadIdx.x; i < kWideKeys * kWideChunk; i += kWideThreads) {
        const int kr = i / kWideChunk, d = o0 + i % kWideChunk;
        sKV[kr][i % kWideChunk] =
            k0 + kr < L && d < D ? dd::load_f(vb, (int64_t)(k0 + kr) * p.sv[2] + d) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kWideKeys; ++jj) {
        const float x = visible(p, row, k0 + jj) ? srow[jj] * p.scale_log2 : -INFINITY;
        const float pj = exp2f(x - m_use);
        l += pj;
#pragma unroll
        for (int i = 0; i < NP; ++i) o[i] = fmaf(pj, sKV[jj][c + 4 * i], o[i]);
      }
      __syncwarp();  // every thread of the quad has read the scores
    }
    const float inv = l == 0.f ? 0.f : 1.f / l;
    if (live) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int d = o0 + c + 4 * i;
        if (d < D) dd::store_f(ob, (int64_t)row * p.so[2] + d, o[i] * inv);
      }
    }
  }
}

int launch_wide(const Params& p, int B, int is_bf16, cudaStream_t stream) {
  const int blocks = (p.L + kWideRows - 1) / kWideRows * B * p.H;
  if (is_bf16)
    flash_attn_wide_kernel<bf16><<<blocks, kWideThreads, 0, stream>>>(p);
  else
    flash_attn_wide_kernel<float><<<blocks, kWideThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The same contract as dd_flash_attention, for any D (meant for D > 256).
extern "C" int dd_flash_attention_wide(const void* q, const void* k, const void* v, void* o,
                                       const long long* strides, int B, int H, int L, int D,
                                       float scale, int window, int causal, int is_bf16,
                                       void* stream) {
  Params p;
  const int err = make_params(p, q, k, v, o, strides, B, H, L, D, scale, window, causal, is_bf16);
  if (err != 0) return err;
  return launch_wide(p, B, is_bf16, (cudaStream_t)stream);
}
