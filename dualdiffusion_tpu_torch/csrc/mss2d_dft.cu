// K5 mss2d_block_loss and K6 mss2d_block_loss_grad, direct-DFT route: the
// shapes that the FFT kernels of mss2d.cu do not take. Any block width 1 to
// 128, any stride >= 1 (above bw too) and any (bw, bw) window, separable or
// not: what the TPU kernel dualdiffusion_tpu/ops/pallas/mss2d.py
// (_mss2d_kernel, and the backward _mss2d_block_loss_bwd) takes.
//
// sample, target: (BC, H, W) fp32. One thread block per block position (i, j)
// of one image b. With E[m] = e^{-2 pi i m / bw} in shared memory and the
// twiddle index kept as a running sum mod bw (no division):
//   Z[r, v] = sum_c window[r, c] x[i*s + r, j*s + c] E[v c]     (row DFT, v <= bw/2)
//   X[u, v] = sum_r Z[r, v] E[u r]                               (column DFT)
// for the sample into A and the target into B, both (bw, bw/2 + 1) complex
// in shared memory; the threads own the outputs in turn (o = u * bins + v).
// K5 adds weight[u, v] * | |S| - |T| | over the bins, reduces it per block in
// a fixed order into one partial per position, and a second kernel adds an
// image's partials in a fixed order.
//
// K6: G = g * weight * sign(|S| - |T|) * S / |S| (0 where |S| = 0; the target's
// with -sign and T / |T|), then the adjoint of the forward map as written (no
// doubling of half-spectrum bins): Z[r, v] = sum_u G[u, v] conj E[u r] and
// D[r, c] = window[r, c] Re(sum_v Z[r, v] conj E[v c]), written per position
// to scratch P (n_grad, BC, rows, n_cols, bw, bw). A gather kernel then adds,
// for each pixel, the D of the positions covering it, in ascending (i, j).
// The scratch holds `chunk` rows of positions at a time: the launcher walks
// the rows in chunks, the gather adding each chunk's share into d in chunk
// order. No atomics: two calls agree bit for bit.
//
// Cost: 2 bw^2 (bw/2 + 1) complex multiply-adds per tensor and position in
// each direction, where FFTs would take O(bw^2 log bw). The DAE training path
// sends none of these shapes; the route is simple before it is fast.

#include "common.cuh"

namespace {

using dd::cadd;
using dd::cmul;

constexpr int kThreads = 256;
constexpr int kMaxBw = 128;

// Z[r * bins + v] = sum_c win[r, c] img[y0 + r, x0 + c] E[v c mod bw]
__device__ __forceinline__ void row_dft(const float* __restrict__ img, int W, int y0, int x0,
                                        const float* __restrict__ win, const float2* E, int bw,
                                        int bins, float2* Z) {
  for (int o = threadIdx.x; o < bw * bins; o += kThreads) {
    const int r = o / bins, v = o - r * bins;
    const float* row = img + (int64_t)(y0 + r) * W + x0;
    const float* wr = win + r * bw;
    float2 acc = make_float2(0.f, 0.f);
    int m = 0;
    for (int c = 0; c < bw; ++c) {
      const float a = __ldg(row + c) * __ldg(wr + c);
      acc.x += a * E[m].x;
      acc.y += a * E[m].y;
      m += v;
      if (m >= bw) m -= bw;
    }
    Z[o] = acc;
  }
}

// sum_k Z[k * bins + v] E[k p mod bw] (conj E if INV): the column DFT at
// (p, v), or its adjoint
template <bool INV>
__device__ __forceinline__ float2 col_dft(const float2* Z, int p, int v, int bw, int bins,
                                          const float2* E) {
  float2 acc = make_float2(0.f, 0.f);
  int m = 0;
  for (int k = 0; k < bw; ++k) {
    const float2 e = INV ? make_float2(E[m].x, -E[m].y) : E[m];
    acc = cadd(acc, cmul(Z[k * bins + v], e));
    m += p;
    if (m >= bw) m -= bw;
  }
  return acc;
}

__device__ __forceinline__ float cmag(float2 z) { return sqrtf(z.x * z.x + z.y * z.y); }

// The spectra of both tensors' blocks at position (i, j) of image b: the
// sample's into A, the target's into B (Z is scratch).
__device__ __forceinline__ void block_spectra(const float* s, const float* t, int W, int y0,
                                              int x0, const float* win, const float2* E, int bw,
                                              int bins, float2* Z, float2* A, float2* B) {
  const int nb = bw * bins;
  for (int tens = 0; tens < 2; ++tens) {
    row_dft(tens ? t : s, W, y0, x0, win, E, bw, bins, Z);
    __syncthreads();
    float2* X = tens ? B : A;
    for (int o = threadIdx.x; o < nb; o += kThreads) {
      const int u = o / bins;
      X[o] = col_dft<false>(Z, u, o - u * bins, bw, bins, E);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void load_twiddles(const float2* __restrict__ E_g, float2* E, int bw) {
  for (int m = threadIdx.x; m < bw; m += kThreads) E[m] = E_g[m];
  __syncthreads();
}

// K5: partial[b][i * n_cols + j] = sum over bins of weight * | |S| - |T| |
__global__ void __launch_bounds__(kThreads)
mss2d_dft_fwd_kernel(const float* __restrict__ s, const float* __restrict__ t, int H, int W,
                     int bw, int stride, int n_cols, const float2* __restrict__ E_g,
                     const float* __restrict__ win, const float* __restrict__ weight,
                     float* __restrict__ partial) {
  extern __shared__ float2 sm[];
  const int bins = bw / 2 + 1, nb = bw * bins;
  float2 *E = sm, *Z = E + bw, *A = Z + nb, *B = A + nb;
  __shared__ float warp_sums[kThreads / 32];
  const int pos = blockIdx.x, b = blockIdx.y;
  const int i = pos / n_cols, j = pos - i * n_cols;
  const int64_t img = (int64_t)b * H * W;
  load_twiddles(E_g, E, bw);
  block_spectra(s + img, t + img, W, i * stride, j * stride, win, E, bw, bins, Z, A, B);
  float acc = 0.f;
  for (int o = threadIdx.x; o < nb; o += kThreads)
    acc += __ldg(weight + o) * fabsf(cmag(A[o]) - cmag(B[o]));
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    partial[(int64_t)b * gridDim.x + pos] = total;
  }
}

// out[b] = sum of image b's n partials, in a fixed order
__global__ void __launch_bounds__(kThreads)
mss2d_dft_sum_kernel(const float* __restrict__ partial, int64_t n, float* __restrict__ out) {
  __shared__ float sums[kThreads];
  const float* p = partial + (int64_t)blockIdx.x * n;
  float acc = 0.f;
  for (int64_t k = threadIdx.x; k < n; k += kThreads) acc += p[k];
  sums[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = sums[0];
}

// K6, per position: P[tens][b][i - i0][j] = D (bw x bw) of the sample (tens 0)
// and, if n_grad is 2, of the target (tens 1)
__global__ void __launch_bounds__(kThreads)
mss2d_dft_bwd_kernel(const float* __restrict__ s, const float* __restrict__ t,
                     const float* __restrict__ g, int bc, int H, int W, int bw, int stride,
                     int i0, int chunk, int n_cols, int n_grad, const float2* __restrict__ E_g,
                     const float* __restrict__ win, const float* __restrict__ weight,
                     float* __restrict__ P) {
  extern __shared__ float2 sm[];
  const int bins = bw / 2 + 1, nb = bw * bins;
  float2 *E = sm, *Z = E + bw, *A = Z + nb, *B = A + nb;
  const int ci = blockIdx.x / n_cols, j = blockIdx.x - ci * n_cols, b = blockIdx.y;
  const int i = i0 + ci;
  const int64_t img = (int64_t)b * H * W;
  load_twiddles(E_g, E, bw);
  block_spectra(s + img, t + img, W, i * stride, j * stride, win, E, bw, bins, Z, A, B);
  const float gb = __ldg(g + b);
  for (int o = threadIdx.x; o < nb; o += kThreads) {
    const float ms = cmag(A[o]), mt = cmag(B[o]), d = ms - mt;
    const float c = gb * __ldg(weight + o) * (float)((d > 0.f) - (d < 0.f));
    A[o] = ms > 0.f ? make_float2(A[o].x * (c / ms), A[o].y * (c / ms)) : make_float2(0.f, 0.f);
    B[o] = mt > 0.f ? make_float2(B[o].x * (-c / mt), B[o].y * (-c / mt))
                    : make_float2(0.f, 0.f);
  }
  __syncthreads();
  for (int tens = 0; tens < n_grad; ++tens) {
    const float2* G = tens ? B : A;
    for (int o = threadIdx.x; o < nb; o += kThreads) {
      const int r = o / bins;
      Z[o] = col_dft<true>(G, r, o - r * bins, bw, bins, E);
    }
    __syncthreads();
    float* out = P + ((((int64_t)tens * bc + b) * chunk + ci) * n_cols + j) * bw * bw;
    for (int o = threadIdx.x; o < bw * bw; o += kThreads) {
      const int r = o / bw, c = o - r * bw;
      const float2* zr = Z + r * bins;
      float acc = 0.f;
      int m = 0;
      for (int v = 0; v < bins; ++v) {
        acc += zr[v].x * E[m].x + zr[v].y * E[m].y;   // Re(Z conj E)
        m += c;
        if (m >= bw) m -= bw;
      }
      out[o] = __ldg(win + o) * acc;
    }
    __syncthreads();
  }
}

// d[tens][b][y][x] += sum over the positions (i, j) of rows [i0, i1) that cover
// (y, x), ascending, of P[tens][b][i - i0][j][y - i*s][x - j*s]; rows y0 + blockIdx.y
__global__ void __launch_bounds__(128)
mss2d_dft_gather_kernel(const float* __restrict__ P, int bc, int H, int W, int bw, int stride,
                        int i0, int i1, int chunk, int n_cols, int y0, float* __restrict__ d0,
                        float* __restrict__ d1) {
  const int x = blockIdx.x * 128 + threadIdx.x, y = y0 + blockIdx.y;
  const int tens = blockIdx.z / bc, b = blockIdx.z - tens * bc;
  if (x >= W || y >= H) return;
  const int ia = max(i0, y >= bw ? (y - bw + stride) / stride : 0);  // ceil((y - bw + 1) / s)
  const int ib = min(i1 - 1, y / stride);
  const int ja = x >= bw ? (x - bw + stride) / stride : 0;
  const int jb = min(n_cols - 1, x / stride);
  const float* p = P + ((int64_t)tens * bc + b) * chunk * n_cols * bw * bw;
  float acc = 0.f;
  for (int i = ia; i <= ib; ++i)
    for (int j = ja; j <= jb; ++j)
      acc += p[(((int64_t)(i - i0) * n_cols + j) * bw + y - i * stride) * bw + x - j * stride];
  (tens ? d1 : d0)[((int64_t)b * H + y) * W + x] += acc;
}

size_t smem_bytes(int bw) { return (size_t)(bw + 3 * bw * (bw / 2 + 1)) * sizeof(float2); }

bool takes(int bw, int stride, int H, int W) {
  return bw >= 1 && bw <= kMaxBw && stride >= 1 && H >= bw && W >= bw;
}

}  // namespace

// E: the bw twiddles e^{-2 pi i m / bw} (complex fp32); win: (bw, bw);
// weight: (bw, bw/2 + 1). partial: bc x n_rows x n_cols floats of scratch;
// out: (bc,) sums.
extern "C" int dd_mss2d_dft_fwd(const void* s, const void* t, int bc, int H, int W, int bw,
                                int stride, int n_rows, int n_cols, const void* E,
                                const void* win, const void* weight, void* partial, void* out,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!takes(bw, stride, H, W)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bw);
  cudaError_t err = dd_allow_smem(mss2d_dft_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mss2d_dft_fwd_kernel<<<dim3(n_rows * n_cols, bc), kThreads, smem, st>>>(
      (const float*)s, (const float*)t, H, W, bw, stride, n_cols, (const float2*)E,
      (const float*)win, (const float*)weight, (float*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mss2d_dft_sum_kernel<<<bc, kThreads, 0, st>>>((const float*)partial,
                                                (int64_t)n_rows * n_cols, (float*)out);
  return (int)cudaGetLastError();
}

// P: (n_grad, bc, chunk, n_cols, bw, bw) floats of scratch, walked in chunks
// of `chunk` position rows; ds, dt: (bc, H, W), written whole.
extern "C" int dd_mss2d_dft_bwd(const void* s, const void* t, const void* g, int bc, int H,
                                int W, int bw, int stride, int n_rows, int n_cols, int n_grad,
                                int chunk, const void* E, const void* win, const void* weight,
                                void* P, void* ds, void* dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!takes(bw, stride, H, W) || chunk < 1 || n_grad < 1 || n_grad > 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bw);
  cudaError_t err = dd_allow_smem(mss2d_dft_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t plane = (size_t)bc * H * W * sizeof(float);
  err = cudaMemsetAsync(ds, 0, plane, st);
  if (err == cudaSuccess && n_grad == 2) err = cudaMemsetAsync(dt, 0, plane, st);
  if (err != cudaSuccess) return (int)err;
  for (int i0 = 0; i0 < n_rows; i0 += chunk) {
    const int i1 = i0 + chunk < n_rows ? i0 + chunk : n_rows;
    mss2d_dft_bwd_kernel<<<dim3((i1 - i0) * n_cols, bc), kThreads, smem, st>>>(
        (const float*)s, (const float*)t, (const float*)g, bc, H, W, bw, stride, i0, chunk,
        n_cols, n_grad, (const float2*)E, (const float*)win, (const float*)weight, (float*)P);
    const int y0 = i0 * stride, y1 = (i1 - 1) * stride + bw < H ? (i1 - 1) * stride + bw : H;
    mss2d_dft_gather_kernel<<<dim3((W + 127) / 128, y1 - y0, n_grad * bc), 128, 0, st>>>(
        (const float*)P, bc, H, W, bw, stride, i0, i1, chunk, n_cols, y0, (float*)ds,
        (float*)dt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
