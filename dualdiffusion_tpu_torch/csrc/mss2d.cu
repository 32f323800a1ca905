// K5 mss2d_block_loss and K6 mss2d_block_loss_grad: one block width of the
// fused 2-D multi-scale spectral loss, and its gradient.
//
// Replaces dualdiffusion_tpu/ops/pallas/mss2d.py: the forward _mss2d_kernel
// (via mss2d_block_loss / _mss2d_block_loss_fwd_impl) and the custom-VJP
// backward _mss2d_block_loss_bwd, which on the TPU recomputes the loss strip
// by strip under jax.vjp in a scan.
//
// sample, target: (BC, H, W) fp32, already reflect-padded by bw/2. For every
// block position (i, j) on a stride grid, both bw x bw blocks are windowed by
// the separable window w1[r] * w1[c] and 2-D DFT'd (full along H, the real half
// along W, bw x (bw/2 + 1) bins), and the loss sums
//   weight[k, l] * | |S_ij[k, l]| - |T_ij[k, l]| |
// over bins and positions into one fp32 value per image.
//
// The DFT factors through the rows: X_ij = Fr . A[i*s : i*s+bw, j*s : j*s+bw] . Fc^T
// with Fr[k, r] = w1[r] e^{-2 pi i k r / bw}, Fc[l, c] = w1[c] e^{-2 pi i l c / bw}.
// Stage 1, P_j[y, l] = sum_c A[y, j*s + c] Fc[l, c], depends on the image row
// y and the column block j only, so it is shared by the bw/s block positions
// that cover a row. Stage 2 is X_ij[k, l] = sum_r Fr[k, r] P_j[i*s + r, l].
//
// What bounds it on the H100: fp32 arithmetic (the inputs are read once, a few
// tens of MB). Direct DFTs in both stages would take about 12x the
// arithmetic of FFTs. Here every transform is a bw-point complex FFT
// held in registers by N2 = bw/8 threads of 8 points each (MSS2D_PLANS in
// ops/kernels/mss2d.py is the same plan, and tests/test_torch_mss2d_plan.py
// models it): thread t holds points t + N2 n1, runs a radix-8 codelet
// (fft.cuh), multiplies by W_bw^(t k1), trades points with the FFT's other
// threads through the FFT's own padded slice of shared memory (entry
// k1 (N2 + 1) + n2; the threads of an FFT share a warp, so __syncwarp
// suffices), and then owns bins k1 + 8 k2 for k1 = t + N2 m, on which it runs
// radix-N2 codelets. The inverse (adjoint) runs the same steps backwards.
//
// A thread block walks JB neighbouring column blocks down the image, one block
// position of each per step, with one __syncthreads a step. Its threads have
// two roles:
// - producers (JB * bw/8 FFTs), a step ahead: stage 1 of the new rows, one
//   complex FFT of w1[c] (sample + i target) per (row, column block) into a
//   ring of bw + stride rows in shared memory, so each (row, j) is transformed
//   once and the input is read once per column block. The Hermitian split of
//   the two tensors' spectra, P_s[l] = (Z[l] + conj Z[-l]) / 2 and
//   P_t[l] = (Z[l] - conj Z[-l]) / 2i, happens where stage 2 reads the ring.
// - consumers (JB * (bw/2 + 1) FFTs, one per bin column l): stage 2, the FFT
//   over r of w1[r] P[i*s + r, l] for S and for T, then the loss (K5) or G
//   (K6) on the bins each thread holds. K5 keeps one running sum per thread,
//   reduced per block in a fixed order; a second pass adds the blocks' sums
//   per image in a fixed order.
//
// K6: with G = g * weight * sign(|S| - |T|) * S / |S| (0 where |S| = 0), the
// gradient is Re(Fr^H G conj(Fc)) summed over the blocks covering a pixel (the
// adjoint of the forward map as written: no doubling of half-spectrum bins).
// The consumers' inverse FFT over k gives Q_i[r, l] = w1[r] sum_k
// e^{+2 pi i k r / bw} G[k, l], which they add into a second ring of bw +
// stride rows; in a step one thread writes a cell, so each row sums its
// positions in position order. The step after a row's last position, the
// producers apply the W adjoint, D_j[y, c] = w1[c] Re(sum_{l <= bw/2} Q[y, l]
// e^{+2 pi i l c / bw}), as one inverse FFT of Q's Hermitian extension per
// tensor (so d_sample is the same with or without dTarget), and write D_j.
// K6b adds, for each pixel, D_j of the column blocks covering it, in ascending
// j. dTarget (-sign, T/|T|) is computed only when asked for. No atomics: two
// calls agree bit for bit.

#include "fft.cuh"

namespace {

using namespace dd_fft;

// N2: threads of one FFT (radices 8 and N2); JB: column blocks a thread
// block walks; ZS, QS: row strides (complex) of the stage-1 and gradient
// rings; XS: complex slots of one FFT's exchange slice. The strides keep
// every shared access at most 2-way bank-conflicted.
template <int BW> struct Plan;
template <> struct Plan<64> {
  static constexpr int N2 = 8, JB = 1, ZS = 66, QS = 34, XS = 72;
};
template <> struct Plan<32> {
  static constexpr int N2 = 4, JB = 4, ZS = 36, QS = 20, XS = 44;
};

template <int BW> struct Shape : Plan<BW> {
  using PL = Plan<BW>;
  static constexpr int N2 = PL::N2, JB = PL::JB;
  static constexpr int kBins = BW / 2 + 1;
  static constexpr int kOwn = 8 / N2;                   // k1 values a thread owns
  static constexpr int kProd = JB * (BW / 8) * N2;      // producer threads
  static constexpr int kCons = JB * kBins * N2;         // consumer threads
  static constexpr int kThreads = kProd + kCons;
  static constexpr int kGroups = kThreads / N2;         // FFTs in flight
  static_assert(N2 * 8 == BW && kProd % 32 == 0, "an FFT's threads share a warp");
};

// Shared memory (float2 units): JB stage-1 rings, the FFTs' exchange slices,
// n_grad x JB gradient rings. A ring holds bw + stride rows.
template <int BW> struct Smem {
  using SH = Shape<BW>;
  int ring, n_grad;
  __host__ __device__ Smem(int stride, int n_grad_) : ring(BW + stride), n_grad(n_grad_) {}
  __host__ __device__ size_t x_off() const { return (size_t)SH::JB * ring * SH::ZS; }
  __host__ __device__ size_t q_off() const { return x_off() + (size_t)SH::kGroups * SH::XS; }
  __host__ __device__ size_t bytes() const {
    return (q_off() + (size_t)n_grad * SH::JB * ring * SH::QS) * sizeof(float2);
  }
};

// What a thread keeps for its FFTs.
template <int BW> struct Lane {
  using SH = Shape<BW>;
  int t;           // its index in the FFT
  unsigned mask;   // the FFT's lanes
  float2* xb;      // the FFT's exchange slice
  float2 tw[8];    // W_bw^(t k1)
  float w1[8];     // w1[N2 n1 + t]

  __device__ Lane(float2* xbase, const float2* __restrict__ E_g, const float* __restrict__ w1_g) {
    t = threadIdx.x % SH::N2;
    mask = ((1u << SH::N2) - 1) << ((threadIdx.x & 31) & ~(SH::N2 - 1));
    xb = xbase + (threadIdx.x / SH::N2) * SH::XS;
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1) tw[k1] = __ldg(E_g + (t * k1) % BW);  // E[m] = W_bw^m
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1) w1[n1] = __ldg(w1_g + SH::N2 * n1 + t);
  }
  // the bin held in a[e] after fft_fwd (and read by fft_inv)
  __device__ __forceinline__ int bin(int e) const {
    return t + SH::N2 * (e / SH::N2) + 8 * (e % SH::N2);
  }
};

// Forward FFT: a[n1] = x[N2 n1 + t] in, a[e] = X[ln.bin(e)] out.
template <int BW>
__device__ __forceinline__ void fft_fwd(float2 (&a)[8], const Lane<BW>& ln) {
  using SH = Shape<BW>;
  constexpr int N2 = SH::N2;
  dft<8, false>(a);
#pragma unroll
  for (int k1 = 0; k1 < 8; ++k1) ln.xb[k1 * (N2 + 1) + ln.t] = dd::cmul(a[k1], ln.tw[k1]);
  __syncwarp(ln.mask);
#pragma unroll
  for (int m = 0; m < SH::kOwn; ++m) {
    float2 b[N2];
#pragma unroll
    for (int n2 = 0; n2 < N2; ++n2) b[n2] = ln.xb[(ln.t + N2 * m) * (N2 + 1) + n2];
    dft<N2, false>(b);
#pragma unroll
    for (int k2 = 0; k2 < N2; ++k2) a[m * N2 + k2] = b[k2];
  }
  __syncwarp(ln.mask);
}

// Its adjoint, the unscaled inverse: a[e] = X[ln.bin(e)] in,
// a[n1] = sum_k X[k] e^{+2 pi i k r / bw} at r = N2 n1 + t out.
template <int BW>
__device__ __forceinline__ void fft_inv(float2 (&a)[8], const Lane<BW>& ln) {
  using SH = Shape<BW>;
  constexpr int N2 = SH::N2;
#pragma unroll
  for (int m = 0; m < SH::kOwn; ++m) {
    float2 b[N2];
#pragma unroll
    for (int k2 = 0; k2 < N2; ++k2) b[k2] = a[m * N2 + k2];
    dft<N2, true>(b);
#pragma unroll
    for (int n2 = 0; n2 < N2; ++n2) ln.xb[(ln.t + N2 * m) * (N2 + 1) + n2] = b[n2];
  }
  __syncwarp(ln.mask);
#pragma unroll
  for (int k1 = 0; k1 < 8; ++k1) {
    const float2 w = ln.tw[k1];
    a[k1] = dd::cmul(ln.xb[k1 * (N2 + 1) + ln.t], make_float2(w.x, -w.y));
  }
  dft<8, true>(a);
  __syncwarp(ln.mask);
}

// Stage 1 of image row y of the column block at x0 into its ring row.
template <int BW>
__device__ __forceinline__ void stage1_row(const Lane<BW>& ln, const float* __restrict__ s_img,
                                           const float* __restrict__ t_img, int y, int W, int x0,
                                           float2* zrow) {
  constexpr int N2 = Shape<BW>::N2;
  const int64_t off = (int64_t)y * W + x0 + ln.t;
  float2 a[8];
#pragma unroll
  for (int n1 = 0; n1 < 8; ++n1)
    a[n1] = make_float2(__ldg(s_img + off + N2 * n1) * ln.w1[n1],
                        __ldg(t_img + off + N2 * n1) * ln.w1[n1]);
  fft_fwd<BW>(a, ln);
#pragma unroll
  for (int e = 0; e < 8; ++e) zrow[ln.bin(e)] = a[e];
}

// Stage 2 of bin column l at the position whose first row is in ring slot
// base: S and T on this thread's bins.
template <int BW>
__device__ __forceinline__ void stage2(const Lane<BW>& ln, const float2* zring, int base, int ring,
                                       int l, float2 (&S)[8], float2 (&T)[8]) {
  using SH = Shape<BW>;
  const int lm = l ? BW - l : 0;
#pragma unroll
  for (int n1 = 0; n1 < 8; ++n1) {
    int sl = base + SH::N2 * n1 + ln.t;
    if (sl >= ring) sl -= ring;
    const float2 z1 = zring[sl * SH::ZS + l], z2 = zring[sl * SH::ZS + lm];
    const float h = 0.5f * ln.w1[n1];
    S[n1] = make_float2(h * (z1.x + z2.x), h * (z1.y - z2.y));   // (z1 + conj z2) / 2
    T[n1] = make_float2(h * (z1.y + z2.y), h * (z2.x - z1.x));   // (z1 - conj z2) / 2i
  }
  fft_fwd<BW>(S, ln);
  fft_fwd<BW>(T, ln);
}

// The Hermitian extension of a half spectrum q at bin l (q read at l or
// bw - l), halved off the ends: its inverse FFT is Re(sum_{l <= bw/2} ...).
template <int BW>
__device__ __forceinline__ float2 herm(float2 q, int l) {
  if (l == 0 || l == BW / 2) return make_float2(q.x, 0.f);
  return l < BW / 2 ? make_float2(0.5f * q.x, 0.5f * q.y) : make_float2(0.5f * q.x, -0.5f * q.y);
}

// K6: the W adjoint of one tensor's finished gradient-ring row q (bw/2 + 1
// bins), written to D_j[y] (bw floats at d); clears the row.
template <int BW>
__device__ __forceinline__ void finalize_row(const Lane<BW>& ln, float2* q, float* d) {
  using SH = Shape<BW>;
  float2 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int l = ln.bin(e);
    v[e] = herm<BW>(q[l <= BW / 2 ? l : BW - l], l);
  }
  __syncwarp(ln.mask);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (ln.bin(e) <= BW / 2) q[ln.bin(e)] = make_float2(0.f, 0.f);
  fft_inv<BW>(v, ln);
#pragma unroll
  for (int n1 = 0; n1 < 8; ++n1) d[SH::N2 * n1 + ln.t] = ln.w1[n1] * v[n1].x;
}

__device__ __forceinline__ float cabs(float2 z) { return sqrtf(z.x * z.x + z.y * z.y); }

// K5 (BWD false): one partial sum per (image, thread block) into partial.
// K6a (BWD true): D[tens][b][y][j][c] for the rows some position covers.
template <int BW, bool BWD>
__global__ void __launch_bounds__(Shape<BW>::kThreads, 2)
mss2d_kernel(const float* __restrict__ sample, const float* __restrict__ target,
             const float* __restrict__ g, int bc, int H, int W, int stride, int n_rows,
             int n_cols, int n_grad, const float2* __restrict__ E_g,
             const float* __restrict__ w1_g, const float* __restrict__ weight,
             float* __restrict__ partial, float* __restrict__ D) {
  using SH = Shape<BW>;
  constexpr int N2 = SH::N2, JB = SH::JB;
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const Smem<BW> L(stride, BWD ? n_grad : 0);
  const int ring = L.ring;
  float2* Z = smem;
  float2* Qr = smem + L.q_off();
  const int b = blockIdx.y, j0 = blockIdx.x * JB;
  const float* s_img = sample + (int64_t)b * H * W;
  const float* t_img = target + (int64_t)b * H * W;
  const Lane<BW> ln(smem + L.x_off(), E_g, w1_g);
  const int group = threadIdx.x / N2;

  // K6: row y of column block jj is finished: D_j[y] of each tensor
  auto finalize = [&](int jj, int y) {
    for (int tens = 0; tens < n_grad; ++tens)
      finalize_row<BW>(ln, Qr + (((size_t)tens * JB + jj) * ring + y % ring) * SH::QS,
                       D + (((((int64_t)tens * bc + b) * H + y) * n_cols + j0 + jj) * BW));
  };

  if (BWD)
    for (int idx = threadIdx.x; idx < n_grad * JB * ring * SH::QS; idx += SH::kThreads)
      Qr[idx] = make_float2(0.f, 0.f);
  // rows 0 .. bw-1 of every column block, all threads
  for (int job = group; job < JB * BW; job += SH::kGroups) {
    const int jj = job / BW, y = job - jj * BW;
    if (j0 + jj < n_cols)
      stage1_row<BW>(ln, s_img, t_img, y, W, (j0 + jj) * stride,
                     Z + ((size_t)jj * ring + y) * SH::ZS);
  }
  __syncthreads();

  const bool producer = threadIdx.x < SH::kProd;
  const int cidx = threadIdx.x - SH::kProd;
  const int cjj = cidx / (SH::kBins * N2);
  const int l = (cidx / N2) % SH::kBins;
  const bool consumer = !producer && j0 + cjj < n_cols;
  const float gb = BWD ? g[b] : 0.f;
  float loss = 0.f;
  for (int i = 0; i < n_rows; ++i) {
    if (producer) {
      constexpr int kPG = SH::kProd / N2;
      // the rows position i + 1 adds, then (K6) the rows position i - 1 finished
      if (i + 1 < n_rows)
        for (int job = group; job < JB * stride; job += kPG) {
          const int jj = job / stride, y = i * stride + BW + job - jj * stride;
          if (j0 + jj < n_cols)
            stage1_row<BW>(ln, s_img, t_img, y, W, (j0 + jj) * stride,
                           Z + ((size_t)jj * ring + y % ring) * SH::ZS);
        }
      if (BWD && i > 0)
        for (int job = group; job < JB * stride; job += kPG) {
          const int jj = job / stride;
          if (j0 + jj < n_cols) finalize(jj, (i - 1) * stride + job - jj * stride);
        }
    } else if (consumer) {
      const int base = (i * stride) % ring;
      float2 S[8], T[8];
      stage2<BW>(ln, Z + (size_t)cjj * ring * SH::ZS, base, ring, l, S, T);
      if (!BWD) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          loss += __ldg(weight + ln.bin(e) * SH::kBins + l) * fabsf(cabs(S[e]) - cabs(T[e]));
      } else {
        // G for sample (in S) and target (in T), then Q = w1[r] Fr^H G
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float ms = cabs(S[e]), mt = cabs(T[e]);
          const float d = ms - mt;
          const float c =
              gb * __ldg(weight + ln.bin(e) * SH::kBins + l) * (float)((d > 0.f) - (d < 0.f));
          S[e] = ms > 0.f ? make_float2(c * S[e].x / ms, c * S[e].y / ms) : make_float2(0.f, 0.f);
          T[e] = mt > 0.f ? make_float2(-c * T[e].x / mt, -c * T[e].y / mt)
                          : make_float2(0.f, 0.f);
        }
        auto add_rows = [&](float2(&G)[8], int tens) {
          fft_inv<BW>(G, ln);
          float2* q = Qr + ((size_t)tens * JB + cjj) * ring * SH::QS + l;
#pragma unroll
          for (int n1 = 0; n1 < 8; ++n1) {
            int sl = base + N2 * n1 + ln.t;
            if (sl >= ring) sl -= ring;
            float2 v = q[sl * SH::QS];
            v.x += ln.w1[n1] * G[n1].x;
            v.y += ln.w1[n1] * G[n1].y;
            q[sl * SH::QS] = v;
          }
        };
        add_rows(S, 0);
        if (n_grad > 1) add_rows(T, 1);
      }
    }
    __syncthreads();
  }

  if (BWD) {
    // the rows of the last position, all threads
    for (int job = group; job < JB * BW; job += SH::kGroups) {
      const int jj = job / BW;
      if (j0 + jj < n_cols) finalize(jj, (n_rows - 1) * stride + job - jj * BW);
    }
  } else {
    // fixed-order block reduction (the rings are free now)
    float* red = reinterpret_cast<float*>(smem);
    red[threadIdx.x] = loss;
    __syncthreads();
    if (threadIdx.x < 32) {
      float v = 0.f;
      for (int k = threadIdx.x; k < SH::kThreads; k += 32) v += red[k];
#pragma unroll
      for (int off = 16; off; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (threadIdx.x == 0) partial[(int64_t)b * gridDim.x + blockIdx.x] = v;
    }
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ partial, int n, int bc,
                                    float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= bc) return;
  float total = 0.f;
  for (int j = 0; j < n; ++j) total += partial[(int64_t)b * n + j];
  out[b] = total;
}

// K6b: d[tens][b][y][x] = sum over the column blocks j covering x, ascending,
// of D[tens][b][y][j][x - j*s]; 0 on rows and columns no block covers.
template <int BW>
__global__ void __launch_bounds__(128)
mss2d_bwd_rows_kernel(const float* __restrict__ D, int bc, int H, int W, int stride, int n_rows,
                      int n_cols, float* __restrict__ d0, float* __restrict__ d1) {
  const int x = blockIdx.x * 128 + threadIdx.x, y = blockIdx.y;
  const int tens = blockIdx.z / bc, b = blockIdx.z - tens * bc;
  if (x >= W) return;
  float acc = 0.f;
  if (y < (n_rows - 1) * stride + BW) {
    const int ja = x >= BW ? (x - BW + stride) / stride : 0;  // ceil((x - BW + 1) / s)
    const int jb = min(n_cols - 1, x / stride);
    const float* row = D + (((int64_t)tens * bc + b) * H + y) * n_cols * BW;
    for (int j = ja; j <= jb; ++j) acc += row[(int64_t)j * BW + x - j * stride];
  }
  (tens ? d1 : d0)[((int64_t)b * H + y) * W + x] = acc;
}

template <int BW, bool BWD>
cudaError_t launch_main(const float* s, const float* t, const float* g, int bc, int H, int W,
                        int stride, int n_rows, int n_cols, int n_grad, const float2* E,
                        const float* w1, const float* weight, float* partial, float* D,
                        cudaStream_t stream) {
  using SH = Shape<BW>;
  const size_t smem = Smem<BW>(stride, BWD ? n_grad : 0).bytes();
  auto kernel = mss2d_kernel<BW, BWD>;
  cudaError_t err = dd_allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n_cols + SH::JB - 1) / SH::JB, bc), SH::kThreads, smem, stream>>>(
      s, t, g, bc, H, W, stride, n_rows, n_cols, n_grad, E, w1, weight, partial, D);
  return cudaGetLastError();
}

template <int BW>
int launch_fwd(const float* s, const float* t, int bc, int H, int W, int stride, int n_rows,
               int n_cols, const float2* E, const float* w1, const float* weight, float* partial,
               float* out, cudaStream_t stream) {
  cudaError_t err = launch_main<BW, false>(s, t, nullptr, bc, H, W, stride, n_rows, n_cols, 0, E,
                                           w1, weight, partial, nullptr, stream);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_cols + Shape<BW>::JB - 1) / Shape<BW>::JB;
  sum_partials_kernel<<<(bc + 127) / 128, 128, 0, stream>>>(partial, blocks, bc, out);
  return (int)cudaGetLastError();
}

template <int BW>
int launch_bwd(const float* s, const float* t, const float* g, int bc, int H, int W, int stride,
               int n_rows, int n_cols, int n_grad, const float2* E, const float* w1,
               const float* weight, float* D, float* ds, float* dt, cudaStream_t stream) {
  cudaError_t err = launch_main<BW, true>(s, t, g, bc, H, W, stride, n_rows, n_cols, n_grad, E,
                                          w1, weight, nullptr, D, stream);
  if (err != cudaSuccess) return (int)err;
  mss2d_bwd_rows_kernel<BW><<<dim3((W + 127) / 128, H, n_grad * bc), 128, 0, stream>>>(
      D, bc, H, W, stride, n_rows, n_cols, ds, dt);
  return (int)cudaGetLastError();
}

template <int BW>
void plan_of(int* out) {
  using PL = Plan<BW>;
  const int v[] = {PL::N2, PL::JB, PL::ZS, PL::QS, PL::XS};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
}

}  // namespace

// E: the bw twiddles e^{-2 pi i m / bw} (complex fp32); w1: the window's
// 1-D factor; weight: (bw, bw/2 + 1). partial: bc x ceil(n_cols / JB)
// floats of scratch; out: (bc,) sums.
extern "C" int dd_mss2d_fwd(const void* s, const void* t, int bc, int H, int W, int bw, int stride,
                            int n_rows, int n_cols, const void* E, const void* w1,
                            const void* weight, void* partial, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (stride < 1 || stride > bw) return (int)cudaErrorInvalidValue;
  if (bw == 64)
    return launch_fwd<64>((const float*)s, (const float*)t, bc, H, W, stride, n_rows, n_cols,
                          (const float2*)E, (const float*)w1, (const float*)weight,
                          (float*)partial, (float*)out, st);
  if (bw == 32)
    return launch_fwd<32>((const float*)s, (const float*)t, bc, H, W, stride, n_rows, n_cols,
                          (const float2*)E, (const float*)w1, (const float*)weight,
                          (float*)partial, (float*)out, st);
  return (int)cudaErrorInvalidValue;
}

// Q: (n_grad, bc, H, n_cols, bw) floats of scratch (D_j); ds, dt: (bc, H, W).
extern "C" int dd_mss2d_bwd(const void* s, const void* t, const void* g, int bc, int H, int W,
                            int bw, int stride, int n_rows, int n_cols, int n_grad, const void* E,
                            const void* w1, const void* weight, void* Q, void* ds, void* dt,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (stride < 1 || stride > bw) return (int)cudaErrorInvalidValue;
  if (bw == 64)
    return launch_bwd<64>((const float*)s, (const float*)t, (const float*)g, bc, H, W, stride,
                          n_rows, n_cols, n_grad, (const float2*)E, (const float*)w1,
                          (const float*)weight, (float*)Q, (float*)ds, (float*)dt, st);
  if (bw == 32)
    return launch_bwd<32>((const float*)s, (const float*)t, (const float*)g, bc, H, W, stride,
                          n_rows, n_cols, n_grad, (const float2*)E, (const float*)w1,
                          (const float*)weight, (float*)Q, (float*)ds, (float*)dt, st);
  return (int)cudaErrorInvalidValue;
}

// The compiled plan of block width bw (MSS2D_PLANS): threads an FFT, column
// blocks a thread block, stage-1 ring row stride, gradient ring row stride,
// exchange slots an FFT, into out[0..4]; returns 1 if bw has one.
extern "C" int dd_mss2d_plan(int bw, int* out) {
  if (bw == 64) {
    plan_of<64>(out);
    return 1;
  }
  if (bw == 32) {
    plan_of<32>(out);
    return 1;
  }
  return 0;
}
