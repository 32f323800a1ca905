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
// tens of MB). This first version computes both stages as direct DFTs with
// register tiling, which is about 7x (bw 32) to 9x (bw 64) the arithmetic of a
// radix-2 FFT; an FFT of stage 2 is the next step. Design: one thread block
// per (image, column block j) walks down the column, PI block positions at a
// time, keeping the stage-1 rows of the bw + (PI-1)*s rows under the current
// positions in a ring in shared memory, so every (row, j) is transformed once
// and the input is read once per column block. In stage 2 a thread owns 4 k
// x 2 l bins of one position, for both tensors, reading 4 twiddles and 2 + 2
// stage-1 values per row (16-byte loads, no bank conflicts). K5 writes one
// partial sum per (image, j); a second pass adds them per image in a fixed
// order. No atomics anywhere: the result is deterministic.
//
// K6: with G = g * weight * sign(|S| - |T|) * S / |S| (0 where |S| = 0), the
// gradient is Re(Fr^H G conj(Fc)) summed over the blocks covering a pixel (the
// adjoint of the forward map as written: no doubling of half-spectrum bins).
// K6a recomputes S and T as K5 does, forms G in shared memory, applies
// Fr^H (Q_ij[r, l] = w1[r] sum_k e^{+2 pi i k r / bw} G[k, l]) and sums Q_ij
// over the positions covering each row in a ring, in position order; a row
// complete after a step is written out as Q_j[y, l]. K6b then gathers, for each
// pixel x of a row, Re(sum_l Q_j[y, l] w1[c] e^{+2 pi i l c / bw}), c = x - j*s,
// over the column blocks j covering x, in ascending j. dTarget (-sign, T/|T|)
// is computed only when asked for.

#include "common.cuh"

namespace {

template <int BW>
struct Dims {
  static constexpr int kBins = BW / 2 + 1;
  static constexpr int kBinsP = kBins + 1;         // padded to an even count
  static constexpr int kKG = BW / 4;               // groups of 4 k (or r) per position
  static constexpr int kLG = kBinsP / 2;           // pairs of l per position
  static constexpr int kTPP = kKG * kLG;           // threads per block position
};

// Shared-memory carve-up shared by K5 and K6a (all offsets in float2 units).
template <int BW, int PI>
struct Smem {
  int stride, ring, new_rows, n_grad;
  __device__ __host__ Smem(int s, int n_grad_) : stride(s), n_grad(n_grad_) {
    ring = BW + (PI - 1) * s;
    new_rows = PI * s;
  }
  __device__ __host__ size_t e_off() const { return 0; }
  __device__ __host__ size_t w1_off() const { return (size_t)BW * BW; }
  __device__ __host__ size_t ain_off() const { return w1_off() + BW; }          // float rows
  __device__ __host__ size_t p_off() const { return ain_off() + (size_t)new_rows * BW; }
  __device__ __host__ size_t g_off() const {
    return p_off() + 2 * (size_t)ring * Dims<BW>::kBinsP;
  }
  __device__ __host__ size_t q_off() const {
    return g_off() + (size_t)n_grad * PI * BW * Dims<BW>::kBinsP;
  }
  __device__ __host__ size_t bytes(bool backward) const {
    return (backward ? q_off() + (size_t)n_grad * ring * Dims<BW>::kBinsP : g_off()) *
           sizeof(float2);
  }
};

// Loads rows [y0, y0 + cnt) of both images' column block (windowed along c)
// and writes their stage-1 transforms into the ring.
template <int BW>
__device__ void stage1_rows(const float* __restrict__ s_img, const float* __restrict__ t_img,
                            int y0, int cnt, int H, int W, int x0, int ring, const float2* E,
                            const float* w1, float* ain, float2* P) {
  using D = Dims<BW>;
  const int n_load = 2 * cnt * BW;
  for (int idx = threadIdx.x; idx < n_load; idx += blockDim.x) {
    const int tens = idx / (cnt * BW);
    const int rem = idx - tens * cnt * BW;
    const int row = rem / BW, c = rem - row * BW;
    const int y = y0 + row;
    const float* img = tens ? t_img : s_img;
    // ain holds 2 x cnt rows; the caller keeps cnt <= new_rows
    ain[idx] = y < H ? __ldg(img + (int64_t)y * W + x0 + c) * w1[c] : 0.f;
  }
  __syncthreads();
  const int n_out = 2 * cnt * D::kBinsP;
  for (int idx = threadIdx.x; idx < n_out; idx += blockDim.x) {
    const int tens = idx / (cnt * D::kBinsP);
    const int rem = idx - tens * cnt * D::kBinsP;
    const int row = rem / D::kBinsP, l = rem - row * D::kBinsP;
    float2 acc = make_float2(0.f, 0.f);
    if (l < D::kBins) {
      const float* a = ain + (tens * cnt + row) * BW;
#pragma unroll 8
      for (int c = 0; c < BW; ++c) {
        const float2 e = E[c * BW + l];  // e^{-2 pi i l c / BW}
        acc.x += a[c] * e.x;
        acc.y += a[c] * e.y;
      }
    }
    P[((size_t)tens * ring + (y0 + row) % ring) * D::kBinsP + l] = acc;
  }
  __syncthreads();
}

// Brings the ring up to date for rows < target.
template <int BW>
__device__ void fill_ring(const float* s_img, const float* t_img, int& filled, int target, int H,
                          int W, int x0, int ring, int new_rows, const float2* E, const float* w1,
                          float* ain, float2* P) {
  while (filled < target) {
    const int cnt = min(new_rows, target - filled);
    stage1_rows<BW>(s_img, t_img, filled, cnt, H, W, x0, ring, E, w1, ain, P);
    filled += cnt;
  }
}

// Stage 2 of one block position: S and T for this thread's 4 k x 2 l bins.
template <int BW>
__device__ __forceinline__ void stage2(int i, int stride, int ring, int kg, int lg,
                                       const float2* E, const float* w1, const float2* P,
                                       float2 (&S)[4][2], float2 (&T)[4][2]) {
  using D = Dims<BW>;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) S[m][n] = T[m][n] = make_float2(0.f, 0.f);
  const float2* Ps = P;
  const float2* Pt = P + (size_t)ring * D::kBinsP;
  int slot = (i * stride) % ring;
#pragma unroll 4
  for (int r = 0; r < BW; ++r) {
    const float4 e01 = *reinterpret_cast<const float4*>(E + r * BW + 4 * kg);
    const float4 e23 = *reinterpret_cast<const float4*>(E + r * BW + 4 * kg + 2);
    const float2 e[4] = {make_float2(e01.x, e01.y), make_float2(e01.z, e01.w),
                         make_float2(e23.x, e23.y), make_float2(e23.z, e23.w)};
    const float wr = w1[r];
    const float4 ps = *reinterpret_cast<const float4*>(Ps + slot * D::kBinsP + 2 * lg);
    const float4 pt = *reinterpret_cast<const float4*>(Pt + slot * D::kBinsP + 2 * lg);
    const float2 vs[2] = {make_float2(ps.x * wr, ps.y * wr), make_float2(ps.z * wr, ps.w * wr)};
    const float2 vt[2] = {make_float2(pt.x * wr, pt.y * wr), make_float2(pt.z * wr, pt.w * wr)};
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        S[m][n].x += e[m].x * vs[n].x - e[m].y * vs[n].y;
        S[m][n].y += e[m].x * vs[n].y + e[m].y * vs[n].x;
        T[m][n].x += e[m].x * vt[n].x - e[m].y * vt[n].y;
        T[m][n].y += e[m].x * vt[n].y + e[m].y * vt[n].x;
      }
    if (++slot == ring) slot = 0;
  }
}

template <int BW>
__device__ void load_tables(const float2* __restrict__ E_g, const float* __restrict__ w1_g,
                            float2* E, float* w1) {
  for (int idx = threadIdx.x; idx < BW * BW; idx += blockDim.x) E[idx] = E_g[idx];
  for (int idx = threadIdx.x; idx < BW; idx += blockDim.x) w1[idx] = w1_g[idx];
}

__device__ __forceinline__ float cabs(float2 z) { return sqrtf(z.x * z.x + z.y * z.y); }

// K5: one partial sum per (image, column block).
template <int BW, int PI>
__global__ void __launch_bounds__(PI * Dims<BW>::kTPP)
mss2d_fwd_kernel(const float* __restrict__ sample, const float* __restrict__ target, int H, int W,
                 int stride, int n_rows, int n_cols, const float2* __restrict__ E_g,
                 const float* __restrict__ w1_g, const float* __restrict__ weight,
                 float* __restrict__ partial) {
  using D = Dims<BW>;
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const Smem<BW, PI> L(stride, 0);
  float2* E = smem + L.e_off();
  float* w1 = reinterpret_cast<float*>(smem + L.w1_off());
  float* ain = reinterpret_cast<float*>(smem + L.ain_off());
  float2* P = smem + L.p_off();
  const int j = blockIdx.x, b = blockIdx.y;
  const float* s_img = sample + (int64_t)b * H * W;
  const float* t_img = target + (int64_t)b * H * W;
  const int x0 = j * stride;
  load_tables<BW>(E_g, w1_g, E, w1);
  __syncthreads();

  const int pi = threadIdx.x / D::kTPP;
  const int rem = threadIdx.x - pi * D::kTPP;
  const int kg = rem % D::kKG, lg = rem / D::kKG;
  float loss = 0.f;
  int filled = 0;
  for (int i0 = 0; i0 < n_rows; i0 += PI) {
    fill_ring<BW>(s_img, t_img, filled, min(i0 * stride + L.ring, H), H, W, x0, L.ring,
                  L.new_rows, E, w1, ain, P);
    const int i = i0 + pi;
    if (i < n_rows) {
      float2 S[4][2], T[4][2];
      stage2<BW>(i, stride, L.ring, kg, lg, E, w1, P, S, T);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int k = 4 * kg + m, l = 2 * lg + n;
          if (l < D::kBins)
            loss += __ldg(weight + k * D::kBins + l) * fabsf(cabs(S[m][n]) - cabs(T[m][n]));
        }
    }
    __syncthreads();  // the next fill overwrites ring rows of this step
  }

  // fixed-order block reduction (the ring is free now)
  float* red = reinterpret_cast<float*>(P);
  red[threadIdx.x] = loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int t = 0; t < (int)blockDim.x; ++t) total += red[t];
    partial[(int64_t)b * n_cols + j] = total;
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

// K6a: the row-summed Fr^H G of every column block, Q[tens][b][y][j][l].
template <int BW, int PI>
__global__ void __launch_bounds__(PI * Dims<BW>::kTPP)
mss2d_bwd_cols_kernel(const float* __restrict__ sample, const float* __restrict__ target,
                      const float* __restrict__ g, int bc, int H, int W, int stride, int n_rows,
                      int n_cols, int n_grad, const float2* __restrict__ E_g,
                      const float* __restrict__ w1_g, const float* __restrict__ weight,
                      float2* __restrict__ Q) {
  using D = Dims<BW>;
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const Smem<BW, PI> L(stride, n_grad);
  float2* E = smem + L.e_off();
  float* w1 = reinterpret_cast<float*>(smem + L.w1_off());
  float* ain = reinterpret_cast<float*>(smem + L.ain_off());
  float2* P = smem + L.p_off();
  float2* G = smem + L.g_off();    // [n_grad][PI][BW][kBinsP]
  float2* Qr = smem + L.q_off();   // [n_grad][ring][kBinsP]
  const int j = blockIdx.x, b = blockIdx.y;
  const float* s_img = sample + (int64_t)b * H * W;
  const float* t_img = target + (int64_t)b * H * W;
  const int x0 = j * stride;
  load_tables<BW>(E_g, w1_g, E, w1);
  for (int idx = threadIdx.x; idx < n_grad * L.ring * D::kBinsP; idx += blockDim.x)
    Qr[idx] = make_float2(0.f, 0.f);
  __syncthreads();

  const int pi = threadIdx.x / D::kTPP;
  const int rem = threadIdx.x - pi * D::kTPP;
  const int kg = rem % D::kKG, lg = rem / D::kKG;
  const float gb = g[b];
  const int covered = (n_rows - 1) * stride + BW;  // rows under some block
  int filled = 0;
  for (int i0 = 0; i0 < n_rows; i0 += PI) {
    fill_ring<BW>(s_img, t_img, filled, min(i0 * stride + L.ring, H), H, W, x0, L.ring,
                  L.new_rows, E, w1, ain, P);
    const int i = i0 + pi;
    const bool valid = i < n_rows;
    // G = g * weight * sign(|S| - |T|) * (S/|S|, -T/|T|), into shared memory
    {
      float2 S[4][2], T[4][2];
      if (valid) stage2<BW>(i, stride, L.ring, kg, lg, E, w1, P, S, T);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int k = 4 * kg + m, l = 2 * lg + n;
          float2 gs = make_float2(0.f, 0.f), gt = gs;
          if (valid && l < D::kBins) {
            const float ms = cabs(S[m][n]), mt = cabs(T[m][n]);
            const float d = ms - mt;
            const float c = gb * __ldg(weight + k * D::kBins + l) * (float)((d > 0.f) - (d < 0.f));
            if (ms > 0.f) gs = make_float2(c * S[m][n].x / ms, c * S[m][n].y / ms);
            if (mt > 0.f) gt = make_float2(-c * T[m][n].x / mt, -c * T[m][n].y / mt);
          }
          G[((size_t)pi * BW + k) * D::kBinsP + l] = gs;
          if (n_grad > 1) G[(((size_t)PI + pi) * BW + k) * D::kBinsP + l] = gt;
        }
    }
    __syncthreads();
    // Q_i[r, l] = w1[r] sum_k conj(E[k][r]) G[k][l]; this thread: 4 r x 2 l
    for (int tens = 0; tens < n_grad; ++tens) {
      float2 q[4][2];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) q[m][n] = make_float2(0.f, 0.f);
      const float2* Gp = G + ((size_t)tens * PI + pi) * BW * D::kBinsP;
      if (valid) {
#pragma unroll 4
        for (int k = 0; k < BW; ++k) {
          const float4 e01 = *reinterpret_cast<const float4*>(E + k * BW + 4 * kg);
          const float4 e23 = *reinterpret_cast<const float4*>(E + k * BW + 4 * kg + 2);
          const float2 e[4] = {make_float2(e01.x, e01.y), make_float2(e01.z, e01.w),
                               make_float2(e23.x, e23.y), make_float2(e23.z, e23.w)};
          const float4 gg = *reinterpret_cast<const float4*>(Gp + k * D::kBinsP + 2 * lg);
          const float2 gv[2] = {make_float2(gg.x, gg.y), make_float2(gg.z, gg.w)};
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int n = 0; n < 2; ++n) {  // conj(e) * g
              q[m][n].x += e[m].x * gv[n].x + e[m].y * gv[n].y;
              q[m][n].y += e[m].x * gv[n].y - e[m].y * gv[n].x;
            }
        }
      }
      // add into the row ring, one position after another (fixed order)
      float2* Qt = Qr + (size_t)tens * L.ring * D::kBinsP;
      for (int pp = 0; pp < PI; ++pp) {
        if (pp == pi && valid) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int r = 4 * kg + m;
            const float wr = w1[r];
            float2* row = Qt + ((i * stride + r) % L.ring) * D::kBinsP + 2 * lg;
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              row[n].x += q[m][n].x * wr;
              row[n].y += q[m][n].y * wr;
            }
          }
        }
        __syncthreads();
      }
    }
    // rows no later position covers are complete: write them out, clear the slots
    const bool last = i0 + PI >= n_rows;
    const int y_lo = i0 * stride, y_hi = last ? H : min((i0 + PI) * stride, H);
    const int n_out = n_grad * (y_hi - y_lo) * D::kBinsP;
    for (int idx = threadIdx.x; idx < n_out; idx += blockDim.x) {
      const int tens = idx / ((y_hi - y_lo) * D::kBinsP);
      const int rem2 = idx - tens * (y_hi - y_lo) * D::kBinsP;
      const int y = y_lo + rem2 / D::kBinsP, l = rem2 % D::kBinsP;
      float2 v = make_float2(0.f, 0.f);
      if (y < covered) {
        float2* slot = Qr + ((size_t)tens * L.ring + y % L.ring) * D::kBinsP + l;
        v = *slot;
        *slot = make_float2(0.f, 0.f);
      }
      Q[((((size_t)tens * bc + b) * H + y) * n_cols + j) * D::kBinsP + l] = v;
    }
    __syncthreads();
  }
}

// K6b: d[tens][b][y][x] = sum_{j covering x} w1[c] Re(sum_l Q[y][j][l] e^{+2 pi i l c / BW}).
template <int BW>
__global__ void __launch_bounds__(128)
mss2d_bwd_rows_kernel(const float2* __restrict__ Q, int bc, int H, int W, int stride, int n_cols,
                      const float2* __restrict__ E_g, const float* __restrict__ w1_g,
                      float* __restrict__ d0, float* __restrict__ d1) {
  using D = Dims<BW>;
  constexpr int kX = 128;
  extern __shared__ float4 smem4[];
  float2* tw = reinterpret_cast<float2*>(smem4);        // e^{-2 pi i m / BW}
  float* w1 = reinterpret_cast<float*>(tw + BW);
  float2* qs = tw + BW + BW / 2;                          // [j - j_lo][kBinsP]
  const int x0 = blockIdx.x * kX, y = blockIdx.y;
  const int tens = blockIdx.z / bc, b = blockIdx.z - tens * bc;
  const int j_lo = max(0, (x0 - BW + stride) / stride);   // ceil((x0 - BW + 1) / s), x0 >= 0
  const int j_hi = min(n_cols - 1, (x0 + kX - 1) / stride);
  for (int idx = threadIdx.x; idx < BW; idx += blockDim.x) {
    tw[idx] = E_g[BW + idx];
    w1[idx] = w1_g[idx];
  }
  const int nq = (j_hi - j_lo + 1) * D::kBinsP;
  const float2* Qrow = Q + (((size_t)tens * bc + b) * H + y) * n_cols * D::kBinsP;
  for (int idx = threadIdx.x; idx < nq; idx += blockDim.x)
    qs[idx] = Qrow[(size_t)j_lo * D::kBinsP + idx];
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  const int ja = max(j_lo, x >= BW ? (x - BW + stride) / stride : 0);
  const int jb = min(j_hi, x / stride);
  float acc = 0.f;
  for (int jj = ja; jj <= jb; ++jj) {
    const int c = x - jj * stride;
    const float2* q = qs + (jj - j_lo) * D::kBinsP;
    float sum = 0.f;
#pragma unroll 4
    for (int l = 0; l < D::kBins; ++l) {
      const float2 e = tw[(l * c) & (BW - 1)];
      sum += q[l].x * e.x + q[l].y * e.y;  // Re(q * conj(e))
    }
    acc += w1[c] * sum;
  }
  (tens ? d1 : d0)[((int64_t)b * H + y) * W + x] = acc;
}

template <int BW, int PI>
int launch_fwd(const float* s, const float* t, int bc, int H, int W, int stride, int n_rows,
               int n_cols, const float2* E, const float* w1, const float* weight, float* partial,
               float* out, cudaStream_t stream) {
  const size_t smem = Smem<BW, PI>(stride, 0).bytes(false);
  auto kernel = mss2d_fwd_kernel<BW, PI>;
  cudaError_t err = dd_allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_cols, bc), PI * Dims<BW>::kTPP, smem, stream>>>(s, t, H, W, stride, n_rows,
                                                                   n_cols, E, w1, weight, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(bc + 127) / 128, 128, 0, stream>>>(partial, n_cols, bc, out);
  return (int)cudaGetLastError();
}

template <int BW, int PI>
int launch_bwd(const float* s, const float* t, const float* g, int bc, int H, int W, int stride,
               int n_rows, int n_cols, int n_grad, const float2* E, const float* w1,
               const float* weight, float2* Q, float* ds, float* dt, cudaStream_t stream) {
  const size_t smem = Smem<BW, PI>(stride, n_grad).bytes(true);
  auto kernel = mss2d_bwd_cols_kernel<BW, PI>;
  cudaError_t err = dd_allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_cols, bc), PI * Dims<BW>::kTPP, smem, stream>>>(
      s, t, g, bc, H, W, stride, n_rows, n_cols, n_grad, E, w1, weight, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int max_j = (127 + BW) / stride + 2;
  const size_t smem2 = (BW + BW / 2 + (size_t)max_j * Dims<BW>::kBinsP) * sizeof(float2);
  auto rows = mss2d_bwd_rows_kernel<BW>;
  err = dd_allow_smem(rows, smem2);
  if (err != cudaSuccess) return (int)err;
  rows<<<dim3((W + 127) / 128, H, n_grad * bc), 128, smem2, stream>>>(Q, bc, H, W, stride,
                                                                      n_cols, E, w1, ds, dt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dd_mss2d_fwd(const void* s, const void* t, int bc, int H, int W, int bw, int stride,
                            int n_rows, int n_cols, const void* E, const void* w1,
                            const void* weight, void* partial, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bw == 64)
    return launch_fwd<64, 1>((const float*)s, (const float*)t, bc, H, W, stride, n_rows, n_cols,
                             (const float2*)E, (const float*)w1, (const float*)weight,
                             (float*)partial, (float*)out, st);
  if (bw == 32)
    return launch_fwd<32, 4>((const float*)s, (const float*)t, bc, H, W, stride, n_rows, n_cols,
                             (const float2*)E, (const float*)w1, (const float*)weight,
                             (float*)partial, (float*)out, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dd_mss2d_bwd(const void* s, const void* t, const void* g, int bc, int H, int W,
                            int bw, int stride, int n_rows, int n_cols, int n_grad, const void* E,
                            const void* w1, const void* weight, void* Q, void* ds, void* dt,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bw == 64)
    return launch_bwd<64, 1>((const float*)s, (const float*)t, (const float*)g, bc, H, W, stride,
                             n_rows, n_cols, n_grad, (const float2*)E, (const float*)w1,
                             (const float*)weight, (float2*)Q, (float*)ds, (float*)dt, st);
  if (bw == 32)
    return launch_bwd<32, 4>((const float*)s, (const float*)t, (const float*)g, bc, H, W, stride,
                             n_rows, n_cols, n_grad, (const float2*)E, (const float*)w1,
                             (const float*)weight, (float2*)Q, (float*)ds, (float*)dt, st);
  return (int)cudaErrorInvalidValue;
}
