// K2 fgla_frame: the per-frame half of one Griffin-Lim iteration.
//
// Replaces the spectral and DFT parts of dualdiffusion_tpu/ops/pallas/
// fgla_iter.py (_kernel via fgla_iter), which also carry
// fgla_spectral.py (_spectral_kernel) and the DFT stages of fgla_middle.py.
// For one (b, c, frame) it computes, from the reframed windowed frame:
//   r_{k+1} = rfft(frame)                      (stored in the work dtype)
//   n       = r_{k+1} - mom * r_k
//   ang     = n / (|n| + 1e-12)
//   x       = ang * (merged + relu(t) * (spec - merged))
//   y       = irfft(x)                          (next iteration's time frame)
// A seed call takes the spectrum (the initial phases) in place of a frame.
//
// What bounds it on the H100: shared-memory bandwidth of the two n-point
// DFTs (6400 points at the production n_fft), not HBM: a frame is read and
// written once (2 x 12.8 KB in bf16) while each DFT stage sweeps the frame
// in shared memory. Design: one block per frame holds the whole frame in
// dynamic shared memory and runs a self-sorting Stockham mixed-radix FFT in
// place of the TPU kernel's two-stage 50 x 128 matmul DFT. The frame is
// real, so each real n-point DFT is one complex n/2-point DFT of the
// even/odd sample pairs plus a split step that pairs bins k and n/2 - k:
// half the butterflies, and two ping-pong buffers of n/2 complex fp32
// (2 x 25.6 KB at n = 6400), so four blocks share an SM. Radix 4 and 2 are
// hand-written butterflies; any other prime radix runs a small direct DFT.
// Twiddles come from one n-entry table in global memory (L1/L2 resident).
// Every arithmetic step is fp32; state is stored in the work dtype.

#include "fgla.cuh"

namespace {

constexpr int kMaxRadices = 32;
constexpr int kThreads = 256;

struct Plan {
  int n;
  int count;
  int r[kMaxRadices];
};

__device__ __forceinline__ float2 twiddle(const float2* __restrict__ table, int t, bool inv) {
  float2 w = __ldg(table + t);
  if (inv) w.y = -w.y;
  return w;
}

// Stockham autosort FFT of size plan.n over `a` using `b` as scratch;
// returns the buffer that holds the naturally ordered result. Sign -1
// (forward) unless inv. The table holds exp(-2 pi i t / (2 plan.n)).
__device__ float2* fft_smem(float2* a, float2* b, const float2* __restrict__ table,
                            const Plan& plan, bool inv) {
  const int n = plan.n;
  int p = 1;
  for (int s = 0; s < plan.count; ++s) {
    const int r = plan.r[s];
    const int m = n / r;
    const int stride = n / (p * r);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int k = i % p;
      const int base = (i - k) * r + k;
      if (r == 4) {
        float2 x0 = a[i], x1 = a[i + m], x2 = a[i + 2 * m], x3 = a[i + 3 * m];
        if (k) {
          x1 = dd::cmul(x1, twiddle(table, 2 * k * stride, inv));
          x2 = dd::cmul(x2, twiddle(table, 4 * k * stride, inv));
          x3 = dd::cmul(x3, twiddle(table, 6 * k * stride, inv));
        }
        const float2 s02 = dd::cadd(x0, x2), d02 = dd::csub(x0, x2);
        const float2 s13 = dd::cadd(x1, x3), d13 = dd::csub(x1, x3);
        // W4 * d13 with W4 = -i (forward) or +i (inverse)
        const float2 wd = inv ? make_float2(-d13.y, d13.x) : make_float2(d13.y, -d13.x);
        b[base] = dd::cadd(s02, s13);
        b[base + p] = dd::cadd(d02, wd);
        b[base + 2 * p] = dd::csub(s02, s13);
        b[base + 3 * p] = dd::csub(d02, wd);
      } else if (r == 2) {
        const float2 x0 = a[i];
        float2 x1 = a[i + m];
        if (k) x1 = dd::cmul(x1, twiddle(table, 2 * k * stride, inv));
        b[base] = dd::cadd(x0, x1);
        b[base + p] = dd::csub(x0, x1);
      } else {
        // direct radix-r DFT; the combined twiddle of input j into output q
        // is W_n^{j (k + q p) stride}
        for (int q = 0; q < r; ++q) {
          const int kq = k + q * p;
          float2 acc = make_float2(0.f, 0.f);
          for (int j = 0; j < r; ++j)
            acc = dd::cadd(acc, dd::cmul(a[i + j * m], twiddle(table, 2 * ((j * kq * stride) % n), inv)));
          b[base + q * p] = acc;
        }
      }
    }
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
    p *= r;
  }
  return a;
}

// plan is for the half size m = n/2; bins = m + 1
template <typename T>
__global__ void __launch_bounds__(kThreads)
fgla_frame_kernel(const T* __restrict__ frames, const T* __restrict__ r_in,
                  const T* __restrict__ r_prev, T* __restrict__ r_out, T* __restrict__ y_out,
                  const T* __restrict__ spec, const T* __restrict__ merged,
                  const float2* __restrict__ table, Plan plan, float t, float mom) {
  extern __shared__ float2 smem[];
  const int m = plan.n;
  const int n = 2 * m;
  float2* buf_a = smem;
  float2* buf_b = smem + m;
  const int64_t row = blockIdx.x;
  const int64_t rb = row * (m + 1);

  const float2* spectrum = nullptr;
  if (frames) {
    const T* fr = frames + row * n;
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      buf_a[i] = make_float2(dd::load_f(fr, 2 * i), dd::load_f(fr, 2 * i + 1));
    __syncthreads();
    spectrum = fft_smem(buf_a, buf_b, table, plan, false);
  }
  float2* x_buf = (spectrum == buf_a) ? buf_b : buf_a;

  const float tt = t > 0.f ? t : 0.f;
  // r (bin k of the new forward spectrum) -> x (bin k of the next iterate)
  auto step = [&](int k, float2 r) {
    const int64_t e = rb + k;
    if (frames) {
      r = make_float2(dd::round_to<T>(r.x), dd::round_to<T>(r.y));
      if (r_out) {
        dd::store_f(r_out, 2 * e, r.x);
        dd::store_f(r_out, 2 * e + 1, r.y);
      }
    }
    if (r_prev) {
      r.x -= mom * dd::load_f(r_prev, 2 * e);
      r.y -= mom * dd::load_f(r_prev, 2 * e + 1);
    }
    const float mag = sqrtf(r.x * r.x + r.y * r.y) + 1e-12f;
    const float mg = dd::load_f(merged, e);
    const float interp = mg + (dd::load_f(spec, e) - mg) * tt;
    float2 x = make_float2(r.x / mag * interp, r.y / mag * interp);
    if (k == 0 || k == m) x.y = 0.f;  // irfft reads only the real part there
    return x;
  };
  // bins k and j = m - k share their split/merge inputs: one thread does both
  for (int k = threadIdx.x; k <= m / 2; k += blockDim.x) {
    const int j = m - k;
    float2 rk, rj;
    if (frames) {
      const float2 zk = spectrum[k], zj = spectrum[j == m ? 0 : j];
      rk = split_bin(zk, zj, twiddle(table, k, false));
      rj = split_bin(zj, zk, twiddle(table, j, false));
    } else {
      rk = make_float2(dd::load_f(r_in, 2 * (rb + k)), dd::load_f(r_in, 2 * (rb + k) + 1));
      rj = make_float2(dd::load_f(r_in, 2 * (rb + j)), dd::load_f(r_in, 2 * (rb + j) + 1));
    }
    const float2 xk = step(k, rk);
    const float2 xj = j != k ? step(j, rj) : xk;
    x_buf[k] = merge_bin(xk, xj, twiddle(table, k, true));
    if (j < m && j != k) x_buf[j] = merge_bin(xj, xk, twiddle(table, j, true));
  }
  if (!y_out) return;  // uniform across the block
  __syncthreads();
  float2* scratch = (x_buf == buf_a) ? buf_b : buf_a;
  const float2* res = fft_smem(x_buf, scratch, table, plan, true);
  const float scale = 1.f / (float)m;
  T* yo = y_out + row * n;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    dd::store_f(yo, 2 * i, res[i].x * scale);
    dd::store_f(yo, 2 * i + 1, res[i].y * scale);
  }
}

template <typename T>
int launch(const void* frames, const void* r_in, const void* r_prev, void* r_out, void* y_out,
           const void* spec, const void* merged, const void* table, const Plan& plan,
           long long rows, float t, float mom, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)plan.n * sizeof(float2);
  auto kernel = fgla_frame_kernel<T>;
  cudaError_t err = dd_allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)rows, kThreads, smem, stream>>>(
      (const T*)frames, (const T*)r_in, (const T*)r_prev, (T*)r_out, (T*)y_out, (const T*)spec,
      (const T*)merged, (const float2*)table, plan, t, mom);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dd_fgla_frame(const void* frames, const void* r_in, const void* r_prev, void* r_out,
                             void* y_out, const void* spec, const void* merged, const void* table,
                             const int* radices, int n_radices, long long rows, int n, float t,
                             float mom, int is_bf16, void* stream) {
  // radices factor n / 2, the size of the complex DFTs
  if (n % 2 || n_radices > kMaxRadices) return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.n = n / 2;
  plan.count = n_radices;
  for (int i = 0; i < n_radices; ++i) plan.r[i] = radices[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(frames, r_in, r_prev, r_out, y_out, spec, merged, table, plan,
                                 rows, t, mom, s);
  return launch<float>(frames, r_in, r_prev, r_out, y_out, spec, merged, table, plan, rows, t,
                       mom, s);
}

extern "C" const char* dd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
