// K3 ola_reframe, Hopper route: one warp a hop chunk, registers only.
//
// Replaces dualdiffusion_tpu/ops/pallas/ola_reframe.py (_ola_reframe_kernel
// via ola_reframe) at hop 256 and n_fft a multiple of 256 (the serving
// paths' 6400 and 4096); every other shape takes csrc/ola_reframe.cu
// (ops/kernels/ola_reframe.py ola_plan routes by shape). It computes what
// that kernel computes: on natural-layout frames y (rows of F frames of n
// samples),
//   out[t, s] = win[s] * padded[t*hop + s],
//   padded    = reflect_pad(sig[n/2 : L - n/2], n/2),  L = (F-1)*hop + n,
//   sig[S]    = inv_env[S] * sum_u win[S - u*hop] * y[u, S - u*hop].
//
// Hop chunks. With R = n/hop, signal chunk k (samples k*hop ... k*hop + 255) is
//   sig_k = inv_env_k * sum_j win_j * y[k-j, chunk j],  0 <= k-j < F,
// and output chunk (t, j) is win_j * padded chunk t+j. Away from the ends
// the crop and the pad cancel: padded chunk k is sig_k wherever
// k*hop >= n/2 and (k+1)*hop <= n/2 + (F-1)*hop. So
//   * a main warp owns one such interior chunk k. Each lane holds 8
//     consecutive samples: it loads the R input chunks that feed them as
//     16-byte vectors (two for fp32), kBatch in flight, sums in fp32
//     registers with the window from L1, scales by inv_env, and writes the
//     R output chunks (k-j, j) that read them as 16-byte stores (evict-first
//     in bf16). Each input sample is read once, each output sample written
//     once; no shared memory, atomics or division by the hop;
//   * the E = ceil(R/2) padded chunks at each end of a row touch the reflect
//     zones (for odd R the chunk holding n/2 is half reflected, half
//     interior, and is theirs). One edge block a row, at the lowest block
//     indices so that it runs in the first wave, recomputes the E + 1 signal
//     chunks that each end's reflection reads into its row of a global
//     scratch (one range where the two ends meet, so no input is read more
//     than twice; a few KB that stay in L2, so the main blocks carry no
//     shared memory and registers alone set their occupancy), then
//     writes those padded chunks' output samples one by one through the
//     reflect index map of csrc/ola_reframe.cu. Taking them out saves
//     about 1 % of a bf16 call and 2-3 % of an fp32 one at the serving
//     shape on an H100 80GB HBM3 (scripts/k3_ablation.py).
//
// What bounds it on the H100: device-memory bytes, y read once and out
// written once (281.8 MB a call at B*C 2, F 5504, n 6400 in bf16), plus the
// L1-resident window and inv_env read once.

#include <climits>

#include "common.cuh"

namespace ola_hopper {

constexpr int kHop = 256;           // a hop chunk: 32 lanes x 8 samples
constexpr int kWarps = 8;           // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 8;           // input chunks a lane has in flight
static_assert(kHop == 32 * 8, "a lane holds 8 samples of a chunk");

// Chunk counts of a frame of R hop chunks (ops/kernels/ola_reframe.py chunk_counts).
__host__ __device__ constexpr int edge_chunks(int r) { return (r + 1) / 2; }
__host__ __device__ constexpr int edge_signal_chunks(int r) { return edge_chunks(r) + 1; }
__host__ __device__ constexpr int interior_chunks(int r, int frames) {
  return frames - 1 + r - 2 * edge_chunks(r);
}
// the serving paths' shapes
static_assert(edge_chunks(25) == 13 && edge_signal_chunks(25) == 14, "n_fft 6400");
static_assert(interior_chunks(25, 5504) == 5502, "n_fft 6400, F 5504");
static_assert(edge_chunks(16) == 8 && edge_signal_chunks(16) == 9, "n_fft 4096");
static_assert(interior_chunks(16, 5504) == 5503, "n_fft 4096, F 5504");

// 8 consecutive samples of the work dtype, moved as 16-byte vectors.
template <typename T> struct Vec8;

template <> struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldcs(reinterpret_cast<const float4*>(p));
    b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void unpack(float (&v)[8]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <> struct Vec8<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void unpack(float (&v)[8]) const {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    // evict-first: 0.1135 against 0.1353 ms a call at the serving shape on
    // an H100 80GB HBM3; fp32's pair of stores runs 2 % slower so
    // (scripts/k3_ablation.py)
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

__device__ __forceinline__ void load8(const float* __restrict__ p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// A lane's 8 samples (from tau) of signal chunk k of the row yb.
template <typename T>
__device__ __forceinline__ void signal_chunk(const T* __restrict__ yb,
                                             const float* __restrict__ win,
                                             const float* __restrict__ inv_env, int k,
                                             int frames, int n, int r, int tau,
                                             float (&acc)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  const int j_lo = max(0, k - frames + 1), j_hi = min(r - 1, k);
  // y[k-j, j*hop + tau] lies at k*n + tau - j*(n - hop)
  const T* src = yb + (int64_t)k * n + tau;
  const int step = n - kHop;
  for (int j0 = j_lo; j0 <= j_hi; j0 += kBatch) {
    Vec8<T> v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (j0 + q <= j_hi) v[q].load(src - (int64_t)(j0 + q) * step);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (j0 + q <= j_hi) {
        float x[8], w[8];
        v[q].unpack(x);
        load8(win + (j0 + q) * kHop + tau, w);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(w[e], x[e], acc[e]);
      }
    }
  }
  float ie[8];
  load8(inv_env + (int64_t)k * kHop + tau, ie);
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] *= ie[e];
}

// The R output chunks (k-j, j) that read interior padded chunk k = sig_k.
template <typename T>
__device__ __forceinline__ void write_chunk(T* __restrict__ ob, const float* __restrict__ win,
                                            const float (&sig)[8], int k, int frames, int n,
                                            int r, int tau) {
  const int j_lo = max(0, k - frames + 1), j_hi = min(r - 1, k);
  T* dst = ob + (int64_t)k * n + tau;
  const int step = n - kHop;
  for (int j = j_lo; j <= j_hi; ++j) {
    float w[8];
    load8(win + j * kHop + tau, w);
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] *= sig[e];
    Vec8<T>::store(dst - (int64_t)j * step, w);
  }
}

// One row's 2E edge padded chunks: their signal chunks into the row's
// scratch sig (2 (E + 1) chunks; written and read by this block only), then
// every output sample that reads them.
template <typename T>
__device__ void edge_row(const T* __restrict__ yb, T* __restrict__ ob,
                         const float* __restrict__ win, const float* __restrict__ inv_env,
                         int frames, int n, int r, float* sig) {
  const int warp = threadIdx.x >> 5, tau = (threadIdx.x & 31) * 8;
  const int half = n / 2, core = (frames - 1) * kHop, e = edge_chunks(r);
  const int total = frames - 1 + r;  // padded chunks of the row
  // the signal chunks the reflections read: [lo0, lo1] at the left end,
  // [hi0, hi1] at the right, hi0 lifted past lo1 where the two meet
  const int lo0 = r / 2, lo1 = r;
  const int hi0 = max(frames - 2, lo1 + 1), hi1 = frames - 1 + (half - 1) / kHop;
  const int n_lo = lo1 - lo0 + 1, n_sig = n_lo + max(0, hi1 - hi0 + 1);
  for (int c = warp; c < n_sig; c += kWarps) {
    float acc[8];
    signal_chunk(yb, win, inv_env, c < n_lo ? lo0 + c : hi0 + c - n_lo, frames, n, r, tau, acc);
    float4* d = reinterpret_cast<float4*>(sig + c * kHop + tau);
    d[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    d[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();
  for (int i = 0; i < 2 * e; ++i) {
    const int k = i < e ? i : total - 2 * e + i;
    const int j_lo = max(0, k - frames + 1), j_hi = min(r - 1, k);
    for (int s = threadIdx.x; s < kHop; s += kThreads) {  // sample s of the chunk
      int jc = k * kHop + s - half;  // index into the cropped core, reflected
      if (jc < 0) jc = -jc;
      else if (jc >= core) jc = 2 * (core - 1) - jc;
      const unsigned src = jc + half;  // the signal sample it reads
      const int c = src / kHop;
      const float v = sig[(c <= lo1 ? c - lo0 : n_lo + c - hi0) * kHop + src % kHop];
      for (int j = j_lo; j <= j_hi; ++j)
        dd::store_f(ob, (int64_t)(k - j) * n + j * kHop + s, __ldg(win + j * kHop + s) * v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ola_reframe_hopper_kernel(const T* __restrict__ y, T* __restrict__ out,
                          const float* __restrict__ win, const float* __restrict__ inv_env,
                          float* scratch, int rows, int frames, int n) {
  const int r = n / kHop;
  const int64_t row = (int64_t)frames * n;
  if ((int)blockIdx.x < rows) {  // the edge blocks, one a row
    edge_row(y + blockIdx.x * row, out + blockIdx.x * row, win, inv_env, frames, n, r,
             scratch + (int64_t)blockIdx.x * 2 * edge_signal_chunks(r) * kHop);
    return;
  }
  const int ni = interior_chunks(r, frames);
  const int g = ((int)blockIdx.x - rows) * kWarps + (threadIdx.x >> 5);
  if (g >= rows * ni) return;
  const int b = g / ni, k = edge_chunks(r) + g % ni;
  const int tau = (threadIdx.x & 31) * 8;
  float acc[8];
  signal_chunk(y + b * row, win, inv_env, k, frames, n, r, tau, acc);
  write_chunk(out + b * row, win, acc, k, frames, n, r, tau);
}

template <typename T>
int launch(const void* y, void* out, const float* win, const float* inv_env, float* scratch,
           long long rows, int frames, int n, cudaStream_t stream) {
  const int r = n / kHop;
  const long long items = rows * interior_chunks(r, frames);
  const long long blocks = rows + (items + kWarps - 1) / kWarps;
  if (n % kHop || r < 1 || items < 0 || items > INT_MAX - kWarps || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  ola_reframe_hopper_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)y, (T*)out, win, inv_env, scratch, (int)rows, frames, n);
  return (int)cudaGetLastError();
}

}  // namespace ola_hopper

// scratch: rows x 2 (E + 1) x hop fp32, 16-byte aligned (the edge blocks' signal chunks).
extern "C" int dd_ola_reframe_hopper(const void* y, void* out, const void* win,
                                     const void* inv_env, void* scratch, long long rows,
                                     int frames, int n, int is_bf16, void* stream) {
  using namespace ola_hopper;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(y, out, (const float*)win, (const float*)inv_env,
                                 (float*)scratch, rows, frames, n, s);
  return launch<float>(y, out, (const float*)win, (const float*)inv_env, (float*)scratch, rows,
                       frames, n, s);
}

// The compiled plan for frames of n samples, F = frames: {R, E, E + 1,
// interior chunks, hop, warps a block}; returns 0 if n is not a multiple of the hop.
extern "C" int dd_ola_reframe_hopper_plan(int n, int frames, int* out) {
  using namespace ola_hopper;
  if (n % kHop) return 0;
  const int r = n / kHop;
  const int vals[6] = {r, edge_chunks(r), edge_signal_chunks(r), interior_chunks(r, frames), kHop,
                       kWarps};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 1;
}
