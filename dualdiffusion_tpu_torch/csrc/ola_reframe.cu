// K3 ola_reframe: the cross-frame half of one Griffin-Lim iteration.
//
// Replaces dualdiffusion_tpu/ops/pallas/ola_reframe.py (_ola_reframe_kernel
// via ola_reframe) and the time-domain middle of fgla_middle.py /
// fgla_iter.py. On natural-layout frames y (rows of n_fft samples) it
// computes the window -> overlap-add -> 1/envelope -> centre crop -> reflect
// pad -> reframe -> window chain of istft followed by stft:
//   out[t, s] = win[s] * sig(P), P = t*hop + s in the reflect-padded signal,
//   sig(S) = inv_env[S] * sum_u win[S - u*hop] * y[u, S - u*hop].
// It is a gather over the <= ceil(n_fft/hop) frames covering each sample:
// no atomics, so blocks run in any order (the TPU kernel instead carried
// OLA banks across sequential grid steps, which Hopper does not have).
//
// What bounds it on the H100: HBM traffic (one read of y, one write of the
// output, both in the work dtype) plus the L2 traffic of the overlapping
// reads. Design: a block owns a run of `frames_per_block` output frames; it
// builds the padded signal under that run once in shared memory (each signal
// sample gathers its covering frames once), then writes every output sample
// of the run from there. A frame sample is read about
// 1 + n_fft / (frames_per_block * hop) times instead of n_fft / hop times.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ola_reframe_kernel(const T* __restrict__ y, T* __restrict__ out, const float* __restrict__ win,
                   const float* __restrict__ inv_env, int frames, int n, int hop,
                   int frames_per_block) {
  extern __shared__ float sig[];
  const int f0 = blockIdx.x * frames_per_block;
  const int nf = min(frames_per_block, frames - f0);
  const int64_t bc = blockIdx.y;
  const T* yb = y + bc * frames * (int64_t)n;
  const int half = n / 2;
  const int core = (frames - 1) * hop;  // signal length after the centre crop
  const int p0 = f0 * hop;
  const int span = (nf - 1) * hop + n;

  for (int idx = threadIdx.x; idx < span; idx += blockDim.x) {
    int j = p0 + idx - half;  // index into the cropped core
    if (j < 0) j = -j;                         // torch reflect, left edge
    else if (j >= core) j = 2 * (core - 1) - j;  // right edge
    const int s = j + half;                    // index into the OLA'd signal
    const int u_hi = min(frames - 1, s / hop);
    const int u_lo = s >= n ? (s - n) / hop + 1 : 0;
    float acc = 0.f;
    for (int u = u_lo; u <= u_hi; ++u) {
      const int off = s - u * hop;
      acc += __ldg(win + off) * dd::load_f(yb, (int64_t)u * n + off);
    }
    sig[idx] = acc * __ldg(inv_env + s);
  }
  __syncthreads();
  T* ob = out + (bc * frames + f0) * (int64_t)n;
  for (int idx = threadIdx.x; idx < nf * n; idx += blockDim.x) {
    const int fl = idx / n;
    const int s = idx - fl * n;
    dd::store_f(ob, idx, sig[fl * hop + s] * __ldg(win + s));
  }
}

template <typename T>
int launch(const void* y, void* out, const float* win, const float* inv_env, long long bc,
           int frames, int n, int hop, int frames_per_block, cudaStream_t stream) {
  const size_t smem = ((size_t)(frames_per_block - 1) * hop + n) * sizeof(float);
  auto kernel = ola_reframe_kernel<T>;
  cudaError_t err = dd_allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((frames + frames_per_block - 1) / frames_per_block, (unsigned)bc);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)y, (T*)out, win, inv_env, frames, n, hop,
                                           frames_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dd_ola_reframe(const void* y, void* out, const void* win, const void* inv_env,
                              long long bc, int frames, int n, int hop, int frames_per_block,
                              int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(y, out, (const float*)win, (const float*)inv_env, bc, frames, n,
                                 hop, frames_per_block, s);
  return launch<float>(y, out, (const float*)win, (const float*)inv_env, bc, frames, n, hop,
                       frames_per_block, s);
}
