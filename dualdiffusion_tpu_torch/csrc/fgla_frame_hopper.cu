// K2 fgla_frame on Hopper: the per-frame half of one Griffin-Lim iteration
// at the sizes of the serving paths (n_fft 6400 and 4096).
//
// Replaces, as csrc/fgla_frame.cu does for other sizes, the spectral and DFT
// parts of dualdiffusion_tpu/ops/pallas/fgla_iter.py (_kernel via fgla_iter),
// with fgla_spectral.py (_spectral_kernel) and the DFT stages of
// fgla_middle.py. It computes exactly what fgla_frame.cu computes: the real
// forward DFT of a frame (stored in the work dtype), n = r - mom * r_prev,
// n / (|n| + 1e-12) times merged + relu(t) (spec - merged), the imaginary
// part zeroed at bins 0 and m, and the real inverse DFT scaled by 1/m.
//
// What bounds it on the H100: HBM bytes (a frame, its previous spectrum and
// two magnitude rows in, a spectrum and a frame out: 64 KB per bf16 frame at
// n_fft 6400), with the fp32 FLOPs of the two transforms at about a third
// of that time. The Stockham kernel of fgla_frame.cu is held back by six
// shared-memory sweeps per transform with strided writes, direct radix-5
// DFTs with scattered twiddle loads and modulos, and uneven rounds.
//
// Design: the complex m-point DFT (m = n/2) of a frame's (even, odd) sample
// pairs runs as three Stockham passes whose radices multiply to m (40, 10, 8
// at m = 3200; 32, 8, 8 at m = 2048). In each pass a thread loads P points
// (40 or 32) from shared memory into registers, multiplies them by the
// pass's twiddles (a table per pass, in shared memory, filled once per block
// from the fp64-built global table), runs P/R radix-R butterflies on them
// and writes them back once. The butterflies are unrolled codelets (radix 2,
// 4 and 5 by hand, larger radices composed of them; csrc/fft.cuh) whose inner
// twiddles are compile-time constants. Every index inside a pass divides by compile-time
// constants only. A frame is m/P threads; four frames share a block, and
// a persistent grid (as many blocks as the SMs hold) fills the pass tables
// once per block and walks the groups of four frames. The
// shared buffers are padded by one complex every 32, which keeps every
// exchange between passes at most 2-way bank-conflicted (the plan's numpy
// model in tests/test_torch_fgla_plan.py counts them). Frames are read and
// written with 16-byte vector accesses through shared memory; the real-FFT
// split, the spectral step and the merge run in one sweep between the two
// transforms, reading each of r_prev, spec and merged and writing r once.
// Every arithmetic step is fp32; state is stored in the work dtype.

#include <algorithm>

#include "fft.cuh"
#include "fgla.cuh"

namespace {

using namespace dd_fft;

template <int M> struct HopperPlan;
// m = 3200 (n_fft 6400): 80 threads a frame, 40 points each
template <> struct HopperPlan<3200> {
  static constexpr int P = 40, T = 80, FPB = 4, R0 = 40, R1 = 10, R2 = 8;
};
// m = 2048 (n_fft 4096): 64 threads a frame, 32 points each
template <> struct HopperPlan<2048> {
  static constexpr int P = 32, T = 64, FPB = 4, R0 = 32, R1 = 8, R2 = 8;
};

// shared-memory slot of complex point e: one pad slot every 32
__device__ __forceinline__ int slot(int e) { return e + (e >> 5); }

// One Stockham pass of radix R after passes whose radices multiply to PP:
// butterfly i (k = i mod PP) takes points i + j m/R, multiplies point j by
// W_(PP R)^(j k) (tw[(j - 1) PP + k]), and writes output q to
// (i - k) R + k + q PP. Thread t of a frame owns butterflies t + T u.
template <class PL, int M, int R, int PP, bool INV>
__device__ __forceinline__ void pass(float2* buf, const float2* tw, int t) {
  constexpr int NB = PL::P / R, S = M / R;
  float2 v[NB][R];
#pragma unroll
  for (int u = 0; u < NB; ++u)
#pragma unroll
    for (int j = 0; j < R; ++j) v[u][j] = buf[slot(t + PL::T * u + j * S)];
  __syncthreads();
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int i = t + PL::T * u;
    const int k = i % PP;
    if constexpr (PP > 1) {
#pragma unroll
      for (int j = 1; j < R; ++j) {
        float2 w = tw[(j - 1) * PP + k];
        if (INV) w.y = -w.y;
        v[u][j] = dd::cmul(v[u][j], w);
      }
    }
    dft<R, INV>(v[u]);
    const int base = (i - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) buf[slot(base + q * PP)] = v[u][q];
  }
  __syncthreads();
}

template <class PL, int M, bool INV>
__device__ __forceinline__ void fft(float2* buf, const float2* tw1, const float2* tw2, int t) {
  pass<PL, M, PL::R0, 1, INV>(buf, nullptr, t);
  pass<PL, M, PL::R1, PL::R0, INV>(buf, tw1, t);
  pass<PL, M, PL::R2, PL::R0 * PL::R1, INV>(buf, tw2, t);
}

// a complex pair of the work dtype
__device__ __forceinline__ float2 load2(const float* p, int64_t e) {
  return *reinterpret_cast<const float2*>(p + 2 * e);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, int64_t e) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + 2 * e));
}
__device__ __forceinline__ void store2(float* p, int64_t e, float2 v) {
  *reinterpret_cast<float2*>(p + 2 * e) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, int64_t e, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p + 2 * e) = __floats2bfloat162_rn(v.x, v.y);
}

// 16 bytes of a frame: 2 (fp32) or 4 (bf16) complex points
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kPoints = 2;
  static __device__ __forceinline__ void unpack(uint4 u, float2 (&z)[2]) {
    z[0] = make_float2(__uint_as_float(u.x), __uint_as_float(u.y));
    z[1] = make_float2(__uint_as_float(u.z), __uint_as_float(u.w));
  }
  static __device__ __forceinline__ uint4 pack(const float2 (&z)[2]) {
    return make_uint4(__float_as_uint(z[0].x), __float_as_uint(z[0].y), __float_as_uint(z[1].x),
                      __float_as_uint(z[1].y));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kPoints = 4;
  static __device__ __forceinline__ float2 bf2(unsigned w) {
    __nv_bfloat162 h;
    *reinterpret_cast<unsigned*>(&h) = w;
    return __bfloat1622float2(h);
  }
  static __device__ __forceinline__ unsigned word(float2 v) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
    return *reinterpret_cast<unsigned*>(&h);
  }
  static __device__ __forceinline__ void unpack(uint4 u, float2 (&z)[4]) {
    z[0] = bf2(u.x);
    z[1] = bf2(u.y);
    z[2] = bf2(u.z);
    z[3] = bf2(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float2 (&z)[4]) {
    return make_uint4(word(z[0]), word(z[1]), word(z[2]), word(z[3]));
  }
};

template <int M> struct Layout {
  using PL = HopperPlan<M>;
  static constexpr int kTw1 = (PL::R1 - 1) * PL::R0;
  static constexpr int kTw2 = (PL::R2 - 1) * PL::R0 * PL::R1;
  static constexpr int kBuf = ((M + M / 32) + 1) & ~1;  // 16-byte aligned frames
  static constexpr int kTwSlots = (kTw1 + kTw2 + 1) & ~1;  // the frames' buffers follow
  static constexpr int kThreads = PL::T * PL::FPB;
  static constexpr size_t kSmem = sizeof(float2) * (kTwSlots + PL::FPB * kBuf);
};

template <int M, typename T>
__global__ void __launch_bounds__(Layout<M>::kThreads, 1)
fgla_frame_hopper_kernel(const T* __restrict__ frames, const T* __restrict__ r_in,
                         const T* __restrict__ r_prev, T* __restrict__ r_out,
                         T* __restrict__ y_out, const T* __restrict__ spec,
                         const T* __restrict__ merged, const float2* __restrict__ table,
                         long long rows, float t_anneal, float mom) {
  using PL = HopperPlan<M>;
  using L = Layout<M>;
  using V = Vec<T>;
  constexpr int n = 2 * M;
  constexpr int kVecs = M / V::kPoints;
  extern __shared__ __align__(16) float2 smem[];
  float2* tw1 = smem;
  float2* tw2 = tw1 + L::kTw1;
  const int frame = threadIdx.x / PL::T;
  const int t = threadIdx.x - frame * PL::T;
  float2* buf = smem + L::kTwSlots + frame * L::kBuf;

  // the passes' twiddles W_(PP R)^(j k) = table[(n / (PP R)) j k], once per block
  for (int idx = threadIdx.x; idx < L::kTw1; idx += L::kThreads) {
    const int j = idx / PL::R0 + 1, k = idx - (j - 1) * PL::R0;
    tw1[idx] = __ldg(table + (n / (PL::R0 * PL::R1)) * j * k);
  }
  for (int idx = threadIdx.x; idx < L::kTw2; idx += L::kThreads) {
    constexpr int pp = PL::R0 * PL::R1;
    const int j = idx / pp + 1, k = idx - (j - 1) * pp;
    tw2[idx] = __ldg(table + (n / (pp * PL::R2)) * j * k);
  }

  const float tt = t_anneal > 0.f ? t_anneal : 0.f;
  // bin k from r: momentum, phase normalise, annealed magnitude
  auto spectral = [&](float2 r, float2 p, float s, float mg, bool real_bin) {
    if (r_prev) {
      r.x -= mom * p.x;
      r.y -= mom * p.y;
    }
    const float mag = sqrtf(r.x * r.x + r.y * r.y) + 1e-12f;
    const float interp = mg + (s - mg) * tt;
    float2 x = make_float2(r.x / mag * interp, r.y / mag * interp);
    if (real_bin) x.y = 0.f;  // irfft reads only the real part of bins 0 and m
    return x;
  };
  auto rounded = [](float2 r) { return make_float2(dd::round_to<T>(r.x), dd::round_to<T>(r.y)); };

  // persistent: the block walks groups of FPB frames
  const long long groups = (rows + PL::FPB - 1) / PL::FPB;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t row = g * PL::FPB + frame;
    const bool valid = row < rows;
    const int64_t rb = row * (M + 1);
    if (frames && valid) {
      const uint4* src = reinterpret_cast<const uint4*>(frames + row * n);
#pragma unroll
      for (int v = t; v < kVecs; v += PL::T) {
        float2 z[V::kPoints];
        V::unpack(__ldg(src + v), z);
#pragma unroll
        for (int c = 0; c < V::kPoints; ++c) buf[slot(v * V::kPoints + c)] = z[c];
      }
    }
    __syncthreads();
    if (frames) fft<PL, M, false>(buf, tw1, tw2, t);

    // Bins k and j = m - k share their split and merge inputs: one thread
    // takes both, reading the spectrum entries and writing the merged ones
    // in place. Pairs k < m/2 go in chunks whose global loads are all issued
    // before any is used; thread 0 also takes the middle bin m/2.
    if (valid) {
      constexpr int KI = (M / 2) / PL::T, CH = KI / 4;
      static_assert(KI * PL::T == M / 2 && CH * 4 == KI, "pairs must split evenly");
      constexpr int mid = M / 2;
      float2 p_mid = make_float2(0.f, 0.f), i_mid = p_mid;
      float s_mid = 0.f, m_mid = 0.f;
      if (t == 0) {
        if (r_prev) p_mid = load2(r_prev, rb + mid);
        if (!frames) i_mid = load2(r_in, rb + mid);
        s_mid = dd::load_f(spec, rb + mid);
        m_mid = dd::load_f(merged, rb + mid);
      }
#pragma unroll 1
      for (int c = 0; c < KI; c += CH) {
        float2 w[CH], pk[CH], pj[CH], ik[CH], ij[CH];
        float sk[CH], sj[CH], mk[CH], mj[CH];
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int k = t + PL::T * (c + u), j = M - k;
          w[u] = __ldg(table + k);
          sk[u] = dd::load_f(spec, rb + k);
          sj[u] = dd::load_f(spec, rb + j);
          mk[u] = dd::load_f(merged, rb + k);
          mj[u] = dd::load_f(merged, rb + j);
          pk[u] = pj[u] = ik[u] = ij[u] = make_float2(0.f, 0.f);
          if (r_prev) {
            pk[u] = load2(r_prev, rb + k);
            pj[u] = load2(r_prev, rb + j);
          }
          if (!frames) {
            ik[u] = load2(r_in, rb + k);
            ij[u] = load2(r_in, rb + j);
          }
        }
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int k = t + PL::T * (c + u), j = M - k;
          // W_n^j = W_n^m W_n^-k = -conj(W_n^k)
          const float2 wk = w[u], wj = make_float2(-wk.x, wk.y);
          float2 rk = ik[u], rj = ij[u];
          if (frames) {
            const float2 zk = buf[slot(k)], zj = buf[slot(j == M ? 0 : j)];
            rk = rounded(split_bin(zk, zj, wk));
            rj = rounded(split_bin(zj, zk, wj));
            if (r_out) {
              store2(r_out, rb + k, rk);
              store2(r_out, rb + j, rj);
            }
          }
          const float2 xk = spectral(rk, pk[u], sk[u], mk[u], k == 0);
          const float2 xj = spectral(rj, pj[u], sj[u], mj[u], j == M);
          buf[slot(k)] = merge_bin(xk, xj, make_float2(wk.x, -wk.y));
          if (j < M) buf[slot(j)] = merge_bin(xj, xk, make_float2(wj.x, -wj.y));
        }
      }
      if (t == 0) {
        const float2 w = __ldg(table + mid);
        float2 r = i_mid;
        if (frames) {
          const float2 z = buf[slot(mid)];
          r = rounded(split_bin(z, z, w));
          if (r_out) store2(r_out, rb + mid, r);
        }
        const float2 x = spectral(r, p_mid, s_mid, m_mid, false);
        buf[slot(mid)] = merge_bin(x, x, make_float2(w.x, -w.y));
      }
    }
    if (y_out) {
      __syncthreads();
      fft<PL, M, true>(buf, tw1, tw2, t);
      if (valid) {
        constexpr float scale = 1.f / (float)M;
        uint4* dst = reinterpret_cast<uint4*>(y_out + row * n);
#pragma unroll
        for (int v = t; v < kVecs; v += PL::T) {
          float2 z[V::kPoints];
#pragma unroll
          for (int c = 0; c < V::kPoints; ++c) {
            const float2 s = buf[slot(v * V::kPoints + c)];
            z[c] = make_float2(s.x * scale, s.y * scale);
          }
          dst[v] = V::pack(z);
        }
      }
    }
    __syncthreads();  // the buffer is free for the next group
  }
}

template <int M, typename T>
int launch(const void* frames, const void* r_in, const void* r_prev, void* r_out, void* y_out,
           const void* spec, const void* merged, const void* table, long long rows, float t,
           float mom, cudaStream_t stream) {
  using L = Layout<M>;
  auto kernel = fgla_frame_hopper_kernel<M, T>;
  cudaError_t err = dd_allow_smem(kernel, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  // a persistent grid: as many blocks as the SMs hold at once
  static int per_sm = 0;  // a property of the kernel alone
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, L::kThreads, L::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long groups = (rows + HopperPlan<M>::FPB - 1) / HopperPlan<M>::FPB;
  if (groups == 0) return (int)cudaSuccess;
  const long long blocks = std::min<long long>(groups, (long long)sms * std::max(per_sm, 1));
  kernel<<<(unsigned)blocks, L::kThreads, L::kSmem, stream>>>(
      (const T*)frames, (const T*)r_in, (const T*)r_prev, (T*)r_out, (T*)y_out, (const T*)spec,
      (const T*)merged, (const float2*)table, rows, t, mom);
  return (int)cudaGetLastError();
}

template <int M>
int launch_typed(const void* frames, const void* r_in, const void* r_prev, void* r_out,
                 void* y_out, const void* spec, const void* merged, const void* table,
                 long long rows, float t, float mom, int is_bf16, cudaStream_t s) {
  if (is_bf16)
    return launch<M, __nv_bfloat16>(frames, r_in, r_prev, r_out, y_out, spec, merged, table, rows,
                                    t, mom, s);
  return launch<M, float>(frames, r_in, r_prev, r_out, y_out, spec, merged, table, rows, t, mom,
                          s);
}

template <int M>
void plan_of(int* out) {
  using PL = HopperPlan<M>;
  const int v[] = {PL::P, PL::T, PL::FPB, PL::R0, PL::R1, PL::R2};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

}  // namespace

// The same arguments as dd_fgla_frame, less the Stockham radices: the plan
// is compiled in for each n_fft this kernel takes (6400, 4096).
extern "C" int dd_fgla_frame_hopper(const void* frames, const void* r_in, const void* r_prev,
                                    void* r_out, void* y_out, const void* spec, const void* merged,
                                    const void* table, long long rows, int n, float t, float mom,
                                    int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 6400)
    return launch_typed<3200>(frames, r_in, r_prev, r_out, y_out, spec, merged, table, rows, t,
                              mom, is_bf16, s);
  if (n == 4096)
    return launch_typed<2048>(frames, r_in, r_prev, r_out, y_out, spec, merged, table, rows, t,
                              mom, is_bf16, s);
  return (int)cudaErrorInvalidValue;
}

// The compiled plan for n_fft n: (P, threads a frame, frames a block,
// radices of the three passes) into out[0..5]; returns 1 if n has one.
extern "C" int dd_fgla_frame_hopper_plan(int n, int* out) {
  if (n == 6400) {
    plan_of<3200>(out);
    return 1;
  }
  if (n == 4096) {
    plan_of<2048>(out);
    return 1;
  }
  return 0;
}
