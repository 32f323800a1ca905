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
// 4 and 5 by hand, larger radices composed of them) whose inner twiddles are
// compile-time constants. Every index inside a pass divides by compile-time
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
#include <type_traits>

#include "fgla.cuh"

namespace {

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

template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}
#define CV(x) decltype(x)::value

// cos and sin of 2 pi e / N in double, evaluated by the compiler
constexpr double kPi = 3.14159265358979323846;
__host__ __device__ constexpr double ct_angle(int e, int N) {
  const int r = ((e % N) + N) % N;
  const double a = 2.0 * kPi * (double)r / (double)N;
  return a > kPi ? a - 2.0 * kPi : a;
}
__host__ __device__ constexpr double ct_cos(int e, int N) {
  const double x = ct_angle(e, N);
  double term = 1.0, sum = 1.0;
  for (int k = 1; k < 30; ++k) {
    term *= -x * x / ((2.0 * k - 1.0) * (2.0 * k));
    sum += term;
  }
  return sum;
}
__host__ __device__ constexpr double ct_sin(int e, int N) {
  const double x = ct_angle(e, N);
  double term = x, sum = x;
  for (int k = 1; k < 30; ++k) {
    term *= -x * x / ((2.0 * k) * (2.0 * k + 1.0));
    sum += term;
  }
  return sum;
}

// v * W_N^E with W_N = exp(-2 pi i / N), or its conjugate when INV
template <int N, int E, bool INV>
__device__ __forceinline__ float2 rot(float2 v) {
  constexpr int e = E % N;
  if constexpr (e == 0) {
    return v;
  } else if constexpr (2 * e == N) {
    return make_float2(-v.x, -v.y);
  } else if constexpr (4 * e == N) {  // -i (forward), +i (inverse)
    return INV ? make_float2(-v.y, v.x) : make_float2(v.y, -v.x);
  } else if constexpr (4 * e == 3 * N) {  // +i (forward), -i (inverse)
    return INV ? make_float2(v.y, -v.x) : make_float2(-v.y, v.x);
  } else {
    constexpr float c = (float)ct_cos(e, N);
    constexpr float s = INV ? (float)ct_sin(e, N) : (float)-ct_sin(e, N);
    return make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
  }
}

// in-register DFT of N points; sign -1 (forward) unless INV
template <int N, bool INV>
__device__ __forceinline__ void dft(float2 (&x)[N]) {
  if constexpr (N == 2) {
    const float2 a = x[0], b = x[1];
    x[0] = dd::cadd(a, b);
    x[1] = dd::csub(a, b);
  } else if constexpr (N == 4) {
    const float2 s02 = dd::cadd(x[0], x[2]), d02 = dd::csub(x[0], x[2]);
    const float2 s13 = dd::cadd(x[1], x[3]), d13 = rot<4, 1, INV>(dd::csub(x[1], x[3]));
    x[0] = dd::cadd(s02, s13);
    x[1] = dd::cadd(d02, d13);
    x[2] = dd::csub(s02, s13);
    x[3] = dd::csub(d02, d13);
  } else if constexpr (N == 5) {
    constexpr float c1 = (float)ct_cos(1, 5), c2 = (float)ct_cos(2, 5);
    constexpr float s1 = (float)ct_sin(1, 5), s2 = (float)ct_sin(2, 5);
    const float2 t1 = dd::cadd(x[1], x[4]), t2 = dd::cadd(x[2], x[3]);
    const float2 t3 = dd::csub(x[1], x[4]), t4 = dd::csub(x[2], x[3]);
    const float2 x0 = x[0];
    const float2 a1 = make_float2(x0.x + c1 * t1.x + c2 * t2.x, x0.y + c1 * t1.y + c2 * t2.y);
    const float2 a2 = make_float2(x0.x + c2 * t1.x + c1 * t2.x, x0.y + c2 * t1.y + c1 * t2.y);
    const float2 b1 = make_float2(s1 * t3.x + s2 * t4.x, s1 * t3.y + s2 * t4.y);
    const float2 b2 = make_float2(s2 * t3.x - s1 * t4.x, s2 * t3.y - s1 * t4.y);
    // forward: X1 = a1 - i b1, X4 = a1 + i b1, X2 = a2 - i b2, X3 = a2 + i b2
    const float sg = INV ? -1.f : 1.f;
    x[0] = make_float2(x0.x + t1.x + t2.x, x0.y + t1.y + t2.y);
    x[1] = make_float2(a1.x + sg * b1.y, a1.y - sg * b1.x);
    x[4] = make_float2(a1.x - sg * b1.y, a1.y + sg * b1.x);
    x[2] = make_float2(a2.x + sg * b2.y, a2.y - sg * b2.x);
    x[3] = make_float2(a2.x - sg * b2.y, a2.y + sg * b2.x);
  } else {
    // N = A B: n = B n1 + n2, k = k1 + A k2; DFT_A over n1, twiddle
    // W_N^(n2 k1), DFT_B over n2
    constexpr int A = (N % 4 == 0) ? 4 : (N % 5 == 0 ? 5 : 2);
    constexpr int B = N / A;
    float2 y[N];
    static_for<0, B>([&](auto n2) {
      float2 t[A];
      static_for<0, A>([&](auto n1) { t[CV(n1)] = x[B * CV(n1) + CV(n2)]; });
      dft<A, INV>(t);
      static_for<0, A>([&](auto k1) {
        y[CV(n2) * A + CV(k1)] = rot<N, CV(n2) * CV(k1), INV>(t[CV(k1)]);
      });
    });
    static_for<0, A>([&](auto k1) {
      float2 t[B];
      static_for<0, B>([&](auto n2) { t[CV(n2)] = y[CV(n2) * A + CV(k1)]; });
      dft<B, INV>(t);
      static_for<0, B>([&](auto k2) { x[CV(k1) + A * CV(k2)] = t[CV(k2)]; });
    });
  }
}

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
