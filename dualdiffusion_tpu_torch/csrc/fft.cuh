// Register FFT codelets shared by the port's FFT kernels (fgla_frame_hopper.cu,
// mss2d.cu): a compile-time loop, twiddles W_N^e = exp(-2 pi i e / N) that
// the compiler evaluates in double, and unrolled in-register DFTs of small N
// (2, 4 and 5 by hand, other sizes composed of them).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace dd_fft {

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

}  // namespace dd_fft
