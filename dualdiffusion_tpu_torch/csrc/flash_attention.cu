// K7 flash_attention: online-softmax attention over (B, H, L, D), forward only.
//
// Replaces dualdiffusion_tpu/ops/pallas/flash_attention.py _attn_kernel (via
// flash_attention), which the JAX package's scaled_dot_product_attention
// takes at L >= 2048: the UNet's "full" and "time" attention axes, and
// sliding_window_attention.
//
// o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h, j] * scale, masked) v[b, h, j]
// with the mask |i - j| <= window when a window is given, j <= i when causal,
// and j < L always. The softmax and the accumulation are fp32; o is written
// in q's dtype. A row whose keys are all masked emits 0, not NaN.
//
// What bounds it on the H100: at the path's shape (B = 2, H = 8, L = 5504,
// D = 64, bf16, dense) one call is 4 B H L^2 D = 124 GFLOP of products,
// 0.126 ms at 989 TFLOP/s bf16, and B H L^2 = 0.48 G exponentials, one per
// score, about 0.12 ms on the SFUs (16 per SM per clock at 1.98 GHz). The
// bytes, 4 x 11.3 MB, take ~0.013 ms. So the tensor cores and the softmax
// together bound it, not the memory.
//
// Design (right and simple first; wgmma, TMA and warp-specialised softmax
// overlap are later work): one block of 4 warps per (b*h, 64-row q tile);
// each warp owns 16 q rows and keeps them in registers as mma.sync A
// fragments. The block walks only the 64-key tiles that meet its rows' band,
// from max(q_lo - w, 0) to min(q_hi + w, L - 1), ending at q_hi when causal:
// O(L w) work for bands. K and V tiles are staged in shared memory with
// 16-byte cp.async, two stages deep, so the next tile's copy overlaps this
// tile's products. S = Q K^T runs on the bf16 tensor cores (mma.sync
// m16n8k16, fp32 accumulators); bf16 x bf16 products are exact in fp32, so
// this matches the TPU kernel's fp32 dot of bf16 inputs up to summation
// order. The online softmax stays in registers: the row max by quad
// shuffles, exp2f of scores pre-multiplied by scale * log2(e), the row sum
// kept per thread and reduced once at the end. P is rounded to bf16 for
// P V on the tensor cores, as the JAX einsum route rounds its
// probabilities to bf16 (models/attention.py:113); that is the kernel's
// tolerance against the fp32 plain version (2e-2 of max |o|). O stays in
// fp32 registers and is divided once, with the l == 0 guard. The tail of L
// is masked in the kernel (zero-filled copies, -inf scores), not padded on
// the host. Tiles that lie wholly inside the band take no mask at all.
// Any (b, h, l) strides are taken, with unit stride along D, so the
// UNet's transposed (B, L, H, D) views need no copies.
//
// fp32 inputs take a second kernel with fp32 FMA on the CUDA cores (no
// TF32, which would change the numbers): 4 threads per q row, each holding
// a quarter of the row's q and o, 32-key tiles in shared memory.

#include "common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t sq[3], sk[3], sv[3], so[3];  // element strides of b, h, l; d has stride 1
  int H, L;
  float scale_log2;  // scale * log2(e)
  int window;        // < 0: no band
  int causal;
};

// the key range [k_lo, k_hi] that rows [q0, q_hi] can see
__device__ __forceinline__ void key_range(const Params& p, int q0, int q_hi, int& k_lo,
                                          int& k_hi) {
  k_lo = 0;
  k_hi = p.L - 1;
  if (p.window >= 0) {
    k_lo = max(q0 - p.window, 0);
    k_hi = min(q_hi + p.window, p.L - 1);
  }
  if (p.causal) k_hi = min(k_hi, q_hi);
}

__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  return col < p.L && (p.window < 0 || abs(row - col) <= p.window) && (!p.causal || col <= row);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;  // q rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + rows) of one (b, h) matrix -> shared tile (row stride LDS);
// rows at or past L are zero-filled
template <int D, int LDS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t sl, int r0,
                                          int rows, int L) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int q = threadIdx.x; q < rows * kChunks; q += kThreads) {
    const int r = q / kChunks, c = (q % kChunks) * 8;
    const bool in = r0 + r < L;
    cp_async16(dst + r * LDS + c, in ? src + (int64_t)(r0 + r) * sl + c : src, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attn_bf16_kernel(const Params p) {
  constexpr int LDS = D + 8;  // row stride: conflict-free ldmatrix, 16-byte aligned rows
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * LDS;       // two stages
  bf16* sV = sK + 2 * kBK * LDS;   // two stages

  const int L = p.L;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.sv[0] + h * p.sv[1];
  bf16* ob = static_cast<bf16*>(p.o) + b * p.so[0] + h * p.so[1];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q_hi = min(q0 + kBQ, L) - 1;
  int k_lo, k_hi;
  key_range(p, q0, q_hi, k_lo, k_hi);
  const int t_lo = k_lo / kBK, t_hi = k_hi / kBK;

  load_tile<D, LDS>(sQ, qb, p.sq[2], q0, kBQ, L);
  load_tile<D, LDS>(sK, kb, p.sk[2], t_lo * kBK, kBK, L);
  load_tile<D, LDS>(sV, vb, p.sv[2], t_lo * kBK, kBK, L);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (log2 domain)
  float l[2] = {0.f, 0.f};              // this thread's part of the running sums
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  for (int j = t_lo; j <= t_hi; ++j) {
    const int st = (j - t_lo) & 1;
    if (j < t_hi) {
      const int nx = (st ^ 1) * kBK * LDS;
      load_tile<D, LDS>(sK + nx, kb, p.sk[2], (j + 1) * kBK, kBK, L);
      load_tile<D, LDS>(sV + nx, vb, p.sv[2], (j + 1) * kBK, kBK, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == t_lo) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int m8 = lane / 8;
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane % 8) + (m8 % 2) * 8) * LDS + kk * 16 +
                                (m8 / 2) * 8);
      }
    }
    const bf16* tK = sK + st * kBK * LDS;
    const bf16* tV = sV + st * kBK * LDS;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < kBK / 16; ++n2) {
        const int m8 = lane / 8;
        uint32_t r[4];
        ldmatrix_x4(r, tK + (n2 * 16 + (lane % 8) + (m8 / 2) * 8) * LDS + kk * 16 + (m8 % 2) * 8);
        mma_bf16(s[2 * n2], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], r[2], r[3]);
      }
    }

    // online softmax in the log2 domain
    const int k0 = j * kBK;
    const bool need_mask = k0 + kBK > L || (p.causal && k0 + kBK - 1 > q0) ||
                           (p.window >= 0 && (k0 < q0 + kBQ - 1 - p.window ||
                                              k0 + kBK - 1 > q0 + p.window));
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale_log2;
        if (need_mask && !visible(p, e < 2 ? row0 : row1, k0 + n * 8 + 2 * t + (e & 1)))
          x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_use[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // all masked so far: p = alpha = 0
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(s[n][e] - m_use[e >> 1]);
        s[n][e] = pv;
        l[e >> 1] += pv;
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        const int m8 = lane / 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, tV + (kk * 16 + (lane % 8) + (m8 % 2) * 8) * LDS + n2 * 16 +
                                 (m8 / 2) * 8);
        mma_bf16(o[2 * n2], a, r[0], r[1]);
        mma_bf16(o[2 * n2 + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  // divide once; fully masked rows (l == 0) emit 0
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
  }
  // stage this warp's rows in its own part of sQ (only it read them), then
  // store 16-byte vectors
  bf16* sO = sQ + warp * 16 * LDS;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(sO + g * LDS + n * 8 + 2 * t) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(sO + (g + 8) * LDS + n * 8 + 2 * t) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int q = lane; q < 16 * kChunks; q += 32) {
    const int r = q / kChunks, c = (q % kChunks) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < L)
      *reinterpret_cast<uint4*>(ob + (int64_t)row * p.so[2] + c) =
          *reinterpret_cast<const uint4*>(sO + r * LDS + c);
  }
}

template <int D>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = (size_t)(kBQ + 4 * kBK) * (D + 8) * sizeof(bf16);
  auto kernel = flash_attn_bf16_kernel<D>;
  cudaError_t err = dd_allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.L + kBQ - 1) / kBQ, B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;                  // q rows per block
constexpr int kF32Threads = 4 * kF32Rows;     // 4 threads per row
constexpr int kF32Keys = 32;                  // keys per tile

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_attn_f32_kernel(const Params p) {
  constexpr int DP = D / 4;  // dims per thread: c, c + 4, c + 8, ...
  __shared__ float sK[kF32Keys][D];
  __shared__ float sV[kF32Keys][D];

  const int L = p.L;
  const int q0 = blockIdx.x * kF32Rows;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const float* qb = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const float* kb = static_cast<const float*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const float* vb = static_cast<const float*>(p.v) + b * p.sv[0] + h * p.sv[1];
  float* ob = static_cast<float*>(p.o) + b * p.so[0] + h * p.so[1];

  const int c = threadIdx.x & 3;
  const int row = q0 + (threadIdx.x >> 2);
  const int q_hi = min(q0 + kF32Rows, L) - 1;
  int k_lo, k_hi;
  key_range(p, q0, q_hi, k_lo, k_hi);

  float qr[DP], o[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = row < L ? qb[(int64_t)row * p.sq[2] + c + 4 * i] : 0.f;
    o[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const float scale_log2 = p.scale_log2;

  for (int k0 = k_lo / kF32Keys * kF32Keys; k0 <= k_hi; k0 += kF32Keys) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kF32Keys * D; i += kF32Threads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < L;
      sK[r][d] = in ? kb[(int64_t)(k0 + r) * p.sk[2] + d] : 0.f;
      sV[r][d] = in ? vb[(int64_t)(k0 + r) * p.sv[2] + d] : 0.f;
    }
    __syncthreads();
    float s[kF32Keys];
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < kF32Keys; ++jj) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc = fmaf(qr[i], sK[jj][c + 4 * i], acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      const float x = visible(p, row, k0 + jj) ? acc * scale_log2 : -INFINITY;
      s[jj] = x;
      mx = fmaxf(mx, x);
    }
    const float m_use = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(m - m_use);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DP; ++i) o[i] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kF32Keys; ++jj) {
      const float pj = exp2f(s[jj] - m_use);
      l += pj;
#pragma unroll
      for (int i = 0; i < DP; ++i) o[i] = fmaf(pj, sV[jj][c + 4 * i], o[i]);
    }
  }
  const float inv = l == 0.f ? 0.f : 1.f / l;
  if (row < L) {
#pragma unroll
    for (int i = 0; i < DP; ++i) ob[(int64_t)row * p.so[2] + c + 4 * i] = o[i] * inv;
  }
}

template <int D>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  dim3 grid((p.L + kF32Rows - 1) / kF32Rows, B * p.H);
  flash_attn_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Params& p, int B, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(p, B, stream) : launch_f32<D>(p, B, stream);
}

}  // namespace

// strides: 12 element strides, (b, h, l) of q, k, v and o in that order
extern "C" int dd_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  const long long* strides, int B, int H, int L, int D,
                                  float scale, int window, int causal, int is_bf16, void* stream) {
  if (B * H > 65535 || L <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  p.H = H;
  p.L = L;
  p.scale_log2 = scale * kLog2e;
  p.window = window;
  p.causal = causal;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(p, B, is_bf16, s);
    case 32: return launch<32>(p, B, is_bf16, s);
    case 48: return launch<48>(p, B, is_bf16, s);
    case 64: return launch<64>(p, B, is_bf16, s);
    case 80: return launch<80>(p, B, is_bf16, s);
    case 96: return launch<96>(p, B, is_bf16, s);
    case 112: return launch<112>(p, B, is_bf16, s);
    case 128: return launch<128>(p, B, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
